"""The classifier's logits on a card: ``predict_logits`` pipelines each
chunk's copy into one page-locked host array that the caller owns.

Marked ``cuda``; each test skips where no CUDA device is present. On a
machine with a card and without JAX, run them with

    python -m pytest --noconftest -m cuda tests/test_torch_classify_cuda.py

Checked: the logits bit for bit ``torch.cat`` of the chunks copied to the
host (f32 and bf16 rows, a short last chunk), the array's memory
page-locked, the copy span's counts under the profiler, the first call's
array kept through a second call (both engines), and the pinned blocks
handed back to later calls once the caller drops its arrays.
"""

import math

import numpy as np
import pytest
import torch

from grandtpu_torch import observe
from grandtpu_torch.infer import classify
from grandtpu_torch.nn.mlp import MLP, MLPConfig

pytestmark = pytest.mark.cuda

N, F, C, BATCH = 25013, 100, 47, 4096     # 7 chunks, the last 459 rows


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(device, dtype=torch.float32):
    torch.manual_seed(0)
    with torch.device(device):
        model = MLP(MLPConfig(num_features=F, num_classes=C, hidden=64,
                              nlayers=2, use_bn=True)).eval()
    x = torch.randn(N, F, device=device).to(dtype)
    return model, x


def owned_logits(path, seed, device="cpu"):
    """Logits of one predict call on inputs drawn from ``seed``: the dense
    engine's ``predict_logits`` or the MAG engine's
    ``predict_logits_sparse``, in three chunks, the last short."""
    from grandtpu_torch.data import load_data
    from grandtpu_torch.data.preprocess import add_self_loops_adj
    from grandtpu_torch.nn.mag_mlp import MagMLP
    from grandtpu_torch.nn.sparse_input import PaddedFeatures

    torch.manual_seed(0)
    cfg = dict(num_classes=5, hidden=16, nlayers=2)
    g = torch.Generator().manual_seed(seed)
    if path == "dense":
        with torch.device(device):
            model = MLP(MLPConfig(num_features=12, use_bn=True, **cfg))
        feats = torch.randn(130, 12, generator=g).to(device)
        return classify.predict_logits(model, feats, batch_size=50)
    data = load_data("synth:400:4:64:sparse", split_seed=0)
    padded = PaddedFeatures.from_csr(data.features)
    with torch.device(device):
        model = MagMLP(MLPConfig(num_features=64, **cfg))
    with torch.no_grad():
        model.table.copy_(torch.randn(model.table.shape, generator=g))
    return classify.predict_logits_sparse(
        model, padded.attr_cols, padded.attr_vals,
        add_self_loops_adj(data.adj), order=3, batch_size=150)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_pipelined_logits_bit_for_bit(device, dtype):
    model, x = _case(device, dtype)
    with torch.no_grad():
        want = torch.cat([model(x[i: i + BATCH].float())
                          for i in range(0, N, BATCH)]).cpu().numpy()
    got = classify.predict_logits(model, x, batch_size=BATCH)
    assert got.dtype == np.float32 and got.shape == (N, C)
    assert np.array_equal(got, want)
    assert torch.from_numpy(got).is_pinned()


def test_copy_span_counts_pinned_bytes_and_chunks(device):
    from torch.profiler import ProfilerActivity, profile

    model, x = _case(device)
    observe.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        got = classify.predict_logits(model, x, batch_size=BATCH)
    recs = observe.spans()
    observe.clear()
    cls = next(r for r in recs if r["name"] == "infer.classify")
    assert [r["name"] for r in recs if r["parent"] == cls["id"]] == [
        "infer.classify.head", "infer.classify.copy"]
    copy = next(r for r in recs if r["name"] == "infer.classify.copy")
    assert copy["counts"] == {"copy_bytes": got.nbytes,
                              "pinned_bytes": got.nbytes,
                              "copy_chunks": math.ceil(N / BATCH)}
    for r in recs:
        assert r["device_ms"] is not None and r["device_ms"] >= 0.0


@pytest.mark.parametrize("path", ["dense", "mag"])
def test_logits_arrays_belong_to_the_caller_on_the_card(device, path):
    first = owned_logits(path, seed=1, device=device)
    kept = first.copy()
    second = owned_logits(path, seed=2, device=device)
    assert not np.array_equal(second, kept)
    np.testing.assert_array_equal(first, kept)
    assert not np.shares_memory(first, second)


def test_dropped_arrays_give_their_pinned_blocks_back(device):
    """Two arrays held at once take two blocks; once both are dropped, the
    next two calls get those blocks again, pinning nothing new."""
    model, x = _case(device)

    def pointers():
        held = [classify.predict_logits(model, x, batch_size=BATCH)
                for _ in range(2)]
        return {a.ctypes.data for a in held}

    first = pointers()
    assert len(first) == 2
    assert pointers() == first

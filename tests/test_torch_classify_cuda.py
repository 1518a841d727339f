"""The classifier's logits on a card: ``predict_logits`` pipelines each
chunk's copy into one page-locked host array that the caller owns, and
classifies each chunk of an eval-mode 2-layer MLP with the hand-written
head (``nn/mlp_head.py``, ``csrc/mlp_head.cu``).

Marked ``cuda``; each test skips where no CUDA device is present. On a
machine with a card and without JAX, run them with

    python -m pytest --noconftest -m cuda tests/test_torch_classify_cuda.py

Checked: the logits bit for bit ``torch.cat`` of the chunks, each through
the head ``predict_logits`` runs (``classify.chunk_head``), copied to the
host (f32 and bf16 rows, a short last chunk), the array's memory
page-locked, the copy span's counts under the profiler, the first call's
array kept through a second call (both engines), and the pinned blocks
handed back to later calls once the caller drops its arrays. The head's
kernel against its plain version and against ``model(x)`` within 2e-6 of
the largest |logit| (its own tolerance: sums in another order, the hidden
norm and BN folded past ``fcs[1]``) at the cells' widths, on a 10,000-row
chunk and the cells' last chunks, with its launches, and the head span's
``fused_rows``.
"""

import math

import numpy as np
import pytest
import torch

from grandtpu_torch import observe
from grandtpu_torch.infer import classify
from grandtpu_torch.nn import mlp_head
from grandtpu_torch.nn.mlp import MLP, MLPConfig
from test_torch_mlp_head import WIDTHS, gap, head_model, kill_row, rows

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
    head, fused = classify.chunk_head(model, x.device)
    assert fused
    with torch.no_grad():
        want = torch.cat([head(x[i: i + BATCH].float())
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


@pytest.mark.parametrize("widths,n", [("amazon2m", 10000), ("amazon2m", 9029),
                                      ("reddit", 10000), ("reddit", 2965)])
def test_fused_head_at_the_cells_widths(device, widths, n):
    """A 10,000-row chunk and each cell's last chunk (2,449,029 and 232,965
    rows in chunks of 10,000): one launch, against the plain version on the
    card and the module's eval forward, the same bits on a second call."""
    f, h, c = WIDTHS[widths]
    model = head_model(f, h, c, device=device)
    x = rows(n, f, device=device)
    launch = mlp_head.head_launcher(model)
    before = mlp_head.head_launcher.launches
    got = launch(x)
    torch.cuda.synchronize()
    assert mlp_head.head_launcher.launches == before + 1
    assert got.shape == (n, c)
    assert gap(got, mlp_head.eval_head_plain(model, x)) <= 2e-6
    with torch.no_grad():
        assert gap(got, model(x)) <= 2e-6
    assert torch.equal(launch(x), got)


@pytest.mark.parametrize("node_norm", [True, False], ids=["norm", "nonorm"])
@pytest.mark.parametrize("use_bn", [True, False], ids=["bn", "nobn"])
@pytest.mark.parametrize("widths", list(WIDTHS))
def test_fused_head_flags_and_a_dead_row(device, widths, use_bn, node_norm):
    """``use_bn`` and ``node_norm`` each on and off, with a row whose hidden
    units are all <= 0 (its hidden norm 0), 1,000 rows."""
    f, h, c = WIDTHS[widths]
    model = head_model(f, h, c, use_bn, node_norm, device=device)
    x = rows(1000, f, device=device)
    kill_row(model, x, 7)
    got = mlp_head.head_launcher(model)(x)
    with torch.no_grad():
        want = model(x)
    assert torch.isfinite(got).all()
    assert gap(got, want) <= 2e-6 and gap(got[7], want[7]) <= 2e-6
    assert gap(got, mlp_head.eval_head_plain(model, x)) <= 2e-6


# (F, H, C, use_bn) and whether the kernel has room for them: the cells'
# widths; a class, hidden units or a BN table too many; no BN table
FITS = {"amazon2m": ((100, 1024, 47, True), True),
        "reddit": ((602, 512, 41, True), True),
        "classes": ((100, 1024, 49, True), False),
        "hidden": ((100, 1028, 47, True), False),
        "hidden_not_4": ((100, 1022, 47, True), False),
        "bn_table": ((9000, 64, 8, True), False),
        "wide_no_bn": ((9000, 64, 8, False), True)}


@pytest.mark.parametrize("case", list(FITS))
def test_fused_head_fits_only_the_widths_it_has_room_for(device, case):
    """The library's own check decides, and the card path keeps the
    module's forward where it refuses; where it accepts, one launch runs."""
    (f, h, c, use_bn), want = FITS[case]
    model = head_model(f, h, c, use_bn, device=device)
    x = rows(300, f, device=device)
    assert mlp_head.takes(model) and mlp_head.fits(model) == want
    _, fused = classify.chunk_head(model, x.device)
    assert fused == want
    if not want:
        with pytest.raises(ValueError):
            mlp_head.head_launcher(model)
        return
    with torch.no_grad():
        assert gap(mlp_head.head_launcher(model)(x), model(x)) <= 2e-6


@pytest.mark.parametrize("widths", list(WIDTHS))
def test_fused_head_config_has_no_spill(device, widths):
    f, h, _ = WIDTHS[widths]
    for use_bn in (True, False):
        cfg = mlp_head.head_config(f, h, use_bn)
        assert cfg["spill_bytes"] == 0 and cfg["blocks_an_sm"] >= 1


def test_fused_head_refuses_what_it_does_not_take(device):
    model = head_model(*WIDTHS["amazon2m"], device=device)
    launch = mlp_head.head_launcher(model)
    x = rows(100, 100, device=device)
    with pytest.raises(TypeError):
        launch(x.double())
    with pytest.raises(ValueError):
        launch(x[:, :50])
    with pytest.raises(ValueError):
        mlp_head.head_launcher(model.train())


def test_fused_head_waits_for_the_writes_before_it(device):
    """A launch that does not follow another of the kernel's waits for the
    kernels before it: rows written by a copy right before each of 20
    launches, each against its own rows' plain logits."""
    f, h, c = WIDTHS["amazon2m"]
    model = head_model(f, h, c, device=device)
    launch = mlp_head.head_launcher(model)
    sources = [rows(10000, f, seed=s, device=device) for s in range(4)]
    x = torch.empty_like(sources[0])
    outs = []
    for k in range(20):
        x.copy_(sources[k % 4])
        outs.append(launch(x))
    for k, out in enumerate(outs):
        assert torch.equal(out, launch(sources[k % 4]))


def test_fused_head_after_head_reads_writes_made_before_the_head(device):
    """``_after_head``'s contract, as ``predict_logits`` keeps it: a copy
    writes two chunks' rows, the first chunk's launch waits for it, and the
    second's, right after, skips its wait and still reads the copy's rows
    (it starts only once every block of the first has passed that wait).
    Twenty rounds, each against the rows' launch alone."""
    f, h, c = WIDTHS["amazon2m"]
    model = head_model(f, h, c, device=device)
    launch = mlp_head.head_launcher(model)
    sources = [rows(20000, f, seed=s, device=device) for s in range(4)]
    x = torch.empty_like(sources[0])
    outs = []
    for k in range(20):
        x.copy_(sources[k % 4])
        outs.append((launch(x[:10000]), launch(x[10000:], _after_head=True)))
    for k, (a, b) in enumerate(outs):
        src = sources[k % 4]
        assert torch.equal(a, launch(src[:10000]))
        assert torch.equal(b, launch(src[10000:]))


def test_overlapped_launches_keep_their_bits(device):
    """Chunks launched one after another with ``_after_head`` (each may run
    beside the one before it) give the bits of launches one at a time."""
    f, h, c = WIDTHS["reddit"]
    model = head_model(f, h, c, device=device)
    launch = mlp_head.head_launcher(model)
    x = rows(50000, f, device=device)
    alone = []
    for i in range(0, 50000, 10000):
        alone.append(launch(x[i: i + 10000]))
        torch.cuda.synchronize()
    together = [launch(x[i: i + 10000], _after_head=i > 0)
                for i in range(0, 50000, 10000)]
    assert all(torch.equal(a, b) for a, b in zip(alone, together))


@pytest.mark.parametrize("path", ["dense", "mag"])
def test_head_span_counts_fused_rows(device, path):
    """``fused_rows`` is every row where the kernel engaged (an MLP: one
    launch a chunk) and 0 for the MAG head."""
    from torch.profiler import ProfilerActivity, profile

    before = mlp_head.head_launcher.launches
    observe.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        got = owned_logits(path, seed=3, device=device)
    recs = observe.spans()
    observe.clear()
    head = next(r for r in recs if r["name"] == "infer.classify.head")
    fused = got.shape[0] if path == "dense" else 0
    assert head["counts"] == {"fused_rows": fused}
    assert mlp_head.head_launcher.launches - before == (3 if fused else 0)

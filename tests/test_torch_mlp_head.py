"""The classifier's hand-written eval head (``grandtpu_torch/nn/mlp_head.py``)
on the CPU: its plain version against ``MLP.forward`` in eval, and which
models the card path of ``predict_logits`` hands to the kernel.

Tolerance: max |head - forward| <= 2e-6 of the largest |logit| (f32 sums
over F and H in another order, and the hidden node_norm and BatchNorm
folded past ``fcs[1]``; measured up to 6.4e-7). The kernel itself runs on
a card only: ``tests/test_torch_classify_cuda.py``.
"""

import math

import pytest
import torch

from grandtpu_torch import observe
from grandtpu_torch.dist import make_mesh
from grandtpu_torch.infer import classify
from grandtpu_torch.nn import mlp_head
from grandtpu_torch.nn.mag_mlp import MagMLP
from grandtpu_torch.nn.mlp import MLP, MLPConfig

# the cells' widths (F, hidden, classes): amazon2m-predict, reddit-predict
WIDTHS = {"amazon2m": (100, 1024, 47), "reddit": (602, 512, 41)}
TOL = 2e-6


def head_model(f, h, c, use_bn=True, node_norm=True, seed=0, nlayers=2,
               device="cpu"):
    """An eval-mode MLP with weights as torch's init draws them and BN
    running stats as a model that saw node-normalised rows would carry
    (the benchmark's ``weights.py`` recipe), from ``seed``."""
    with torch.device(device):
        model = MLP(MLPConfig(num_features=f, num_classes=c, hidden=h,
                              nlayers=nlayers, use_bn=use_bn,
                              node_norm=node_norm))
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for fc in model.fcs:
            b = 1.0 / math.sqrt(fc.in_features)
            fc.weight.copy_(torch.rand(fc.weight.shape, generator=g) * 2 * b
                            - b)
            fc.bias.copy_(torch.rand(fc.bias.shape, generator=g) * 2 * b - b)
        for bn in model.bns:
            d = bn.weight.shape[0]
            bn.weight.copy_(1.0 + 0.1 * torch.randn(d, generator=g))
            bn.bias.copy_(0.1 * torch.randn(d, generator=g))
            bn.running_mean.copy_(0.3 / math.sqrt(d)
                                  * torch.randn(d, generator=g))
            bn.running_var.copy_((0.5 + torch.rand(d, generator=g)) / d)
    return model.eval()


def rows(n, f, seed=1, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, f, generator=g).to(device)


def gap(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def kill_row(model, x, r):
    """Set ``fcs[0]``'s bias so that every hidden unit of row ``r`` of
    ``x`` is -1e-4 before relu (its hidden norm 0), other rows' not: a
    margin far above the products' rounding, and small beside their size,
    so that the other rows' pre-activations cancel no digits."""
    cfg = model.cfg
    with torch.no_grad():
        xr = x[r: r + 1]
        if cfg.node_norm:
            xr = xr / (1e-12 + torch.linalg.vector_norm(xr))
        if cfg.use_bn:
            xr = model.bns[0](xr)
        pre = model.fcs[0].weight @ xr[0]
        model.fcs[0].bias.copy_(-pre - 1e-4)


@pytest.mark.parametrize("node_norm", [True, False], ids=["norm", "nonorm"])
@pytest.mark.parametrize("use_bn", [True, False], ids=["bn", "nobn"])
@pytest.mark.parametrize("widths", list(WIDTHS))
def test_plain_head_matches_the_eval_forward(widths, use_bn, node_norm):
    f, h, c = WIDTHS[widths]
    model = head_model(f, h, c, use_bn, node_norm)
    x = rows(300, f)
    with torch.no_grad():
        want = model(x)
    got = mlp_head.eval_head_plain(model, x)
    assert got.shape == (300, c) and got.dtype == torch.float32
    assert gap(got, want) <= TOL


@pytest.mark.parametrize("widths", list(WIDTHS))
def test_plain_head_on_a_row_whose_hidden_norm_is_zero(widths):
    f, h, c = WIDTHS[widths]
    model = head_model(f, h, c)
    x = rows(200, f)
    kill_row(model, x, 7)
    with torch.no_grad():
        xn = x / (1e-12 + torch.linalg.vector_norm(x, dim=-1, keepdim=True))
        hidden = torch.relu(model.fcs[0](model.bns[0](xn)))
        want = model(x)
    assert (hidden[7] == 0).all() and (hidden.sum(1) > 0).sum() >= 150
    got = mlp_head.eval_head_plain(model, x)
    assert torch.isfinite(got).all()
    assert gap(got, want) <= TOL
    assert gap(got[7], want[7]) <= TOL


@pytest.mark.parametrize("widths", list(WIDTHS))
def test_plain_head_chunk_by_chunk_with_a_ragged_last_chunk(widths):
    """The head on 128-row chunks of 300 rows (the last 44), as
    ``predict_logits`` cuts them, against the forward on all rows."""
    f, h, c = WIDTHS[widths]
    model = head_model(f, h, c)
    x = rows(300, f)
    chunks = [x[i: i + 128] for i in range(0, 300, 128)]
    assert [len(ch) for ch in chunks] == [128, 128, 44]
    got = torch.cat([mlp_head.eval_head_plain(model, ch) for ch in chunks])
    with torch.no_grad():
        want = model(x)
    assert got.shape == want.shape
    assert gap(got, want) <= TOL


@pytest.mark.parametrize("widths", list(WIDTHS))
def test_the_kernel_takes_an_eval_two_layer_mlp(widths):
    """The model's kind; whether the kernel has room for its widths is the
    library's to say, on a card (``tests/test_torch_classify_cuda.py``)."""
    model = head_model(*WIDTHS[widths])
    assert mlp_head.takes(model)


def _refused(case):
    f, h, c = WIDTHS["amazon2m"]
    if case == "mag":
        with torch.device("cpu"):
            return MagMLP(MLPConfig(num_features=64, num_classes=8,
                                    hidden=64, nlayers=2)).eval()
    if case in ("nlayers1", "nlayers3"):
        return head_model(f, h, c, nlayers=int(case[-1]))
    if case == "training":
        return head_model(f, h, c).train()
    if case == "model_split":
        mesh = make_mesh(1, n_model=2, device="cpu")
        return head_model(f, h, c).shard_hidden(mesh).eval()
    if case == "bf16":
        return head_model(f, h, c).to(torch.bfloat16)
    raise ValueError(case)


@pytest.mark.parametrize("case", ["mag", "nlayers1", "nlayers3", "training",
                                  "model_split", "bf16"])
def test_the_card_path_keeps_the_forward_of_other_models(case):
    model = _refused(case)
    assert not mlp_head.takes(model)
    _, fused = classify.chunk_head(model, torch.device("cpu"))
    assert not fused


def test_the_card_path_keeps_the_forward_of_a_model_on_another_device():
    """A model the kernel takes, whose weights are not on the rows' device:
    the module's forward (the library is not asked)."""
    model = head_model(*WIDTHS["reddit"])
    assert mlp_head.takes(model)
    _, fused = classify.chunk_head(model, torch.device("cuda"))
    assert not fused


def test_the_module_path_runs_the_forward():
    model = _refused("nlayers3")
    run, fused = classify.chunk_head(model, torch.device("cpu"))
    x = rows(10, model.cfg.num_features)
    with torch.no_grad():
        assert not fused and torch.equal(run(x, _after_head=True), model(x))


def test_head_span_counts_no_fused_rows_off_a_card():
    from torch.profiler import ProfilerActivity, profile

    model = head_model(12, 16, 5)
    x = rows(130, 12)
    observe.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        classify.predict_logits(model, x, batch_size=50)
    recs = observe.spans()
    observe.clear()
    head = next(r for r in recs if r["name"] == "infer.classify.head")
    assert head["counts"] == {"fused_rows": 0}

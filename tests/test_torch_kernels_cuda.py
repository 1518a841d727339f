"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips where no CUDA device is present. On a
machine with a card and without JAX, run them with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest imports JAX). Shapes cover the edge
cases the full-width checks in ``chip_smoke.py`` do not: K = 1..8, odd
widths, empty and fully masked rows, hub rows, for K1 a grid of F, Ktop, K
and batch (every vector width, lane groups, rows a block, tiles), views
that start off a vector's alignment, the same bits on repeated calls and
the Python mirror of its launch configuration, and for K3 attribute-free
nodes, input dropout, colliding ids (the backward's runs of equal ids) and
the node form, the backward's bits on repeated calls and against its
plain version (every form, Zipf-like ids, more entries than one block's
shared memory holds, H past 64 features), inside a CUDA graph's
replays, with no sort or fill of PyTorch's among its launches, and the
Python mirror of its scratch size, a grid of Ktop, P, H and K for the forward's warps, lane groups and id
lists, the forward's bits on repeated calls, and its vocab-window form (an
empty window, the whole vocabulary, ids on the window's edges, the windows
summing to the full op); for the fast-precision hops (K2-bf16, quantize,
K2-q8, K2-q8mxu) f32 and bf16 carries, widths that are not a multiple of 4
or 32, an all-zero column, a 9000-nonzero hub row and a one-row operator;
for the GFPush kernels (top-k, P1's push mask, P2's hop and reserve merge)
ties, rows with fewer than k positives, a dangling node, a 9000-nonzero hub
source and determinism, and for the top-k rows past its shared-memory
candidate buffer (233,000 and 20,000 positives, one row all equal) and P1's
and P2's full shapes at k 64 and 1024; for K2 and K2-bf16 split hub rows
(20,000 and 150,000 nonzeros beside empty rows) at F 1, 33, 64, 100 and 602,
both carry types, with and without accumulate, against the plain version
(which follows the same split plan) and the unsplit hop, and for K2-q8 and
K2-q8mxu the same hub rows at F 1, 16, 33, 64, 100, 128 and 602 (every
vector width of their lane groups, and several tiles) bit for bit their
plain versions (K2-q8mxu's split hop bit for bit its unsplit one), the
unsplit hops and misaligned views at those widths, rows shorter than the
kernels' batch of edges and split rows whose last chunk is, and the Python
mirrors of their configuration choice and alignment rule against the
kernels' own; for K2-seg (coo_spmm; its bf16-carry form bit for bit, split
hub rows included), D1's halo_pack (its send plan: a row
every receiver needs, empty and all-padding groups, a row longer than a plan
item, two windows of shared scales) and halo_hop (each form) and the
quantize split (column_absmax, quantize_with_amax) 4-wide and 1-wide lanes,
a 9000-nonzero hub row, empty rows and an empty shard; for Adam
(csrc/adam.cu) bit for bit its plain version on the reddit MLP's leaves,
the MAG table [2780000, 64] and head, a leaf without a gradient, leaves
off the 16-byte alignment and of odd lengths, and more leaves than one
launch takes, with and without weight decay, and the Python mirror of its
leaf cap.
"""

import ctypes
import functools

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from grandtpu_torch.nn.dropnode import (K1Config, gather_and_prop,
                                        gather_and_prop_plain, k1_align,
                                        k1_config)
from grandtpu_torch.ppr.coef import build_coef
from grandtpu_torch.ppr.dense_push import (dense_push_mask,
                                           dense_push_mask_plain)
from grandtpu_torch.ppr.push_topk import (push_topk, push_topk_plain,
                                          row_offsets)
from grandtpu_torch.data import synthetic_graph
from grandtpu_torch.nn.sparse_input import (PaddedFeatures, bwd_scratch_bytes,
                                            embed_prop, embed_prop_backward,
                                            embed_prop_backward_plain,
                                            embed_prop_plain,
                                            embed_prop_window,
                                            embed_prop_window_backward)
from grandtpu_torch.ops._build import load_kernels
from grandtpu_torch.sparse.spmm import (CSROperator, Q8HopConfig, bf16_ulps,
                                        q8_hop_align, q8_hop_config,
                                        quantize_columns,
                                        quantize_columns_plain,
                                        row_values_if_constant,
                                        spmm_prop_step, spmm_prop_step_bf16,
                                        spmm_prop_step_plain,
                                        spmm_prop_step_q8,
                                        spmm_prop_step_q8_plain,
                                        spmm_prop_step_q8mxu,
                                        spmm_prop_step_q8mxu_plain)

pytestmark = pytest.mark.cuda

TOL = 1e-5   # max |kernel - plain| / max |plain|, f32 sums in another order


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel_err(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


@pytest.mark.parametrize("num_aug,batch,ktop,nfeat", [
    (1, 5, 7, 3), (2, 33, 64, 602), (3, 8, 33, 257), (8, 4, 5, 1000),
])
def test_dropnode_mean_kernel_matches_plain(device, num_aug, batch, ktop,
                                            nfeat):
    rs = np.random.RandomState(0)
    n = 50
    features = torch.tensor(rs.randn(n, nfeat).astype(np.float32),
                            device=device)
    cols = torch.tensor(rs.randint(0, n, (batch, ktop)).astype(np.int32),
                        device=device)
    vals_np = rs.rand(batch, ktop).astype(np.float32)
    vals_np[0] = 0.0                       # a row of padding only
    vals = torch.tensor(vals_np, device=device)
    keep_np = rs.rand(num_aug, batch, ktop) < 0.5
    keep_np[:, 1] = False                  # a row whose mask drops all
    keep = torch.tensor(keep_np, device=device)

    before = gather_and_prop.launches
    got = gather_and_prop(features, cols, vals, keep)
    got_eval = gather_and_prop(features, cols, vals)
    torch.cuda.synchronize()
    assert gather_and_prop.launches == before + 2
    assert got.shape == (num_aug, batch, nfeat)
    assert _rel_err(got, gather_and_prop_plain(features, cols, vals,
                                               keep)) <= TOL
    assert _rel_err(got_eval, gather_and_prop_plain(features, cols,
                                                    vals)) <= TOL
    assert float(got[:, 0].abs().max()) == 0.0
    assert float(got[:, 1].abs().max()) == 0.0


def _k1_case(device, n, nfeat, batch, ktop, num_aug, seed):
    """K1 inputs with padding slots, slots that every mask drops and, where
    the batch has room, a row of padding only (row 0) and a row that every
    mask drops (row 1)."""
    rs = np.random.RandomState(seed)
    features = torch.tensor(rs.randn(n, nfeat).astype(np.float32),
                            device=device)
    cols = torch.tensor(rs.randint(0, n, (batch, ktop)).astype(np.int32),
                        device=device)
    vals_np = rs.rand(batch, ktop).astype(np.float32)
    vals_np[:, ktop - ktop // 4:] = 0.0    # padding slots
    keep_np = rs.rand(num_aug, batch, ktop) < 0.5
    keep_np[:, :, ::3] = False             # slots every mask drops
    if batch >= 3:
        vals_np[0] = 0.0
        keep_np[:, 1] = False
    return (features, cols, torch.tensor(vals_np, device=device),
            torch.tensor(keep_np, device=device))


@pytest.mark.parametrize("batch", [1, 1410])
@pytest.mark.parametrize("num_aug", [1, 2, 8])
@pytest.mark.parametrize("ktop", [1, 7, 32, 64, 128])
@pytest.mark.parametrize("nfeat", [1, 3, 100, 101, 602, 1000])
def test_dropnode_mean_grid_matches_plain(device, nfeat, ktop, num_aug,
                                          batch):
    """Every vector width (float4 at F 100 and 1000, float2 at 602, one
    float at 1, 3 and 101), lane groups (F 1, 3), rows a block (Ktop 1, 7),
    several tiles and warps a row, the train and eval forms, the same bits
    on a second call."""
    features, cols, vals, keep = _k1_case(device, 3000, nfeat, batch, ktop,
                                          num_aug, nfeat * 7 + ktop)
    before = gather_and_prop.launches
    got = gather_and_prop(features, cols, vals, keep)
    got_eval = gather_and_prop(features, cols, vals)
    again = gather_and_prop(features, cols, vals, keep)
    torch.cuda.synchronize()
    assert gather_and_prop.launches == before + 3
    assert got.shape == (num_aug, batch, nfeat)
    assert _rel_err(got, gather_and_prop_plain(features, cols, vals,
                                               keep)) <= TOL
    assert _rel_err(got_eval, gather_and_prop_plain(features, cols,
                                                    vals)) <= TOL
    assert torch.equal(got, again)
    if batch >= 3:
        assert float(got[:, 0].abs().max()) == 0.0
        assert float(got[:, 1].abs().max()) == 0.0
        assert float(got_eval[:, 0].abs().max()) == 0.0


@pytest.mark.parametrize("offset,vec", [(1, 1), (2, 2)])
@pytest.mark.parametrize("nfeat", [100, 602])
def test_dropnode_mean_on_a_misaligned_view(device, nfeat, offset, vec):
    """A contiguous view of features that starts 4 or 8 bytes past a
    16-byte boundary: the kernel takes the narrower vector there (one
    float, or float2 where F is even), and reads nothing out of line."""
    n = 2000
    _, cols, vals, keep = _k1_case(device, n, nfeat, 250, 64, 2, offset)
    rs = np.random.RandomState(nfeat)
    base = torch.tensor(rs.randn(n * nfeat + 8).astype(np.float32),
                        device=device)
    assert base.data_ptr() % 16 == 0
    features = base.view(-1)[offset:offset + n * nfeat].view(n, nfeat)
    assert k1_align(features) == offset
    assert k1_config(64, nfeat, 2, k1_align(features)).vec == vec
    got = gather_and_prop(features, cols, vals, keep)
    torch.cuda.synchronize()
    assert _rel_err(got, gather_and_prop_plain(features, cols, vals,
                                               keep)) <= TOL


def test_dropnode_mean_gives_the_same_bits(device):
    """Repeated calls at the reddit train form give the same bits: the sums
    meet in a fixed order, with no float atomics."""
    features, cols, vals, keep = _k1_case(device, 20000, 602, 250, 64, 2, 3)
    first = gather_and_prop(features, cols, vals, keep)
    first_eval = gather_and_prop(features, cols, vals)
    for _ in range(5):
        assert torch.equal(gather_and_prop(features, cols, vals, keep), first)
        assert torch.equal(gather_and_prop(features, cols, vals), first_eval)


def test_k1_config_matches_the_kernel(device):
    """nn/dropnode.py's k1_config against the kernel's own choice
    (dropnode_mean_config) for every F in 1..1100, each alignment and
    several Ktop and K."""
    lib = load_kernels()
    out = (ctypes.c_int * 7)()
    for nfeat in range(1, 1101):
        for align in (1, 2, 4):
            for ktop, num_aug in ((64, 2), (64, 1), (7, 1), (1000, 8),
                                  (0, 3)):
                assert lib.dropnode_mean_config(ktop, nfeat, num_aug, align,
                                                out) == 0
                assert K1Config(*out) == k1_config(ktop, nfeat, num_aug,
                                                   align), (nfeat, align,
                                                            ktop, num_aug)
    assert lib.dropnode_mean_config(64, 0, 2, 4, out) != 0


def test_dropnode_mean_wrapper_rejects_bad_input(device):
    features = torch.zeros(4, 8, device=device)
    vals = torch.ones(2, 3, device=device)
    with pytest.raises(TypeError):
        gather_and_prop(features, torch.zeros(2, 3, dtype=torch.int64,
                                              device=device), vals)
    with pytest.raises(ValueError):
        gather_and_prop(features, torch.zeros(2, 3, dtype=torch.int32), vals)


@pytest.mark.parametrize("nfeat", [1, 33, 602])
@pytest.mark.parametrize("accumulate", [True, False])
def test_csr_spmm_kernel_matches_plain(device, nfeat, accumulate):
    rs = np.random.RandomState(1)
    n = 300
    adj = sp.random(n, n, density=0.02, random_state=rs, format="lil")
    adj[5, :] = 0.0                        # an empty row
    adj[7, :200] = 1.0                     # a hub row
    adj = adj.tocsr()
    op = CSROperator.from_scipy(adj, device)
    x = torch.tensor(rs.randn(n, nfeat).astype(np.float32), device=device)
    acc0 = torch.tensor(rs.randn(n, nfeat).astype(np.float32),
                        device=device)

    out_k, acc_k = torch.empty_like(x), acc0.clone()
    out_p, acc_p = torch.empty_like(x), acc0.clone()
    before = spmm_prop_step.launches
    spmm_prop_step(op, x, out_k, acc_k, 0.8, accumulate)
    torch.cuda.synchronize()
    assert spmm_prop_step.launches == before + 1
    spmm_prop_step_plain(op, x, out_p, acc_p, 0.8, accumulate)
    assert _rel_err(out_k, out_p) <= TOL
    assert _rel_err(acc_k, acc_p) <= TOL
    assert float(out_k[5].abs().max()) == 0.0


def _k3_inputs(device, num_aug, rows, ktop, p, h, q, collide, node_form,
               seed=0):
    rs = np.random.RandomState(seed)
    vocab, n = 300, 50
    table = rs.randn(vocab, h).astype(np.float32)
    attr_cols = rs.randint(0, vocab, (n, p)).astype(np.int32)
    if collide:
        attr_cols[:] = 7                   # every id the same table row
    attr_vals = rs.rand(n, p).astype(np.float32)
    attr_vals[:, p // 2:] *= rs.rand(n, p - p // 2) < 0.5   # padding
    attr_vals[3] = 0.0                     # a node with no attributes
    args = {"attr_cols": attr_cols, "attr_vals": attr_vals}
    if node_form:
        args = {k: v[:rows] for k, v in args.items()}
        drop_shape = (num_aug, rows, p, h)
    else:
        tk_cols = rs.randint(0, n, (rows, ktop)).astype(np.int32)
        tk_cols[0, 0] = 3
        tk_vals = rs.rand(rows, ktop).astype(np.float32)
        tk_vals[-1, ktop // 2:] = 0.0      # top-k padding
        keep = rs.rand(num_aug, rows, ktop) < 0.5
        keep[:, min(1, rows - 1)] = False  # a row whose mask drops all
        args.update(tk_cols=tk_cols, tk_vals=tk_vals, keep=keep)
        drop_shape = (num_aug, rows, ktop, p, h)
    if q > 0:
        args["drop"] = rs.rand(*drop_shape) < 1.0 - q
    grad = rs.randn(num_aug, rows, h).astype(np.float32)
    to = {k: torch.tensor(v, device=device) for k, v in args.items()}
    return (torch.tensor(table, device=device), to,
            torch.tensor(grad, device=device))


def _k3_check(device, num_aug, rows, ktop, p, h, q, collide=False,
              node_form=False):
    table, args, grad = _k3_inputs(device, num_aug, rows, ktop, p, h, q,
                                   collide, node_form)
    fwd0, bwd0 = embed_prop.launches, embed_prop_backward.launches
    t_k = table.clone().requires_grad_(True)
    out = embed_prop(t_k, droprate=q, **args)
    (out * grad).sum().backward()
    torch.cuda.synchronize()
    assert embed_prop.launches == fwd0 + 1
    assert embed_prop_backward.launches == bwd0 + 1
    t_p = table.clone().requires_grad_(True)
    want = embed_prop_plain(t_p, droprate=q, **args)
    (want * grad).sum().backward()
    assert out.shape == want.shape == (num_aug, rows, h)
    assert _rel_err(out.detach(), want.detach()) <= TOL
    # the backward adds an id's terms in entry order, autograd's scatter in
    # another
    assert _rel_err(t_k.grad, t_p.grad) <= TOL
    return out


@pytest.mark.parametrize("num_aug,rows,ktop,p,h,q", [
    (1, 5, 7, 3, 64, 0.0), (2, 40, 32, 24, 64, 0.0), (2, 40, 32, 24, 64, 0.5),
    (3, 9, 33, 37, 33, 0.5), (5, 4, 3, 5, 130, 0.0), (8, 6, 5, 5, 1, 0.5),
    (8, 3, 9, 2, 64, 0.0),
])
def test_embed_prop_kernels_match_plain(device, num_aug, rows, ktop, p, h,
                                        q):
    out = _k3_check(device, num_aug, rows, ktop, p, h, q)
    assert float(out.detach()[:, min(1, rows - 1)].abs().max()) == 0.0


@pytest.mark.parametrize("q", [0.0, 0.5])
def test_embed_prop_kernels_with_colliding_ids(device, q):
    _k3_check(device, 2, 40, 32, 24, 64, q, collide=True)


@pytest.mark.parametrize("num_aug,q,h", [(1, 0.0, 64), (2, 0.5, 33),
                                         (1, 0.0, 3)])
def test_embed_prop_node_form_matches_plain(device, num_aug, q, h):
    out = _k3_check(device, num_aug, 40, 1, 24, h, q, node_form=True)
    assert float(out.detach()[:, 3].abs().max()) == 0.0


_K3_GRID = [(ktop, p, h) for ktop in (1, 7, 32, 64) for p in (1, 24, 33)
            for h in (1, 16, 64, 100)]


@pytest.mark.parametrize("i,ktop,p,h", [(i, *c) for i, c in
                                        enumerate(_K3_GRID)])
def test_embed_prop_forward_grid_matches_plain(device, i, ktop, p, h):
    """The forward (and backward) across Ktop 1, 7, 32, 64 (a warp a slot,
    rows sharing a block, two slots a warp), P 1, 24, 33 (one and two id
    lists), H 1, 16, 64, 100 (one float a lane; float4 lane groups of 4 and
    16 lanes; two feature chunks), each (K, input dropout) of K 1, 2, 8
    with and without dropout on eight grid points."""
    num_aug = (1, 2, 8)[i % 3]
    q = 0.5 if (i // 3) % 2 else 0.0
    _k3_check(device, num_aug, 9, ktop, p, h, q)


@pytest.mark.parametrize("window", ["all", "some", "none"])
@pytest.mark.parametrize("ktop,p,h,num_aug,q", [
    (7, 24, 16, 2, 0.5), (32, 33, 100, 8, 0.0), (64, 1, 1, 1, 0.5),
    (1, 24, 64, 2, 0.0)])
def test_embed_prop_window_forward_grid_matches_plain(device, window, ktop,
                                                      p, h, num_aug, q):
    """The window forward over windows holding all, some or none of the
    ids (the ids outside take no gather), against its plain version."""
    table, args, _ = _k3_inputs(device, num_aug, 9, ktop, p, h, q, False,
                                False)
    lo, hi = {"all": (0, 300), "some": (120, 210),
              "none": (300, 310)}[window]
    shard = (torch.randn(hi - lo, h, device=device) if window == "none"
             else table[lo:hi].contiguous())
    with torch.no_grad():
        got = embed_prop_window(shard, lo, hi, **args, droprate=q)
    want = embed_prop_plain(shard, **args, droprate=q, vocab_lo=lo,
                            vocab_hi=hi)
    assert got.shape == (num_aug, 9, h)
    if window == "none":
        assert not got.any()
    else:
        assert _rel_err(got, want) <= TOL


@pytest.mark.parametrize("q,node_form", [(0.0, False), (0.5, False),
                                         (0.0, True)])
def test_embed_prop_forward_repeats_bit_for_bit(device, q, node_form):
    """No float atomics in the forward: the same bits on every call."""
    table, args, _ = _k3_inputs(device, 2, 40, 1 if node_form else 32, 24,
                                64, q, False, node_form)
    with torch.no_grad():
        outs = [embed_prop(table, **args, droprate=q) for _ in range(3)]
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


@pytest.mark.parametrize("q,collide,window", [(0.0, False, False),
                                              (0.5, False, False),
                                              (0.0, True, False),
                                              (0.0, False, True)])
def test_embed_prop_backward_repeats_bit_for_bit(device, q, collide, window):
    """No float atomics in the backward: each id's terms added in entry
    order, the same bits on every call (every id the same row, where the
    atomics of the earlier backward met most; a vocab window)."""
    table, args, grad = _k3_inputs(device, 2, 40, 32, 24, 64, q, collide,
                                   False)
    lo, hi = (30, 70) if window else (0, table.shape[0])
    grads = []
    for _ in range(3):
        t = table[lo:hi].clone().requires_grad_(True)
        out = (embed_prop_window(t, lo, hi, droprate=q, **args) if window
               else embed_prop(t, droprate=q, **args))
        (out * grad).sum().backward()
        grads.append(t.grad)
    assert all(torch.equal(g, grads[0]) for g in grads[1:])
    assert grads[0].abs().max() > 0


def test_embed_prop_wrapper_rejects_bad_input(device):
    table = torch.zeros(10, 4, device=device)
    cols = torch.zeros(3, 2, dtype=torch.int32, device=device)
    vals = torch.ones(3, 2, device=device)
    with pytest.raises(TypeError):
        embed_prop(table, cols.long(), vals)
    with pytest.raises(TypeError):
        embed_prop(table.double(), cols, vals)
    with pytest.raises(ValueError):
        embed_prop(table, cols.cpu(), vals)
    with pytest.raises(ValueError):             # K > 8
        embed_prop(table, cols, vals, cols, vals,
                   torch.ones(9, 3, 2, dtype=torch.bool, device=device))
    with pytest.raises(ValueError):             # drop of the wrong shape
        embed_prop(table, cols, vals,
                   drop=torch.ones(1, 3, 2, 5, dtype=torch.bool,
                                   device=device), droprate=0.5)


def _k3_window_run(fn, table, lo, hi, args, grad, q):
    t = table.clone().requires_grad_(True)
    out = fn(t, lo, hi, **args, droprate=q) if hi is not None else \
        fn(t, **args, droprate=q)
    (out * grad).sum().backward()
    return out.detach(), t.grad


@pytest.mark.parametrize("window", ["empty", "all", "edges"])
@pytest.mark.parametrize("q,node_form", [(0.0, False), (0.5, False),
                                         (0.5, True)])
def test_embed_prop_window_kernels_match_plain(device, window, q,
                                               node_form):
    """K3 over a vocab window against its plain version: an empty window
    (past the vocabulary: nothing added, a zero gradient), the whole
    vocabulary (the full op bit for bit) and ids just inside and just
    outside both edges."""
    table, args, grad = _k3_inputs(device, 2, 40, 1 if node_form else 32,
                                   24, 64, q, False, node_form)
    lo, hi = {"empty": (300, 340), "all": (0, 300),
              "edges": (100, 200)}[window]
    # ids on the edges, in a node every form reads (node 3 has no values)
    args["attr_cols"][0, :4] = torch.tensor([99, 100, 199, 200])
    if not node_form:
        args["tk_cols"][:, 0] = 0
    shard = (torch.randn(hi - lo, 64, device=device) if window == "empty"
             else table[lo:hi].contiguous())
    fwd0 = embed_prop_window.launches
    bwd0 = embed_prop_window_backward.launches
    out_k, d_k = _k3_window_run(embed_prop_window, shard, lo, hi, args,
                                grad, q)
    torch.cuda.synchronize()
    assert embed_prop_window.launches == fwd0 + 1
    assert embed_prop_window_backward.launches == bwd0 + 1
    t_p = shard.clone().requires_grad_(True)
    want = embed_prop_plain(t_p, **args, droprate=q, vocab_lo=lo,
                            vocab_hi=hi)
    (want * grad).sum().backward()
    assert d_k.shape == (hi - lo, 64)
    if window == "empty":
        assert not out_k.any() and not d_k.any()
        return
    assert _rel_err(out_k, want.detach()) <= TOL
    assert _rel_err(d_k, t_p.grad) <= TOL
    if window == "all":
        full, d_full = _k3_window_run(embed_prop, table, None, None, args,
                                      grad, q)
        assert torch.equal(out_k, full)
    else:
        assert float(d_k[0].abs().max()) > 0.0      # id 100 is in
        assert float(d_k[-1].abs().max()) > 0.0     # id 199 is in


@pytest.mark.parametrize("shards", [3, 4])
def test_embed_prop_windows_sum_to_the_full_op(device, shards):
    table, args, grad = _k3_inputs(device, 2, 40, 32, 24, 64, 0.5, False,
                                   False)
    per = -(-300 // shards)
    padded = torch.cat([table, table.new_zeros(per * shards - 300, 64)])
    full, d_full = _k3_window_run(embed_prop, table, None, None, args, grad,
                                  0.5)
    outs, grads = zip(*(_k3_window_run(
        embed_prop_window, padded[s * per:(s + 1) * per].contiguous(),
        s * per, (s + 1) * per, args, grad, 0.5) for s in range(shards)))
    assert _rel_err(sum(outs), full) <= TOL
    assert _rel_err(torch.cat(grads)[:300], d_full) <= TOL
    assert not torch.cat(grads)[300:].any()


@pytest.mark.parametrize("h,q", [(64, 0.0), (64, 0.5), (66, 0.5)])
def test_embed_prop_on_a_column_block_matches_plain(device, h, q):
    """K3 forward and backward on each model shard's column block [V, H/2]
    of the table (a strided slice made contiguous, as
    ``MagMLP.shard_columns`` stores it; H/2 = 33 takes the scalar path),
    with the input-dropout mask's matching columns, against the plain
    version; the blocks join to the full op's output and gradient."""
    table, args, grad = _k3_inputs(device, 2, 40, 32, 24, h, q, False, False)
    w = h // 2
    full, d_full = _k3_window_run(embed_prop, table, None, None, args, grad,
                                  q)
    outs, grads = [], []
    for m in range(2):
        cols = slice(m * w, (m + 1) * w)
        block = table[:, cols].contiguous()
        part = dict(args)
        if "drop" in part:
            part["drop"] = part["drop"][..., cols].contiguous()
        g = grad[..., cols].contiguous()
        fwd0, bwd0 = embed_prop.launches, embed_prop_backward.launches
        out, d_k = _k3_window_run(embed_prop, block, None, None, part, g, q)
        assert embed_prop.launches == fwd0 + 1
        assert embed_prop_backward.launches == bwd0 + 1
        t_p = block.clone().requires_grad_(True)
        want = embed_prop_plain(t_p, droprate=q, **part)
        (want * g).sum().backward()
        assert _rel_err(out, want.detach()) <= TOL
        assert _rel_err(d_k, t_p.grad) <= TOL
        outs.append(out)
        grads.append(d_k)
    assert _rel_err(torch.cat(outs, -1), full) <= TOL
    assert _rel_err(torch.cat(grads, 1), d_full) <= TOL


def _k3_saved(args, q, dims):
    """The saved inputs the backward wrappers take after ``grad``."""
    return (args["attr_cols"], args["attr_vals"], args.get("tk_cols"),
            args.get("tk_vals"), args.get("keep"), args.get("drop"), q, dims)


def _k3_backward(grad, lo, hi, args, q, dims):
    """The backward kernels over [lo, hi) (the full wrapper for the whole
    300-word vocabulary, else the window's)."""
    saved = _k3_saved(args, q, dims)
    if (lo, hi) == (0, 300):
        return embed_prop_backward(grad, 300, *saved)
    return embed_prop_window_backward(grad, lo, hi, *saved)


@pytest.mark.parametrize("num_aug,rows,ktop,p,h,q,collide,node_form", [
    (2, 40, 32, 24, 64, 0.0, False, False),    # the MAG train step
    (2, 40, 32, 24, 64, 0.5, False, False),    # with input dropout
    (1, 240, 32, 24, 64, 0.0, False, False),   # the eval form's rows
    (3, 9, 33, 37, 33, 0.5, False, False),
    (5, 4, 3, 5, 130, 0.0, False, False),
    (8, 6, 5, 5, 1, 0.5, False, False),
    (2, 40, 32, 24, 64, 0.0, True, False),     # one id: a long segment
    (2, 40, 32, 24, 64, 0.5, True, False),
    (2, 40, 32, 24, 300, 0.0, True, False),    # H past a block's threads
    (2, 40, 1, 24, 64, 0.5, False, True),      # node form
    (1, 40, 1, 24, 3, 0.0, False, True),
])
@pytest.mark.parametrize("window", [(0, 300), (5, 105), (300, 340)])
def test_embed_prop_backward_matches_its_plain_version_bit_for_bit(
        device, num_aug, rows, ktop, p, h, q, collide, node_form, window):
    """The backward (terms, counts, segments, each id's terms added in entry
    order) against ``embed_prop_backward_plain``, which does the same
    operations in torch ops: the same bits, over the whole vocabulary, a
    window and an empty window."""
    table, args, grad = _k3_inputs(device, num_aug, rows, ktop, p, h, q,
                                   collide, node_form)
    lo, hi = window
    got = _k3_backward(grad, lo, hi, args, q, (rows, ktop, p, h, num_aug))
    want = embed_prop_backward_plain(grad, lo, hi, **args, droprate=q)
    torch.cuda.synchronize()
    assert got.shape == (hi - lo, h)
    assert torch.equal(got, want)
    assert bool(got.any()) == (hi <= 300)


def _skewed_k3_inputs(device, rows, ktop, num_aug, skew, seed=0):
    """K3's train-form inputs over Zipf-like attribute ids (the synthetic
    generator's ``token_skew``), 4,000 nodes and a 20,000-word vocabulary."""
    _, feats, _ = synthetic_graph(num_nodes=4000, num_classes=4,
                                  num_features=20000, sparse_features=True,
                                  token_skew=skew, seed=seed)
    padded = PaddedFeatures.from_csr(feats)
    rs = np.random.RandomState(seed)
    args = {"attr_cols": padded.attr_cols, "attr_vals": padded.attr_vals,
            "tk_cols": rs.randint(0, 4000, (rows, ktop)).astype(np.int32),
            "tk_vals": rs.rand(rows, ktop).astype(np.float32),
            "keep": rs.rand(num_aug, rows, ktop) < 0.5}
    grad = rs.randn(num_aug, rows, 64).astype(np.float32)
    return ({k: torch.tensor(v, device=device) for k, v in args.items()},
            torch.tensor(grad, device=device), padded)


@pytest.mark.parametrize("skew", [2.0, 4.0, 8.0])
def test_embed_prop_backward_with_skewed_ids(device, skew):
    """Zipf-like ids, whose most frequent ids fill long segments (summed by
    a whole block) beside short ones: bit for bit the plain version, within
    TOL of autograd, the same bits on a second call."""
    rows, ktop, num_aug = 40, 32, 2
    args, grad, padded = _skewed_k3_inputs(device, rows, ktop, num_aug, skew)
    ids = args["attr_cols"][args["tk_cols"].long()]
    live = (args["attr_vals"][args["tk_cols"].long()] != 0) & \
        args["keep"].any(0)[..., None]
    assert int(torch.bincount(ids[live].long()).max()) > 32
    v = padded.num_features
    dims = (rows, ktop, padded.attr_cols.shape[1], 64, num_aug)
    saved = _k3_saved(args, 0.0, dims)
    got = embed_prop_backward(grad, v, *saved)
    again = embed_prop_backward(grad, v, *saved)
    want = embed_prop_backward_plain(grad, 0, v, **args)
    t = torch.randn(v, 64, device=device, requires_grad=True)
    (embed_prop_plain(t, **args) * grad).sum().backward()
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, again)
    assert _rel_err(got, t.grad) <= TOL


@pytest.mark.parametrize("collide", [False, True])
def test_embed_prop_backward_past_one_blocks_shared_memory(device, collide):
    """153,600 entries (200 rows x 32 slots x 24 attributes): more than one
    block's shared memory holds as int32, so that the block summing one id
    of all of them lists its entries over 75 rounds of the ids."""
    table, args, grad = _k3_inputs(device, 2, 200, 32, 24, 64, 0.0, collide,
                                   False)
    dims = (200, 32, 24, 64, 2)
    got = _k3_backward(grad, 0, 300, args, 0.0, dims)
    want = embed_prop_backward_plain(grad, 0, 300, **args)
    t = table.clone().requires_grad_(True)
    (embed_prop_plain(t, **args) * grad).sum().backward()
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert _rel_err(got, t.grad) <= TOL


@pytest.mark.parametrize("q,collide,window", [(0.0, False, False),
                                              (0.5, False, False),
                                              (0.0, True, False),
                                              (0.0, False, True)])
def test_embed_prop_backward_replays_in_a_cuda_graph(device, q, collide,
                                                     window):
    """The backward captured in a CUDA graph (its scratch sized from the
    shapes alone, no host sync): each replay on a new ``grad`` gives the
    eager call's bits on that ``grad``."""
    table, args, grad = _k3_inputs(device, 2, 40, 32, 24, 64, q, collide,
                                   False)
    lo, hi = (5, 105) if window else (0, 300)
    dims = (40, 32, 24, 64, 2)
    static = grad.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _k3_backward(static, lo, hi, args, q, dims)        # build, warm up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _k3_backward(static, lo, hi, args, q, dims)
    g = torch.Generator(device=device).manual_seed(3)
    for _ in range(3):
        new = torch.randn(grad.shape, generator=g, device=device)
        static.copy_(new)
        graph.replay()
        eager = _k3_backward(new, lo, hi, args, q, dims)
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        assert out.abs().max() > 0


@pytest.mark.parametrize("q,collide,window,node_form", [
    (0.0, False, False, False), (0.5, False, False, False),
    (0.0, True, False, False), (0.0, False, True, False),
    (0.5, False, False, True)])
def test_embed_prop_backward_launches_only_its_kernels(device, q, collide,
                                                       window, node_form):
    """One call launches the backward's four kernels and nothing else: no
    sort, no fill or memset of PyTorch's (by name, under torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    ktop = 1 if node_form else 32
    table, args, grad = _k3_inputs(device, 2, 40, ktop, 24, 64, q, collide,
                                   node_form)
    lo, hi = (5, 105) if window else (0, 300)
    dims = (40, ktop, 24, 64, 2)
    _k3_backward(grad, lo, hi, args, q, dims)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _k3_backward(grad, lo, hi, args, q, dims)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 4, names
    assert all("embed_prop_bwd" in n for n in names), names
    assert not any("sort" in n.lower() for n in names)


def test_bwd_scratch_bytes_matches_the_kernels(device):
    """``bwd_scratch_bytes`` (the wrapper's allocation) against the
    kernels' own ``embed_prop_bwd_scratch``, with and without input
    dropout, across K, H and odd entry counts."""
    lib = load_kernels()
    out = (ctypes.c_int64 * 1)()
    for rows, ktop, p, h, k in [(40, 32, 24, 64, 2), (240, 32, 24, 64, 1),
                                (10000, 1, 24, 64, 1), (9, 33, 37, 33, 3),
                                (1, 1, 1, 1, 8), (4, 3, 5, 130, 5)]:
        for drop in (False, True):
            assert lib.embed_prop_bwd_scratch(rows, ktop, p, h, k, drop,
                                              out) == 0
            assert out[0] == bwd_scratch_bytes(rows, ktop, p, h, k, drop)


@functools.lru_cache(maxsize=None)
def _hop_operator(n):
    """Row-normalized D^-1 (adj + I) with an empty row 5 and, when n is
    large enough, a 9000-nonzero hub row 7; plus a copy with varied
    values (a general operator, for the kernels that read values)."""
    rs = np.random.RandomState(4)
    adj = sp.random(n, n, density=min(1.0, 4.0 / n), random_state=rs,
                    format="csr") + sp.eye(n, format="csr")
    if n > 9000:
        adj = adj + sp.csr_matrix((np.ones(9000), (np.full(9000, 7),
                                                   rs.permutation(n)[:9000])),
                                  shape=(n, n))
    keep = np.ones(n, np.float32)
    keep[5:6] = 0.0                        # row 5 empty (when n > 5)
    adj = sp.diags(keep).dot((adj > 0).astype(np.float32)).tocsr()
    adj.eliminate_zeros()
    deg = np.maximum(np.asarray(adj.sum(1)).ravel(), 1e-12)
    norm = sp.diags(1.0 / deg).dot(adj).tocsr().astype(np.float32)
    varied = norm.copy()
    varied.data = (varied.data * rs.uniform(0.5, 1.5, varied.nnz)).astype(
        np.float32)
    return norm, varied


def _carry(x, carry):
    return x.to(torch.bfloat16) if carry == "bf16" else x


@functools.lru_cache(maxsize=None)
def _split_operator():
    """A varied-value operator of 160,000 rows with hub rows of 20,000
    (row 7) and 150,000 (row 11) nonzeros, above the split cap, beside
    empty rows 5 and 6."""
    n = 160000
    rs = np.random.RandomState(9)
    # COO built directly: sp.random at this size samples from n^2 slots
    rows = np.concatenate([rs.randint(0, n, 4 * n), np.arange(n),
                           np.full(20000, 7), np.full(150000, 11)])
    cols = np.concatenate([rs.randint(0, n, 4 * n), np.arange(n),
                           rs.permutation(n)[:20000],
                           rs.permutation(n)[:150000]])
    keep = (rows != 5) & (rows != 6)
    adj = sp.csr_matrix((np.ones(keep.sum(), np.float32),
                         (rows[keep], cols[keep])), shape=(n, n))
    adj.data = rs.uniform(0.5, 1.5, adj.nnz).astype(np.float32)
    deg = np.maximum(np.asarray(adj.sum(1)).ravel(), 1e-12)
    return sp.diags(1.0 / deg).dot(adj).tocsr().astype(np.float32)


@pytest.mark.parametrize("term", ["f32", "bf16"])
@pytest.mark.parametrize("carry", ["f32", "bf16"])
@pytest.mark.parametrize("nfeat", [1, 33, 64, 100, 602])
@pytest.mark.parametrize("accumulate", [True, False])
def test_split_hops_match_plain(device, term, carry, nfeat, accumulate):
    """K2 and K2-bf16 on hub rows above the cap: the chunks' partial sums
    and the in-launch fix-up against the plain version, which follows the
    same split plan; one launch a hop."""
    adj = _split_operator()
    op = CSROperator.from_scipy(adj, device)
    assert op.plan is not None and op.plan.rows.tolist() == [7, 11]
    n = adj.shape[0]
    rs = np.random.RandomState(nfeat)
    x = _carry(torch.tensor(rs.randn(n, nfeat).astype(np.float32),
                            device=device), carry)
    acc0 = _carry(torch.tensor(rs.randn(n, nfeat).astype(np.float32),
                               device=device), carry)
    wrapper = spmm_prop_step if term == "f32" else spmm_prop_step_bf16
    out_k, acc_k = torch.empty_like(x), acc0.clone()
    out_p, acc_p = torch.empty_like(x), acc0.clone()
    before = wrapper.launches
    wrapper(op, x, out_k, acc_k, 0.8, accumulate)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    spmm_prop_step_plain(op, x, out_p, acc_p, 0.8, accumulate, term)
    for got, want in ((out_k, out_p), (acc_k, acc_p)):
        _assert_hop_matches(got, want, term, carry)
    assert float(out_k[5:7].float().abs().max()) == 0.0
    again = torch.empty_like(x)
    wrapper(op, x, again, acc0.clone(), 0.8, accumulate)
    assert torch.equal(again, out_k)                  # deterministic


@pytest.mark.parametrize("nfeat", [64, 100, 602])
def test_split_hop_matches_the_unsplit_hop(device, nfeat):
    """The split and the unsplit kernel on the same operator: the same
    terms grouped another way (TOL), and the split hop on misaligned
    views."""
    adj = _split_operator()
    split = CSROperator.from_scipy(adj, device)
    whole = CSROperator.from_scipy(adj, device, split_cap=adj.nnz)
    assert whole.plan is None
    rs = np.random.RandomState(nfeat)
    x = torch.tensor(rs.randn(adj.shape[0], nfeat).astype(np.float32),
                     device=device)
    acc0 = torch.tensor(rs.randn(adj.shape[0], nfeat).astype(np.float32),
                        device=device)
    outs = []
    for op, view in ((split, _misaligned), (whole, lambda t: t)):
        out, acc = view(torch.empty_like(x)), view(acc0.clone())
        spmm_prop_step(op, view(x), out, acc, 0.8, True)
        outs.append((out, acc))
    torch.cuda.synchronize()
    for got, want in zip(*outs):
        assert _rel_err(got, want) <= TOL


def _split_operator_rows_constant():
    """The structure of :func:`_split_operator` with each row's values
    1 / its nonzeros (D^-1 A's form, which K2-q8mxu needs)."""
    adj = _split_operator()
    deg = np.diff(adj.indptr)
    vals = np.repeat(1.0 / np.maximum(deg, 1), deg).astype(np.float32)
    return sp.csr_matrix((vals, adj.indices, adj.indptr), shape=adj.shape)


# The int8 hops' widths: every vector width of csr_spmm_q8.cu's lane
# groups (V 16 at 16, 64, 128; 4 at 100; 2 at 602; 1 at 1 and 33) and its
# walk over several tiles (602)
INT8_WIDTHS = [1, 16, 33, 64, 100, 128, 602]


@pytest.mark.parametrize("kernel", ["q8", "q8mxu"])
@pytest.mark.parametrize("carry", ["f32", "bf16"])
@pytest.mark.parametrize("nfeat", INT8_WIDTHS)
@pytest.mark.parametrize("accumulate", [True, False])
def test_split_int8_hops_match_plain(device, kernel, carry, nfeat,
                                     accumulate):
    """K2-q8 and K2-q8mxu on hub rows above the cap: the chunks' partials
    (f32 and int32) and the in-launch fix-up against the plain version,
    which groups the terms the same way, bit for bit; one launch a hop;
    the same bits on a second run; and K2-q8mxu's split hop bit for bit its
    unsplit hop (int32 sums)."""
    adj = (_split_operator_rows_constant() if kernel == "q8mxu"
           else _split_operator())
    op = CSROperator.from_scipy(adj, device)
    assert op.plan is not None and op.plan.rows.tolist() == [7, 11]
    n = adj.shape[0]
    rs = np.random.RandomState(nfeat)
    x = torch.tensor(rs.randn(n, nfeat).astype(np.float32), device=device)
    acc0 = _carry(torch.tensor(rs.randn(n, nfeat).astype(np.float32),
                               device=device), carry)
    q, scale = quantize_columns_plain(x)
    rv = row_values_if_constant(adj)
    row_val = None if rv is None else torch.tensor(rv, device=device)

    def hop(fn, o):
        out, acc = torch.empty_like(acc0), acc0.clone()
        if fn is spmm_prop_step_q8 or fn is spmm_prop_step_q8_plain:
            fn(o, q, scale, out, acc, 0.8, accumulate)
        else:
            fn(o, q, scale, row_val, out, acc, 0.8, accumulate)
        return out, acc

    wrapper, plain = ((spmm_prop_step_q8, spmm_prop_step_q8_plain)
                      if kernel == "q8" else
                      (spmm_prop_step_q8mxu, spmm_prop_step_q8mxu_plain))
    before = wrapper.launches
    got = hop(wrapper, op)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    want = hop(plain, op)
    again = hop(wrapper, op)
    for g, w, a in zip(got, want, again):
        assert torch.equal(g, w), int((g != w).sum())
        assert torch.equal(g, a)                      # deterministic
    assert float(got[0][5:7].float().abs().max()) == 0.0
    if kernel == "q8mxu":
        whole = CSROperator.from_scipy(adj, device, split_cap=adj.nnz)
        assert whole.plan is None
        for g, w in zip(got, hop(wrapper, whole)):
            assert torch.equal(g, w)


def _short_rows_operator(rows_constant):
    """3,000 rows of 0 to 9 nonzeros (U = 8 edges a batch: rows shorter
    than one batch, one batch, one and a bit) and four rows above a cap of
    64 whose last chunks hold 3, 7, 64 and 1 edges; the values varied, or
    1 / the row's nonzeros."""
    n = 3000
    rs = np.random.RandomState(11)
    deg = np.arange(n) % 10
    deg[[5, 17, 29, 41]] = [64 * 3 + 3, 64 * 2 + 7, 64 * 2, 65]
    rows = np.repeat(np.arange(n), deg)
    cols = np.concatenate([rs.choice(n, d, replace=False) for d in deg])
    vals = (np.repeat(1.0 / np.maximum(deg, 1), deg) if rows_constant
            else rs.uniform(0.1, 1.0, rows.size))
    return sp.csr_matrix((vals.astype(np.float32), (rows, cols)),
                         shape=(n, n))


@pytest.mark.parametrize("kernel", ["q8", "q8mxu"])
@pytest.mark.parametrize("carry", ["f32", "bf16"])
@pytest.mark.parametrize("nfeat", [16, 100, 128])
def test_int8_hops_on_short_rows_and_chunks(device, kernel, carry, nfeat):
    """Rows shorter than the kernels' batch of U edges and split rows whose
    last chunk is shorter than U: bit for bit the plain version (which
    follows the same plan), one launch a hop, and K2-q8mxu's split hop bit
    for bit its unsplit one."""
    adj = _short_rows_operator(kernel == "q8mxu")
    op = CSROperator.from_scipy(adj, device, split_cap=64)
    assert op.plan is not None and op.plan.rows.tolist() == [5, 17, 29, 41]
    rs = np.random.RandomState(nfeat)
    x = torch.tensor(rs.randn(adj.shape[0], nfeat).astype(np.float32),
                     device=device)
    acc0 = _carry(torch.tensor(rs.randn(adj.shape[0], nfeat)
                               .astype(np.float32), device=device), carry)
    q, scale = quantize_columns_plain(x)
    rv = row_values_if_constant(adj)
    row_val = None if kernel == "q8" else torch.tensor(rv, device=device)
    wrapper, plain = ((spmm_prop_step_q8, spmm_prop_step_q8_plain)
                      if kernel == "q8" else
                      (spmm_prop_step_q8mxu, spmm_prop_step_q8mxu_plain))

    def hop(fn, o):
        out, acc = torch.empty_like(acc0), acc0.clone()
        args = (q, scale) if row_val is None else (q, scale, row_val)
        fn(o, *args, out, acc, 0.8, True)
        return out, acc

    before = wrapper.launches
    got = hop(wrapper, op)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    for g, w in zip(got, hop(plain, op)):
        assert torch.equal(g, w), int((g != w).sum())
    assert float(got[0][0].float().abs().max()) == 0.0     # an empty row
    if kernel == "q8mxu":
        whole = CSROperator.from_scipy(adj, device, split_cap=adj.nnz)
        for g, w in zip(got, hop(wrapper, whole)):
            assert torch.equal(g, w)


def test_q8_hop_config_matches_the_kernel(device):
    """sparse/spmm.py's q8_hop_config against the kernels' own choice
    (csr_spmm_q8_config) for every F in 1..1100 and alignment."""
    lib = load_kernels()
    out = (ctypes.c_int * 5)()
    for nfeat in range(1, 1101):
        for align in (1, 4, 8, 16):
            assert lib.csr_spmm_q8_config(nfeat, align, out) == 0
            assert Q8HopConfig(*out) == q8_hop_config(nfeat, align), (
                nfeat, align)
    assert lib.csr_spmm_q8_config(0, 16, out) != 0


@pytest.mark.parametrize("carry", [torch.float32, torch.bfloat16])
def test_q8_hop_align_matches_the_kernel(device, carry):
    """sparse/spmm.py's q8_hop_align against the kernels' own alignment
    rule (csr_spmm_q8_align) on views of q, the scales and the carries at
    every offset that changes it, acc given or not."""
    lib = load_kernels()

    def at(numel, dtype, offset):
        flat = torch.empty(numel + 64, dtype=dtype, device=device)
        skip = (-flat.data_ptr() % 64) // flat.element_size() + offset
        return flat[skip:skip + numel]

    bf16 = int(carry == torch.bfloat16)
    for q_off in range(17):
        q = at(256, torch.int8, q_off)
        for s_off in range(5):
            scale = at(16, torch.float32, s_off)
            for y_off in range(9):
                y = at(256, carry, y_off)
                for acc in (None, at(256, carry, 0), at(256, carry, 3)):
                    got = lib.csr_spmm_q8_align(
                        ctypes.c_void_p(q.data_ptr()),
                        ctypes.c_void_p(scale.data_ptr()),
                        ctypes.c_void_p(y.data_ptr()),
                        None if acc is None else ctypes.c_void_p(
                            acc.data_ptr()), bf16)
                    assert got == q8_hop_align(q, scale, y, acc), (
                        q_off, s_off, y_off)


def _assert_hop_matches(got, want, kernel, carry):
    """A hop's carry against the plain version's. The plain versions add
    in the kernels' order, so a hop whose terms round as the plain's do
    (every kernel but K2's fused multiply-add) is bit for bit the same with
    bf16 carries, and the int8 hops with f32 carries too; K2 with bf16
    carries stays within one bf16 ulp of max |plain| (2^-8) with at most
    1e-3 of the elements different. f32 carries of K2 and K2-bf16: TOL."""
    if kernel in ("q8", "q8mxu"):
        assert torch.equal(got, want), int((got != want).sum())
        return
    if carry == "f32":
        limit = 1e-6 if kernel == "q8mxu" else TOL
        assert _rel_err(got, want) <= limit, (_rel_err(got, want), limit)
        return
    if kernel != "f32":
        assert torch.equal(got, want), int((got != want).sum())
        return
    assert _rel_err(got.float(), want.float()) <= 2.0 ** -8
    assert float((got != want).double().mean()) <= 1e-3


@pytest.mark.parametrize("n,nfeat", [(1, 3), (300, 33), (9500, 100),
                                     (300, 1), (9500, 602)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_columns_kernel_matches_plain(device, n, nfeat, dtype):
    rs = np.random.RandomState(3)
    x = torch.tensor(rs.randn(n, nfeat).astype(np.float32), device=device)
    x[:, nfeat // 2] = 0.0                 # an all-zero column
    x = _carry(x, dtype)
    before = quantize_columns.launches
    q, scale = quantize_columns(x)
    torch.cuda.synchronize()
    assert quantize_columns.launches == before + 1
    q_p, scale_p = quantize_columns_plain(x)
    assert torch.equal(q, q_p)
    assert torch.equal(scale, scale_p)
    assert float(scale[nfeat // 2]) == 1.0


@pytest.mark.parametrize("kernel", ["f32", "bf16", "q8", "q8mxu"])
@pytest.mark.parametrize("carry", ["f32", "bf16"])
@pytest.mark.parametrize("n,nfeat", [(1, 5), (300, 33), (9500, 100),
                                     (9500, 1), (9500, 16), (9500, 64),
                                     (9500, 128), (9500, 602)])
@pytest.mark.parametrize("accumulate", [True, False])
def test_fast_precision_hops_match_plain(device, kernel, carry, n, nfeat,
                                         accumulate):
    rs = np.random.RandomState(4)
    norm, varied = _hop_operator(n)
    op = CSROperator.from_scipy(norm if kernel == "q8mxu" else varied,
                                device)
    x = torch.tensor(rs.randn(n, nfeat).astype(np.float32), device=device)
    if nfeat > 2:
        x[:, 2] = 0.0                      # an all-zero column
    acc0 = torch.tensor(rs.randn(n, nfeat).astype(np.float32),
                        device=device)
    x, acc0 = _carry(x, carry), _carry(acc0, carry)
    out_k, acc_k = torch.empty_like(x), acc0.clone()
    out_p, acc_p = torch.empty_like(x), acc0.clone()
    if kernel in ("f32", "bf16"):
        wrapper = spmm_prop_step if kernel == "f32" else spmm_prop_step_bf16
        before = wrapper.launches
        wrapper(op, x, out_k, acc_k, 0.8, accumulate)
        spmm_prop_step_plain(op, x, out_p, acc_p, 0.8, accumulate, kernel)
    else:
        q, scale = quantize_columns_plain(x)
        if kernel == "q8":
            wrapper = spmm_prop_step_q8
            before = wrapper.launches
            wrapper(op, q, scale, out_k, acc_k, 0.8, accumulate)
            spmm_prop_step_q8_plain(op, q, scale, out_p, acc_p, 0.8,
                                    accumulate)
        else:
            row_val = torch.tensor(row_values_if_constant(norm),
                                   device=device)
            wrapper = spmm_prop_step_q8mxu
            before = wrapper.launches
            wrapper(op, q, scale, row_val, out_k, acc_k, 0.8, accumulate)
            spmm_prop_step_q8mxu_plain(op, q, scale, row_val, out_p, acc_p,
                                       0.8, accumulate)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    for got, want in ((out_k, out_p), (acc_k, acc_p)):
        _assert_hop_matches(got, want, kernel, carry)
    if n > 5:
        assert float(out_k[5].float().abs().max()) == 0.0   # the empty row
    if kernel in ("q8", "q8mxu"):
        _assert_int8_hop_repeats(wrapper, op, q, scale, norm, accumulate,
                                 out_k, acc_k, acc0)


def _assert_int8_hop_repeats(wrapper, op, q, scale, norm, accumulate,
                             out_k, acc_k, acc0):
    """A second launch of an int8 hop on the same inputs gives the same
    bits."""
    out, acc = torch.empty_like(out_k), acc0.clone()
    args = ((q, scale) if wrapper is spmm_prop_step_q8 else
            (q, scale, torch.tensor(row_values_if_constant(norm),
                                    device=q.device)))
    wrapper(op, *args, out, acc, 0.8, accumulate)
    torch.cuda.synchronize()
    assert torch.equal(out, out_k) and torch.equal(acc, acc_k)


def _misaligned(t):
    """A contiguous copy of ``t`` one element past an aligned address, so
    the kernels must take their one-feature-a-lane path."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("kernel", ["f32", "bf16", "q8", "q8mxu",
                                    "quantize"])
@pytest.mark.parametrize("carry", ["f32", "bf16"])
@pytest.mark.parametrize("nfeat", INT8_WIDTHS)
def test_hops_on_misaligned_views_match_plain(device, kernel, carry, nfeat):
    rs = np.random.RandomState(6)
    norm, varied = _hop_operator(300)
    op = CSROperator.from_scipy(norm if kernel == "q8mxu" else varied,
                                device)
    x = _carry(torch.tensor(rs.randn(300, nfeat).astype(np.float32),
                            device=device), carry)
    acc0 = _carry(torch.tensor(rs.randn(300, nfeat).astype(np.float32),
                               device=device), carry)
    if kernel == "quantize":
        q, scale = quantize_columns(_misaligned(x))
        q_p, scale_p = quantize_columns_plain(x)
        assert torch.equal(q, q_p) and torch.equal(scale, scale_p)
        return
    out_k, acc_k = _misaligned(torch.empty_like(x)), _misaligned(acc0)
    out_p, acc_p = torch.empty_like(x), acc0.clone()
    if kernel in ("f32", "bf16"):
        wrapper = spmm_prop_step if kernel == "f32" else spmm_prop_step_bf16
        wrapper(op, _misaligned(x), out_k, acc_k, 0.8, True)
        spmm_prop_step_plain(op, x, out_p, acc_p, 0.8, True, kernel)
    else:
        q, scale = quantize_columns_plain(x)
        q_view = _misaligned(q)
        wrapper = spmm_prop_step_q8 if kernel == "q8" else spmm_prop_step_q8mxu
        before = wrapper.launches
        if kernel == "q8":
            spmm_prop_step_q8(op, q_view, scale, out_k, acc_k, 0.8, True)
            spmm_prop_step_q8_plain(op, q, scale, out_p, acc_p, 0.8, True)
        else:
            row_val = torch.tensor(row_values_if_constant(norm),
                                   device=device)
            spmm_prop_step_q8mxu(op, q_view, scale, row_val, out_k, acc_k,
                                 0.8, True)
            spmm_prop_step_q8mxu_plain(op, q, scale, row_val, out_p, acc_p,
                                       0.8, True)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        _assert_int8_hop_repeats(wrapper, op, q_view, scale, norm, True,
                                 out_k.clone(), acc_k.clone(),
                                 _misaligned(acc0))
    torch.cuda.synchronize()
    for got, want in ((out_k, out_p), (acc_k, acc_p)):
        _assert_hop_matches(got, want, kernel, carry)


def test_fast_precision_wrappers_reject_bad_input(device):
    op = CSROperator.from_scipy(sp.eye(4, format="csr", dtype=np.float32),
                                device)
    x = torch.zeros(4, 8, device=device)
    with pytest.raises(TypeError):               # carries of two dtypes
        spmm_prop_step_bf16(op, x, x.clone().to(torch.bfloat16), None, 1.0,
                            False)
    with pytest.raises(TypeError):
        quantize_columns(x.double())
    q, scale = quantize_columns(x)
    with pytest.raises(TypeError):               # q must be int8
        spmm_prop_step_q8(op, q.int(), scale, x.clone(), None, 1.0, False)
    with pytest.raises(ValueError):              # row_val must be [n]
        spmm_prop_step_q8mxu(op, q, scale, torch.ones(3, device=device),
                             x.clone(), None, 1.0, False)
    with pytest.raises(ValueError):              # on another device
        spmm_prop_step_q8(op, q, scale.cpu(), x.clone(), None, 1.0, False)


# --- GFPush device backends (P1, P2) and their top-k ----------------------


def _push_graph(n, hub_degree, seed):
    """A random graph with self-loops, a dangling node (n - 1, no row) and,
    where ``hub_degree``, a hub source 0 with that many neighbours."""
    rs = np.random.RandomState(seed)
    adj = sp.random(n, n, density=4.0 / n, random_state=rs, format="lil")
    adj.setdiag(1.0)
    if hub_degree:
        adj[0, rs.permutation(n)[:hub_degree]] = 1.0
    adj[n - 1, :] = 0.0
    adj = adj.tocsr()
    adj.data[:] = 1.0
    return adj


@pytest.mark.parametrize("k", [1, 7, 64, 1024])
@pytest.mark.parametrize("with_ids", [True, False])
def test_push_topk_kernel_matches_plain(device, k, with_ids):
    """Ragged rows: empty, fewer than k positives, many ties (values drawn
    from a few levels), negatives and zeros, and a 233,000-wide row."""
    rs = np.random.RandomState(k)
    lens = np.array([0, 3, k, 5000, 233000, 17])
    vals = rs.choice([0.0, -0.5, 0.25, 0.125, 1e-3, 3e-7],
                     size=lens.sum()).astype(np.float32)
    vals[lens[:4].sum():lens[:5].sum()] *= rs.rand(233000) < 0.01
    ids = np.concatenate([rs.permutation(1 << 20)[:m] for m in lens])
    vals_t = torch.tensor(vals, device=device)
    ids_t = torch.tensor(ids.astype(np.int32), device=device) if with_ids \
        else None
    off = row_offsets(torch.tensor(lens, device=device))
    before = push_topk.launches
    cols, out = push_topk(ids_t, vals_t, off, k)
    again = push_topk(ids_t, vals_t, off, k)
    torch.cuda.synchronize()
    assert push_topk.launches == before + 2
    want_cols, want_vals = push_topk_plain(ids_t, vals_t, off, k)
    assert torch.equal(cols, want_cols) and torch.equal(out, want_vals)
    assert torch.equal(again[0], cols) and torch.equal(again[1], out)


def _topk_twice_matches_plain(ids_t, vals_t, off, k):
    before = push_topk.launches
    cols, out = push_topk(ids_t, vals_t, off, k)
    again = push_topk(ids_t, vals_t, off, k)
    torch.cuda.synchronize()
    assert push_topk.launches == before + 2
    want_cols, want_vals = push_topk_plain(ids_t, vals_t, off, k)
    assert torch.equal(cols, want_cols) and torch.equal(out, want_vals)
    assert torch.equal(again[0], cols) and torch.equal(again[1], out)
    return cols, out


@pytest.mark.parametrize("k", [64, 1024])
@pytest.mark.parametrize("with_ids", [True, False])
def test_push_topk_rows_past_the_shared_buffer(device, k, with_ids):
    """Rows with more positive entries than the kernel's shared-memory
    candidate buffer (12,288 keys): 233,000 and 20,000 all positive, one of
    them all equal (ordered by id), beside a short row."""
    rs = np.random.RandomState(k + with_ids)
    lens = np.array([233000, 5, 20000, 233000])
    vals = (rs.rand(lens.sum()) + 1e-3).astype(np.float32)
    vals[lens[:3].sum():] = 0.5                  # the last row all equal
    ids = np.concatenate([rs.permutation(1 << 20)[:m] for m in lens])
    ids_t = (torch.tensor(ids.astype(np.int32), device=device) if with_ids
             else None)
    cols, out = _topk_twice_matches_plain(
        ids_t, torch.tensor(vals, device=device),
        row_offsets(torch.tensor(lens, device=device)), k)
    assert bool((out[3] == 0.5).all())
    assert bool((cols[3][1:] > cols[3][:-1]).all())


@pytest.mark.parametrize("k", [64, 1024])
@pytest.mark.parametrize("form", ["p1", "p2"])
def test_push_topk_at_the_push_shapes(device, k, form):
    """P1's form (512 rows of 233,000 entries, about 1 % positive, no ids)
    and P2's (1,024 hash tables of about 6,500 slots with ids, about half
    empty), with values from a few levels so that ties cross the k-th."""
    rs = np.random.RandomState(k)
    if form == "p1":
        rows, width = 512, 233000
        lens = np.full(rows, width)
        live = rs.rand(rows * width) < 0.01
    else:
        rows = 1024
        lens = rs.randint(5000, 8000, rows)
        live = rs.rand(lens.sum()) < 0.5
    levels = np.array([1e-6, 3e-5, 2e-4, 1e-3, 0.01, 0.25], np.float32)
    vals = np.where(live, rs.choice(levels, lens.sum())
                    * rs.choice([1.0, 1.0, 1.5], lens.sum()), 0.0)
    vals = vals.astype(np.float32)
    ids_t = None
    if form == "p2":
        # unique in each row: a row's positions shuffled, spread over 2M
        spread = np.argsort(rs.rand(rows, lens.max()), axis=1) * 250
        spread += rs.randint(0, 250, (rows, 1))
        ids = np.concatenate([spread[r, :m] for r, m in enumerate(lens)])
        ids_t = torch.tensor(ids.astype(np.int32), device=device)
    _topk_twice_matches_plain(ids_t, torch.tensor(vals, device=device),
                              row_offsets(torch.tensor(lens, device=device)),
                              k)


def test_push_topk_wrapper_rejects_bad_input(device):
    vals = torch.ones(4, device=device)
    off = torch.tensor([0, 4], device=device)
    with pytest.raises(ValueError):
        push_topk(None, vals, off, 1025)
    with pytest.raises(TypeError):
        push_topk(None, vals.double(), off, 2)
    with pytest.raises(ValueError):
        push_topk(torch.zeros(3, dtype=torch.int32, device=device), vals,
                  off, 2)


@pytest.mark.parametrize("final", [False, True])
def test_dense_push_mask_kernel_matches_plain(device, final):
    """Bit for bit: the same f32 operations, and the teleport in Q62."""
    rs = np.random.RandomState(3)
    n, b = 1000, 37
    residue = torch.tensor(rs.rand(n, b).astype(np.float32) ** 4,
                           device=device)
    deg = torch.tensor(rs.randint(0, 9, n).astype(np.float32), device=device)
    thr = np.float32(1e-3) * deg
    src = torch.tensor(rs.randint(0, n, b).astype(np.int32), device=device)
    tele_in = torch.tensor(rs.randint(0, 1 << 60, b), device=device)
    outs = []
    for mask in (dense_push_mask, dense_push_mask_plain):
        reserve = torch.full_like(residue, 0.5)
        pushed = torch.zeros_like(residue)
        tele = torch.zeros(b, dtype=torch.int64, device=device)
        mask(residue, reserve, pushed, tele_in, None if final else tele, src,
             deg, thr, 0.15, final)
        torch.cuda.synchronize()
        outs.append((reserve, pushed, tele))
    for got, want in zip(*outs):
        assert torch.equal(got, want)


@pytest.mark.parametrize("dense_threshold", [8192, 0])
def test_dense_push_kernels_match_plain(device, dense_threshold):
    """P1 on the card against its plain version on the card, with a
    dangling node; two kernel runs identical."""
    from grandtpu_torch.ppr import dense_push
    adj = _push_graph(600, 0, 4)
    coef = np.asarray(build_coef("ppr", 6, 0.1), np.float32)
    g = dense_push.DensePushGraph(adj.indptr, adj.indices, 1e-4,
                                  dense_threshold, device)
    src = torch.arange(0, 600, 7, dtype=torch.int32, device=device)
    before = dense_push_mask.launches
    cols, vals = dense_push.push_block(g, src, coef, 32)
    cols2, vals2 = dense_push.push_block(g, src, coef, 32)
    torch.cuda.synchronize()
    assert dense_push_mask.launches == before + 14
    want_cols, want_vals = dense_push.push_block(g, src, coef, 32,
                                                 plain=True)
    assert torch.equal(cols, want_cols)
    assert _rel_err(vals, want_vals) <= TOL
    assert torch.equal(cols, cols2) and torch.equal(vals, vals2)


@pytest.mark.parametrize("rmax", [0.0, 1e-4])
def test_bucket_push_kernels_match_plain(device, rmax):
    """P2 on the card against its plain version, bit for bit, on a graph
    with a dangling node and a 9000-nonzero hub source; two runs
    identical."""
    from grandtpu_torch.ppr import bucket_push
    adj = _push_graph(12000, 9000, 5)
    coef = np.asarray(build_coef("ppr", 4, 0.2), np.float32)
    g = bucket_push.BucketPushGraph(adj.indptr, adj.indices, rmax,
                                    device=device)
    src = torch.tensor([0, 1, 11999, 5, 0], dtype=torch.int32, device=device)
    before = (bucket_push.bucket_hop.launches,
              bucket_push.bucket_reserve.launches)
    got = bucket_push.push_block(g, src, coef, 64)
    again = bucket_push.push_block(g, src, coef, 64)
    torch.cuda.synchronize()
    # 4 hops and one reserve merge a block (rmax 0: every hop pushes)
    if rmax == 0.0:
        assert bucket_push.bucket_hop.launches == before[0] + 8
    assert bucket_push.bucket_hop.launches > before[0]
    assert bucket_push.bucket_reserve.launches == before[1] + 2
    # the hub source's reserves (9001 entries at hop 1) are over the shared
    # table
    assert bucket_push.bucket_reserve.global_sources >= 2
    want = bucket_push.push_block(g, src, coef, 64, plain=True)
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(got[0][0], got[0][4])     # the same source twice


# the sources of a block, its rmax and whether a table goes global: no hub
# (the hub 0 never pushes at 1e-4 unless it is the source); the hub source
# (9001 slots at hop 1, over the shared table's 6,144); the hub source twice
# beside a dangling one with every node pushing
_P2_BLOCKS = [([1, 2, 11999, 5, 5, 7], 1e-4, False),
              ([0, 3, 11999], 1e-4, True),
              ([0, 1, 11999, 5, 0], 0.0, True)]


def _p2_log(bucket_push, g, src, hops, kernel):
    """The frontiers of a block's hops (from the kernel or the plain hop)
    and the global-table sources of each kernel hop."""
    fr = bucket_push.initial_frontier(g, src)
    frontiers, spilled = [fr], []
    for _ in range(hops):
        layout = bucket_push.table_layout(fr.exp)
        if layout.slots == 0:
            break
        if kernel:
            fr = bucket_push.bucket_hop(g, fr, src, layout)
            spilled.append(bucket_push.bucket_hop.global_sources)
        else:
            fr = bucket_push.push_hop_plain(g, fr, src)
        frontiers.append(fr)
    return frontiers, spilled


@pytest.mark.parametrize("sources,rmax,spill", _P2_BLOCKS)
def test_bucket_hop_kernel_matches_plain(device, sources, rmax, spill):
    """Each hop of a block: the kernel's next frontier, ordered by id within
    each source, bit for bit the plain hop's from the same frontier, with
    cnt and exp; the hub source takes the global table."""
    from grandtpu_torch.ppr import bucket_push
    adj = _push_graph(12000, 9000, 5)
    g = bucket_push.BucketPushGraph(adj.indptr, adj.indices, rmax,
                                    device=device)
    src = torch.tensor(sources, dtype=torch.int32, device=device)
    before = bucket_push.bucket_hop.launches
    frontiers, spilled = _p2_log(bucket_push, g, src, 4, kernel=True)
    torch.cuda.synchronize()
    assert bucket_push.bucket_hop.launches == before + len(spilled)
    assert len(spilled) >= 3
    assert (max(spilled) > 0) == spill
    for fr, got in zip(frontiers, frontiers[1:]):
        want = bucket_push.push_hop_plain(g, fr, src)
        assert torch.equal(got.cnt, want.cnt)
        assert torch.equal(got.exp, want.exp)
        assert bool((got.cnt <= fr.exp).all())
        ids, q = bucket_push.by_row_and_id(got.off, got.cnt, got.ids, got.q)
        assert torch.equal(ids, want.ids) and torch.equal(q, want.q)
    if sources.count(sources[0]) > 1:          # a source listed twice
        last = frontiers[-1]
        rows = [bucket_push.by_row_and_id(last.off[i:i + 1],
                                          last.cnt[i:i + 1], last.ids,
                                          last.q)
                for i in (0, sources.index(sources[0], 1))]
        assert all(torch.equal(a, b) for a, b in zip(*rows))


@pytest.mark.parametrize("sources,rmax,spill", _P2_BLOCKS)
def test_bucket_reserve_kernel_matches_plain(device, sources, rmax, spill):
    """The reserve merge of a block's log in one launch: per source the
    distinct reserves, ordered by id, bit for bit the plain table's (ids,
    u64 sums and their f32 values), zeros after them; the hub source's
    table is global."""
    from grandtpu_torch.ppr import bucket_push
    adj = _push_graph(12000, 9000, 5)
    g = bucket_push.BucketPushGraph(adj.indptr, adj.indices, rmax,
                                    device=device)
    src = torch.tensor(sources, dtype=torch.int32, device=device)
    coef = build_coef("ppr", 4, 0.2)
    frontiers, _ = _p2_log(bucket_push, g, src, 4, kernel=False)
    logs = [(fr, float(c)) for fr, c in zip(frontiers, coef)]
    layout = bucket_push.reserve_layout(logs)
    before = bucket_push.bucket_reserve.launches
    ids, sums, vals, cnt = bucket_push.bucket_reserve(logs, layout,
                                                      sums=True)
    torch.cuda.synchronize()
    assert bucket_push.bucket_reserve.launches == before + 1
    assert (bucket_push.bucket_reserve.global_sources > 0) == spill
    row_off, want_ids, want_sums = bucket_push.reserve_table_plain(g, logs)
    assert torch.equal(cnt, row_off[1:] - row_off[:-1])
    got = bucket_push.by_row_and_id(layout.out_off[:-1], cnt, ids, sums,
                                    vals)
    assert torch.equal(got[0], want_ids) and torch.equal(got[1], want_sums)
    assert torch.equal(got[2], (want_sums.double() / bucket_push.ONE).float())
    live = torch.zeros_like(vals, dtype=torch.bool)
    pos, _ = bucket_push._entries(bucket_push.Frontier(
        off=layout.out_off[:-1], cnt=cnt, ids=ids, q=sums, exp=cnt))
    live[pos] = True
    assert bool((vals[~live] == 0).all()) and bool((ids[~live] == -1).all())


def test_bucket_push_occupancy(device):
    """Two CTAs an SM for each P2 kernel; the kernels' shared table is the
    size that ``table_layout`` plans with."""
    from grandtpu_torch.ppr import bucket_push
    occ = bucket_push.occupancy()
    for name in ("bucket_hop", "bucket_reserve"):
        assert occ[name]["ctas_per_sm"] >= 2, occ
        assert occ[name]["table_slots"] == bucket_push.SMEM_SLOTS
        assert occ[name]["smem_bytes"] >= bucket_push.SMEM_SLOTS * 12


@pytest.mark.parametrize("fault", ["shared", "short_table", "short_out"])
def test_bucket_kernels_refuse_a_short_layout(device, fault):
    """A layout that gives the hub source (9001 slots at hop 1) too small a
    table (shared, or a global region under its table) or too small an
    output region makes each P2 kernel raise instead of dropping sums."""
    from grandtpu_torch.ppr import bucket_push
    adj = _push_graph(12000, 9000, 5)
    g = bucket_push.BucketPushGraph(adj.indptr, adj.indices, 0.0,
                                    device=device)
    src = torch.tensor([1, 0, 5], dtype=torch.int32, device=device)
    fr = bucket_push.initial_frontier(g, src)
    fr = bucket_push.bucket_hop(g, fr, src, bucket_push.table_layout(fr.exp))
    logs = [(bucket_push.initial_frontier(g, src), 0.2), (fr, 0.16)]

    def short(good):
        g_off, out_off = good.g_off.clone(), good.out_off.clone()
        if fault == "shared":
            g_off.zero_()
        elif fault == "short_table":
            g_off[2:] -= 2 * int(good.g_off[2] - good.g_off[1]) // 3
        else:
            out_off[2:] -= 1
        return bucket_push.TableLayout(
            out_off=out_off, g_off=g_off, slots=int(out_off[-1]),
            spill=int(g_off[-1]), global_sources=good.global_sources)

    good = bucket_push.table_layout(fr.exp)
    assert int(good.g_off[2] - good.g_off[1]) > 0   # the hub source's
    with pytest.raises(RuntimeError, match="bucket_hop: a source's table"):
        bucket_push.bucket_hop(g, fr, src, short(good))
    good = bucket_push.reserve_layout(logs)
    assert int(good.g_off[2] - good.g_off[1]) > 0
    with pytest.raises(RuntimeError, match="bucket_reserve: a source's"):
        bucket_push.bucket_reserve(logs, short(good))


# K2-seg, D1's halo kernels and the quantize split


def _seg_graph(n, hub, seed=5):
    """A random row-sorted graph with empty rows and, with ``hub``, a
    9000-nonzero row 3 that spans hundreds of the kernel's edge runs."""
    rs = np.random.RandomState(seed)
    adj = sp.random(n, n, density=min(1.0, 5.0 / n), random_state=rs,
                    format="lil", dtype=np.float32)
    if hub:
        adj[3, rs.permutation(n)[:9000]] = rs.rand(9000) + 0.1
    adj[[0, n // 2], :] = 0
    adj = adj.tocsr()
    adj.data = (np.abs(adj.data) + 0.1).astype(np.float32)
    return adj


def _split_mask(padded, n, device):
    """The rows under the plan's cap (each adds in edge order, bit for bit
    the plain version)."""
    under = torch.ones(n, dtype=torch.bool, device=device)
    if padded.plan is not None:
        under[padded.plan.rows.long()] = False
    return under


@pytest.mark.parametrize("n,nfeat,hub", [(50, 1, False), (300, 33, False),
                                         (9500, 100, True), (9500, 64, True),
                                         (2, 4, False)])
def test_coo_spmm_kernel_matches_plain(device, n, nfeat, hub):
    """K2-seg's bare product against its plain version: every row of the
    output written (no zero-fill), rows under the split cap bit for bit
    (edge order from 0), the split hub row (9000 nonzeros, its chunks
    added in order) within TOL; one launch; the same bits on a second run
    (no atomics); and the library's product."""
    from grandtpu_torch.sparse.spmm import (PaddedCSR, spmm_segment,
                                            spmm_segment_plain)
    adj = _seg_graph(n, hub)
    padded = PaddedCSR.from_scipy(adj, device=device)
    assert (padded.plan is not None) == hub
    x = torch.randn(n, nfeat, device=device,
                    generator=torch.Generator(device).manual_seed(0))
    before = spmm_segment.launches
    out = torch.full((n, nfeat), 3.0, device=device)
    got = spmm_segment(padded, x, out=out)
    torch.cuda.synchronize()
    assert spmm_segment.launches == before + 1
    assert got.data_ptr() == out.data_ptr()
    want = spmm_segment_plain(padded, x)
    assert _rel_err(got, want) <= TOL
    under = _split_mask(padded, n, device)
    assert torch.equal(got[under], want[under])
    assert float(got[0].abs().max()) == 0.0           # an empty row
    assert torch.equal(spmm_segment(padded, x), got)  # deterministic
    a = torch.sparse_coo_tensor(
        torch.stack([padded.rows.long(), padded.cols.long()]), padded.vals,
        (n + 1, n)).coalesce()
    assert _rel_err(got, torch.sparse.mm(a, x)[:n]) <= TOL


def _seg_case(n, hub, trailing, seed=5):
    """_seg_graph with its last ``trailing`` rows emptied (the rows after
    the last real edge: a D1 shard's padded rows)."""
    adj = _seg_graph(n, hub, seed).tolil()
    if trailing:
        adj[n - trailing:, :] = 0
    return adj.tocsr()


@pytest.mark.parametrize("n,nfeat,hub,trailing", [
    (2, 4, False, 1), (300, 1, False, 0), (300, 33, False, 7),
    (9500, 100, True, 0), (9500, 64, True, 3), (9500, 602, True, 2),
    (3000, 128, False, 5)])
@pytest.mark.parametrize("row_scale", [False, True])
@pytest.mark.parametrize("accumulate", [True, False])
def test_segment_prop_step_matches_plain(device, n, nfeat, hub, trailing,
                                         row_scale, accumulate):
    """The fused K2-seg hop (y = scale * (h * row_scale), acc += y) against
    its plain version: rows under the cap bit for bit (y and acc), the
    split row within TOL, empty and trailing empty rows written (y 0, acc
    + 0), one launch, the same bits on a second launch."""
    from grandtpu_torch.sparse.spmm import (PaddedCSR,
                                            spmm_segment_prop_step,
                                            spmm_segment_prop_step_plain)
    adj = _seg_case(n, hub, trailing)
    padded = PaddedCSR.from_scipy(adj, device=device)
    gen = torch.Generator(device).manual_seed(4)
    x = torch.randn(n, nfeat, device=device, generator=gen)
    acc0 = torch.randn(n, nfeat, device=device, generator=gen)
    rs = (torch.rand(n, device=device, generator=gen) + 0.5
          if row_scale else None)

    def hop(fn):
        y = torch.full((n, nfeat), 3.0, device=device)
        acc = acc0.clone() if accumulate else None
        fn(padded, x, y, acc, 0.8, accumulate, rs)
        return y, acc

    before = spmm_segment_prop_step.launches
    got = hop(spmm_segment_prop_step)
    torch.cuda.synchronize()
    assert spmm_segment_prop_step.launches == before + 1
    want = hop(spmm_segment_prop_step_plain)
    again = hop(spmm_segment_prop_step)
    under = _split_mask(padded, n, device)
    for g, w, a in zip(got, want, again):
        if w is None:
            continue
        assert _rel_err(g, w) <= TOL
        assert torch.equal(g[under], w[under]), int((g[under] != w[under])
                                                   .sum())
        assert torch.equal(g, a)                       # deterministic
    empty = torch.as_tensor(np.diff(adj.indptr) == 0, device=device)
    assert float(got[0][empty].abs().max()) == 0.0
    if trailing:
        assert bool(empty[n - trailing:].all())


@pytest.mark.parametrize("n,nfeat,hub,trailing", [
    (2, 4, False, 1), (300, 1, False, 0), (300, 33, False, 7),
    (9500, 100, True, 0), (9500, 64, True, 3), (9500, 602, True, 2),
    (3000, 128, False, 5)])
@pytest.mark.parametrize("accumulate", [True, False])
def test_segment_prop_step_bf16_carries_match_plain(device, n, nfeat, hub,
                                                    trailing, accumulate):
    """K2-seg's bf16-carry form (bf16 x, y and acc; f32 terms summed in f32,
    h rounded to bf16, the update in bf16 with a bf16-rounded scale)
    against its plain version: every row bit for bit, split hub rows
    included (both add a chunk's terms in edge order and the chunks in
    order), one launch, the same bits on a second launch, and within
    2e-2 of the f32 hop."""
    from grandtpu_torch.sparse.spmm import (PaddedCSR,
                                            spmm_segment_prop_step,
                                            spmm_segment_prop_step_plain)
    adj = _seg_case(n, hub, trailing)
    padded = PaddedCSR.from_scipy(adj, device=device)
    gen = torch.Generator(device).manual_seed(4)
    x = torch.randn(n, nfeat, device=device, generator=gen).bfloat16()
    acc0 = torch.randn(n, nfeat, device=device, generator=gen).bfloat16()

    def hop(fn, dtype=torch.bfloat16):
        y = torch.full((n, nfeat), 3.0, device=device, dtype=dtype)
        acc = acc0.to(dtype, copy=True) if accumulate else None
        fn(padded, x.to(dtype), y, acc, 0.8, accumulate)
        return y, acc

    before = spmm_segment_prop_step.launches
    got = hop(spmm_segment_prop_step)
    torch.cuda.synchronize()
    assert spmm_segment_prop_step.launches == before + 1
    want = hop(spmm_segment_prop_step_plain)
    again = hop(spmm_segment_prop_step)
    f32 = hop(spmm_segment_prop_step, torch.float32)
    for g, w, a, f in zip(got, want, again, f32):
        if w is None:
            continue
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, w), (int((g != w).sum()), bf16_ulps(g, w))
        assert torch.equal(g, a)                       # deterministic
        assert _rel_err(g.float(), f) <= 2e-2
    empty = torch.as_tensor(np.diff(adj.indptr) == 0, device=device)
    assert float(got[0][empty].float().abs().max()) == 0.0


def test_segment_prop_step_with_no_real_edge(device):
    """An operator with no edge at all (a shard of padding only): every
    row written, y zero and acc unchanged in value."""
    from grandtpu_torch.sparse.spmm import PaddedCSR, spmm_segment_prop_step
    adj = sp.csr_matrix((40, 40), dtype=np.float32)
    padded = PaddedCSR.from_scipy(adj, device=device)
    acc0 = torch.randn(40, 8, device=device)
    y, acc = torch.full((40, 8), 3.0, device=device), acc0.clone()
    spmm_segment_prop_step(padded, torch.randn(40, 8, device=device), y, acc,
                           0.5, True)
    torch.cuda.synchronize()
    assert float(y.abs().max()) == 0.0 and torch.equal(acc, acc0)


def test_coo_spmm_wrapper_checks(device):
    from grandtpu_torch.sparse.spmm import (PaddedCSR, spmm_segment,
                                            spmm_segment_prop_step)
    adj = _seg_graph(40, False)
    padded = PaddedCSR.from_scipy(adj, device=device)
    with pytest.raises(TypeError):
        spmm_segment(padded, torch.zeros(40, 4, dtype=torch.float64,
                                         device=device))
    with pytest.raises(TypeError):                    # mixed carries
        spmm_segment(padded, torch.zeros(40, 4, device=device),
                     out=torch.zeros(40, 4, dtype=torch.bfloat16,
                                     device=device))
    with pytest.raises(ValueError):
        spmm_segment(padded, torch.zeros(41, 4, device=device))
    with pytest.raises(ValueError):
        spmm_segment(padded, torch.zeros(40, 4, device=device),
                     out=torch.zeros(41, 4, device=device))
    x = torch.zeros(40, 4, device=device)
    with pytest.raises(ValueError):                   # x aliases acc
        spmm_segment_prop_step(padded, x, torch.zeros_like(x), x, 1.0, True)
    with pytest.raises(ValueError):                   # a row scale [n + 1]
        spmm_segment_prop_step(padded, x, torch.zeros_like(x), None, 1.0,
                               False, torch.ones(41, device=device))
    rows = padded.rows.clone()
    i = int(torch.nonzero(rows[1:] > rows[:-1])[0, 0])
    rows[[i, i + 1]] = rows[[i + 1, i]]
    with pytest.raises(ValueError, match="sorted"):
        PaddedCSR(rows, padded.cols, padded.vals, 40, padded.chunk)


@pytest.mark.parametrize("kernel", ["q8", "q8mxu"])
@pytest.mark.parametrize("carry", ["f32", "bf16"])
@pytest.mark.parametrize("nfeat", INT8_WIDTHS)
@pytest.mark.parametrize("split", [False, True])
def test_int8_hop_amax_matches_column_absmax(device, kernel, carry, nfeat,
                                             split):
    """The maxima an int8 hop raises (amax_out) are column_absmax of the y
    it stored, bit for bit, split or not, every width; the hop's carries
    are those of the hop without them; one launch; a buffer above the
    maxima keeps its values."""
    from grandtpu_torch.sparse.spmm import column_absmax
    adj = (_split_operator_rows_constant() if kernel == "q8mxu"
           else _split_operator())
    op = CSROperator.from_scipy(adj, device,
                                split_cap=None if split else adj.nnz)
    assert (op.plan is not None) == split
    n = adj.shape[0]
    rs = np.random.RandomState(nfeat + 1)
    x = torch.tensor(rs.randn(n, nfeat).astype(np.float32), device=device)
    acc0 = _carry(torch.tensor(rs.randn(n, nfeat).astype(np.float32),
                               device=device), carry)
    q, scale = quantize_columns_plain(x)
    rv = row_values_if_constant(adj)
    wrapper = spmm_prop_step_q8 if kernel == "q8" else spmm_prop_step_q8mxu
    args = (q, scale) if kernel == "q8" else (
        q, scale, torch.tensor(rv, device=device))

    def hop(amax_out):
        y, acc = torch.empty_like(acc0), acc0.clone()
        wrapper(op, *args, y, acc, 0.8, True, amax_out)
        return y, acc

    amax = torch.zeros(nfeat, device=device)
    before = wrapper.launches
    got = hop(amax)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    for g, w in zip(got, hop(None)):
        assert torch.equal(g, w)
    assert torch.equal(amax.view(torch.int32),
                       column_absmax(got[0]).view(torch.int32))
    high = torch.full((nfeat,), 1e30, device=device)
    hop(high)
    torch.cuda.synchronize()
    assert torch.equal(high, torch.full_like(high, 1e30))


@pytest.mark.parametrize("n,nfeat", [(1, 3), (300, 33), (9500, 100),
                                     (300, 1), (2000, 602), (40, 5000)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_with_amax_one_launch_matches_plain(device, n, nfeat,
                                                     dtype):
    """The one-launch quantize (the scales computed in each block's shared
    memory, by windows of 4096 features) bit for bit the plain version,
    from the column maxima and from larger ones; it zeroes the other
    buffer it is given; one launch a call."""
    from grandtpu_torch.sparse.spmm import (column_absmax,
                                            quantize_with_amax,
                                            quantize_with_amax_plain)
    x = _carry(torch.randn(n, nfeat, device=device,
                           generator=torch.Generator(device).manual_seed(2)),
               dtype)
    x[:, nfeat // 2] = 0.0                 # an all-zero column
    pair = torch.rand((2, nfeat), device=device)
    pair[0] = column_absmax(x)
    before = quantize_with_amax.launches
    q, scale = quantize_with_amax(x, pair[0], pair[1])
    torch.cuda.synchronize()
    assert quantize_with_amax.launches == before + 1
    assert not pair[1].any()
    q_p, scale_p = quantize_columns_plain(x)
    assert torch.equal(q, q_p) and torch.equal(scale, scale_p)
    wider = (pair[0] * 1.7 + 0.3).to(x.dtype).float()
    q, scale = quantize_with_amax(x, wider)
    q_p, scale_p = quantize_with_amax_plain(x, wider)
    assert torch.equal(q, q_p) and torch.equal(scale, scale_p)
    with pytest.raises(ValueError):
        quantize_with_amax(x, pair[0], pair[0])


@pytest.mark.parametrize("precision", ["int8", "int8cast"])
@pytest.mark.parametrize("carry", [torch.float32, torch.bfloat16])
def test_int8_run_reuses_the_hops_maxima(device, precision, carry):
    """A whole int8 Propagator run on the card (one full quantize, then
    each later hop's on the maxima the hop before raised) equals the run
    that quantizes every hop in full, bit for bit, with the launches
    1 + (order - 1) + order."""
    from grandtpu_torch.infer import Propagator
    from grandtpu_torch.sparse.spmm import quantize_with_amax
    base = _split_operator()
    # unit weights and self-loops: D^-1 A's rows are constant (int8 runs
    # K2-q8mxu), its hub rows split
    adj = ((base + sp.eye(base.shape[0], format="csr")) != 0).astype(
        np.float32)
    prop = Propagator(adj, backend="csr", device=device, dtype=carry)
    assert prop.adj_op.plan is not None
    x = torch.randn(adj.shape[0], 100, device=device,
                    generator=torch.Generator(device).manual_seed(7))
    order = 5
    counts = [f.launches for f in (quantize_columns, quantize_with_amax)]
    got = prop(x, mode="ppr", order=order, alpha=0.2, precision=precision)
    torch.cuda.synchronize()
    assert [f.launches for f in (quantize_columns, quantize_with_amax)] == [
        counts[0] + 1, counts[1] + order - 1]
    hop = (spmm_prop_step_q8mxu if prop.last_precision == "int8mxu"
           else spmm_prop_step_q8)
    cur = (x.to(carry) * (float(torch.tensor(0.2).to(carry)))).contiguous()
    acc = cur.clone()
    out = torch.empty_like(cur)
    for _ in range(order):
        q, s = quantize_columns(cur)
        args = (q, s) if hop is spmm_prop_step_q8 else (q, s, prop.row_val)
        hop(prop.adj_op, *args, out, acc, 0.8, True)
        cur, out = out, cur
    torch.cuda.synchronize()
    assert torch.equal(got, acc)


@pytest.mark.parametrize("n,nfeat", [(1, 3), (300, 33), (9500, 100)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_split_equals_quantize_columns(device, n, nfeat, dtype):
    """column_absmax then quantize_with_amax: quantize_columns' launches,
    bit for bit; and from a larger (global) amax, the plain version's."""
    from grandtpu_torch.sparse.spmm import (column_absmax,
                                            column_absmax_plain,
                                            quantize_with_amax,
                                            quantize_with_amax_plain)
    x = _carry(torch.randn(n, nfeat, device=device,
                           generator=torch.Generator(device).manual_seed(1)),
               dtype)
    x[:, 0] = 0.0
    amax = column_absmax(x)
    assert torch.equal(amax, column_absmax_plain(x))
    q, scale = quantize_with_amax(x, amax)
    q_c, scale_c = quantize_columns(x)
    torch.cuda.synchronize()
    assert torch.equal(q, q_c) and torch.equal(scale, scale_c)
    # maxima in x's dtype, as every caller's are (a shard's, a mesh's max)
    wider = (amax * 1.7 + 0.3).to(x.dtype).float()
    q, scale = quantize_with_amax(x, wider)
    q_p, scale_p = quantize_with_amax_plain(x, wider)
    assert torch.equal(q, q_p) and torch.equal(scale, scale_p)


def _halo_case(device, nfeat, hub, empty_shard):
    """A 3-shard halo graph and random carries on the card. With
    ``empty_shard`` the row blocks are so large (rows_per_shard rounded up
    to them) that two shards hold every row and shard 2 only padding."""
    from grandtpu_torch.dist import HaloShardedGraph, make_mesh
    from grandtpu_torch.dist.halo import HaloPropagator
    n = 9500 if hub else 300
    # unit weights: D^-1 A's rows are constant, as the exact form needs
    adj = ((_seg_graph(n, hub, seed=6) + sp.eye(n, format="csr")) > 0)
    block = (4800 if hub else 160) if empty_shard else 8
    g = HaloShardedGraph.build(adj.astype(np.float32).tocsr(), 3,
                               rows_per_block=block)
    assert (g.rows_per_shard * 2 >= n) == empty_shard
    prop = HaloPropagator(make_mesh(3, devices=[device] * 3), g)
    gen = torch.Generator(device).manual_seed(2)
    xs = [torch.randn(g.rows_per_shard, nfeat, device=device, generator=gen)
          for _ in range(3)]
    return prop, xs


@pytest.mark.parametrize("nfeat", [1, 3, 33, 100])
@pytest.mark.parametrize("quant", [False, True])
def test_halo_pack_kernel_matches_plain(device, nfeat, quant):
    """The fused gather (and quantize) is bit for bit the plain version's."""
    from grandtpu_torch.dist.halo import halo_pack, halo_pack_plain
    prop, xs = _halo_case(device, nfeat, False, False)
    amax = (torch.stack([x.abs().amax(0) for x in xs]).amax(0)
            if quant else None)
    for x, idx in zip(xs, prop.send_idx):
        before = halo_pack.launches
        send, scale = halo_pack(x, idx, amax)
        torch.cuda.synchronize()
        assert halo_pack.launches == before + 1
        want, want_scale = halo_pack_plain(x, idx, amax)
        assert send.dtype == want.dtype and torch.equal(send, want)
        assert (scale is None) == (not quant)
        if quant:
            assert torch.equal(scale, want_scale)


def _hand_send_idx(case):
    """send_idx [S=3, S, C_max] by hand: a row that every receiver needs,
    an empty group, groups of padding only (row 0), a row with more slots
    than a plan item holds."""
    from grandtpu_torch.dist.halo import SLOTS_PER_ITEM
    send = np.zeros((3, 3, 6), np.int32)
    if case == "every_receiver":
        send[0, :, 0] = 4
        send[0, 1, 1:3] = [1, 6]
    elif case == "empty_group":
        send[1, 0, :4] = [0, 2, 3, 9]
        send[1, 2, :] = 0
    elif case == "long_row":
        send = np.zeros((3, 3, 2 * SLOTS_PER_ITEM + 3), np.int32)
        send[2, 1, :5] = [7, 8, 9, 10, 11]
    return send


@pytest.mark.parametrize("case", ["every_receiver", "empty_group",
                                  "all_padding", "long_row"])
@pytest.mark.parametrize("nfeat", [1, 3, 100, 4100])
@pytest.mark.parametrize("quant", [False, True])
def test_halo_pack_plan_cases_match_plain(device, case, nfeat, quant):
    """halo_pack bit for bit its plain version (and col_scale) on
    hand-made send lists, with the plan built by the wrapper and by
    SendPlan.build; F 4100 takes two windows of the shared scales, and a
    zero column the scale 1."""
    from grandtpu_torch.dist.halo import SendPlan, halo_pack, halo_pack_plain
    gen = torch.Generator(device).manual_seed(4)
    x = torch.randn(12, nfeat, device=device, generator=gen)
    x[:, 0] = 0.0
    amax = x.abs().amax(0) * 1.25 if quant else None
    send = _hand_send_idx(case)
    for s in range(3):
        idx = torch.as_tensor(send[s].reshape(-1), device=device)
        want, want_scale = halo_pack_plain(x, idx, amax)
        for plan in (None, SendPlan.build(idx)):
            got, scale = halo_pack(x, idx, amax, plan)
            torch.cuda.synchronize()
            assert got.dtype == want.dtype and torch.equal(got, want)
            assert (scale is None) == (not quant)
            if quant:
                assert torch.equal(scale, want_scale)


@pytest.mark.parametrize("form", ["f32", "cast", "exact"])
@pytest.mark.parametrize("nfeat,hub,empty_shard", [
    (1, False, False), (33, False, True), (100, True, False),
    (64, True, True)])
@pytest.mark.parametrize("accumulate", [True, False])
def test_halo_hop_kernel_matches_plain(device, form, nfeat, hub,
                                       empty_shard, accumulate):
    """halo_hop against its plain version, each form: both add each partial
    sum in edge order with rounded products, so a hop is bit for bit the
    plain one; the hub row (9000 nonzeros, diagonal and halo) included."""
    from grandtpu_torch.dist.halo import (halo_hop, halo_hop_plain,
                                          halo_pack)
    prop, xs = _halo_case(device, nfeat, hub, empty_shard)
    S, c = 3, prop.g.halo_per_pair
    quant = form != "f32"
    amax = (torch.stack([x.abs().amax(0) for x in xs]).amax(0)
            if quant else None)
    packs = [halo_pack(x, idx, amax) for x, idx in zip(xs, prop.send_idx)]
    recv = prop.mesh.all_to_all([p.view(S, c, -1) for p, _ in packs])
    for s in range(S):
        row_val = prop.row_val[s] if form == "exact" else None
        acc = torch.randn_like(xs[s]) if accumulate else None
        outs = []
        for hop in (halo_hop, halo_hop_plain):
            y = torch.empty_like(xs[s])
            a = acc.clone() if accumulate else None
            before = halo_hop.launches
            hop(prop.diag[s], prop.halo[s], xs[s], recv[s].view(S * c, -1),
                y, a, 0.8, accumulate, packs[s][1], row_val)
            torch.cuda.synchronize()
            if hop is halo_hop:
                assert halo_hop.launches == before + (1 if xs[s].numel()
                                                      else 0)
            outs.append((y, a))
        assert torch.equal(outs[0][0], outs[1][0])
        if accumulate:
            assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("variant,precision", [
    ("scatter", "f32"), *((v, p) for v in ("block", "halo")
                          for p in ("f32", "bf16", "int8", "int8cast"))])
def test_sharded_propagators_match_plain_runs(device, variant, precision):
    """A whole 4-hop run of each D1 variant on a 4-shard mesh on the card
    against the same run with the plain versions (plain=True)."""
    from grandtpu_torch.dist import (BlockShardedGraph,
                                     BlockShardedPropagator,
                                     HaloPropagator, HaloShardedGraph,
                                     ShardedGraph, ShardedPropagator,
                                     make_mesh)
    adj = _seg_graph(3000, False, seed=7) + sp.eye(3000, format="csr")
    mesh = make_mesh(4, devices=[device] * 4)
    x = torch.randn(3000, 36, device=device,
                    generator=torch.Generator(device).manual_seed(3))
    if variant == "scatter":
        prop, kw = ShardedPropagator(mesh, ShardedGraph.build(adj, 4)), {}
    else:
        cls, gcls = ((BlockShardedPropagator, BlockShardedGraph)
                     if variant == "block" else
                     (HaloPropagator, HaloShardedGraph))
        prop = cls(mesh, gcls.build(adj, 4, rows_per_block=64))
        kw = {"precision": precision}
    got = prop(x, order=4, alpha=0.2, **kw)
    want = prop(x, order=4, alpha=0.2, plain=True, **kw)
    torch.cuda.synchronize()
    limit = TOL if precision in ("f32", "bf16") else 5e-3
    assert _rel_err(got, want) <= limit


@pytest.mark.parametrize("axis", ["data", "model"])
@pytest.mark.parametrize("variant,precision", [
    ("scatter", "f32"), ("block", "f32"), ("block", "int8"),
    ("halo", "int8")])
def test_sharded_propagators_on_a_2d_mesh_equal_the_1d_mesh(
        device, variant, precision, axis):
    """A 4-hop run of each D1 variant on a (2 x 2) mesh of the card along
    ``axis``: every group's result equal, and bit for bit the run on a 1-D
    mesh of 2 shards of the card."""
    from grandtpu_torch.dist import (BlockShardedGraph,
                                     BlockShardedPropagator,
                                     HaloPropagator, HaloShardedGraph,
                                     ShardedGraph, ShardedPropagator,
                                     make_mesh)
    adj = _seg_graph(3000, False, seed=7) + sp.eye(3000, format="csr")
    mesh = make_mesh(2, n_model=2, devices=[device] * 4)
    x = torch.randn(3000, 36, device=device,
                    generator=torch.Generator(device).manual_seed(3))
    if variant == "scatter":
        cls, g, kw = ShardedPropagator, ShardedGraph.build(adj, 2), {}
    else:
        cls, gcls = ((BlockShardedPropagator, BlockShardedGraph)
                     if variant == "block" else
                     (HaloPropagator, HaloShardedGraph))
        g, kw = gcls.build(adj, 2, rows_per_block=64), {"precision":
                                                          precision}
    outs = cls(mesh, g, axis).each(x, order=4, alpha=0.2, **kw)
    one = cls(make_mesh(2, devices=[device] * 2), g)(x, order=4, alpha=0.2,
                                                     **kw)
    torch.cuda.synchronize()
    assert len(outs) == 2
    assert all(torch.equal(o, one) for o in outs)


def test_process_mesh_on_one_card(device, tmp_path):
    """2 ranks on cuda:0 with the gloo backend (one shard each, a process
    apiece, tests/test_torch_dist_process.py's ``card`` part): one dense
    step, every drop rate on, within 1e-5 of the one-process 2-shard mesh's
    step on the card, the replicas bit-identical; then the nccl backend
    with both ranks on the card is refused, naming gloo."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "dist_process", os.path.join(os.path.dirname(__file__),
                                     "test_torch_dist_process.py"))
    workers = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(workers)
    outs = workers.spawn("card", tmp_path, ports=2, timeout=300)
    for out in outs:
        assert "refused: NCCL cannot run two ranks on one card" in out, out


# scan_steps: a rolled step group as one CUDA graph replay (train/loop.py)

def _group_setup(engine: str, device):
    """A small model of ``engine`` with its Adam, its step as the
    loop calls it (every drop rate of the step on), the step's generator
    and an epoch of 8 batches with their step indices."""
    from grandtpu_torch.config import GrandConfig
    from grandtpu_torch.nn.mag_mlp import init_mag_mlp
    from grandtpu_torch.nn.mlp import MLPConfig, init_mlp
    from grandtpu_torch.nn.sparse_input import PaddedFeatures
    from grandtpu_torch.train.step import (StepConfig, build_train_step,
                                           make_optimizer)
    from grandtpu_torch.train.trainer_sparse import build_sparse_steps

    torch.backends.cuda.matmul.allow_tf32 = False
    rs = np.random.RandomState(0)
    n, c, nt, nu, ktop = 300, 5, 12, 20, 16
    cfg = GrandConfig(batch_size=nt, unlabel_batch_size=nu, sample=3,
                      dropnode_rate=0.5, input_droprate=0.3,
                      hidden_droprate=0.2, hidden=32,
                      nlayers=2, use_bn=engine == "dense", node_norm=True,
                      lr=1e-2, weight_decay=1e-3, clip_norm=0.5, loss="kl",
                      warmup=10.0)
    tk = [torch.as_tensor(rs.randint(0, n, (200, ktop)).astype(np.int32),
                          device=device),
          torch.as_tensor(rs.rand(200, ktop).astype(np.float32),
                          device=device)]
    if engine == "dense":
        nfeat = 40
        operands = [torch.as_tensor(rs.rand(n, nfeat).astype(np.float32),
                                    device=device)] + tk
    else:
        m = (rs.rand(n, 500) < 0.02) * rs.rand(n, 500)
        padded = PaddedFeatures.from_csr(sp.csr_matrix(m.astype(np.float32)))
        nfeat = padded.num_features
        operands = [torch.as_tensor(a, device=device) for a in
                    (padded.attr_cols, padded.attr_vals)] + tk
    mcfg = MLPConfig(num_features=nfeat, num_classes=c, hidden=cfg.hidden,
                     nlayers=2, use_bn=cfg.use_bn, node_norm=True,
                     input_droprate=cfg.input_droprate,
                     hidden_droprate=cfg.hidden_droprate)
    model = (init_mlp if engine == "dense" else init_mag_mlp)(mcfg, 0,
                                                              device)
    opt = make_optimizer(model, cfg.lr, cfg.weight_decay)
    if engine == "dense":
        step = build_train_step(StepConfig(
            mlp=mcfg, k_aug=cfg.sample, dropnode_rate=cfg.dropnode_rate,
            n_train=nt, lam=1.0, warmup=cfg.warmup, tem=0.5, conf=0.4,
            loss_kind="kl", clip_norm=cfg.clip_norm), model, opt)
    else:
        step = build_sparse_steps(cfg, model, opt, c)[0]
    gen = torch.Generator(device=device).manual_seed(7)
    lmask = np.ones((8, nt), np.float32)
    lmask[:, -3:] = 0.0
    epoch = {"rows": torch.as_tensor(rs.randint(0, 200, (8, nt + nu)),
                                     device=device),
             "labels": torch.as_tensor(rs.randint(0, c, (8, nt)),
                                       device=device),
             "label_mask": torch.as_tensor(lmask, device=device),
             "unlabel_mask": torch.ones(8, nu, device=device)}
    nbs = torch.arange(2, 10, dtype=torch.float32, device=device)

    def step_fn(batch, nb):
        return step(*operands, batch, gen, nb)

    return model, opt, gen, step_fn, epoch, nbs


def _saved(model, opt, gen):
    out = {f"m.{k}": v.detach().clone() for k, v in model.state_dict().items()}
    for i, p in enumerate(model.parameters()):
        for key, v in opt.state.get(p, {}).items():
            out[f"a.{i}.{key}"] = v.detach().clone()
    out["count"] = opt.count.clone()
    out["gen"] = gen.get_state()
    return out


def _restore(model, opt, gen, saved):
    model.load_state_dict({k[2:]: v for k, v in saved.items()
                           if k.startswith("m.")})
    for i, p in enumerate(model.parameters()):
        for key, v in opt.state.get(p, {}).items():
            v.copy_(saved[f"a.{i}.{key}"])
    opt.count.copy_(saved["count"])
    gen.set_state(saved["gen"])


@pytest.mark.parametrize("engine", ["dense", "mag"])
def test_step_group_replay_equals_eager_steps(device, engine):
    """From one saved state, a StepGroup of 3 steps (captured into a CUDA
    graph, then replayed) against the same 3 steps run eagerly: the dense
    engine's parameters, BN buffers, Adam state and generator state bit
    for bit; MAG's too (K3's backward adds in a fixed order). The
    wrappers (Adam's too)
    count k launches a replay, none for the capture; a second group of
    another length runs eagerly between replays and the next replay still
    equals eager steps."""
    from grandtpu_torch.nn.dropnode import gather_and_prop as k1
    from grandtpu_torch.train.adam import adam_update
    from grandtpu_torch.train.loop import StepGroup

    model, opt, gen, step_fn, epoch, nbs = _group_setup(engine, device)
    counted = ([k1, adam_update] if engine == "dense"
               else [embed_prop, embed_prop_backward, adam_update])

    def eager(i0, k):
        for i in range(i0, i0 + k):
            step_fn({n: t[i] for n, t in epoch.items()}, nbs[i])

    def check(got, want):
        for key, w in want.items():
            assert torch.equal(got[key], w), key

    eager(0, 2)                         # Adam's state, first launches
    saved = _saved(model, opt, gen)
    eager(2, 3)
    torch.cuda.synchronize()
    want = _saved(model, opt, gen)
    _restore(model, opt, gen, saved)
    rest = {n: t[2:] for n, t in epoch.items()}
    group = StepGroup(3, step_fn, rest, device, (gen,))
    before = [f.launches for f in counted]
    group(rest, nbs[2:], 0)
    torch.cuda.synchronize()
    assert group.graph is not None
    assert [f.launches - b for f, b in zip(counted, before)] == [3] * len(
        counted)
    assert set(group.launches.values()) == {3}
    check(_saved(model, opt, gen), want)

    # eager steps of another count in between, then a replay of other
    # batches: against the same steps run eagerly from the same state
    saved = _saved(model, opt, gen)
    eager(5, 2)
    eager(4, 3)
    torch.cuda.synchronize()
    want = _saved(model, opt, gen)
    _restore(model, opt, gen, saved)
    eager(5, 2)
    before = [f.launches for f in counted]
    group(epoch, nbs, 4)                # steps 4, 5, 6 of the epoch
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counted, before)] == [3] * len(
        counted)
    check(_saved(model, opt, gen), want)


@pytest.mark.parametrize("engine", ["dense", "mag"])
def test_adam_checkpoint_round_trip_into_a_captured_group(device, tmp_path,
                                                          engine):
    """Adam's state written with training_trees after 2 eager steps, then a
    captured group of 3 steps (a replay advances the int32 count on the
    card by 3); restore_training of the file into the live optimizer copies
    into its moments and count (the same tensors, on the card), and the
    group's graph replayed from there gives what its first replay gave,
    bit for bit (the count and the generator's state too)."""
    from grandtpu_torch.train import checkpoint as tckpt
    from grandtpu_torch.train.loop import StepGroup

    model, opt, gen, step_fn, epoch, nbs = _group_setup(engine, device)
    for i in range(2):
        step_fn({n: t[i] for n, t in epoch.items()}, nbs[i])
    assert opt.count.device == next(model.parameters()).device
    assert opt.count.dtype == torch.int32 and int(opt.count) == 2
    params, state, ost = tckpt.training_trees(model, opt, 1e-3)
    path = str(tmp_path / "latest.npz")
    tckpt.save_checkpoint(path, params=params, state=state, opt_state=ost,
                          num_batch=2, best_val_acc=0.5, best_val_loss=0.5)
    gen_state = gen.get_state()
    group = StepGroup(3, step_fn, epoch, device, (gen,))
    group(epoch, nbs, 2)
    torch.cuda.synchronize()
    assert group.graph is not None and int(opt.count) == 5
    want = _saved(model, opt, gen)
    held = {id(v) for st in opt.state.values() for v in st.values()}
    params_t, state_t = tckpt.training_templates(model)
    lp, ls, lo, meta = tckpt.load_checkpoint(
        path, params_template=params_t, state_template=state_t,
        opt_template=tckpt.adam_tree(params_t, weight_decay=1e-3))
    tckpt.restore_training(model, opt, lp, ls, lo)
    gen.set_state(gen_state)
    assert int(opt.count) == 2 and meta["num_batch"] == 2
    assert {id(v) for st in opt.state.values() for v in st.values()} == held
    group(epoch, nbs, 2)
    torch.cuda.synchronize()
    got = _saved(model, opt, gen)
    for key, w in want.items():
        assert torch.equal(got[key], w), key


@pytest.mark.parametrize("engine", ["dense", "mag"])
def test_train_scan_steps_on_the_card(device, engine):
    """train(scan_steps=True) on the card: the rolled lengths are CUDA-graph
    replays whose launches count (Adam once a step), and the run is the
    per-step run: the same step count, the history and test_acc equal (a
    replayed step runs what an eager one runs)."""
    from grandtpu_torch.config import GrandConfig
    from grandtpu_torch.data import load_data
    from grandtpu_torch.nn.dropnode import gather_and_prop as k1
    from grandtpu_torch.train import train
    from grandtpu_torch.train.adam import adam_update

    if engine == "dense":
        cfg = GrandConfig(dataset="synth:400:4:32", epochs=8, eval_batch=3,
                          patience=100)
    else:
        cfg = GrandConfig(dataset="synth:400:4:64:sparse", epochs=6,
                          eval_batch=4, patience=100, batch_size=20,
                          unlabel_batch_size=30, hidden=32)
    data = load_data(cfg.dataset, split_seed=cfg.seed1)
    per = train(cfg, data=data, device=device)
    counted = k1 if engine == "dense" else embed_prop_backward
    before = counted.launches, adam_update.launches
    got = train(cfg.replace(scan_steps=True), data=data, device=device)
    assert got.scan_groups and all(s["graph"]
                                   for s in got.scan_groups.values())
    steps = got.num_batches
    want = (steps + len(got.history)) if engine == "dense" else steps
    assert counted.launches - before[0] == want
    assert adam_update.launches - before[1] == steps
    assert got.num_batches == per.num_batches
    assert got.history == per.history
    assert got.test_acc == per.test_acc


# Adam (csrc/adam.cu): grandtpu's optax chain over a list of leaves

def _adam_shapes(engine: str) -> tuple:
    """(leaf shapes, the indices without a gradient) of a main-path model:
    the reddit preset's MLP (F 602, 41 classes, BatchNorm on) or the MAG
    table [2780000, 64] with mag_scholar_c's head (8 classes, its unused
    BatchNorm's parameters without a gradient)."""
    from grandtpu_torch.nn.mag_mlp import MagMLP
    from grandtpu_torch.nn.mlp import MLP, MLPConfig

    if engine == "reddit":
        model = MLP(MLPConfig(num_features=602, num_classes=41, hidden=512,
                              nlayers=2, use_bn=True))
    else:
        with torch.device("meta"):
            model = MagMLP(MLPConfig(num_features=2780000, num_classes=8,
                                     hidden=64, nlayers=2, use_bn=False))
    named = list(model.named_parameters())
    return ([tuple(p.shape) for _, p in named],
            {i for i, (n, _) in enumerate(named)
             if n.startswith("bns.") and not model.cfg.use_bn})


ADAM_CASES = {
    "reddit": lambda: _adam_shapes("reddit"),
    "mag": lambda: _adam_shapes("mag"),
    "no_grad": lambda: ([(64, 33), (17,), (5,)], {1}),
    "odd_lengths": lambda: ([(7,), (1001,), (3, 5), (1,), (0,)], set()),
    "many_leaves": lambda: ([(1 + (37 * i) % 300,) for i in range(150)],
                            {3, 77}),
}


def _adam_inputs(shapes, no_grad, device, offset: int):
    """Leaves, gradients (None at ``no_grad``), mu and nu of ``shapes``,
    drawn on the card; each a view ``offset`` floats into its storage (1:
    off the 16-byte alignment)."""
    g = torch.Generator(device=device).manual_seed(0)

    def make(shape, scale, positive=False):
        n = int(np.prod(shape))
        draw = torch.rand if positive else torch.randn
        return (draw(n + offset, generator=g, device=device) * scale)[
            offset:].view(shape)

    return ([make(s, 0.5) for s in shapes],
            [None if i in no_grad else make(s, 1e-2)
             for i, s in enumerate(shapes)],
            [make(s, 1e-3) for s in shapes],
            [make(s, 1e-5, positive=True) for s in shapes])


@pytest.mark.parametrize("wd", [0.0, 1e-2])
@pytest.mark.parametrize("case,offset", [
    (case, offset) for case in sorted(ADAM_CASES) for offset in (0, 1)
    if case != "mag" or offset == 0])   # the 712 MB table once
def test_adam_kernel_matches_plain(device, case, offset, wd):
    """adam_update (one launch a MAX_LEAVES non-empty leaves) bit for bit
    adam_update_plain on the card: every leaf, mu and nu, from random
    moments at step 3 (bias corrections as the optimizer takes them)."""
    from grandtpu_torch.train.adam import (MAX_LEAVES, adam_update,
                                           adam_update_plain)

    shapes, no_grad = ADAM_CASES[case]()
    got = _adam_inputs(shapes, no_grad, device, offset)
    want = [[None if t is None else t.clone() for t in ts] for ts in got]
    count = torch.tensor(3.0, device=device)
    bc = 1 - torch.pow(torch.tensor([0.9, 0.999], device=device), count)
    before = adam_update.launches
    adam_update(*got, bc[0], bc[1], 1e-2, wd)
    live = sum(int(np.prod(s)) > 0 for s in shapes)
    assert adam_update.launches - before == -(-live // MAX_LEAVES)
    adam_update_plain(*want, bc[0], bc[1], 1e-2, wd)
    torch.cuda.synchronize()
    for what, gs, ws in zip(("leaf", "mu", "nu"), (got[0], got[2], got[3]),
                            (want[0], want[2], want[3])):
        for i, (a, b) in enumerate(zip(gs, ws)):
            assert torch.equal(a, b), (what, i, _rel_err(a, b))


def test_adam_max_leaves_matches_the_kernel(device):
    from grandtpu_torch.train.adam import MAX_LEAVES

    assert load_kernels().adam_max_leaves() == MAX_LEAVES


def test_adam_refuses_what_the_kernel_does_not_take(device):
    """No fallback: an f64 leaf, a moment of another shape and bias
    corrections off the card raise."""
    from grandtpu_torch.train.adam import adam_update

    p = torch.zeros(8, device=device)
    bc = torch.ones(2, device=device)
    with pytest.raises(TypeError):
        adam_update([p.double()], [None], [p.double()], [p.double()], bc[0],
                    bc[1], 1e-2, 0.0)
    with pytest.raises(ValueError):
        adam_update([p], [None], [torch.zeros(4, device=device)], [p.clone()],
                    bc[0], bc[1], 1e-2, 0.0)
    with pytest.raises(ValueError):
        adam_update([p], [None], [p.clone()], [p.clone()], bc[0].cpu(),
                    bc[1].cpu(), 1e-2, 0.0)

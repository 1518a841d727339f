"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips where no CUDA device is present. On a
machine with a card and without JAX, run them with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest imports JAX). Shapes cover the edge
cases the full-width checks in ``chip_smoke.py`` do not: K = 1..8, odd
widths, empty and fully masked rows, hub rows, and for K3 attribute-free
nodes, input dropout, colliding ids (the backward's atomics) and the node
form; for the fast-precision hops (K2-bf16, quantize, K2-q8, K2-q8mxu) f32
and bf16 carries, widths that are not a multiple of 4 or 32, an all-zero
column, a 9000-nonzero hub row and a one-row operator; for the GFPush
kernels (top-k, P1's push mask, P2's expansion and compaction) ties, rows
with fewer than k positives, a dangling node, a 9000-nonzero hub source and
determinism; for K2-seg (coo_spmm), D1's halo_pack and halo_hop (each
form) and the quantize split (column_absmax, quantize_with_amax) 4-wide and
1-wide lanes, a 9000-nonzero hub row, empty rows and an empty shard.
"""

import functools

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from grandtpu_torch.nn.dropnode import gather_and_prop, gather_and_prop_plain
from grandtpu_torch.ppr.coef import build_coef
from grandtpu_torch.ppr.dense_push import (dense_push_mask,
                                           dense_push_mask_plain)
from grandtpu_torch.ppr.push_topk import (push_topk, push_topk_plain,
                                          row_offsets)
from grandtpu_torch.nn.sparse_input import (embed_prop, embed_prop_backward,
                                            embed_prop_plain)
from grandtpu_torch.sparse.spmm import (CSROperator, quantize_columns,
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
    # the backward's atomics sum in another order than autograd's scatter
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


def _assert_hop_matches(got, want, kernel, carry):
    """A hop's carry against the plain version's. The plain versions add
    in the kernels' order, so a hop whose terms round as the plain's do
    (every kernel but K2's fused multiply-add) is bit for bit the same with
    bf16 carries; K2 with bf16 carries stays within one bf16 ulp of
    max |plain| (2^-8) with at most 1e-3 of the elements different. f32
    carries: TOL (1e-6 for K2-q8mxu, whose int32 sums are exact)."""
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
                                     (9500, 1)])
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
def test_hops_on_misaligned_views_match_plain(device, kernel, carry):
    rs = np.random.RandomState(6)
    norm, varied = _hop_operator(300)
    op = CSROperator.from_scipy(norm if kernel == "q8mxu" else varied,
                                device)
    x = _carry(torch.tensor(rs.randn(300, 100).astype(np.float32),
                            device=device), carry)
    acc0 = _carry(torch.tensor(rs.randn(300, 100).astype(np.float32),
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
        if kernel == "q8":
            spmm_prop_step_q8(op, _misaligned(q), scale, out_k, acc_k, 0.8,
                              True)
            spmm_prop_step_q8_plain(op, q, scale, out_p, acc_p, 0.8, True)
        else:
            row_val = torch.tensor(row_values_if_constant(norm),
                                   device=device)
            spmm_prop_step_q8mxu(op, _misaligned(q), scale, row_val, out_k,
                                 acc_k, 0.8, True)
            spmm_prop_step_q8mxu_plain(op, q, scale, row_val, out_p, acc_p,
                                       0.8, True)
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
    before = (bucket_push.bucket_expand.launches,
              bucket_push.bucket_compact.launches)
    got = bucket_push.push_block(g, src, coef, 64)
    again = bucket_push.push_block(g, src, coef, 64)
    torch.cuda.synchronize()
    assert bucket_push.bucket_expand.launches > before[0]
    assert bucket_push.bucket_compact.launches > before[1]
    want = bucket_push.push_block(g, src, coef, 64, plain=True)
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(got[0][0], got[0][4])     # the same source twice


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


@pytest.mark.parametrize("n,nfeat,hub", [(50, 1, False), (300, 33, False),
                                         (9500, 100, True), (9500, 64, True),
                                         (2, 4, False)])
def test_coo_spmm_kernel_matches_plain(device, n, nfeat, hub):
    """K2-seg against its plain version: rows inside one edge run add in
    edge order, as the plain version does; a row over several runs adds
    their partial sums with atomics (in any order where there are more
    than two: the hub row), so the limit is TOL, not bit for bit."""
    from grandtpu_torch.sparse.spmm import (PaddedCSR, spmm_segment,
                                            spmm_segment_plain)
    adj = _seg_graph(n, hub)
    padded = PaddedCSR.from_scipy(adj, device=device)
    x = torch.randn(n, nfeat, device=device,
                    generator=torch.Generator(device).manual_seed(0))
    before = spmm_segment.launches
    out = torch.full((n + 1, nfeat), 3.0, device=device)
    got = spmm_segment(padded, x, out=out)
    torch.cuda.synchronize()
    assert spmm_segment.launches == before + 1
    want = spmm_segment_plain(padded, x)
    assert _rel_err(got, want) <= TOL
    assert float(out[-1].abs().max()) == 0.0          # the discard row
    assert float(got[0].abs().max()) == 0.0           # an empty row
    # rows of at most 32 edges span at most two runs: deterministic sums;
    # and the library's product
    again = spmm_segment(padded, x)
    inside = torch.ones(n, dtype=torch.bool, device=device)
    if hub:
        inside[3] = False
    assert torch.equal(again[inside], got[inside])
    a = torch.sparse_coo_tensor(
        torch.stack([padded.rows.long(), padded.cols.long()]), padded.vals,
        (n + 1, n)).coalesce()
    assert _rel_err(got, torch.sparse.mm(a, x)[:n]) <= TOL


def test_coo_spmm_wrapper_checks(device):
    from grandtpu_torch.sparse.spmm import PaddedCSR, spmm_segment
    adj = _seg_graph(40, False)
    padded = PaddedCSR.from_scipy(adj, device=device)
    with pytest.raises(TypeError):
        spmm_segment(padded, torch.zeros(40, 4, dtype=torch.float64,
                                         device=device))
    with pytest.raises(ValueError):
        spmm_segment(padded, torch.zeros(41, 4, device=device))
    with pytest.raises(ValueError):
        spmm_segment(padded, torch.zeros(40, 4, device=device),
                     out=torch.zeros(40, 4, device=device))
    rows = padded.rows.clone()
    i = int(torch.nonzero(rows[1:] > rows[:-1])[0, 0])
    rows[[i, i + 1]] = rows[[i + 1, i]]
    with pytest.raises(ValueError, match="sorted"):
        PaddedCSR(rows, padded.cols, padded.vals, 40, padded.chunk)


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


@pytest.mark.parametrize("nfeat", [1, 33, 100])
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

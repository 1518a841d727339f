"""The port's tensor parallelism on CPU meshes (``make_mesh(n_data,
n_model=m, device="cpu")``, the kernels' plain versions): a 'model' axis
on the mesh, the dense MLP's hidden width and the MAG table's columns split
over it.

- The 2-D collectives and their adjoints against sums written by hand, on
  (2 x 2), (1 x 2) and (2 x 3) meshes.
- The split step against the port's one-device step from the same state
  and generator seed, every drop rate on, BN and the clip on, node_norm on
  and off, 3 steps on (1 x 2), (2 x 2) and (4 x 2), ``nlayers`` 2 and 3:
  metrics, and every parameter, gradient, Adam moment and BN buffer with
  the blocks joined. Adam runs with weight decay 1e-3 throughout, as
  ``tests/test_dist.py`` sets it up.
- The split step against grandtpu's GSPMD step on ``make_mesh(n_data=4,
  n_model=2)`` (``tests/test_dist.py``'s set-up), every drop rate 0, the
  weights carried across by ``convert``; dense and MAG.
- Both engines' eval steps; checkpoints both ways across the packages;
  the refusals; one layer split and one model shard against the
  replicated step.

Tolerance: max |a - b| / max |b| <= 1e-5 (f32 sums in another order).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from grandtpu.config import GrandConfig as JaxConfig
from grandtpu.data import synthetic_graph
from grandtpu.dist import data_parallel as jdp
from grandtpu.dist import make_mesh as jax_make_mesh
from grandtpu.nn import mag_mlp as jmag
from grandtpu.nn import mlp as jmlp
from grandtpu.ppr import gfpush as jax_gfpush
from grandtpu.train import checkpoint as jckpt
from grandtpu.train import step as jstep
from grandtpu.train import trainer_sparse as jts

from grandtpu_torch.config import GrandConfig
from grandtpu_torch.convert import (mag_from_jax, mag_to_jax, mlp_from_jax,
                                    mlp_to_jax)
from grandtpu_torch.dist import (dist_exact_propagate, joined_state,
                                 make_mesh, shard_batch,
                                 shard_sparse_train_inputs,
                                 shard_train_inputs, sharded_gfpush)
from grandtpu_torch.dist.data_parallel import split_rows
from grandtpu_torch.dist.mesh import Mesh
from grandtpu_torch.nn.mag_mlp import init_mag_mlp
from grandtpu_torch.nn.mlp import MLPConfig, init_mlp
from grandtpu_torch.nn.sparse_input import PaddedFeatures
from grandtpu_torch.train import step as tstep
from grandtpu_torch.train import trainer as ttrainer
from grandtpu_torch.train import trainer_sparse as ttsparse
from grandtpu_torch.train.checkpoint import (load_model, model_trees,
                                             save_checkpoint)

# one intra-op thread a test process (see test_torch_dist.py)
torch.set_num_threads(1)

TOL = 1e-5
N, C, F_, VOCAB, NT, NU, H = 200, 3, 24, 30, 32, 32, 16
MESHES = [(1, 2), (2, 2), (4, 2)]


def _np(x):
    return (x.detach().cpu().numpy() if torch.is_tensor(x)
            else np.asarray(x)).astype(np.float64)


def rel(got, want):
    got, want = _np(got), _np(want)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


@pytest.fixture(scope="module")
def graph():
    """grandtpu's 200-node test graph, its top-k table and a CSR
    bag-of-words over a vocabulary of 30 (test_dist.py's MAG step)."""
    adj, feats, labels = synthetic_graph(num_nodes=N, num_classes=C,
                                         num_features=F_, seed=9)
    adj = (adj + sp.eye(N, format="csr")).tocsr()
    tk = jax_gfpush(adj, np.arange(N), prop_mode="ppr", order=4, alpha=0.2,
                    rmax=1e-6, k=8, backend="numpy")
    rs = np.random.RandomState(3)
    bow = sp.random(N, VOCAB, density=0.15, format="csr", random_state=rs,
                    dtype=np.float32)
    bow.data[:] = np.abs(bow.data) + 0.1
    padded = PaddedFeatures.from_csr(bow)
    return {"adj": adj, "feats": feats,
            "labels": labels.argmax(-1).astype(np.int64),
            "cols": tk.cols, "vals": tk.vals, "attr_cols": padded.attr_cols,
            "attr_vals": padded.attr_vals}


def _batches(graph, n, seed=0):
    """Wrap-padded-looking batches: some label and unlabel rows masked."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        lab = rs.permutation(N)[:NT]
        out.append({
            "rows": np.concatenate([lab, rs.permutation(N)[:NU]]),
            "labels": graph["labels"][lab],
            "label_mask": (rs.rand(NT) < 0.85).astype(np.float32),
            "unlabel_mask": (rs.rand(NU) < 0.9).astype(np.float32)})
    return out


def _torch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _jax_batch(b):
    return {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
            for k, v in b.items()}


def _check_states(got_model, got_opt, want_model, want_opt):
    want = joined_state(want_model, want_opt)
    got = joined_state(got_model, got_opt)
    assert want.keys() == got.keys(), (sorted(want), sorted(got))
    for name, w in want.items():
        for i, what in enumerate(("value", "grad", "mu", "nu")[:len(w)]):
            assert rel(got[name][i], w[i]) <= TOL, (name, what)


def _dense_cfgs(nlayers, node_norm=True, drop=True):
    rate = 0.3 if drop else 0.0
    mcfg = MLPConfig(F_, C, H, nlayers, use_bn=True, node_norm=node_norm,
                     input_droprate=rate, hidden_droprate=rate)
    scfg = tstep.StepConfig(mlp=mcfg, k_aug=2,
                            dropnode_rate=0.5 if drop else 0.0, n_train=NT,
                            lam=1.0, warmup=10.0, tem=0.1, conf=2 / 3,
                            loss_kind="l2", clip_norm=0.1)
    return mcfg, scfg


def _mag_cfgs(nlayers=2, drop=True, classes=C):
    rate = 0.3 if drop else 0.0
    kw = dict(hidden=H, nlayers=nlayers, use_bn=True, node_norm=True)
    cfg = GrandConfig(dataset="x", batch_size=NT, unlabel_batch_size=NU,
                      sample=2, dropnode_rate=0.5 if drop else 0.0,
                      input_droprate=rate, hidden_droprate=rate, lam=1.0,
                      warmup=10.0, tem=0.1, loss="l2", clip_norm=0.1, lr=0.01,
                      weight_decay=1e-3, **kw)
    return cfg, MLPConfig(num_features=VOCAB, num_classes=classes,
                          input_droprate=rate, hidden_droprate=rate, **kw)


def _dense_step(graph, model, scfg, mesh, tensor_parallel=True):
    ops = [torch.as_tensor(graph[k]) for k in ("feats", "cols", "vals")]
    if mesh is not None:
        ops = shard_train_inputs(mesh, model=model, features=ops[0],
                                 tk_cols=ops[1], tk_vals=ops[2],
                                 tensor_parallel=tensor_parallel)
    opt = tstep.make_optimizer(model, 0.01, 1e-3)
    step = tstep.build_train_step(scfg, model, opt, mesh=mesh)
    evaluate = tstep.build_eval_step(scfg, model, mesh=mesh)

    def run(b, g, nb):
        return step(*ops, shard_batch(mesh, _torch(b)) if mesh is not None
                    else _torch(b), g, nb)

    return opt, run, lambda *rest: evaluate(*ops, *rest)


def _mag_step(graph, model, cfg, mesh, emb_mode="tp", classes=C):
    ops = [torch.as_tensor(graph[k])
           for k in ("attr_cols", "attr_vals", "cols", "vals")]
    if mesh is not None:
        ops = shard_sparse_train_inputs(
            mesh, model=model, attr_cols=ops[0], attr_vals=ops[1],
            tk_cols=ops[2], tk_vals=ops[3], emb_mode=emb_mode)
    opt = tstep.make_optimizer(model, cfg.lr, cfg.weight_decay)
    step, evaluate = ttsparse.build_sparse_steps(cfg, model, opt, classes,
                                                 mesh=mesh)

    def run(b, g, nb):
        return step(*ops, shard_batch(mesh, _torch(b)) if mesh is not None
                    else _torch(b), g, nb)

    return opt, run, lambda *rest: evaluate(*ops, *rest)


def _check_trees(got, want):
    """The port's (params, state) against grandtpu's: BN state leaf by
    leaf, parameter values relative to the model's largest parameter (as
    tests/test_torch_dist_process.py compares them: a BN bias starts at 0,
    so after a few Adam steps it is nothing but lr-sized updates)."""
    got_p, got_s = got
    want_p, want_s = jax.tree.map(np.asarray, want)
    scale = max(np.abs(w).max() for w in jax.tree.leaves(want_p))
    for g, w in zip(jax.tree.leaves(got_p), jax.tree.leaves(want_p)):
        assert np.abs(_np(g) - _np(w)).max() / scale <= TOL
    for g, w in zip(jax.tree.leaves(got_s), jax.tree.leaves(want_s)):
        assert rel(g, w) <= TOL


def _same_steps(run1, run2, batches):
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    for nb, b in enumerate(batches):
        r1, r2 = run1(b, g1, nb), run2(b, g2, nb)
        assert r1.keys() == r2.keys()
        for k in r1:
            assert rel(r2[k], r1[k]) <= TOL, (nb, k)


# ------------------------------------------------------- the collectives


@pytest.mark.parametrize("shape", [(2, 2), (1, 2), (2, 3)])
def test_model_axis_collectives_and_their_adjoints(shape):
    """g, f, the column blocks and the data-axis collectives of a 2-D mesh,
    forward and gradient, against sums written by hand (f64: exact)."""
    nd, nm = shape
    mesh = make_mesh(nd, n_model=nm, device="cpu")
    s = nd * nm
    rs = np.random.RandomState(10 * nd + nm)

    def t(*shp):
        return torch.tensor(rs.randn(*shp))

    def row(i):
        return [j for j in range(s) if j // nm == i // nm]

    def col(i):
        return [j for j in range(s) if j % nm == i % nm]

    def grads(outs, ws, leaves):
        loss = sum((o * w).sum() for o, w in zip(outs, ws))
        return torch.autograd.grad(loss, leaves)

    xs = [t(2, 3).requires_grad_(True) for _ in range(s)]
    ws = [t(2, 3) for _ in range(s)]
    # g: the row's sum, the identity backward
    outs = mesh.model_all_reduce(xs)
    for i, o in enumerate(outs):
        assert torch.allclose(o, sum(xs[j] for j in row(i)))
    for g, w in zip(grads(outs, ws, xs), ws):
        assert torch.equal(g, w)
    # f: the identity, the row's sum backward
    outs = mesh.model_copy(xs)
    assert all(torch.equal(o, x) for o, x in zip(outs, xs))
    for i, g in enumerate(grads(outs, ws, xs)):
        assert torch.allclose(g, sum(ws[j] for j in row(i)))
    # the column blocks of a replicated value, and their join
    wide = [t(2, 3 * nm).requires_grad_(True) for _ in range(s)]
    outs = mesh.model_split(wide)
    for i, o in enumerate(outs):
        m = i % nm
        assert torch.equal(o, wide[i][:, 3 * m:3 * (m + 1)])
    for i, g in enumerate(grads(outs, ws, wide)):
        assert torch.equal(g, torch.cat([ws[j] for j in row(i)], 1))
    outs = mesh.model_all_gather(xs)
    wws = [t(2, 3 * nm) for _ in range(s)]
    for i, o in enumerate(outs):
        assert torch.equal(o, torch.cat([xs[j] for j in row(i)], 1))
    for i, g in enumerate(grads(outs, wws, xs)):
        m = i % nm
        assert torch.equal(g, wws[i][:, 3 * m:3 * (m + 1)])
    # the data axis, within each model column
    outs = mesh.all_reduce_sum(xs)
    for i, o in enumerate(outs):
        assert torch.allclose(o, sum(xs[j] for j in col(i)))
    for i, g in enumerate(grads(outs, ws, xs)):
        assert torch.allclose(g, sum(ws[j] for j in col(i)))
    # the loss's sum: column 0's terms; its gradient to every term
    total = mesh.reduce_sum(xs)
    assert torch.allclose(total, sum(xs[j] for j in col(0)))
    w0 = t(2, 3)
    for g in torch.autograd.grad((total * w0).sum(), xs):
        assert torch.equal(g, w0)
    # a replicated value's gradient from column 0, over 'data'
    x = t(2, 3).requires_grad_(True)
    g, = grads(mesh.broadcast(x), ws, [x])
    assert torch.allclose(g, sum(ws[j] for j in col(0)))
    ps = [t(2, 3).requires_grad_(True) for _ in range(nm)]
    outs = mesh.broadcast_columns(ps)
    assert all(o is ps[i % nm] for i, o in enumerate(outs))
    for m, g in enumerate(grads(outs, ws, ps)):
        assert torch.allclose(g, sum(ws[j] for j in col(m)))
    tall = t(2 * nd, 3).requires_grad_(True)
    outs = mesh.scatter_rows(tall)
    for i, o in enumerate(outs):
        d = i // nm
        assert torch.equal(o, tall[2 * d:2 * (d + 1)])
    g, = grads(outs, ws, [tall])
    assert torch.allclose(g, torch.cat([ws[j] for j in col(0)]))
    assert torch.equal(mesh.gather_columns(ps, 1), torch.cat(ps, 1))


# ------------------------------------------------------ the dense engine


@pytest.mark.parametrize("node_norm", [True, False])
@pytest.mark.parametrize("nlayers", [2, 3])
@pytest.mark.parametrize("shape", MESHES)
def test_tp_dense_step_equals_one_device_step(graph, shape, nlayers,
                                              node_norm):
    mcfg, scfg = _dense_cfgs(nlayers, node_norm)
    mesh = make_mesh(shape[0], n_model=shape[1], device="cpu")
    one = init_mlp(mcfg, 0, "cpu")
    split = copy.deepcopy(one)
    opt1, run1, _ = _dense_step(graph, one, scfg, None)
    opt2, run2, _ = _dense_step(graph, split, scfg, mesh)
    assert split.sharded_parameters()
    assert not hasattr(split.fcs[0], "weight")
    _same_steps(run1, run2, _batches(graph, 3))
    _check_states(split, opt2, one, opt1)


@pytest.mark.parametrize("nlayers", [2, 3])
def test_tp_dense_step_matches_grandtpu_gspmd(graph, nlayers):
    """test_dist.py::test_gspmd_sharded_train_step on the port: (4 x 2),
    tensor_parallel, every drop rate 0, 2 steps."""
    mlp_kw = dict(num_features=F_, num_classes=C, hidden=H, nlayers=nlayers,
                  use_bn=True, node_norm=True)
    step_kw = dict(k_aug=2, dropnode_rate=0.0, n_train=NT, lam=1.0,
                   warmup=10.0, tem=0.1, conf=2 / 3, loss_kind="l2",
                   clip_norm=0.1)
    params, state = jmlp.init_mlp(jax.random.PRNGKey(0),
                                  jmlp.MLPConfig(**mlp_kw))
    opt = jstep.make_optimizer(0.01, 1e-3)
    jfn = jstep.build_train_step(
        jstep.StepConfig(mlp=jmlp.MLPConfig(**mlp_kw), **step_kw), opt)
    mesh_j = jax_make_mesh(n_data=4, n_model=2)
    p, s, o, f, tc, tv = jdp.shard_train_inputs(
        mesh_j, params=params, state=state, opt_state=opt.init(params),
        features=jnp.asarray(graph["feats"]),
        tk_cols=jnp.asarray(graph["cols"]), tk_vals=jnp.asarray(graph["vals"]),
        tensor_parallel=True)
    model = mlp_from_jax(jax.tree.map(np.asarray, params),
                         jax.tree.map(np.asarray, state),
                         MLPConfig(**mlp_kw), "cpu")
    mesh = make_mesh(4, n_model=2, device="cpu")
    scfg = tstep.StepConfig(mlp=MLPConfig(**mlp_kw), **step_kw)
    _, run, _ = _dense_step(graph, model, scfg, mesh)
    gen = torch.Generator().manual_seed(0)
    for nb, b in enumerate(_batches(graph, 2, seed=1)):
        p, s, o, jm = jfn(p, s, o, f, tc, tv, jdp.shard_batch(
            mesh_j, _jax_batch(b)), jax.random.PRNGKey(7), jnp.float32(nb))
        tm = run(b, gen, nb)
        for k in jm:
            assert rel(tm[k], jm[k]) <= TOL, (nb, k)
    _check_trees(mlp_to_jax(model), (p, s))


# -------------------------------------------------------- the MAG engine


@pytest.mark.parametrize("nlayers", [2, 3])
@pytest.mark.parametrize("shape", MESHES)
def test_tp_mag_step_equals_one_device_step(graph, shape, nlayers):
    cfg, mcfg = _mag_cfgs(nlayers)
    mesh = make_mesh(shape[0], n_model=shape[1], device="cpu")
    one = init_mag_mlp(mcfg, 0, "cpu")
    split = copy.deepcopy(one)
    opt1, run1, _ = _mag_step(graph, one, cfg, None)
    opt2, run2, _ = _mag_step(graph, split, cfg, mesh)
    assert split.table_columns[0].shape == (VOCAB, H // shape[1])
    _same_steps(run1, run2, _batches(graph, 3))
    _check_states(split, opt2, one, opt1)


def test_tp_mag_one_layer_splits_the_classes(graph):
    """With one layer the table maps to the classes: they split over
    'model' (3 over (2 x 3)), the logits join before the loss; 3 classes
    do not split over 2 model shards."""
    cfg, mcfg = _mag_cfgs(1)
    one = init_mag_mlp(mcfg, 0, "cpu")
    split = copy.deepcopy(one)
    mesh = make_mesh(2, n_model=3, device="cpu")
    opt1, run1, _ = _mag_step(graph, one, cfg, None)
    opt2, run2, _ = _mag_step(graph, split, cfg, mesh)
    assert split.table_columns[0].shape == (VOCAB, 1)
    _same_steps(run1, run2, _batches(graph, 3))
    _check_states(split, opt2, one, opt1)
    with pytest.raises(ValueError, match="width 3 does not divide"):
        init_mag_mlp(mcfg, 0, "cpu").shard_columns(
            make_mesh(2, n_model=2, device="cpu"))


def test_tp_mag_step_matches_grandtpu_gspmd(graph):
    """test_dist.py::test_gspmd_sharded_sparse_step's ("tp", (4, 2)) case
    on the port, 2 steps."""
    _check_gspmd_mag(graph, "tp", seed=2)


def _check_gspmd_mag(graph, emb_mode, seed):
    jm_cfg = jmlp.MLPConfig(num_features=VOCAB, num_classes=C, hidden=H,
                            nlayers=2, use_bn=True, node_norm=True)
    params, state = jmag.init_mag_mlp(jax.random.PRNGKey(0), jm_cfg)
    opt = jstep.make_optimizer(0.01, 1e-3)
    cfg, mcfg = _mag_cfgs(2, drop=False)
    jtrain, _ = jts._build_sparse_steps(
        jm_cfg, JaxConfig(**{k: getattr(cfg, k) for k in (
            "dataset", "batch_size", "unlabel_batch_size", "sample",
            "dropnode_rate", "input_droprate", "hidden_droprate", "lam",
            "warmup", "tem", "loss", "clip_norm", "hidden", "nlayers",
            "use_bn", "node_norm")}), opt, C)
    tabs = [graph[k] for k in ("attr_cols", "attr_vals", "cols", "vals")]
    mesh_j = jax_make_mesh(n_data=4, n_model=2)
    p, s, o, *jtabs = jdp.shard_sparse_train_inputs(
        mesh_j, params=params, state=state, opt_state=opt.init(params),
        attr_cols=jnp.asarray(tabs[0]), attr_vals=jnp.asarray(tabs[1]),
        tk_cols=jnp.asarray(tabs[2]), tk_vals=jnp.asarray(tabs[3]),
        emb_mode=emb_mode)
    model = mag_from_jax(jax.tree.map(np.asarray, params),
                         jax.tree.map(np.asarray, state), mcfg, "cpu")
    mesh = make_mesh(4, n_model=2, device="cpu")
    _, run, _ = _mag_step(graph, model, cfg, mesh, emb_mode)
    gen = torch.Generator().manual_seed(0)
    for nb, b in enumerate(_batches(graph, 2, seed=seed)):
        p, s, o, jloss = jtrain(p, s, o, *jtabs, jdp.shard_batch(
            mesh_j, _jax_batch(b)), jax.random.PRNGKey(7), jnp.float32(nb))
        assert rel(run(b, gen, nb)["loss"], jloss) <= TOL, nb
    _check_trees(mag_to_jax(model), (p, s))


@pytest.mark.parametrize("shape", [(2, 2), (4, 2), (1, 3)])
def test_vocab_table_on_a_2d_mesh_equals_the_1d_vocab_step(graph, shape):
    """emb_mode 'vocab' on a (data, model) mesh: the table's rows split over
    'data' (one block a data row, padded to a multiple of the rows),
    replicated over 'model'; every drop rate on, 3 steps, equal to the
    1-D vocab mesh of the same data rows and to one device."""
    nd, nm = shape
    cfg, mcfg = _mag_cfgs(2)
    one = init_mag_mlp(mcfg, 0, "cpu")
    flat, grid = copy.deepcopy(one), copy.deepcopy(one)
    opt1, run1, _ = _mag_step(graph, one, cfg, None)
    opt2, run2, _ = _mag_step(graph, flat, cfg, make_mesh(nd, device="cpu"),
                              "vocab")
    opt3, run3, _ = _mag_step(graph, grid, cfg,
                              make_mesh(nd, n_model=nm, device="cpu"),
                              "vocab")
    per = -(-VOCAB // nd)
    assert [tuple(t.shape) for t in grid.table_shards] == [(per, H)] * nd
    batches = _batches(graph, 3)
    _same_steps(run1, run3, batches)
    gen = torch.Generator().manual_seed(5)
    for nb, b in enumerate(batches):
        run2(b, gen, nb)
    got, flat_state = joined_state(grid, opt3), joined_state(flat, opt2)
    want = joined_state(one, opt1)
    assert got.keys() == want.keys() == flat_state.keys()
    for name, w in want.items():
        for i, (g, f) in enumerate(zip(got[name], flat_state[name])):
            if name == "table":
                assert not g[VOCAB:].any(), (name, i)
                g, f = g[:VOCAB], f[:VOCAB]
            assert rel(g, w[i]) <= TOL, (name, i)
            assert rel(g, f) <= TOL, (name, i)


def test_vocab_table_on_a_2d_mesh_matches_grandtpu_gspmd(graph):
    """grandtpu's emb_mode 'vocab' (P('data', None), rows padded to the
    data rows) on its (4 x 2) mesh against the port's, 2 steps."""
    _check_gspmd_mag(graph, "vocab", seed=3)


# ---------------------------------------------------------- eval steps


@pytest.mark.parametrize("engine", ["dense", "mag", "mag_vocab"])
def test_tp_eval_step_equals_one_device(graph, engine):
    """After a step (BN running stats moved), each engine's eval on a
    (2 x 2) mesh, rows split over 'data', equals the one-device eval (the
    MAG table split over 'model', or by rows over 'data')."""
    mesh = make_mesh(2, n_model=2, device="cpu")
    if engine == "dense":
        mcfg, scfg = _dense_cfgs(3)
        one = init_mlp(mcfg, 0, "cpu")
        split = copy.deepcopy(one)
        _, run1, ev1 = _dense_step(graph, one, scfg, None)
        _, run2, ev2 = _dense_step(graph, split, scfg, mesh)
    else:
        cfg, mcfg = _mag_cfgs(3)
        one = init_mag_mlp(mcfg, 0, "cpu")
        split = copy.deepcopy(one)
        _, run1, ev1 = _mag_step(graph, one, cfg, None)
        _, run2, ev2 = _mag_step(graph, split, cfg, mesh,
                                 "vocab" if engine == "mag_vocab" else "tp")
    _same_steps(run1, run2, _batches(graph, 1))
    rows = torch.arange(0, N, 3)
    labels = torch.as_tensor(graph["labels"][::3])
    mask = torch.ones(rows.shape[0])
    want = ev1(rows, labels, mask)
    got = ev2(*(split_rows(mesh, t) for t in (rows, labels, mask)))
    for g, w in zip(got, want):
        assert rel(g, w) <= TOL


# ---------------------------------------------------------- checkpoints


@pytest.mark.parametrize("engine", ["dense", "mag"])
def test_tp_checkpoint_loads_in_grandtpu_and_back(tmp_path, graph, engine):
    """A split model's best.npz (``model_trees`` joins the blocks) loads in
    grandtpu's ``load_checkpoint`` as the whole trees, and grandtpu's
    checkpoint builds a split model (``*_from_jax`` with a mesh) that
    joins back to the same arrays."""
    mesh = make_mesh(2, n_model=2, device="cpu")
    if engine == "dense":
        mcfg, scfg = _dense_cfgs(3)
        whole = init_mlp(mcfg, 4, "cpu")
        split = copy.deepcopy(whole)
        _dense_step(graph, split, scfg, mesh)
        jm = jmlp.MLPConfig(F_, C, H, 3, use_bn=True, node_norm=True)
        template = jmlp.init_mlp(jax.random.PRNGKey(0), jm)
        to_jax = mlp_to_jax
    else:
        cfg, mcfg = _mag_cfgs(2)
        whole = init_mag_mlp(mcfg, 4, "cpu")
        split = copy.deepcopy(whole)
        _mag_step(graph, split, cfg, mesh)
        jm = jmlp.MLPConfig(VOCAB, C, H, 2, use_bn=True, node_norm=True)
        template = jmag.init_mag_mlp(jax.random.PRNGKey(0), jm)
        to_jax = mag_to_jax
    path = str(tmp_path / "best.npz")
    assert save_checkpoint(path, params=model_trees(split)[0],
                           state=model_trees(split)[1])
    params, state, _, _ = jckpt.load_checkpoint(
        path, params_template=template[0], state_template=template[1])
    for g, w in zip(jax.tree.leaves((params, state)),
                    jax.tree.leaves(to_jax(whole))):
        np.testing.assert_array_equal(np.asarray(g), w)
    # grandtpu's checkpoint -> a split model
    jpath = str(tmp_path / "grandtpu.npz")
    jckpt.save_checkpoint(jpath, params=template[0], state=template[1])
    loaded, _ = load_model(jpath, mcfg, sparse=engine == "mag",
                           device="cpu")
    jp, js = to_jax(loaded)
    if engine == "dense":
        back = mlp_from_jax(jp, js, mcfg, "cpu", mesh=mesh,
                            tensor_parallel=True)
        assert back.model_mesh is mesh and back.sharded_parameters()
    else:
        back = mag_from_jax(jp, js, mcfg, "cpu", mesh=mesh, emb_mode="tp")
        assert back.model_mesh is mesh and len(back.table_columns) == 2
    for g, w in zip(jax.tree.leaves(to_jax(back)),
                    jax.tree.leaves(template)):
        np.testing.assert_array_equal(g, np.asarray(w))


# ------------------------------------------------------------ refusals


def test_a_width_that_does_not_divide_raises():
    mesh = make_mesh(2, n_model=3, device="cpu")
    with pytest.raises(ValueError, match="hidden width 16 does not divide"):
        init_mlp(_dense_cfgs(2)[0], 0, "cpu").shard_hidden(mesh)
    with pytest.raises(ValueError, match="width 16 does not divide"):
        init_mag_mlp(_mag_cfgs(2)[1], 0, "cpu").shard_columns(mesh)
    with pytest.raises(ValueError, match="rows of 3"):
        Mesh((torch.device("cpu"),) * 4, n_model=3)


def test_trainers_d1_and_pushes_refuse_a_model_axis(graph):
    """The trainers refuse a mesh with a 'model' axis, as grandtpu's build
    none (they take no mesh); D1 and the push run on one, along either
    axis, equal to the 1-D mesh of the axis's size.
    (multihost_native_gfpush runs over the process group and takes no
    mesh.)"""
    mesh = make_mesh(2, n_model=2, device="cpu")
    item = r"\(num_devices x 1\) mesh, grandtpu/train/trainer.py:129"
    cfg = GrandConfig(dataset="synth:240:3:16", num_devices=4,
                      push_backend="numpy")
    with pytest.raises(NotImplementedError, match=item):
        ttrainer.train(cfg, device="cpu", mesh=mesh)
    with pytest.raises(NotImplementedError, match=item):
        ttsparse.train_sparse(cfg.replace(dataset="synth:240:3:30:sparse"),
                              device="cpu", mesh=mesh)
    adj, one = graph["adj"], make_mesh(2, device="cpu")
    want = dist_exact_propagate(one, adj, graph["feats"], halo_threshold=1.0)
    push = sharded_gfpush(one, adj.indptr, adj.indices, np.arange(8),
                          np.ones(3, np.float32), 1e-4, 4)
    for axis in ("data", "model"):
        assert torch.equal(dist_exact_propagate(
            mesh, adj, graph["feats"], axis=axis, halo_threshold=1.0), want)
        got = sharded_gfpush(mesh, adj.indptr, adj.indices, np.arange(8),
                             np.ones(3, np.float32), 1e-4, 4, axis=axis)
        assert all(np.array_equal(g, w) for g, w in zip(got, push))


def test_one_layer_split_equals_the_replicated_step(graph):
    """tensor_parallel with one layer splits nothing: the step on a
    (2 x 2) mesh equals the replicated one there and the one-device one."""
    mcfg, scfg = _dense_cfgs(1)
    base = init_mlp(mcfg, 0, "cpu")
    for tp in (True, False):
        one, model = copy.deepcopy(base), copy.deepcopy(base)
        opt1, run1, _ = _dense_step(graph, one, scfg, None)
        opt, run, _ = _dense_step(graph, model, scfg,
                                  make_mesh(2, n_model=2, device="cpu"), tp)
        assert not model.sharded_parameters()
        _same_steps(run1, run, _batches(graph, 2))
        _check_states(model, opt, one, opt1)


def test_tp_table_on_one_model_shard_equals_the_replicated_step(graph):
    """emb_mode 'tp' on a 1-D mesh: one column block, the whole table; the
    step equals the replicated table's."""
    cfg, mcfg = _mag_cfgs(2)
    base = init_mag_mlp(mcfg, 0, "cpu")
    rep, tp = copy.deepcopy(base), copy.deepcopy(base)
    opt1, run1, _ = _mag_step(graph, rep, cfg, make_mesh(2, device="cpu"),
                              "replicate")
    opt2, run2, _ = _mag_step(graph, tp, cfg, make_mesh(2, device="cpu"))
    assert tp.table_columns[0].shape == (VOCAB, H)
    _same_steps(run1, run2, _batches(graph, 2))
    _check_states(tp, opt2, rep, opt1)

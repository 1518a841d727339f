"""The port's data-parallel training (D2) on CPU meshes
(``make_mesh(S, device="cpu")``, the kernels' plain versions).

- The S-shard step against the port's one-device step from the same state
  and generator seed, every drop rate on, for 3 steps: metrics, grads,
  parameters, BN buffers and Adam moments; dense and MAG (vocabulary 30,
  which 8 does not divide, as in grandtpu's test).
- The 4-shard step against grandtpu's GSPMD step on ``make_mesh(n_data=4,
  n_model=1)`` with every drop rate 0, the weights carried across by
  ``convert``; the MAG table's real rows compared, its padded rows zero in
  both.
- The mesh collectives and their adjoints; the K3 window's plain version
  summed over the windows against ``embed_prop_plain``; both trainers
  with ``num_devices=8``; an uneven batch; mesh checkpoints across the
  two packages.

Tolerance: max |a - b| / max |b| <= 1e-5 (f32 sums in another order).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from grandtpu.config import GrandConfig as JaxConfig
from grandtpu.data import synthetic_graph
from grandtpu.dist import make_mesh as jax_make_mesh
from grandtpu.dist import data_parallel as jdp
from grandtpu.nn import mag_mlp as jmag
from grandtpu.nn import mlp as jmlp
from grandtpu.ppr import gfpush as jax_gfpush
from grandtpu.train import checkpoint as jckpt
from grandtpu.train import step as jstep
from grandtpu.train import trainer_sparse as jts

import grandtpu_torch.dist as tdist
from grandtpu_torch.config import GrandConfig
from grandtpu_torch.convert import (mag_from_jax, mag_to_jax, mlp_from_jax,
                                    mlp_to_jax)
from grandtpu_torch.dist import (joined_state, make_mesh, shard_batch,
                                 shard_sparse_train_inputs,
                                 shard_train_inputs)
from grandtpu_torch.dist.data_parallel import split_rows
from grandtpu_torch.infer import exact_propagate
from grandtpu_torch.nn.mag_mlp import MagMLP, init_mag_mlp
from grandtpu_torch.nn.mlp import MLPConfig, init_mlp
from grandtpu_torch.nn.sparse_input import (PaddedFeatures, embed_prop,
                                            embed_prop_plain,
                                            embed_prop_window)
from grandtpu_torch.train import step as tstep
from grandtpu_torch.train import trainer as ttrainer
from grandtpu_torch.train import trainer_sparse as ttsparse
from grandtpu_torch.train.checkpoint import load_model

# one intra-op thread a test process (see test_torch_dist.py)
torch.set_num_threads(1)

TOL = 1e-5
N, C, F_, VOCAB, NT, NU = 200, 3, 24, 30, 32, 32


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
    return {"feats": feats, "labels": labels.argmax(-1).astype(np.int64),
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


def _mag_cfg(cls, drop: bool):
    rate = 0.3 if drop else 0.0
    return cls(dataset="x", batch_size=NT, unlabel_batch_size=NU, sample=2,
               dropnode_rate=0.5 if drop else 0.0, input_droprate=rate,
               hidden_droprate=rate, lam=1.0, warmup=10.0, tem=0.1,
               loss="l2", clip_norm=0.1, hidden=16, nlayers=2, use_bn=True,
               node_norm=True, lr=0.01, weight_decay=1e-3)


def _mag_mlp_cfg(cls=MLPConfig, drop=False):
    rate = 0.3 if drop else 0.0
    return cls(num_features=VOCAB, num_classes=C, hidden=16, nlayers=2,
               use_bn=True, node_norm=True, input_droprate=rate,
               hidden_droprate=rate)


def _dense_pair(graph, mesh):
    mcfg = MLPConfig(F_, C, 16, 3, use_bn=True, node_norm=True,
                     input_droprate=0.3, hidden_droprate=0.3)
    scfg = tstep.StepConfig(mlp=mcfg, k_aug=2, dropnode_rate=0.5,
                            n_train=NT, lam=1.0, warmup=10.0, tem=0.1,
                            conf=2 / 3, loss_kind="l2", clip_norm=0.1)
    one = init_mlp(mcfg, 0, "cpu")
    sharded = copy.deepcopy(one)
    opt1 = tstep.make_optimizer(one, 0.01, 1e-3)
    opt2 = tstep.make_optimizer(sharded, 0.01, 1e-3)
    ops = [torch.as_tensor(graph[k]) for k in ("feats", "cols", "vals")]
    ops_s = shard_train_inputs(mesh, model=sharded, features=ops[0],
                               tk_cols=ops[1], tk_vals=ops[2])
    step1 = tstep.build_train_step(scfg, one, opt1)
    step2 = tstep.build_train_step(scfg, sharded, opt2, mesh=mesh)
    return ((one, opt1, lambda b, g, nb: step1(*ops, b, g, nb)),
            (sharded, opt2, lambda b, g, nb: step2(*ops_s, b, g, nb)))


def _mag_pair(graph, mesh, emb_mode="vocab"):
    cfg = _mag_cfg(GrandConfig, drop=True)
    one = init_mag_mlp(_mag_mlp_cfg(drop=True), 0, "cpu")
    sharded = copy.deepcopy(one)
    ops = [torch.as_tensor(graph[k])
           for k in ("attr_cols", "attr_vals", "cols", "vals")]
    ops_s = shard_sparse_train_inputs(
        mesh, model=sharded, attr_cols=ops[0], attr_vals=ops[1],
        tk_cols=ops[2], tk_vals=ops[3], emb_mode=emb_mode)
    opt1 = tstep.make_optimizer(one, 0.01, 1e-3)
    opt2 = tstep.make_optimizer(sharded, 0.01, 1e-3)
    step1, _ = ttsparse.build_sparse_steps(cfg, one, opt1, C)
    step2, _ = ttsparse.build_sparse_steps(cfg, sharded, opt2, C, mesh=mesh)
    return ((one, opt1, lambda b, g, nb: step1(*ops, b, g, nb)),
            (sharded, opt2, lambda b, g, nb: step2(*ops_s, b, g, nb)))


@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("engine", ["dense", "mag", "mag_replicate"])
def test_mesh_step_equals_one_device_step(graph, engine, shards):
    """Every drop rate on: the masks are drawn at the batch's shapes from
    one generator, so the S-shard step equals the one-device step (the MAG
    table vocab-sharded, or replicated)."""
    mesh = make_mesh(shards, device="cpu")
    if engine == "dense":
        pair = _dense_pair(graph, mesh)
    else:
        pair = _mag_pair(graph, mesh, "vocab" if engine == "mag"
                         else "replicate")
    (m1, o1, step1), (m2, o2, step2) = pair
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    for nb, b in enumerate(_batches(graph, 3)):
        r1 = step1(_torch(b), g1, nb)
        r2 = step2(shard_batch(mesh, _torch(b)), g2, nb)
        assert r1.keys() == r2.keys()
        for k in r1:
            assert rel(r2[k], r1[k]) <= TOL, (nb, k)
    want, got = joined_state(m1, o1), joined_state(m2, o2)
    assert want.keys() == got.keys()
    for name, w in want.items():
        g = got[name]
        for i, what in enumerate(("value", "grad", "exp_avg",
                                  "exp_avg_sq")[:len(w)]):
            gi = g[i][:VOCAB] if name == "table" else g[i]
            assert rel(gi, w[i]) <= TOL, (name, what)
            if name == "table":    # the padding rows never move
                assert not g[i][VOCAB:].any(), (name, what)


def _jax_dense(graph, mesh_j):
    mlp_kw = dict(num_features=F_, num_classes=C, hidden=16, nlayers=2,
                  use_bn=True, node_norm=True)
    step_kw = dict(k_aug=2, dropnode_rate=0.0, n_train=NT, lam=1.0,
                   warmup=10.0, tem=0.1, conf=2 / 3, loss_kind="l2",
                   clip_norm=0.1)
    params, state = jmlp.init_mlp(jax.random.PRNGKey(0),
                                  jmlp.MLPConfig(**mlp_kw))
    opt = jstep.make_optimizer(0.01, 1e-3)
    jfn = jstep.build_train_step(
        jstep.StepConfig(mlp=jmlp.MLPConfig(**mlp_kw), **step_kw), opt)
    model = mlp_from_jax(jax.tree.map(np.asarray, params),
                         jax.tree.map(np.asarray, state),
                         MLPConfig(**mlp_kw), "cpu")
    placed = jdp.shard_train_inputs(
        mesh_j, params=params, state=state, opt_state=opt.init(params),
        features=jnp.asarray(graph["feats"]),
        tk_cols=jnp.asarray(graph["cols"]), tk_vals=jnp.asarray(graph["vals"]))
    scfg = tstep.StepConfig(mlp=MLPConfig(**mlp_kw), **step_kw)
    return placed, jfn, model, scfg


def test_mesh_step_matches_grandtpu_gspmd_dense(graph):
    mesh_j = jax_make_mesh(n_data=4, n_model=1)
    mesh = make_mesh(4, device="cpu")
    (p, s, o, f, tc, tv), jfn, model, scfg = _jax_dense(graph, mesh_j)
    opt = tstep.make_optimizer(model, 0.01, 1e-3)
    step = tstep.build_train_step(scfg, model, opt, mesh=mesh)
    ops = shard_train_inputs(mesh, model=model,
                             features=torch.as_tensor(graph["feats"]),
                             tk_cols=torch.as_tensor(graph["cols"]),
                             tk_vals=torch.as_tensor(graph["vals"]))
    gen = torch.Generator().manual_seed(0)
    for nb, b in enumerate(_batches(graph, 2, seed=1)):
        jb = jdp.shard_batch(mesh_j, {k: jnp.asarray(v.astype(np.int32)
                                                      if v.dtype == np.int64
                                                      else v)
                                      for k, v in b.items()})
        p, s, o, jm = jfn(p, s, o, f, tc, tv, jb, jax.random.PRNGKey(7),
                          jnp.float32(nb))
        tm = step(*ops, shard_batch(mesh, _torch(b)), gen, nb)
        for k in jm:
            assert rel(tm[k], jm[k]) <= TOL, (nb, k)
    got_p, got_s = mlp_to_jax(model)
    for g, w in zip(jax.tree.leaves((got_p, got_s)),
                    jax.tree.leaves((jax.tree.map(np.asarray, p),
                                     jax.tree.map(np.asarray, s)))):
        assert rel(g, w) <= TOL


def test_mesh_step_matches_grandtpu_gspmd_mag(graph):
    mesh_j = jax_make_mesh(n_data=4, n_model=1)
    mesh = make_mesh(4, device="cpu")
    jm_cfg = _mag_mlp_cfg(jmlp.MLPConfig)
    params, state = jmag.init_mag_mlp(jax.random.PRNGKey(0), jm_cfg)
    opt = jstep.make_optimizer(0.01, 1e-3)
    jtrain, _ = jts._build_sparse_steps(jm_cfg, _mag_cfg(JaxConfig, False),
                                        opt, C)
    tabs = [graph[k] for k in ("attr_cols", "attr_vals", "cols", "vals")]
    p, s, o, *jtabs = jdp.shard_sparse_train_inputs(
        mesh_j, params=params, state=state, opt_state=opt.init(params),
        attr_cols=jnp.asarray(tabs[0]), attr_vals=jnp.asarray(tabs[1]),
        tk_cols=jnp.asarray(tabs[2]), tk_vals=jnp.asarray(tabs[3]),
        emb_mode="vocab")
    model = mag_from_jax(jax.tree.map(np.asarray, params),
                         jax.tree.map(np.asarray, state), _mag_mlp_cfg(),
                         "cpu")
    ops = shard_sparse_train_inputs(
        mesh, model=model, **dict(zip(
            ("attr_cols", "attr_vals", "tk_cols", "tk_vals"),
            (torch.as_tensor(t) for t in tabs))))
    topt = tstep.make_optimizer(model, 0.01, 1e-3)
    ttrain, _ = ttsparse.build_sparse_steps(_mag_cfg(GrandConfig, False),
                                            model, topt, C, mesh=mesh)
    gen = torch.Generator().manual_seed(0)
    for nb, b in enumerate(_batches(graph, 2, seed=2)):
        jb = jdp.shard_batch(mesh_j, {k: jnp.asarray(v.astype(np.int32)
                                                      if v.dtype == np.int64
                                                      else v)
                                      for k, v in b.items()})
        p, s, o, jloss = jtrain(p, s, o, *jtabs, jb, jax.random.PRNGKey(7),
                                jnp.float32(nb))
        tm = ttrain(*ops, shard_batch(mesh, _torch(b)), gen, nb)
        assert rel(tm["loss"], jloss) <= TOL, nb
    got_p, got_s = mag_to_jax(model)
    want_table = np.asarray(p["emb"]["table"])
    assert got_p["emb"]["table"].shape == want_table.shape == (32, 16)
    assert rel(got_p["emb"]["table"][:VOCAB], want_table[:VOCAB]) <= TOL
    assert not got_p["emb"]["table"][VOCAB:].any()
    assert not want_table[VOCAB:].any()
    for part, got, want in (("fcs", got_p, p), ("bns", got_p, p),
                            ("bns", got_s, s)):
        for g, w in zip(jax.tree.leaves(got[part]),
                        jax.tree.leaves(jax.tree.map(np.asarray, want[part]))):
            assert rel(g, w) <= TOL, part


@pytest.mark.parametrize("shards", [2, 3])
def test_mesh_collectives_and_their_adjoints(shards):
    mesh = make_mesh(shards, device="cpu")
    rs = np.random.RandomState(shards)
    xs = [torch.tensor(rs.randn(2 * shards, 3), requires_grad=True)
          for _ in range(shards)]
    total = sum(x.detach() for x in xs)
    for got in mesh.all_reduce_sum(xs):
        assert torch.allclose(got, total)
    parts = mesh.reduce_scatter_rows(xs)
    assert torch.allclose(torch.cat(parts), total)
    gathered = mesh.all_gather(parts, dim=1)
    assert gathered[0].shape == (2, 3 * shards)
    # reduce-scatter's adjoint is the all-gather: every shard's input gets
    # the gradient of the whole sum
    weights = [torch.tensor(rs.randn(2, 3)) for _ in range(shards)]
    loss = sum((p * w).sum() for p, w in zip(parts, weights))
    grads = torch.autograd.grad(loss, xs)
    for g in grads:
        assert torch.allclose(g, torch.cat(weights))
    with pytest.raises(ValueError, match="split"):
        mesh.scatter_rows(torch.zeros(2 * shards + 1, 3))
    # on a (shards x 2) mesh each model column sums on its own over 'data'
    grid = make_mesh(shards, n_model=2, device="cpu")
    cols = [torch.tensor(rs.randn(2, 3)) for _ in range(2 * shards)]
    sums = grid.all_reduce_sum(cols)
    for i, got in enumerate(sums):
        assert torch.allclose(got, sum(cols[i % 2::2]))


@pytest.mark.parametrize("form", ["train", "train_drop", "node"])
def test_embed_prop_window_plain_sums_to_full(graph, form):
    """K3's window form: summed over the vocab windows, the forward equals
    the full one (the denominators are the whole rows'); the windows'
    gradients concatenate to the full gradient."""
    rs = np.random.RandomState(1)
    shards, per = 4, 8                           # 30 words, padded to 32
    table = torch.tensor(rs.randn(per * shards, 5).astype(np.float32))
    table[VOCAB:] = 0.0
    ac, av = (torch.as_tensor(graph[k]) for k in ("attr_cols", "attr_vals"))
    kw = {}
    if form == "node":
        ac, av = ac[:40], av[:40]
    else:
        rows = rs.randint(0, N, 12)
        kw = {"tk_cols": torch.as_tensor(graph["cols"][rows]),
              "tk_vals": torch.as_tensor(graph["vals"][rows]),
              "keep": torch.as_tensor(rs.rand(3, 12, 8) < 0.6)}
        if form == "train_drop":
            kw["drop"] = torch.as_tensor(rs.rand(3, 12, 8, ac.shape[1], 5)
                                         < 0.7)
            kw["droprate"] = 0.3
    full_t = table.clone().requires_grad_(True)
    full = embed_prop_plain(full_t, ac, av, **kw)
    gout = torch.tensor(rs.randn(*full.shape).astype(np.float32))
    d_full, = torch.autograd.grad(full, full_t, gout)
    outs, grads = [], []
    for s in range(shards):
        t = table[s * per:(s + 1) * per].clone().requires_grad_(True)
        out = embed_prop_window(t, s * per, (s + 1) * per, ac, av, **kw)
        outs.append(out.detach())
        grads.append(torch.autograd.grad(out, t, gout)[0])
    assert rel(sum(outs), full.detach()) <= 1e-6
    assert rel(torch.cat(grads), d_full) <= 1e-6
    assert not torch.cat(grads)[VOCAB:].any()
    # the whole vocabulary as one window is the full op
    assert torch.equal(embed_prop_window(table, 0, per * shards, ac, av,
                                         **kw),
                       embed_prop(table, ac, av, **kw))
    with pytest.raises(ValueError, match="window"):
        embed_prop_window(table, 0, per, ac, av, **kw)


def _spy(monkeypatch):
    calls = []
    real = tdist.dist_exact_propagate

    def spy(mesh, adj, feats, **kw):
        out = real(mesh, adj, feats, **kw)
        calls.append({"out": out, "adj": adj, "feats": feats.clone()
                      if torch.is_tensor(feats) else feats, "kw": kw,
                      "mesh": mesh})
        return out

    monkeypatch.setattr(tdist, "dist_exact_propagate", spy)
    return calls


def _check_sharded_predict(calls):
    assert len(calls) == 1, "the trainer's predict must use the mesh"
    c = calls[0]
    assert c["mesh"].size == 8
    want = exact_propagate(c["adj"], c["feats"], device="cpu",
                           **{k: v for k, v in c["kw"].items()
                              if k in ("mode", "order", "alpha")})
    assert rel(c["out"], want) <= TOL


def test_trainer_num_devices(monkeypatch):
    """tests/test_dist.py::test_trainer_num_devices on the port: 8 shards
    of the CPU, learns, predicts through dist_exact_propagate."""
    calls = _spy(monkeypatch)
    cfg = GrandConfig(dataset="synth:240:3:16", epochs=20, patience=15,
                      order=4, alpha=0.2, rmax=1e-6, top_k=16, hidden=32,
                      batch_size=32, unlabel_batch_size=32, warmup=20.0,
                      eval_batch=5, push_backend="numpy", num_devices=8)
    r = ttrainer.train(cfg, device="cpu")
    assert r.test_acc > 0.7
    _check_sharded_predict(calls)


def test_sparse_trainer_num_devices_sharded_predict(monkeypatch):
    """::test_sparse_trainer_num_devices_sharded_predict on the port: the
    vocab-sharded MAG engine on 8 shards, the embedding-space predict
    through dist_exact_propagate."""
    calls = _spy(monkeypatch)
    cfg = GrandConfig(dataset="synth:240:3:64:sparse", sparse_features=True,
                      epochs=10, patience=10, order=3, alpha=0.2, rmax=1e-6,
                      top_k=16, hidden=32, nlayers=2, batch_size=32,
                      unlabel_batch_size=32, warmup=20.0, eval_batch=5,
                      push_backend="numpy", num_devices=8)
    r = ttsparse.train_sparse(cfg, device="cpu")
    assert isinstance(r.model, MagMLP) and r.model.vocab_mesh.size == 8
    assert not r.model.gathered_table()[64:].any()
    _check_sharded_predict(calls)
    assert r.test_acc > 0.5


def test_uneven_batch_raises_before_any_step(monkeypatch):
    def no_step(*a, **k):
        raise AssertionError("a step ran")

    monkeypatch.setattr(ttrainer, "run_training_loop", no_step)
    monkeypatch.setattr(ttsparse, "run_training_loop", no_step)
    for spec, shards in (("synth:240:3:16", 4), ("synth:240:3:64:sparse", 3)):
        cfg = GrandConfig(dataset=spec, batch_size=30,
                          unlabel_batch_size=32, num_devices=shards,
                          push_backend="numpy")
        with pytest.raises(ValueError, match="unlabel_batch_size"):
            ttrainer.train(cfg, device="cpu")
    mesh = make_mesh(4, device="cpu")
    with pytest.raises(ValueError, match="batch_size 6"):
        shard_batch(mesh, {"rows": torch.arange(10),
                           "labels": torch.zeros(6, dtype=torch.long),
                           "label_mask": torch.ones(6)})
    with pytest.raises(ValueError, match="shards"):
        ttrainer.train(GrandConfig(dataset="synth:240:3:16", num_devices=2),
                       device="cpu", mesh=make_mesh(4, device="cpu"))


def test_placements_and_d1_run_on_a_2d_mesh():
    """The placements on a 2-D mesh work (the split MLP, the table's
    columns over 'model' or its rows over 'data'), and so does D1 along
    'data', equal to the 1-D mesh's run."""
    mesh = make_mesh(2, n_model=2, device="cpu")
    model = init_mag_mlp(_mag_mlp_cfg(), 0, "cpu")
    z = torch.zeros(4, 2, dtype=torch.int32)
    placed = shard_sparse_train_inputs(mesh, model=model, attr_cols=z,
                                       attr_vals=z.float(), tk_cols=z,
                                       tk_vals=z.float(), emb_mode="tp")
    assert len(placed[0]) == 4 and len(model.table_columns) == 2
    assert model.table_columns[0].shape == (VOCAB, 8)
    dense = init_mlp(MLPConfig(F_, C, 16, 2), 0, "cpu")
    shard_train_inputs(mesh, model=dense, features=z, tk_cols=z, tk_vals=z,
                       tensor_parallel=True)
    assert [tuple(p.shape) for p in dense.sharded_parameters()] == \
        [(8, F_), (8, F_), (8,), (8,), (C, 8), (C, 8)]
    vocab = init_mag_mlp(_mag_mlp_cfg(), 0, "cpu")
    shard_sparse_train_inputs(mesh, model=vocab, attr_cols=z,
                              attr_vals=z.float(), tk_cols=z,
                              tk_vals=z.float(), emb_mode="vocab")
    assert [tuple(t.shape) for t in vocab.table_shards] == [(VOCAB // 2,
                                                             16)] * 2
    assert vocab.vocab_window(1) == (VOCAB // 2, VOCAB)
    x = np.arange(8, dtype=np.float32).reshape(4, 2)
    assert torch.equal(
        tdist.dist_exact_propagate(mesh, sp.eye(4, format="csr"), x),
        tdist.dist_exact_propagate(make_mesh(2, device="cpu"),
                                   sp.eye(4, format="csr"), x))


def test_split_rows_covers_the_rows_once():
    mesh = make_mesh(4, device="cpu")
    parts = split_rows(mesh, torch.arange(10))
    assert [p.numel() for p in parts] == [3, 3, 2, 2]
    assert torch.equal(torch.cat(parts), torch.arange(10))


@pytest.mark.parametrize("weight_decay", [0.0, 1e-3])
def test_grandtpu_mesh_checkpoint_loads_in_the_port(tmp_path, graph,
                                                    weight_decay):
    """A grandtpu MAG checkpoint of a vocab-sharded run (the padded table,
    ``__row_padded__`` set) loads in the port as the unpadded table; the
    port's meta of such a run is grandtpu's."""
    mesh_j = jax_make_mesh(n_data=4, n_model=1)
    jm_cfg = _mag_mlp_cfg(jmlp.MLPConfig)
    params, state = jmag.init_mag_mlp(jax.random.PRNGKey(3), jm_cfg)
    opt_state = jstep.make_optimizer(0.01, weight_decay).init(params)
    z = jnp.zeros((N, 2), jnp.int32)
    pp, ss, oo, *_ = jdp.shard_sparse_train_inputs(
        mesh_j, params=params, state=state, opt_state=opt_state,
        attr_cols=z, attr_vals=z.astype(jnp.float32), tk_cols=z,
        tk_vals=z.astype(jnp.float32))
    row_padded = jckpt.row_padded_meta({"params": params, "opt": opt_state},
                                       {"params": pp, "opt": oo})
    assert row_padded == ttsparse._vocab_row_padded(VOCAB, 32, 16,
                                                  weight_decay)
    path = str(tmp_path / "best.npz")
    jckpt.save_checkpoint(path, params=pp, state=ss, row_padded=row_padded)
    model, meta = load_model(path, _mag_mlp_cfg(), sparse=True, device="cpu")
    assert meta["__row_padded__"] == row_padded
    np.testing.assert_array_equal(model.table.detach().numpy(),
                                  np.asarray(params["emb"]["table"]))
    mesh = make_mesh(4, device="cpu")
    sharded = mag_from_jax(jax.tree.map(np.asarray, pp),
                           jax.tree.map(np.asarray, ss), _mag_mlp_cfg(),
                           "cpu", mesh=mesh)
    np.testing.assert_array_equal(mag_to_jax(sharded)[0]["emb"]["table"],
                                  np.asarray(pp["emb"]["table"]))


def test_port_mesh_checkpoint_loads_in_grandtpu(tmp_path):
    """The port's MAG run on 4 shards writes best.npz with the padded table
    and grandtpu's ``__row_padded__`` meta; grandtpu restores it into its
    unpadded template."""
    cfg = GrandConfig(dataset="synth:240:3:30:sparse", epochs=2, order=3,
                      top_k=8, hidden=16, batch_size=20,
                      unlabel_batch_size=20, eval_batch=2, patience=50,
                      push_backend="numpy", num_devices=4,
                      ckpt_dir=str(tmp_path))
    r = ttrainer.train(cfg, device="cpu")
    jm_cfg = jmlp.MLPConfig(**dataclasses.asdict(r.model.cfg))
    params_t, state_t = jmag.init_mag_mlp(jax.random.PRNGKey(0), jm_cfg)
    params, state, _, meta = jckpt.load_checkpoint(
        str(tmp_path / "best.npz"), params_template=params_t,
        state_template=state_t)
    assert meta["__row_padded__"] == ttsparse._vocab_row_padded(
        30, 32, 16, cfg.weight_decay)
    table = r.model.gathered_table()
    np.testing.assert_array_equal(np.asarray(params["emb"]["table"]),
                                  table[:30].numpy())
    for g, w in zip(jax.tree.leaves(mag_to_jax(r.model)[0]["fcs"]),
                    jax.tree.leaves(params["fcs"])):
        np.testing.assert_array_equal(g, np.asarray(w))

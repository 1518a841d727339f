"""The port's mesh over processes: 2 real ``torch.distributed`` ranks (gloo,
2 CPU shards each, a 4-shard mesh), as ``tests/test_multiprocess.py`` runs
grandtpu over 2 processes of 2 devices.

This file is also its own worker: ``python tests/test_torch_dist_process.py
PART RANK WORLD PORTS DIR`` joins the process group at ``tcp://localhost``
on the first of ``PORTS`` and runs PART, which asserts, writes what the
test reads to ``DIR`` and prints ``RANK<r> OK``. The workers import no JAX
and nothing of ``grandtpu``: what grandtpu computes, the pytest process
computes and hands them in an npz. Parts, one test each:

- (a) ``push``: ``multihost_native_gfpush`` equal to one process's native
  push (cols and vals);
- (b) ``dense``: the dense step, every drop rate on, against the
  one-process 4-shard mesh's (metrics, gradients, parameters, Adam moments,
  BN state within 1e-5; the replicas bit-identical); with DropNode and
  dropout off also against grandtpu's single-device step from grandtpu's
  initial weights (within 1e-5);
- (c) ``d1``: ``dist_exact_propagate``, the all_gather and the halo
  branches, f32 (within 1e-5 of the one-device ``exact_propagate``) and
  int8 (within 1e-3 of the one-process mesh's int8 run), the scatter
  variant, and the 0.5 default threshold of a process mesh;
- (d) ``mag``: the vocab-sharded MAG step (vocabulary 30, which 4 does not
  divide, every drop rate on, the clip on) against the one-process mesh's;
- (e) ``e2e``: ``train()`` of both engines with ``ckpt_dir``: the same
  history and weights on every rank, one ``best.npz`` written by rank 0,
  loaded by the port on every rank and by grandtpu here, the row-padded
  table sliced back;
- (f) ``longrun``: ``train()``'s long-run options over the processes:
  only rank 0 writes the metrics stream and ``latest.npz``; every rank
  resumes from it to the same weights (a digest taken as the resume loads
  them) and the same history; a SIGTERM on every rank stops both engines
  at the same step, with a fresh save for the replicated dense model and
  none for the vocab-sharded MAG table (grandtpu's rule: its gather is a
  collective that signals do not line up);
- ``collectives``: every cross-process collective's forward and gradient
  against the one-process mesh's on the same inputs;
- ``d1_2d``: D1 (the all_gather, halo and scatter variants) and the
  source-sharded push on 2-D meshes along either axis, the groups along
  the axis spanning the ranks or lying inside them, each rank's result
  equal to the one-process mesh of the same shape;
- ``tp``: tensor parallelism over the ranks, both engines (the dense MLP's
  hidden width, the MAG table's columns split over 'model'; and the MAG
  table's rows split over 'data' on the same 2-D meshes), every drop
  rate on, on a (2 x 2) mesh ('model' inside a rank, 'data' across the
  ranks) and a (1 x 4) mesh ('model' across the ranks), each against the
  one-process mesh of its shape (metrics, and every parameter, gradient,
  Adam moment and BN buffer with the split ones joined); the ranks'
  replicas bit-identical.

Tolerance: max |a - b| / max |b| <= 1e-5 (f32 sums in another order).
"""

import copy
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, REPO)

import torch  # noqa: E402

TOL = 1e-5
INT8_TOL = 1e-3
N, C, F_, VOCAB, NT, NU = 200, 3, 24, 30, 16, 16
WORLD = 2
CPU = torch.device("cpu")


def rel(got, want) -> float:
    got, want = (np.asarray(x.detach().cpu() if torch.is_tensor(x) else x,
                            np.float64) for x in (got, want))
    return float(np.max(np.abs(got - want))
                 / max(np.max(np.abs(want)), 1e-30))


# ---------------------------------------------------------------- spawning


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(part: str, shared, world: int = WORLD, timeout: float = 120,
          ports: int = 1) -> list:
    """Run ``part`` on ``world`` worker processes; each must exit 0 and
    print its OK line. Returns their outputs."""
    ports = ",".join(str(_free_port()) for _ in range(ports))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), part, str(rank),
         str(world), ports, str(shared)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(world)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        assert f"RANK{rank} OK" in out, f"rank {rank}:\n{out}"
    return outs


def write_inputs(path) -> dict:
    """The graph, its top-k table, a bag-of-words over VOCAB words and two
    batches, from seeds (numpy), for the workers."""
    import scipy.sparse as sp

    from grandtpu_torch.data.synthetic import synthetic_graph
    from grandtpu_torch.nn.sparse_input import PaddedFeatures
    from grandtpu_torch.ppr import gfpush

    adj, feats, labels = synthetic_graph(num_nodes=N, num_classes=C,
                                         num_features=F_, seed=9)
    adj = (adj + sp.eye(N, format="csr")).tocsr().astype(np.float32)
    tk = gfpush(adj, np.arange(N), prop_mode="ppr", order=4, alpha=0.2,
                rmax=1e-6, k=8, backend="numpy", device="cpu")
    rs = np.random.RandomState(3)
    bow = sp.random(N, VOCAB, density=0.15, format="csr", random_state=rs,
                    dtype=np.float32)
    bow.data[:] = np.abs(bow.data) + 0.1
    padded = PaddedFeatures.from_csr(bow)
    labels = labels.argmax(-1).astype(np.int64)
    out = {"feats": np.asarray(feats, np.float32), "labels": labels,
           "cols": tk.cols, "vals": tk.vals,
           "attr_cols": padded.attr_cols, "attr_vals": padded.attr_vals,
           "adj_indptr": adj.indptr, "adj_indices": adj.indices,
           "adj_data": adj.data}
    for i in range(2):
        lab = rs.permutation(N)[:NT]
        out[f"rows_{i}"] = np.concatenate([lab, rs.permutation(N)[:NU]])
        out[f"labels_{i}"] = labels[lab]
        out[f"label_mask_{i}"] = (rs.rand(NT) < 0.85).astype(np.float32)
        out[f"unlabel_mask_{i}"] = (rs.rand(NU) < 0.9).astype(np.float32)
    np.savez(os.path.join(path, "inputs.npz"), **out)
    return out


# ------------------------------------------------------------ the workers


def _inputs(shared) -> dict:
    with np.load(os.path.join(shared, "inputs.npz")) as d:
        return {k: d[k] for k in d.files}


def _adj(inp):
    import scipy.sparse as sp

    return sp.csr_matrix((inp["adj_data"], inp["adj_indices"],
                          inp["adj_indptr"]), shape=(N, N))


def _batch(inp, i) -> dict:
    return {k: torch.as_tensor(inp[f"{k}_{i}"])
            for k in ("rows", "labels", "label_mask", "unlabel_mask")}


def _one_process_mesh():
    from grandtpu_torch.dist.mesh import Mesh

    return Mesh((CPU,) * 4)


def _process_mesh(rank: int):
    from grandtpu_torch.dist import make_mesh

    mesh = make_mesh(4, device="cpu")
    assert mesh.multiprocess and mesh.size == 4, mesh
    assert mesh.shards == (2 * rank, 2 * rank + 1), mesh
    return mesh


def same_on_every_rank(tensors) -> bool:
    """Whether every rank holds these tensors bit for bit."""
    from grandtpu_torch.dist.mesh import all_gather_tensor

    flat = torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8)
                      for t in tensors])
    return all(torch.equal(g, flat) for g in all_gather_tensor(flat))


def _compare_states(got: dict, want: dict, vocab: int | None = None):
    assert got.keys() == want.keys(), (sorted(got), sorted(want))
    for name, w in want.items():
        for i, (g_i, w_i) in enumerate(zip(got[name], w)):
            if name == "table":
                assert not g_i[vocab:].any(), f"{name}[{i}]: a padding row"
                g_i, w_i = g_i[:vocab], w_i[:vocab]
            assert rel(g_i, w_i) <= TOL, (name, i, rel(g_i, w_i))


def _flat(state: dict) -> list:
    return [t for name in sorted(state) for t in state[name]]


def part_push(rank, world, shared):
    from grandtpu_torch.dist import multihost_native_gfpush
    from grandtpu_torch.ppr import gfpush

    adj = _adj(_inputs(shared))
    sources = np.arange(N - 3)          # 197: rank 1's share is padded
    kw = dict(prop_mode="ppr", order=3, alpha=0.2, rmax=1e-4, k=4,
              backend="native", device="cpu")
    got = multihost_native_gfpush(adj, sources, **kw)
    want = gfpush(adj, sources, **kw)
    assert np.array_equal(got.cols, want.cols), "cols differ"
    assert np.array_equal(got.vals, want.vals), "vals differ"
    assert np.array_equal(got.sources, want.sources)


def _dense_cfgs(drop: bool):
    from grandtpu_torch.nn.mlp import MLPConfig
    from grandtpu_torch.train.step import StepConfig

    rate = 0.3 if drop else 0.0
    mcfg = MLPConfig(F_, C, 16, 2, use_bn=True, node_norm=True,
                     input_droprate=rate, hidden_droprate=rate)
    return mcfg, StepConfig(mlp=mcfg, k_aug=2,
                            dropnode_rate=0.5 if drop else 0.0, n_train=NT,
                            lam=1.0, warmup=10.0, tem=0.1, conf=2 / 3,
                            loss_kind="l2", clip_norm=0.1)


def part_dense(rank, world, shared):
    from grandtpu_torch.dist import (joined_state, shard_batch,
                                     shard_train_inputs)
    from grandtpu_torch.nn.mlp import init_mlp
    from grandtpu_torch.train.checkpoint import load_model
    from grandtpu_torch.train.step import build_train_step, make_optimizer

    inp = _inputs(shared)
    with np.load(os.path.join(shared, "grandtpu_dense.npz")) as d:
        ref = {k: d[k] for k in d.files}
    meshes = {"proc": _process_mesh(rank), "one": _one_process_mesh()}
    ops = [torch.as_tensor(inp[k]) for k in ("feats", "cols", "vals")]
    for drop in (True, False):
        mcfg, scfg = _dense_cfgs(drop)
        base = (init_mlp(mcfg, 0, "cpu") if drop else load_model(
            os.path.join(shared, "grandtpu_dense_init.npz"), mcfg,
            sparse=False, device="cpu")[0])
        runs = {}
        for name, mesh in meshes.items():
            model = copy.deepcopy(base)
            opt = make_optimizer(model, 0.01, 1e-3)
            placed = shard_train_inputs(mesh, model=model, features=ops[0],
                                        tk_cols=ops[1], tk_vals=ops[2])
            step = build_train_step(scfg, model, opt, mesh=mesh)
            gen = torch.Generator().manual_seed(5)
            metrics = [step(*placed, shard_batch(mesh, _batch(inp, i)), gen,
                            i) for i in range(2)]
            runs[name] = (metrics, joined_state(model, opt))
        (m_p, s_p), (m_o, s_o) = runs["proc"], runs["one"]
        for i in range(2):
            for k in m_o[i]:
                assert rel(m_p[i][k], m_o[i][k]) <= TOL, (drop, i, k)
        _compare_states(s_p, s_o)
        assert same_on_every_rank(_flat(s_p)), "the replicas differ"
        if drop:
            continue
        # grandtpu's single-device step on the same numpy inputs. Parameter
        # values relative to the model's largest: Adam's first update
        # lr g / (|g| + eps) magnifies an f32 difference of a gradient
        # element near 0, and a BN bias starts at 0
        for i in range(2):
            for k in m_p[i]:
                assert rel(m_p[i][k], ref[f"metric/{k}/{i}"]) <= TOL, (i, k)
        scale = max(float(np.abs(v).max()) for k, v in ref.items()
                    if k.startswith("param/"))
        for name, vals in s_p.items():
            keys = ["param", "grad", "mu", "nu"]
            if len(vals) == 1:
                keys = ["buffer"]
            for key, v in zip(keys, vals):
                want = ref.get(f"{key}/{name}")
                if want is None:
                    continue
                err = rel(v, want)
                if key == "param":
                    err *= max(float(np.abs(want).max()), 1e-30) / scale
                assert err <= TOL, (key, name, err)


def part_d1(rank, world, shared):
    from grandtpu_torch.dist import (HaloPropagator, ShardedGraph,
                                     default_halo_threshold,
                                     dist_exact_propagate,
                                     dist_exact_propagator,
                                     estimate_halo_compression,
                                     sharded_propagate)
    from grandtpu_torch.infer import exact_propagate

    inp = _inputs(shared)
    adj, x = _adj(inp), torch.as_tensor(inp["feats"])
    proc, one = _process_mesh(rank), _one_process_mesh()
    kw = dict(mode="ppr", order=3, alpha=0.2)
    ref = exact_propagate(adj, x, device="cpu", **kw)
    assert default_halo_threshold(proc) == 0.5
    assert default_halo_threshold(one) == 0.0
    prop, _ = dist_exact_propagator(proc, adj, F_)
    halo = estimate_halo_compression(adj, 4) < 0.5
    assert isinstance(prop, HaloPropagator) == halo
    results = {}
    for thr in (0.0, float("inf")):
        prop, _ = dist_exact_propagator(proc, adj, F_, halo_threshold=thr)
        assert isinstance(prop, HaloPropagator) == (thr > 0)
        for precision in ("f32", "int8"):
            got = dist_exact_propagate(proc, adj, x, halo_threshold=thr,
                                       precision=precision, **kw)
            want = dist_exact_propagate(one, adj, x, halo_threshold=thr,
                                        precision=precision, **kw)
            assert got.shape == (N, F_)
            if precision == "f32":
                assert rel(got, ref) <= TOL, (thr, rel(got, ref))
            else:
                assert rel(got, want) <= INT8_TOL, (thr, rel(got, want))
            results[f"{thr}/{precision}"] = rel(got, want)
    got = sharded_propagate(proc, ShardedGraph.build(adj, 4), x, **kw)
    assert rel(got, ref) <= TOL
    assert same_on_every_rank([got])
    with open(os.path.join(shared, f"d1_{rank}.json"), "w") as f:
        json.dump(results, f)


# the 2-D meshes of part d1_2d, with the axis D1 and the push run along:
# the (2 x 2) mesh's model columns span the ranks ('model' inside each),
# the (1 x 2) and (1 x 4) meshes' data row spans them, the (2 x 2) mesh's
# rows lie inside the ranks
D1_2D_MESHES = (("2x2", "data"), ("1x2", "model"), ("1x4", "model"),
                ("2x2", "model"))
D1_2D_FORMS = (("block", "f32"), ("block", "int8"), ("halo", "f32"),
               ("halo", "int8"), ("scatter", "f32"))


def part_d1_2d(rank, world, shared):
    """D1 (each variant built on 8-row blocks, so that every shard holds
    rows) and the push on 2-D process meshes along either axis: each
    rank's result equal to the one-process mesh of the same shape and to
    every local group's, f32 within 1e-5 of exact_propagate, the same bits
    on every rank."""
    from grandtpu_torch.dist import (BlockShardedGraph,
                                     BlockShardedPropagator,
                                     HaloPropagator, HaloShardedGraph,
                                     ShardedGraph, ShardedPropagator,
                                     dist_exact_propagate, make_mesh,
                                     sharded_gfpush)
    from grandtpu_torch.dist.mesh import Mesh
    from grandtpu_torch.infer import exact_propagate

    inp = _inputs(shared)
    adj, x = _adj(inp), torch.as_tensor(inp["feats"])
    kw = dict(mode="ppr", order=3, alpha=0.2)
    ref = exact_propagate(adj, x, device="cpu", **kw)
    variants = {
        "block": lambda s: (BlockShardedPropagator,
                            BlockShardedGraph.build(adj, s,
                                                    rows_per_block=8)),
        "halo": lambda s: (HaloPropagator,
                           HaloShardedGraph.build(adj, s, rows_per_block=8)),
        "scatter": lambda s: (ShardedPropagator, ShardedGraph.build(adj, s))}
    coef = np.array([0.2, 0.16, 0.128, 0.1024], np.float32)
    indptr = adj.indptr.astype(np.int32)
    indices = adj.indices.astype(np.int32)
    report = {}
    for shape, axis in D1_2D_MESHES:
        n_data, n_model = map(int, shape.split("x"))
        proc = make_mesh(n_data, n_model=n_model, device="cpu")
        one = Mesh((CPU,) * (n_data * n_model), n_model=n_model)
        assert proc.multiprocess and proc.size == one.size, proc
        shards = proc.shape[axis]
        for variant, precision in D1_2D_FORMS:
            cls, g = variants[variant](shards)
            run = dict(kw) if variant == "scatter" else dict(
                kw, precision=precision)
            outs = cls(proc, g, axis).each(x, **run)
            want = cls(one, g, axis)(x, **run)
            err = rel(outs[0], ref)
            if precision == "f32":
                assert err <= TOL, (shape, axis, variant, err)
            report[f"{shape}/{axis}/{variant}_{precision}"] = {
                "groups": len(outs), "err": err,
                "equal_one_process": all(torch.equal(o, want)
                                         for o in outs),
                "same": same_on_every_rank(outs)}
        got = dist_exact_propagate(proc, adj, x, axis=axis, **kw)
        assert rel(got, ref) <= TOL
        push = sharded_gfpush(proc, indptr, indices, np.arange(N - 3), coef,
                              1e-4, 4, axis=axis, block=16)
        want = sharded_gfpush(one, indptr, indices, np.arange(N - 3), coef,
                              1e-4, 4, axis=axis, block=16)
        flat = [torch.as_tensor(a) for a in push]
        report[f"{shape}/{axis}/push"] = {
            "groups": len(proc.along(axis)), "err": 0.0,
            "equal_one_process": all(np.array_equal(a, b)
                                     for a, b in zip(push, want)),
            "same": same_on_every_rank(flat)}
    with open(os.path.join(shared, f"d1_2d_{rank}.json"), "w") as f:
        json.dump(report, f)


def _mag_cfgs():
    from grandtpu_torch.config import GrandConfig
    from grandtpu_torch.nn.mlp import MLPConfig

    cfg = GrandConfig(dataset="x", batch_size=NT, unlabel_batch_size=NU,
                      sample=2, dropnode_rate=0.5, input_droprate=0.3,
                      hidden_droprate=0.3, lam=1.0, warmup=10.0, tem=0.1,
                      loss="l2", clip_norm=0.1, hidden=16, nlayers=2,
                      use_bn=True, node_norm=True, lr=0.01,
                      weight_decay=1e-3)
    return cfg, MLPConfig(num_features=VOCAB, num_classes=C, hidden=16,
                          nlayers=2, use_bn=True, node_norm=True,
                          input_droprate=0.3, hidden_droprate=0.3)


def part_mag(rank, world, shared):
    from grandtpu_torch.dist import (joined_state, shard_batch,
                                     shard_sparse_train_inputs)
    from grandtpu_torch.nn.mag_mlp import init_mag_mlp
    from grandtpu_torch.train.step import make_optimizer
    from grandtpu_torch.train.trainer_sparse import build_sparse_steps

    inp = _inputs(shared)
    cfg, mcfg = _mag_cfgs()
    base = init_mag_mlp(mcfg, 0, "cpu")
    tabs = [torch.as_tensor(inp[k])
            for k in ("attr_cols", "attr_vals", "cols", "vals")]
    runs = {}
    for name, mesh in (("proc", _process_mesh(rank)),
                       ("one", _one_process_mesh())):
        model = copy.deepcopy(base)
        placed = shard_sparse_train_inputs(
            mesh, model=model, attr_cols=tabs[0], attr_vals=tabs[1],
            tk_cols=tabs[2], tk_vals=tabs[3], emb_mode="vocab")
        assert len(model.table_shards) == len(mesh.shards)
        opt = make_optimizer(model, cfg.lr, cfg.weight_decay)
        step, _ = build_sparse_steps(cfg, model, opt, C, mesh=mesh)
        gen = torch.Generator().manual_seed(5)
        losses = [step(*placed, shard_batch(mesh, _batch(inp, i)), gen, i)
                  ["loss"] for i in range(2)]
        runs[name] = (losses, joined_state(model, opt))
    (l_p, s_p), (l_o, s_o) = runs["proc"], runs["one"]
    for a, b in zip(l_p, l_o):
        assert rel(a, b) <= TOL, (float(a), float(b))
    _compare_states(s_p, s_o, vocab=VOCAB)
    assert same_on_every_rank(_flat(s_p)), "the replicas differ"


def part_e2e(rank, world, shared):
    import torch.distributed as tdist

    from grandtpu_torch.config import GrandConfig
    from grandtpu_torch.convert import mag_to_jax, mlp_to_jax
    from grandtpu_torch.data import load_data
    from grandtpu_torch.nn.mag_mlp import MagMLP
    from grandtpu_torch.train import loop, train
    from grandtpu_torch.train.checkpoint import load_model

    writes = []
    real = loop.save_checkpoint
    loop.save_checkpoint = lambda *a, **k: writes.append(real(*a, **k))
    report = {}
    for engine, spec in (("dense", "synth:240:3:16"),
                         ("sparse", "synth:240:3:30:sparse")):
        ckpt = os.path.join(shared, engine)
        cfg = GrandConfig(dataset=spec, epochs=3, patience=50, order=3,
                          alpha=0.2, rmax=1e-6, top_k=8, hidden=16,
                          batch_size=16, unlabel_batch_size=16,
                          eval_batch=2, push_backend="numpy",
                          num_devices=4, ckpt_dir=ckpt)
        writes.clear()
        r = train(cfg, device="cpu")
        model = r.model
        assert model.fcs[0].weight.device == CPU
        sparse = isinstance(model, MagMLP)
        if sparse:
            assert model.vocab_mesh.multiprocess
            assert len(model.table_shards) == 2
        params = mag_to_jax(model)[0] if sparse else mlp_to_jax(model)[0]
        tdist.barrier()
        assert writes and all(w == (rank == 0) for w in writes), writes
        assert os.listdir(ckpt) == ["best.npz"], os.listdir(ckpt)
        hist = torch.tensor([[h["batch"], h["val_loss"], h["val_acc"],
                              h["loss"]] for h in r.history])
        assert same_on_every_rank([hist, torch.tensor(r.test_acc)]), \
            "the ranks recorded another history"
        for name, t in [*model.named_parameters(), *model.named_buffers()]:
            if not name.startswith("table_shards."):
                assert same_on_every_rank([t]), f"{name} differs by rank"
        loaded, meta = load_model(os.path.join(ckpt, "best.npz"), model.cfg,
                                  sparse=sparse, device="cpu")
        assert meta["best_val_acc"] == r.best_val_acc
        want = model.gathered_table()[:model.cfg.num_features] if sparse \
            else None
        if sparse:
            assert torch.equal(loaded.table, want)
            assert meta["__row_padded__"]
        for a, b in zip(loaded.fcs.parameters(), model.fcs.parameters()):
            assert torch.equal(a, b)
        # the same run on the one-process mesh
        one = train(cfg.replace(ckpt_dir=None), device="cpu",
                    mesh=_one_process_mesh())
        hist_one = torch.tensor([[h["batch"], h["val_loss"], h["val_acc"],
                                  h["loss"]] for h in one.history])
        assert hist.shape == hist_one.shape
        assert rel(hist[:, 1], hist_one[:, 1]) <= 1e-4, (hist, hist_one)
        n_test = len(load_data(spec, split_seed=cfg.seed1).idx_test)
        assert abs(r.test_acc - one.test_acc) <= 1.0 / n_test + 1e-9
        report[engine] = {"test_acc": r.test_acc, "one": one.test_acc,
                          "writes": len(writes)}
        if rank == 0:
            np.savez(os.path.join(shared, f"{engine}_weights.npz"),
                     **{"w0": params["fcs"][0]["w"],
                        **({"table": params["emb"]["table"]} if sparse
                           else {})})
    with open(os.path.join(shared, f"e2e_{rank}.json"), "w") as f:
        json.dump(report, f)


def _digest(model) -> torch.Tensor:
    """A checksum of a model's whole weights and buffers, a vocab-sharded
    table gathered (a collective: every rank calls it), the same bits
    giving the same value."""
    import hashlib

    h = hashlib.sha256()
    for name, t in [*model.named_parameters(), *model.named_buffers()]:
        if not name.startswith("table_shards."):
            h.update(t.detach().contiguous().numpy().tobytes())
    if hasattr(model, "gathered_table"):
        h.update(model.gathered_table().contiguous().numpy().tobytes())
    return torch.tensor(list(h.digest()), dtype=torch.uint8)


def part_longrun(rank, world, shared):
    import signal

    import torch.distributed as tdist

    from grandtpu_torch.config import GrandConfig
    from grandtpu_torch.train import loop, train
    from grandtpu_torch.train import trainer as dense_trainer
    from grandtpu_torch.train import trainer_sparse

    writes, digests = [], []
    real_save, real_restore = loop.save_checkpoint, loop.restore_training
    loop.save_checkpoint = lambda *a, **k: writes.append(
        (os.path.basename(a[0]), real_save(*a, **k)))

    def restore(model, optimizer, *a):
        real_restore(model, optimizer, *a)
        if optimizer is not None:           # latest.npz, not best.npz
            digests.append(_digest(model))

    loop.restore_training = restore
    report = {}
    for engine, spec in (("dense", "synth:240:3:16"),
                         ("sparse", "synth:240:3:30:sparse")):
        base = os.path.join(shared, "longrun", engine)
        cfg = GrandConfig(dataset=spec, epochs=2, patience=50, order=3,
                          alpha=0.2, rmax=1e-6, top_k=8, hidden=16,
                          batch_size=16, unlabel_batch_size=16,
                          eval_batch=2, push_backend="numpy",
                          num_devices=4, ckpt_dir=os.path.join(base, "ck"),
                          save_every=1,
                          metrics_path=os.path.join(base, "m.jsonl"))
        writes.clear()
        first = train(cfg, device="cpu")
        tdist.barrier()
        assert writes and all(ok == (rank == 0) for _, ok in writes), writes
        lines = [json.loads(ln) for ln in open(cfg.metrics_path)]
        # one writer: each eval once, then train_end
        assert len(lines) == len(first.history) + 1, lines
        assert lines[-1]["event"] == "train_end"
        logs, digests[:] = [], []
        res = train(cfg.replace(resume=True, epochs=4), device="cpu",
                    log=logs.append)
        assert any("resumed from" in str(m) for m in logs)
        assert len(digests) == 1 and same_on_every_rank(digests), \
            "the ranks resumed to other weights"
        hist = torch.tensor([[h["batch"], h["val_loss"], h["val_acc"],
                              h["loss"]] for h in res.history])
        assert same_on_every_rank([hist]), "the resumed histories differ"
        assert res.history[0]["batch"] > first.history[-1]["batch"]

        # SIGTERM on every rank at the 3rd step: both stop after the group
        stop_dir = os.path.join(base, "stop")
        steps = {"n": 0}

        def signalling(step):
            def sig_step(*a, **k):
                steps["n"] += 1
                if steps["n"] == 3:
                    os.kill(os.getpid(), signal.SIGTERM)
                return step(*a, **k)
            return sig_step

        real_dense = dense_trainer.build_train_step
        real_sparse = trainer_sparse.build_sparse_steps
        dense_trainer.build_train_step = lambda *a, **k: signalling(
            real_dense(*a, **k))
        trainer_sparse.build_sparse_steps = lambda *a, **k: (
            lambda st, ev: (signalling(st), ev))(*real_sparse(*a, **k))
        logs, writes[:] = [], []
        try:
            stopped = train(cfg.replace(ckpt_dir=stop_dir, save_every=0,
                                        metrics_path=None, epochs=4),
                            device="cpu", log=logs.append)
        finally:
            dense_trainer.build_train_step = real_dense
            trainer_sparse.build_sparse_steps = real_sparse
        tdist.barrier()
        assert stopped.preempted and stopped.num_batches == 3, \
            stopped.num_batches
        saved = "latest.npz" in os.listdir(stop_dir)
        assert saved == (engine == "dense"), os.listdir(stop_dir)
        if engine == "sparse":
            assert any("WITHOUT a fresh save" in str(m) for m in logs)
        report[engine] = {"num_batches": res.num_batches,
                          "stopped": stopped.num_batches, "saved": saved}
    with open(os.path.join(shared, f"longrun_{rank}.json"), "w") as f:
        json.dump(report, f)


COLLECTIVES = ("broadcast", "reduce_sum", "all_reduce_sum", "all_gather_0",
               "all_gather_1", "scatter_rows", "reduce_scatter_rows",
               "all_to_all", "pmax", "gather_rows")


def _collective_case(mesh, name: str, rank_shards) -> dict:
    """The forward outputs (this process's) and the input gradients of
    collective ``name`` on ``mesh``, from inputs drawn for all 4 shards;
    the loss is the replicated sum of each output times a weight drawn for
    its shard."""
    g = torch.Generator().manual_seed(7)
    xs_all = [torch.randn(8, 3, generator=g) for _ in range(4)]
    x_rep = torch.randn(8, 3, generator=g)
    ws = [torch.randn(32, 3, generator=g) for _ in range(4)]
    xs = [xs_all[s].clone().requires_grad_(True) for s in rank_shards]
    x = x_rep.clone().requires_grad_(True)

    def weighted(outs):
        return mesh.reduce_sum([(o * ws[s][:o.shape[0], :o.shape[1]]).sum()
                                for o, s in zip(outs, rank_shards)])

    leaves = xs
    if name == "broadcast":
        outs, leaves = mesh.broadcast(x), [x]
        loss = weighted(outs)
    elif name == "reduce_sum":
        outs = [mesh.reduce_sum(xs)]
        loss = (outs[0] * ws[0][:8]).sum()
    elif name == "all_reduce_sum":
        outs = mesh.all_reduce_sum(xs)
        loss = weighted(outs)
    elif name.startswith("all_gather"):
        outs = mesh.all_gather(xs, dim=int(name[-1]))
        loss = weighted([o.reshape(-1, 3) for o in outs])
    elif name == "scatter_rows":
        outs, leaves = mesh.scatter_rows(x), [x]
        loss = weighted(outs)
    elif name == "reduce_scatter_rows":
        outs = mesh.reduce_scatter_rows(xs)
        loss = weighted(outs)
    elif name == "all_to_all":
        with torch.no_grad():
            outs = mesh.all_to_all([x_.detach().reshape(4, 2, 3)
                                    for x_ in xs])
        loss = None
    elif name == "pmax":
        with torch.no_grad():
            outs = mesh.pmax(xs)
        loss = None
    else:
        with torch.no_grad():
            outs = [mesh.gather_rows(xs)]
        loss = None
    grads = ([] if loss is None
             else list(torch.autograd.grad(loss, leaves)))
    return {"outs": [o.detach() for o in outs], "grads": grads,
            "loss": None if loss is None else loss.detach()}


def part_collectives(rank, world, shared):
    proc, one = _process_mesh(rank), _one_process_mesh()
    mine = list(proc.shards)
    report = {}
    for name in COLLECTIVES:
        got = _collective_case(proc, name, mine)
        want = _collective_case(one, name, [0, 1, 2, 3])
        # the one-process mesh's outputs and gradients of this rank's
        # shards (a replicated input's gradient is the whole one)
        whole = name in ("reduce_sum", "gather_rows")
        w_outs = (want["outs"] if whole
                  else [want["outs"][s] for s in mine])
        if not want["grads"] or name in ("broadcast", "scatter_rows"):
            w_grads = want["grads"]
        else:
            w_grads = [want["grads"][s] for s in mine]
        errs = [rel(a, b) for a, b in zip(got["outs"], w_outs)]
        gerrs = [rel(a, b) for a, b in zip(got["grads"], w_grads)]
        # the replicated values: the loss, or a forward-only result that
        # every rank holds whole
        if got["loss"] is not None:
            same = same_on_every_rank([got["loss"]])
        elif name in ("pmax", "gather_rows"):
            same = same_on_every_rank(got["outs"])
        else:
            same = True
        report[name] = {
            "outs": len(got["outs"]) == len(w_outs)
            and all(a.shape == b.shape for a, b in zip(got["outs"], w_outs)),
            "grads": len(got["grads"]) == len(w_grads),
            "err": max(errs + gerrs), "same": same}
    with open(os.path.join(shared, f"collectives_{rank}.json"), "w") as f:
        json.dump(report, f)


def part_card(rank, world, shared, ports):
    """One dense step of 2 gloo ranks on cuda:0 against the one-process
    2-shard mesh of the card, then the NCCL refusal of such a job."""
    import torch.distributed as tdist

    from grandtpu_torch.dist import (joined_state, make_mesh, shard_batch,
                                     shard_train_inputs)
    from grandtpu_torch.dist.mesh import Mesh
    from grandtpu_torch.nn.mlp import init_mlp
    from grandtpu_torch.train.step import build_train_step, make_optimizer

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    rs = np.random.RandomState(0)
    ops = [torch.as_tensor(a, device=dev) for a in (
        rs.rand(N, F_).astype(np.float32),
        rs.randint(0, N, (N, 8)).astype(np.int32),
        rs.rand(N, 8).astype(np.float32))]
    batch = {"rows": torch.as_tensor(rs.permutation(N)[:NT + NU], device=dev),
             "labels": torch.as_tensor(rs.randint(0, C, NT), device=dev),
             "label_mask": torch.ones(NT, device=dev),
             "unlabel_mask": torch.ones(NU, device=dev)}
    mcfg, scfg = _dense_cfgs(True)
    base = init_mlp(mcfg, 0, dev)
    proc = make_mesh(2)
    assert proc.multiprocess and proc.devices == (dev,), proc
    runs = {}
    for name, mesh in (("proc", proc), ("one", Mesh((dev, dev)))):
        model = copy.deepcopy(base)
        opt = make_optimizer(model, 0.01, 1e-3)
        placed = shard_train_inputs(mesh, model=model, features=ops[0],
                                    tk_cols=ops[1], tk_vals=ops[2])
        step = build_train_step(scfg, model, opt, mesh=mesh)
        gen = torch.Generator(device=dev).manual_seed(5)
        metrics = step(*placed, shard_batch(mesh, batch), gen, 3)
        runs[name] = (metrics, joined_state(model, opt))
    for k in runs["one"][0]:
        assert rel(runs["proc"][0][k], runs["one"][0][k]) <= TOL, k
    _compare_states(runs["proc"][1], runs["one"][1])
    assert same_on_every_rank(_flat(runs["proc"][1]))
    tdist.destroy_process_group()
    tdist.init_process_group("nccl", init_method=f"tcp://localhost:"
                             f"{ports[1]}", world_size=world, rank=rank)
    try:
        make_mesh(2)
    except RuntimeError as e:
        assert "two ranks on one card" in str(e) and "gloo" in str(e), e
        print(f"refused: {e}", flush=True)
    else:
        raise AssertionError("NCCL with two ranks on one card was taken")


TP_SHAPES = ((2, 2), (1, 4))


def part_tp(rank, world, shared):
    from grandtpu_torch.dist import (joined_state, make_mesh, shard_batch,
                                     shard_sparse_train_inputs,
                                     shard_train_inputs)
    from grandtpu_torch.dist.mesh import Mesh
    from grandtpu_torch.nn.mag_mlp import init_mag_mlp
    from grandtpu_torch.nn.mlp import init_mlp
    from grandtpu_torch.train.step import build_train_step, make_optimizer
    from grandtpu_torch.train.trainer_sparse import build_sparse_steps

    inp = _inputs(shared)
    dense_ops = [torch.as_tensor(inp[k]) for k in ("feats", "cols", "vals")]
    mag_ops = [torch.as_tensor(inp[k])
               for k in ("attr_cols", "attr_vals", "cols", "vals")]
    mcfg, scfg = _dense_cfgs(True)
    cfg, mag_mcfg = _mag_cfgs()
    report = {}
    for engine in ("dense", "mag", "vocab"):
        base = (init_mlp(mcfg, 0, "cpu") if engine == "dense"
                else init_mag_mlp(mag_mcfg, 0, "cpu"))
        for n_data, n_model in TP_SHAPES:
            runs = {}
            for name, mesh in (
                    ("proc", make_mesh(n_data, n_model=n_model,
                                       device="cpu")),
                    ("one", Mesh((CPU,) * 4, n_model=n_model))):
                model = copy.deepcopy(base)
                if engine == "dense":
                    placed = shard_train_inputs(
                        mesh, model=model, features=dense_ops[0],
                        tk_cols=dense_ops[1], tk_vals=dense_ops[2],
                        tensor_parallel=True)
                    opt = make_optimizer(model, 0.01, 1e-3)
                    step = build_train_step(scfg, model, opt, mesh=mesh)
                else:
                    placed = shard_sparse_train_inputs(
                        mesh, model=model, attr_cols=mag_ops[0],
                        attr_vals=mag_ops[1], tk_cols=mag_ops[2],
                        tk_vals=mag_ops[3],
                        emb_mode="tp" if engine == "mag" else "vocab")
                    opt = make_optimizer(model, cfg.lr, 1e-3)
                    step = build_sparse_steps(cfg, model, opt, C,
                                              mesh=mesh)[0]
                gen = torch.Generator().manual_seed(5)
                metrics = [step(*placed, shard_batch(mesh, _batch(inp, i)),
                                gen, i) for i in range(2)]
                runs[name] = (metrics, joined_state(model, opt), mesh)
            (m_p, s_p, proc), (m_o, s_o, _) = runs["proc"], runs["one"]
            errs = [rel(m_p[i][k], m_o[i][k]) for i in range(2)
                    for k in m_o[i]]
            assert s_p.keys() == s_o.keys(), (sorted(s_p), sorted(s_o))
            errs += [rel(g, w) for name in s_o
                     for g, w in zip(s_p[name], s_o[name])]
            report[f"{engine}/{n_data}x{n_model}"] = {
                "err": max(errs), "same": same_on_every_rank(_flat(s_p)),
                "model_group": proc.model_group,
                "columns": list(proc.local_columns)}
    with open(os.path.join(shared, f"tp_{rank}.json"), "w") as f:
        json.dump(report, f)


PARTS = {"push": part_push, "dense": part_dense, "d1": part_d1,
         "d1_2d": part_d1_2d,
         "mag": part_mag, "e2e": part_e2e, "longrun": part_longrun,
         "collectives": part_collectives,
         "card": part_card, "tp": part_tp}


def worker(argv) -> None:
    import torch.distributed as tdist

    part, rank, world = argv[0], int(argv[1]), int(argv[2])
    ports, shared = [int(p) for p in argv[3].split(",")], argv[4]
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"tcp://localhost:"
                             f"{ports[0]}", world_size=world, rank=rank)
    try:
        if part == "card":
            part_card(rank, world, shared, ports)
        else:
            PARTS[part](rank, world, shared)
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
    print(f"RANK{rank} OK", flush=True)


if __name__ == "__main__":
    worker(sys.argv[1:])
    sys.exit(0)


# -------------------------------------------------------------- the tests


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    path = tmp_path_factory.mktemp("dist_process")
    write_inputs(str(path))
    return path


def _grandtpu_dense(path) -> None:
    """grandtpu's single-device dense step, DropNode and dropout off, two
    steps from its own initial weights on the workers' inputs: the initial
    weights as a grandtpu checkpoint, and after each step the metrics,
    and after the last the parameters, gradients (Adam's first moment is
    0.1 of the clipped, decayed gradient after one step), moments and BN
    state under the port's names."""
    import jax
    import jax.numpy as jnp

    from grandtpu.nn import mlp as jmlp
    from grandtpu.train import checkpoint as jckpt
    from grandtpu.train import step as jstep

    from grandtpu_torch.convert import mlp_from_jax
    from grandtpu_torch.nn.mlp import MLPConfig

    inp = _inputs(path)
    mcfg, scfg = _dense_cfgs(False)
    kw = {f: getattr(mcfg, f) for f in ("num_features", "num_classes",
                                        "hidden", "nlayers", "use_bn",
                                        "node_norm")}
    jm = jmlp.MLPConfig(**kw)
    params, state = jmlp.init_mlp(jax.random.PRNGKey(0), jm)
    jckpt.save_checkpoint(os.path.join(path, "grandtpu_dense_init.npz"),
                          params=params, state=state)
    opt = jstep.make_optimizer(0.01, 1e-3)
    opt_state = opt.init(params)
    step_kw = {f: getattr(scfg, f) for f in (
        "k_aug", "dropnode_rate", "n_train", "lam", "warmup", "tem", "conf",
        "loss_kind", "clip_norm")}
    fn = jstep.build_train_step(jstep.StepConfig(mlp=jm, **step_kw), opt)
    out = {}
    for i in range(2):
        batch = {k: jnp.asarray(inp[f"{k}_{i}"].astype(np.int32)
                                if inp[f"{k}_{i}"].dtype == np.int64
                                else inp[f"{k}_{i}"])
                 for k in ("rows", "labels", "label_mask", "unlabel_mask")}
        params, state, opt_state, m = fn(
            params, state, opt_state, jnp.asarray(inp["feats"]),
            jnp.asarray(inp["cols"]), jnp.asarray(inp["vals"]), batch,
            jax.random.PRNGKey(2), float(i))
        for k, v in m.items():
            out[f"metric/{k}/{i}"] = np.asarray(v)
    adam = next(s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda t: hasattr(t, "mu")) if hasattr(s, "mu"))
    tm = MLPConfig(**kw)

    def named(tree, st, key):
        model = mlp_from_jax(jax.tree.map(np.asarray, tree),
                             jax.tree.map(np.asarray, st), tm, "cpu")
        return {f"{key}/{n}": p.detach().numpy()
                for n, p in model.named_parameters()}, model

    got, model = named(params, state, "param")
    out.update(got)
    out.update({f"buffer/{n}": b.numpy() for n, b in model.named_buffers()})
    out.update(named(adam.mu, state, "mu")[0])
    out.update(named(adam.nu, state, "nu")[0])
    np.savez(os.path.join(path, "grandtpu_dense.npz"), **out)


def test_two_rank_push_equals_one_process_push(shared):
    """(a) the all-gather of the padded tables, cols and vals exact."""
    spawn("push", shared)


def test_two_rank_dense_step_equals_one_process_and_grandtpu(shared):
    """(b) the dense step over 2 ranks x 2 shards: every drop rate on,
    equal to the one-process 4-shard mesh's step; drops off, also equal to
    grandtpu's single-device step; the replicas bit-identical."""
    _grandtpu_dense(shared)
    spawn("dense", shared)


def test_two_rank_d1_both_branches(shared):
    """(c) D1 over the processes: all_gather and halo, f32 and int8, the
    scatter variant, the 0.5 default threshold."""
    spawn("d1", shared)
    for rank in range(WORLD):
        with open(os.path.join(shared, f"d1_{rank}.json")) as f:
            assert len(json.load(f)) == 4


@pytest.fixture(scope="module")
def d1_2d(shared):
    spawn("d1_2d", shared)
    out = []
    for rank in range(WORLD):
        with open(os.path.join(shared, f"d1_2d_{rank}.json")) as f:
            out.append(json.load(f))
    return out


@pytest.mark.parametrize("case", [
    f"{shape}/{axis}/{what}" for shape, axis in D1_2D_MESHES
    for what in [f"{v}_{p}" for v, p in D1_2D_FORMS] + ["push"]])
def test_two_rank_d1_and_push_on_a_2d_mesh(d1_2d, case):
    """D1 and the push over 2 ranks on a 2-D mesh along either axis: the
    column groups of a (2 x 2) mesh span the ranks, the row of a (1 x 2)
    or (1 x 4) mesh spans them, the rows of a (2 x 2) mesh along 'model'
    lie inside them. Each rank's result, from every local group, equals
    the one-process mesh of the same shape bit for bit, the same on every
    rank; f32 within 1e-5 of exact_propagate."""
    shape, axis = case.split("/")[:2]
    n_data, n_model = map(int, shape.split("x"))
    # local groups: a rank holds n_model / 2 columns of the data row it is
    # in when 'model' spans the ranks, every column otherwise; along
    # 'model' one row a rank, or its share of the only one
    groups = {"data": n_model, "model": max(n_data // WORLD, 1)}[axis]
    for rank, report in enumerate(d1_2d):
        r = report[case]
        assert r["groups"] == groups, (rank, r)
        assert r["equal_one_process"] and r["same"], (rank, r)
        if case.endswith("f32"):
            assert r["err"] <= TOL, (rank, r)


def test_two_rank_vocab_sharded_mag_step(shared):
    """(d) the vocab-sharded MAG step (vocabulary 30 over 4 shards): equal
    to the one-process mesh's, the clip's norm over every rank's table
    shards, the replicas bit-identical."""
    spawn("mag", shared)


def test_two_rank_trainers_end_to_end_with_checkpoints(shared):
    """(e) ``train()`` of both engines over the processes with ``ckpt_dir``:
    rank 0 writes the one best.npz; grandtpu loads it (the padded MAG table
    sliced back to the vocabulary) and finds the weights the ranks hold."""
    import jax

    from grandtpu.nn import mag_mlp as jmag
    from grandtpu.nn import mlp as jmlp
    from grandtpu.train import checkpoint as jckpt

    spawn("e2e", shared, timeout=240)
    reports = []
    for rank in range(WORLD):
        with open(os.path.join(shared, f"e2e_{rank}.json")) as f:
            reports.append(json.load(f))
    assert reports[0] == reports[1]
    for engine, vocab in (("dense", None), ("sparse", 30)):
        jm = jmlp.MLPConfig(num_features=vocab or 16, num_classes=3,
                            hidden=16, nlayers=2)
        init = jmag.init_mag_mlp if vocab else jmlp.init_mlp
        params_t, state_t = init(jax.random.PRNGKey(0), jm)
        params, _, _, meta = jckpt.load_checkpoint(
            os.path.join(shared, engine, "best.npz"),
            params_template=params_t, state_template=state_t)
        with np.load(os.path.join(shared, f"{engine}_weights.npz")) as d:
            np.testing.assert_array_equal(
                np.asarray(params["fcs"][0]["w"]), d["w0"])
            if vocab:
                assert np.asarray(params["emb"]["table"]).shape[0] == vocab
                assert d["table"].shape[0] == 32
                np.testing.assert_array_equal(
                    np.asarray(params["emb"]["table"]), d["table"][:vocab])
                assert meta["__row_padded__"]


def test_two_rank_long_run_options(shared):
    """(f) over 2 gloo ranks: rank 0 alone writes the metrics stream and
    latest.npz, every rank resumes from it to the same weights and
    history, and a preemption saves for the replicated dense model but not
    for the vocab-sharded MAG table (grandtpu's ``saveable`` rule)."""
    spawn("longrun", shared, timeout=240)
    reports = []
    for rank in range(WORLD):
        with open(os.path.join(shared, f"longrun_{rank}.json")) as f:
            reports.append(json.load(f))
    assert reports[0] == reports[1]
    assert reports[0]["dense"]["saved"] and not reports[0]["sparse"]["saved"]


@pytest.fixture(scope="module")
def collectives(shared):
    spawn("collectives", shared)
    out = []
    for rank in range(WORLD):
        with open(os.path.join(shared, f"collectives_{rank}.json")) as f:
            out.append(json.load(f))
    return out


@pytest.mark.parametrize("name", COLLECTIVES)
def test_process_collective_and_its_adjoint(collectives, name):
    """Forward and gradient of each collective over 2 ranks x 2 shards
    equal the one-process 4-shard mesh's on the same inputs (forward only
    for all_to_all, pmax and gather_rows), the same on every rank."""
    for rank, report in enumerate(collectives):
        r = report[name]
        assert r["outs"] and r["grads"], (rank, r)
        assert r["err"] <= TOL, (rank, r)
        assert r["same"], (rank, r)


@pytest.fixture(scope="module")
def tensor_parallel(shared):
    spawn("tp", shared, timeout=240)
    out = []
    for rank in range(WORLD):
        with open(os.path.join(shared, f"tp_{rank}.json")) as f:
            out.append(json.load(f))
    return out


@pytest.mark.parametrize("case", ["dense/2x2", "dense/1x4", "mag/2x2",
                                  "mag/1x4", "vocab/2x2", "vocab/1x4"])
def test_two_rank_tensor_parallel_step(tensor_parallel, case):
    """The step split over 'model' (or, for ``vocab``, the MAG table's rows
    over 'data', replicated over 'model') on 2 ranks x 2 shards equals the
    one-process mesh of its shape, every drop rate on; the replicas are
    bit-identical. (2 x 2) keeps 'model' inside a rank, (1 x 4) puts each
    rank on 2 of a row's 4 model columns."""
    across = case.endswith("1x4")
    for rank, report in enumerate(tensor_parallel):
        r = report[case]
        assert r["err"] <= TOL, (rank, r)
        assert r["same"], (rank, r)
        assert r["model_group"] == ([0, 1] if across else None), r
        assert r["columns"] == ([2 * rank, 2 * rank + 1] if across
                                else [0, 1]), r


def test_hand_made_process_mesh_places_its_own_shards():
    """Placement needs no process group: rank 1 of a 2-rank mesh of 4
    shards gets blocks 2 and 3 of the rows, the batch and the features."""
    from grandtpu_torch.dist import shard_batch
    from grandtpu_torch.dist.data_parallel import BatchSplit, split_rows
    from grandtpu_torch.dist.mesh import Mesh
    from grandtpu_torch.dist.spmm_shard import place

    mesh = Mesh((CPU, CPU), shards=(2, 3), ranks=2, rank=1)
    assert mesh.size == 4 and mesh.shape == {"data": 4, "model": 1}
    assert mesh.multiprocess and not Mesh((CPU,) * 4).multiprocess
    assert Mesh((CPU,) * 4).shards == (0, 1, 2, 3)
    assert [p.tolist() for p in split_rows(mesh, torch.arange(10))] == \
        [[6, 7], [8, 9]]
    batch = {"rows": torch.arange(16), "labels": torch.arange(8),
             "label_mask": torch.ones(8)}
    parts = shard_batch(mesh, batch)
    assert [p["rows"].tolist() for p in parts] == [[4, 5, 12, 13],
                                                   [6, 7, 14, 15]]
    assert [p["labels"].tolist() for p in parts] == [[4, 5], [6, 7]]
    split = BatchSplit(mesh, 8, 8)
    assert split.rows == 16
    assert [b.tolist() for b in split(torch.arange(16))] == \
        [[4, 5, 12, 13], [6, 7, 14, 15]]
    blocks = place(mesh, 10, 3, torch.arange(10.0)[:, None])
    assert [b[:, 0].tolist() for b in blocks] == [[6, 7, 8], [9, 0, 0]]


def test_hand_made_process_mesh_shards_the_vocab_by_global_id():
    from grandtpu_torch.dist.mesh import Mesh
    from grandtpu_torch.nn.mag_mlp import init_mag_mlp

    _, mcfg = _mag_cfgs()
    model = init_mag_mlp(mcfg, 0, "cpu")
    table = model.table.detach().clone()
    model.shard_vocab(Mesh((CPU, CPU), shards=(2, 3), ranks=2, rank=1))
    assert len(model.table_shards) == 2
    assert model.vocab_window(3) == (24, 32)
    assert torch.equal(model.table_shards[0], table[16:24])
    assert torch.equal(model.table_shards[1][:6], table[24:30])
    assert not model.table_shards[1][6:].any()


def test_default_halo_threshold_follows_the_processes():
    from grandtpu_torch.dist import default_halo_threshold
    from grandtpu_torch.dist.mesh import Mesh

    assert default_halo_threshold(Mesh((CPU,) * 4)) == 0.0
    assert default_halo_threshold(
        Mesh((CPU,), shards=(0,), ranks=2, rank=0)) == 0.5


def test_nccl_refuses_two_ranks_on_one_card():
    from grandtpu_torch.dist.mesh import refuse_shared_cards

    refuse_shared_cards(["h/H100/a", "h/H100/b", "g/H100/a"])
    with pytest.raises(RuntimeError, match="ranks 0 and 2 .*gloo"):
        refuse_shared_cards(["h/H100/a", "h/H100/b", "h/H100/a"])


def test_one_rank_multihost_push_is_the_plain_push(shared):
    from grandtpu_torch.dist import multihost_native_gfpush
    from grandtpu_torch.ppr import gfpush

    adj = _adj(_inputs(shared))
    kw = dict(prop_mode="ppr", order=3, alpha=0.2, rmax=1e-4, k=4,
              backend="numpy", device="cpu")
    got = multihost_native_gfpush(adj, np.arange(50), **kw)
    want = gfpush(adj, np.arange(50), **kw)
    assert np.array_equal(got.cols, want.cols)
    assert np.array_equal(got.vals, want.vals)


def test_tensor_parallel_names_its_item():
    """A hand-made rank of a (1 x 4) mesh over 2 ranks holds model columns
    2 and 3 of data row 0: 'model' spans the ranks, and the groups its
    collectives take are the row's ranks; the source-sharded push runs on
    a (2 x 2) mesh along either axis, equal to the 1-D mesh's."""
    import scipy.sparse as sp

    from grandtpu_torch.dist import make_mesh, sharded_gfpush
    from grandtpu_torch.dist.mesh import Mesh

    mesh = Mesh((CPU, CPU), shards=(2, 3), ranks=2, rank=1, n_model=4)
    assert mesh.shape == {"data": 1, "model": 4}
    assert mesh.local_columns == (2, 3) and mesh.data_shards == (0, 0)
    assert mesh.model_group == (0, 1)
    assert mesh.column(3).shards == (0,) and not mesh.column(3).multiprocess
    inside = Mesh((CPU, CPU), shards=(2, 3), ranks=2, rank=1, n_model=2)
    assert inside.model_group is None and inside.column(0).multiprocess
    ring = sp.csr_matrix(sp.eye(6, k=1) + sp.eye(6, k=-5) + sp.eye(6))
    args = (ring.indptr.astype(np.int32), ring.indices.astype(np.int32),
            np.arange(6, dtype=np.int32), np.ones(2, np.float32), 1e-4, 2)
    want = sharded_gfpush(make_mesh(2, device="cpu"), *args)
    for axis in ("data", "model"):
        got = sharded_gfpush(make_mesh(2, n_model=2, device="cpu"), *args,
                             axis=axis)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_row_and_along_name_each_layout():
    """``Mesh.row(d)`` and ``Mesh.along(axis)`` on hand-made process
    meshes: the groups' shards named by their index along the axis, and a
    group over the ranks that hold it. (1 x 4) over 2 ranks: the row spans
    them; (2 x 2) over 2 ranks: the rows lie inside them and the columns
    span them; (2 x 4) over 4 ranks: a row spans 2 of them, a column the
    other 2."""
    from grandtpu_torch.dist.mesh import Mesh

    across = Mesh((CPU, CPU), shards=(2, 3), ranks=2, rank=1, n_model=4)
    (idx, row), = across.along("model").items()
    assert idx == 0 and row[0] == (0, 1) and row[1] is across.row(0)
    row = across.row(0)
    assert (row.shards, row.ranks, row.rank, row.group, row.size) == (
        (2, 3), 2, 1, (0, 1), 4)
    assert list(across.along("data")) == [2, 3]
    assert across.along("data")[3] == ((1,), across.column(3))

    inside = Mesh((CPU, CPU), shards=(2, 3), ranks=2, rank=1, n_model=2)
    row = inside.row(1)
    assert list(inside.along("model")) == [1]
    assert row.shards == (0, 1) and not row.multiprocess
    col = inside.column(1)
    assert inside.along("data")[1] == ((1,), col)
    assert (col.shards, col.ranks, col.rank, col.group) == ((1,), 2, 1,
                                                            None)

    grid = Mesh((CPU, CPU), shards=(4, 5), ranks=4, rank=2, n_model=4)
    assert grid.shape == {"data": 2, "model": 4}
    row, col = grid.row(1), grid.column(1)
    assert (row.shards, row.ranks, row.rank, row.group) == ((0, 1), 2, 0,
                                                            (2, 3))
    assert (col.shards, col.ranks, col.rank, col.group) == ((1,), 2, 1,
                                                            (0, 2))
    with pytest.raises(ValueError, match="not 'bogus'"):
        grid.along("bogus")

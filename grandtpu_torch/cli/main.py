"""Experiment CLI (port of ``grandtpu/cli/main.py``: ``run``,
``predict`` and ``presets``; ``bench`` is not ported yet).

    python -m grandtpu_torch.cli.main run --preset reddit \
        --dataset synth:233000:41:602 --epochs 2          # on the GPU
    python -m grandtpu_torch.cli.main run --dataset synth:500:4:32 \
        --epochs 5 --device cpu                           # plain versions
    python -m grandtpu_torch.cli.main run --preset mag_scholar_c \
        --dataset synth:1000000:8:2780000:sparse --epochs 5   # MAG engine
    python -m grandtpu_torch.cli.main run --dataset synth:400:4:32 \
        --ckpt-dir /tmp/c --device cpu                    # writes best.npz
    python -m grandtpu_torch.cli.main run --dataset synth:400:4:32 \
        --ckpt-dir /tmp/d --ckpt-backend orbax --device cpu   # best/ (DCP)
    python -m grandtpu_torch.cli.main run --dataset synth:400:4:32 \
        --num-devices 2 --device cpu                      # data-parallel
    python -m grandtpu_torch.cli.main predict --dataset synth:400:4:32 \
        --ckpt /tmp/c/best.npz --device cpu [--num-devices 2]
    python -m grandtpu_torch.cli.main predict --dataset synth:400:4:32 \
        --ckpt /tmp/d/best --device cpu                   # from a directory
    GRANDTPU_DATA_DIR=/data python -m grandtpu_torch.cli.main predict \
        --preset Amazon2M --ckpt /tmp/c/best.npz --precision int8
    python -m grandtpu_torch.cli.main presets

``--dataset`` takes a ``synth:`` spec or a dataset's name (``reddit``,
``Amazon2M``, ``cora``, ...), whose files ``load_data`` reads from
$GRANDTPU_DATA_DIR (``python -m grandtpu_torch.data.download
--dataset NAME`` fetches them); a preset without ``--dataset`` loads its
own dataset's files. Every GrandConfig field is overridable via a --flag of
the same name (underscores become dashes).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np

from grandtpu_torch.config import PRESETS, GrandConfig, preset


def _add_config_flags(p: argparse.ArgumentParser):
    for f in dataclasses.fields(GrandConfig):
        flag = "--" + f.name.replace("_", "-")
        if isinstance(f.default, bool):
            p.add_argument(flag, type=lambda s: s.lower() in
                           ("1", "true", "yes"), default=None,
                           metavar="BOOL")
        elif isinstance(f.default, int):
            p.add_argument(flag, type=int, default=None)
        elif isinstance(f.default, float):
            p.add_argument(flag, type=float, default=None)
        else:
            p.add_argument(flag, type=str, default=None)


def _build_config(args) -> GrandConfig:
    # --preset applies a named preset's hyperparameters to ANY dataset
    # (e.g. a synth:* scale stand-in run under the reddit recipe); without
    # it, a dataset whose name IS a preset gets its preset.
    if args.preset:
        base = preset(args.preset, args.prop_mode or "ppr").replace(
            dataset=args.dataset or args.preset)
    elif args.dataset in PRESETS:
        base = preset(args.dataset, args.prop_mode or "ppr")
    else:
        base = GrandConfig(dataset=args.dataset)
    overrides = {f.name: getattr(args, f.name)
                 for f in dataclasses.fields(GrandConfig)
                 if getattr(args, f.name, None) is not None}
    return base.replace(**overrides)


def cmd_run(args) -> int:
    from grandtpu_torch.train import train

    cfg = _build_config(args)
    accs, times, btimes, bmeds, nbatches = [], [], [], [], []
    # multi-run protocols enumerate seeds 0..N-1 like the reference driver
    # (run_model.py:83-86); a single run honors the configured seeds
    for s1 in range(cfg.seed1_runs):
        for s2 in range(cfg.seed2_runs):
            run_cfg = cfg.replace(
                seed1=s1 if cfg.seed1_runs > 1 else cfg.seed1,
                seed2=s2 if cfg.seed2_runs > 1 else cfg.seed2)
            r = train(run_cfg, device=args.device)
            accs.append(r.test_acc)
            times.append(r.total_time)
            btimes.append(r.batch_time_avg)
            bmeds.append(r.batch_time_median)
            nbatches.append(r.num_batches)
            print(f"split run: {s1}, init run: {s2}, "
                  f"acc: {r.test_acc:.4f}, avg acc: {np.mean(accs):.4f}")
    print(json.dumps({
        "dataset": cfg.dataset, "prop_mode": cfg.prop_mode,
        "device": args.device, "runs": len(accs),
        "accs": [float(a) for a in accs],
        "test_acc_mean": float(np.mean(accs)),
        "test_acc_std": float(np.std(accs)),
        "time_mean_s": float(np.mean(times)),
        "batch_time_mean_s": float(np.mean(btimes)),
        "batch_time_median_s": float(np.median(bmeds)),
        "num_batches_mean": float(np.mean(nbatches)),
    }))
    return 0


def cmd_predict(args) -> int:
    """Offline serving: load a checkpoint (the port's or grandtpu's), classify
    every node after exact full-graph propagation, on one device or
    row-partitioned over ``--num-devices`` shards, and write the logits and
    predictions to an npz. Prints grandtpu's JSON line on stdout and the
    wall time by phase (data, checkpoint, operator build, hops, classify)
    on stderr. ``--profile-dir D`` writes a ``torch.profiler`` Chrome trace
    of the propagation and the classifier into D, the port's ``infer.*``
    spans on its timeline."""
    import torch

    from grandtpu_torch.data import load_data
    from grandtpu_torch.data.preprocess import add_self_loops_adj
    from grandtpu_torch.device import resolve_device
    from grandtpu_torch.infer.classify import (predict_logits,
                                               predict_logits_sparse)
    from grandtpu_torch.infer.propagate import exact_propagator
    from grandtpu_torch.nn.mlp import MLPConfig
    from grandtpu_torch.nn.sparse_input import PaddedFeatures
    from grandtpu_torch.observe import profile_trace
    from grandtpu_torch.train.checkpoint import load_model

    device = resolve_device(args.device)
    cfg = _build_config(args)
    seconds = {}

    def lap(name: str, t0: float) -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.time()
        seconds[name] = now - t0
        return now

    t = time.time()
    data = load_data(cfg.dataset, split_seed=cfg.seed1)
    adj_sl = add_self_loops_adj(data.adj)
    sparse = cfg.sparse_features or data.has_sparse_features
    t = lap("data_s", t)
    # num_features is the attr vocabulary in the sparse case and the dense
    # feature width otherwise: features.shape[1] either way
    mlp_cfg = MLPConfig(
        num_features=data.features.shape[1], num_classes=data.num_classes,
        hidden=cfg.hidden, nlayers=cfg.nlayers, use_bn=cfg.use_bn,
        node_norm=cfg.node_norm, input_droprate=cfg.input_droprate,
        hidden_droprate=cfg.hidden_droprate)
    model, meta = load_model(args.ckpt, mlp_cfg, sparse=sparse,
                             device=device)
    t = lap("checkpoint_s", t)
    mesh = None
    if cfg.num_devices > 1:
        # row-partitioned propagation (all_gather or halo exchange)
        from grandtpu_torch.dist import dist_exact_propagator, make_mesh
        mesh = make_mesh(cfg.num_devices, device=device)

    def propagate(x):
        t0 = time.time()
        if mesh is None:
            prop, precision = exact_propagator(
                adj_sl, x.shape[1], precision=args.precision, device=device)
        else:
            prop, precision = dist_exact_propagator(
                mesh, adj_sl, x.shape[1], precision=args.precision)
        t0 = lap("build_s", t0)
        out = prop(x, mode=cfg.prop_mode, order=cfg.order, alpha=cfg.alpha,
                   precision=precision)
        lap("hops_s", t0)
        return out

    # the propagation and the classifier; profiled with profile_dir
    with profile_trace(cfg.profile_dir):
        if sparse:
            padded = PaddedFeatures.from_csr(data.features)
            logits = predict_logits_sparse(
                model, padded.attr_cols, padded.attr_vals, adj_sl,
                mode=cfg.prop_mode, order=cfg.order, alpha=cfg.alpha,
                propagate=propagate)
            # the embeddings and the head, around the propagation
            lap("classify_s", t)
            seconds["classify_s"] -= seconds["build_s"] + seconds["hops_s"]
        else:
            prop = propagate(torch.as_tensor(
                np.asarray(data.features, np.float32), device=device))
            t = time.time()
            logits = predict_logits(model, prop)
            lap("classify_s", t)
    preds = logits.argmax(1)
    acc = float(np.equal(preds[data.idx_test],
                         data.labels_int[data.idx_test]).mean())
    out = args.output or f"predictions_{cfg.dataset.replace(':', '_')}.npz"
    np.savez(out, logits=logits, predictions=preds, idx_test=data.idx_test)
    print(json.dumps({"predict_seconds": seconds, "device": str(device),
                      "num_devices": cfg.num_devices}), file=sys.stderr)
    print(json.dumps({"dataset": cfg.dataset, "output": out,
                      "test_acc": acc,
                      "ckpt_val_acc": meta.get("best_val_acc")}))
    return 0


def cmd_presets(_args) -> int:
    keep = ("order alpha rmax top_k hidden nlayers lr weight_decay "
            "batch_size unlabel_batch_size lam tem loss warmup "
            "use_bn node_norm patience stop_mode").split()
    for name, cfg in PRESETS.items():
        d = dataclasses.asdict(cfg)
        print(name, json.dumps({k: d[k] for k in keep}))
    return 0


def cli(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="grandtpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_run = sub.add_parser("run", help="train + evaluate one config")
    _add_config_flags(p_run)
    p_run.add_argument("--preset", default=None, choices=sorted(PRESETS),
                       help="apply this dataset preset's hyperparameters "
                       "to --dataset (scale runs on synth:* stand-ins)")
    p_run.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                       help="cuda runs the hand-written kernels; cpu runs "
                       "their plain PyTorch versions")
    p_run.set_defaults(fn=cmd_run)
    p_pre = sub.add_parser("presets", help="list per-dataset presets")
    p_pre.set_defaults(fn=cmd_presets)
    p_pred = sub.add_parser(
        "predict", help="classify all nodes from a checkpoint")
    _add_config_flags(p_pred)
    p_pred.add_argument("--preset", default=None, choices=sorted(PRESETS),
                        help="apply this dataset preset's hyperparameters "
                        "to --dataset")
    p_pred.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda runs the hand-written kernels; cpu runs "
                        "their plain PyTorch versions")
    p_pred.add_argument("--ckpt", required=True,
                        help="checkpoint npz or directory (best.npz, or "
                        "best/ with --ckpt-backend orbax, from --ckpt-dir)")
    p_pred.add_argument("--output", default=None, help="output npz path")
    p_pred.add_argument("--precision", default="f32",
                        choices=["f32", "bf16", "int8", "auto"],
                        help="propagation precision: f32 (default), bf16, "
                        "int8 (quantized gather), or auto (grandtpu's "
                        "working-set heuristic between int8 and bf16)")
    p_pred.set_defaults(fn=cmd_predict)
    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except (NotImplementedError, FileNotFoundError, KeyError,
            ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(cli())

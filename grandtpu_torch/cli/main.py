"""Experiment driver CLI (port of ``grandtpu/cli/main.py``: ``run`` and
``presets``; ``predict`` and ``bench`` are not ported yet).

    python -m grandtpu_torch.cli.main run --preset reddit \
        --dataset synth:233000:41:602 --epochs 2          # on the GPU
    python -m grandtpu_torch.cli.main run --dataset synth:500:4:32 \
        --epochs 5 --device cpu                           # plain versions
    python -m grandtpu_torch.cli.main run --preset mag_scholar_c \
        --dataset synth:1000000:8:2780000:sparse --epochs 5   # MAG engine
    python -m grandtpu_torch.cli.main presets

Every GrandConfig field is overridable via a --flag of the same name
(underscores become dashes).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

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
    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except (NotImplementedError, KeyError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(cli())

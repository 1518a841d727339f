"""Typed experiment configuration + per-dataset presets.

The port's own copy of ``grandtpu/config.py`` (same fields, defaults,
presets and variants; the port imports nothing of ``grandtpu``). Every
field's feature is ported; ``ckpt_backend="orbax"`` keeps grandtpu's name
for the port's directory checkpoint (``torch.distributed.checkpoint``'s
bytes, ``train/checkpoint.py``).

Replaces the reference's flat argparse namespace (reference
``run_model.py:8-75``) and the seven ``scripts/run_*.sh`` hyperparameter
presets with one frozen dataclass and a typed preset table (reference
``scripts/run_cora.sh`` .. ``run_mag.sh``; see SURVEY.md Appendix A).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class GrandConfig:
    """Full configuration for one GRAND+ training run.

    Field semantics track the reference flags (``run_model.py:9-73``) so that
    presets are directly comparable; defaults equal the reference defaults.
    """

    # experiment identity
    model: str = "grandpp"
    dataset: str = "cora"
    seed1: int = 42              # data-split seed
    seed2: int = 42              # init/augmentation seed

    # propagation / precompute
    prop_mode: str = "ppr"       # 'ppr' | 'avg' | 'single'
    order: int = 10              # propagation steps N (coef length = order+1)
    alpha: float = 0.2           # ppr teleport
    rmax: float = 1e-7           # GFPush residue threshold
    top_k: int = 32              # per-row entries kept in the sparse Pi
    unlabel_num: int = -1        # |U'| pool size; -1 = all of idx_test

    # model
    hidden: int = 64
    nlayers: int = 2
    use_bn: bool = False
    node_norm: bool = False
    input_droprate: float = 0.5
    hidden_droprate: float = 0.7
    dropnode_rate: float = 0.5

    # optimization
    lr: float = 0.01
    weight_decay: float = 1e-3   # torch-Adam style (coupled, added to grad)
    epochs: int = 5000
    batch_size: int = 50
    unlabel_batch_size: int = 100
    sample: int = 2              # K augmentations per step
    clip_norm: float = -1.0      # <=0 disables clipping
    # consistency regularization
    lam: float = 1.0
    tem: float = 0.1
    loss: str = "l2"             # 'l2' | 'kl'
    warmup: float = 1000.0       # ramp length in batches

    # evaluation / early stopping
    eval_batch: int = 10
    patience: int = 100
    stop_mode: str = "both"      # 'acc' | 'both'

    # run protocol
    seed1_runs: int = 1
    seed2_runs: int = 1
    visible: bool = False

    # engine selection (new in grandtpu; reference dispatches on dataset name
    # at run_model.py:87-90)
    sparse_features: bool = False  # MAG-style embedding input path
    push_backend: str = "auto"     # 'auto' | 'native' | 'bucket' | 'jax'
    #                                | 'numpy'; auto = the device bucket
    #                                push at scale (ppr/api.py:
    #                                _auto_backend), else the native host
    #                                kernel
    push_cache_dir: Optional[str] = None  # content-addressed on-disk cache
    #                                of GFPush results (ppr/cache.py) —
    #                                precompute once, train many
    # (a pallas_dropnode flag existed through r3: the fused kernel lost to
    #  XLA's random_prop on every preset shape on hardware and was deleted)
    scan_steps: bool = False       # run each group of steps between
    #                                evals as one unit, with grandtpu's
    #                                policy (train/loop.py): on a card one
    #                                CUDA-graph replay, on the CPU step by
    #                                step; ignored on a mesh. Opt-in, as in
    #                                grandtpu; the trajectory is per-step
    #                                training's

    # distribution (no reference equivalent; reference is single-process)
    num_devices: int = 1           # data-parallel replication of the step
    mesh_axis: str = "data"

    # checkpointing / observability (beyond the reference's best-weights
    # torch.save; SURVEY.md §5)
    ckpt_dir: Optional[str] = None   # save best + periodic full state here
    ckpt_backend: str = "npz"        # "npz" (single file) | "orbax" (dir)
    resume: bool = False             # resume from ckpt_dir/latest.npz
    save_every: int = 0              # full-state ckpt every N evals (0=off)
    metrics_path: Optional[str] = None  # JSONL metrics stream
    profile_dir: Optional[str] = None   # torch.profiler Chrome traces

    # test-time exact-propagation precision (reference computes this on the
    # host in f32/f64, model.py:186-210 — f32 is the parity default).
    # 'bf16'/'int8'/'auto' are the fast paths (5e-3 gate, skew-guarded);
    # 'bf16_carry' additionally keeps the [n, H] power-iteration carries in
    # bf16 — halves propagation HBM, the backoff that lets MAG-scale
    # (12.4M x 64) predict fit a single 16GB chip
    predict_precision: str = "f32"

    @property
    def conf(self) -> float:
        """Confidence threshold injected at runtime in the reference
        (``model.py:328``): 2/n_class. Needs n_class; see resolve_conf."""
        raise AttributeError("use resolve_conf(n_class)")

    def resolve_conf(self, n_class: int) -> float:
        return 2.0 / n_class

    def replace(self, **kw) -> "GrandConfig":
        return dataclasses.replace(self, **kw)


def _p(**kw) -> GrandConfig:
    return GrandConfig(**kw)


# Per-dataset ppr-mode presets, transcribed from the reference launch scripts
# (scripts/run_cora.sh etc.; SURVEY.md Appendix A). avg/single variants are
# derived with `variant()` below.
PRESETS: dict[str, GrandConfig] = {
    "cora": _p(
        dataset="cora", order=20, alpha=0.2, rmax=1e-7, top_k=32,
        hidden=64, nlayers=2, lr=0.01, weight_decay=1e-3,
        batch_size=50, unlabel_batch_size=100, unlabel_num=-1,
        lam=1.5, tem=0.1, loss="l2", warmup=1000.0,
        input_droprate=0.5, hidden_droprate=0.7,
        use_bn=False, node_norm=False, clip_norm=-1.0,
        patience=200, stop_mode="both",
    ),
    "citeseer": _p(
        dataset="citeseer", order=10, alpha=0.4, rmax=1e-7, top_k=32,
        hidden=256, nlayers=2, lr=0.001, weight_decay=1e-3,
        batch_size=50, unlabel_batch_size=100, unlabel_num=-1,
        lam=0.8, tem=0.1, loss="l2", warmup=500.0,
        input_droprate=0.0, hidden_droprate=0.0,
        use_bn=False, node_norm=False, clip_norm=-1.0,
        patience=200, stop_mode="both",
    ),
    "pubmed": _p(
        dataset="pubmed", order=6, alpha=0.5, rmax=1e-5, top_k=16,
        hidden=64, nlayers=1, lr=0.01, weight_decay=1e-2,
        batch_size=5, unlabel_batch_size=100, unlabel_num=-1,
        lam=1.0, tem=0.1, loss="l2", warmup=100.0,
        input_droprate=0.2, hidden_droprate=0.2,
        use_bn=True, node_norm=True, clip_norm=0.1,
        patience=50, stop_mode="both",
    ),
    "aminer": _p(
        dataset="aminer", order=6, alpha=0.1, rmax=1e-5, top_k=64,
        hidden=64, nlayers=1, lr=0.01, weight_decay=1e-2,
        batch_size=20, unlabel_batch_size=100, unlabel_num=10000,
        lam=1.5, tem=0.1, loss="kl", warmup=100.0,
        input_droprate=0.0, hidden_droprate=0.0,
        use_bn=True, node_norm=False, clip_norm=-1.0,
        patience=10, stop_mode="acc",
    ),
    "reddit": _p(
        dataset="reddit", order=6, alpha=0.05, rmax=1e-5, top_k=64,
        hidden=512, nlayers=2, lr=1e-4, weight_decay=0.0,
        batch_size=50, unlabel_batch_size=200, unlabel_num=10000,
        lam=1.5, tem=0.1, loss="kl", warmup=500.0,
        input_droprate=0.0, hidden_droprate=0.0,
        use_bn=True, node_norm=True, clip_norm=0.1,
        patience=20, stop_mode="acc",
    ),
    "Amazon2M": _p(
        dataset="Amazon2M", order=6, alpha=0.2, rmax=1e-6, top_k=64,
        hidden=1024, nlayers=2, lr=1e-3, weight_decay=1e-5,
        batch_size=50, unlabel_batch_size=200, unlabel_num=10000,
        lam=0.8, tem=0.1, loss="kl", warmup=500.0,
        input_droprate=0.0, hidden_droprate=0.0,
        use_bn=True, node_norm=True, clip_norm=-1.0,
        patience=30, stop_mode="acc",
    ),
    "mag_scholar_c": _p(
        dataset="mag_scholar_c", order=10, alpha=0.2, rmax=1e-5, top_k=32,
        hidden=64, nlayers=2, lr=0.01, weight_decay=0.0,
        batch_size=20, unlabel_batch_size=20, unlabel_num=10000,
        lam=1.0, tem=0.1, loss="l2", warmup=1000.0,
        input_droprate=0.0, hidden_droprate=0.2,
        use_bn=False, node_norm=False, clip_norm=-1.0,
        patience=20, stop_mode="acc",
        sparse_features=True,
    ),
}


# avg/single variant overrides, transcribed from the same launch scripts
# (each dict entry replaces fields of the ppr-mode preset row)
VARIANTS: dict[tuple[str, str], dict] = {
    ("cora", "avg"): dict(order=4),
    ("cora", "single"): dict(order=2),
    ("citeseer", "avg"): dict(order=2),
    ("citeseer", "single"): dict(order=2),
    ("pubmed", "avg"): dict(order=4, warmup=1000.0),
    ("pubmed", "single"): dict(order=2, warmup=1000.0),
    ("aminer", "avg"): dict(order=4),
    ("aminer", "single"): dict(order=2),
    ("reddit", "avg"): dict(order=6),
    ("reddit", "single"): dict(order=2, rmax=1e-7),
    ("Amazon2M", "avg"): dict(order=4),
    ("Amazon2M", "single"): dict(order=2, top_k=32),
    ("mag_scholar_c", "avg"): dict(order=10),
    ("mag_scholar_c", "single"): dict(order=2),
}


def preset(dataset: str, prop_mode: str = "ppr",
           order: Optional[int] = None) -> GrandConfig:
    """Look up the preset for ``dataset`` and specialize the prop mode
    (avg/single variants apply the reference scripts' overrides)."""
    if dataset not in PRESETS:
        raise KeyError(
            f"no preset for dataset {dataset!r}; known: {sorted(PRESETS)}")
    cfg = PRESETS[dataset].replace(prop_mode=prop_mode)
    overrides = VARIANTS.get((dataset, prop_mode))
    if overrides:
        cfg = cfg.replace(**overrides)
    if order is not None:
        cfg = cfg.replace(order=order)
    return cfg

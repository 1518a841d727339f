"""Training engine: train/eval steps, the early-stopped host loop, the
``train`` entry point and its checkpoints."""

from grandtpu_torch.train.trainer import TrainResult, train  # noqa: F401

"""Training engine: train/eval steps, the early-stopped host loop and the
``train`` driver."""

from grandtpu_torch.train.trainer import TrainResult, train  # noqa: F401

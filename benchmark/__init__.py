"""The benchmark of ``grandtpu_torch``, the PyTorch and CUDA port of
GRAND+: cells driven by data (``configs/``, ``traffic/``, ``metrics/``,
``limits/``), run by ``python3 -m benchmark.run``."""

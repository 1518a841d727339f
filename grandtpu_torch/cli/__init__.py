"""Command-line driver: ``python -m grandtpu_torch.cli.main``."""

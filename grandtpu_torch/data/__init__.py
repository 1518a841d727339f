"""Dataset layer: ``synth:`` loader, stratified splits, self-loops (numpy/
scipy only)."""

from grandtpu_torch.data.registry import GraphData, load_data  # noqa: F401
from grandtpu_torch.data.synthetic import synthetic_graph  # noqa: F401

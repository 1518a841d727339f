"""Dataset layer: the file loaders and ``synth:`` graphs, splits,
preprocessing (numpy/scipy only)."""

from grandtpu_torch.data.registry import GraphData, load_data  # noqa: F401
from grandtpu_torch.data.synthetic import synthetic_graph  # noqa: F401

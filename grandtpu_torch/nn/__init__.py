"""Model layer: MLP classifier, DropNode random propagation (K1), losses,
and the MAG model with its embedding-bag input (K3)."""

from grandtpu_torch.nn.dropnode import gather_and_prop  # noqa: F401
from grandtpu_torch.nn.losses import consis_loss, nll_loss  # noqa: F401
from grandtpu_torch.nn.mag_mlp import MagMLP, init_mag_mlp  # noqa: F401
from grandtpu_torch.nn.mlp import MLP, MLPConfig, init_mlp  # noqa: F401
from grandtpu_torch.nn.sparse_input import (PaddedFeatures,  # noqa: F401
                                            embed_prop)

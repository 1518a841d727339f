"""GFPush precompute: row-sparse top-k approximation of the generalized
propagation matrix Pi = sum_n coef_n (D^-1 A)^n, by the native C++/OpenMP
kernel (host), the numpy oracle, or the dense- and sparse-residue pushes on
the card (CUDA kernels); ``cached_gfpush`` keeps results in an on-disk
cache under grandtpu's content key."""

from grandtpu_torch.ppr.api import gfpush  # noqa: F401
from grandtpu_torch.ppr.coef import build_coef  # noqa: F401
from grandtpu_torch.ppr.oracle import gfpush_numpy  # noqa: F401
from grandtpu_torch.ppr.cache import cached_gfpush  # noqa: F401

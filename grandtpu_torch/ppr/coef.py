"""Propagation coefficient vectors (copy of ``grandtpu/ppr/coef.py``).

Built Python-side and L1-normalized exactly like the reference driver
(``model.py:255-267``): Pi = sum_{n=0..order} coef_n (D^-1 A)^n.
"""

from __future__ import annotations

import numpy as np


def build_coef(prop_mode: str, order: int, alpha: float = 0.2) -> np.ndarray:
    """Length order+1 float64 coefficient vector, L1-normalized.

    ppr    : [alpha, alpha(1-a), ..., alpha(1-a)^order]  (truncated Neumann)
    avg    : all-ones
    single : one-hot on the last hop
    """
    if prop_mode == "avg":
        coef = np.ones(order + 1, dtype=np.float64)
    elif prop_mode == "ppr":
        coef = alpha * np.power(1.0 - alpha, np.arange(order + 1),
                                dtype=np.float64)
    elif prop_mode == "single":
        coef = np.zeros(order + 1, dtype=np.float64)
        coef[-1] = 1.0
    else:
        raise ValueError(f"unknown prop_mode {prop_mode!r}")
    return coef / coef.sum()

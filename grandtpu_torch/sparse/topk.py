"""Padded top-k propagation rows: the training-side sparse Pi.

Port of ``grandtpu/sparse/topk.py``: each GFPush source row owns exactly K
slots (cols, vals; padding has val 0 and contributes nothing to the
weighted mean), so a minibatch of B sources is a [B, K] gather. The tables
stay int32/f32 as in the reference; the K1 kernel takes them as they are.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TopKProp:
    """Top-k rows of Pi for a set of source nodes.

    sources : int32 [n_src]  global node id of each row
    cols    : int32 [n_src, K] global neighbor ids (0 where padded)
    vals    : float32 [n_src, K] propagation weights (0 where padded)
    num_nodes : global node count
    """

    sources: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    num_nodes: int

    def __post_init__(self):
        self.sources = np.asarray(self.sources, dtype=np.int32)
        self.cols = np.asarray(self.cols, dtype=np.int32)
        self.vals = np.asarray(self.vals, dtype=np.float32)
        # position of each global node id among the rows (-1 = absent)
        pos = np.full(self.num_nodes, -1, dtype=np.int32)
        pos[self.sources] = np.arange(self.sources.shape[0], dtype=np.int32)
        self._pos_of_node = pos

    @property
    def k(self) -> int:
        return self.cols.shape[1]

    def row_positions(self, node_ids: np.ndarray) -> np.ndarray:
        """Map global node ids -> row positions (raises if any is absent)."""
        pos = self._pos_of_node[np.asarray(node_ids, dtype=np.int64)]
        if np.any(pos < 0):
            missing = np.asarray(node_ids)[pos < 0][:5]
            raise KeyError(f"nodes without precomputed rows, e.g. {missing}")
        return pos

"""The degree-corrected stand-in (``graph.kind`` ``dcsbm``): a stochastic
block model whose degrees are heavy-tailed, as a social graph's are
(Karrer and Newman, Phys. Rev. E 83, 016107, 2011).

Node i has the weight theta_i = (r_i + 1 + ``degree_offset``) **
(-1 / (``degree_exponent`` - 1)), r a permutation of the nodes drawn from
``data_seed``, so that the hubs lie anywhere in the row order. Both ends of
a candidate pair are drawn in proportion to theta (inverse CDF over the
cumulative weights), same-class pairs are kept always and others with
1/``p_in_over_p_out``, self-loops dropped and repeats merged, and a random
subset of exactly ``edges`` pairs is kept. Expected degrees then fall off
as a power law of exponent ``degree_exponent``, flattened below the
``degree_offset``-th largest. Labels and features are those of the ``sbm``
kind (``standin.py``).

:func:`ensure` writes the stand-in once per checkout where
``standin.data_root`` looks for it, in the same file layout, so that the
port's loader, ``standin.raw_arrays``, the reference and ``control.read``
read it as they read the other stand-ins.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import numpy as np

from benchmark import standin


def weights(nodes: int, exponent: float, offset: float,
            rng: np.random.Generator) -> np.ndarray:
    """theta of every node (float64), ranked by a permutation from
    ``rng``."""
    ranks = rng.permutation(nodes).astype(np.float64)
    return (ranks + 1.0 + offset) ** (-1.0 / (exponent - 1.0))


def dcsbm_edges(nodes: int, edges: int, labels: np.ndarray,
                theta: np.ndarray, p_in_over_p_out: float,
                rng: np.random.Generator) -> np.ndarray:
    """Exactly ``edges`` distinct undirected pairs (u < v) as keys u*n + v,
    both ends drawn in proportion to ``theta``, same-class pairs kept
    always and others with 1/``p_in_over_p_out``, no self-loops."""
    cum = np.cumsum(theta)
    total = cum[-1]
    keep_share = 1.0 / p_in_over_p_out
    keys = np.empty(0, np.int64)
    chunk = min(1 << 24, int(edges * p_in_over_p_out) + 4096)
    while keys.size < edges:
        parts, kept = [keys], keys.size
        while kept < edges * 1.02 + 1024:
            ends = np.searchsorted(cum, rng.random(2 * chunk) * total,
                                   side="right")
            np.minimum(ends, nodes - 1, out=ends)
            src, dst = ends[:chunk], ends[chunk:]
            keep = labels[src] == labels[dst]
            keep |= rng.random(chunk, dtype=np.float32) < keep_share
            keep &= src != dst
            lo, hi = np.minimum(src, dst)[keep], np.maximum(src, dst)[keep]
            parts.append(lo * nodes + hi)
            kept += lo.size
            del ends, src, dst, keep, lo, hi
        keys = np.unique(np.concatenate(parts))
        del parts
    # a random subset of exactly `edges` pairs, not the smallest keys
    return np.sort(keys[rng.permutation(keys.size)[:edges]])


def generate(cfg: dict):
    """(adj csr without self-loops, features, int labels) of ``cfg``."""
    g = cfg["graph"]
    if g["kind"] != "dcsbm":
        raise ValueError(f"not a dcsbm stand-in: {g['kind']!r}")
    rng = np.random.default_rng(g["data_seed"])
    n, c, f = cfg["nodes"], cfg["classes"], cfg["features"]
    labels = np.arange(n, dtype=np.int64) % c
    rng.shuffle(labels)
    theta = weights(n, g["degree_exponent"], g["degree_offset"], rng)
    adj = standin.symmetric_csr(n, dcsbm_edges(
        n, cfg["edges"], labels, theta, g["p_in_over_p_out"], rng))
    proto = rng.standard_normal((c, f), dtype=np.float32)
    feats = rng.standard_normal((n, f), dtype=np.float32)
    feats *= np.float32(g["feature_noise"])
    feats += proto[labels]
    return adj, feats, labels


def write(cfg: dict, root: str) -> None:
    """Generate ``cfg``'s stand-in and move it into ``root`` whole."""
    tmp = root + ".partial"
    shutil.rmtree(tmp, ignore_errors=True)
    adj, feats, labels = generate(cfg)
    standin._write(cfg, adj, feats, labels, os.path.join(tmp, cfg["dataset"]))
    os.replace(tmp, root)


def ensure(cfg: dict, cache_root: str) -> str:
    """``standin.data_root(cfg, cache_root)``, the stand-in written there
    first, in a child process, if this checkout has none yet."""
    root = os.path.join(cache_root, f"{cfg['name']}-{standin.data_key(cfg)}")
    if not os.path.isdir(os.path.join(root, cfg["dataset"])):
        here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        subprocess.run([sys.executable, "-m", "benchmark.standin_dcsbm",
                        json.dumps(cfg), root], cwd=here, check=True)
    return standin.data_root(cfg, cache_root)


if __name__ == "__main__":
    write(json.loads(sys.argv[1]), sys.argv[2])

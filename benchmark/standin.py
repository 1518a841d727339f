"""The stand-in graphs of the benchmark's configurations.

No dataset file is in the repository, so each configuration names a
stochastic block model (SBM) at its own sizes, drawn from its fixed
``data_seed`` as a dataset is fixed: the communities are the labels, edges
join same-class pairs eight times as often as others, and the features are
class prototypes plus noise (``sbm``) or a class-banded bag of words whose
in-band ranks are Zipf-like (``sbm_bow``, the MAG regime). It follows
``grandtpu_torch/data/synthetic.py``'s model, drawn in chunks with numpy's
PCG64 so that the published edge count comes out exactly.

The first run in a checkout writes the graph in the file layout of the
port's loader (``load_data("Amazon2M")``'s ``<name>_adj.npz`` and
``_feat.npy``, ``load_data("mag_scholar_c")``'s npz of CSR arrays) under
``build/benchmark/data/<config>-<key>/``; every run reads it from there.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import scipy.sparse as sp

GENERATOR_VERSION = 1


def data_key(cfg: dict) -> str:
    """A key of everything that fixes the stand-in's bytes."""
    fixed = {k: cfg.get(k) for k in ("dataset", "nodes", "edges", "classes",
                                     "features", "graph")}
    fixed["version"] = GENERATOR_VERSION
    blob = json.dumps(fixed, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:12]


def sbm_edges(nodes: int, edges: int, labels: np.ndarray,
              p_in_over_p_out: float, rng: np.random.Generator
              ) -> np.ndarray:
    """Exactly ``edges`` distinct undirected pairs (u < v) as keys u*n + v,
    same-class pairs kept always and others with 1/``p_in_over_p_out``,
    no self-loops."""
    keys = np.empty(0, np.int64)
    chunk = min(1 << 25, int(edges * p_in_over_p_out) + 4096)
    while keys.size < edges:
        parts, kept = [keys], keys.size
        while kept < edges * 1.01 + 1024:
            src = rng.integers(0, nodes, chunk, dtype=np.int64)
            dst = rng.integers(0, nodes, chunk, dtype=np.int64)
            keep = labels[src] == labels[dst]
            keep |= rng.random(chunk, dtype=np.float32) < 1.0 / p_in_over_p_out
            keep &= src != dst
            lo, hi = np.minimum(src, dst)[keep], np.maximum(src, dst)[keep]
            parts.append(lo * nodes + hi)
            kept += lo.size
        keys = np.unique(np.concatenate(parts))
        del parts
    # a random subset of exactly `edges` pairs, not the smallest keys
    return np.sort(keys[rng.permutation(keys.size)[:edges]])


def symmetric_csr(nodes: int, keys: np.ndarray) -> sp.csr_matrix:
    """The symmetric 0/1 adjacency of the undirected pairs ``keys``."""
    lo, hi = np.divmod(keys, nodes)
    both = np.concatenate([lo * nodes + hi, hi * nodes + lo])
    del lo, hi
    both.sort()
    rows, cols = np.divmod(both, nodes)
    del both
    indptr = np.zeros(nodes + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=nodes), out=indptr[1:])
    return sp.csr_matrix((np.ones(cols.size, np.float32),
                          cols.astype(np.int32), indptr.astype(np.int32)),
                         shape=(nodes, nodes))


def bag_of_words(labels: np.ndarray, vocab: int, tokens: int,
                 uniform_frac: float, token_skew: float,
                 rng: np.random.Generator) -> sp.csr_matrix:
    """0/1 CSR [n, vocab]: each node's ``tokens`` ids from its class's band
    of the vocabulary (ranks Zipf-like with ``token_skew``), a share
    ``uniform_frac`` uniform over the vocabulary; repeats merged."""
    n = labels.shape[0]
    classes = int(labels.max()) + 1
    band = max(vocab // classes, 1)
    u = rng.random((n, tokens), dtype=np.float32)
    ranks = np.minimum((band * u ** (1.0 + token_skew)).astype(np.int64),
                       band - 1)
    in_band = np.minimum(ranks + labels[:, None] * band, vocab - 1)
    uniform = rng.integers(0, vocab, (n, tokens), dtype=np.int64)
    cols = np.where(rng.random((n, tokens), dtype=np.float32) < uniform_frac,
                    uniform, in_band)
    keys = np.unique(np.arange(n, dtype=np.int64)[:, None] * vocab + cols)
    rows, ids = np.divmod(keys, vocab)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return sp.csr_matrix((np.ones(ids.size, np.float32),
                          ids.astype(np.int32), indptr), shape=(n, vocab))


def generate(cfg: dict):
    """(adj csr without self-loops, features, int labels) of ``cfg``."""
    g = cfg["graph"]
    rng = np.random.default_rng(g["data_seed"])
    n, c = cfg["nodes"], cfg["classes"]
    labels = np.arange(n, dtype=np.int64) % c
    rng.shuffle(labels)
    adj = symmetric_csr(n, sbm_edges(n, cfg["edges"], labels,
                                     g["p_in_over_p_out"], rng))
    if g["kind"] == "sbm":
        f = cfg["features"]
        proto = rng.standard_normal((c, f), dtype=np.float32)
        feats = rng.standard_normal((n, f), dtype=np.float32)
        feats *= np.float32(g["feature_noise"])
        feats += proto[labels]
    elif g["kind"] == "sbm_bow":
        feats = bag_of_words(labels, cfg["features"], g["tokens_per_node"],
                             g["bow_uniform_frac"], g["token_skew"], rng)
    else:
        raise ValueError(f"unknown stand-in kind {g['kind']!r}")
    return adj, feats, labels


def _write(cfg: dict, adj, feats, labels, path: str) -> None:
    name = cfg["dataset"]
    os.makedirs(path)
    if cfg["engine"] == "dense":
        sp.save_npz(os.path.join(path, f"{name}_adj.npz"), adj,
                    compressed=False)
        np.save(os.path.join(path, f"{name}_feat.npy"), feats)
        np.save(os.path.join(path, f"{name}_labels.npy"), labels)
    else:
        arrays = {"labels": labels}
        for key, m in (("adj_matrix", adj), ("attr_matrix", feats)):
            arrays.update({f"{key}.data": m.data, f"{key}.indices": m.indices,
                           f"{key}.indptr": m.indptr,
                           f"{key}.shape": np.asarray(m.shape)})
        np.savez(os.path.join(path, f"{name}.npz"), **arrays)
    # on the disk before the first run's window opens, so that its writeback
    # does not share the host with the measured requests
    for f in os.listdir(path):
        with open(os.path.join(path, f), "rb") as fh:
            os.fsync(fh.fileno())


def data_root(cfg: dict, cache_root: str) -> str:
    """The directory the port's loader reads ``cfg``'s dataset from (its
    ``GRANDTPU_DATA_DIR``); written by the first run of the checkout, in a
    child process, so that the run that measures starts as every later run
    does (the generation's freed memory would otherwise serve its host
    allocations)."""
    root = os.path.join(cache_root, f"{cfg['name']}-{data_key(cfg)}")
    if not os.path.isdir(os.path.join(root, cfg["dataset"])):
        here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        subprocess.run([sys.executable, "-m", "benchmark.standin",
                        json.dumps(cfg), root], cwd=here, check=True)
    return root


def write(cfg: dict, root: str) -> None:
    """Generate ``cfg``'s stand-in and move it into ``root`` whole."""
    tmp = root + ".partial"
    shutil.rmtree(tmp, ignore_errors=True)
    adj, feats, labels = generate(cfg)
    _write(cfg, adj, feats, labels, os.path.join(tmp, cfg["dataset"]))
    os.replace(tmp, root)


def raw_arrays(cfg: dict, root: str) -> dict:
    """The stand-in's files as plain arrays, read with numpy and scipy
    alone (the reference's input): ``adj`` csr, ``features`` (dense array
    or csr) and ``labels``."""
    d = os.path.join(root, cfg["dataset"])
    name = cfg["dataset"]
    if cfg["engine"] == "dense":
        return {"adj": sp.load_npz(os.path.join(d, f"{name}_adj.npz")),
                "features": np.load(os.path.join(d, f"{name}_feat.npy")),
                "labels": np.load(os.path.join(d, f"{name}_labels.npy"))}
    with np.load(os.path.join(d, f"{name}.npz")) as z:
        mats = {key: sp.csr_matrix(
            (z[f"{key}.data"], z[f"{key}.indices"], z[f"{key}.indptr"]),
            shape=tuple(z[f"{key}.shape"])) for key in ("adj_matrix",
                                                        "attr_matrix")}
        return {"adj": mats["adj_matrix"], "features": mats["attr_matrix"],
                "labels": z["labels"]}


if __name__ == "__main__":
    write(json.loads(sys.argv[1]), sys.argv[2])

"""grandtpu_torch's config, synth loader and GFPush against grandtpu's.

Both packages get the same inputs; every comparison here is exact
equality, because the port copies the numpy code and the C++ kernel."""

import dataclasses

import numpy as np
import pytest

from grandtpu import config as jcfg
from grandtpu.data import load_data as jax_load_data
from grandtpu.data.preprocess import add_self_loops_adj as jax_self_loops
from grandtpu.ppr import build_coef as jax_build_coef
from grandtpu.ppr import gfpush as jax_gfpush

from grandtpu_torch import config as tcfg
from grandtpu_torch.data import load_data
from grandtpu_torch.data.preprocess import add_self_loops_adj
from grandtpu_torch.ppr import build_coef, gfpush


@pytest.mark.parametrize("spec", ["synth:100:2:8", "synth:300:4:16:sparse"])
def test_renormalize_option(spec):
    """``load_data(renormalize=True)``: D^-1/2 (A+I) D^-1/2 as grandtpu's
    (tests/test_data.py::test_renormalize_option), symmetric, with
    self-loop mass on the diagonal."""
    want = jax_load_data(spec, split_seed=0, renormalize=True)
    got = load_data(spec, split_seed=0, renormalize=True)
    assert (abs(got.adj - want.adj)).max() == 0
    assert (abs(got.adj - got.adj.T)).max() < 1e-6
    assert got.adj.diagonal().min() > 0
    assert (load_data(spec, split_seed=0).adj
            != jax_load_data(spec, split_seed=0).adj).nnz == 0


@pytest.mark.parametrize("spec,seed", [("synth:400:4:32", 0),
                                       ("synth:900:7:20", 42)])
def test_synth_loader_equal(spec, seed):
    want = jax_load_data(spec, split_seed=seed)
    got = load_data(spec, split_seed=seed)
    assert (got.adj != want.adj).nnz == 0
    np.testing.assert_array_equal(got.features, want.features)
    assert got.features.dtype == want.features.dtype == np.float32
    np.testing.assert_array_equal(got.labels, want.labels)
    for name in ("idx_train", "idx_val", "idx_test", "idx_unlabel"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    sl, jsl = add_self_loops_adj(got.adj), jax_self_loops(want.adj)
    assert (sl != jsl).nnz == 0


@pytest.mark.parametrize("mode", ["ppr", "avg", "single"])
def test_build_coef_equal(mode):
    np.testing.assert_array_equal(build_coef(mode, 6, 0.05),
                                  jax_build_coef(mode, 6, 0.05))


@pytest.mark.parametrize("backend", ["native", "numpy", "native:2"])
@pytest.mark.parametrize("mode", ["ppr", "avg"])
def test_gfpush_equal(backend, mode):
    """``native:2`` runs the native kernel on 2 OpenMP threads
    (``num_threads``), which must not change its output."""
    d = jax_load_data("synth:500:4:16", split_seed=1)
    adj = jax_self_loops(d.adj)
    sources = np.concatenate([d.idx_train, d.idx_val[:20]])
    backend, _, threads = backend.partition(":")
    kw = dict(prop_mode=mode, order=6, alpha=0.1, rmax=1e-5, k=16,
              backend=backend)
    want = jax_gfpush(adj, sources, **kw)
    got = gfpush(adj, sources, num_threads=int(threads or 0), **kw)
    np.testing.assert_array_equal(got.cols, want.cols)
    np.testing.assert_array_equal(got.vals, want.vals)
    np.testing.assert_array_equal(got.sources, want.sources)
    np.testing.assert_array_equal(got.row_positions(d.idx_val[:20]),
                                  want.row_positions(d.idx_val[:20]))


def test_config_and_presets_equal():
    assert ([f.name for f in dataclasses.fields(tcfg.GrandConfig)]
            == [f.name for f in dataclasses.fields(jcfg.GrandConfig)])
    assert (dataclasses.asdict(tcfg.GrandConfig())
            == dataclasses.asdict(jcfg.GrandConfig()))
    for name in jcfg.PRESETS:
        for mode in ("ppr", "avg", "single"):
            assert (dataclasses.asdict(tcfg.preset(name, mode))
                    == dataclasses.asdict(jcfg.preset(name, mode)))


def test_unported_inputs_raise(tmp_path, monkeypatch):
    """A file dataset whose files are missing raises FileNotFoundError, as
    grandtpu's loader does, naming the same missing file and
    $GRANDTPU_DATA_DIR; a name no family knows, NotImplementedError."""
    monkeypatch.setenv("GRANDTPU_DATA_DIR", str(tmp_path))
    for name in ("cora", "mag_scholar_c", "Amazon2M", "reddit", "aminer",
                 "cora_full"):
        with pytest.raises(FileNotFoundError, match="GRANDTPU_DATA_DIR") as e:
            load_data(name)
        with pytest.raises(FileNotFoundError) as want:
            jax_load_data(name)
        assert (str(e.value).split(" — ")[0]
                == str(want.value).split(" — ")[0])
    with pytest.raises(NotImplementedError, match="unknown dataset"):
        load_data("no_such_graph")

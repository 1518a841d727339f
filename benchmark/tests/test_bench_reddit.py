"""The reddit-predict cell on the CPU at a small size of its own: hub rows
that the operator splits, F 10 (not a multiple of 4), 5 classes. The CPU
path runs the plain versions of K2 and of its split, which the reference
follows to float32 rounding; the float2 kernel with the split at F 602 is
held to them by the card tests (``tests/test_torch_kernels_cuda.py``)."""

import copy

import numpy as np
import pytest

from benchmark import control, faults, harness, run, standin_dcsbm
from grandtpu_torch.sparse.spmm import default_split_cap

NAME = "reddit-predict"
# above the dense backend's 20,000 nodes; mean degree 20 (cap 512) and a
# degree offset of 10, so that ≈ 80 hub rows split
SMALL = {"cfg": {"nodes": 24000, "edges": 240000, "features": 10,
                 "hidden": 32, "classes": 5, "predict_batch_size": 4096,
                 "graph": {"kind": "dcsbm", "p_in_over_p_out": 8.0,
                           "feature_noise": 0.6, "degree_exponent": 2.1,
                           "degree_offset": 10, "data_seed": 7}},
         "traffic": {"rows_per_request": 64}}


def small_cfg() -> dict:
    cfg = copy.deepcopy(harness.cell(NAME, harness.manifest())[1])
    cfg.update(copy.deepcopy(SMALL["cfg"]))
    return cfg


def test_small_size_splits_hub_rows():
    adj = standin_dcsbm.generate(small_cfg())[0]
    deg = np.diff(adj.indptr) + 1
    cap = default_split_cap(adj.shape[0], int(deg.sum()))
    assert cap == 512 and (deg > cap).sum() >= 40


def test_reference_matches_cpu_path(root):
    result, compared, _ = run.run_cell(NAME, 2 ** 31 + 13, 0.5, False, "cpu",
                                       root=root, overrides=SMALL)
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] > 0
    assert compared["logit_gap"]["value"] <= 1e-6, compared


def test_control_exceeds_the_limit(root):
    # the control reads the stand-in a run of the cell has written
    standin_dcsbm.ensure(small_cfg(), harness.cache_dirs(root)["data"])
    numbers = control.read(NAME, 5, "cpu", root=root, overrides=SMALL)
    compared, correct = run.compare(NAME, numbers)
    assert not correct, compared


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_fault_is_not_correct(fault, root):
    with faults.planted(fault):
        result, compared, _ = run.run_cell(NAME, 7, 0.5, False, "cpu",
                                           root=root, overrides=SMALL)
    assert not result["correct"], compared

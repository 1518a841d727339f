"""Shared set-up of the benchmark's tests: small sizes of every cell, and a
checkout root of the tests' own, so that the stand-in data they write
stays out of the repository's build directory."""

import os
import shutil

import pytest
import torch

from benchmark import harness

# a few threads a test process: the runs are small, and several test
# workers share the cores
torch.set_num_threads(2)

# each cell at a size a CPU test run holds (the widths that matter to the
# numbers compared stay as published where they fit)
SMALL = {
    "amazon2m-predict": {
        "cfg": {"nodes": 24000, "edges": 120000, "features": 16,
                "hidden": 32, "classes": 5, "predict_batch_size": 4096},
        "traffic": {"rows_per_request": 64}},
    "mag-predict": {
        "cfg": {"nodes": 24000, "edges": 120000, "features": 3000,
                "hidden": 16, "predict_batch_size": 4096},
        "traffic": {"rows_per_request": 64}},
}


@pytest.fixture(scope="session")
def root(tmp_path_factory):
    """A checkout root holding BENCHMARK.json; its build/ gets the data."""
    d = tmp_path_factory.mktemp("checkout")
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), d)
    return str(d)


@pytest.fixture
def cuda():
    """Skips unless a CUDA card is present (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"

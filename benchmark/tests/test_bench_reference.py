"""The reference against the port's CPU path, through each cell's own
entry, at small sizes: every compared number far inside its limit."""

import pytest

from benchmark import run
from benchmark.tests.conftest import SMALL

# the CPU path runs the port's plain versions, which the reference follows
# to float32 rounding: far tighter than the cells' limits
TIGHT = {"logit_gap": 1e-6}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_reference_matches_cpu_path(name, root):
    result, compared, _ = run.run_cell(name, 2 ** 31 + 11, 0.5, False,
                                       "cpu", root=root,
                                       overrides=SMALL[name])
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] > 0
    for key, c in compared.items():
        assert c["value"] <= TIGHT[key], (key, c)

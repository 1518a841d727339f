"""The lower-precision control fails the comparison, and the fault a
predict cell can have turns ``correct`` false, at small sizes."""

import pytest

from benchmark import control, faults, run
from benchmark.tests.conftest import SMALL


@pytest.mark.parametrize("name", sorted(SMALL))
def test_control_fails(name, root):
    numbers = control.read(name, 5, "cpu", root=root, overrides=SMALL[name])
    compared, correct = run.compare(name, numbers)
    assert not correct, compared


@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("fault", faults.FAULTS)
def test_fault_is_not_correct(name, fault, root):
    with faults.planted(fault):
        result, compared, _ = run.run_cell(name, 7, 0.5, False, "cpu",
                                           root=root, overrides=SMALL[name])
    assert not result["correct"], compared


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SMALL))
def test_control_fails_on_card(name, root, cuda):
    numbers = control.read(name, 5, cuda, root=root, overrides=SMALL[name])
    compared, correct = run.compare(name, numbers)
    assert not correct, compared

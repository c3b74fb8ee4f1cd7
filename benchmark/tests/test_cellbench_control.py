"""The correctness control comes out not correct while the program comes
out correct, at tiny sizes on the CPU (the control
runs at the cells' own sizes on the card: python3 -m benchmark.control)."""

import pytest

from benchmark import control, harness
from benchmark.tests import cellbench_tiny


@pytest.fixture(scope="module")
def registry(tmp_path_factory):
    return cellbench_tiny.tiny_root(tmp_path_factory.mktemp("bench"))


def test_the_control_fails_and_the_program_passes(registry):
    cell, seed = cellbench_tiny.CELL, cellbench_tiny.SEED
    assert harness.run_cell(cell, seed, 0.1, False, registry, "cpu")["correct"]
    assert control.control_checks(cell, seed, registry, "cpu")["failed_as_it_must"]

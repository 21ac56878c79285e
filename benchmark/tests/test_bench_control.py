"""The control: the reference in the program's place, its U-Net in fp8
(the precision below the configurations' bfloat16), fails the cell's own
limits at a size a test holds; the half-batch fault fails the training
cells'. ``control.py`` reads the same at the cells' sizes on the card."""

import pytest

from benchmark import check, control, manifest
from benchmark.tests.tiny import CPU, tiny_cell

CELLS = [w["name"] for w in manifest.load_manifest()["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [11, 2**31 + 3])
def test_the_fp8_control_is_not_correct(workload, seed):
    cell = tiny_cell(workload, "bfloat16")
    numbers = control.readings(cell, seed, CPU, "fp8")
    numbers.pop("diagnostics", None)
    ok, table = check.verdict(numbers, cell.limits)
    assert not ok, table


@pytest.mark.parametrize("workload", [w for w in CELLS if w.startswith("train")])
def test_the_half_batch_fault_is_not_correct(workload):
    cell = tiny_cell(workload, "bfloat16")
    numbers = control.readings(cell, 5, CPU, "half_batch")
    numbers.pop("diagnostics", None)
    assert not check.verdict(numbers, cell.limits)[0]

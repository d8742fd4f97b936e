"""The control at a size a test run holds: the reference computed in fp8 (the
precision below the configurations' bf16) put in the program's place comes
out not correct against the cell's limits, on three seeds, while the
program in f32 comes out correct. On the card, at the cells' own sizes,
`python3 -m benchmark.control` gives the readings the limits are set
from (PERF.md)."""

import pytest

from benchmark import control, run
from benchmark.tests import cells
from benchmark.tests.test_bench_faults import OVERRIDES


@pytest.mark.parametrize("name", sorted(OVERRIDES))
@pytest.mark.parametrize("seed", [5, 2 ** 31 + 6, 77])
def test_control_fails_and_the_program_passes(name, seed):
    cell = cells.cell(name)
    limits = run.limits_of(name)
    got = control.readings(cell, seed, "cpu", True,
                           overrides=OVERRIDES[name])
    assert limits
    assert all(got["program"][k] <= lim for k, lim in limits.items()), got
    assert any(got["control"][k] > lim for k, lim in limits.items()), got

"""The control at each cell's own size, on the card: the reference in
float8 (one step below the configuration's bfloat16) in the program's
place must fail a compared number of the cell on every seed."""

import pytest

from conftest import BENCH, ROOT
from harness.core import Run, load_json, load_module

CELLS = [w["name"] for w in load_json(ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [104729, 2147483659, 7919000013])
def test_control_is_not_correct(card, workload, seed):
    run = Run(workload, seed, 1, False, ROOT)
    driver = load_module(BENCH / "drivers" / f"{run.traffic['driver']}.py",
                         "driver_" + run.traffic["driver"])
    driver.control(run)
    failing = {k: v for k, (v, limit) in run.compared.items() if v > limit}
    assert failing, run.compared

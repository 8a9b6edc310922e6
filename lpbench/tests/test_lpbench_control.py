"""The control, at a size a test run can hold: a whole run of each cell
with the port's float32 path switched on (the nearest precision below the
configurations' float64) comes out not correct, where every sound float64
run is correct."""
import pytest

from lpbench import harness

from .conftest import SERVE

SEEDS = [2**31 + 41, 2**31 + 42, 2**31 + 43]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["bmatch-netflix.solve", "bmatch-netflix.seq", "vcover-kron.solve"])
def test_control_fails_where_the_program_passes(name, seed, tiny):
    program = harness.run_cell(name, seed, 0.3, False, device="cpu", overrides=tiny[name])
    control = harness.run_cell(name, seed, 0.3, False, device="cpu", dtype="float32", overrides=tiny[name])
    assert program["correct"], program["checks"]
    assert not control["correct"], control["checks"]


def test_serve_control_fails(tiny, root_of):
    out = harness.run_cell(SERVE, SEEDS[0], 0.3, False, device="cpu", dtype="float32", overrides=tiny[SERVE],
                           root=root_of(SERVE))
    assert not out["correct"], out["checks"]

"""The search kernel's plan, compiled for the host.

``csrc/search_plan.cuh`` decides, on the host, how the step-size search
kernel (``csrc/linesearch_probe.cu``) sweeps the two sides of a probe: the
blocks of its co-resident grid a side, the most tiles a block sweeps, and
whether the blocks keep their tiles' inputs in shared memory from the
first sweep on ("held") or read them at every sweep ("streamed"). It uses
no CUDA type, so it is compiled here with the host's C++ compiler and held
against a Python statement of the same rule: at phase 3's, phase 6's and
vcover's shapes of ``chip_smoke.py`` on the H100's grid (132 SMs, two
blocks each), and at both edges of every threshold (one tile a block, the
proportional split, the most tiles held) on several grids. The card tests
(``tests/test_torch_cuda.py -k threshold``) run the kernel at the edges.
"""
import ctypes
import math
import shutil
import subprocess
from pathlib import Path

import pytest

HEADER = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "kernels" / "csrc" / "search_plan.cuh"
THREADS, CHUNK_BYTES, HELD_TILES = 256, 64, 3  # search_plan.cuh's constants
H100_GRID = 132 * 2

SHIM = r"""
#include "search_plan.cuh"
extern "C" void plan(long long ny, long long nz, int elem_bytes, int nb_max, int* out) {
  const rt::SearchPlan p = rt::search_plan(ny, nz, elem_bytes, nb_max);
  out[0] = p.gy;
  out[1] = p.gz;
  out[2] = p.tiles;
  out[3] = p.held;
}
"""


def llround(x: float) -> int:
    """C's llround for x >= 0: the nearest integer, halves away from zero."""
    f = math.floor(x)
    return f + 1 if x - f >= 0.5 else f


def plan_rule(ny: int, nz: int, elem_bytes: int, nb_max: int) -> tuple[int, int, int, int]:
    """The rule in words: tiles of 256 threads x 64 bytes; one block a tile
    while both sides fit in the grid, else the grid split in proportion to
    the sides' tiles (rounded, at least one block a side that has
    elements); held while no block sweeps more than three tiles."""
    tile = THREADS * (CHUNK_BYTES // elem_bytes)
    ty, tz = -(-ny // tile), -(-nz // tile)
    if ty + tz <= nb_max:
        gy, gz = ty, tz
    elif ty == 0 or tz == 0:
        gy, gz = (nb_max if ty else 0), (nb_max if tz else 0)
    else:
        gy = min(max(llround(float(nb_max) * float(ty) / float(ty + tz)), 1), nb_max - 1)
        gz = nb_max - gy
    per = max(-(-ty // gy) if gy else 0, -(-tz // gz) if gz else 0)
    return gy, gz, per, int(per <= HELD_TILES)


def edge_cases() -> list[tuple[int, int, int, int]]:
    """Both sides of every threshold, for each element size and grid."""
    cases = []
    for elem in (8, 4):
        tile = THREADS * (CHUNK_BYTES // elem)
        for g in (H100_GRID, 132, 512, 3):
            held = HELD_TILES * (g - 1)  # the most tiles a side of g - 1 blocks holds
            for tiles_y in (g - 1, g, 2 * (g - 1), held, held + 1, 5 * g):  # one tile a block, then the split
                for extra in (0, 1):
                    cases.append((tiles_y * tile + extra, 1, elem, g))
            cases.append((1, held * tile, elem, g))  # the covering side holds its tiles
            cases.append((1, held * tile + 1, elem, g))
            cases.append((5 * g * tile, 0, elem, g))  # a one-sided probe
    return cases


@pytest.fixture(scope="module")
def plan(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++ or c++) to build the plan")
    tmp = tmp_path_factory.mktemp("search_plan")
    (tmp / "plan.cpp").write_text(SHIM)
    lib = tmp / "libplan.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-I", str(HEADER.parent), "-o", str(lib),
                    str(tmp / "plan.cpp")], check=True, capture_output=True)
    c = ctypes.CDLL(str(lib))
    c.plan.argtypes = [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]

    def run(ny, nz, elem, nb_max):
        out = (ctypes.c_int * 4)()
        c.plan(ny, nz, elem, nb_max, out)
        return tuple(out)
    return run


@pytest.mark.parametrize("shape, elem, want", [
    ((497_959, 1), 8, (244, 1, 1, 1)),  # phase 3's bmatch state: one tile a block, held
    ((497_959, 1), 4, (122, 1, 1, 1)),
    ((1 << 20, 1), 8, (263, 1, 2, 1)),  # phase 6's bucket: two tiles a block, held
    ((1 << 20, 1), 4, (256, 1, 1, 1)),
    ((1, 1 << 22), 8, (1, 263, 8, 0)),  # vcover's bucket side: eight tiles a block, streamed
    ((1, 1 << 22), 4, (1, 263, 4, 0)),
], ids=["bmatch-f64", "bmatch-f32", "bucket-f64", "bucket-f32", "vcover-f64", "vcover-f32"])
def test_plan_at_the_smoke_shapes(plan, shape, elem, want):
    assert plan(*shape, elem, H100_GRID) == plan_rule(*shape, elem, H100_GRID) == want


@pytest.mark.parametrize("ny, nz, elem, nb_max", edge_cases())
def test_plan_matches_rule_at_thresholds(plan, ny, nz, elem, nb_max):
    got = plan(ny, nz, elem, nb_max)
    assert got == plan_rule(ny, nz, elem, nb_max)
    gy, gz, per, held = got
    assert gy + gz <= nb_max and (gy > 0) == (ny > 0) and (gz > 0) == (nz > 0)
    assert held == (per <= HELD_TILES)

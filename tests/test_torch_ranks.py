"""Rank groups for the port's distributed tests, over gloo on the CPU.

:func:`run_ranks` starts W ``python -c`` processes, each with its rank, a
``file://`` init under a temporary directory, gloo and a timeout, and
reads the one-line JSON report of each; jax is blocked in them. The other
distributed tests (``tests/test_torch_dist*.py``, the mesh case of
``tests/test_torch_lpserve.py``, the two-rank card test of
``tests/test_torch_cuda.py``) start their ranks with it. This file imports
neither jax nor ``repro``, and its own tests check the launcher's time
limit and the groups ``MeshPlan.build`` makes on four ranks.
"""
import json
import os
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import pytest

SRC = str(Path(__file__).resolve().parents[1] / "src")

# what every rank of run_ranks runs first: the group (gloo, file:// init,
# a timeout) and a one-line JSON report; jax cannot be imported
PRELUDE = """\
import sys; sys.modules["jax"] = None
import datetime, json
import torch, torch.distributed as dist
torch.set_num_threads(1)
RANK, WORLD = int(sys.argv[1]), int(sys.argv[2])
dist.init_process_group("gloo", init_method="file://" + sys.argv[3], rank=RANK, world_size=WORLD,
                        timeout=datetime.timedelta(seconds=float(sys.argv[4])))
"""


def run_ranks(code: str, world: int = 4, timeout: float = 240.0) -> list:
    """Run ``code`` (after :data:`PRELUDE`) in ``world`` processes over gloo;
    returns each rank's report, the JSON object its last stdout line holds.
    The ranks are killed, and the test fails, past ``timeout`` seconds, so a
    rank left waiting in a collective fails instead of hanging the suite."""
    prog = PRELUDE + textwrap.dedent(code) + "\ndist.destroy_process_group()\n"
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory() as tmp:
        init = os.path.join(tmp, "init")
        procs = [subprocess.Popen([sys.executable, "-c", prog, str(r), str(world), init, str(timeout / 2)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
                 for r in range(world)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.communicate()
            pytest.fail(f"ranks did not finish within {timeout} s")
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{err[-3000:]}"
    return [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]


GROUPS_CODE = """
from repro_torch.dist import MeshPlan

report = {"rank": RANK}
for pod, data in [(2, 2), (4, 1), (1, 4)]:
    mesh = MeshPlan(pod=pod, data=data).build()
    report[f"{pod}x{data}"] = {
        "pod_index": mesh.pod_index, "data_index": mesh.data_index,
        "pod_group": None if mesh.pod_group is None else dist.get_process_group_ranks(mesh.pod_group),
        "data_group": None if mesh.data_group is None else dist.get_process_group_ranks(mesh.data_group),
        "cached": MeshPlan(pod=pod, data=data).build() is mesh,
    }
try:
    MeshPlan(pod=2).build()
    report["mismatch"] = None
except ValueError as err:
    report["mismatch"] = str(err)
print(json.dumps(report))
"""


@pytest.fixture(scope="module")
def groups():
    return run_ranks(GROUPS_CODE, world=4)


@pytest.mark.parametrize("pod,data", [(2, 2), (4, 1), (1, 4)])
def test_mesh_groups_layout(groups, pod, data):
    """Row-major (pod, data) ranks, as the reference lays out its devices:
    rank = pod_index * data + data_index; a pod group is {d, data + d, ...},
    a data group {p * data, ..., p * data + data - 1}; an axis of one rank
    has no group; a plan is built once a process."""
    for r in groups:
        m = r[f"{pod}x{data}"]
        assert r["rank"] == m["pod_index"] * data + m["data_index"]
        want_pod = [p * data + m["data_index"] for p in range(pod)]
        want_data = [m["pod_index"] * data + d for d in range(data)]
        assert m["pod_group"] == (want_pod if pod > 1 else None)
        assert m["data_group"] == (want_data if data > 1 else None)
        assert m["cached"]


def test_plan_world_mismatch(groups):
    for r in groups:
        assert "needs 2 ranks" in r["mismatch"] and "init_process_group" in r["mismatch"]


def test_run_ranks_time_limit():
    """A rank that never finishes fails the test at the time limit instead
    of hanging the suite."""
    with pytest.raises(pytest.fail.Exception, match="did not finish"):
        run_ranks("import time\nif RANK == 1:\n    time.sleep(600)\nprint(json.dumps({}))\n", world=2,
                  timeout=4.0)

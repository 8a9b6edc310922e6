"""The last line's shape on tiny CPU runs with the kernels' plain versions,
and ``run.py``'s exits without a card or without the program."""
import json
import math
import os
import shutil
import subprocess
import sys

import pytest

from lpbench import harness, spec

from .conftest import SERVE

ROOT = spec.ROOT
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
NUMBER = (int, float)


def _number(x):
    return isinstance(x, NUMBER) and not isinstance(x, bool) and math.isfinite(x)


@pytest.mark.parametrize("name", CELLS + [SERVE])
def test_result_line_shape(name, tiny, root_of):
    out = harness.run_cell(name, 2**31 + 17, 0.5, False, device="cpu", overrides=tiny[name], root=root_of(name))
    log = out.pop("log")
    line = json.loads(json.dumps(out))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks", "the numbers compared come last"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    cell = spec.resolve(name, root_of(name))
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        got = line["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and _number(got["value"]) and got["value"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for c in line["checks"].values():
        assert _number(c["value"]) and _number(c["limit"]) and c["value"] <= c["limit"]
    assert [ln.split()[1] for ln in log[-len(line["checks"]):]] == list(line["checks"]), "checks end stderr"


@pytest.mark.parametrize("name", ["bmatch-netflix.solve", SERVE])
def test_traced_line_shape(name, tiny, root_of):
    """On the CPU there is no device trace: the device metrics are left out,
    never reported as 0; the program's counters are there."""
    out = harness.run_cell(name, 2**31 + 18, 0.5, True, device="cpu", overrides=tiny[name], root=root_of(name))
    cell = spec.resolve(name, root_of(name))
    assert set(out["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert not any(k.startswith(("device_idle", "lane_iter_ms", "roofline_share")) for k in out["metrics"])
    assert out["metrics"], "the program's counters are read"
    if cell.traffic["mode"] == "engine":
        assert "padding_waste" in out["metrics"]
        assert 0.0 <= out["metrics"]["padding_waste"]["value"] < 100.0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["device"]["window_s"] > 0


def _run_py(cwd, env_extra=None):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env_extra or {})}
    return subprocess.run([sys.executable, "lpbench/run.py", "--workload", "bmatch-netflix.solve", "--seed",
                           "4294967311", "--seconds", "1", "--trace", "0"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_no_card_no_result():
    r = _run_py(ROOT)
    assert r.returncode != 0 and "CUDA" in r.stderr
    assert not r.stdout.strip()


def test_without_the_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "lpbench", tmp_path / "lpbench", ignore=shutil.ignore_patterns("__pycache__"))
    r = _run_py(tmp_path)
    assert r.returncode != 0
    assert not r.stdout.strip()


@pytest.mark.cuda
def test_a_cell_on_the_card(tiny):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = harness.run_cell("vcover-kron.solve", 2**31 + 19, 1.0, True, device="cuda",
                           overrides=tiny["vcover-kron.solve"])
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0 and out["metrics"]["lane_iter_ms"]["value"] > 0
    assert 0 < out["metrics"]["roofline_share.solve"]["value"] <= 100

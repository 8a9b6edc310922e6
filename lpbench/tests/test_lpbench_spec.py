"""Every cell resolves to its files by name, and a cell made of new files
only is picked up without an edit."""
import json
import shutil

import pytest

from lpbench import harness, spec

ROOT = spec.ROOT
BENCH = spec.benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    cell = spec.resolve(name)
    cfg = cell.config
    assert (ROOT / cfg["entry"]["file"]).is_file()
    assert cfg["name"] == cfg["entry"]["name"]
    assert hasattr(spec.generator(cfg), "generate")
    assert hasattr(spec.roofline(cfg), "iteration_bytes")
    assert hasattr(spec.reference(cfg), "judge") and hasattr(spec.reference(cfg), "exact_optimum")
    assert cell.traffic["mode"] in ("solver", "engine")
    for m in cell.per_layer:
        assert hasattr(spec.metric_reader(m["name"]), "read")
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert m["moves"] in names, f"{m['name']} moves an end-to-end metric {name} reports"


def test_every_config_is_used_and_every_key_is_known():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    allowed = {"name", "source", "file", "reduced", "why"}
    for c in BENCH["configs"]:
        assert set(c) == allowed
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert set(cfg["reduced"]) == set(c["reduced"])
        assert cfg["source"] == c["source"]


def test_a_cell_of_new_files_only_is_picked_up(tmp_path, tiny):
    """Copy the benchmark, add a configuration, a mix, a metric and a cell
    as new files and entries, and run the cell on the CPU."""
    shutil.copytree(ROOT / "lpbench", tmp_path / "lpbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((ROOT / "lpbench/configs/bmatch-netflix.json").read_text())
    cfg.update(name="bmatch-small", labellings=0, params={**cfg["params"], **tiny["bmatch-netflix.solve"]["params"]})
    (tmp_path / "lpbench/configs/bmatch-small.json").write_text(json.dumps(cfg))
    (tmp_path / "lpbench/traffic/solve2.json").write_text(json.dumps(
        {"why": "two lanes", "mode": "solver", "clients": 1, "batch_width": 2}))
    (tmp_path / "lpbench/metrics/solves.py").write_text(
        "def read(rec):\n    return float(len(rec.window.answers))\n")
    bench["configs"].append({"name": "bmatch-small", "source": cfg["source"],
                             "file": "lpbench/configs/bmatch-small.json",
                             "reduced": [], "why": "a test's"})
    bench["workloads"].append({"name": "bmatch-small.solve2", "config": "bmatch-small", "traffic": "solve2",
                               "chips": 1, "why": "a test's"})
    bench["end_to_end"][0]["workloads"].append("bmatch-small.solve2")
    bench["per_layer"].append({"name": "solves", "unit": "solves", "better": "higher", "source": "host_clock",
                               "layer": "bound search", "moves": "solve_s", "workloads": ["bmatch-small.solve2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.resolve("bmatch-small.solve2", tmp_path)
    assert cell.config["name"] == "bmatch-small" and cell.traffic["batch_width"] == 2
    assert [m["name"] for m in cell.per_layer] == ["solves"]
    out = harness.run_cell("bmatch-small.solve2", 11, 0.5, True, device="cpu", root=tmp_path)
    assert out["correct"], out["checks"]
    assert out["metrics"]["solves"]["value"] >= 1

"""Resolve a cell of ``BENCHMARK.json`` to its files, by name.

A cell names a configuration and a traffic mix; the configuration's entry
names its file, which names its generator (``generators/<name>.py``) and
its LP family (``roofline/<family>.py``, ``reference/<family>.py``); the mix is
``traffic/<name>.json``; each per-layer metric is ``metrics/<name>.py``.
Nothing here lists a cell, a configuration, a mix or a metric: a new one
is a new file and a new entry. Every lookup is under ``root`` (the
checkout), its ``BENCHMARK.json`` and its ``lpbench/``.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration's file, with its BENCHMARK.json entry under "entry"
    traffic: dict  # the mix's file
    end_to_end: list  # the metric entries this cell reports with --trace 0
    per_layer: list  # ... and with --trace 1


def here(root: Path = ROOT) -> Path:
    return Path(root) / "lpbench"


def load_module(path: Path):
    """Import the Python file at ``path`` (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"lpbench_file_{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _reports(metric: dict, cell: str, e2e_of_cell: set) -> bool:
    """A metric with ``workloads`` is reported in those cells; one without,
    in every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    return moves is None or moves in e2e_of_cell


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def resolve(name: str, root: Path = ROOT) -> Cell:
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have: {', '.join(cells)})")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((Path(root) / entry["file"]).read_text())
    config["entry"] = entry
    traffic = json.loads((here(root) / "traffic" / f"{cell['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name=name, chips=int(cell["chips"]), config=config, traffic=traffic,
                end_to_end=e2e, per_layer=per_layer)


def generator(config: dict, root: Path = ROOT):
    return load_module(here(root) / "generators" / f"{config['generator']}.py")


def roofline(config: dict, root: Path = ROOT):
    return load_module(here(root) / "roofline" / f"{config['family']}.py")


def reference(config: dict, root: Path = ROOT):
    """The plain reference of the configuration's LP family."""
    return load_module(here(root) / "reference" / f"{config['family']}.py")


def metric_reader(name: str, root: Path = ROOT):
    return load_module(here(root) / "metrics" / f"{name}.py")


def load_peaks(root: Path = ROOT) -> dict:
    """The table of peaks, by the name ``torch.cuda.get_device_name()`` gives."""
    return json.loads((here(root) / "peaks.json").read_text())["devices"]

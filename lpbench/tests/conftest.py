"""The benchmark's tests run on the CPU with the kernels' plain versions:
the checkout's root (``lpbench``) and ``src`` (``repro_torch``) on the path,
and tiny sizes for every cell."""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: a serving cell of the load generator's engine mode (``traffic/serve.json``),
#: which no cell of ``BENCHMARK.json`` runs yet: the tests add it as entries
SERVE = "vcover-kron.serve"

#: per cell, the sizes a CPU run can hold (the same shapes, far fewer rows)
TINY = {
    "bmatch-netflix.solve": {"params": {"n_users": 600, "n_items": 40, "avg_ratings": 12}, "config": {"labellings": 2}},
    "bmatch-netflix.seq": {"params": {"n_users": 600, "n_items": 40, "avg_ratings": 12}, "config": {"labellings": 2}},
    "vcover-kron.solve": {"params": {"scale": 7}},
    SERVE: {"pool": [{"scale": 4}, {"scale": 5}], "traffic": {"clients": 2, "lanes": 2, "drain_s": 30}},
}


@pytest.fixture
def tiny():
    return TINY


@pytest.fixture
def serve_root(tmp_path):
    """A copy of the benchmark with the serving cell and ``lp_per_s`` added
    as entries only."""
    shutil.copytree(ROOT / "lpbench", tmp_path / "lpbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": SERVE, "config": "vcover-kron", "traffic": "serve", "chips": 1,
                               "why": "a test's"})
    bench["end_to_end"].append({"name": "lp_per_s", "unit": "LP/s", "better": "higher", "bound": 0.25,
                                "source": "host_clock", "workloads": [SERVE]})
    bench["per_layer"].append({"name": "padding_waste", "unit": "%", "better": "lower",
                               "source": "program_counter", "layer": "engine", "moves": "lp_per_s",
                               "workloads": [SERVE]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


@pytest.fixture
def root_of(serve_root):
    """The checkout a cell's run resolves in."""
    return lambda name: serve_root if name == SERVE else ROOT

"""Nothing the benchmark runs imports JAX or the JAX package (``repro``),
compared by whole top-level names, so ``repro_torch`` is not caught; the
reference imports nothing of the program."""
import ast
import subprocess
import sys

import pytest

from lpbench import spec

HERE = spec.here()
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


def _top_names(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                names.add(str(arg.value).split(".")[0])
    return names


def test_the_check_compares_whole_names(tmp_path):
    sample = tmp_path / "sample.py"
    sample.write_text("import repro_torch.api\nfrom repro_torch import kernels\nimport jaxtyping\n")
    assert not _top_names(sample) & FORBIDDEN
    sample.write_text("import os\nfrom repro.api import Solver\n")
    assert _top_names(sample) & FORBIDDEN == {"repro"}


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not _top_names(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = _top_names(path)
    assert not names & (FORBIDDEN | {"repro_torch", "lpbench"}), names
    assert names <= {"__future__", "numpy", "scipy", "torch"}, names


def test_a_run_loads_no_jax(tiny):
    code = (
        "import sys, json; sys.path[:0] = [sys.argv[1], sys.argv[1] + '/src']\n"
        "from lpbench import harness\n"
        "harness.run_cell('vcover-kron.solve', 5, 0.2, False, device='cpu', overrides=json.loads(sys.argv[2]))\n"
        "print(json.dumps(harness.forbidden_modules()))\n"
    )
    import json

    r = subprocess.run([sys.executable, "-c", code, str(spec.ROOT), json.dumps(tiny["vcover-kron.solve"])],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []

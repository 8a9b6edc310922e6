"""repro_torch.tracecheck.astlint: each RPR code fires on a fixture, the
port's tree is clean, noqa suppresses per line, and the lint never
imports torch or jax. One test for each test of tests/test_astlint.py
(same intent, same name where it makes sense), plus the framework held
against the reference's: RPR000, RPR006 and noqa give the same findings
as ``repro.tracecheck.astlint.lint_source`` on the same sources."""
import os
import subprocess
import sys

import pytest

from repro.tracecheck import astlint as ref_astlint
from repro_torch.tracecheck.astlint import RPR_RULES, format_findings, lint_paths, lint_source
from repro_torch.tracecheck.astlint import main as astlint_main

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir, "src"))

_CORE = '''\
import os
import warnings

import torch


def loop(y: torch.Tensor, n):
    flag = os.environ.get("REPRO_FLAG")  # outside a loop: no finding
    for _ in range(n):
        on = torch.cuda.is_available()
        env = os.environ["REPRO_FLAG"]
        m = y.min()
        if m > 0:
            break
        v = m.item()
    return y.to(torch.float64), flag, on, env, v


def wait():
    torch.cuda.synchronize()


def old_api():
    warnings.warn("old_api is deprecated", DeprecationWarning)
'''

_OPS = '''\
from .. import loader


def thing(x):
    return loader.kernel_fn("rt_thing", x.dtype)(x.data_ptr())


@loader.counted("thing", lambda r, x: {})
def counted_thing(x):
    return _launch(x)


def _launch(x):
    return loader.kernel_fn("rt_thing", x.dtype)(x.data_ptr())
'''


def _fixture_tree(tmp_path):
    # core/ for RPR001-RPR003, a kernel wrapper module for RPR005
    (tmp_path / "core").mkdir()
    (tmp_path / "core" / "fixture.py").write_text(_CORE)
    (tmp_path / "kernels" / "thing").mkdir(parents=True)
    (tmp_path / "kernels" / "thing" / "ops.py").write_text(_OPS)
    return tmp_path


def test_fixture_trips_every_rule(tmp_path):
    findings = lint_paths([str(_fixture_tree(tmp_path))])
    codes = [f.code for f in findings]
    assert set(codes) == set(RPR_RULES), format_findings(findings)
    assert set(RPR_RULES) == {f"RPR00{i}" for i in range(1, 7)}
    # RPR001 for the device query and the env read in the loop, not the one before it
    assert codes.count("RPR001") == 2
    # RPR002 for the branch on a tensor and the .item() in the loop
    assert codes.count("RPR002") == 2
    # RPR005 for the uncounted wrapper only: the counted one's private helper is covered
    assert [f.symbol for f in findings if f.code == "RPR005"] == ["thing"]


def test_ast_cli_exits_nonzero_on_fixture(tmp_path):
    assert astlint_main([str(_fixture_tree(tmp_path))]) == 1


def test_source_tree_is_clean():
    findings = lint_paths([os.path.join(SRC, "repro_torch")])
    assert findings == [], format_findings(findings)


def test_package_cli_ast_defaults_to_clean_tree():
    """`python -m repro_torch.tracecheck --ast` (no paths) lints the package."""
    from repro_torch.tracecheck.__main__ import main

    assert main(["--ast"]) == 0


def test_noqa_suppresses_per_line():
    src = (
        "import torch\n"
        "def f(y: torch.Tensor, n):\n"
        "    for _ in range(n):\n"
        "        r = y.tolist()  # repro: noqa[RPR002] the loop's one read\n"
        "    return r\n"
    )
    assert lint_source(src, "core/mod.py") == []
    # without the annotation the same source is a finding
    assert [f.code for f in lint_source(src.replace("  # repro: noqa[RPR002] the loop's one read", ""),
                                        "core/mod.py")] == ["RPR002"]


def test_shape_and_none_branches_are_not_host_reads():
    """Branches on static facts of a tensor (shape, dtype, None, isinstance,
    len) read nothing from the card."""
    src = (
        "import torch\n"
        "def f(x: torch.Tensor, mask, ts):\n"
        "    while len(ts):\n"
        "        t = ts.pop()\n"
        "        if mask is None or isinstance(t, int):\n"
        "            continue\n"
        "        if x.shape[0] % 8 and x.dtype == torch.float32:\n"
        "            x = x + t\n"
        "    return x\n"
    )
    assert lint_source(src, "core/mod.py") == []


def test_branch_on_derived_tensor_value_fires():
    src = (
        "import torch\n"
        "def f(x: torch.Tensor, n):\n"
        "    for _ in range(n):\n"
        "        y = x + 1\n"
        "        if y:\n"
        "            return y\n"
        "    return x\n"
    )
    findings = lint_source(src, "core/mod.py")
    assert [f.code for f in findings] == ["RPR002"]
    assert findings[0].line == 5


def test_astlint_never_imports_torch_or_jax():
    """`python -m repro_torch.tracecheck --ast` runs with torch and jax made
    unimportable, and exits 0 on src/repro_torch."""
    prog = (
        "import sys, runpy; sys.path.insert(0, sys.argv[1]); "
        "sys.modules['torch'] = None; sys.modules['jax'] = None; sys.modules['numpy'] = None; "
        "sys.argv = ['repro_torch.tracecheck', '--ast', sys.argv[2]]; "
        "runpy.run_module('repro_torch.tracecheck', run_name='__main__')"
    )
    out = subprocess.run([sys.executable, "-c", prog, SRC, os.path.join(SRC, "repro_torch")], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "astlint: clean" in out.stdout


def test_astlint_file_runs_directly():
    """The file runs without the package importable (its ``__main__``)."""
    path = os.path.join(SRC, "repro_torch", "tracecheck", "astlint.py")
    out = subprocess.run([sys.executable, path, os.path.join(SRC, "repro_torch")], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# ------------------------------------------------ the port's rules, one each --
@pytest.mark.parametrize("line, flagged", [
    ("os.environ['X']", False),  # outside a loop of core/: fine
    ("torch.cuda.current_device()", False),
])
def test_rpr001_core_outside_loops_is_fine(line, flagged):
    src = f"import os\nimport torch\ndef f():\n    return {line}\n"
    assert bool(lint_source(src, "core/mod.py")) == flagged


def test_rpr001_anywhere_in_a_kernel_wrapper_module():
    src = "import torch\ndef plan(device=None):\n    return device or torch.cuda.current_device()\n"
    assert [f.code for f in lint_source(src, "kernels/thing/ops.py")] == ["RPR001"]
    # the same source elsewhere (a kernel's plain version) is not a wrapper module
    assert lint_source(src, "kernels/thing/ref.py") == []


@pytest.mark.parametrize("expr", ["float(y.sum())", "int(y.argmax())", "bool(y.any())", "y.cpu()", "y.numpy()"])
def test_rpr002_each_host_read_in_a_loop(expr):
    src = f"import torch\ndef f(y: torch.Tensor, n):\n    for _ in range(n):\n        v = {expr}\n    return v\n"
    assert [f.code for f in lint_source(src, "core/mod.py")] == ["RPR002"]
    # the router's module is in scope; the LM plane's other modules are not
    assert [f.code for f in lint_source(src, "models/layers/moe.py")] == ["RPR002"]
    assert lint_source(src, "models/layers/mlp.py") == []


def test_rpr002_comprehension_is_a_loop_but_a_read_of_its_result_is_not():
    src = (
        "import torch\n"
        "def f(ts):\n"
        "    once = torch.stack([t.min() for t in ts]).tolist()\n"
        "    each = [t.item() for t in ts]\n"
        "    return once, each\n"
    )
    findings = lint_source(src, "core/mod.py")
    assert [(f.code, f.line) for f in findings] == [("RPR002", 4)]


def test_rpr002_host_values_are_not_tensors():
    """float() of a host value read once (a list from tolist) reads nothing."""
    src = (
        "import torch\n"
        "def f(rec: torch.Tensor, n):\n"
        "    r = rec.tolist()\n"
        "    for k in range(n):\n"
        "        v = float(r[k]) + int(len(r))\n"
        "    return v\n"
    )
    assert lint_source(src, "core/mod.py") == []


def test_rpr003_dtype_tests_and_tables_are_not_widenings():
    src = (
        "import numpy as np\n"
        "import torch\n"
        "TABLE = {torch.float32: 'f32', torch.float64: 'f64'}\n"
        "NAMES = ('float64', np.float64)\n"
        "def f(x):\n"
        "    if x.dtype == torch.float64 or x.dtype in (torch.float32, torch.double):\n"
        "        return x\n"
        "    return x.to(torch.double), np.asarray([1.0], dtype=np.float64), x.to(dtype='float64')\n"
    )
    findings = lint_source(src, "kernels/mod.py")
    assert [(f.code, f.line) for f in findings] == [("RPR003", 8)] * 3
    # outside kernels/, core/ and models/ nothing is flagged
    assert lint_source(src, "graphs/mod.py") == []


def test_rpr004_synchronize_anywhere_unless_sanctioned():
    src = "import torch\ndef timed(run):\n    run()\n    torch.cuda.synchronize()\n"
    assert [f.code for f in lint_source(src, "lpserve/mod.py")] == ["RPR004"]
    assert lint_source(src.replace("synchronize()", "synchronize()  # repro: noqa[RPR004] a wall clock"),
                       "lpserve/mod.py") == []


def test_rpr005_only_in_kernel_wrapper_modules():
    assert [f.code for f in lint_source(_OPS, "kernels/thing/ops.py")] == ["RPR005"]
    assert lint_source(_OPS, "kernels/loader.py") == []
    counted = _OPS.replace("def thing(x):", "@loader.counted('thing', None)\ndef thing(x):")
    assert lint_source(counted, "kernels/thing/ops.py") == []


def test_rpr005_uncounted_caller_of_a_private_launcher_is_flagged():
    src = _OPS + "\n\ndef other(x):\n    return _launch(x)\n"
    assert sorted(f.symbol for f in lint_source(src, "kernels/thing/ops.py")) == ["other", "thing"]


def test_every_kernel_wrapper_of_the_port_is_counted():
    """RPR005 over the real wrappers, with a counted decorator removed: the
    lint names that wrapper."""
    path = os.path.join(SRC, "repro_torch", "kernels", "axpy_reduce", "ops.py")
    src = open(path).read()
    assert lint_source(src, "kernels/axpy_reduce/ops.py") == []
    stripped = "\n".join(line for line in src.splitlines() if not line.startswith("@loader.counted"))
    assert [f.symbol for f in lint_source(stripped, "kernels/axpy_reduce/ops.py")] == ["axpy_reduce"]


def test_the_mwu_loop_read_is_the_one_sanctioned_loop_read():
    """core/mwu.py lints clean only through its annotations: the loop's read
    of the lane record is RPR002 without its noqa."""
    path = os.path.join(SRC, "repro_torch", "core", "mwu.py")
    src = open(path).read()
    assert lint_source(src, "core/mwu.py") == []
    bare = [line.split("  # repro: noqa")[0] for line in src.splitlines()]
    findings = lint_source("\n".join(bare), "core/mwu.py")
    assert {f.code for f in findings} == {"RPR002", "RPR003"}
    reads = [f for f in findings if f.code == "RPR002"]
    assert len(reads) == 1 and "rec.tolist()" in bare[reads[0].line - 1] and reads[0].symbol == "_run"


# -------------------------------------------------- held against the reference --
_REFERENCE_SOURCES = {
    "syntax-error": ("def f(:\n    pass\n", "core/mod.py"),
    "syntax-error-late": ("x = 1\ny = (\n", "mod.py"),
    "deprecation-module": ("import warnings\nwarnings.warn('old', DeprecationWarning)\n", "mod.py"),
    "deprecation-function": ("import warnings\ndef f():\n    warnings.warn('old', category=DeprecationWarning)\n",
                             "api/mod.py"),
    "deprecation-method": ("from warnings import warn\nclass A:\n    def f(self):\n        warn('x', DeprecationWarning)\n",
                           "core/mod.py"),
    "deprecation-nested": ("import warnings\ndef f():\n    def g():\n        warnings.warn('x', DeprecationWarning)\n"
                           "    return g\n", "mod.py"),
    "deprecation-sanctioned": ("import warnings\nwarnings.warn('old', DeprecationWarning)\n", "utils/deprecation.py"),
    "deprecation-noqa": ("import warnings\nwarnings.warn('old', DeprecationWarning)  # repro: noqa[RPR006]\n",
                         "mod.py"),
    "deprecation-other-noqa": ("import warnings\nwarnings.warn('old', DeprecationWarning)  # repro: noqa[RPR001]\n",
                               "mod.py"),
    "deprecation-two-codes": ("import warnings\n"
                              "warnings.warn('old', DeprecationWarning)  # repro: noqa[RPR003, RPR006]\n", "mod.py"),
    "user-warning": ("import warnings\nwarnings.warn('not a deprecation', UserWarning)\n", "mod.py"),
}


@pytest.mark.parametrize("case", sorted(_REFERENCE_SOURCES))
def test_rpr000_rpr006_and_noqa_match_the_reference(case):
    src, rel = _REFERENCE_SOURCES[case]
    port = [f.as_dict() for f in lint_source(src, rel)]
    ref = [f.as_dict() for f in ref_astlint.lint_source(src, rel)]
    assert port == ref
    expect_finding = case.startswith("syntax") or case in ("deprecation-module", "deprecation-function",
                                                           "deprecation-method", "deprecation-nested",
                                                           "deprecation-other-noqa")
    assert bool(port) == expect_finding


def test_framework_matches_the_reference():
    """The same finding class, fingerprints and report format."""
    a = lint_source("def f(:\n", "core/mod.py")[0]
    b = ref_astlint.lint_source("def f(:\n", "core/mod.py")[0]
    assert (a.fingerprint, a.as_dict()) == (b.fingerprint, b.as_dict())
    assert format_findings([a]) == ref_astlint.format_findings([b])
    assert format_findings([]) == ref_astlint.format_findings([]) == "astlint: clean"
    assert ref_astlint.RPR_RULES.keys() == RPR_RULES.keys()

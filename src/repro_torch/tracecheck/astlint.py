"""AST lint over the port's source (the RPR rule codes).

Port of ``repro.tracecheck.astlint``. The recorded-run passes in
:mod:`.rules` check what an entry point *does*; this module checks the
*source* for the patterns that produce those regressions, in seconds and
without torch: importing this module must never pull in torch or jax.

The framework is the reference's, kept whole: :class:`AstFinding`,
:func:`lint_source` / :func:`lint_file` / :func:`lint_paths` /
:func:`format_findings`, ``RPR000`` for a file that does not parse, and
per-line suppression with no baseline. The rules are recast for eager
PyTorch, where there is no trace to freeze a value into and the tensor's
device decides where a kernel runs:

``RPR001``  ``os.environ`` / ``os.getenv`` / ``torch.cuda.is_available()``
            / ``torch.cuda.current_device()`` read inside a loop body of
            ``core/`` or anywhere in a kernel wrapper module
            (``kernels/*/ops.py``): the tensor's device decides, not the
            process's state.
``RPR002``  a host read inside a loop body of ``core/``,
            ``kernels/*/ops.py`` or ``models/layers/moe.py``: ``.item()``,
            ``.tolist()``, ``.cpu()``, ``.numpy()``, ``float()`` / ``int()``
            / ``bool()`` of a tensor, or an ``if`` / ``while`` on a tensor.
            Each one waits for the card and copies to the host, once a
            loop iteration. Which names hold tensors is inferred within a
            function (parameters annotated ``Tensor``, values of
            ``torch.*`` calls and of expressions over such names); a loop
            body is a ``for`` / ``while`` body or a comprehension's.
``RPR003``  a bare ``torch.float64`` / ``torch.double`` / ``np.float64``
            (or the string ``'float64'``) in ``kernels/``, ``core/`` or
            ``models/``: the solver is dtype-generic, and a hard-coded f64
            widens every op downstream. A dtype test (an operand of a
            comparison) and an entry of a literal dtype table are not
            widenings and are not flagged.
``RPR004``  ``torch.cuda.synchronize()`` outside a sanctioned read site:
            a synchronize stalls the host on the card as a read does.
``RPR005``  a wrapper in ``kernels/*/ops.py`` that reaches
            ``loader.kernel_fn`` (itself or through the module's private
            helpers) without ``@loader.counted``: the op counter
            (``utils.opcount``), and the cost model and the kernel-path
            rule on it, see a kernel only through that decorator. It takes
            the place of the reference's static-argument rule, which has
            no meaning without ``jit``.
``RPR006``  ``warnings.warn(..., DeprecationWarning)`` outside
            :mod:`repro_torch.utils.deprecation`: deprecations funnel
            through ``warn_once``.

Suppression is per line: append ``# repro: noqa[RPR002]`` (comma-separated
codes), with the reason beside it, to the flagged line. The sanctioned
sites of the port (the MWU loop's reads, its f64 record) carry such
annotations.

CLI: ``python -m repro_torch.tracecheck --ast [paths...]`` (default: the
``repro_torch`` package), or this file run directly; exits nonzero on any
unsuppressed finding.
"""
from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass

__all__ = [
    "RPR_RULES",
    "AstFinding",
    "lint_source",
    "lint_file",
    "lint_paths",
    "format_findings",
]

RPR_RULES = {
    "RPR001": "device or env query inside a core loop body or a kernel wrapper module",
    "RPR002": "host read inside a loop body of the solver's hot path",
    "RPR003": "bare float64 literal in kernel/core/model module",
    "RPR004": "torch.cuda.synchronize outside a sanctioned read site",
    "RPR005": "kernel wrapper launches without @loader.counted",
    "RPR006": "DeprecationWarning not routed through utils.deprecation.warn_once",
}

_RPR003_SCOPES = ("kernels", "core", "models")  # package dirs of repro_torch
_RPR006_SANCTIONED = "utils/deprecation.py"

_NOQA_RE = re.compile(r"#\s*repro:\s*noqa\[([A-Z0-9, ]+)\]")

_F64_CHAINS = frozenset({"torch.float64", "torch.double", "np.float64", "numpy.float64"})
_DEVICE_QUERIES = frozenset({"cuda.is_available", "cuda.current_device"})
_READ_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
_READ_BUILTINS = frozenset({"float", "int", "bool"})
# attributes and methods of a tensor whose value is a host value, not a tensor
_STATIC_ATTRS = frozenset({"shape", "dtype", "device", "ndim", "is_cuda", "is_floating_point", "requires_grad",
                           "name", "T_"})
_HOST_METHODS = frozenset({"item", "tolist", "numpy", "size", "dim", "numel", "element_size", "data_ptr",
                           "is_contiguous", "stride", "storage_offset", "nelement", "is_floating_point"})
# torch.* functions whose result is not a tensor
_HOST_TORCH = frozenset({"finfo", "iinfo", "promote_types", "result_type", "device", "is_tensor", "Size",
                         "get_default_dtype", "is_grad_enabled", "Generator", "dtype"})
_LOOPS = (ast.For, ast.AsyncFor, ast.While)
_COMPREHENSIONS = (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)
_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)


@dataclass
class AstFinding:
    """One source-level rule violation (the stdlib sibling of rules.Finding)."""

    code: str
    path: str
    line: int
    col: int
    message: str
    symbol: str = ""

    @property
    def fingerprint(self) -> str:
        sym = self.symbol or f"L{self.line}"
        return f"{self.code}::{self.path}::{sym}"

    def as_dict(self) -> dict:
        return {
            "code": self.code,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "fingerprint": self.fingerprint,
        }


def _attr_chain(node: ast.AST) -> str:
    """Dotted name of an attribute/name chain ('' when not a plain chain)."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _tail(chain: str) -> str:
    return chain.rsplit(".", 1)[-1] if chain else ""


def _is_env_read(node: ast.AST) -> bool:
    """os.environ[...] / os.environ.get(...) / os.getenv(...) /
    torch.cuda.is_available() / torch.cuda.current_device()."""
    if isinstance(node, ast.Call):
        chain = _attr_chain(node.func)
        if chain.endswith("os.getenv") or chain == "getenv" or chain.endswith("environ.get"):
            return True
        if any(chain == q or chain.endswith("." + q) for q in _DEVICE_QUERIES):
            return True
    if isinstance(node, ast.Subscript):
        chain = _attr_chain(node.value)
        if chain.endswith("os.environ") or chain == "environ":
            return True
    return False


def _own_nodes(roots) -> list:
    """The nodes under ``roots``, not descending into nested function,
    lambda or class scopes (a nested scope's body does not run where it is
    defined)."""
    out, stack = [], list(roots)
    while stack:
        n = stack.pop()
        out.append(n)
        if isinstance(n, _SCOPES):
            continue
        stack.extend(ast.iter_child_nodes(n))
    return out


def _loop_nodes(fn) -> list:
    """The nodes of ``fn``'s own body that run once a loop iteration: the
    bodies of its ``for`` / ``while`` loops (a ``while``'s test too) and its
    comprehensions' elements and conditions."""
    out, seen = [], set()
    for n in _own_nodes(fn.body):
        if isinstance(n, _LOOPS):
            roots = list(n.body) + ([n.test] if isinstance(n, ast.While) else [])
        elif isinstance(n, _COMPREHENSIONS):
            roots = ([n.key, n.value] if isinstance(n, ast.DictComp) else [n.elt])
            roots += [c for g in n.generators for c in g.ifs]
        else:
            continue
        for m in _own_nodes(roots):
            if id(m) not in seen:
                seen.add(id(m))
                out.append(m)
    return out


class _Tensors:
    """The names of one function that hold tensors, by a forward pass over
    its assignments (module docstring, RPR002)."""

    def __init__(self, fn):
        self.names: set[str] = set()
        args = fn.args
        for a in list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs):
            if a.annotation is not None and "Tensor" in ast.unparse(a.annotation):
                self.names.add(a.arg)
        body = fn.body if isinstance(fn.body, list) else [fn.body]
        for _ in range(2):  # a loop may assign a name before the line that makes it a tensor
            for n in _own_nodes(body):
                if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign)) and n.value is not None \
                        and self.tensor(n.value):
                    targets = n.targets if isinstance(n, ast.Assign) else [n.target]
                    for t in targets:
                        self.names.update(x.id for x in ast.walk(t) if isinstance(x, ast.Name))
                elif isinstance(n, (ast.For, ast.AsyncFor)) and self.tensor(n.iter):
                    self.names.update(x.id for x in ast.walk(n.target) if isinstance(x, ast.Name))

    def tensor(self, expr: ast.AST) -> bool:
        """Whether ``expr`` evaluates to a tensor (as far as the names say)."""
        if isinstance(expr, ast.Call):
            chain = _attr_chain(expr.func)
            head = _tail(chain)
            if chain.startswith("torch.") and chain.count(".") == 1:
                return head not in _HOST_TORCH
            if isinstance(expr.func, ast.Name) and head in _READ_BUILTINS | {"len", "isinstance", "hasattr",
                                                                               "callable", "range", "enumerate"}:
                return False
            if isinstance(expr.func, ast.Attribute) and expr.func.attr in _HOST_METHODS:
                return False
            if isinstance(expr.func, ast.Attribute):
                return self.tensor(expr.func.value)
            return False
        if isinstance(expr, ast.Attribute):
            return expr.attr not in _STATIC_ATTRS and self.tensor(expr.value)
        if isinstance(expr, ast.Name):
            return expr.id in self.names
        if isinstance(expr, (ast.BinOp, ast.UnaryOp, ast.Compare, ast.Subscript, ast.IfExp, ast.BoolOp)):
            if isinstance(expr, ast.Compare) and any(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                                                     for op in expr.ops):
                return False
            if isinstance(expr, ast.Subscript):
                return self.tensor(expr.value)
            return any(self.tensor(c) for c in ast.iter_child_nodes(expr) if isinstance(c, ast.expr))
        return False

    def branches(self, test: ast.AST) -> bool:
        """Whether an ``if`` / ``while`` on ``test`` reads a tensor's truth."""
        if isinstance(test, ast.BoolOp):
            return any(self.branches(v) for v in test.values)
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return self.branches(test.operand)
        return self.tensor(test)


class _Linter(ast.NodeVisitor):
    def __init__(self, rel: str, source: str):
        self.rel = rel.replace(os.sep, "/")
        self.findings: list[AstFinding] = []
        self.scope: list[str] = []
        self.noqa = self._noqa_lines(source)
        parts = self.rel.split("/")
        self.in_rpr003_scope = any(p in _RPR003_SCOPES for p in parts[:-1])
        self.in_core = "core" in parts[:-1]
        self.is_ops = len(parts) >= 3 and parts[-1] == "ops.py" and parts[-3] == "kernels"
        self.hot = self.in_core or self.is_ops or self.rel.endswith("models/layers/moe.py")
        self.rpr006_ok = self.rel.endswith(_RPR006_SANCTIONED)

    @staticmethod
    def _noqa_lines(source: str) -> dict[int, set[str]]:
        out: dict[int, set[str]] = {}
        for i, line in enumerate(source.splitlines(), start=1):
            m = _NOQA_RE.search(line)
            if m:
                out[i] = {c.strip() for c in m.group(1).split(",") if c.strip()}
        return out

    def emit(self, code: str, node: ast.AST, message: str, symbol: str = ""):
        line = getattr(node, "lineno", 0)
        if code in self.noqa.get(line, ()):
            return
        self.findings.append(AstFinding(
            code=code, path=self.rel, line=line,
            col=getattr(node, "col_offset", 0), message=message, symbol=symbol,
        ))

    # -- module pass: RPR005 ----------------------------------------------
    def visit_Module(self, node):
        if self.is_ops:
            self._check_rpr005(node)
        self.generic_visit(node)

    # -- per-function passes: RPR001 (core loops), RPR002 ------------------
    def _function(self, node):
        self.scope.append(node.name)
        name = ".".join(self.scope)
        if self.hot:
            loop = _loop_nodes(node)
            if self.in_core:
                for sub in loop:
                    if _is_env_read(sub):
                        self.emit("RPR001", sub, f"device/env query inside a loop of `{name}` — the tensor's "
                                                 "device decides where the work runs", symbol=name)
            self._check_rpr002(node, name, loop)
        self.generic_visit(node)
        self.scope.pop()

    visit_FunctionDef = _function
    visit_AsyncFunctionDef = _function

    def _check_rpr002(self, fn, name: str, loop: list):
        tensors = _Tensors(fn)
        for sub in loop:
            what = None
            if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute) and sub.func.attr in _READ_METHODS:
                what = f"`.{sub.func.attr}()`"
            elif isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name) and sub.func.id in _READ_BUILTINS \
                    and len(sub.args) == 1 and tensors.tensor(sub.args[0]):
                what = f"`{sub.func.id}()` of a tensor"
            elif isinstance(sub, (ast.If, ast.While, ast.IfExp)) and tensors.branches(sub.test):
                what = f"`{'while' if isinstance(sub, ast.While) else 'if'}` on a tensor"
            if what is not None:
                self.emit("RPR002", sub, f"host read ({what}) inside a loop of `{name}` — it waits for the card "
                                         "once a loop iteration; keep the value on the device", symbol=name)

    # -- node checks -------------------------------------------------------
    def visit_Call(self, node):
        chain = _attr_chain(node.func)
        if self.is_ops and _is_env_read(node):
            self.emit("RPR001", node, f"device query `{chain}()` in a kernel wrapper module — the tensor's "
                                      "device decides", symbol=".".join(self.scope))
        if chain == "torch.cuda.synchronize" or chain == "cuda.synchronize":
            self.emit("RPR004", node, "torch.cuda.synchronize() outside a sanctioned read site — it stalls "
                                      "the host on the card as a read does", symbol=".".join(self.scope))
        self._check_rpr006(node)
        self.generic_visit(node)

    def visit_Subscript(self, node):
        if self.is_ops and _is_env_read(node):
            self.emit("RPR001", node, "os.environ read in a kernel wrapper module — the tensor's device decides",
                      symbol=".".join(self.scope))
        self.generic_visit(node)

    # -- RPR003: bare float64 literals ------------------------------------
    def visit_Compare(self, node):
        for c in [node.left] + list(node.comparators):  # dtype tests: not widenings
            self._skip_literals(c)

    def _skip_literals(self, node):
        """Visit ``node`` with its own float64 literals exempt (dtype tests
        and dtype tables), its calls still checked."""
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            for e in node.elts:
                self._skip_literals(e)
        elif isinstance(node, ast.Dict):
            for e in list(node.keys) + list(node.values):
                if e is not None:
                    self._skip_literals(e)
        elif not (_attr_chain(node) in _F64_CHAINS or _is_f64_string(node)):
            self.visit(node)

    visit_Tuple = visit_List = visit_Set = _skip_literals
    visit_Dict = _skip_literals

    def visit_Attribute(self, node):
        chain = _attr_chain(node)
        if self.in_rpr003_scope and chain in _F64_CHAINS:
            self.emit("RPR003", node, f"bare `{chain}` literal — derive the wide dtype from the inputs "
                                      "(torch.promote_types) so the solver stays dtype-generic")
        self.generic_visit(node)

    def visit_Constant(self, node):
        if self.in_rpr003_scope and _is_f64_string(node):
            self.emit("RPR003", node, "bare 'float64' dtype string — derive the dtype from the inputs")

    # -- RPR005: kernel wrappers are counted -------------------------------
    def _check_rpr005(self, module: ast.Module):
        fns = {n.name: n for n in module.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        calls = {name: {_tail(_attr_chain(c.func)) for c in ast.walk(fn) if isinstance(c, ast.Call)}
                 for name, fn in fns.items()}
        counted = {name for name, fn in fns.items()
                   if any(_tail(_attr_chain(d.func if isinstance(d, ast.Call) else d)) == "counted"
                          for d in fn.decorator_list)}

        def reaches(name, seen=()):
            if "kernel_fn" in calls[name]:
                return True
            return any(reaches(c, seen + (name,)) for c in calls[name] if c in fns and c not in seen + (name,))

        callers = {name: [c for c in fns if name in calls[c] and c != name] for name in fns}

        def covered(name, seen=()):
            if name in counted:
                return True
            if not name.startswith("_") or not callers[name] or name in seen:
                return False
            return all(covered(c, seen + (name,)) for c in callers[name])

        for name, fn in fns.items():
            if reaches(name) and not covered(name) and (not name.startswith("_") or not callers[name]):
                self.emit("RPR005", fn, f"`{name}` launches a kernel (loader.kernel_fn) without "
                                        "@loader.counted — the op counter and the cost model cannot see it",
                          symbol=name)

    # -- RPR006 ------------------------------------------------------------
    def _check_rpr006(self, node: ast.Call):
        if self.rpr006_ok:
            return
        chain = _attr_chain(node.func)
        if chain not in ("warnings.warn", "warn"):
            return
        refs = list(node.args) + [kw.value for kw in node.keywords]
        for arg in refs:
            for n in ast.walk(arg):
                if isinstance(n, (ast.Name, ast.Attribute)) and _tail(_attr_chain(n)) == "DeprecationWarning":
                    self.emit(
                        "RPR006", node,
                        "DeprecationWarning raised directly — route through "
                        "utils.deprecation.warn_once so it fires once per process",
                        symbol=".".join(self.scope),
                    )
                    return


def _is_f64_string(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and isinstance(node.value, str) and node.value == "float64"


def lint_source(source: str, rel_path: str, path: str = "") -> list[AstFinding]:
    """Lint one module's source text; ``rel_path`` keys the scope rules
    (``path`` is accepted for the reference's signature and unused)."""
    try:
        tree = ast.parse(source)
    except SyntaxError as exc:
        return [AstFinding(
            code="RPR000", path=rel_path.replace(os.sep, "/"),
            line=exc.lineno or 0, col=exc.offset or 0,
            message=f"syntax error: {exc.msg}",
        )]
    linter = _Linter(rel_path, source)
    linter.visit(tree)
    return sorted(linter.findings, key=lambda f: (f.path, f.line, f.code))


def lint_file(path: str, root: str | None = None) -> list[AstFinding]:
    rel = os.path.relpath(path, root) if root else path
    with open(path, encoding="utf-8") as f:
        return lint_source(f.read(), rel, path)


def lint_paths(paths: list[str]) -> list[AstFinding]:
    """Lint every ``.py`` under each path (files are linted directly)."""
    findings: list[AstFinding] = []
    for p in paths:
        if os.path.isfile(p):
            findings.extend(lint_file(p, root=os.path.dirname(p) or "."))
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    findings.extend(lint_file(os.path.join(dirpath, fn), root=p))
    return findings


def format_findings(findings: list[AstFinding]) -> str:
    if not findings:
        return "astlint: clean"
    lines = [f"{f.path}:{f.line}:{f.col}: {f.code} {f.message}" for f in findings]
    lines.append(f"astlint: {len(findings)} finding(s)")
    return "\n".join(lines)


def default_root() -> str:
    """The ``repro_torch`` package directory."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(paths: list[str] | None = None) -> int:
    """Entry point shared by ``--ast`` and direct execution
    (``python src/repro_torch/tracecheck/astlint.py [paths...]`` works
    without the package importable)."""
    findings = lint_paths(paths or [default_root()])
    print(format_findings(findings))
    return 1 if findings else 0


if __name__ == "__main__":  # pragma: no cover
    import sys

    sys.exit(main(sys.argv[1:] or None))

"""Rule/report framework and the solver's performance-invariant rules.

Port of ``repro.tracecheck.rules``. A :class:`TraceArtifact` is one
recorded entry point: its eager run on the device the case names, as the
op stream that :mod:`.capture`'s recorder saw, split into solves, loop
iterations and lane iterations (one lane's ``core.mwu._iteration``), with
each lane iteration's kernel calls, collectives, host reads, output dtypes
and op counts, plus the expectations computed at capture time from host
facts. A :class:`Rule` inspects one artifact and yields :class:`Finding`s;
:func:`run_rules` applies the default set.

The rules (each guards one way the per-iteration cost of the paper's loop
regresses):

``host-reads-in-loop``  exactly one host read a loop iteration, for all
                        lanes: ``core/mwu.py``'s read of the lane record.
                        Checked from the second iteration on: the first may
                        also build an operator's cached CSR at its first
                        card product (vcover's covering side, whose scatter
                        runs first in the loop), once an operator. The
                        loop's other reads are once a solve (``_start``
                        and ``_finalize``: the MoE router's two reads a
                        layer). ``solve_traced``'s rows come from that same
                        read, and a traced artifact must carry them (the
                        reference's ``io_callback``, allowed and required).
``kernel-path``         each lane iteration calls (CPU) or launches (card)
                        2 softmax, 1 step direction, 1 search and 3 axpy,
                        plus the gathers and (on the card) the scatters of
                        its operators' products, and no lone gather where
                        the packing side has a gather form. Batched lanes
                        launch the kernels too: the port has no custom_vmap
                        exemption (the reference's vmapped lanes take its
                        XLA batch rule), by design.
``loop-collectives``    a lane iteration's collectives equal the plan's:
                        two ``psum`` and one ``pmax`` under a pod-sharded
                        plan (the reference's ``_POD_COLLECTIVES``), none
                        under identity and data plans. Counted a *lane*
                        iteration: ``_iteration`` all_reduces max(d) once a
                        lane (``core/mwu.py``), where the reference's vmap
                        issues one collective for all lanes (ROADMAP 13b).
``dtype-discipline``    no op of an f32 solve's loop outputs f64, but the
                        lane record row and the lane's last step (alpha),
                        which are f64 by design.
``trip-count``          a case forced not to converge runs exactly
                        ``max_iter`` lane iterations a lane: every lane the
                        loop stopped at its cap ran ``max_iter``, and every
                        lane ran as many as the loop counted for it (a lane
                        that ends infeasible or covered stops earlier).
``smem-footprint``      every kernel entry of the compiler's log
                        (``loader.build_log()``, ``-Xptxas -v``) within 227
                        KB of shared memory a block, 255 registers and no
                        spills: the card's counterpart of
                        ``vmem-footprint``. Two kinds of entry may spill,
                        each named with its reason in :data:`SPILL_ALLOWED`:
                        the f32 flash body at d 256, and the search's
                        stamped timing instantiation, which no wrapper
                        launches.

Adding a rule: subclass :class:`Rule`, implement ``check(artifact)``,
append an instance to :data:`DEFAULT_RULES`. Give repeated findings a
stable ``key`` so one baseline entry (:mod:`.report`) covers them.
"""
from __future__ import annotations

import re
from collections import Counter
from dataclasses import dataclass, field
from typing import Any

__all__ = [
    "ERROR",
    "WARNING",
    "Finding",
    "LaneIteration",
    "LoopIteration",
    "SolveRecord",
    "TraceArtifact",
    "Rule",
    "DEFAULT_RULES",
    "run_rules",
    "parse_ptxas",
    "entry_name",
    "SMEM_BYTES_PER_BLOCK",
    "MAX_REGISTERS",
]

ERROR = "error"
WARNING = "warning"

SMEM_BYTES_PER_BLOCK = 227 * 1024  # H100: the most shared memory one block may take
MAX_REGISTERS = 255  # a thread's registers on sm_90
# entries that may spill, each with its reason
SPILL_ALLOWED = {
    re.compile(r"flash_f32_kernelILi256E"): "the f32 flash body at d 256 (chip_smoke.flash_ptxas prints it)",
    re.compile(r"search_kernelI[fd]NS_\d+\w+ControlELb1E"): "the search's stamped timing instantiation "
    "(kStamp), which only tools/search_ab.py launches: its clock stamps take the registers",
}

_FLOAT_BYTES = {"float16": 2, "bfloat16": 2, "float32": 4, "float64": 8}


@dataclass
class Finding:
    """One rule violation on one artifact.

    ``fingerprint`` identifies the violation *class* stably across runs
    (no counts that drift), so a baseline allowlist entry keeps covering it.
    """

    rule: str
    severity: str
    artifact: str
    message: str
    key: str = ""
    detail: dict = field(default_factory=dict)

    @property
    def fingerprint(self) -> str:
        return f"{self.rule}::{self.artifact}" + (f"::{self.key}" if self.key else "")

    def as_dict(self) -> dict:
        return {
            "rule": self.rule,
            "severity": self.severity,
            "artifact": self.artifact,
            "message": self.message,
            "fingerprint": self.fingerprint,
            "detail": dict(self.detail),
        }


@dataclass
class LaneIteration:
    """One lane's ``core.mwu._iteration``: its op tokens (:mod:`.diff`),
    kernel calls by name, collectives by kind (``psum``, ``pmax``, ...),
    host reads, the dtypes its ops output (but the lane record's and
    alpha's), its op counts (an ``utils.opcount.OpReport``) and the kernel
    calls it should make."""

    lane: int
    tokens: list = field(default_factory=list)
    kernels: Counter = field(default_factory=Counter)
    collectives: Counter = field(default_factory=Counter)
    reads: list = field(default_factory=list)
    outputs: Counter = field(default_factory=Counter)  # (op, dtype) -> outputs
    report: Any = None
    expected: Counter | None = None  # the kernel calls its operators and step rule need (capture's)


@dataclass
class LoopIteration:
    """One iteration of the MWU loop: its lanes' iterations, and what ran
    outside them (``tokens``, the loop's read last), with its reads."""

    lanes: list = field(default_factory=list)
    tokens: list = field(default_factory=list)
    reads: list = field(default_factory=list)

    def all_reads(self) -> list:
        return list(self.reads) + [r for ln in self.lanes for r in ln.reads]


@dataclass
class SolveRecord:
    """One ``core.mwu`` solve: ``_start``'s tokens, the loop, ``_finalize``'s."""

    start: list = field(default_factory=list)
    iterations: list = field(default_factory=list)
    finalize: list = field(default_factory=list)
    reads: dict = field(default_factory=dict)  # segment -> reads there ("start", "finalize")
    stops: dict = field(default_factory=dict)  # lane -> (why it stopped: infeasible | covered | cap, its iterations)

    def lane_iterations(self) -> dict:
        """{lane: its LaneIterations, in order}."""
        out: dict = {}
        for it in self.iterations:
            for ln in it.lanes:
                out.setdefault(ln.lane, []).append(ln)
        return out


@dataclass
class TraceArtifact:
    """One recorded entry point plus the expectations the rules enforce.

    ``expect`` keys read by the default rules:

    * ``traced``      -- the entry returns ``solve_traced``'s rows
      (``trace_rows``: how many it returned);
    * ``kernels``     -- {kernel: calls} a lane iteration (absent: no check);
      ``kernels_anywhere`` for a loop-free kernel artifact;
    * ``collectives`` -- {kind: count} a lane iteration (missing = {});
    * ``dtype``       -- the solve dtype; wider float outputs are leaks;
    * ``trips``       -- lane iterations every lane must run (a case forced
      not to converge: its ``max_iter``).
    """

    name: str
    device: str = "cpu"
    solves: list = field(default_factory=list)
    outside: list = field(default_factory=list)  # tokens recorded outside any solve
    kernels_outside: Counter = field(default_factory=Counter)
    opts: Any = None  # core.mwu.MWUOptions
    plan: Any = None  # dist.mesh.MeshPlan
    pod_mode: str | None = None
    expect: dict = field(default_factory=dict)
    trace_rows: int | None = None
    ptxas: str | None = None  # compiler log text (kernel artifacts on the card)

    def lane_iterations(self) -> list:
        """Every lane iteration of every solve, in order."""
        return [ln for s in self.solves for it in s.iterations for ln in it.lanes]

    def steady_iteration(self, solve: int = 0):
        """The loop iteration the parity proof and the cost model read: the
        second (the first allocates the kernels' scratch), or the only one."""
        its = self.solves[solve].iterations if len(self.solves) > solve else []
        return its[1] if len(its) > 1 else (its[0] if its else None)


class Rule:
    """Base class: one invariant, checked per artifact."""

    name: str = "rule"
    description: str = ""

    def check(self, art: TraceArtifact) -> list[Finding]:  # pragma: no cover
        raise NotImplementedError

    def finding(self, art, message, *, key="", severity=ERROR, **detail) -> Finding:
        return Finding(
            rule=self.name, severity=severity, artifact=art.name,
            message=message, key=key, detail=detail,
        )


# ------------------------------------------------------------------ rules --
class HostReadsRule(Rule):
    """One host read a loop iteration, for all lanes (module docstring)."""

    name = "host-reads-in-loop"
    description = "exactly one host read a steady loop iteration (core/mwu.py's read of the lane record)"

    def check(self, art):
        out = []
        extra: Counter = Counter()
        for s in art.solves:
            for it in s.iterations[1:]:
                reads = it.all_reads()
                if "loop" in reads:
                    reads.remove("loop")
                extra.update(reads)
        for what, n in sorted(extra.items()):
            out.append(self.finding(
                art, f"{n} `{what}` host read(s) inside the MWU loop beyond its one read an iteration — "
                     "every loop iteration now waits for the card more than once",
                key=what, count=n,
            ))
        if art.expect.get("traced"):
            lanes = art.solves[0].lane_iterations() if art.solves else {}
            iters = len(next(iter(lanes.values()), []))
            if art.trace_rows != iters:
                out.append(self.finding(
                    art, f"solve_traced expected but its rows ({art.trace_rows}) are not the loop's "
                         f"{iters} iterations", key="missing-trace-hook", severity=WARNING,
                ))
        return out


class KernelPathRule(Rule):
    """Each lane iteration calls the kernel wrappers the capture expects."""

    name = "kernel-path"
    description = "kernel calls a lane iteration match the loop's and its operators' kernels"

    def check(self, art):
        out = []
        if "kernels_anywhere" in art.expect:
            want = Counter(art.expect["kernels_anywhere"])
            got = Counter(art.kernels_outside)
            for ln in art.lane_iterations():
                got.update(ln.kernels)
            if want - got:
                out.append(self.finding(art, f"kernel entry point ran without its kernel: {dict(want - got)}",
                                        key="missing", want=dict(want), got=dict(got)))
            return out
        forced = art.expect.get("kernels")
        missing: Counter = Counter()
        unexpected: Counter = Counter()
        want: Counter = Counter()
        for ln in art.lane_iterations():
            lane_want = ln.expected if forced is None else Counter(forced)
            if lane_want is None:  # a host step rule: its probes depend on the data
                continue
            want = +lane_want
            missing |= want - ln.kernels
            unexpected |= ln.kernels - want
        where = "launched on the card" if art.device == "cuda" else "called"
        if missing:
            out.append(self.finding(
                art, f"a lane iteration {where} fewer kernels than its loop and operators need: "
                     f"{dict(missing)} short of {dict(want)} — a kernel path silently fell back",
                key="missing", want=dict(want), missing=dict(missing),
            ))
        if unexpected:
            out.append(self.finding(
                art, f"a lane iteration {where} kernels beyond {dict(want)}: {dict(unexpected)}",
                key="unexpected", want=dict(want), unexpected=dict(unexpected),
            ))
        return out


class LoopCollectivesRule(Rule):
    """A lane iteration's collectives == what the mesh plan declares."""

    name = "loop-collectives"
    description = "collectives a lane iteration match the declared MeshPlan (2 psum + 1 pmax pod-sharded)"

    def check(self, art):
        expected = {k: int(v) for k, v in art.expect.get("collectives", {}).items() if v}
        for ln in art.lane_iterations():
            got = dict(ln.collectives)
            if got != expected:
                mode = art.pod_mode or "identity"
                return [self.finding(
                    art,
                    f"collectives a lane iteration {got or '{}'} != declared {expected or '{}'} for "
                    f"pod mode `{mode}` — per-iteration communication changed",
                    expected=expected, got=got, pod_mode=mode,
                )]
        return []


class DtypeRule(Rule):
    """No op of the loop outputs a float wider than the solve dtype."""

    name = "dtype-discipline"
    description = "no f64 op outputs in an f32 solve's loop (but the lane record row and alpha)"

    def check(self, art):
        expected = art.expect.get("dtype", "float32")
        width = _FLOAT_BYTES.get(expected, 8)
        if width >= 8:  # an f64 solve has nothing wider to leak into
            return []
        leaks: Counter = Counter()
        for ln in art.lane_iterations():
            for (op, dt), n in ln.outputs.items():
                if _FLOAT_BYTES.get(dt, 0) > width:
                    leaks[op] += n
        if not leaks:
            return []
        return [self.finding(
            art, f"ops of the loop output floats wider than the {expected} solve dtype: {dict(leaks)}",
            key="ops", leaks=dict(leaks),
        )]


class TripCountRule(Rule):
    """A case forced not to converge runs max_iter lane iterations a lane."""

    name = "trip-count"
    description = "every lane of a case forced not to converge runs MWUOptions.max_iter iterations"

    def check(self, art):
        want = art.expect.get("trips")
        if want is None:
            return []
        if not art.solves:
            return [self.finding(art, "no MWU loop was recorded — the entry point no longer reaches core.mwu",
                                 key="missing-loop", severity=WARNING)]
        capped, recorded, counted = set(), [], []
        for s in art.solves:
            for k, its in s.lane_iterations().items():
                stop, n = s.stops.get(k, ("cap", len(its)))
                if stop == "cap":
                    capped.add(len(its))
                if n != len(its):
                    recorded.append(len(its))
                    counted.append(n)
        out = []
        if capped and capped != {int(want)}:
            out.append(self.finding(
                art, f"lanes stopped at the cap ran {sorted(capped)} iterations, not the configured "
                     f"max_iter={want} — the loop's iteration cap drifted from MWUOptions",
                trips=sorted(capped), max_iter=int(want)))
        if recorded:
            out.append(self.finding(
                art, f"lanes ran {recorded} recorded iterations where the loop counted {counted}",
                key="uncounted", recorded=recorded, counted=counted))
        return out


def parse_ptxas(text: str) -> dict:
    """{entry function: {source, registers, smem, spill_stores, spill_loads,
    lines}} from the compiler's ``-Xptxas -v`` output as ``loader.build``
    keeps it (``== <source> (rc N)`` before each file's lines). A spill
    line of a function an entry calls counts against that entry."""
    entries: dict = {}
    source, current = "", None
    for line in text.splitlines():
        if line.startswith("== "):
            source, current = line[3:].split(" ")[0], None
            continue
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = entries.setdefault(m.group(1), dict(source=source, registers=0, smem=0, spill_stores=0,
                                                         spill_loads=0, lines=[]))
            continue
        if current is None or not any(w in line for w in ("registers", "spill", "smem")):
            continue
        current["lines"].append(line.strip())
        if (r := re.search(r"Used (\d+) registers", line)) is not None:
            current["registers"] = max(current["registers"], int(r.group(1)))
        if (s := re.search(r"(\d+) bytes smem", line)) is not None:
            current["smem"] = max(current["smem"], int(s.group(1)))
        if (sp := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)) is not None:
            current["spill_stores"] += int(sp.group(1))
            current["spill_loads"] += int(sp.group(2))
    return entries


class SmemFootprintRule(Rule):
    """Every kernel entry fits a block's shared memory and registers, unspilled."""

    name = "smem-footprint"
    description = "ptxas: <= 227 KB shared memory a block, <= 255 registers, no spills (f32 flash d 256 may)"

    def check(self, art):
        if art.ptxas is None:
            return []
        out = []
        for entry, e in sorted(parse_ptxas(art.ptxas).items()):
            short = entry_name(entry)
            if e["smem"] > SMEM_BYTES_PER_BLOCK:
                out.append(self.finding(
                    art, f"kernel `{short}` ({e['source']}) uses {e['smem']} bytes of shared memory a block, "
                         f"over the {SMEM_BYTES_PER_BLOCK} a block may take", key=f"{short}:smem",
                    bytes=e["smem"], budget=SMEM_BYTES_PER_BLOCK))
            if e["registers"] > MAX_REGISTERS:
                out.append(self.finding(
                    art, f"kernel `{short}` uses {e['registers']} registers a thread, over {MAX_REGISTERS}",
                    key=f"{short}:registers", registers=e["registers"]))
            spills = e["spill_stores"] + e["spill_loads"]
            if spills and not any(p.search(entry) for p in SPILL_ALLOWED):
                out.append(self.finding(
                    art, f"kernel `{short}` ({e['source']}) spills {e['spill_stores']} bytes stored and "
                         f"{e['spill_loads']} loaded", key=f"{short}:spill", spill_bytes=spills))
        return out


def entry_name(mangled: str) -> str:
    """A readable, stable key of a mangled entry name: its namespaced
    identifier and its template arguments (``rt::search_kernel<double,
    NewtonControl,false>``); the mangled name where it does not parse."""
    try:
        return _demangle(mangled)
    except (IndexError, ValueError):
        return mangled


def _source_name(s: str, i: int) -> tuple[str, int]:
    """The <length><identifier> at s[i:], and the index after it."""
    j = i
    while s[j].isdigit():
        j += 1
    n = int(s[i:j])
    return s[j:j + n], j + n


def _demangle(s: str) -> str:
    if not s.startswith("_Z"):
        return s
    parts, i = [], 2
    if s[i] == "N":  # a nested (namespaced) name: N <names> [template args] E
        i += 1
        while s[i].isdigit():
            name, i = _source_name(s, i)
            parts.append(name)
    else:
        name, i = _source_name(s, i)
        parts.append(name)
    args = []
    if s[i] == "I":
        i += 1
        while s[i] != "E":
            if s[i] == "L":  # a literal: L <type> <value> E
                j = s.index("E", i)
                args.append({"b1": "true", "b0": "false"}.get(s[i + 1:j], s[i + 2:j]))
                i = j + 1
            elif s[i] == "N":  # a nested name; S<seq>_ refers to a scope already named
                i, scope = i + 1, []
                while s[i] != "E":
                    if s[i] == "S":
                        i = s.index("_", i) + 1
                    else:
                        name, i = _source_name(s, i)
                        scope.append(name)
                args.append("::".join(scope))
                i += 1
            elif s[i].isdigit():
                name, i = _source_name(s, i)
                args.append(name)
            else:
                args.append(_BUILTIN[s[i]])
                i += 1
    return "::".join(parts) + (f"<{','.join(args)}>" if args else "")


_BUILTIN = {"f": "float", "d": "double", "i": "int", "j": "unsigned", "l": "long", "b": "bool", "h": "uchar",
            "c": "char", "x": "longlong"}


DEFAULT_RULES: list[Rule] = [
    HostReadsRule(),
    KernelPathRule(),
    LoopCollectivesRule(),
    DtypeRule(),
    TripCountRule(),
    SmemFootprintRule(),
]


def run_rules(artifacts, rules=None) -> list[Finding]:
    """Apply ``rules`` (default: all) to every artifact; findings in order."""
    rules = DEFAULT_RULES if rules is None else rules
    findings: list[Finding] = []
    for art in artifacts:
        for rule in rules:
            findings.extend(rule.check(art))
    return findings

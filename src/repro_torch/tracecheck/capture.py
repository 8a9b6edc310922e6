"""Record hot entry points as :class:`~.rules.TraceArtifact`s.

Port of ``repro.tracecheck.capture``. The port compiles no program, so
there is no jaxpr or HLO to read: the "trace" of a case is its *recorded
eager run* on the device the case names, capped at
:data:`CAPTURE_MAX_ITER` loop iterations so that a case costs well under a
second. :class:`Recorder`, an ``utils.opcount.OpCounter`` (a
``TorchDispatchMode``), records while the entry point runs:

* every aten op as a token of its name, its operands' dtypes and shapes
  (devices dropped; a commutative op's operands sorted) and its outputs'
  (a composite op that reaches the mode whole, as ``matmul`` and
  ``einsum`` do under ``inference_mode``, is one token), and each output's
  dtype;
* each call of a kernel wrapper (``kernels.loader.counted``) as one token
  ``kernel:<name>``, whichever version runs (the plain version's own ops
  and host reads are not recorded);
* each host read (:func:`counted_reads`: ``item``, ``tolist``,
  ``__float__``, ``__int__``, ``__bool__``, ``cpu``, ``numpy`` of a tensor
  on the case's device), which on the CPU counts the same call sites that
  read the card;
* each collective, as ``OpCounter`` counts it, with its reduction
  (``psum``, ``pmax``, ``pmin``);
* the op counts of each lane iteration (the cost model's).

The stream is split at ``core.mwu``'s seams, which the recorder wraps for
the run: ``_start`` opens a solve, each ``_iteration`` call is one lane's
iteration, the loop's read of the lane record (``core/mwu.py``, in
``_run``) closes a loop iteration, ``_finalize`` closes the solve. Nothing
of ``core``, ``kernels`` or ``dist`` changes, and no recorder, no work:
the wrappers find no recorder on the dispatch stack.

Expectations come from host facts, as in the reference's ``_base_expect``:
the kernels a lane iteration must call follow from the lane's operators
(:func:`loop_kernels`) and the step rule; the collectives from the mesh
plan (the reference's ``_POD_COLLECTIVES``, a lane iteration); the dtype
from the problem's operators; the trip count from ``max_iter``.

Cases run on the device they name. On a host with no card the card
(``kernel``) cases are not run (:func:`capture_case` returns None, and the
caller lists them as skipped), as the reference skips plans wider than its
device set: there is no fallback to the CPU. Their per-iteration costs can
still be reckoned on the CPU with the operators' products on the card's
path (:func:`card_products`, :func:`reckon_case`): counts do not depend on
the device, only on the path.
"""
from __future__ import annotations

import contextlib
import functools
import sys
from collections import Counter

import numpy as np
import torch

from ..utils.opcount import _ALLOC, _FREE, OpCounter, OpReport
from .rules import LaneIteration, LoopIteration, SolveRecord, TraceArtifact

__all__ = [
    "READ_METHODS",
    "CAPTURE_MAX_ITER",
    "counted_reads",
    "Recorder",
    "record",
    "build_problem",
    "solve_dtype",
    "loop_kernels",
    "card_products",
    "capture_case",
    "reckon_case",
]

# Small but not degenerate capture graphs (the reference's): every family's
# operators appear, searches run several probes, gen-match's masks the
# masked paths. (n_vertices, n_edges) of erdos(seed=7).
_GRAPH_SHAPE = (24, 60)
CAPTURE_MAX_ITER = 4  # loop iterations a case runs: each lane runs exactly these at the mid bound
CAPTURE_DTYPE = torch.float32  # the reference's default (no x64): the dtype rule has a wider type to catch

# the reference's declared pod-plan collectives (src/repro/tracecheck/capture.py:80): the dy and dz
# completions and max(d); the port issues them a lane iteration
_POD_COLLECTIVES = {"psum": 2, "pmax": 1}

#: the Tensor methods that read a tensor's value to the host (chip_smoke.py counts these)
READ_METHODS = ("item", "tolist", "__float__", "cpu", "numpy")
_RECORDED_READS = READ_METHODS + ("__int__", "__bool__")

_SHORT = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16", torch.float16: "f16",
          torch.int32: "i32", torch.int64: "i64", torch.bool: "b8", torch.uint8: "u8", torch.int8: "i8"}
_COMMUTATIVE = frozenset({"add", "mul", "maximum", "minimum", "eq", "ne", "logical_and", "logical_or",
                          "logical_xor", "bitwise_and", "bitwise_or", "bitwise_xor"})
_DROP_KWARGS = frozenset({"device", "pin_memory", "layout", "out", "memory_format", "non_blocking"})


@contextlib.contextmanager
def counted_reads(device: str = "cuda", methods=READ_METHODS, on_read=None):
    """Count the host's reads of the values of tensors on ``device`` (a
    device type) while active, by patching the Tensor methods ``methods``
    (a CPU tensor's ``tolist`` reaches no dispatcher, so a dispatch mode
    cannot see it): yields a one-element list that holds the count. A read
    made inside another (``cpu`` calling ``item``) counts once.
    ``on_read(method, tensor, frame)``, where given, is called for each
    counted read with the caller's frame; what it returns, if not None, is
    a context manager entered around the read."""
    reads, active = [0], [False]
    saved = {name: getattr(torch.Tensor, name) for name in methods}

    def counting(name, method):
        def read(t, *a, **k):
            around = None
            if t.device.type == device and not active[0]:
                reads[0] += 1
                if on_read is not None:
                    around = on_read(name, t, sys._getframe(1))
            active[0], outer = True, active[0]
            try:
                with around or contextlib.nullcontext():
                    return method(t, *a, **k)
            finally:
                active[0] = outer
        return read

    for name, method in saved.items():
        setattr(torch.Tensor, name, counting(name, method))
    try:
        yield reads
    finally:
        for name, method in saved.items():
            setattr(torch.Tensor, name, method)


def _desc(x) -> str | None:
    """A token's operand: a tensor's dtype and shape, a scalar's value."""
    if isinstance(x, torch.Tensor):
        return f"{_SHORT.get(x.dtype, str(x.dtype))}[{','.join(map(str, x.shape))}]"
    if isinstance(x, torch.dtype):
        return _SHORT.get(x, str(x))
    if isinstance(x, torch.device):
        return None
    if isinstance(x, (tuple, list)):
        return "(" + ",".join(d for d in map(_desc, x) if d is not None) + ")"
    if x is None or isinstance(x, (bool, int, float, str)):
        return repr(x)
    return type(x).__name__


def _tensor_list(obj) -> list:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in _tensor_list(o)]
    return []


class Recorder(OpCounter):
    """``with Recorder(device) as r: run()`` records ``run``'s op stream
    (module docstring) while counting it as ``OpCounter`` does; the hooks
    into ``core.mwu`` are installed by :func:`record`."""

    def __init__(self, device="cpu", card_path: bool = False):
        super().__init__()
        self.device = torch.device(device).type
        self.card_path = card_path or self.device != "cpu"  # the operators' products take the card's path
        self.solves: list = []
        self.outside: list = []
        self.kernels_outside: Counter = Counter()
        self._solve: SolveRecord | None = None
        self._loop: LoopIteration | None = None
        self._lane: LaneIteration | None = None
        self._segment = "outside"
        self._depth = 0  # > 0: inside a composite op taken whole
        self._quiet = 0  # > 0: reads and ops not recorded (a plain version's, the counter's own, a read's copy)
        self._record_keys: set = set()  # storages of the lane's record row and alpha
        self._pending: str | None = None  # the reduction of the collective being issued

    # -- where a token goes ------------------------------------------------
    def _sink(self) -> list:
        if self._lane is not None:
            return self._lane.tokens
        if self._segment == "start":
            return self._solve.start
        if self._segment == "loop":
            return self._loop.tokens
        if self._segment == "finalize":
            return self._solve.finalize
        return self.outside

    # -- core.mwu's seams ------------------------------------------------
    def begin_solve(self) -> None:
        self._solve = SolveRecord(reads={"start": 0, "finalize": 0})
        self.solves.append(self._solve)
        self._segment = "start"

    def begin_loop(self) -> None:
        self._loop = LoopIteration()
        self._segment = "loop"

    @contextlib.contextmanager
    def lane(self, k: int, expected=None, keep=()):
        """One lane's iteration: its tokens, counts and report apart;
        outputs into the storages of ``keep`` (the record row, alpha) are
        not counted as the loop's dtypes."""
        if self._loop is None:  # a lane iteration outside a recorded loop (a test's): its own solve
            self.begin_solve()
            self.begin_loop()
        lane = LaneIteration(lane=k, expected=expected)
        saved_report, self.report = self.report, OpReport()
        self._record_keys = {t.untyped_storage()._cdata for t in keep}
        self._lane = lane
        try:
            yield lane
        finally:
            self._lane = None
            self._record_keys = set()
            lane.report = self.report
            peak = max(saved_report.peak_live_bytes, self.report.peak_live_bytes)
            self.report = OpReport.combine([(1, saved_report), (1, lane.report)])
            self.report.peak_live_bytes = peak
            self._loop.lanes.append(lane)

    def loop_read(self) -> None:
        """The loop's read of the lane record: closes a loop iteration."""
        self._loop.reads.append("loop")
        self._loop.tokens.append("read:loop")
        self._solve.iterations.append(self._loop)
        self.begin_loop()

    def begin_finalize(self, lanes=()) -> None:
        """Close the loop; ``lanes`` (``core.mwu._Lane``s) say why each lane
        stopped: ``infeasible``, ``covered`` (min Cx >= 1) or ``cap`` (its
        ``max_iter`` iterations), and after how many iterations."""
        from ..core.mwu import Status

        if self._loop is not None and (self._loop.lanes or self._loop.tokens):
            self._solve.iterations.append(self._loop)  # a loop left without its read
        for ln in lanes:
            stop = "infeasible" if ln.status == Status.INFEASIBLE else "covered" if ln.min_z >= 1.0 else "cap"
            self._solve.stops[ln.k] = (stop, ln.it)
        self._loop = None
        self._segment = "finalize"

    def end_solve(self) -> None:
        self._solve = self._loop = None
        self._segment = "outside"

    # -- events ------------------------------------------------------------
    @contextlib.contextmanager
    def quiet(self):
        """Record nothing inside: a plain version's own reads, the op
        counter's (a search's FLOPs are its probes, read from its record),
        and the copy a read of a card tensor makes (``tolist``'s
        ``_to_copy``, which a CPU tensor's read does not dispatch)."""
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    def on_read(self, method: str, tensor, frame):
        if self._quiet:
            return None
        from ..core import mwu

        if self._segment == "loop" and self._lane is None and frame.f_code is mwu._run.__code__:
            self.loop_read()
            return self.quiet()
        name = method.strip("_")
        self._sink().append(f"read:{name}")
        if self._lane is not None:
            self._lane.reads.append(name)
        elif self._segment == "loop":
            self._loop.reads.append(name)
        elif self._segment in ("start", "finalize"):
            self._solve.reads[self._segment] += 1
        return self.quiet()

    def on_all_reduce(self, op) -> None:
        self._pending = "p" + getattr(op, "name", str(op).rsplit(".", 1)[-1]).lower()

    def kernel_call(self, name, flops, fn, args, kwargs):
        """One token; a plain version (CPU tensors) records nothing inside,
        a card call records its wrapper's own reads (a read there is a
        regression), and the counter's formula records nothing."""
        self._sink().append(f"kernel:{name}")
        (self._lane.kernels if self._lane is not None else self.kernels_outside)[name] += 1
        ts = _tensor_list(list(args) + list(kwargs.values()))

        def charged(*a, **k):
            with self.quiet():
                return flops(*a, **k)

        with self.quiet() if ts and ts[0].device.type == "cpu" else contextlib.nullcontext():
            return super().kernel_call(name, charged, fn, args, kwargs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self._depth += 1
        try:
            out = super().__torch_dispatch__(func, types, args, kwargs)
        finally:
            self._depth -= 1
        if self._depth == 0:
            self._note(func, args, kwargs, out)
        return out

    def _note(self, func, args, kwargs, out) -> None:
        if self._quiet:
            return
        packet = func.overloadpacket
        if func.namespace == "c10d":
            kind, self._pending = self._pending or func._schema.name.split("::")[1].strip("_"), None
            self._sink().append(f"coll:{kind}({_desc(_tensor_list(args[0]))})")
            if self._lane is not None:
                self._lane.collectives[kind] += 1
            return
        if func.is_view or (packet in _FREE and packet not in _ALLOC):
            return
        ins = [d for d in map(_desc, args) if d is not None]
        if packet.__name__.rstrip("_") in _COMMUTATIVE and len(ins) >= 2:
            ins[:2] = sorted(ins[:2])
        ins += [f"{k}={_desc(v)}" for k, v in sorted(kwargs.items()) if k not in _DROP_KWARGS]
        outs = _tensor_list(out)
        self._sink().append(f"{func}({','.join(ins)})->({','.join(_desc(t) for t in outs)})")
        if self._lane is not None:
            for t in outs:
                if t.untyped_storage()._cdata not in self._record_keys:
                    self._lane.outputs[(str(packet), str(t.dtype).replace("torch.", ""))] += 1

    def artifact(self, name: str, **fields) -> TraceArtifact:
        return TraceArtifact(name=name, device=self.device, solves=self.solves, outside=self.outside,
                             kernels_outside=self.kernels_outside, **fields)


def _rule_search(record_fn) -> Counter | None:
    """The search kernel a lane iteration of ``record_fn`` calls once (None:
    a host rule, whose probes depend on the data)."""
    from ..core import stepsize

    if record_fn is stepsize.newton_step_record:
        return Counter(newton_search=1)
    if record_fn is stepsize.binary_step_record:
        return Counter(binary_search=1)
    if record_fn is stepsize.standard_step_record:
        return Counter()
    return None


def _has_gather(op) -> bool:
    """Whether ``op.as_gather`` gives a gather (``core.operators``, ``dist.shard``)."""
    from ..core.operators import Incidence, ScaledRows

    if isinstance(op, Incidence):
        return True
    if isinstance(op, ScaledRows) or type(op).__name__ == "PodSum":
        return _has_gather(op.inner)
    return False


def _op_kernels(op, direction: str, card: bool) -> Counter:
    """The kernel calls of one ``op.matvec`` (direction "matvec") or
    ``op.rmatvec``: a gather for an incidence's transposed product, and on
    the card a scatter for each product that sums over its rows."""
    from ..core.operators import AdjacencyPlusId, Coo, Incidence, Transposed, VertexEdgePair, VStack

    if isinstance(op, Transposed):
        return _op_kernels(op.inner, "rmatvec" if direction == "matvec" else "matvec", card)
    if isinstance(op, VStack):
        return sum((_op_kernels(o, direction, card) for o in op.ops), Counter())
    if getattr(op, "inner", None) is not None:  # ScaledRows, and dist.shard's PodSum and SlabCols
        return _op_kernels(op.inner, direction, card)
    scatter = Counter(incidence_scatter=1) if card else Counter()
    if isinstance(op, (Incidence, VertexEdgePair)):
        return scatter if direction == "matvec" else Counter(incidence_gather=1)
    if isinstance(op, (Coo, AdjacencyPlusId)):
        return scatter
    return Counter()


def loop_kernels(P, C, record_fn, card: bool) -> Counter | None:
    """The kernel calls of one lane iteration (``core.mwu._iteration``) over
    operators P and C: 2 softmax weights, 1 step direction (which gathers
    P's transposed product itself where P has a gather form, so no lone
    gather then), the rule's search, 3 axpy, and the kernels of the
    operators' products."""
    search = _rule_search(record_fn)
    if search is None:
        return None
    want = Counter(softmax_weights=2, step_direction=1, axpy_reduce=3) + search
    if not _has_gather(P):
        want += _op_kernels(P, "rmatvec", card)
    for op, direction in ((C, "rmatvec"), (P, "matvec"), (C, "matvec")):
        want += _op_kernels(op, direction, card)
    return want


@contextlib.contextmanager
def _hooks(rec: Recorder):
    """Wrap ``core.mwu``'s seams and ``torch.distributed.all_reduce`` for
    ``rec``, and count reads, while active."""
    import torch.distributed as dist

    from ..core import mwu

    saved = {name: getattr(mwu, name) for name in ("_start", "_iteration", "_finalize")}
    all_reduce = dist.all_reduce

    def start(*a, **k):
        rec.begin_solve()
        out = saved["_start"](*a, **k)
        rec.begin_loop()
        return out

    def iteration(ln, record_fn, ls_eps):
        want = loop_kernels(ln.P, ln.C, record_fn, rec.card_path)  # host facts
        with rec.lane(ln.k, expected=want, keep=(ln.rec, ln.alpha_dev)):
            return saved["_iteration"](ln, record_fn, ls_eps)

    def finalize(opts, state, X):
        rec.begin_finalize(state)
        try:
            return saved["_finalize"](opts, state, X)
        finally:
            rec.end_solve()

    def reduce(tensor, op=dist.ReduceOp.SUM, *a, **k):
        if not rec._quiet:
            rec.on_all_reduce(op)
        return all_reduce(tensor, op, *a, **k)

    mwu._start, mwu._iteration, mwu._finalize = start, iteration, finalize
    dist.all_reduce = reduce
    try:
        with counted_reads(rec.device, _RECORDED_READS, rec.on_read):
            yield
    finally:
        for name, fn in saved.items():
            setattr(mwu, name, fn)
        dist.all_reduce = all_reduce


def record(fn, name: str, device="cpu", card_path: bool = False, **fields) -> tuple[TraceArtifact, object]:
    """Run ``fn()`` under a :class:`Recorder` on ``device``; returns (the
    artifact named ``name``, with ``fields`` set, and fn's result).
    ``card_path``: the operators' products take the card's path on the CPU
    (:func:`card_products`), and the expectations are the card's."""
    rec = Recorder(device, card_path)
    with contextlib.ExitStack() as stack:
        if card_path:
            stack.enter_context(card_products())
        stack.enter_context(_hooks(rec))
        stack.enter_context(rec)
        result = fn()
    return rec.artifact(name, **fields), result


# -------------------------------------------------------------- problems --
def _gen_match(g, device, dtype):
    """Generalized matching on ``g`` with degree bounds lb in {0, 1} (every
    other vertex 1) and ub 2. The reference's lb is 0 everywhere, which
    masks every covering row: its traced loop is there all the same, but a
    run that covers at once ends before its first iteration. Here the kept
    rows make the loop run, and the masked ones keep the masked paths."""
    from ..graphs import problems

    lb = (np.arange(g.n) % 2 == 0).astype(np.float64)
    return problems.generalized_matching_problem(g, lb, np.full(g.n, 2.0), device=device, dtype=dtype)


def build_problem(family: str, device="cpu", dtype=CAPTURE_DTYPE):
    """A tiny representative Problem of ``family`` (the reference's graph)."""
    from ..graphs import generators, problems

    g = generators.erdos(*_GRAPH_SHAPE, seed=7)
    if family == "gen-match":
        return _gen_match(g, device, dtype)
    return problems.build(family, g, device=device, dtype=dtype)


def _mid_bound(problem) -> float | None:
    if problem.bound_mode == "none":
        return None
    lo, hi = float(problem.lo), float(problem.hi)
    return lo * (hi / max(lo, 1e-300)) ** 0.5


def _batch_bounds(problem, width: int) -> np.ndarray:
    if problem.bound_mode == "none":
        return np.ones(width)
    lo, hi = float(problem.lo), float(problem.hi)
    r = hi / max(lo, 1e-300)
    return np.asarray([lo * r ** ((k + 1) / (width + 1)) for k in range(width)])


def solve_dtype(problem, bound=None) -> str:
    """The dtype the MWU loop runs this problem in (``core.mwu._start``'s)."""
    P, C, _, _ = problem.instantiate(bound)
    dt = torch.promote_types(P.colmax().dtype, C.colmax().dtype)
    return str(dt if dt.is_floating_point else torch.float32).replace("torch.", "")


def _expect(opts, dtype: str, *, collectives=None, traced=False) -> dict:
    return {"traced": traced, "collectives": dict(collectives or {}), "dtype": dtype, "trips": opts.max_iter}


@contextlib.contextmanager
def card_products():
    """The operators' products take the card's path (the scatter kernel's
    wrapper, over the operator's CSR) on any device while active: on the CPU
    the wrapper runs its plain version and is counted as the card's call.
    The branches are ``core.operators``' own card branches."""
    from ..core import operators as O
    from ..kernels import incidence_scatter

    patches = {
        (O.Incidence, "matvec"): lambda self, x: incidence_scatter(x, *self.csr, order=self.scatter_order),
        (O.Coo, "matvec"): lambda self, x: incidence_scatter(x, self.csr[0], order=self.scatter_order[0]),
        (O.Coo, "rmatvec"): lambda self, y: incidence_scatter(y, self.csr[1], order=self.scatter_order[1]),
        (O.AdjacencyPlusId, "matvec"): lambda self, x: incidence_scatter(x, *self.csr, base=x,
                                                                         order=self.scatter_order),
        (O.VertexEdgePair, "matvec"): lambda self, z: incidence_scatter(z, *self.csr, order=self.scatter_order),
    }
    saved = {key: key[0].__dict__[key[1]] for key in patches}
    for (cls, name), fn in patches.items():
        setattr(cls, name, fn)
    try:
        yield
    finally:
        for (cls, name), fn in saved.items():
            setattr(cls, name, fn)


def capture_case(case, device: str | None = None, card_path: bool = False):
    """The artifact (a list of them for ``lpserve``) of one matrix
    :class:`~.matrix.Case` on ``device`` (default: the case's own), or None
    where the case's device is a card this host does not have.
    ``card_path``: see :func:`record`."""
    device = case.device if device is None else device
    run = functools.partial(record, card_path=card_path)
    if device == "cuda" and not torch.cuda.is_available():
        return None
    if case.entry == "kernel":
        return _capture_kernel(case)

    from ..api.solver import Solver
    from ..core.mwu import MWUOptions

    opts = MWUOptions(max_iter=CAPTURE_MAX_ITER)
    problem = build_problem(case.family, device)
    bound = _mid_bound(problem)
    dtype = solve_dtype(problem, bound)

    if case.entry in ("solve", "solve_traced"):
        traced = case.entry == "solve_traced"
        art, out = run(lambda: Solver(opts).feasible(problem, bound, trace=traced), case.name, device,
                          opts=opts, expect=_expect(opts, dtype, traced=traced))
        if traced:
            art.trace_rows = len(out[1]["alpha"])
        return art

    if case.entry == "solve_batch":
        bounds = _batch_bounds(problem, 2)
        art, _ = run(lambda: Solver(opts).solve_batch(problem, bounds), case.name, device, opts=opts,
                        expect=_expect(opts, dtype))
        return art

    if case.entry == "dist":
        from ..dist.mesh import MeshPlan
        from ..dist.shard import pod_mode
        from ..dist.solver import DistSolver
        from ..launch.dryrun import fake_world

        plan = MeshPlan(pod=case.pod, data=case.data)
        # identity plans take solve_batch's width, so that the identity proof
        # diffs the two streams op for op; sharded plans one lane a data rank
        bounds = _batch_bounds(problem, 2 if plan.n_devices == 1 else plan.data)
        world = fake_world(plan.n_devices) if plan.n_devices > 1 else contextlib.nullcontext()
        with world:
            art, _ = run(lambda: DistSolver(opts, plan=plan).solve_batch(problem, bounds), case.name, device,
                            opts=opts, plan=plan, pod_mode=pod_mode(problem) if plan.pod > 1 else None,
                            expect=_expect(opts, dtype, collectives=_POD_COLLECTIVES if plan.pod > 1 else None))
        return art

    if case.entry == "lpserve":
        from ..api.solver import _lane_problem
        from ..graphs import generators, problems
        from ..lpserve import LPEngine, LPServeConfig

        eng = LPEngine(LPServeConfig(opts=opts, lanes=case.lanes))
        for seed in (1, 2):
            g = generators.erdos(*_GRAPH_SHAPE, seed=seed)
            eng.submit(_gen_match(g, device, CAPTURE_DTYPE) if case.family == "gen-match"
                       else problems.build(case.family, g, device=device, dtype=CAPTURE_DTYPE))
        arts = []
        for key, (stacked, bounds) in eng.audit_launches().items():
            art, _ = run(lambda: eng.solver.solve_batch(stacked, bounds, batched_problem=True),
                            f"{case.name}[{key[0]}/{key[4]}]", device, opts=opts,
                            expect=_expect(opts, solve_dtype(_lane_problem(stacked, 0), float(bounds[0]))))
            arts.append(art)
        return arts

    raise ValueError(f"unknown tracecheck entry {case.entry!r}")


def reckon_case(case):
    """A card case's artifact recorded on the CPU with the operators'
    products on the card's path (:func:`card_products`): what the cost
    model holds the card's counts to. None for a case with no loop."""
    if case.entry == "kernel":
        return None
    return capture_case(case, device="cpu", card_path=True)


# ----------------------------------------------------------- raw kernels --
# op -> (the wrapper's counted name, its CUDA sources)
_KERNEL_CASES = {
    "gather": ("incidence_gather", ("incidence_gather.cu",)),
    "softmax": ("softmax_weights", ("softmax_weights.cu",)),
    "probe": ("linesearch_probe", ("linesearch_probe.cu",)),
    "axpy": ("axpy_reduce", ("axpy_reduce.cu",)),
}
_KERNEL_ROWS = 1 << 20  # a streamed vector's length (the reference's)


def _build_log_of(sources) -> str:
    """The compiler's log sections (``== <source> (rc N)``) of ``sources``."""
    from ..kernels import loader

    keep, out = False, []
    for line in loader.build_log().read_text().splitlines():
        if line.startswith("== "):
            keep = line[3:].split(" ")[0] in sources
        if keep:
            out.append(line)
    return "\n".join(out)


def _capture_kernel(case) -> TraceArtifact:
    """One kernel wrapper launched once on the card, with its compiler log
    (the shared-memory rule's input)."""
    from .. import kernels as K

    name, sources = _KERNEL_CASES[case.op]
    gen = torch.Generator().manual_seed(0)
    n = _KERNEL_ROWS
    y = torch.rand(n, generator=gen).cuda()
    dy = (torch.rand(n, generator=gen) - 0.5).cuda()
    calls = {
        "gather": lambda: K.incidence_gather(*(torch.randint(0, n, (4096,), generator=gen, dtype=torch.int32).cuda()
                                              for _ in range(2)), y),
        "softmax": lambda: K.softmax_weights(y, 30.0),
        "probe": lambda: K.linesearch_probe(y, dy, 0.5, 30.0),
        "axpy": lambda: K.axpy_reduce(y, dy, 0.5),
    }
    art, _ = record(calls[case.op], case.name, "cuda", expect={"kernels_anywhere": {name: 1}, "dtype": "float32"})
    art.ptxas = _build_log_of(sources)
    return art

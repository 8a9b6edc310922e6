"""Op counts of an eager run: the port's counterpart of ``repro.utils.hlo``.

The reference reads FLOPs, HBM bytes and collective wire bytes off the
compiled, partitioned HLO text of a step. The port compiles no program, so
there is no HLO to parse: :class:`OpCounter`, a ``TorchDispatchMode``,
counts what an eager run dispatches, op by op, on any device (``meta``,
CPU or the card), and returns an :class:`OpReport` with the reference's
``HloReport`` fields plus FLOPs by dtype.

Charges:

* FLOPs. Products (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions)
  are counted by ``torch.utils.flop_counter`` (``dot_flops``), under the
  dtype of their inputs: ``bf16`` (bf16 or fp16), ``tf32`` (f32 where
  ``torch.backends.cuda.matmul.allow_tf32`` is set), ``f32``, ``f64``.
  Every other op that computes is charged one FLOP an element of its
  largest tensor (``fusion_flops``, here elementwise work; the reference's
  estimate for a fusion's ops), under ``f64`` if a tensor of it is f64,
  else ``f32`` (PyTorch computes bf16 elementwise ops in f32). Ops that
  only move data (copies, casts, concatenation, indexing, fills) are
  charged no FLOPs.
* HBM bytes. An eager op reads its inputs from HBM and writes its outputs
  there, so it is charged exactly those bytes, each tensor once. Views and
  metadata ops are charged nothing. Ops that read a slice of a tensor
  through indices (``embedding``, ``index``, ``index_select``, ``gather``)
  are charged their indices and twice their output, the slice read and
  the output written; ops that write through indices (``index_put_``,
  ``scatter``, ``index_add_``) their indices and twice their values; an
  overwrite (``copy_``, ``fill_``, ``zero_``) does not read its target.
  These two follow the reference's slice charges (``hlo.py:148-154``).
* Kernel calls. Each call of a kernel wrapper of the port
  (``repro_torch.kernels``) is charged as one op: its own FLOPs (the bound
  formula of ``PERF.md`` §6: flash attention 4 B Hq d over the scored
  pairs, 3x under ``tf32`` for the f32 kernel's 3xTF32 products; a search
  its probes' sweeps) and bytes (inputs read once, outputs written once),
  whether the CUDA kernel or its plain version runs. The plain version's
  own passes, which run on ``meta`` and on the CPU, are never counted.
  The reference does otherwise: its ``_SKIP_BYTES`` charges a Pallas
  ``custom-call`` nothing (``hlo.py:51-55``), and it cannot see the
  kernel's FLOPs.
* Collectives, in wire bytes a device, by the reference's ring formulas
  (``hlo.py:14-22``): all-reduce 2 (g-1)/g size, all-gather (g-1)/g size
  (the gathered output), reduce-scatter (g-1) size (the scattered output),
  all-to-all (g-1)/g size, broadcast and permute size. A collective the run
  issues (a ``c10d`` op, e.g. the MWU loop's ``all_reduce`` over a fake
  process group, which moves no data) is counted as issued; callers add the
  ones a sharding implies but an eager run on one rank does not issue with
  :meth:`OpCounter.reckon`. Each entry says which it is.
* Memory. The peak of the bytes of the storages that ops of the run
  allocated and that are still alive (``peak_live_bytes``): tensors made
  before the run (parameters, optimizer state, caches, inputs) are not in
  it; what the run returns is.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode, _pop_mode_temporarily
from torch.utils.flop_counter import flop_registry

__all__ = ["OpReport", "OpCounter", "wire_bytes", "dot_dtype"]

aten = torch.ops.aten

# ops charged nothing: views (schema-flagged) and these; the first allocate memory
_ALLOC = {aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty, aten.new_empty_strided}
_FREE = _ALLOC | {aten._unsafe_view, aten.detach, aten.alias, aten.lift_fresh, aten._local_scalar_dense,
                  aten.is_same_size, aten.set_, aten.sym_size, aten.sym_stride, aten.sym_numel,
                  aten.sym_storage_offset}
_SLICE_READ = {aten.embedding, aten.index, aten.index_select, aten.gather}
_SLICE_WRITE = {aten.index_put, aten.index_put_, aten._index_put_impl_, aten.scatter, aten.scatter_,
                aten.scatter_add, aten.scatter_add_, aten.index_add, aten.index_add_, aten.index_copy,
                aten.index_copy_}
_OVERWRITE = {aten.copy_, aten.fill_, aten.zero_}
# ops that move data and compute nothing
_NO_FLOPS = _SLICE_READ | _SLICE_WRITE | _OVERWRITE | {
    aten._to_copy, aten.clone, aten.cat, aten.stack, aten.constant_pad_nd, aten.repeat, aten.fill,
    aten.zeros, aten.zeros_like, aten.ones, aten.ones_like, aten.full, aten.full_like, aten.new_zeros,
    aten.new_ones, aten.new_full, aten.arange, aten.slice_scatter, aten.select_scatter, aten.flip, aten.roll,
    aten.linspace, aten.masked_scatter, aten.expand_copy}
# c10d op name -> collective kind
_COLLECTIVES = {"allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce", "allgather_": "all-gather",
                "_allgather_base_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
                "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
                "reduce_scatter_tensor_coalesced_": "reduce-scatter", "alltoall_": "all-to-all",
                "alltoall_base_": "all-to-all", "broadcast_": "broadcast", "send": "permute", "recv_": "permute"}


def wire_bytes(kind: str, size: float, g: int) -> float:
    """Wire bytes a device of one collective of ``kind`` over ``g`` ranks
    (``size``: the tensor's bytes; all-gather's output, reduce-scatter's
    output), by the reference's ring formulas."""
    if kind == "all-reduce":
        return 2.0 * (g - 1) / max(g, 1) * size
    if kind in ("all-gather", "all-to-all"):
        return (g - 1) / max(g, 1) * size
    if kind == "reduce-scatter":
        return float(g - 1) * size
    return float(size)


def dot_dtype(dtype: torch.dtype) -> str:
    """The rate a product of ``dtype`` inputs runs at (``utils.roofline``)."""
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    if dtype == torch.float64:
        return "f64"
    return "tf32" if torch.backends.cuda.matmul.allow_tf32 else "f32"


def _tensors(obj, out: list) -> list:
    """Every tensor in obj (nested tuples, lists, dicts, dataclasses)."""
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            _tensors(o, out)
    elif isinstance(obj, dict):
        for o in obj.values():
            _tensors(o, out)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _tensors(getattr(obj, f.name), out)
    return out


def _unique(ts: list) -> list:
    seen, out = set(), []
    for t in ts:
        if id(t) not in seen:
            seen.add(id(t))
            out.append(t)
    return out


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _add(d: dict, key, value) -> None:
    d[key] = d.get(key, 0) + value


@dataclass
class OpReport:
    """Counts of a run, with ``repro.utils.hlo.HloReport``'s fields:
    ``flops`` = ``dot_flops`` + ``fusion_flops`` (elementwise) +
    ``kernel_flops``; ``flops_by_dtype`` splits it by the rate it runs at.
    ``collectives`` maps (kind, group size, "issued" | "reckoned") to
    [count, bytes, wire bytes]."""

    flops_by_dtype: dict = field(default_factory=dict)
    dot_flops: float = 0.0
    fusion_flops: float = 0.0
    kernel_flops: float = 0.0
    hbm_bytes: float = 0.0
    kernel_calls: dict = field(default_factory=dict)
    n_ops: float = 0
    collectives: dict = field(default_factory=dict)
    peak_live_bytes: float = 0.0

    @property
    def flops(self) -> float:
        return self.dot_flops + self.fusion_flops + self.kernel_flops

    @property
    def collective_wire_bytes(self) -> float:
        return sum(c[2] for c in self.collectives.values())

    @property
    def collective_breakdown(self) -> dict:
        out: dict = {}
        for (kind, _, _), c in self.collectives.items():
            _add(out, kind, c[2])
        return out

    @property
    def n_collectives(self) -> float:
        return sum(c[0] for c in self.collectives.values())

    def reckon(self, kind: str, size: float, group: int, count: float = 1, source: str = "reckoned") -> None:
        """Add ``count`` collectives of ``kind`` over ``group`` ranks, each of
        ``size`` bytes (see :func:`wire_bytes`); none over one rank."""
        if group <= 1 or count == 0:
            return
        c = self.collectives.setdefault((kind, int(group), source), [0, 0.0, 0.0])
        c[0] += count
        c[1] += count * size
        c[2] += count * wire_bytes(kind, size, group)

    @staticmethod
    def combine(parts) -> "OpReport":
        """sum of w * report over ``parts``, a list of (w, report): the
        extension of per-layer counts to a model's depth (and, with one
        part, a scaling)."""
        out = OpReport()
        for w, r in parts:
            for k, v in r.flops_by_dtype.items():
                _add(out.flops_by_dtype, k, w * v)
            for k, v in r.kernel_calls.items():
                _add(out.kernel_calls, k, w * v)
            for k, v in r.collectives.items():
                c = out.collectives.setdefault(k, [0, 0.0, 0.0])
                for i in range(3):
                    c[i] += w * v[i]
            for name in ("dot_flops", "fusion_flops", "kernel_flops", "hbm_bytes", "n_ops", "peak_live_bytes"):
                setattr(out, name, getattr(out, name) + w * getattr(r, name))
        return out

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "flops_by_dtype": dict(self.flops_by_dtype),
            "dot_flops": self.dot_flops,
            "fusion_flops": self.fusion_flops,
            "kernel_flops": self.kernel_flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_wire_bytes": self.collective_wire_bytes,
            "collective_breakdown": self.collective_breakdown,
            "n_collectives": self.n_collectives,
            "collectives": [{"kind": k, "group": g, "source": s, "count": c[0], "bytes": c[1], "wire_bytes": c[2]}
                            for (k, g, s), c in sorted(self.collectives.items())],
            "kernel_calls": dict(self.kernel_calls),
            "n_ops": self.n_ops,
            "peak_live_bytes": self.peak_live_bytes,
        }


class OpCounter(TorchDispatchMode):
    """``with OpCounter() as c: run()`` counts ``run``'s ops into ``c.report``
    (module docstring). The kernel wrappers of the port find it on the
    dispatch mode stack (``kernels.loader.counted``) and call
    :meth:`kernel_call`."""

    def __init__(self):
        super().__init__()
        self.report = OpReport()
        self._live: dict = {}  # storage key -> (weak reference, bytes)
        self._cur = 0

    # -- memory -----------------------------------------------------------
    def _allocated(self, ts, inputs) -> None:
        """Register the storages of outputs ``ts`` that the op allocated: not
        those of its inputs (an op in place or into ``out=`` allocates nothing)."""
        taken = {t.untyped_storage()._cdata for t in inputs}
        for t in ts:
            st = t.untyped_storage()
            key = st._cdata
            if key in taken:
                continue
            hit = self._live.get(key)
            if hit is not None:
                if not hit[0].expired():
                    continue
                self._cur -= hit[1]  # a freed storage's address taken again
            self._live[key] = (StorageWeakRef(st), st.nbytes())
            self._cur += st.nbytes()
        if self._cur > self.report.peak_live_bytes:  # the freed purged before it can count as a peak
            self.report.peak_live_bytes = max(self.report.peak_live_bytes, self.live_bytes())

    # -- charges ----------------------------------------------------------
    def _charge(self, flops: dict, kind: str, nbytes: float) -> None:
        r = self.report
        for k, v in flops.items():
            _add(r.flops_by_dtype, k, v)
            setattr(r, kind, getattr(r, kind) + v)
        r.hbm_bytes += nbytes
        r.n_ops += 1

    def live_bytes(self) -> int:
        """Bytes of the storages the run allocated that are alive now."""
        for key in [k for k, (ref, _) in self._live.items() if ref.expired()]:
            self._cur -= self._live.pop(key)[1]
        return self._cur

    def add(self, report: OpReport, times: float = 1) -> None:
        """Add ``times`` x ``report``, counted elsewhere (its peak is not added)."""
        peak = self.report.peak_live_bytes
        self.report = OpReport.combine([(1, self.report), (times, report)])
        self.report.peak_live_bytes = peak

    def kernel_call(self, name: str, flops, fn, args: tuple, kwargs: dict):
        """One call of kernel ``name``'s wrapper ``fn``, run with this counter
        off and charged as one op: ``flops(result, *args, **kwargs)`` (FLOPs
        by dtype) and its tensors' bytes, inputs read once (but ``out`` and
        ``red``, which it writes) and outputs written once."""
        with _pop_mode_temporarily():
            out = fn(*args, **kwargs)
        # what it only writes: out and red, unless also an input (out=y, an update in place)
        written = {id(kwargs[k]) for k in ("out", "red") if k in kwargs} - {id(a) for a in args}
        ins = [t for t in _unique(_tensors((args, kwargs), [])) if id(t) not in written]
        outs = _unique(_tensors(out, []))
        self._charge(flops(out, *args, **kwargs), "kernel_flops", _nbytes(ins) + _nbytes(outs))
        _add(self.report.kernel_calls, name, 1)
        self._allocated(outs, _tensors((args, kwargs), []))
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in flop_registry:
            # a composite op reaches the mode whole where autograd is off (matmul,
            # einsum, reshape under inference_mode): count the ops it runs, as
            # they reach the mode where autograd is on (FlopCounterMode does so)
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if func.namespace == "c10d":
            self._collective(func, args, out)
        elif packet in _ALLOC:
            self._allocated(_tensors(out, []), [])
        elif not (func.is_view or packet in _FREE):
            self._count(func, packet, args, kwargs, out)
        return out

    def _collective(self, func, args, out) -> None:
        from torch.distributed.distributed_c10d import ProcessGroup

        kind = _COLLECTIVES.get(func._schema.name.split("::")[1])
        if kind is None:
            return
        pg = next(a for a in args if isinstance(a, torch.ScriptObject))
        g = ProcessGroup.unbox(pg).size()
        # the first argument: the tensors reduced or sent, the gathered
        # outputs of an all-gather, the scattered outputs of a reduce-scatter
        self.report.reckon(kind, _nbytes(_tensors(args[0], [])), g, source="issued")

    def _count(self, func, packet, args, kwargs, out) -> None:
        outs = _unique(_tensors(out, []))
        ins = _unique(_tensors((args, {k: v for k, v in kwargs.items() if k != "out"}), []))
        if packet in _SLICE_READ:
            index = [t for t in ins if not t.is_floating_point()]
            nbytes = _nbytes(index) + 2 * _nbytes(outs)
        elif packet in _SLICE_WRITE:
            rest = _unique(_tensors(args[1:], []))  # indices, then the values written (the last argument)
            nbytes = _nbytes(rest) + _nbytes(rest[-1:])
        elif packet in _OVERWRITE:
            nbytes = _nbytes(ins[1:]) + _nbytes(outs)
        else:
            nbytes = _nbytes(ins) + _nbytes(outs)
        if packet in flop_registry:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            self._charge({dot_dtype(args[0].dtype): n}, "dot_flops", nbytes)
        elif packet in _NO_FLOPS:
            self._charge({}, "fusion_flops", nbytes)
        else:
            ts = ins + outs
            n = max((t.numel() for t in ts), default=0)
            dt = "f64" if any(t.dtype == torch.float64 for t in ts) else "f32"
            self._charge({dt: n} if n else {}, "fusion_flops", nbytes)
        self._allocated(outs, _tensors((args, kwargs), []))

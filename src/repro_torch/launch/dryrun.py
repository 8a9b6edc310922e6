"""Multi-pod dry run: reckon every (arch x shape x mesh) cell on the meta device.

Port of ``repro.launch.dryrun``. For each runnable cell
(``configs.shapes.skip_reason``) the reference lowers and compiles the
step on 512 fabricated host devices and reads memory, cost and the HLO
roofline off the compiled program. The port has no program to compile; on
the host, with no card and no allocation, :func:`run_cell`

  1. builds the production mesh, (16, 16) or (2, 16, 16), over PyTorch's
     fake process group of 512 ranks (``fake_world``; this process is rank 0);
  2. builds the model abstractly on ``meta`` (``Model(cfg, device="meta")``,
     ``fsdp = (step == "train")``, MoE dispatch groups = the DP size, as the
     reference sets them) and takes the per-device argument bytes from the
     partition specs: parameters (``param_spec``), AdamW's two f32 moments
     for train, the caches for decode (``cache_spec``), the batch;
  3. runs the step once on ``meta`` inputs (``configs.shapes.input_specs``)
     at the per-device batch (the global batch over the DP size where it
     divides, else whole, as ``dp_divides`` decides) and the model's own
     widths, under ``utils.opcount.OpCounter``: FLOPs by dtype, HBM bytes,
     kernel calls and the peak of live temporaries. A TP-sharded width is
     counted whole, then every count is divided by the "model" axis size.
     The layers are the pattern unit repeated: a model of ``reps``
     repetitions is counted at 1 and 2 and its counts extended linearly to
     ``reps`` (the reference's analyzer multiplies a scanned layer's body
     by its trip count the same way); the tail layers are in both counts;
  4. adds the collectives the specs imply, which a one-rank eager run does
     not issue (``_reckon_collectives``), and records the roofline terms
     (``utils.roofline``, the H100's rates) and the model FLOPs.

The steps are ``train.step.make_train_step`` (AdamW), ``Model.prefill``
and ``Model.decode_step``. An ``-mwu`` arch's router reads the host once a
loop iteration, which a meta tensor cannot do: its routing LP is counted
on the CPU at the router's shape (one group's tokens x the experts, random
logits from a seed), its start once and one lane iteration
(``core.mwu._iteration``) times ``mwu_iters``, the budget's upper bound,
and charged for every group of every router call of the meta run.

:func:`run_mwu_cell` is the paper's own workload, matching on 2^22
vertices at edge factor 16, distributed as ``dist.DistSolver`` runs it:
rank 0's lane of a ``MeshPlan(pod=256)`` (single: edge slabs of 262,144
edges, 4.2M vertices, one bound) or ``MeshPlan(pod=256, data=2)`` (pod2:
two bounds, one lane a pod, as the reference's pod-parallel lanes), on
real CPU tensors over the fake group. The group's collectives carry no
data, so the iterates are meaningless, but the counts are those of the
card's path (the slab's products go through the scatter kernel's wrapper,
as on the card): the start once, a few iterations (binary search, as the
reference's ``_dist_solve_local``), reckoned over the reference's 5,000
iteration budget.

Usage (no card needed; one JSON a cell under ``experiments/dryrun_torch/``):
  python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both
  python -m repro_torch.launch.dryrun --arch mwu-graph --mesh both
  python -m repro_torch.launch.dryrun --list
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..configs import ARCH_IDS, get
from ..configs.shapes import SHAPES, input_specs, skip_reason
from ..models import Model
from ..models.common import TP, dp_axes
from ..models.layers import moe as moemod
from ..utils.opcount import OpCounter, OpReport
from ..utils.roofline import model_flops_estimate, roofline_terms
from .mesh import axis_sizes, local_bytes, make_production_mesh

__all__ = ["run_cell", "run_mwu_cell", "count_step", "argument_bytes", "summary", "fake_world", "dp_divides", "main", "OUT_DIR"]

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
WORLD = 512  # ranks of the fake process group: the two-pod mesh
MWU_BUDGET = 5000  # the reference's iteration budget of the MWU cell
MWU_COUNTED_ITERS = 3  # iterations counted on the CPU, their mean reckoned over the budget


@contextlib.contextmanager
def fake_world(n: int = WORLD):
    """A fake default process group of ``n`` ranks (this process rank 0) for
    the block, destroyed after it; a default group that already exists is
    used as it is."""
    if dist.is_initialized():
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def dp_divides(sizes: dict, global_batch: int) -> bool:
    return global_batch % math.prod(sizes[a] for a in dp_axes(tuple(sizes))) == 0


def _local(tree, spec_tree, sizes: dict) -> int:
    """Bytes a device of a tree of tensors, each sharded by its spec."""
    total = 0

    def one(spec, t):
        nonlocal total
        total += local_bytes(t, spec, sizes)

    def walk(spec, t):
        if isinstance(t, torch.Tensor):
            one(spec, t)
        elif isinstance(t, dict):
            for k in t:
                walk(spec[k], t[k])
        elif isinstance(t, (tuple, list)):
            for s, x in zip(spec, t):
                walk(s, x)

    walk(spec_tree, tree)
    return total


# -- the MWU LP router of an -mwu arch -------------------------------------
def _router_lane(T: int, E: int, k: int, cap: int, iters: int, seed: int = 0) -> tuple[OpReport, OpReport]:
    """One routing LP lane at the router's shape on the CPU: the counts of
    its start and of one iteration (``core.mwu._iteration``, Newton search
    in its step form)."""
    from ..core import mwu

    logits = torch.randn(T, E, generator=torch.Generator().manual_seed(seed))
    P, C = moemod.routing_ops(torch.softmax(logits, dim=-1), k, cap)
    opts = moemod.router_options(iters)
    with torch.no_grad():
        with OpCounter() as c0:
            state, _, _ = mwu._start([(P, C, None, None)], opts)
        with OpCounter() as c1:
            mwu._iteration(state[0], mwu._record_fn(opts.step_rule), opts.ls_tol)
    return c0.report, c1.report


@contextlib.contextmanager
def _charged_router(counter: OpCounter, lane: OpReport):
    """``moe.mwu_route`` for a meta run: each call charges ``lane`` (a
    group's routing LP at its budget) once a group, and computes the
    router's softmax and the rounding of a plan of the LP's shape on meta."""
    real = moemod.mwu_route

    def route(logits, k, capacity, mwu_iters=16):
        grouped = logits.dim() == 3
        lg = logits if grouped else logits[None]
        counter.add(lane, times=lg.shape[0])
        probs = torch.softmax(lg.float(), dim=-1)
        idx, gate = moemod.round_plan(torch.empty(probs.shape, device=probs.device), probs, k, logits.dtype)
        return (idx, gate) if grouped else (idx[0], gate[0])

    moemod.mwu_route = route
    try:
        yield
    finally:
        moemod.mwu_route = real


# -- one step on meta --------------------------------------------------------
def _meta_batch(cfg, cell, B: int) -> dict:
    return {k: torch.zeros(shape, dtype=dtype, device="meta")
            for k, (shape, dtype) in input_specs(cfg, replace(cell, global_batch=B)).items()}


def _count_once(cfg, cell, B: int, mesh_axes, loss_chunk: int, lane: OpReport | None) -> OpReport:
    from ..train import AdamWConfig, make_train_state, make_train_step

    train = cell.step == "train"
    model = Model(cfg, device="meta", mesh_axes=mesh_axes, fsdp=train)
    batch = _meta_batch(cfg, cell, B)
    counter = OpCounter()
    router = _charged_router(counter, lane) if lane is not None else contextlib.nullcontext()
    if train:
        state = make_train_state(model)
        step_fn = make_train_step(model, AdamWConfig(), 1, loss_chunk)
        with router, counter:
            step_fn(state, batch)
        return counter.report
    with torch.inference_mode():
        if cell.step == "forward":  # the full-sequence forward to hidden states, as chip_smoke.py times it
            with router, counter:
                model(batch)
        elif cell.step == "prefill":
            with router, counter:
                model.prefill(batch, max_len=cell.seq_len)
        else:
            caches = model.init_caches(B, cell.seq_len)
            tok = batch.get("tokens", batch.get("frames"))
            with router, counter:
                model.decode_step(caches, tok)
    return counter.report


def count_step(cfg, cell, B: int, mesh_axes=("data", "model"), loss_chunk: int = 512) -> tuple[OpReport, dict]:
    """The counts of ``cell``'s step at batch ``B`` and ``cfg``'s widths on
    ``meta``, the pattern unit's repetitions counted at 1 and 2 and extended
    linearly to the model's; an ``-mwu`` router charged at its budget.
    Returns (the counts, what was counted)."""
    k = len(cfg.block_pattern or (cfg.pattern()[0],))
    reps, tail = cfg.n_layers // k, cfg.n_layers % k
    depths = [reps] if reps <= 2 else [1, 2]
    info = {"reps": reps, "counted_reps": depths, "tail_layers": tail}
    lane = None
    if cfg.moe is not None and cfg.moe.router == "mwu":
        T = B * (cell.seq_len if cell.step != "decode" else 1)
        G, cap = moemod.dispatch_shape(cfg, T)
        start, it = _router_lane(T // G, cfg.moe.n_experts, cfg.moe.top_k, cap, cfg.moe.mwu_iters)
        lane = OpReport.combine([(1, start), (cfg.moe.mwu_iters, it)])
        info["mwu_router"] = {"groups": G, "tokens_a_group": T // G, "experts": cfg.moe.n_experts, "capacity": cap,
                              "iterations": cfg.moe.mwu_iters, "upper_bound": True,
                              "start": start.as_dict(), "iteration": it.as_dict()}
    counts = [_count_once(replace(cfg, n_layers=k * r + tail), cell, B, mesh_axes, loss_chunk, lane) for r in depths]
    if len(counts) == 1:
        return counts[0], info
    return OpReport.combine([(2 - reps, counts[0]), (reps - 1, counts[1])]), info


# -- collectives the sharding implies ---------------------------------------
def _axes_of(spec) -> set:
    out = set()
    for e in spec:
        out |= set() if e is None else ({e} if isinstance(e, str) else set(e))
    return out


def _reckon_collectives(report: OpReport, model, sizes: dict, cell, B: int, remat: bool, shard_seq: bool) -> None:
    """Per device, the collectives the partition specs imply (source
    "reckoned"): a parameter split over DP axes is all-gathered over them
    before each use (FSDP: the forward, and in a train step with remat the
    recompute and the backward), its gradient reduce-scattered over them
    and all-reduced over the DP axes that replicate it; a product whose
    weight is split over "model" on its contraction dim (the second to
    last: the row-parallel ``wo``, ``wd``, ``out_proj``, ``wout``, the
    vocab-split embedding lookup) all-reduces its output over "model" (and
    its input gradient in the backward); decode over a KV cache split over
    "model" along its slots all-reduces each attention layer's f32 output
    and softmax statistics."""
    cfg, train = model.cfg, cell.step == "train"
    dp_names = dp_axes(tuple(sizes))
    tp = sizes.get(TP, 1)
    tokens = B * (cell.seq_len if cell.step != "decode" else 1)
    ct = model.dt.compute.itemsize
    uses = (3 if remat else 2) if train else 1
    rows = tokens
    if cfg.moe is not None:  # an expert product's rows: the dispatched slots
        G, cap = moemod.dispatch_shape(cfg, tokens)
        rows = G * cfg.moe.n_experts * cap
    spec = model.param_spec()
    for name, p in model.named_parameters():
        axes = _axes_of(spec[name])
        local = local_bytes(p, spec[name], sizes)
        g = math.prod(sizes[a] for a in dp_names if a in axes)
        report.reckon("all-gather", local * g, g, count=uses)
        if train:
            report.reckon("reduce-scatter", local * 4 // p.element_size(), g)
            report.reckon("all-reduce", local * 4 // p.element_size(),
                          math.prod(sizes[a] for a in dp_names if a not in axes))
        if p.dim() >= 2 and TP in _axes_of(spec[name][-2:-1]):
            n = (tokens if p.dim() == 2 else rows) * p.shape[-1] * ct
            report.reckon("all-reduce", n, tp, count=1 if name == "embedding" else (uses if train else 1))
    if cell.step == "decode" and shard_seq:
        n_attn = sum(k == "attn" for k in cfg.pattern())
        report.reckon("all-reduce", B * cfg.n_heads * (cfg.d_head + 2) * 4, tp, count=n_attn)


# -- cells ---------------------------------------------------------------------
def argument_bytes(cfg, cell, sizes: dict, decode_shard_seq: bool = True) -> dict:
    """Per-device bytes of a cell's arguments and outputs, from the full
    model built on meta at its global shapes and each tensor's spec
    (``fsdp`` for train): the parameters, AdamW's two f32 moments (train),
    the caches (decode), the batch (over the DP axes where they divide it);
    the outputs (the last position's logits and the caches; the hidden
    states of a "forward"; a train step updates its state in place:
    ``alias_bytes``)."""
    names = tuple(sizes)
    train = cell.step == "train"
    shard_batch = dp_divides(sizes, cell.global_batch)
    model = Model(cfg, device="meta", mesh_axes=names, fsdp=train)
    params = dict(model.named_parameters())
    pspec = model.param_spec()
    dps = dp_axes(names)
    dp_spec = (dps if len(dps) > 1 else dps[0]) if shard_batch and dps else None
    batch = _meta_batch(cfg, cell, cell.global_batch)
    mem = {"param_bytes": _local(params, pspec, sizes),
           "batch_bytes": _local(batch, {k: (dp_spec,) for k in batch}, sizes)}
    if train:
        mem["opt_state_bytes"] = 2 * sum(local_bytes(p, pspec[n], sizes) * 4 // p.element_size()
                                         for n, p in params.items())
        mem["output_bytes"] = 0  # metrics; the state is updated in place
        mem["alias_bytes"] = mem["param_bytes"] + mem["opt_state_bytes"]
    elif cell.step == "forward":
        hidden = torch.empty(cell.global_batch, cell.seq_len, cfg.d_model, dtype=model.dt.compute, device="meta")
        mem["output_bytes"] = local_bytes(hidden, (dp_spec, None, None), sizes)
    else:
        caches = model.init_caches(cell.global_batch, cell.seq_len)
        cspec = model.cache_spec(shard_seq=decode_shard_seq, shard_batch=shard_batch)
        cache_bytes = _local(caches.layers, cspec.layers, sizes)
        logits = torch.empty(cell.global_batch, 1, cfg.padded_vocab, dtype=model.dt.logit, device="meta")
        mem["output_bytes"] = cache_bytes + local_bytes(logits, (dp_spec, None, TP), sizes)
        if cell.step == "decode":
            mem["cache_bytes"] = cache_bytes
    mem["argument_bytes"] = mem["param_bytes"] + mem["batch_bytes"] + mem.get("opt_state_bytes", 0) + \
        mem.get("cache_bytes", 0)
    return mem


def run_cell(arch, shape, mesh_kind: str = "single", loss_chunk: int = 512, attn_chunk=None, extra_tag: str = "",
             decode_shard_seq: bool = True, remat=None, *, mesh=None) -> dict:
    """The record of one (arch x shape x mesh) cell. ``arch``: a registry id
    or a ``ModelConfig``; ``shape``: a ``SHAPES`` key or a ``ShapeCell``;
    ``mesh``: a ``DeviceMesh`` (or axis name -> size) in place of
    ``mesh_kind``'s production mesh. Every size in it is per device. Beside
    the reference's steps (train, prefill, decode) a cell's step may be
    "forward", the full-sequence forward to hidden states."""
    cell = SHAPES[shape] if isinstance(shape, str) else shape
    cfg = get(arch) if isinstance(arch, str) else arch
    if attn_chunk is not None:
        cfg = replace(cfg, attn_chunk=attn_chunk)
    if remat is not None:
        cfg = replace(cfg, remat=remat)
    rec = {"arch": cfg.name, "shape": cell.name, "mesh": mesh_kind, "step": cell.step, "tag": extra_tag, "ok": False}
    reason = skip_reason(cfg, cell)
    if reason is not None:
        rec.update({"skipped": True, "reason": reason})
        return rec
    if mesh is None:
        with fake_world():
            mesh = make_production_mesh(multi_pod=(mesh_kind == "pod2"))
    sizes = axis_sizes(mesh)
    names = tuple(sizes)
    n_dev = math.prod(sizes.values())
    dp = math.prod(sizes[a] for a in dp_axes(names))
    tp = sizes.get(TP, 1)
    train = cell.step == "train"
    if cfg.moe is not None:
        cfg = replace(cfg, moe_dispatch_groups=dp)
    shard_batch = dp_divides(sizes, cell.global_batch)
    B = cell.global_batch // dp if shard_batch else cell.global_batch
    # a device's share of the dispatch groups: its own tokens' group, or all of them
    run_cfg = cfg if cfg.moe is None else replace(cfg, moe_dispatch_groups=1 if shard_batch else dp)
    rec.update(mesh_shape=sizes, n_devices=n_dev, per_device_batch=B, batch_sharded=shard_batch,
               moe_dispatch_groups=cfg.moe_dispatch_groups)

    mem = argument_bytes(cfg, cell, sizes, decode_shard_seq)
    counted, depth = count_step(run_cfg, cell, B, names, loss_chunk)
    report = OpReport.combine([(1.0 / tp, counted)])
    _reckon_collectives(report, Model(run_cfg, device="meta", mesh_axes=names, fsdp=train), sizes, cell, B,
                        train and cfg.remat == "full", decode_shard_seq)
    mem["temp_bytes"] = report.peak_live_bytes
    mem["peak_bytes"] = mem["argument_bytes"] + mem["temp_bytes"]
    rec["memory"] = mem
    rec["counts"] = report.as_dict()
    rec["depth"] = depth
    rec["tp_divided"] = (f"counted at the per-device batch with every width whole, then every count and the peak "
                         f"of temporaries divided by the model axis size {tp}")
    tokens = cell.global_batch * (cell.seq_len if cell.step != "decode" else 1)
    mf = model_flops_estimate(cfg, cell)
    rec["model_flops"] = mf
    rec["roofline"] = roofline_terms(report, n_devices=n_dev, model_flops=mf["total"])
    rec["tokens"] = tokens
    rec["ok"] = True
    return rec


def _slab_problem(n: int, edges: int, seed: int = 0):
    """Rank 0's edge slab of a matching LP on n vertices: ``edges`` random
    edges (u < v, u ascending, as a graph emits them), f32, objective 1 an
    edge, its covering row at bound n / 4; its products take the card's
    path (the scatter kernel's wrapper)."""
    from ..core.operators import Incidence, OnesRow
    from ..kernels import incidence_scatter

    class CardPath(Incidence):
        def matvec(self, x):
            return incidence_scatter(x, *self.csr, order=self.scatter_order)

    rng = np.random.default_rng(seed)
    a, b = rng.integers(0, n, edges), rng.integers(0, n - 1, edges)
    b = b + (b >= a)  # no self loops
    u, v = np.minimum(a, b), np.maximum(a, b)
    order = np.argsort(u, kind="stable")
    P = CardPath(u=torch.from_numpy(u[order].astype(np.int32)), v=torch.from_numpy(v[order].astype(np.int32)),
                 n_vertices=n)
    c = torch.ones(edges, dtype=torch.float32)
    return P, OnesRow(c=c, inv_bound=torch.tensor(4.0 / n, dtype=torch.float32))


def run_mwu_cell(mesh_kind: str = "single", scale: int = 22, edgefactor: int = 16) -> dict:
    """The paper's workload: rank 0's lane of the distributed MWU matching
    on 2^scale vertices (module docstring)."""
    from ..core import mwu
    from ..dist.mesh import MeshPlan
    from ..dist.shard import PodSum

    pod, data = 256, (2 if mesh_kind == "pod2" else 1)
    n = 1 << scale
    m = edgefactor * n
    edges = -(-m // pod)
    rec = {"arch": "mwu-graph", "shape": f"match-2^{scale}", "mesh": mesh_kind, "step": "mwu", "ok": False,
           "plan": {"pod": pod, "data": data}, "n_devices": pod * data, "vertices": n, "edges": m,
           "slab_edges": edges, "bounds": data}
    opts = mwu.MWUOptions(eps=0.1, step_rule="binary", max_iter=MWU_BUDGET)
    with fake_world(pod * data):
        group = MeshPlan(pod=pod, data=data).build().pod_group
        P, C = _slab_problem(n, edges)
        arg = sum(t.numel() * t.element_size() for t in (P.u, P.v, C.c))
        with torch.no_grad():
            with OpCounter() as c0:
                state, _, rec_t = mwu._start([(PodSum(P, group), PodSum(C, group), None, None)], opts, group=group,
                                             init_cols=m)
            live = c0.live_bytes()
            iters, probes = [], []
            for _ in range(MWU_COUNTED_ITERS):
                with OpCounter() as c:
                    mwu._iteration(state[0], mwu._record_fn(opts.step_rule), opts.ls_tol)
                iters.append(c.report)
                probes.append(mwu._advance(state[0], rec_t.tolist()[0])[3])
    it = OpReport.combine([(1.0 / len(iters), r) for r in iters])
    report = OpReport.combine([(1, c0.report), (MWU_BUDGET, it)])
    rec["memory"] = {"argument_bytes": arg, "temp_bytes": max(c0.report.peak_live_bytes,
                                                              live + max(r.peak_live_bytes for r in iters))}
    rec["memory"]["peak_bytes"] = rec["memory"]["argument_bytes"] + rec["memory"]["temp_bytes"]
    rec["counts"] = report.as_dict()
    rec["start"] = c0.report.as_dict()
    rec["iteration"] = it.as_dict()
    rec["iterations"] = {"budget": MWU_BUDGET, "counted": MWU_COUNTED_ITERS, "probes": probes}
    # the reference's model: two products a iteration over the 2 m nonzeros, with their vector work, 12 flops each
    rec["model_flops"] = {"total": MWU_BUDGET * 12.0 * 2 * m}
    rec["roofline"] = roofline_terms(report, n_devices=pod * data, model_flops=rec["model_flops"]["total"])
    rec["ok"] = True
    return rec


def summary(rec: dict) -> str:
    """One line of a record: peak GB and TFLOP a device, the roofline terms and the bottleneck."""
    r, mem = rec["roofline"], rec["memory"]
    return (f"{mem['peak_bytes'] / 1e9:.2f} GB a device, {rec['counts']['flops'] / 1e12:.3f} TFLOP; "
            f"compute {r['compute_s']:.3e} s, memory {r['memory_s']:.3e} s, collective {r['collective_s']:.3e} s; "
            f"bottleneck {r['bottleneck']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Dry run of every (arch x shape x mesh) cell on the meta device")
    ap.add_argument("--arch", default=None, help="a registry id, an -mwu variant, or mwu-graph")
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "pod2", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--loss-chunk", type=int, default=512)
    ap.add_argument("--attn-chunk", type=int, default=None)
    ap.add_argument("--no-shard-seq", action="store_true",
                    help="decode: replicate the KV cache seq dim instead of TP-sharding")
    ap.add_argument("--remat", default=None, choices=[None, "none", "full"])
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = ["single", "pod2"] if args.mesh == "both" else [args.mesh]
    cells = [(a, s, m) for a in archs for s in shapes for m in meshes]

    if args.list:
        for a, s, m in cells:
            r = skip_reason(get(a), SHAPES[s])
            print(f"{a:20s} {s:12s} {m:7s} {'SKIP: ' + r if r else 'run'}")
        return 0

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    failed = 0
    if args.arch == "mwu-graph":
        jobs = [(f"mwu-graph__match__{m}.json", f"mwu-graph / match / {m}", {"arch": "mwu-graph", "mesh": m},
                 lambda m=m: run_mwu_cell(m)) for m in meshes]
    else:
        tag = f"__{args.tag}" if args.tag else ""
        jobs = [(f"{a}__{s}__{m}{tag}.json", f"{a} / {s} / {m}", {"arch": a, "shape": s, "mesh": m},
                 lambda a=a, s=s, m=m: run_cell(a, s, m, loss_chunk=args.loss_chunk, attn_chunk=args.attn_chunk,
                                                extra_tag=args.tag, decode_shard_seq=not args.no_shard_seq,
                                                remat=args.remat))
                for a, s, m in cells]
    for fname, title, key, job in jobs:
        print(f"=== {title} ===", flush=True)
        t0 = time.perf_counter()
        try:
            rec = job()
        except Exception as e:  # a failed cell is recorded: it is a dry-run bug
            rec = {**key, "ok": False, "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
            print(f"  FAILED: {rec['error'][:300]}", flush=True)
            failed += 1
        (OUT_DIR / fname).write_text(json.dumps(rec, indent=1))
        if rec.get("ok"):
            print(f"  ok in {time.perf_counter() - t0:.1f} s: {summary(rec)}", flush=True)
        elif rec.get("skipped"):
            print(f"  skipped: {rec['reason']}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())

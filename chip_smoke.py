#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--n-users N] [--serve-requests N]

Builds the CUDA kernels of ``src/repro_torch/kernels/csrc`` with nvcc for
sm_90a and drives the port's three paths, the MWU graph-LP solve, the
hubert-xlarge encoder forward and graph-LP serving (``repro_torch.lpserve``),
and the paper's two comparison studies (Table 3's step rules, Figure 3's
MPCSolver baseline), in seven phases; any failed phase exits non-zero
before the result lines are printed.

1. Card: its name and power limit (nvidia-smi) and the kernels' build time.
2. Kernels vs their plain PyTorch versions on the card, at the main path's
   shapes, in float32 and float64: max error against the bar; the device
   time of the kernel and of the plain version (one call captured in a
   CUDA graph and replayed between CUDA events); the time of an eager call,
   which for short vectors is the host's cost; one library call computing
   the same function where there is one; and the bound (bytes read once
   and written once over 3.35 TB/s, or operations over the card's peak).
   Flash attention gets rows at published widths: (a) hubert-xlarge's
   attention (B 16, S 1500, 16 heads, d 80, bidirectional) and (b)
   minitron-4b's (B 1, S 4096, 24 over 8 heads, d 128, causal) in bf16 and
   f32, and (c) mixtral-8x22b's (B 1, S 6144, 48 over 8 heads, d 128,
   causal, window 4096) in bf16. Within bar means |kernel - plain| <= bar * (1 + |plain|)
   elementwise (tests/test_kernels.py's atol = rtol). At these sizes every
   call is bound by the device, so the plain version is timed eagerly (its
   f32 scores take up to 7 GB, too much to capture twice in a CUDA graph);
   the library time is ``scaled_dot_product_attention`` with the same mask,
   a yardstick the port never calls. Each flash row also prints its
   achieved TFLOP/s (4 d flops per scored pair over the device time) and,
   in bf16, the kernel's tile choices (swizzle, boxes, stages, tile rows,
   shared memory) as the built library reports them. The f32 rows are
   bound by 3x their flops over the TF32 tensor-core peak (the kernel's
   3xTF32 products), and also print the bound of the same flops once at f32
   FMA, SDPA's time in f32, and the card's name and power limit. Both
   bodies' ptxas lines (registers, spills) are printed per head dim, and a
   spill at d 80 or 128 in either fails the phase. The Newton search runs on three seeded
   states a dtype: equal bit for bit to the host loop over the probe
   kernel, and within ls_eps * alpha of its plain version (the same loop
   over plain PyTorch probes), whose time is the row's plain time. Its
   step form, as the MWU loop launches it (max(d) and the warm start read
   from device memory, the record [alpha, probes, completes, step, bad]
   written there), gets a row of its own, held on those states and one
   whose alpha < 1, at max(d) > 0 and = 0, to the host loop bit for bit
   and to its plain version. The binary search kernel (Alg. 3 in one
   launch, ``binary_rows``) gets its step-form row at the solve's shape and
   masked at phase 6's bucket, held in both forms to the host loop over the
   probe kernel bit for bit (alpha, probes, completes; step, bad and
   alpha_prev) and to its plain version within ls_eps where alpha >= 1.
   The axpy gets a second row too: its step read
   from device memory (the form the loop launches), bit for bit the
   host-float form and the plain version, in place as well.
   ``step_direction`` (g gathered from w, as bmatch's solve runs it) must
   give d bit for bit as the plain eager chain, in both of its sources, and
   max(d) exactly. ``incidence_scatter`` runs M x with the items' Zipf
   popularity of the bmatch graph (one item of ~740k entries): within
   1e-4 (f32) / 1e-10 (f64) of its plain version relative to max(1,
   |plain|), two launches bitwise equal, with the v side as the operator
   cuts it into slabs of x and in one piece (that segment spans hundreds
   of merge tiles); its library time is the two ``index_add_`` calls it
   replaces. The masked forms (row masks, one byte a row: the padded rows
   of phase 6's requests) get rows of their own at phase 6's bucket
   V1048576xE4194304 with tier 1's rows real: the gather over the padded
   match operator's edges (a masked ``Incidence`` is no plain gather, so
   served match lanes launch it; beside cuSPARSE's M^T w), softmax over the vertex rows
   (weights exactly 0 off the mask), the two-sided probe over both (mins
   exact), the search in both forms at a served match request's shape (the
   vertex rows masked) held as above (bit for bit against the host loop
   over the masked probe kernel, within ls_eps of the masked plain loop),
   the axpy's min and max over the edge rows (exact; the update bit for
   bit over every row), and the scatter over the match operator of tier
   1's request padded onto the bucket (3M of 4,194,304 edges kept; x fits
   the L2), held as above, with cuSPARSE's time.
3. The full-size solve: bipartite matching (bmatch) at float64 on the
   Netflix Prize shape, ``bipartite_ratings(480_189, 17_770,
   avg_ratings=209, seed=0)`` (498k vertices, 98.6M edges), through
   ``Solver(MWUOptions(eps=0.1, step_rule="newton"), batch_width=4)``,
   whose rounds of four bounds run as the four lanes of one
   ``solve_batch``: the phase prints each round's lanes, bounds, lane
   iterations and wall time, the loop iterations (the longest lane's a
   round), the certificate's time alone (``certify_solution``, on the
   host), peak memory of a plain Solver's solve and the lanes' state as
   reckoned beforehand. Round
   1's four lanes must equal four sequential ``feasible()`` solves at its
   bounds bit for bit (status, iterations, probes, certificates, x).
   The certified objective must be within 1.5*eps of the exact maximum
   matching (scipy's Hopcroft-Karp; the bipartite matching LP is
   integral) and max(Mx), recomputed on the host, at most 1 + 1e-9.
   The scatter's CSR (bytes, build time) is built first. The solve runs
   twice: the two must give the same feasibility calls, iterations,
   probes, objective and x bits (no atomics in the scatter). The launch
   counts of the first show that it went through every MWU kernel but the
   probe's and the standalone gather's: the Newton search and the step
   direction, each launched once a lane iteration, the axpy three times,
   probe and gather inside their own launches. One more feasibility solve
   at the certified bound, and round 1's batch again, are each timed, then
   profiled (the two repeat) for the device time by kernel, the search's
   share, the device's idle share and the host reads (device-to-host
   copies) a loop iteration, which must be one, plus three at most for
   the run; the profile must show the scatter and step-direction kernels
   and no ``index_add_`` kernel. ``--n-users`` cuts the user count (items
   and ratings per user stay).
4. Small solves, card vs CPU, for all six families: same status, bound
   within rel 1e-5, objective within rel 2*eps; each card solve run twice
   repeats bit for bit, and their launches give the gather's count in the
   kernels line. Then four-lane ``solve_batch`` calls on the card for
   the six families and a ``stack_problems`` batch of two match instances
   (erdos(4096, 40000)): each lane equal to the card's ``feasible()`` at
   its bound bit for bit. Then match and vcover on
   rgg(12) with ``step_rule="binary"``: the binary search kernel once a
   lane iteration (its launches are its count in the kernels line), no
   lone probe (the probe's count there: 0), the host read once a loop
   iteration (printed), and each solve's status, iterations, probes and
   ``sha256 binary x`` line to compare with another tree
   (``tools/binary_bits.py``).
5. The hubert-xlarge encoder forward at full width: 48 layers, d_model
   1280, 16 heads of d 80, ``attn_impl="pallas"``, bf16 compute over f32
   params from a seeded random init, on 16 utterances x 1500 frames (30 s
   at 50 frames/s; frames N(0, 0.02^2)), ``forward`` + ``logits`` under
   ``torch.inference_mode``. The launch counts of one forward must show
   flash attention 48 times; the logits must be finite and agree with the
   dense-attention forward on the same weights within a relative L2 error
   of 5e-2 (bf16 rounds at other places in the two paths, through 48
   residual layers). Time per forward, frames/s, peak memory, and a
   torch.profiler breakdown (flash, matmuls, the rest) with the device's
   idle share.
6. Graph-LP serving at card size: 12 requests (``--serve-requests``),
   match and vcover alternating, request i on ``erdos(n, m, seed=i)`` of
   tier i % 3 of (600k, 2.2M), (800k, 3M), (1.5M, 4M) vertices and edges,
   through ``LPEngine(LPServeConfig(MWUOptions(eps=0.1,
   step_rule="newton"), lanes=4))`` with the default bucket policy, in
   float64: buckets V1048576xE4194304 and V2097152xE4194304, four
   dispatch keys, every lane padded and masked. Prints per bucket its
   requests, batches, occupancy and padding waste; latency p50 and p99 and
   the engine's wall time, split into its rounds, its certificates (host
   clock) and the rest; each round's lanes, iterations and time; per
   request its calls and objective. Fails unless every request is found
   and feasible, max Mx <= 1 + 1e-9 (match) or min M^T x >= 1 - 1e-9
   (vcover) recomputed on the host, each objective within 3*eps of the
   sequential ``Solver(batch_width=1).solve`` on the card
   (examples/serve_lp_batch.py's contract), batches < feasibility calls,
   and every lane iteration launched the search and the step direction
   once (no lone probe). One more round, profiled (a fresh engine's
   second round over four tier-0/1 match requests, their CSR built by its
   first), must read the host at most its loop iterations + 3 times; it
   prints its device time by kernel, the device-to-host copies' time and
   the idle share against the same round of another fresh engine timed
   without the profiler.
7. The paper's comparison studies at full width, on phase 3's graph,
   float64. (a) Table 3: one profiled ``Solver.feasible`` of phase 3's
   bmatch problem at its certified bound per step rule, newton, binary
   and std (std cut to 500 iterations; the cut is printed): status,
   iterations, probes an iteration, device ms a lane iteration, ms a
   search launch, host reads a loop iteration (at most 1.01 for every
   rule, else the phase fails) and the idle share. (b) Figure 3:
   generalized matching with ``benchmarks/bench_convergence.py``'s bounds
   (users lb = min(3, deg), ub = 5; items ub = 200), eps 0.05, by
   ``solve_traced`` with the newton and the std rule and by ``mpc_solve``,
   each cut to 2,000 iterations (std to 500): iterations to eps (or "not
   reached by the cap"), the final violation, ms an iteration and host reads an
   iteration; first ``mpc_solve`` on a small instance on the card against
   the CPU (the same iterations, x within rel 1e-9).

The line before the last is ``{"kernels": [...]}``, one entry per kernel;
the last is ``{"ok": true, "device": {...}}``. The flash entry takes row
(a) in bf16 and its launches from phase 5; the axpy and the searches take
the row of the form the main path launches (device step, step form), and
each MWU kernel's masked row goes into its entry's ``masked`` field. Every
entry's launches add phase 6's (``serving_launches``). The script exits non-zero
without a result when no CUDA device is present or when it is run outside
the repository.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# peak rates: f32 and f64 outside the tensor cores, bf16 and TF32 on them
# (dense; NVIDIA H100 SXM data sheet). The f32 flash kernel multiplies on
# the TF32 tensor cores, three times a product (3xTF32): its bound is 3x its
# flops over the "tf32" rate.
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12, torch.bfloat16: 989e12, "tf32": 495e12}
LOGITS_REL_L2_BAR = 5e-2  # pallas vs dense forward of phase 5, bf16 through 48 layers
# bf16 flash rows, whole tensor: ||kernel - plain|| / ||plain||. The two
# differ by where p is rounded to bf16 (unnormalised in the kernel, after
# the division in the plain version): ~3e-3 at every bf16 row. The bar is
# twice that, so a fault of 1% (a few unmasked keys in a row of 1,500)
# fails it; the elementwise bar alone lets such a fault through.
FLASH_REL_L2_BAR = 6e-3
EPS = 0.1
# the form of a kernel that the main path launches, where a kernel has two
# rows in phase 2 (its kernels-line entry takes that row); the "masked"
# rows of phase 6's forms go into the entry's "masked" field
MAIN_FORM = {"axpy_reduce": "device step", "newton_search": "step", "binary_search": "step"}
MASKED_FORM = {"softmax_weights": "masked", "linesearch_probe": "masked", "newton_search": "step masked",
               "binary_search": "step masked", "axpy_reduce": "masked", "incidence_scatter": "masked",
               "incidence_gather": "masked"}
# phase 7: iteration caps of the comparison studies (cuts: the reference's
# bench_convergence.py runs 6,000 iterations, MWUOptions' default cap is
# 5,000). The std rule, whose iterations are alike (alpha 1, no search),
# is cut further to keep the phase short: it reaches neither the bound nor
# eps within any of these caps.
TABLE3_STD_CAP = 500
FIG3_CAP = 2_000
FIG3_STD_CAP = 500
FIG3_EPS = 0.05
# phase 6: graph-LP serving, request i on erdos(n, m, seed=i) of tier i % 3,
# match and vcover alternating; both buckets have 4,194,304 edge slots
SERVE_TIERS = [(600_000, 2_200_000), (800_000, 3_000_000), (1_500_000, 4_000_000)]
SERVE_BUCKET = (1 << 20, 1 << 22)  # tiers 0 and 1


class SmokeFailure(RuntimeError):
    pass


def sha256(t) -> str:
    """sha256 of a tensor's or an array's bytes, to compare two trees' bits."""
    a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def check(failures: list, ok: bool, what: str) -> None:
    print(("  ok    " if ok else "  FAIL  ") + what, flush=True)
    if not ok:
        failures.append(what)


def end_phase(name: str, failures: list) -> None:
    if failures:
        raise SmokeFailure(f"phase {name} failed: {failures}")


def _events_ms(run, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def call_ms(fn, reps: int) -> float:
    """Mean time of back-to-back eager calls of fn() from CUDA events, after a
    warm-up call: for short vectors this is the host's cost of a call."""
    fn()
    torch.cuda.synchronize()
    return _events_ms(fn, reps)


def device_ms(fn, reps: int) -> float:
    """Mean device time of fn(): one call captured in a CUDA graph, the graph
    replayed back to back between CUDA events, so no host cost is counted."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    return _events_ms(graph.replay, reps)


def host_ms(fn, reps: int = 20) -> float:
    """Mean host-clock time of fn() after a warm-up call: for loops that
    read the card back between launches."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t0) / reps


@contextlib.contextmanager
def counted_reads():
    """Count the host's reads of CUDA tensors' values (``item``,
    ``tolist``, ``float``, ``cpu``, ``numpy``) while active: yields a
    one-element list that holds the count."""
    reads, active = [0], [False]
    saved = {name: getattr(torch.Tensor, name) for name in ("item", "tolist", "__float__", "cpu", "numpy")}

    def counting(method):
        def read(t, *a, **k):
            if t.is_cuda and not active[0]:
                reads[0] += 1
            active[0], outer = True, active[0]
            try:
                return method(t, *a, **k)
            finally:
                active[0] = outer
        return read

    for name, method in saved.items():
        setattr(torch.Tensor, name, counting(method))
    try:
        yield reads
    finally:
        for name, method in saved.items():
            setattr(torch.Tensor, name, method)


def bound(nbytes: int, ops: int, rate) -> tuple[float, str]:
    """Least time (ms) for the bytes over HBM's rate or the ops over the
    peak of ``rate`` (a key of PEAK_OPS_PER_S), the larger, and which."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[rate]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


# -- phase 2 -----------------------------------------------------------------
def scatter_inputs(n_vertices: int, n_items: int, n_edges: int, seed: int = 0) -> tuple:
    """The scatter's edges at the bmatch graph's shape: users ascending, items
    of the Zipf popularity of graphs/generators.py (item = n_items / rank,
    rank = U^-2 at zipf_a 1.5: item 0 holds ~E / sqrt(n_items) entries);
    u, v int32 on the card from a generator seeded with ``seed``."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_users = n_vertices - n_items
    u = torch.randint(0, n_users, (n_edges,), generator=gen, device=dev, dtype=torch.int32).sort().values
    v = n_users + torch.clamp((n_items * torch.rand(n_edges, generator=gen, device=dev, dtype=torch.float64) ** 2)
                              .to(torch.int32), max=n_items - 1)
    return u, v


def scatter_x(n_edges: int, dtype, seed: int = 1) -> torch.Tensor:
    """The scatter's x: n_edges values in [0, 1) on the card, seeded."""
    dev = torch.device("cuda")
    return torch.rand(n_edges, generator=torch.Generator(device=dev).manual_seed(seed), device=dev, dtype=dtype)


def serving_scatter_op():
    """The match operator of phase 6's request 4 (tier 1: erdos(800_000,
    3_000_000, seed=4)) as the engine serves it: padded by ``pad_problem``
    onto the bucket V1048576xE4194304, its padded edges masked."""
    from repro_torch.graphs import build, erdos
    from repro_torch.lpserve import BucketSpec, pad_problem

    return pad_problem(build("match", erdos(*SERVE_TIERS[1], seed=4), device="cuda"), BucketSpec(*SERVE_BUCKET)).P


def sparse_matrix(sides, dtype) -> torch.Tensor:
    """The rows x cols ``torch.sparse_csr_tensor`` (int32 indices) of the
    segments' entries, all sides together: ``torch.mv`` over it (cuSPARSE)
    is the one PyTorch call that computes the same product. A yardstick,
    which the port never calls."""
    rows, cols, vals = [], [], []
    for s in sides:
        q = torch.arange(s.slabs * s.span, device=s.offsets.device)
        rows.append(s.lo + torch.repeat_interleave(q, s.offsets[1:] - s.offsets[:-1], output_size=s.nnz) % s.span)
        cols.append(torch.arange(s.nnz, dtype=torch.int32, device=q.device) if s.src is None else s.src)
        vals.append(torch.ones(s.nnz, dtype=dtype, device=q.device) if s.wt is None else s.wt.to(dtype))
    r, order = torch.sort(torch.cat(rows), stable=True)
    n = sides[0].rows
    crow = torch.searchsorted(r, torch.arange(n + 1, device=r.device)).to(torch.int32)
    return torch.sparse_csr_tensor(crow, torch.cat(cols)[order], torch.cat(vals)[order], size=(n, sides[0].cols),
                                   check_invariants=False)


def kernel_rows(K, refs, n_vertices: int, n_items: int, n_edges: int, dtype, eta: float,
                failures: list) -> list[dict]:
    """Each kernel vs its plain version at the main path's shapes in ``dtype``."""
    from repro_torch.core.mwu import make_eta
    from repro_torch.core.operators import Incidence
    from repro_torch.kernels.incidence_scatter import MERGE_TILE, segments

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    size = torch.finfo(dtype).bits // 8
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    rows = []

    def row(name, shape, err, bar, ok, kernel, plain, reps, nbytes, ops, library=None, form=None):
        b_ms, b_by = bound(nbytes, ops, dtype)
        r = dict(name=name, form=form, dtype=str(dtype).removeprefix("torch."), shape=shape, max_abs_err=err, bar=bar,
                 within_bar=ok,
                 ms=device_ms(kernel, reps), plain_ms=device_ms(plain, reps), bound_ms=b_ms, bound_by=b_by,
                 library_ms=None if library is None else call_ms(library, reps),
                 call_ms=call_ms(kernel, reps), plain_call_ms=call_ms(plain, reps))
        check(failures, ok, f"{name}{'' if form is None else f' ({form})'} {r['dtype']} {shape}: max_abs_err "
                            f"{err:.3g} (bar {bar}); device ms: kernel "
                            f"{r['ms']:.4f}, plain {r['plain_ms']:.4f}, library {r['library_ms']}, bound "
                            f"{b_ms:.4f} ({b_by}); per eager call: kernel {r['call_ms']:.4f}, plain "
                            f"{r['plain_call_ms']:.4f}")
        rows.append(r)

    # incidence gather at E edges over n vertices, laid out as the bmatch
    # graph's edges are: users ascending, each rating a random item
    E, n = n_edges, n_vertices
    u = torch.randint(0, n - n_items, (E,), generator=gen, device=dev, dtype=torch.int32).sort().values
    v = torch.randint(n - n_items, n, (E,), generator=gen, device=dev, dtype=torch.int32)
    w = torch.rand(n, generator=gen, device=dev, dtype=dtype)
    err = (K.incidence_gather(u, v, w) - refs["incidence_gather"](u, v, w)).abs().max().item()
    # one library call computing the same function: the CSR product M^T w
    crow = torch.arange(0, 2 * E + 1, 2, device=dev, dtype=torch.int32)
    mt = torch.sparse_csr_tensor(crow, torch.stack([u, v], dim=1).reshape(-1),
                                 torch.ones(2 * E, device=dev, dtype=dtype), size=(E, n), check_invariants=False)
    lib_err = (torch.mv(mt, w) - K.incidence_gather(u, v, w)).abs().max().item()
    check(failures, lib_err <= tol, f"sparse M^T w agrees with the gather ({lib_err:.3g})")
    row("incidence_gather", [E, n], err, 0.0, err == 0.0, lambda: K.incidence_gather(u, v, w),
        lambda: refs["incidence_gather"](u, v, w), 10, E * (4 + 4 + size) + n * size, E, lambda: torch.mv(mt, w))
    del crow, mt

    # the step direction with its max, g gathered from w (bmatch's source):
    # d bit-equal to the plain eager chain, max(d) exact; the read source on
    # the same g too
    h = torch.rand(E, generator=gen, device=dev, dtype=dtype) * 2.0
    x = torch.rand(E, generator=gen, device=dev, dtype=dtype)
    scale = float(torch.tensor(1.0 / eta, dtype=dtype))  # bmatch is pure packing
    d, dmax = K.step_direction(h, x, scale, gather=(u, v, w))
    d_r, dmax_r = refs["step_direction"](h, x, scale, gather=(u, v, w))
    d2, dmax2 = K.step_direction(h, x, scale, g=refs["incidence_gather"](u, v, w))
    same = torch.equal(d, d_r) and torch.equal(d2, d_r) and dmax.item() == dmax_r.item() == dmax2.item()
    err = (d - d_r).abs().max().item()
    positive = (d > 0).float().mean().item()
    del d, d_r, d2
    check(failures, same, f"step_direction {dtype} [{E}, {n}]: d bit-equal to the plain chain in both sources, "
                          f"max(d) {dmax.item():.6g} exact ({positive:.1%} of d > 0)")
    row("step_direction", [E, n], err, 0.0, same, lambda: K.step_direction(h, x, scale, gather=(u, v, w)),
        lambda: refs["step_direction"](h, x, scale, gather=(u, v, w)), 10, E * (4 + 4 + 3 * size) + n * size, 6 * E)
    del h, x, w
    torch.cuda.empty_cache()

    # the scatter M x at the bmatch graph's shape with the items' Zipf
    # popularity (scatter_inputs: item 0 holds ~740k entries). The v side as
    # the operator builds it (cut into slabs of x) and in one piece (no
    # slabs: one segment of hundreds of merge tiles); in both many CSR rows
    # cross merge-tile edges. Its library time is cuSPARSE's CSR product;
    # the two index_add_ calls the kernel replaced are printed beside it
    del u, v
    u, v = scatter_inputs(n, n_items, E)
    op = Incidence(u=u, v=v, n_vertices=n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a, b = op.csr
    order = op.scatter_order
    torch.cuda.synchronize()
    t_csr = time.perf_counter() - t0
    whole = segments(v, n, E, slab_cols=E)

    def crossing(s) -> int:  # CSR rows whose merge items span two tiles or more
        q = torch.arange(s.offsets.shape[0] - 1, device=dev)
        return int(((q + s.offsets[:-1]) // MERGE_TILE != (q + s.offsets[1:]) // MERGE_TILE).sum())

    longest = int((whole.offsets[1:] - whole.offsets[:-1]).max())
    cross = [crossing(s) for s in (a, b, whole)]
    check(failures, longest >= 2**18 and min(cross[1:]) > 0 and a.src is None and b.slabs > 1,
          f"scatter segments: u side sorted (no permutation: {a.src is None}); v side in {b.slabs} slabs of rows "
          f"[{b.lo}, {b.lo + b.span}); longest segment in one piece {longest} entries (>= 2^18); CSR rows across "
          f"merge tiles (u, v, v in one piece) {cross}; CSR {(a.nbytes + b.nbytes) / 1e6:.1f} MB and the "
          f"dispatch order of {a.tiles} + {b.tiles} tiles built in {t_csr:.2f} s")
    x = scatter_x(E, dtype)
    got, again = K.incidence_scatter(x, a, b, order=order), K.incidence_scatter(x, a, b, order=order)
    ref = refs["incidence_scatter"](x, a, b)
    same = torch.equal(got, again)
    err = ((got - ref).abs() / ref.abs().clamp(min=1.0)).max().item()
    side_major = K.incidence_scatter(x, a, b, order=torch.arange(a.tiles + b.tiles, dtype=torch.int32, device=dev))
    check(failures, torch.equal(side_major, got), f"incidence_scatter {dtype}: the side-major and the interleaved "
                                                  f"dispatch orders give the same bits")
    if dtype == torch.float64:
        print(f"sha256 scatter f64 [{E}, {n}]: {sha256(got)}", flush=True)
    one, one_again = K.incidence_scatter(x, a, whole), K.incidence_scatter(x, a, whole)
    one_err = ((one - ref).abs() / ref.abs().clamp(min=1.0)).max().item()
    check(failures, torch.equal(one, one_again) and one_err <= tol,
          f"incidence_scatter {dtype}, v side in one piece: two launches bitwise equal, {one_err:.3g} from the "
          f"plain version (relative; bar {tol})")
    del one, one_again, whole, side_major
    mat = sparse_matrix((a, b), dtype)
    lib, lib_again = torch.mv(mat, x), torch.mv(mat, x)
    lib_err = ((lib - ref).abs() / ref.abs().clamp(min=1.0)).max().item()
    print(f"  cuSPARSE torch.mv {dtype} [{E}, {n}]: two calls bit-equal: {torch.equal(lib, lib_again)}", flush=True)
    check(failures, lib_err <= tol, f"cuSPARSE torch.mv M x agrees with the plain version ({lib_err:.3g}, relative)")
    del lib, lib_again
    add_err = ((torch.zeros(n, dtype=dtype, device=dev).index_add_(0, u, x).index_add_(0, v, x) - ref).abs()
               / ref.abs().clamp(min=1.0)).max().item()
    del got, again, ref
    check(failures, same, f"incidence_scatter {dtype} [{E}, {n}]: two launches bitwise equal")
    check(failures, add_err <= tol, f"index_add_ M x agrees with the plain version ({add_err:.3g}, relative)")
    row("incidence_scatter", [E, n], err, tol, err <= tol and same, lambda: K.incidence_scatter(x, a, b, order=order),
        lambda: refs["incidence_scatter"](x, a, b), 10, E * (size + 4) + 2 * (n + 1) * 8 + n * size, 2 * E,
        lambda: torch.mv(mat, x))
    rows[-1]["index_add_ms"] = call_ms(lambda: torch.zeros(n, dtype=dtype, device=dev).index_add_(0, u, x)
                                       .index_add_(0, v, x), 10)
    print(f"  incidence_scatter {dtype} [{E}, {n}]: cuSPARSE {rows[-1]['library_ms']:.4f} ms, index_add_ x2 "
          f"{rows[-1]['index_add_ms']:.4f} ms (eager calls)", flush=True)
    del u, v, x, op, a, b, order, mat
    torch.cuda.empty_cache()

    # softmax weights on the packing side (n) and the one-row objective side
    # (1); the two-sided probe at the solve's shape, both sides in one launch
    reps = 200
    for m in (n, 1):
        y = torch.rand(m, generator=gen, device=dev, dtype=dtype) * 1.1
        lse, wk = K.softmax_weights(y, eta, 1.0)
        lse2, wk2 = K.softmax_weights(y, eta, 1.0)
        lse_r, w_r = refs["softmax_weights"](y, eta, 1.0)
        lse_err = abs(lse.item() - lse_r.item())
        err = max(lse_err, (wk - w_r).abs().max().item())
        ok = lse_err <= tol * max(1.0, abs(lse_r.item())) and (wk - w_r).abs().max().item() <= tol
        same = torch.equal(wk, wk2) and lse.item() == lse2.item()
        check(failures, same, f"softmax_weights {dtype} [{m}]: two launches bitwise equal")
        row("softmax_weights", [m], err, tol, ok and same, lambda: K.softmax_weights(y, eta, 1.0),
            lambda: refs["softmax_weights"](y, eta, 1.0), reps, 2 * m * size, 7 * m)
        del y

    y, dy = (torch.rand(n, generator=gen, device=dev, dtype=dtype) * s for s in (1.1, 1e-3))
    z, dz = (torch.rand(1, generator=gen, device=dev, dtype=dtype) * s for s in (1.1, 1e-3))
    got, again = (K.linesearch_probe2(y, dy, z, dz, 7.5, eta) for _ in range(2))
    ref = refs["linesearch_probe2"](y, dy, z, dz, 7.5, eta)
    err = (got - ref).abs().max().item()
    ok = err <= tol * max(1.0, ref.abs().max().item()) and got[2].item() == ref[2].item() and got[5].item() == ref[5].item()
    same = torch.equal(got, again)
    check(failures, same, f"linesearch_probe {dtype} [{n}, 1]: two launches bitwise equal")
    row("linesearch_probe", [n, 1], err, tol, ok and same, lambda: K.linesearch_probe2(y, dy, z, dz, 7.5, eta),
        lambda: refs["linesearch_probe2"](y, dy, z, dz, 7.5, eta), reps, 2 * (n + 1) * size, 9 * (n + 1))
    del y, dy, z, dz
    rows += search_rows(K, n, dtype, eta, failures)
    rows += binary_rows(K, n, dtype, eta, failures)

    # fused update at E (the x update)
    y = torch.rand(E, generator=gen, device=dev, dtype=dtype)
    dy = torch.rand(E, generator=gen, device=dev, dtype=dtype)
    out, mn, mx = K.axpy_reduce(y, dy, 3.25)
    out_r, mn_r, mx_r = refs["axpy_reduce"](y, dy, 3.25)
    err = max((out - out_r).abs().max().item(), abs(mn.item() - mn_r.item()), abs(mx.item() - mx_r.item()))
    del out, out_r
    row("axpy_reduce", [E], err, min(tol, 1e-6), err <= min(tol, 1e-6), lambda: K.axpy_reduce(y, dy, 3.25),
        lambda: refs["axpy_reduce"](y, dy, 3.25), 10, 3 * E * size, 4 * E, form="host alpha")
    # the device-step form, as the MWU loop runs it: the step read from
    # device memory, [min, max] into a float64 slot; bit for bit the
    # host-float form and the plain version, into another tensor and in place
    step, red = torch.tensor([3.25], dtype=torch.float64, device=dev), torch.empty(2, dtype=torch.float64, device=dev)
    buf = torch.empty_like(y)
    out, mn, mx = K.axpy_reduce(y, dy, 3.25)
    out_r = refs["axpy_reduce"](y, dy, step)[0]
    got, gmn, gmx = K.axpy_reduce(y, dy, step, out=buf, red=red)
    same = torch.equal(got, out) and torch.equal(got, out_r) and (gmn.item(), gmx.item()) == (mn.item(), mx.item())
    inplace = y.clone()
    K.axpy_reduce(inplace, dy, step, out=inplace)
    same = same and torch.equal(inplace, out)
    err = (got - out_r).abs().max().item()
    del out, out_r, inplace
    check(failures, same, f"axpy_reduce {dtype} [{E}], device step: bit-equal to the host-float form and the plain "
                          f"version, in place too; [min, max] into the record slot")
    # the plain version reads the step as a host float (a read would stop
    # the CUDA graph the time is taken from): the same arithmetic
    row("axpy_reduce", [E], err, 0.0, same, lambda: K.axpy_reduce(y, dy, step, out=buf, red=red),
        lambda: refs["axpy_reduce"](y, dy, 3.25), 10, 3 * E * size, 4 * E, form="device step")
    del y, dy, buf
    torch.cuda.empty_cache()

    # the masked forms, at phase 6's bucket V1048576xE4194304 with tier 1's
    # real rows first (800k vertices, 3M edges), as pad_problem lays them
    # out: softmax over the vertex rows, the two-sided probe over both, the
    # search at a served match request's shape (the vertex rows masked, the
    # objective row not), the z update's min and max over the edge rows
    V, Eb = SERVE_BUCKET
    kv = torch.arange(V, device=dev) < SERVE_TIERS[1][0]
    ke = torch.arange(Eb, device=dev) < SERVE_TIERS[1][1]
    eta_b = float(make_eta(V + 1, EPS))
    y = torch.rand(V, generator=gen, device=dev, dtype=dtype) * 1.1
    lse, wk = K.softmax_weights(y, eta_b, 1.0, keep=kv)
    lse_r, w_r = refs["softmax_weights"](y, eta_b, 1.0, keep=kv)
    lse_err, w_err = abs(lse.item() - lse_r.item()), (wk - w_r).abs().max().item()
    ok = lse_err <= tol * max(1.0, abs(lse_r.item())) and w_err <= tol and not wk[~kv].any()
    row("softmax_weights", [V], max(lse_err, w_err), tol, ok, lambda: K.softmax_weights(y, eta_b, 1.0, keep=kv),
        lambda: refs["softmax_weights"](y, eta_b, 1.0, keep=kv), reps, 2 * V * size + V, 7 * V, form="masked")
    dy = torch.rand(V, generator=gen, device=dev, dtype=dtype) * 1e-3
    z, dz = (torch.rand(Eb, generator=gen, device=dev, dtype=dtype) * s for s in (1.1, 1e-3))
    got = K.linesearch_probe2(y, dy, z, dz, 7.5, eta_b, p_keep=kv, c_keep=ke)
    ref = refs["linesearch_probe2"](y, dy, z, dz, 7.5, eta_b, kv, ke)
    err = (got - ref).abs().max().item()
    ok = err <= tol * max(1.0, ref.abs().max().item()) and got[2].item() == ref[2].item() and \
        got[5].item() == ref[5].item()
    row("linesearch_probe", [V, Eb], err, tol, ok, lambda: K.linesearch_probe2(y, dy, z, dz, 7.5, eta_b, p_keep=kv,
                                                                               c_keep=ke),
        lambda: refs["linesearch_probe2"](y, dy, z, dz, 7.5, eta_b, kv, ke), reps, (2 * size + 1) * (V + Eb),
        9 * (V + Eb), form="masked")
    del y, dy
    rows += search_rows(K, V, dtype, eta_b, failures, p_keep=kv)
    rows += binary_rows(K, V, dtype, eta_b, failures, p_keep=kv)
    red = torch.empty(2, dtype=torch.float64, device=dev)
    step = torch.tensor([3.25], dtype=torch.float64, device=dev)
    out, mn, mx = K.axpy_reduce(z, dz, step, red=red, keep=ke)
    out_r, mn_r, mx_r = refs["axpy_reduce"](z, dz, 3.25, keep=ke)
    same = torch.equal(out, out_r) and (mn.item(), mx.item()) == (mn_r.item(), mx_r.item())
    check(failures, same, f"axpy_reduce masked {dtype} [{Eb}]: the update bit-equal to the plain version's over every "
                          f"row, [min, max] {[mn.item(), mx.item()]} over the kept rows exact")
    row("axpy_reduce", [Eb], (out - out_r).abs().max().item(), 0.0, same,
        lambda: K.axpy_reduce(z, dz, step, out=z, red=red, keep=ke), lambda: refs["axpy_reduce"](z, dz, 3.25, keep=ke),
        10, 3 * Eb * size + Eb, 4 * Eb, form="masked")
    del z, dz, out, out_r
    torch.cuda.empty_cache()

    # the scatter at the same bucket: the match operator of tier 1's request,
    # padded (3M of its 4,194,304 edge slots kept); x fits the L2
    op = serving_scatter_op()
    a, b = op.csr
    x = scatter_x(Eb, dtype)
    got, again = (K.incidence_scatter(x, a, b, order=op.scatter_order) for _ in range(2))
    ref = refs["incidence_scatter"](x, a, b)
    err = ((got - ref).abs() / ref.abs().clamp(min=1.0)).max().item()
    same = torch.equal(got, again)
    mat = sparse_matrix((a, b), dtype)
    lib, lib_again = torch.mv(mat, x), torch.mv(mat, x)
    lib_err = ((lib - ref).abs() / ref.abs().clamp(min=1.0)).max().item()
    check(failures, same and lib_err <= tol, f"incidence_scatter masked {dtype} [{Eb}, {V}], {a.nnz} edges kept: two "
                                             f"launches bitwise equal; cuSPARSE {lib_err:.3g} from the plain version "
                                             f"(relative), two calls bit-equal: {torch.equal(lib, lib_again)}")
    del got, again, ref, lib, lib_again
    nnz = a.nnz + b.nnz  # the kept entries: x, each side's permutation, offsets, out
    row("incidence_scatter", [Eb, V], err, tol, err <= tol and same,
        lambda: K.incidence_scatter(x, a, b, order=op.scatter_order), lambda: refs["incidence_scatter"](x, a, b), 10,
        a.nnz * size + 4 * nnz + 2 * (V + 1) * 8 + V * size, nnz, lambda: torch.mv(mat, x), form="masked")
    del a, b, x, mat
    # the gather at the same bucket, over the padded operator's edges: a
    # masked Incidence is no plain gather, so served match lanes launch it
    # (the mask is applied after it); its library call is M^T w over the CSR
    # of the 4,194,304 x 1,048,576 transposed incidence
    u, v = op.u, op.v
    w = torch.rand(V, generator=gen, device=dev, dtype=dtype)
    err = (K.incidence_gather(u, v, w) - refs["incidence_gather"](u, v, w)).abs().max().item()
    crow = torch.arange(0, 2 * Eb + 1, 2, device=dev, dtype=torch.int32)
    mt = torch.sparse_csr_tensor(crow, torch.stack([u, v], dim=1).reshape(-1),
                                 torch.ones(2 * Eb, device=dev, dtype=dtype), size=(Eb, V), check_invariants=False)
    lib_err = (torch.mv(mt, w) - K.incidence_gather(u, v, w)).abs().max().item()
    check(failures, lib_err <= tol, f"sparse M^T w agrees with the gather at the bucket ({lib_err:.3g})")
    row("incidence_gather", [Eb, V], err, 0.0, err == 0.0, lambda: K.incidence_gather(u, v, w),
        lambda: refs["incidence_gather"](u, v, w), 10, Eb * (4 + 4 + size) + V * size, Eb, lambda: torch.mv(mt, w),
        form="masked")
    del op, u, v, w, crow, mt
    torch.cuda.empty_cache()
    return rows


def search_state(n: int, kind: str, seed: int, dtype) -> list:
    """A mid-solve MWU state (tests/test_torch_stepsize.py's _state) with n
    packing rows and the one objective row of bmatch: y, z, dy, dz."""
    rng = np.random.default_rng(seed)
    y, dy, dz = rng.random(n) * 0.3, rng.random(n) * 1e-3, rng.random(1) * 4e-3 + 1e-4
    z = {"far": rng.random(1) * 0.3, "near": 1.0 - dz * rng.uniform(0.5, 3.0, 1),
         "done": 1.0 - dz * rng.uniform(0.2, 0.9, 1), "below": rng.random(1) * 0.3}[kind]
    if kind == "below":  # a packing step 300x as large: f(1) < 1, the search backs off below 1
        dy = dy * 300.0
    return [torch.from_numpy(t).to(dtype).cuda() for t in (y, z, dy, dz)]


def search_rows(K, n: int, dtype, eta: float, failures: list, p_keep=None) -> list[dict]:
    """The Newton search kernel on seeded n + 1 states (its packing rows
    masked by ``p_keep`` when given, as a served match request's padded
    vertex rows are: the rows' "masked" forms). Against the host loop
    over the probe kernel (stepsize._newton_step_host): alpha bit for bit,
    probes and completes equal. Against its plain version, the same loop
    over plain PyTorch probes on the card (ref.newton_search_ref), whose
    probes differ from the kernel's by rounding: completes equal and alpha
    within ls_eps * alpha, the search's own resolution. The row times the
    "far" state from a cold start (alpha0 1, as the solve's first
    iteration): ms a search (one launch replayed from a CUDA graph), its
    probes, and ms a probe counting the alpha = 0 sweep; the plain version
    and the host loop over the probe kernel are timed a search on the host
    clock (their probes read back one by one).

    Then the step form, as the MWU loop launches it (max(d) and the warm
    start alpha_prev read from device memory, the record [alpha, probes,
    completes, step, bad] written there), on the three states and a
    "below" one whose alpha < 1, at max(d) > 0 and max(d) = 0: alpha,
    probes and completes bit for bit the host loop's; step, bad and
    alpha_prev as the MWU iteration decides them; against its plain
    version (ref.newton_step_ref) bad and completes equal and alpha within
    ls_eps * alpha. Its row times the "far" state at max(d) = 0, so that
    alpha_prev stays and every replay runs the same search."""
    import struct

    from repro_torch.core import stepsize
    from repro_torch.kernels.linesearch_probe.ref import newton_search_ref, newton_step_ref

    size = torch.finfo(dtype).bits // 8
    masked = "" if p_keep is None else " masked"
    mask_bytes = 0 if p_keep is None else n
    for kind, alpha0 in (("far", 1.0), ("near", 37.0), ("done", None)):
        y, z, dy, dz = search_state(n, kind, 1, dtype)
        host = stepsize._newton_step_host(y, z, dy, dz, eta, p_keep, ls_eps=EPS, alpha0=alpha0)
        dev = stepsize.newton_step(y, z, dy, dz, eta, p_keep, ls_eps=EPS, alpha0=alpha0)
        p_alpha, p_probes, p_completes = newton_search_ref(y, dy, z, dz, eta, EPS, alpha0, p_keep).tolist()
        same = (struct.pack("d", dev.alpha), dev.probes, dev.completes) == \
            (struct.pack("d", host.alpha), host.probes, host.completes)
        bar = EPS * max(dev.alpha, p_alpha)
        near = dev.completes == bool(p_completes) and abs(dev.alpha - p_alpha) <= bar
        check(failures, same, f"newton_search{masked} {dtype} [{n}, 1] {kind}, alpha0 {alpha0}: card {tuple(dev)} | "
                              f"host loop {tuple(host)}")
        check(failures, near, f"newton_search{masked} {dtype} [{n}, 1] {kind}, alpha0 {alpha0}: plain search "
                              f"({p_alpha!r}, {int(p_probes)}, {bool(p_completes)}), |alpha - plain| "
                              f"{abs(dev.alpha - p_alpha):.3g} (bar {bar:.3g})")
        if kind == "far":
            timed, err, probes, ok, far_bar = (y, z, dy, dz, alpha0), abs(dev.alpha - p_alpha), dev.probes, \
                same and near, bar
    y, z, dy, dz, alpha0 = timed
    ms = device_ms(lambda: K.newton_search(y, dy, z, dz, eta, EPS, alpha0, p_keep=p_keep), 50)
    plain_ms = host_ms(lambda: newton_search_ref(y, dy, z, dz, eta, EPS, alpha0, p_keep).tolist())
    loop_ms = host_ms(lambda: stepsize._newton_step_host(y, z, dy, dz, eta, p_keep, ls_eps=EPS, alpha0=alpha0))
    call = call_ms(lambda: stepsize.newton_step(y, z, dy, dz, eta, p_keep, ls_eps=EPS, alpha0=alpha0), 50)
    # bound: the inputs (and the mask) read once; operations of every sweep the search took
    b_ms, b_by = bound(2 * (n + 1) * size + mask_bytes, 9 * (n + 1) * (probes + 1), dtype)
    r = dict(name="newton_search", dtype=str(dtype).removeprefix("torch."), shape=[n, 1], max_abs_err=err,
             bar=far_bar, within_bar=ok, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
             call_ms=call, plain_call_ms=plain_ms, host_loop_ms=loop_ms, probes=probes,
             ms_per_probe=ms / (probes + 1))
    check(failures, ok, f"newton_search{masked} {r['dtype']} [{n}, 1]: {probes} probes; device ms a search {ms:.4f} "
                        f"({r['ms_per_probe']:.4f} a probe with the alpha = 0 sweep), bound {b_ms:.4f} ({b_by}); "
                        f"host clock ms a search: plain {plain_ms:.4f}, host loop over the probe kernel "
                        f"{loop_ms:.4f}, newton_step with its read {call:.4f}")

    def bits(v: float) -> bytes:
        return struct.pack("d", v)

    dev = torch.device("cuda")
    step_ok, step_err = True, 0.0
    for kind, alpha0 in (("far", 1.0), ("near", 37.0), ("done", 1.0), ("below", 1.0)):
        y, z, dy, dz = search_state(n, kind, 1, dtype)
        host = stepsize._newton_step_host(y, z, dy, dz, eta, p_keep, ls_eps=EPS, alpha0=alpha0)
        for d_max in (1e-3, 0.0):
            dm = torch.tensor(d_max, dtype=dtype, device=dev)
            ap, ap_p = (torch.tensor([alpha0], dtype=torch.float64, device=dev) for _ in range(2))
            rec = stepsize.newton_step_record(y, z, dy, dz, eta, EPS, dm, ap, p_mask=p_keep).tolist()
            plain = newton_step_ref(y, dy, z, dz, eta, EPS, dm, ap_p, p_keep).tolist()
            bad = d_max <= 0 or host.alpha < 1
            same = (bits(rec[0]), int(rec[1]), bool(rec[2])) == (bits(host.alpha), host.probes, host.completes) \
                and bool(rec[4]) == bad and bits(rec[3]) == bits(0.0 if bad else host.alpha) \
                and bits(ap.item()) == bits(alpha0 if bad else host.alpha)
            near = (rec[2], rec[4]) == (plain[2], plain[4]) and abs(rec[0] - plain[0]) <= EPS * max(rec[0], plain[0])
            check(failures, same and near and (kind != "below" or host.alpha < 1),
                  f"newton_search{masked} step form {dtype} [{n}, 1] {kind}, alpha_prev {alpha0}, max(d) {d_max}: record "
                  f"{rec} | host loop {tuple(host)}, bad {bad}; plain {plain}")
            step_ok = step_ok and same and near
            step_err = max(step_err, abs(rec[0] - plain[0]))
    y, z, dy, dz = search_state(n, "far", 1, dtype)
    dm0, ap, out = (torch.zeros((), dtype=dtype, device=dev), torch.ones(1, dtype=torch.float64, device=dev),
                    torch.empty(5, dtype=torch.float64, device=dev))
    def search():
        return K.newton_search(y, dy, z, dz, eta, EPS, ap, d_max=dm0, out=out, p_keep=p_keep)

    probes = int(search()[1].item())
    ms = device_ms(search, 50)
    plain_ms = host_ms(lambda: newton_step_ref(y, dy, z, dz, eta, EPS, dm0, ap, p_keep).tolist())
    b_ms, b_by = bound(2 * (n + 1) * size + mask_bytes, 9 * (n + 1) * (probes + 1), dtype)
    s = dict(r, form="step" + masked, max_abs_err=step_err, within_bar=step_ok, ms=ms, plain_ms=plain_ms,
             bound_ms=b_ms, bound_by=b_by, call_ms=call_ms(search, 50), plain_call_ms=plain_ms, probes=probes,
             ms_per_probe=ms / (probes + 1))
    check(failures, step_ok, f"newton_search{masked} step form {s['dtype']} [{n}, 1]: {probes} probes; device ms a "
                             f"search {ms:.4f}, bound {b_ms:.4f} ({b_by}); plain {plain_ms:.4f} (host clock); eager "
                             f"call {s['call_ms']:.4f}")
    return [dict(r, form="host alpha0" + masked), s]


def binary_rows(K, n: int, dtype, eta: float, failures: list, p_keep=None) -> list[dict]:
    """The binary search kernel (Alg. 3 in one launch) on the seeded n + 1
    states of ``search_rows`` (its packing rows masked by ``p_keep`` when
    given: the row's "masked" form). In both forms against the host loop
    over the probe kernel (stepsize._binary_search_step_host): alpha,
    probes and completes bit for bit; the step form (max(d) and the warm
    start alpha_prev read from device memory, the record [alpha, probes,
    completes, step, bad] written there) at max(d) > 0 and = 0, with step,
    bad and alpha_prev as the MWU iteration decides them. Against its plain
    version (ref.binary_step_ref, the same loop over plain PyTorch probes):
    completes and bad equal and alpha within ls_eps * alpha where alpha >=
    1 (a step the loop takes; far below 1, as on the "below" state, whose
    alpha < 1 is checked, f32 probes are rounding noise). The row is the step form, as the MWU loop
    launches it, timed on the "far" state from a cold start at max(d) = 0
    (alpha_prev stays, so every replay runs the same search): ms a search
    (one launch replayed from a CUDA graph), its probes, ms a sweep (the
    probes, the alpha = 0 sweep and the completion test's sweep); its plain
    version on the host clock."""
    import struct

    from repro_torch.core import stepsize
    from repro_torch.kernels.linesearch_probe.ref import binary_step_ref

    def bits(v: float) -> bytes:
        return struct.pack("d", v)

    dev = torch.device("cuda")
    size = torch.finfo(dtype).bits // 8
    masked = "" if p_keep is None else " masked"
    ok, err = True, 0.0
    for kind, alpha0 in (("far", 1.0), ("near", 37.0), ("done", 1.0), ("below", 1.0)):
        y, z, dy, dz = search_state(n, kind, 1, dtype)
        host = stepsize._binary_search_step_host(y, z, dy, dz, eta, p_keep, ls_eps=EPS, alpha0=alpha0)
        lone = stepsize.binary_search_step(y, z, dy, dz, eta, p_keep, ls_eps=EPS, alpha0=alpha0)
        same = (bits(lone.alpha), lone.probes, lone.completes) == (bits(host.alpha), host.probes, host.completes)
        for d_max in (1e-3, 0.0):
            dm = torch.tensor(d_max, dtype=dtype, device=dev)
            ap, ap_p = (torch.tensor([alpha0], dtype=torch.float64, device=dev) for _ in range(2))
            rec = stepsize.binary_step_record(y, z, dy, dz, eta, EPS, dm, ap, p_mask=p_keep).tolist()
            plain = binary_step_ref(y, dy, z, dz, eta, EPS, dm, ap_p, p_keep).tolist()
            bad = d_max <= 0 or host.alpha < 1
            same = same and (bits(rec[0]), int(rec[1]), bool(rec[2])) == \
                (bits(host.alpha), host.probes, host.completes) and bool(rec[4]) == bad \
                and bits(rec[3]) == bits(0.0 if bad else host.alpha) and bits(ap.item()) == bits(alpha0 if bad else
                                                                                                 host.alpha)
            near = host.alpha < 1 if kind == "below" else host.alpha < 1 or \
                (rec[2], rec[4]) == (plain[2], plain[4]) and abs(rec[0] - plain[0]) <= EPS * max(rec[0], plain[0])
            check(failures, same and near,
                  f"binary_search{masked} {dtype} [{n}, 1] {kind}, alpha_prev {alpha0}, max(d) {d_max}: record {rec} | "
                  f"host loop {tuple(host)}, bad {bad}; one-call form {tuple(lone)}; plain {plain}")
            ok = ok and same and near
            if host.alpha >= 1:
                err = max(err, abs(rec[0] - plain[0]))
    y, z, dy, dz = search_state(n, "far", 1, dtype)
    dm0, ap, out = (torch.zeros((), dtype=dtype, device=dev), torch.ones(1, dtype=torch.float64, device=dev),
                    torch.empty(5, dtype=torch.float64, device=dev))

    def search():
        return K.binary_search(y, dy, z, dz, eta, EPS, ap, d_max=dm0, out=out, p_keep=p_keep)

    probes = int(search()[1].item())
    ms = device_ms(search, 50)
    plain_ms = host_ms(lambda: binary_step_ref(y, dy, z, dz, eta, EPS, dm0, ap, p_keep).tolist())
    loop_ms = host_ms(lambda: stepsize._binary_search_step_host(y, z, dy, dz, eta, p_keep, ls_eps=EPS, alpha0=1.0))
    # bound: the inputs (and the mask) read once; the operations of every sweep the search took
    b_ms, b_by = bound(2 * (n + 1) * size + (0 if p_keep is None else n), 9 * (n + 1) * (probes + 2), dtype)
    r = dict(name="binary_search", form="step" + masked, dtype=str(dtype).removeprefix("torch."), shape=[n, 1],
             max_abs_err=err, bar=EPS, within_bar=ok, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
             library_ms=None, call_ms=call_ms(search, 50), plain_call_ms=plain_ms, host_loop_ms=loop_ms,
             probes=probes, ms_per_sweep=ms / (probes + 2))
    check(failures, ok, f"binary_search{masked} step form {r['dtype']} [{n}, 1]: {probes} probes; device ms a search "
                        f"{ms:.4f} ({r['ms_per_sweep']:.4f} a sweep, {probes + 2} sweeps), bound {b_ms:.4f} ({b_by}); "
                        f"host clock ms a search: plain {plain_ms:.4f}, host loop over the probe kernel {loop_ms:.4f}; "
                        f"eager call {r['call_ms']:.4f}")
    return [r]


def scored_pairs(S: int, causal: bool, window) -> int:
    """(query, key) pairs that attention scores: S^2 bidirectional, S(S+1)/2
    causal, the band for a window."""
    q = np.arange(S)
    lo = np.maximum(0, q - window + 1) if window else np.zeros(S, np.int64)
    hi = q if causal else np.full(S, S - 1)
    return int((hi - lo + 1).sum())


FLASH_CASES = [  # tag, B, S, Hq, Hkv, d, causal, window, dtype
    ("a", 16, 1500, 16, 16, 80, False, None, torch.bfloat16),  # hubert-xlarge
    ("a", 16, 1500, 16, 16, 80, False, None, torch.float32),
    ("b", 1, 4096, 24, 8, 128, True, None, torch.bfloat16),  # minitron-4b at train_4k
    ("b", 1, 4096, 24, 8, 128, True, None, torch.float32),
    ("c", 1, 6144, 48, 8, 128, True, 4096, torch.bfloat16),  # mixtral-8x22b, sliding window
]


def flash_ptxas(failures: list) -> None:
    """The flash kernels' ptxas lines (registers, spills, shared memory) from
    the loaded build's compiler log, one block per body and head dim; no
    spills at the models' head dims, 80 and 128, in either body."""
    import re

    from repro_torch.kernels import loader

    blocks, current = {}, None
    for line in loader.build_log().read_text().splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"flash_(bf16|f32)_kernelILi(\d+)E", line)
            current = f"flash_{m.group(1)}_kernel<{m.group(2)}>" if m else None
            if current is not None:
                blocks[current] = []
        elif current is not None and ("registers" in line or "spill" in line or "smem" in line):
            blocks[current].append(line.strip())
    for name in sorted(blocks):
        print(f"  ptxas, {name}: " + " | ".join(blocks[name]), flush=True)
    for body in ("bf16", "f32"):
        for d in (80, 128):
            name = f"flash_{body}_kernel<{d}>"
            spills = [int(n) for line in blocks.get(name, []) for n in re.findall(r"(\d+) bytes spill", line)]
            check(failures, bool(spills) and not any(spills),
                  f"{name}: no spills in ptxas's report ({spills or 'no report'})")


def tail_fault_rel_l2(q, k, v, block_k: int, ref) -> float:
    """Relative L2, against ``ref``, of the output that a bidirectional
    kernel would give if the zero-filled keys past S in its last key tile
    scored 0 instead of being masked: what the whole-tensor bar must catch."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    S = q.shape[1]
    q, k, v = (F.pad(t, (0, 0, 0, 0, 0, -S % block_k)) for t in (q, k, v))
    fault = flash_attention_plain(q, k, v, causal=False)[:, :S].float()
    return ((fault - ref).norm() / ref.norm()).item()


def flash_rows(K, card: str, failures: list) -> list[dict]:
    """Flash attention vs its plain version at published widths; ``card`` is
    nvidia-smi's name and power limit, printed beside each f32 row."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import bf16_config
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    flash_ptxas(failures)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for tag, B, S, Hq, Hkv, d, causal, window, dtype in FLASH_CASES:
        q = torch.randn(B, S, Hq, d, generator=gen, device=dev).to(dtype)
        k, v = (torch.randn(B, S, Hkv, d, generator=gen, device=dev).to(dtype) for _ in range(2))
        bar = 3e-5 if dtype == torch.float32 else 2e-2

        def kernel():
            return K.flash_attention(q, k, v, causal=causal, window=window)

        def plain():
            return flash_attention_plain(q, k, v, causal=causal, window=window)

        mask = None
        if window is not None:
            i = torch.arange(S, device=dev)
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)

        def library():
            return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                                  attn_mask=mask, is_causal=causal and mask is None,
                                                  enable_gqa=Hq != Hkv).transpose(1, 2)

        config = bf16_config(d) if dtype == torch.bfloat16 else None
        got, ref = kernel().float(), plain().float()
        diff = (got - ref).abs()
        err = diff.max().item()
        rel = (diff.norm() / ref.norm()).item()
        ok = bool((diff <= bar * (1 + ref.abs())).all())
        lib_diff = (library().float() - ref).abs()
        lib_ok = bool((lib_diff <= bar * (1 + ref.abs())).all())
        if config is not None:
            rel_ok = rel <= FLASH_REL_L2_BAR
            check(failures, rel_ok, f"flash_attention ({tag}) bfloat16: relative L2 vs plain {rel:.4g} "
                                    f"(bar {FLASH_REL_L2_BAR})")
            ok = ok and rel_ok
            if not causal and window is None and S % config["block_k"]:
                fault = tail_fault_rel_l2(q, k, v, config["block_k"], ref)
                check(failures, fault > FLASH_REL_L2_BAR,
                      f"flash_attention ({tag}): unmasked zero keys past S would give relative L2 {fault:.4g}, "
                      f"beyond the bar {FLASH_REL_L2_BAR}")
        del got, ref, diff, lib_diff
        size = torch.finfo(dtype).bits // 8
        flops = 4 * B * Hq * d * scored_pairs(S, causal, window)
        nbytes = 2 * B * S * (Hq + Hkv) * d * size
        f32 = dtype == torch.float32  # the f32 kernel's 3xTF32: 3x the flops on the TF32 tensor cores
        b_ms, b_by = bound(nbytes, 3 * flops, "tf32") if f32 else bound(nbytes, flops, dtype)
        plain_ms = call_ms(plain, 3)
        r = dict(name="flash_attention", case=tag, dtype=str(dtype).removeprefix("torch."),
                 shape=[B, S, Hq, Hkv, d], causal=causal, window=window, max_abs_err=err, bar=bar, within_bar=ok,
                 rel_l2=rel, ms=device_ms(kernel, 20), plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                 library_ms=device_ms(library, 20), call_ms=call_ms(kernel, 20), plain_call_ms=plain_ms,
                 config=config)
        r["tflops"] = flops / (r["ms"] * 1e-3) / 1e12
        r["library_tflops"] = flops / (r["library_ms"] * 1e-3) / 1e12
        check(failures, ok, f"flash_attention ({tag}) {r['dtype']} B {B} S {S} heads {Hq}/{Hkv} d {d} causal {causal} "
                            f"window {window}: max_abs_err {err:.3g} (bar {bar}), relative L2 {rel:.3g}; "
                            f"device ms: kernel {r['ms']:.4f} "
                            f"({r['tflops']:.1f} TFLOP/s), plain {plain_ms:.4f}, SDPA {r['library_ms']:.4f} "
                            f"({r['library_tflops']:.1f} TFLOP/s, within bar: {lib_ok}), bound {b_ms:.4f} ({b_by}), "
                            f"{b_ms / r['ms']:.0%} of bound; eager call {r['call_ms']:.4f}; tiles {r['config']}")
        if f32:
            fma_ms, _ = bound(nbytes, flops, dtype)  # the same flops once at f32 FMA
            print(f"  f32 ({tag}) on {card}: kernel {r['ms']:.4f} ms ({r['tflops']:.1f} TFLOP/s), SDPA f32 "
                  f"{r['library_ms']:.4f} ms; bound {b_ms:.4f} ms at 3xTF32 (3 x {flops:.4g} flops over "
                  f"{PEAK_OPS_PER_S['tf32'] / 1e12:.0f} TFLOP/s, {b_ms / r['ms']:.0%} of it), {fma_ms:.4f} ms at "
                  f"f32 FMA ({PEAK_OPS_PER_S[dtype] / 1e12:.0f} TFLOP/s, {fma_ms / r['ms']:.0%})", flush=True)
        rows.append(r)
        del q, k, v, mask
        torch.cuda.empty_cache()
    return rows


# -- phase 3 -----------------------------------------------------------------
def round_solver(opts, batch_width: int = 4):
    """A Solver that keeps, for each search round, its bounds, its lanes'
    iterations and its wall time, and the first batched round's result."""
    from repro_torch.api import Solver

    class RoundSolver(Solver):
        def __init__(self):
            super().__init__(opts, batch_width=batch_width)
            self.rounds, self.first_batch = [], None

        def solve_batch(self, problem, bounds, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = super().solve_batch(problem, bounds, **kw)
            torch.cuda.synchronize()
            self.rounds.append(dict(bounds=[float(b) for b in bounds], iters=res.iters.tolist(),
                                    wall_s=time.perf_counter() - t0))
            if self.first_batch is None:
                self.first_batch = res
            return res

        def feasible(self, problem, bound=None, trace=False):
            res = super().feasible(problem, bound, trace)
            self.rounds.append(dict(bounds=[float(bound)], iters=[res.iters], wall_s=None))
            return res

    return RoundSolver()


def full_solve(n_users: int, failures: list) -> tuple:
    """Phase 3; returns its numbers, the bmatch problem on the card and its
    host graph (phase 7 runs on both)."""
    from repro_torch import kernels as K
    from repro_torch.api import MWUOptions, Solver, Status
    from repro_torch.api.solver import certify_solution
    from repro_torch.graphs import baselines, bipartite_ratings, build

    t0 = time.perf_counter()
    g = bipartite_ratings(n_users, 17_770, avg_ratings=209, seed=0)
    t_graph = time.perf_counter() - t0
    print(f"  graph bipartite_ratings({n_users}, 17770, avg_ratings=209, seed=0): "
          f"{g.n} vertices, {g.m} edges, {t_graph:.1f} s on the host", flush=True)
    t0 = time.perf_counter()
    exact = baselines.hopcroft_karp_bmatch(g)
    t_exact = time.perf_counter() - t0
    t0 = time.perf_counter()
    prob = build("bmatch", g, device="cuda", dtype=torch.float64)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    print(f"  exact maximum matching {exact} ({t_exact:.1f} s); builder with greedy bounds "
          f"[{prob.lo}, {prob.hi}] ({t_build:.1f} s)", flush=True)

    # the scatter's CSR, built once per operator at its first card product
    # and shared by the lanes of a round (they share the operator)
    t0 = time.perf_counter()
    sides = prob.P.csr
    torch.cuda.synchronize()
    t_csr = time.perf_counter() - t0
    print(f"  scatter CSR of M: {sum(s.nbytes for s in sides) / 1e6:.1f} MB (u side "
          f"{sides[0].nbytes / 1e6:.1f} MB, permutation: {sides[0].src is not None}; v side "
          f"{sides[1].nbytes / 1e6:.1f} MB), built in {t_csr:.2f} s", flush=True)
    opts = MWUOptions(eps=EPS, step_rule="newton")
    # the lanes' state beyond one solve's: K - 1 more rows of x (E), y (V) and z (1)
    lane_gb = 3 * (g.m + g.n + 1) * 8 / 1e9
    print(f"  reckoned: 4 lanes hold {lane_gb:.2f} GB of state beyond one solve's (3 more rows of x, y, z); the "
          f"graph and the CSR are shared", flush=True)

    K.reset_launch_counts()
    solver = round_solver(opts)  # keeps round 1's batch (its x rows) for the check below
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol = solver.solve(prob)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    # round 1's lanes against four sequential solves at full size, bit for bit
    batch, seq = solver.first_batch, Solver(opts)
    for j, b in enumerate(solver.rounds[0]["bounds"] if batch is not None else []):
        res = seq.feasible(prob, b)
        same = (int(batch.status[j]), int(batch.iters[j]), int(batch.ls_probes[j]), float(batch.max_px[j]),
                float(batch.min_cx[j])) == (res.status, res.iters, res.ls_probes, res.max_px, res.min_cx)
        check(failures, same and torch.equal(batch.x[j], res.x),
              f"round 1, lane {j} (bound {b!r}): equal to feasible() bit for bit ({res.iters} iterations, "
              f"{res.ls_probes} probes, {Status.NAMES[res.status]}, x bits equal: {torch.equal(batch.x[j], res.x)})")
        del res
    check(failures, batch is not None, "the search ran a batched round")
    # free the first solve's lane rows, so that the second solve's peak is its own
    solver.first_batch = batch = sol.last_result = None
    torch.cuda.empty_cache()
    # the same solve again, by a plain Solver (its peak memory is the
    # solve's own): the scatter sums in a fixed order, so a card solve
    # repeats bit for bit
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    sol2 = Solver(opts, batch_width=4).solve(prob)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the solve's last step alone: the certificate of its best lane (x and
    # the objective to the host, the rescale and the objective's dot there)
    t0 = time.perf_counter()
    certify_solution(prob, sol2.last_result, sol2.bound, dict(calls=0, iters=0, probes=0))
    t_cert = time.perf_counter() - t0

    rounds = solver.rounds
    loop_iters = sum(max(r["iters"]) for r in rounds)
    loads = np.bincount(g.u, sol.x, g.n) + np.bincount(g.v, sol.x, g.n) if sol.found else np.array([np.inf])
    info = dict(n_vertices=g.n, n_edges=g.m, exact=exact, objective=sol.objective, bound=sol.bound,
                status=Status.NAMES[sol.status], calls=sol.feasibility_calls, iters=sol.mwu_iters_total,
                probes=sol.ls_probes_total, wall_s=wall, ms_per_iter=1e3 * wall / max(sol.mwu_iters_total, 1),
                rounds=len(rounds), lanes_per_round=[len(r["bounds"]) for r in rounds],
                round_loop_iters=[max(r["iters"]) for r in rounds], round_lane_iters=[r["iters"] for r in rounds],
                round_wall_s=[r["wall_s"] for r in rounds], loop_iters=loop_iters,
                ms_per_loop_iter=1e3 * wall / max(loop_iters, 1),
                max_memory_gb=peak_gb, memory_before_gb=base_gb, reckoned_lane_state_gb=lane_gb,
                max_Mx=float(loads.max()),
                launches=launches, setup_s=dict(graph=t_graph, exact=t_exact, build=t_build, csr=t_csr),
                csr_mb=sum(s.nbytes for s in sides) / 1e6, certify_s=t_cert,
                rounds_wall_s=sum(r["wall_s"] or 0.0 for r in rounds), second_wall_s=wall2,
                second_ms_per_iter=1e3 * wall2 / max(sol2.mwu_iters_total, 1))
    print("  " + json.dumps(info), flush=True)
    print(f"sha256 bmatch x: {sha256(sol.x)} ({sol.mwu_iters_total} lane iterations, objective {sol.objective!r})",
          flush=True)
    for r in rounds:
        print(f"  round: {len(r['bounds'])} lanes at bounds {[round(b, 3) for b in r['bounds']]}, lane iterations "
              f"{r['iters']} (loop iterations {max(r['iters'])}), {r['wall_s']} s", flush=True)
    for k, sl in enumerate((sol, sol2)):
        check(failures, sl.feasible, f"bmatch solve {k + 1} is FEASIBLE ({Status.NAMES[sl.status]})")
        rel = abs(sl.objective - exact) / exact
        check(failures, rel <= 1.5 * EPS, f"solve {k + 1}: objective {sl.objective!r} within 1.5*eps of exact {exact} "
                                          f"(rel {rel:.4f})")
        loads = np.bincount(g.u, sl.x, g.n) + np.bincount(g.v, sl.x, g.n) if sl.found else np.array([np.inf])
        check(failures, loads.max() <= 1 + 1e-9, f"solve {k + 1}: host-recomputed max(Mx) = {loads.max()!r} <= 1 + 1e-9")
    first = (sol.feasibility_calls, sol.mwu_iters_total, sol.ls_probes_total, sol.objective)
    second = (sol2.feasibility_calls, sol2.mwu_iters_total, sol2.ls_probes_total, sol2.objective)
    same_x = sol.found and sol2.found and np.array_equal(sol.x, sol2.x)
    check(failures, first == second and same_x,
          f"two solves in one call repeat: (calls, iterations, probes, objective) {first} | {second}; x bits equal: "
          f"{same_x}; {wall:.2f} / {wall2:.2f} s")
    check(failures, sum(len(r["bounds"]) for r in rounds) == sol.feasibility_calls
          and all(r["wall_s"] is not None for r in rounds if len(r["bounds"]) > 1),
          f"the search's {sol.feasibility_calls} feasibility calls ran as {len(rounds)} rounds of "
          f"{[len(r['bounds']) for r in rounds]} lanes, every round of more than one through solve_batch")
    for name, count in launches.items():
        if name == "flash_attention":  # the LM plane's kernel, off this path
            check(failures, count == 0, f"{name} launched {count} times in the solve")
        elif name in ("linesearch_probe", "binary_search"):  # probes inside the search; the binary rule: phases 4, 7
            check(failures, count == 0, f"{name} launched {count} times in the solve")
        elif name == "incidence_gather":  # step_direction gathers M^T w itself (phase 4 runs the gather)
            check(failures, count == 0, f"{name} launched {count} times in the solve")
        elif name in ("newton_search", "step_direction"):
            check(failures, count == sol.mwu_iters_total,
                  f"{name} launched {count} times in the solve, once a lane iteration ({sol.mwu_iters_total})")
        elif name == "axpy_reduce":
            check(failures, count == 3 * sol.mwu_iters_total,
                  f"{name} launched {count} times in the solve, 3 a lane iteration ({sol.mwu_iters_total})")
        else:
            check(failures, count > 0, f"{name} launched {count} times in the solve")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True).stdout.strip()
    print(f"  after the solve: sm clock, power draw, power limit, temperature = {smi}", flush=True)

    if sol.found:
        info["profile"] = profile_run(lambda: Solver(opts).feasible(prob, sol.bound), "one feasibility solve at "
                                      "the certified bound", failures)
        info["profile_round"] = profile_run(lambda: Solver(opts).solve_batch(prob, rounds[0]["bounds"]),
                                            "round 1's batch of 4 lanes", failures)
    return info, prob, g


def profile_run(run, what: str, failures: list) -> dict:
    """Where the time of ``run()`` (a feasibility solve or a batch of them)
    goes: the call timed alone, then again under torch.profiler for device
    time by kernel (the two take the same iterations: a card solve
    repeats). Lane iterations are the lanes' iterations summed, loop
    iterations the longest lane's; host reads are the device-to-host
    copies. The profile must show the scatter and step-direction kernels
    and no index_add_ / scatter_add kernel. It traces the device alone:
    every number here comes from device events, and tracing the host's
    operators too slows a long run several times over."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import Status

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        profiled = run()
        torch.cuda.synchronize()
    # device-side events only: the operators that launched them carry the
    # same device time again
    kernels = sorted(((e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0), reverse=True)
    busy_ms = sum(k[0] for k in kernels)
    port_ms = sum(k[0] for k in kernels if "rt::" in k[2])
    search = [k for k in kernels if "rt::search_kernel" in k[2]]  # the Newton or the binary search
    search_ms = sum(k[0] for k in search)
    # host reads: the device-to-host copies (.item(), .tolist()) the run made
    reads = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA and "DtoH" in e.key)
    iters = np.atleast_1d(res.iters)
    lane_iters, loop_iters = int(iters.sum()), int(iters.max())
    out = dict(lanes=len(iters), status=[Status.NAMES[int(s)] for s in np.atleast_1d(res.status)],
               lane_iters=lane_iters, loop_iters=loop_iters, probes=int(np.sum(res.ls_probes)),
               wall_ms=wall_ms, wall_ms_per_lane_iter=wall_ms / max(lane_iters, 1), device_busy_ms=busy_ms,
               device_ms_per_lane_iter=busy_ms / max(lane_iters, 1),
               device_idle_share=1.0 - busy_ms / wall_ms if busy_ms else None,
               port_kernels_ms=port_ms, other_device_ms=busy_ms - port_ms, search_ms=search_ms,
               search_launches=sum(k[1] for k in search), search_share=search_ms / busy_ms if busy_ms else None,
               host_reads=reads,
               host_reads_per_loop_iter=reads / max(loop_iters, 1))
    print(f"  profile of {what}: {json.dumps(out)}", flush=True)
    for ms, count, key in kernels[:20]:
        print(f"    {ms:10.2f} ms {count:7d} x  {key[:110]}", flush=True)
    same = np.array_equal(np.atleast_1d(profiled.iters), iters) and torch.equal(profiled.x, res.x)
    check(failures, same, f"{what}: the timed and the profiled run repeat ({iters.tolist()} / "
                          f"{np.atleast_1d(profiled.iters).tolist()} iterations, x bits equal)")
    check(failures, reads <= loop_iters + 3, f"{what}: {reads} host reads in {loop_iters} loop iterations "
                                             f"({out['host_reads_per_loop_iter']:.3f} a loop iteration)")
    atomic = [k for k in kernels if any(w in k[2] for w in ("indexFunc", "index_add", "scatter_add"))]
    check(failures, not atomic, f"no index_add_ / scatter_add kernel in the profile ({[k[2][:60] for k in atomic]})")
    for name in ("incidence_scatter_kernel", "step_direction_kernel"):
        hit = [k for k in kernels if f"rt::{name}" in k[2]]
        check(failures, bool(hit), f"rt::{name} in the profile: {sum(k[0] for k in hit):.2f} ms, "
                                   f"{sum(k[1] for k in hit)} launches")
    return out


# -- phase 4 -----------------------------------------------------------------
def small_solves(failures: list) -> dict:
    """The six families card vs CPU, and each card solve run twice: the
    second repeats the first bit for bit. Returns the card solves' launches
    (the gather's count in the kernels line: bmatch's Newton solve gathers
    inside the step-direction kernel)."""
    from repro_torch import kernels as K
    from repro_torch.api import MWUOptions, Solver, Status
    from repro_torch.graphs import bipartite_ratings, build, generalized_matching_problem, rgg

    g = rgg(12, seed=0)
    bg = bipartite_ratings(2_000, 500, avg_ratings=10.0, seed=0)
    s, deg = bg.bipartite_split, bg.degrees()
    lb, ub = np.zeros(bg.n), np.ones(bg.n)
    lb[:s] = np.minimum(1, deg[:s])
    ub[:s], ub[s:] = 5, 8
    print(f"  rgg(12, seed=0): {g.n} vertices, {g.m} edges; bipartite_ratings(2000, 500): {bg.m} edges", flush=True)
    opts = MWUOptions(eps=EPS, step_rule="newton")
    launches = {}
    for family in ("match", "bmatch", "vcover", "dom-set", "dense-sub", "gen-match"):
        sols = {}
        for device in ("cuda", "cpu"):
            if family == "gen-match":
                prob = generalized_matching_problem(bg, lb, ub, device=device)
            else:
                prob = build(family, bg if family == "bmatch" else g, device=device)
            if device == "cuda":
                torch.cuda.synchronize()
                K.reset_launch_counts()
            t0 = time.perf_counter()
            sols[device] = Solver(opts).solve(prob)
            sols[device + "_s"] = time.perf_counter() - t0
            if device == "cuda":
                torch.cuda.synchronize()
                for name, count in K.launch_counts().items():
                    launches[name] = launches.get(name, 0) + count
                again = Solver(opts).solve(prob)
                same = (again.mwu_iters_total, again.ls_probes_total) == \
                    (sols["cuda"].mwu_iters_total, sols["cuda"].ls_probes_total) and \
                    np.array_equal(again.x, sols["cuda"].x)
                check(failures, same, f"{family}: a second card solve repeats the first ({again.mwu_iters_total} "
                                      f"iterations, x bits equal)")
        a, b = sols["cuda"], sols["cpu"]
        same = a.status == b.status == Status.FEASIBLE
        if family != "gen-match":
            same = same and abs(a.bound - b.bound) <= 1e-5 * abs(b.bound)
            same = same and abs(a.objective - b.objective) <= 2 * EPS * abs(b.objective)
        check(failures, same, f"{family}: card {Status.NAMES[a.status]} bound {a.bound:.6g} objective "
                              f"{a.objective:.6g} iters {a.mwu_iters_total} ({sols['cuda_s']:.1f} s) | cpu "
                              f"{Status.NAMES[b.status]} bound {b.bound:.6g} objective {b.objective:.6g} iters "
                              f"{b.mwu_iters_total} ({sols['cpu_s']:.1f} s)")
    print(f"  launches of the six card solves: {launches}", flush=True)
    check(failures, launches["incidence_gather"] > 0 and launches["incidence_scatter"] > 0,
          "the six card solves launched the gather and the scatter")
    return launches


def batch_solves(failures: list) -> None:
    """Batched lanes on the card against feasible() on the card, bit for bit:
    four bounds of each of the six families (gen-match has no bound: four
    lanes of one problem), and two stacked match instances, each lane over
    its own operators."""
    from repro_torch.api import MWUOptions, Solver, Status, stack_problems
    from repro_torch.graphs import bipartite_ratings, build, erdos, generalized_matching_problem, rgg

    g, bg = rgg(12, seed=0), bipartite_ratings(2_000, 500, avg_ratings=10.0, seed=0)
    s, deg = bg.bipartite_split, bg.degrees()
    lb, ub = np.zeros(bg.n), np.ones(bg.n)
    lb[:s] = np.minimum(1, deg[:s])
    ub[:s], ub[s:] = 5, 8
    solver = Solver(MWUOptions(eps=EPS, step_rule="newton"))
    cases = []
    for family in ("match", "bmatch", "vcover", "dom-set", "dense-sub", "gen-match"):
        if family == "gen-match":
            prob = generalized_matching_problem(bg, lb, ub, device="cuda")
            cases.append((family, prob, np.ones(4), False, [prob] * 4))
        else:
            prob = build(family, bg if family == "bmatch" else g, device="cuda")
            cases.append((family, prob, np.geomspace(prob.lo, prob.hi, 4), False, [prob] * 4))
    probs = [build("match", erdos(4_096, 40_000, seed=k), device="cuda") for k in (0, 1)]
    cases.append(("stacked match", stack_problems(probs), [p.lo for p in probs], True, probs))
    for family, prob, bounds, stacked, lanes in cases:
        t0 = time.perf_counter()
        batch = solver.solve_batch(prob, bounds, batched_problem=stacked)
        torch.cuda.synchronize()
        t_batch = time.perf_counter() - t0
        for j, (p, b) in enumerate(zip(lanes, bounds)):
            res = solver.feasible(p, float(b))
            same = (int(batch.status[j]), int(batch.iters[j]), int(batch.ls_probes[j]), float(batch.max_px[j]),
                    float(batch.min_cx[j])) == (res.status, res.iters, res.ls_probes, res.max_px, res.min_cx)
            check(failures, same and torch.equal(batch.x[j], res.x),
                  f"{family}, lane {j} of {len(lanes)} (bound {float(b):.6g}): equal to feasible() bit for bit "
                  f"({Status.NAMES[res.status]}, {res.iters} iterations, {res.ls_probes} probes); batch {t_batch:.2f} s")


def binary_solves(failures: list) -> dict:
    """The binary step rule, card vs CPU, on match and vcover of rgg(12):
    every lane iteration launches the binary search kernel once (its step
    form, no lone probe), and the loop reads the host once a loop iteration
    for all lanes (the reads, counted, include each round's start and
    finish and the certificate's copies of x and c). Prints each card
    solve's status, iterations, probes and the sha256 of x, to compare the
    bits with another tree (tools/binary_bits.py runs the same solves)."""
    from repro_torch import kernels as K
    from repro_torch.api import MWUOptions, Solver, Status
    from repro_torch.graphs import build, rgg

    g = rgg(12, seed=0)
    opts = MWUOptions(eps=EPS, step_rule="binary")
    families = ("match", "vcover")
    sols = {(f, "cpu"): Solver(opts).solve(build(f, g, device="cpu")) for f in families}
    probs = {f: build(f, g, device="cuda") for f in families}
    solvers = {f: round_solver(opts) for f in families}
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with counted_reads() as reads:
        for family in probs:
            sols[family, "cuda"] = solvers[family].solve(probs[family])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    for family in probs:
        a, b = sols[family, "cuda"], sols[family, "cpu"]
        same = a.status == b.status == Status.FEASIBLE and abs(a.bound - b.bound) <= 1e-5 * abs(b.bound)
        same = same and abs(a.objective - b.objective) <= 2 * EPS * abs(b.objective)
        check(failures, same, f"{family}, binary rule: card {Status.NAMES[a.status]} bound {a.bound:.6g} objective "
                              f"{a.objective:.6g} probes {a.ls_probes_total} | cpu {Status.NAMES[b.status]} bound "
                              f"{b.bound:.6g} objective {b.objective:.6g} probes {b.ls_probes_total}")
        print(f"sha256 binary x {family}: {sha256(a.x)} ({Status.NAMES[a.status]}, {a.feasibility_calls} calls, "
              f"{a.mwu_iters_total} lane iterations, {a.ls_probes_total} probes)", flush=True)
    lane_iters = sum(sols[f, "cuda"].mwu_iters_total for f in probs)
    rounds = [r for f in families for r in solvers[f].rounds]
    loop_iters = sum(max(r["iters"]) for r in rounds)
    probes = sum(sols[f, "cuda"].ls_probes_total for f in probs)
    check(failures, launches["binary_search"] == lane_iters and launches["linesearch_probe"] == 0
          and launches["newton_search"] == 0,
          f"binary-rule solves launched binary_search {launches['binary_search']} times for {lane_iters} lane "
          f"iterations ({probes} probes, {probes / max(lane_iters, 1):.2f} a lane iteration), linesearch_probe "
          f"{launches['linesearch_probe']}, newton_search {launches['newton_search']}")
    print(f"  binary-rule card solves: {reads[0]} host reads in {loop_iters} loop iterations over {len(rounds)} rounds "
          f"({reads[0] / max(loop_iters, 1):.3f} a loop iteration); {wall:.2f} s", flush=True)
    return launches


# -- phase 5 -----------------------------------------------------------------
def _device_kernels(prof) -> list[tuple[float, int, str]]:
    """(device ms, calls, name) of each kernel, device-side events only: the
    operators that launched them carry the same device time again."""
    from torch.autograd import DeviceType

    return sorted(((e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0), reverse=True)


def encoder_forward(K, failures: list) -> dict:
    """hubert-xlarge's encode forward at full width (phase 5)."""
    from dataclasses import replace

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get
    from repro_torch.models import Model

    cfg = replace(get("hubert-xlarge"), attn_impl="pallas")
    B, S = 16, 1500
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda", seed=0)
    frames = torch.randn(B, S, cfg.d_model, generator=torch.Generator(device="cuda").manual_seed(1),
                         device="cuda") * 0.02
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads of d {cfg.d_head}, "
          f"d_ff {cfg.d_ff}, {n_params / 1e6:.1f}M f32 params, init {init_s:.1f} s; frames {B} x {S}", flush=True)

    def run(m):
        return m.logits(m({"frames": frames}))

    with torch.inference_mode():
        run(model)  # warm-up: cuBLAS handles and heuristics
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = run(model)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = K.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(model)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall_s = float(np.median(walls))

        V = cfg.vocab_size
        finite = bool(torch.isfinite(logits[..., :V]).all())
        pad_ok = bool((logits[..., V:] == -1e30).all())
        dense = Model(replace(cfg, attn_impl="dense"), device="cuda")
        dense.load_state_dict(model.state_dict())
        ref = run(dense)
        del dense
        rel = ((logits[..., :V] - ref[..., :V]).norm() / ref[..., :V].norm()).item()
        del ref
        torch.cuda.empty_cache()

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(model)
            torch.cuda.synchronize()
    kernels = _device_kernels(prof)
    busy = sum(k[0] for k in kernels)
    flash_ms = sum(k[0] for k in kernels if "rt::flash" in k[2])
    mm_ms = sum(k[0] for k in kernels if any(w in k[2].lower() for w in ("gemm", "nvjet", "xmma", "cutlass")))
    info = dict(config=cfg.name, batch=B, frames=S, layers=cfg.n_layers, first_forward_s=first_s,
                wall_ms=1e3 * wall_s, wall_ms_runs=[1e3 * w for w in walls], frames_per_s=B * S / wall_s,
                max_memory_gb=peak_gb, launches=launches, logits_shape=list(logits.shape), logits_finite=finite,
                pad_vocab_masked=pad_ok, rel_l2_vs_dense=rel,
                profile=dict(device_busy_ms=busy, flash_ms=flash_ms, matmul_ms=mm_ms, other_ms=busy - flash_ms - mm_ms,
                             device_idle_share=1.0 - busy / (1e3 * wall_s)))
    print("  " + json.dumps(info), flush=True)
    for ms, count, key in kernels[:14]:
        print(f"    {ms:10.2f} ms {count:7d} x  {key[:110]}", flush=True)
    check(failures, launches["flash_attention"] == cfg.n_layers,
          f"flash_attention launched {launches['flash_attention']} times in one forward ({cfg.n_layers} layers)")
    check(failures, all(n == 0 for name, n in launches.items() if name != "flash_attention"),
          f"no MWU kernel launched in the forward ({launches})")
    check(failures, finite and pad_ok and list(logits.shape) == [B, S, cfg.padded_vocab],
          f"logits {list(logits.shape)} finite over the vocab ({finite}), pad slots -1e30 ({pad_ok})")
    check(failures, rel <= LOGITS_REL_L2_BAR,
          f"logits vs the dense-attention forward: relative L2 {rel:.4g} (bar {LOGITS_REL_L2_BAR})")
    return info


# -- phase 6 -----------------------------------------------------------------
def serve_requests(n_requests: int, failures: list) -> dict:
    """Graph-LP serving at card size through the port's lpserve engine:
    match and vcover alternating, request i on erdos(n, m, seed=i) of
    SERVE_TIERS[i % 3], LPServeConfig(MWUOptions(eps=0.1, step_rule="newton"),
    lanes=4), the default BucketPolicy, float64. Returns the phase's numbers
    and its launches (counted from 0 over the engine's run alone)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels as K
    from repro_torch.api import MWUOptions, Solver
    from repro_torch.graphs import build, erdos
    from repro_torch.lpserve import LPEngine, LPServeConfig
    from repro_torch.lpserve import engine as engine_mod

    opts = MWUOptions(eps=EPS, step_rule="newton")
    t0 = time.perf_counter()
    graphs = [erdos(*SERVE_TIERS[i % 3], seed=i) for i in range(n_requests)]
    probs = [build(("match", "vcover")[i % 2], g, device="cuda") for i, g in enumerate(graphs)]
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    print(f"  {n_requests} requests (match, vcover alternating; tiers {SERVE_TIERS}) generated and built in "
          f"{t_build:.1f} s on the host", flush=True)

    class RoundSolver(Solver):
        """Keeps each round's lanes, iterations and wall time."""

        def __init__(self):
            super().__init__(opts, batch_width=1)
            self.rounds = []

        def solve_stack(self, problems, bounds):
            t0 = time.perf_counter()
            batch = super().solve_stack(problems, bounds)
            self.rounds.append(dict(bucket=(problems[0].name, problems[0].P.shape if problems[0].P is not None
                                            else problems[0].C.shape), lanes=len(problems),
                                    iters=[int(i) for i in batch.iters], probes=int(np.sum(batch.ls_probes)),
                                    wall_s=time.perf_counter() - t0))
            self.last = batch
            return batch

    # the certificates' host time, inside the engine's rounds
    certify, cert = engine_mod.certify_solution, dict(s=0.0, n=0)

    def timed_certify(*a, **kw):
        t0 = time.perf_counter()
        out = certify(*a, **kw)
        cert["s"], cert["n"] = cert["s"] + time.perf_counter() - t0, cert["n"] + 1
        return out

    engine = LPEngine(LPServeConfig(opts=opts, lanes=4))
    engine.solver = RoundSolver()
    torch.cuda.synchronize()
    engine_mod.certify_solution = timed_certify
    K.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        sols = engine.solve_many(probs)
        torch.cuda.synchronize()
    finally:
        engine_mod.certify_solution = certify
    t_engine = time.perf_counter() - t0
    launches = K.launch_counts()
    stats = engine.stats()
    rounds = engine.solver.rounds

    seq = Solver(opts, batch_width=1)
    t0 = time.perf_counter()
    refs = [seq.solve(p) for p in probs]
    torch.cuda.synchronize()
    t_seq = time.perf_counter() - t0

    lane_iters = sum(sum(r["iters"]) for r in rounds)
    loop_iters = sum(max(r["iters"]) for r in rounds)
    info = dict(requests=n_requests, build_s=t_build, engine_wall_s=t_engine, sequential_wall_s=t_seq,
                batches=stats["batches"], feasibility_calls=stats["feasibility_calls"],
                mwu_iters=stats["mwu_iters"], lane_iters_launched=lane_iters, loop_iters=loop_iters,
                lane_occupancy=stats["lane_occupancy"], padding_waste=stats["padding_waste"],
                latency_p50_s=stats["latency_p50_s"], latency_p99_s=stats["latency_p99_s"],
                rounds_wall_s=sum(r["wall_s"] for r in rounds), certify_s=cert["s"], certificates=cert["n"],
                compiles=stats["compiles"],
                compile_cache_hits=stats["compile_cache_hits"], launches=launches,
                buckets={k: {f: b[f] for f in ("requests", "batches", "lane_occupancy", "padding_waste",
                                               "feasibility_calls", "mwu_iters", "batch_seconds")}
                         for k, b in stats["buckets"].items()})
    print("  " + json.dumps(info), flush=True)
    for key, b in stats["buckets"].items():
        print(f"  bucket {key:24s} requests={b['requests']:3d} batches={b['batches']:3d} "
              f"occupancy={b['lane_occupancy']:.0%} waste={b['padding_waste']:.1%} "
              f"batch_seconds={b['batch_seconds']:.2f}", flush=True)
    print(f"  engine {t_engine:.2f} s ({stats['batches']} batches, {stats['feasibility_calls']} calls, "
          f"{stats['mwu_iters']} lane iterations of real lanes, {lane_iters} launched, {loop_iters} loop "
          f"iterations): rounds {info['rounds_wall_s']:.2f} s, {cert['n']} certificates {cert['s']:.2f} s, the rest "
          f"(x copies, padding at submit, bookkeeping) {t_engine - info['rounds_wall_s'] - cert['s']:.2f} s; latency "
          f"p50 {stats['latency_p50_s']:.2f} s, p99 {stats['latency_p99_s']:.2f} s; sequential Solver(batch_width=1) "
          f"{t_seq:.2f} s", flush=True)
    for r in rounds:
        print(f"    round {r['bucket'][0]} {list(r['bucket'][1])}: {r['lanes']} lanes, iterations {r['iters']}, "
              f"{r['probes']} probes, {r['wall_s']:.3f} s", flush=True)

    for i, (g, p, sol, ref) in enumerate(zip(graphs, probs, sols, refs)):
        ok = sol.found and sol.feasible
        if ok and p.name == "match":  # packing: max Mx <= 1 on the host
            loads = np.bincount(g.u, sol.x, g.n) + np.bincount(g.v, sol.x, g.n)
            cert, ok = f"max Mx {loads.max()!r}", loads.max() <= 1 + 1e-9
        elif ok:  # covering: min M^T x >= 1 on the host
            cover = sol.x[g.u] + sol.x[g.v]
            cert, ok = f"min M^T x {cover.min()!r}", cover.min() >= 1 - 1e-9
        else:
            cert = "not found"
        rel = abs(sol.objective - ref.objective) / max(abs(ref.objective), 1e-12)
        check(failures, ok and ref.feasible and rel <= 3 * EPS,
              f"request {i:2d}: {p.name:6s} erdos{SERVE_TIERS[i % 3]} calls {sol.feasibility_calls}, objective "
              f"{sol.objective:.3f} (sequential {ref.objective:.3f}, rel {rel:.4f}, bar {3 * EPS}); {cert}")
    check(failures, stats["batches"] < stats["feasibility_calls"],
          f"batches {stats['batches']} < feasibility calls {stats['feasibility_calls']}")
    check(failures, stats["completed"] == n_requests and stats["not_found"] == 0,
          f"{stats['completed']} of {n_requests} requests completed, {stats['not_found']} not found")
    check(failures, launches["newton_search"] == launches["step_direction"] == lane_iters
          and launches["axpy_reduce"] == 3 * lane_iters and launches["softmax_weights"] == 2 * lane_iters
          and launches["linesearch_probe"] == 0 and launches["flash_attention"] == 0,
          f"every lane iteration on the card: launches {launches} for {lane_iters} lane iterations (the search, the "
          f"step direction once each, the axpy 3x, softmax 2x, no lone probe)")

    # one round profiled: a fresh engine's second round over the four
    # requests of the first tier-0/1 match bucket (its first round built
    # their CSR); reads are the device-to-host copies. The same round of a
    # second fresh engine, timed without the profiler (a card solve repeats:
    # the same iterations), gives the wall time the idle share is taken of.
    quad = [p for i, p in enumerate(probs) if i % 2 == 0 and i % 3 != 2][:4]

    def second_round(profiled: bool):
        eng = LPEngine(LPServeConfig(opts=opts, lanes=4))
        eng.solver = RoundSolver()
        for p in quad:
            eng.submit(p)
        eng.step()
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if profiled else None
        if prof is not None:
            prof.__enter__()
        eng.step()
        torch.cuda.synchronize()
        if prof is not None:
            prof.__exit__(None, None, None)
        check(failures, len(eng.solver.rounds) == 2, f"the fresh engine ran {len(eng.solver.rounds)} rounds (2)")
        return eng.solver.rounds[-1], 1e3 * (time.perf_counter() - t0), K.launch_counts(), prof

    timed, wall_ms, _, _ = second_round(False)
    r, prof_wall_ms, prof_launches, prof = second_round(True)
    check(failures, r["iters"] == timed["iters"], f"the timed and the profiled round repeat ({timed['iters']} / "
                                                  f"{r['iters']} iterations)")
    events = prof.key_averages()
    kernels = sorted(((e.self_device_time_total / 1e3, e.count, e.key) for e in events
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0), reverse=True)
    busy = sum(k[0] for k in kernels)
    reads = sum(e.count for e in events if e.device_type == DeviceType.CUDA and "DtoH" in e.key)
    loop = max(r["iters"])
    copy_ms = sum(k[0] for k in kernels if "Memcpy DtoH" in k[2])
    prof_info = dict(lanes=r["lanes"], lane_iters=sum(r["iters"]), loop_iters=loop, probes=r["probes"],
                     wall_ms=wall_ms, profiled_wall_ms=prof_wall_ms, device_busy_ms=busy, dtoh_copy_ms=copy_ms,
                     device_idle_share=1.0 - busy / wall_ms,
                     kernel_ms_per_lane_iter=(busy - copy_ms) / max(sum(r["iters"]), 1), host_reads=reads,
                     host_reads_per_loop_iter=reads / max(loop, 1), launches=prof_launches)
    info["profile_round"] = prof_info
    print(f"  profile of one engine round: {json.dumps(prof_info)}", flush=True)
    for ms, count, key in kernels[:14]:
        print(f"    {ms:10.2f} ms {count:7d} x  {key[:110]}", flush=True)
    check(failures, reads <= loop + 3,
          f"profiled round: {reads} host reads in {loop} loop iterations ({r['probes']} probes; bar: loop "
          f"iterations + 3)")
    check(failures, prof_launches["linesearch_probe"] == 0 and prof_launches["newton_search"] == sum(r["iters"]),
          f"profiled round: no probe read back one by one (linesearch_probe {prof_launches['linesearch_probe']}, "
          f"newton_search {prof_launches['newton_search']} for {sum(r['iters'])} lane iterations)")
    return info


# -- phase 7 -----------------------------------------------------------------
def table3(prob, bound: float, failures: list) -> dict:
    """Table 3 at full width: one profiled feasibility solve of phase 3's
    bmatch problem at its certified bound per step rule (newton, binary,
    std; std cut to TABLE3_STD_CAP iterations), each through ``profile_run``: its
    iterations, probes an iteration, device ms a lane iteration, ms a
    search launch, host reads a loop iteration (at most 1.01 for every
    rule) and the device's idle share."""
    from repro_torch.api import MWUOptions, Solver

    out = {}
    for rule in ("newton", "binary", "std"):
        cap = TABLE3_STD_CAP if rule == "std" else MWUOptions().max_iter
        if rule == "std":
            print(f"  cut: the std rule's solve is capped at {cap} iterations (MWUOptions' default cap: "
                  f"{MWUOptions().max_iter})", flush=True)
        opts = MWUOptions(eps=EPS, step_rule=rule, max_iter=cap)
        t0 = time.perf_counter()
        p = profile_run(lambda: Solver(opts).feasible(prob, bound), f"Table 3, the {rule} rule at bound {bound!r}",
                        failures)
        p["phase_s"] = time.perf_counter() - t0
        p["probes_per_iter"] = p["probes"] / max(p["lane_iters"], 1)
        p["ms_per_search_launch"] = p["search_ms"] / p["search_launches"] if p["search_launches"] else None
        out[rule] = p
        print(f"  Table 3 {rule}: {p['status'][0]}, {p['lane_iters']} iterations, {p['probes_per_iter']:.3f} probes an "
              f"iteration, {p['device_ms_per_lane_iter']:.4f} device ms a lane iteration, ms a search launch "
              f"{p['ms_per_search_launch']}, {p['host_reads_per_loop_iter']:.4f} host reads a loop iteration, idle "
              f"share {p['device_idle_share']:.4f}; timed and profiled in {p['phase_s']:.1f} s", flush=True)
        launches_ok = p["search_launches"] == (0 if rule == "std" else p["lane_iters"])
        check(failures, p["host_reads_per_loop_iter"] <= 1.01 and launches_ok,
              f"Table 3 {rule}: {p['host_reads_per_loop_iter']:.4f} host reads a loop iteration (bar 1.01); "
              f"{p['search_launches']} search launches for {p['lane_iters']} iterations")
    return out


def iters_to(viol: np.ndarray, eps: float):
    """Iterations until the violation first is at most eps
    (benchmarks/bench_convergence.py's iters_to), None if never."""
    idx = np.nonzero(viol <= eps)[0]
    return int(idx[0]) if len(idx) else None


def figure3(g, failures: list) -> dict:
    """Figure 3 at full width: generalized matching on phase 3's graph with
    ``benchmarks/bench_convergence.py::build_instance``'s bounds (users lb =
    min(3, deg), ub = 5; items ub = 200), eps FIG3_EPS, float64, by MWU with
    the Newton rule, MWU with the std rule (``solve_traced``) and MPCSolver
    (``mpc_solve``), each cut to FIG3_CAP iterations, the std rule to
    FIG3_STD_CAP. For each: iterations
    to eps ("not reached by the cap" where so), the final violation, ms an
    iteration (host clock) and host reads an iteration (counted). First
    ``mpc_solve`` on a small instance (build_instance cut to 300 users and
    140 items) on the card and on the CPU: the same iterations, x within
    rel 1e-9."""
    from repro_torch.core import MPCOptions, mpc_solve
    from repro_torch.core.mwu import MWUOptions, solve_traced
    from repro_torch.graphs import bipartite_ratings, generalized_matching_lp

    def bounds(graph):
        deg, s = graph.degrees(), graph.bipartite_split
        lb, ub = np.zeros(graph.n), np.ones(graph.n)
        lb[:s], ub[:s], ub[s:] = np.minimum(3, deg[:s]), 5, 200
        return lb, ub

    small = bipartite_ratings(300, 140, avg_ratings=18.0, seed=0)
    runs = {}
    for dev in ("cpu", "cuda"):
        sP, sC, s_mask = generalized_matching_lp(small, *bounds(small), device=dev)
        runs[dev] = mpc_solve(sP, sC, MPCOptions(eps=FIG3_EPS, max_iter=3000), c_mask=s_mask)
    (x_c, tr_c), (x_g, tr_g) = runs["cpu"], runs["cuda"]
    rel = float(np.max(np.abs(x_g - x_c) / np.maximum(np.abs(x_c), 1e-300)))
    check(failures, tr_g["iters"] == tr_c["iters"] and rel <= 1e-9,
          f"mpc_solve on the small instance: card {tr_g['iters']} / cpu {tr_c['iters']} iterations, x within rel "
          f"{rel:.3g} (bar 1e-9)")

    lb, ub = bounds(g)
    t0 = time.perf_counter()
    P, C, cm = generalized_matching_lp(g, lb, ub, device="cuda")
    # build the operators' CSR before timing (at their first card products)
    x = torch.full((g.m,), 1e-6, dtype=torch.float64, device="cuda")
    P.rmatvec(P.matvec(x))
    C.rmatvec(C.matvec(x))
    del x
    torch.cuda.synchronize()
    print(f"  generalized matching on {g.n} vertices, {g.m} edges: P {P.shape}, C {C.shape}, {int(cm.sum())} covering "
          f"rows kept; built in {time.perf_counter() - t0:.1f} s. cut: Newton and MPCSolver capped at {FIG3_CAP} "
          f"iterations, std at {FIG3_STD_CAP} (bench_convergence.py: 6000)", flush=True)
    out = {}
    methods = (("mwu-newton", "newton", FIG3_CAP), ("mwu-std", "std", FIG3_STD_CAP), ("mpcsolver-gd", None, FIG3_CAP))
    for name, rule, cap in methods:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with counted_reads() as reads:
            if rule is None:
                x, tr = mpc_solve(P, C, MPCOptions(eps=FIG3_EPS, max_iter=cap), c_mask=cm)
                iters = tr["iters"]
            else:
                res, tr = solve_traced(P, C, MWUOptions(eps=FIG3_EPS, step_rule=rule, max_iter=cap), c_mask=cm)
                x, iters = res.x, res.iters
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        viol = tr["max_violation"]
        reached = iters_to(viol, FIG3_EPS)
        r = dict(iters=iters, cap=cap, iters_to_eps=reached, final_violation=float(viol[-1]), wall_s=wall,
                 ms_per_iter=1e3 * wall / max(iters, 1), host_reads=reads[0],
                 host_reads_per_iter=reads[0] / max(iters, 1))
        out[name] = r
        print(f"  Figure 3 {name}: iterations to eps {FIG3_EPS}: "
              f"{'not reached by the cap' if reached is None else reached}; {iters} iterations, final violation "
              f"{r['final_violation']!r}, {r['ms_per_iter']:.3f} ms an iteration, {r['host_reads_per_iter']:.4f} host "
              f"reads an iteration", flush=True)
        finite = bool(np.isfinite(viol).all()) and bool(torch.isfinite(torch.as_tensor(x)).all())
        check(failures, finite and 0 < iters <= cap and len(viol) >= iters and reads[0] <= iters + 3,
              f"Figure 3 {name}: {iters} iterations, finite violations and x, {reads[0]} host reads")
        del x, tr
    del P, C, cm
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-users", type=int, default=480_189, help="users of the full-size bmatch graph")
    ap.add_argument("--serve-requests", type=int, default=12, help="requests of phase 6's serving run")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import kernels as K
    from repro_torch.kernels import loader
    from repro_torch.kernels.axpy_reduce.ref import axpy_reduce_ref
    from repro_torch.kernels.incidence_gather.ref import incidence_gather_ref
    from repro_torch.kernels.incidence_scatter.ref import incidence_scatter_ref
    from repro_torch.kernels.linesearch_probe.ref import linesearch_probe2_ref
    from repro_torch.kernels.softmax_weights.ref import softmax_weights_ref
    from repro_torch.kernels.step_direction.ref import step_direction_ref
    from repro_torch.core.mwu import make_eta

    t_start = time.perf_counter()
    print("== phase 1: card and build", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}", flush=True)
    lib, build_s = loader.build()
    print(f"  nvcc build of {len(list(loader.CSRC.glob('*.cu')))} sources: {build_s:.1f} s -> {lib.name}", flush=True)
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line or line.startswith("=="):
            print("  " + line.strip(), flush=True)

    print("== phase 2: kernels vs plain versions on the card", flush=True)
    refs = dict(incidence_gather=incidence_gather_ref, softmax_weights=softmax_weights_ref,
                linesearch_probe2=linesearch_probe2_ref, axpy_reduce=axpy_reduce_ref,
                incidence_scatter=incidence_scatter_ref, step_direction=step_direction_ref)
    n_vertices, n_items, n_edges = 497_959, 17_770, 98_609_647  # the full-size bmatch graph
    eta = float(make_eta(n_vertices + 1, EPS))
    failures: list = []
    rows = []
    for dtype in (torch.float32, torch.float64):
        rows += kernel_rows(K, refs, n_vertices, n_items, n_edges, dtype, eta, failures)
    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 plain attention's products in full f32
    rows += flash_rows(K, smi, failures)
    end_phase("2", failures)

    print("== phase 3: full-size bmatch solve", flush=True)
    info, bmatch, graph = full_solve(args.n_users, failures)
    end_phase("3", failures)

    print("== phase 4: small solves, card vs CPU", flush=True)
    small_launches = small_solves(failures)
    batch_solves(failures)
    binary_launches = binary_solves(failures)
    end_phase("4", failures)

    print("== phase 5: hubert-xlarge encoder forward at full width", flush=True)
    enc = encoder_forward(K, failures)
    end_phase("5", failures)

    print("== phase 6: graph-LP serving at card size (lpserve)", flush=True)
    serve = serve_requests(args.serve_requests, failures)
    end_phase("6", failures)

    print("== phase 7: the paper's comparison studies at full width (Table 3, Figure 3)", flush=True)
    t7 = time.perf_counter()
    table3(bmatch, info["bound"], failures)
    del bmatch
    torch.cuda.empty_cache()
    figure3(graph, failures)
    print(f"  phase 7: {time.perf_counter() - t7:.1f} s", flush=True)
    end_phase("7", failures)
    print(f"  total {time.perf_counter() - t_start:.1f} s", flush=True)

    # one entry per kernel: for the MWU kernels their float64 row at the
    # solve's largest shape and the solve's launches (the binary search's and
    # the lone probe's from phase 4's binary-rule solves, where the probe
    # runs inside the search: 0; the gather's from its six Newton solves:
    # bmatch gathers inside step_direction); for flash attention row (a) in
    # bf16 and the launches of one encoder forward
    kernels = []
    for name, (source, replaces) in K.KERNELS.items():
        if name == "flash_attention":
            r = next(r for r in rows if r["name"] == name and r["case"] == "a" and r["dtype"] == "bfloat16")
            launches = enc["launches"][name]
        else:
            r = max((r for r in rows if r["name"] == name and r["dtype"] == "float64"
                     and r.get("form") in (None, MAIN_FORM.get(name))), key=lambda r: r["shape"][0])
            launches = {"linesearch_probe": binary_launches, "binary_search": binary_launches,
                        "incidence_gather": small_launches}.get(name, info["launches"])[name]
        launches += serve["launches"][name]
        masked = next((m for m in rows if name in MASKED_FORM and m["name"] == name and m["dtype"] == "float64"
                       and m.get("form") == MASKED_FORM[name]), None)
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches,
                            serving_launches=serve["launches"][name],
                            **{k: r.get(k) for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                                     "library_ms", "call_ms", "plain_call_ms", "shape", "dtype", "bar",
                                                     "within_bar", "form")},
                            masked=None if masked is None else {k: masked.get(k) for k in (
                                "form", "shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms")}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

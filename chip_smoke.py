#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--n-users N]

Builds the CUDA kernels of ``src/repro_torch/kernels/csrc`` with nvcc for
sm_90a and drives the port's two paths, the MWU graph-LP solve and the
hubert-xlarge encoder forward, in five phases; any failed phase exits
non-zero before the result lines are printed.

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
   and to its plain version. The axpy gets a second row too: its step read
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
   replaces.
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
   rgg(12) with ``step_rule="binary"``: its host loop launches the probe
   kernel once a probe, and those launches are the probe's count in the
   kernels line.
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

The line before the last is ``{"kernels": [...]}``, one entry per kernel;
the last is ``{"ok": true, "device": {...}}``. The flash entry takes row
(a) in bf16 and its launches from phase 5; the axpy and the search take
the row of the form the main path launches (device step, step form). The script exits non-zero
without a result when no CUDA device is present or when it is run outside
the repository.
"""
from __future__ import annotations

import argparse
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
# rows in phase 2 (its kernels-line entry takes that row)
MAIN_FORM = {"axpy_reduce": "device step", "newton_search": "step"}


class SmokeFailure(RuntimeError):
    pass


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


def bound(nbytes: int, ops: int, rate) -> tuple[float, str]:
    """Least time (ms) for the bytes over HBM's rate or the ops over the
    peak of ``rate`` (a key of PEAK_OPS_PER_S), the larger, and which."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[rate]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


# -- phase 2 -----------------------------------------------------------------
def kernel_rows(K, refs, n_vertices: int, n_items: int, n_edges: int, dtype, eta: float,
                failures: list) -> list[dict]:
    """Each kernel vs its plain version at the main path's shapes in ``dtype``."""
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

    # the scatter M x on the same edges with the items' Zipf popularity of
    # graphs/generators.py (item = n_items / rank, rank = U^-2 at zipf_a
    # 1.5): item 0 holds ~E / sqrt(n_items) = 740k entries. The v side as
    # the operator builds it (cut into slabs of x) and in one piece (no
    # slabs: one segment of hundreds of merge tiles); in both many CSR rows
    # cross merge-tile edges
    v = (n - n_items) + torch.clamp((n_items * torch.rand(E, generator=gen, device=dev, dtype=torch.float64) ** 2)
                                    .to(torch.int32), max=n_items - 1)
    op = Incidence(u=u, v=v, n_vertices=n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a, b = op.csr
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
          f"merge tiles (u, v, v in one piece) {cross}; CSR {(a.nbytes + b.nbytes) / 1e6:.1f} MB built in "
          f"{t_csr:.2f} s")
    x = torch.rand(E, generator=gen, device=dev, dtype=dtype)
    got, again = K.incidence_scatter(x, a, b), K.incidence_scatter(x, a, b)
    ref = refs["incidence_scatter"](x, a, b)
    same = torch.equal(got, again)
    err = ((got - ref).abs() / ref.abs().clamp(min=1.0)).max().item()
    one, one_again = K.incidence_scatter(x, a, whole), K.incidence_scatter(x, a, whole)
    one_err = ((one - ref).abs() / ref.abs().clamp(min=1.0)).max().item()
    check(failures, torch.equal(one, one_again) and one_err <= tol,
          f"incidence_scatter {dtype}, v side in one piece: two launches bitwise equal, {one_err:.3g} from the "
          f"plain version (relative; bar {tol})")
    del one, one_again, whole
    lib_err = ((torch.zeros(n, dtype=dtype, device=dev).index_add_(0, u, x).index_add_(0, v, x) - ref).abs()
               / ref.abs().clamp(min=1.0)).max().item()
    del got, again, ref
    check(failures, same, f"incidence_scatter {dtype} [{E}, {n}]: two launches bitwise equal")
    check(failures, lib_err <= tol, f"index_add_ M x agrees with the plain version ({lib_err:.3g}, relative)")
    row("incidence_scatter", [E, n], err, tol, err <= tol and same, lambda: K.incidence_scatter(x, a, b),
        lambda: refs["incidence_scatter"](x, a, b), 10, E * (size + 4) + 2 * (n + 1) * 8 + n * size, 2 * E,
        lambda: torch.zeros(n, dtype=dtype, device=dev).index_add_(0, u, x).index_add_(0, v, x))
    del u, v, x, op, a, b
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


def search_rows(K, n: int, dtype, eta: float, failures: list) -> list[dict]:
    """The Newton search kernel on seeded n + 1 states. Against the host loop
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

    def host_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        return 1e3 * (time.perf_counter() - t0) / 20

    size = torch.finfo(dtype).bits // 8
    for kind, alpha0 in (("far", 1.0), ("near", 37.0), ("done", None)):
        y, z, dy, dz = search_state(n, kind, 1, dtype)
        host = stepsize._newton_step_host(y, z, dy, dz, eta, ls_eps=EPS, alpha0=alpha0)
        dev = stepsize.newton_step(y, z, dy, dz, eta, ls_eps=EPS, alpha0=alpha0)
        p_alpha, p_probes, p_completes = newton_search_ref(y, dy, z, dz, eta, EPS, alpha0).tolist()
        same = (struct.pack("d", dev.alpha), dev.probes, dev.completes) == \
            (struct.pack("d", host.alpha), host.probes, host.completes)
        bar = EPS * max(dev.alpha, p_alpha)
        near = dev.completes == bool(p_completes) and abs(dev.alpha - p_alpha) <= bar
        check(failures, same, f"newton_search {dtype} [{n}, 1] {kind}, alpha0 {alpha0}: card {tuple(dev)} | host "
                              f"loop {tuple(host)}")
        check(failures, near, f"newton_search {dtype} [{n}, 1] {kind}, alpha0 {alpha0}: plain search "
                              f"({p_alpha!r}, {int(p_probes)}, {bool(p_completes)}), |alpha - plain| "
                              f"{abs(dev.alpha - p_alpha):.3g} (bar {bar:.3g})")
        if kind == "far":
            timed, err, probes, ok, far_bar = (y, z, dy, dz, alpha0), abs(dev.alpha - p_alpha), dev.probes, \
                same and near, bar
    y, z, dy, dz, alpha0 = timed
    ms = device_ms(lambda: K.newton_search(y, dy, z, dz, eta, EPS, alpha0), 50)
    plain_ms = host_ms(lambda: newton_search_ref(y, dy, z, dz, eta, EPS, alpha0).tolist())
    loop_ms = host_ms(lambda: stepsize._newton_step_host(y, z, dy, dz, eta, ls_eps=EPS, alpha0=alpha0))
    call = call_ms(lambda: stepsize.newton_step(y, z, dy, dz, eta, ls_eps=EPS, alpha0=alpha0), 50)
    # bound: the inputs read once; operations of every sweep the search took
    b_ms, b_by = bound(2 * (n + 1) * size, 9 * (n + 1) * (probes + 1), dtype)
    r = dict(name="newton_search", dtype=str(dtype).removeprefix("torch."), shape=[n, 1], max_abs_err=err,
             bar=far_bar, within_bar=ok, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
             call_ms=call, plain_call_ms=plain_ms, host_loop_ms=loop_ms, probes=probes,
             ms_per_probe=ms / (probes + 1))
    check(failures, ok, f"newton_search {r['dtype']} [{n}, 1]: {probes} probes; device ms a search {ms:.4f} "
                        f"({r['ms_per_probe']:.4f} a probe with the alpha = 0 sweep), bound {b_ms:.4f} ({b_by}); "
                        f"host clock ms a search: plain {plain_ms:.4f}, host loop over the probe kernel "
                        f"{loop_ms:.4f}, newton_step with its read {call:.4f}")

    def bits(v: float) -> bytes:
        return struct.pack("d", v)

    dev = torch.device("cuda")
    step_ok, step_err = True, 0.0
    for kind, alpha0 in (("far", 1.0), ("near", 37.0), ("done", 1.0), ("below", 1.0)):
        y, z, dy, dz = search_state(n, kind, 1, dtype)
        host = stepsize._newton_step_host(y, z, dy, dz, eta, ls_eps=EPS, alpha0=alpha0)
        for d_max in (1e-3, 0.0):
            dm = torch.tensor(d_max, dtype=dtype, device=dev)
            ap, ap_p = (torch.tensor([alpha0], dtype=torch.float64, device=dev) for _ in range(2))
            rec = stepsize.newton_step_record(y, z, dy, dz, eta, EPS, dm, ap).tolist()
            plain = newton_step_ref(y, dy, z, dz, eta, EPS, dm, ap_p).tolist()
            bad = d_max <= 0 or host.alpha < 1
            same = (bits(rec[0]), int(rec[1]), bool(rec[2])) == (bits(host.alpha), host.probes, host.completes) \
                and bool(rec[4]) == bad and bits(rec[3]) == bits(0.0 if bad else host.alpha) \
                and bits(ap.item()) == bits(alpha0 if bad else host.alpha)
            near = (rec[2], rec[4]) == (plain[2], plain[4]) and abs(rec[0] - plain[0]) <= EPS * max(rec[0], plain[0])
            check(failures, same and near and (kind != "below" or host.alpha < 1),
                  f"newton_search step form {dtype} [{n}, 1] {kind}, alpha_prev {alpha0}, max(d) {d_max}: record "
                  f"{rec} | host loop {tuple(host)}, bad {bad}; plain {plain}")
            step_ok = step_ok and same and near
            step_err = max(step_err, abs(rec[0] - plain[0]))
    y, z, dy, dz = search_state(n, "far", 1, dtype)
    dm0, ap, out = (torch.zeros((), dtype=dtype, device=dev), torch.ones(1, dtype=torch.float64, device=dev),
                    torch.empty(5, dtype=torch.float64, device=dev))
    probes = int(K.newton_search(y, dy, z, dz, eta, EPS, ap, d_max=dm0, out=out)[1].item())
    ms = device_ms(lambda: K.newton_search(y, dy, z, dz, eta, EPS, ap, d_max=dm0, out=out), 50)
    plain_ms = host_ms(lambda: newton_step_ref(y, dy, z, dz, eta, EPS, dm0, ap).tolist())
    b_ms, b_by = bound(2 * (n + 1) * size, 9 * (n + 1) * (probes + 1), dtype)
    s = dict(r, form="step", max_abs_err=step_err, within_bar=step_ok, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
             bound_by=b_by, call_ms=call_ms(lambda: K.newton_search(y, dy, z, dz, eta, EPS, ap, d_max=dm0, out=out), 50),
             plain_call_ms=plain_ms, probes=probes, ms_per_probe=ms / (probes + 1))
    check(failures, step_ok, f"newton_search step form {s['dtype']} [{n}, 1]: {probes} probes; device ms a search "
                             f"{ms:.4f}, bound {b_ms:.4f} ({b_by}); plain {plain_ms:.4f} (host clock); eager call "
                             f"{s['call_ms']:.4f}")
    return [dict(r, form="host alpha0"), s]


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


def full_solve(n_users: int, failures: list) -> dict:
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
        elif name == "linesearch_probe":  # the Newton search probes inside its own launch (phase 4 runs it)
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
    return info


def profile_run(run, what: str, failures: list) -> dict:
    """Where the time of ``run()`` (a feasibility solve or a batch of them)
    goes: the call timed alone, then again under torch.profiler for device
    time by kernel (the two take the same iterations: a card solve
    repeats). Lane iterations are the lanes' iterations summed, loop
    iterations the longest lane's; host reads are the device-to-host
    copies. The profile must show the scatter and step-direction kernels
    and no index_add_ / scatter_add kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled = run()
        torch.cuda.synchronize()
    # device-side events only: the operators that launched them carry the
    # same device time again
    kernels = sorted(((e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0), reverse=True)
    busy_ms = sum(k[0] for k in kernels)
    port_ms = sum(k[0] for k in kernels if "rt::" in k[2])
    search_ms = sum(k[0] for k in kernels if "newton_search" in k[2])
    # host reads: the device-to-host copies (.item(), .tolist()) the run made
    reads = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA and "DtoH" in e.key)
    iters = np.atleast_1d(res.iters)
    lane_iters, loop_iters = int(iters.sum()), int(iters.max())
    out = dict(lanes=len(iters), lane_iters=lane_iters, loop_iters=loop_iters, probes=int(np.sum(res.ls_probes)),
               wall_ms=wall_ms, wall_ms_per_lane_iter=wall_ms / max(lane_iters, 1), device_busy_ms=busy_ms,
               device_ms_per_lane_iter=busy_ms / max(lane_iters, 1),
               device_idle_share=1.0 - busy_ms / wall_ms if busy_ms else None,
               port_kernels_ms=port_ms, other_device_ms=busy_ms - port_ms, newton_search_ms=search_ms,
               newton_search_share=search_ms / busy_ms if busy_ms else None, host_reads=reads,
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
    for name in ("scatter_tiles_kernel", "scatter_rows_kernel", "step_direction_kernel"):
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
    """The binary step rule, card vs CPU: a host loop over the two-sided
    probe kernel (one launch a probe), the path that still launches it."""
    from repro_torch import kernels as K
    from repro_torch.api import MWUOptions, Solver, Status
    from repro_torch.graphs import build, rgg

    g = rgg(12, seed=0)
    opts = MWUOptions(eps=EPS, step_rule="binary")
    families = ("match", "vcover")
    sols = {(f, "cpu"): Solver(opts).solve(build(f, g, device="cpu")) for f in families}
    probs = {f: build(f, g, device="cuda") for f in families}
    torch.cuda.synchronize()
    K.reset_launch_counts()
    for family in probs:
        sols[family, "cuda"] = Solver(opts).solve(probs[family])
    torch.cuda.synchronize()
    launches = K.launch_counts()
    for family in probs:
        a, b = sols[family, "cuda"], sols[family, "cpu"]
        same = a.status == b.status == Status.FEASIBLE and abs(a.bound - b.bound) <= 1e-5 * abs(b.bound)
        same = same and abs(a.objective - b.objective) <= 2 * EPS * abs(b.objective)
        check(failures, same, f"{family}, binary rule: card {Status.NAMES[a.status]} bound {a.bound:.6g} objective "
                              f"{a.objective:.6g} probes {a.ls_probes_total} | cpu {Status.NAMES[b.status]} bound "
                              f"{b.bound:.6g} objective {b.objective:.6g} probes {b.ls_probes_total}")
    check(failures, launches["linesearch_probe"] > 0 and launches["newton_search"] == 0,
          f"binary-rule solves launched linesearch_probe {launches['linesearch_probe']} times, newton_search "
          f"{launches['newton_search']}")
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-users", type=int, default=480_189, help="users of the full-size bmatch graph")
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
    info = full_solve(args.n_users, failures)
    end_phase("3", failures)

    print("== phase 4: small solves, card vs CPU", flush=True)
    small_launches = small_solves(failures)
    batch_solves(failures)
    binary_launches = binary_solves(failures)
    end_phase("4", failures)

    print("== phase 5: hubert-xlarge encoder forward at full width", flush=True)
    enc = encoder_forward(K, failures)
    end_phase("5", failures)
    print(f"  total {time.perf_counter() - t_start:.1f} s", flush=True)

    # one entry per kernel: for the MWU kernels their float64 row at the
    # solve's largest shape and the solve's launches (the probe kernel's from
    # phase 4's binary-rule solves, the gather's from its six Newton solves:
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
            launches = {"linesearch_probe": binary_launches,
                        "incidence_gather": small_launches}.get(name, info["launches"])[name]
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches,
                            **{k: r.get(k) for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                                     "library_ms", "call_ms", "plain_call_ms", "shape", "dtype", "bar",
                                                     "within_bar", "form")}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time the step-size search kernel on one GPU, and split its sweeps into stages.

    python3 tools/search_ab.py [--src DIR] [--no-split] [--reps N] [--shapes ...]

The kernel of ``csrc/linesearch_probe.cu`` runs at three shapes, f64 and
f32, each on ``chip_smoke.py``'s seeded "far" state (``search_state``):

* ``bmatch``: phase 3's state, [497,959, 1], no mask;
* ``bucket``: phase 6's bucket, [1,048,576, 1], the vertex rows masked
  (tier 1's 800,000 kept), as a served match lane;
* ``vcover``: the bucket's covering side, [1, 4,194,304], the edge rows
  masked (tier 1's 3,000,000 kept), as a served vcover lane.

For each: the Newton and the binary search in their step form (max(d) = 0,
so that alpha_prev stays and every replay runs the same search) and the
lone two-sided probe, each timed as ``chip_smoke.py`` times a kernel (one
call captured in a CUDA graph, replayed between CUDA events), with the
kernel's plan (``linesearch_probe.ops.search_plan``: registers or
streamed, where the tree has one), the sweeps and us a sweep. Through the
timing entry point (``rt_search_ab``, where the tree has it) the same
search also runs with the streamed path forced, timed the same way.

Then, unless ``--no-split``, the timing instantiation of each variant
(thread 0 of every block stamps the SM's clock64 and the global timer at
each point of each sweep) splits the sweeps. Its record must equal the
wrapper's bit for bit, or the tool exits non-zero. A sweep's stages are
read on its critical block, the last to arrive among the blocks that
fold (block 0 on this tree; every block on a tree whose blocks all fold
behind a grid barrier): the first tile's loads, the chunks' exps (and
the later tiles' loads), the block reduction, the partial's store and
arrival, the wait for the other blocks (the grid barrier), the fold's
loads, the fold (its block reduction, log, div), the controller, and the
broadcast (with the hand-off). Each
stage is the median over the sweeps after the first (the first also
loads the inputs from device memory; it is printed alone), in ns at the
SM clock that the run's own stamps give (clock64 ticks over global-timer
ns, on block 0). The global timer's step is checked first
(``rt_clock_probe``).

``--src DIR`` imports ``repro_torch`` from DIR (an unpacked tree of another
commit, whose kernels are then built there). A tree without the timing
instantiation is timed without the split. ``--patch FILE`` first copies
DIR under ``build/search_ab/`` and applies FILE, a unified diff against
that tree: ``tools/search_ab_stamps_1c14182.patch`` adds the stamps and the
timing entry point to the kernel of commit 1c14182 (before its redesign)
and changes nothing else, so that the split of that kernel's sweep can
be taken again. Run each tree in its own process: two builds of the
kernel library do not work in one.

    mkdir -p build/parent && git archive 1c14182 | tar -x -C build/parent
    python3 tools/search_ab.py --src build/parent/src --patch tools/search_ab_stamps_1c14182.patch
    python3 tools/search_ab.py
"""
from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import statistics
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
EPS = 0.1
SHAPES = {"bmatch": (497_959, 1, None), "bucket": (1 << 20, 1, ("p", 800_000)),
          "vcover": (1, 1 << 22, ("c", 3_000_000))}
STAGES = ["loads", "exps", "block reduction", "store + arrive", "wait", "fold loads", "fold", "controller",
          "broadcast"]


def ab_fn(lib, dtype):
    """The timing entry point for dtype (``rt_search_ab``), or None where the
    tree has none."""
    name = "rt_search_ab_" + ("f64" if dtype == torch.float64 else "f32")
    if not hasattr(lib, name):
        return None
    fn = getattr(lib, name)
    P, I64, F64, INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double, ctypes.c_int
    fn.argtypes = [INT, INT, P, P, P, I64, P, P, P, I64, F64, F64, F64, INT, F64] + [P] * 6
    fn.restype = ctypes.c_int
    return fn


def apply_patch(src: Path, patch: Path) -> Path:
    """A copy of the tree ``src`` (a ``src`` folder) under build/search_ab/
    with the unified diff ``patch`` applied (paths a/src/...); every hunk's
    context must match."""
    dest = ROOT / "build" / "search_ab" / patch.stem / "src"
    if dest.parent.exists():
        shutil.rmtree(dest.parent)
    shutil.copytree(src, dest, ignore=shutil.ignore_patterns("build", "__pycache__"))
    target, lines, out, at = None, [], [], 0
    for line in patch.read_text().splitlines(keepends=True) + ["--- end\n"]:
        if line.startswith("--- "):
            if target is not None:
                out += lines[at:]
                target.write_text("".join(out))
            target, out, at = None, [], 0
        elif line.startswith("+++ "):
            target = dest / line[4:].strip().removeprefix("b/").removeprefix("src/")
            lines = target.read_text().splitlines(keepends=True)
        elif line.startswith("@@"):
            start = int(re.match(r"@@ -(\d+)", line).group(1)) - 1
            out += lines[at:start]
            at = start
        elif line[:1] in (" ", "-"):
            if lines[at] != line[1:]:
                raise SystemExit(f"search_ab: {patch} does not apply to {target} at line {at + 1}")
            if line[0] == " ":
                out.append(lines[at])
            at += 1
        elif line[:1] == "+":
            out.append(line[1:])
    return dest


def clock_probe(lib) -> tuple[int, float]:
    """The global timer's step (ns) and the SM clock (MHz) over 200 us."""
    lib.rt_clock_probe.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]
    out = torch.zeros(3, dtype=torch.int64, device="cuda")
    rc = lib.rt_clock_probe(out.data_ptr(), 100_000, 200_000, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if rc:
        raise RuntimeError(f"rt_clock_probe failed with {rc}")
    step, ticks, ns = out.tolist()
    return step, 1e3 * ticks / ns


def split(stamps: np.ndarray, sweeps: int) -> dict:
    """The stages of each sweep on its critical block, from stamps of shape
    [kStampSweeps, kMaxPartials, 2, slots] (clock64, then the global
    timer): the last block to arrive at the barrier among those that
    folded."""
    st = stamps[:sweeps]
    grid = int((st[0, :, 0, 0] != 0).sum())
    clk, gt = st[:, :grid, 0, :].astype(np.float64), st[:, :grid, 1, :].astype(np.float64)
    b0 = clk[:, 0, 0]
    mhz = 1e3 * (b0[-1] - b0[0]) / (gt[-1, 0, 0] - gt[0, 0, 0]) if sweeps > 1 else float("nan")
    ns = 1e3 / mhz
    rows = []
    for k in range(sweeps):
        folded = clk[k, :, 7] != 0
        crit = int(np.argmax(np.where(folded, gt[k, :, 4], -np.inf)))
        d = np.diff(clk[k, crit]) * ns  # the nine stages between the ten points
        period = (b0[k + 1] - b0[k]) * ns if k + 1 < sweeps else float("nan")
        arrive, released = gt[k, :, 4], gt[k, :, 5]
        rows.append(dict(stages=d, period=period, crit=crit, arrive_spread=arrive.max() - arrive.min(),
                         release_after_last=float(np.median(released - arrive.max()))))
    steady = rows[1:] or rows
    med = {s: statistics.median(float(r["stages"][i]) for r in steady) for i, s in enumerate(STAGES)}
    periods = [r["period"] for r in rows[:-1]]
    return dict(grid=grid, mhz=mhz, first=rows[0], steady=med,
                period=statistics.median(periods[1:] or periods) if periods else float("nan"),
                arrive_spread=statistics.median(r["arrive_spread"] for r in steady),
                release_after_last=statistics.median(r["release_after_last"] for r in steady),
                crit=[r["crit"] for r in rows])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src", help="the tree whose repro_torch is timed")
    ap.add_argument("--patch", type=Path, default=None, help="a unified diff to apply to a copy of --src first")
    ap.add_argument("--no-split", action="store_true", help="time only, without the stamped instantiation")
    ap.add_argument("--reps", type=int, default=200, help="graph replays a timing")
    ap.add_argument("--shapes", nargs="*", default=list(SHAPES), choices=list(SHAPES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("search_ab: no CUDA device", file=sys.stderr)
        return 1
    src = apply_patch(args.src.resolve(), args.patch) if args.patch else args.src.resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    from chip_smoke import device_ms, search_state
    import repro_torch
    from repro_torch import kernels as K
    from repro_torch.core.mwu import make_eta
    from repro_torch.kernels import loader
    from repro_torch.kernels.linesearch_probe import ops as lp_ops

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    lib = loader.load()
    plan = getattr(lp_ops, "search_plan", None)
    ab = {dt: ab_fn(lib, dt) for dt in (torch.float64, torch.float32)}
    print(f"  repro_torch from {Path(repro_torch.__file__).parent}; plan: {plan is not None}; timing entry: "
          f"{ab[torch.float64] is not None}", flush=True)
    if ab[torch.float64] is not None:
        step, mhz = clock_probe(lib)
        print(f"  %globaltimer step {step} ns; SM clock {mhz:.1f} MHz over 200 us (one thread)", flush=True)
        layout = (ctypes.c_int * 2)()
        lib.rt_search_stamp_layout(layout)
        k_sweeps, slots, grid_max = layout[0], layout[1], lib.rt_max_partials()
    dev = torch.device("cuda")
    failed = []
    for shape in args.shapes:
        n, m, mask = SHAPES[shape]
        eta = float(make_eta(n + m, EPS))
        for dtype in (torch.float64, torch.float32):
            dt = str(dtype).removeprefix("torch.")
            y, z, dy, dz = search_state(n, "far", 1, dtype, m)
            p_keep = torch.arange(n, device=dev) < mask[1] if mask and mask[0] == "p" else None
            c_keep = torch.arange(m, device=dev) < mask[1] if mask and mask[0] == "c" else None
            pl = plan(n, m, dtype) if plan else None
            path = f"{pl['path']} ({pl['gy']} + {pl['gz']} blocks, at most {pl['tiles']} tiles a block)" if pl else "?"
            print(f"== {shape} [{n}, {m}] {dt}" + (f", {mask[0]}_keep {mask[1]} kept" if mask else "")
                  + f"; path {path}", flush=True)
            dm0 = torch.zeros((), dtype=dtype, device=dev)
            ky = None if p_keep is None else p_keep.view(torch.uint8).data_ptr()
            kz = None if c_keep is None else c_keep.view(torch.uint8).data_ptr()
            for rule in ("newton_search", "binary_search"):
                wrapper = getattr(K, rule)
                ap_, out = torch.ones(1, dtype=torch.float64, device=dev), torch.empty(5, dtype=torch.float64,
                                                                                     device=dev)

                def search(wrapper=wrapper, ap_=ap_, out=out):
                    return wrapper(y, dy, z, dz, eta, EPS, ap_, d_max=dm0, out=out, p_keep=p_keep, c_keep=c_keep)

                rec = search().tolist()
                probes = int(rec[1])
                sweeps = probes + (1 if rule == "newton_search" else 2)
                ms = device_ms(search, args.reps)
                print(f"  {rule:14s} step form: {probes} probes, {sweeps} sweeps; device ms {ms:.4f}, "
                      f"{1e3 * ms / sweeps:.2f} us a sweep", flush=True)
                fn = ab[dtype]
                if fn is None or (args.no_split and plan is None):
                    continue
                if hasattr(lib, "rt_search_scratch_states"):
                    part = loader.scratch(rule + "_ab", y, lib.rt_search_scratch_states(), zeroed=True)
                else:  # the earlier kernel's searches: 8 values a partial (two buffers of 4), not zeroed
                    part = loader.scratch(rule + "_ab", y, 8)
                out2 = torch.empty(5, dtype=torch.float64, device=dev)
                for name, stream_only in (("plan", 0), ("streamed", 1)) if plan else (("plan", 0),):
                    def timed(stamps=None, stream_only=stream_only):
                        rc = fn(int(rule == "binary_search"), stream_only, y.data_ptr(), dy.data_ptr(), ky,
                                n, z.data_ptr(), dz.data_ptr(), kz, m, eta, EPS, 0.0, 0, torch.finfo(dtype).tiny,
                                part.data_ptr(), out2.data_ptr(), dm0.data_ptr(), ap_.data_ptr(),
                                None if stamps is None else stamps.data_ptr(),
                                torch.cuda.current_stream().cuda_stream)
                        if rc:
                            raise RuntimeError(f"rt_search_ab failed with {rc}")

                    if name != "plan":
                        t_ms = device_ms(timed, args.reps)
                        print(f"    {name}: device ms {t_ms:.4f}, {1e3 * t_ms / sweeps:.2f} us a sweep", flush=True)
                    if args.no_split:
                        continue
                    stamps = torch.zeros(k_sweeps * grid_max * 2 * slots, dtype=torch.int64, device=dev)
                    for _ in range(2):  # the second run's stamps, warm
                        stamps.zero_()
                        timed(stamps)
                        torch.cuda.synchronize()
                    same = [struct.pack("d", v) for v in out2.tolist()] == [struct.pack("d", v) for v in rec]
                    if not same:
                        failed.append((shape, dt, rule, name))
                    sp = split(stamps.view(k_sweeps, grid_max, 2, slots).cpu().numpy(), min(sweeps, k_sweeps))
                    print(f"    stamped ({name}): record bit-equal {same}; grid {sp['grid']}; SM clock "
                          f"{sp['mhz']:.1f} MHz; sweep period (block 0) {sp['period']:.0f} ns; arrivals spread "
                          f"{sp['arrive_spread']:.0f} ns; release {sp['release_after_last']:.0f} ns after the last "
                          f"arrival (global timer); critical blocks {sp['crit'][:6]}", flush=True)
                    print("    stage ns (sweep 0 | median of the others): " + "; ".join(
                        f"{s} {sp['first']['stages'][i]:.0f} | {sp['steady'][s]:.0f}" for i, s in enumerate(STAGES))
                        + f"; sum {sum(sp['steady'].values()):.0f}", flush=True)
            pr = torch.empty(6, dtype=dtype, device=dev)
            ms = device_ms(lambda: K.linesearch_probe2(y, dy, z, dz, 7.5, eta, out=pr, p_keep=p_keep, c_keep=c_keep),
                           args.reps)
            print(f"  {'probe':14s} lone two-sided probe at alpha 7.5: device ms {ms:.4f}", flush=True)
            del y, z, dy, dz
            torch.cuda.empty_cache()
    if failed:
        print(f"search_ab: stamped record differs from the wrapper's: {failed}", file=sys.stderr)
        return 1
    print("search_ab: done")
    return 0


if __name__ == "__main__":
    sys.exit(main())

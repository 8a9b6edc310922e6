#!/usr/bin/env python3
"""Time the incidence gather on one GPU, split its time, and time the masked serving chain.

    python3 tools/gather_ab.py [--reps N] [--sweep]

Builds ``tools/gather_ab.cu`` (the gather and the step direction of
commit 6424a8f, before the gather's redesign, three variants that split
the gather's time, and a probe of the lookups' rate) into one library
with the port's kernels of ``src/repro_torch/kernels/csrc`` (one CUDA
runtime in the process: two builds of the kernel library do not work in
one), under ``build/gather_ab/``. Two shapes, f64 and f32:

* ``bmatch``: ``chip_smoke.py``'s phase 2 gather inputs, 98,609,647 edges
  over 497,959 vertices, users ascending (the u side's lookups in order),
  each rating a random one of 17,770 items (the v side's lookups
  scattered over 142 KB at f64);
* ``bucket``: phase 6's bucket, the match operator of tier 1's request 4
  padded onto V1048576xE4194304 (``chip_smoke.serving_scatter_op``: erdos
  edges sorted by u, the v side scattered over the 8 MB of w; 3,000,000
  of 4,194,304 edges kept, the padded ones at (0, 0)).

Each shape times, as ``chip_smoke.py`` times a kernel (one call captured
in a CUDA graph, replayed between CUDA events), in turns (the list, then
the list reversed):

* the gather: the parent's (``parent``), its three split variants
  (``streams``: u and v read, g written, no lookup; ``sorted``: w[u] only;
  ``scattered``: w[v] only), ``l2`` (E hashed lookups of w summed a
  thread, no index stream: the card's rate for 32-byte sectors from the
  L2), ``vec16`` (the first redesign, since replaced: lanes of four
  consecutive edges in 16-byte index loads, one wave, evict-first
  streams), the port's gather (``new``) and, at the bucket, the port's gather
  with the edge mask (``new masked``) against the chain a masked operator
  ran before (the parent's gather, then ``ones``, ``where`` and the
  multiply: ``parent masked chain``). Beside each: the bound (the bytes
  read once and written once over 3.35 TB/s) and the L2 sectors the
  lookups touch (the distinct 32-byte sectors of w that each warp's 32
  lookups of a side fall in, summed over the warps: the traffic from the
  L2 when no lookup hits the L1);
* the step direction: the parent's and the port's, gather and read
  sources, and at the bucket the masked serving chain of a match lane as
  it ran before (the parent's gather, ``ones``, ``where``, the multiply,
  and the parent's read form) against its fused replacement (one
  ``step_direction`` launch, the gather and the edge mask inside), with
  the bound of each (the fused pass: u, v, the mask byte, h and x read, d
  written; w once).

Every gather and step-direction form is held bit for bit to its plain
version (d and max(d)); the tool exits non-zero if one is not. Prints the
card's name and power limit, and the ptxas lines of the gather and step
direction kernels.
"""
from __future__ import annotations

import argparse
import hashlib
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
TOOL_CU = Path(__file__).resolve().parent / "gather_ab.cu"
VARIANTS = {"parent": 0, "streams": 1, "sorted": 2, "scattered": 3, "l2": 4, "vec16": 5}


def sweep_threads(E: int) -> int:
    """Threads of the tool's grid over E edges: csrc/common.cuh's
    sweep_blocks(E, 132 * 16) blocks of 256."""
    return max(1, min(-(-E // 256), 132 * 16)) * 256


def build_library(loader) -> Path:
    """The port's kernel sources and gather_ab.cu, compiled with the port's
    flags (all nvcc processes at once) and linked into one library under
    build/gather_ab/, keyed by a hash of the sources and flags."""
    sources = sorted(loader.CSRC.glob("*.cu")) + [TOOL_CU]
    h = hashlib.sha256(" ".join(loader.NVCC_FLAGS).encode())
    for p in sorted(loader.CSRC.glob("*.cu*")) + [TOOL_CU]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = ROOT / "build" / "gather_ab"
    path = out / f"libgather_ab_{h.hexdigest()[:16]}.so"
    if path.exists():
        return path
    out.mkdir(parents=True, exist_ok=True)
    nvcc = loader._nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out) as tmp:
        procs = [(src, Path(tmp) / (src.stem + ".o")) for src in sources]
        procs = [(src, obj, subprocess.Popen([nvcc, *loader.NVCC_FLAGS, "-I", str(loader.CSRC), "-c", str(src), "-o",
                                              str(obj)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
                 for src, obj in procs]
        log = []
        for src, _, p in procs:
            text, _ = p.communicate()
            log.append(f"== {src.name} (rc {p.returncode})\n{text}")
        if any(p.returncode for _, _, p in procs):
            raise SystemExit("gather_ab: nvcc failed:\n" + "\n".join(log))
        tmp_lib = Path(tmp) / path.name
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp_lib), *(str(obj) for _, obj, _ in procs)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise SystemExit(f"gather_ab: link failed:\n{link.stdout}")
        tmp_lib.replace(path)
    path.with_suffix(".log").write_text("\n".join(log))
    print(f"  built {path.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    entry = None  # ptxas's lines for the gather and step-direction kernels: registers, spills
    for line in path.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else None
        elif entry and any(k in entry for k in ("gather", "direction")) and ("registers" in line or "spill" in line):
            print(f"  {entry[:60]}: {line.split(':', 1)[-1].strip()}", flush=True)
    return path


def lookup_sectors(idx: torch.Tensor, size: int) -> int:
    """Distinct 32-byte sectors of w that each warp's 32 lookups w[idx[e]]
    touch (consecutive edges, one a lane), summed over the warps."""
    s = (idx.long() * size) // 32
    pad = (-s.shape[0]) % 32
    s = torch.cat([s, s[-1:].expand(pad)]).view(-1, 32).sort(dim=1).values
    return int(s.shape[0] + (s[:, 1:] != s[:, :-1]).sum())


def shape_inputs(shape: str, dev):
    """(u, v, n, mask, generator) of ``shape``: bmatch's or the bucket's (module docstring)."""
    from chip_smoke import serving_scatter_op

    if shape == "bmatch":
        n, n_items, E = 497_959, 17_770, 98_609_647
        gen = torch.Generator(device=dev).manual_seed(0)
        u = torch.randint(0, n - n_items, (E,), generator=gen, device=dev, dtype=torch.int32).sort().values
        v = torch.randint(n - n_items, n, (E,), generator=gen, device=dev, dtype=torch.int32)
        return u, v, n, None, gen
    op = serving_scatter_op()
    return op.u, op.v, op.n_vertices, op.edge_mask, torch.Generator(device=dev).manual_seed(0)


def sweep(lib, loader, reps: int) -> int:
    """``--sweep``: the port's gather body (lanes 32 edges apart) at 4, 8 and
    16 edges a thread, the edge streams' hints on and off, one and two
    waves of resident blocks, in turns beside the port's gather, at both
    shapes, f64 and f32; every combination bit for bit the plain version."""
    import ctypes
    import itertools

    from chip_smoke import device_ms
    from repro_torch import kernels as K
    from repro_torch.kernels.incidence_gather.ref import incidence_gather_ref

    fn = lib.rt_gather_ab_sweep
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev, failed = torch.device("cuda"), []
    for shape in ("bmatch", "bucket"):
        u, v, n, _, gen = shape_inputs(shape, dev)
        E = u.shape[0]
        for dtype in (torch.float64, torch.float32):
            w = torch.rand(n, generator=gen, device=dev, dtype=dtype)
            want = incidence_gather_ref(u, v, w)
            fns = {"new": lambda: K.incidence_gather(u, v, w)}
            for slots, hints, waves in itertools.product((4, 8, 16), (0, 1), (1, 2)):
                def run(slots=slots, hints=hints, waves=waves):
                    g = torch.empty(E, dtype=dtype, device=dev)
                    rc = fn(int(dtype == torch.float64), slots, hints, waves, u.data_ptr(), v.data_ptr(),
                            w.data_ptr(), g.data_ptr(), E, loader.stream_handle(w))
                    loader.check_status(rc, "gather_ab sweep")
                    return g
                fns[f"slots {slots} hints {hints} waves {waves}"] = run
            for name, f in fns.items():
                if not torch.equal(f(), want):
                    failed.append((shape, str(dtype), name))
            times = {name: [] for name in fns}
            for order in (list(fns), list(reversed(fns))):
                for name in order:
                    times[name].append(device_ms(fns[name], reps or (20 if shape == "bmatch" else 200)))
            for name, ts in sorted(times.items(), key=lambda kv: min(kv[1])):
                print(f"  sweep {shape} {str(dtype)[6:]} {name:24s} device ms {ts[0]:.4f} / {ts[1]:.4f}", flush=True)
            del w, want, fns
        del u, v
        torch.cuda.empty_cache()
    if failed:
        print(f"gather_ab: not bit-equal: {failed}", file=sys.stderr)
        return 1
    print("gather_ab: every combination bit-equal to the plain version")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=0, help="replays a timing (default: 20 at bmatch, 200 at the bucket)")
    ap.add_argument("--sweep", action="store_true", help="time the gather body's parameters instead (f64 and f32)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gather_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import ctypes

    from chip_smoke import HBM_BYTES_PER_S, device_ms
    from repro_torch import kernels as K
    from repro_torch.core.mwu import make_eta
    from repro_torch.kernels import loader
    from repro_torch.kernels.incidence_gather.ref import incidence_gather_ref
    from repro_torch.kernels.step_direction.ref import step_direction_ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    path = build_library(loader)
    loader.build = lambda: (path, 0.0)  # the port's wrappers bind this library
    lib = loader.load()
    P, I64 = ctypes.c_void_p, ctypes.c_int64
    ab, ab_dir = lib.rt_gather_ab, lib.rt_gather_ab_direction
    ab.argtypes = [ctypes.c_int, ctypes.c_int, P, P, P, I64, P, I64, P]
    ab_dir.argtypes = [ctypes.c_int] + [P] * 6 + [ctypes.c_double, ctypes.c_double, I64, ctypes.c_int] + [P] * 5
    ab.restype = ab_dir.restype = ctypes.c_int
    dev = torch.device("cuda")
    failed = []
    if args.sweep:
        return sweep(lib, loader, args.reps)

    def variant(name, u, v, w):
        """The tool's kernel ``name`` over (u, v, w): a function returning its output."""
        E = u.shape[0]
        out = sweep_threads(E) if name == "l2" else E

        def run():
            g = torch.empty(out, dtype=w.dtype, device=dev)
            rc = ab(VARIANTS[name], int(w.dtype == torch.float64), u.data_ptr(), v.data_ptr(), w.data_ptr(),
                    w.shape[0], g.data_ptr(), E, loader.stream_handle(w))
            loader.check_status(rc, f"gather_ab {name}")
            return g
        return run

    def parent_direction(h, x, scale, g=None, gather=None):
        """The parent's step direction (gather or read source): a function returning (d, dmax)."""
        E = x.shape[0]
        nb = loader.partial_blocks(E)
        part = torch.empty(nb, dtype=x.dtype, device=dev)
        ticket = torch.zeros(1, dtype=torch.int32, device=dev)  # left at 0 by every launch
        u, v, w = gather if gather is not None else (None, None, None)

        def run():
            d, dmax = torch.empty_like(x), torch.empty((), dtype=x.dtype, device=dev)
            rc = ab_dir(int(x.dtype == torch.float64), *(None if t is None else t.data_ptr() for t in (u, v, w, g)),
                        h.data_ptr(), x.data_ptr(), scale, torch.finfo(x.dtype).tiny, E, nb, d.data_ptr(),
                        part.data_ptr(), ticket.data_ptr(), dmax.data_ptr(), loader.stream_handle(x))
            loader.check_status(rc, "gather_ab direction")
            return d, dmax
        return run

    def timed(fns, reps):
        """Device ms of each function, in turns: the list, then the list reversed."""
        times = {name: [] for name in fns}
        for order in (list(fns), list(reversed(fns))):
            for name in order:
                times[name].append(device_ms(fns[name], reps))
        return times

    def bits_equal(a, b):
        return torch.equal(a.reshape(-1).view(torch.int8), b.reshape(-1).view(torch.int8))

    for shape in ("bmatch", "bucket"):
        u, v, n, mask, gen = shape_inputs(shape, dev)
        E = u.shape[0]
        reps = args.reps or (20 if shape == "bmatch" else 200)
        for dtype in (torch.float64, torch.float32):
            size = torch.finfo(dtype).bits // 8
            w = torch.rand(n, generator=gen, device=dev, dtype=dtype)
            sectors = {side: lookup_sectors(idx, size) for side, idx in (("u", u), ("v", v))}
            fns = {name: variant(name, u, v, w) for name in VARIANTS}
            fns["new"] = lambda: K.incidence_gather(u, v, w)
            plain = incidence_gather_ref(u, v, w)
            checks = {"parent": plain, "vec16": plain, "new": plain}
            nbytes = {name: E * (8 + size) + n * size for name in fns}
            nbytes["streams"] = E * (8 + size)
            nbytes["l2"] = n * size
            if mask is not None:
                def chain():
                    g = fns["parent"]()
                    return g * torch.where(mask, torch.ones(E, dtype=dtype, device=dev), 0.0)
                fns["parent masked chain"] = chain
                fns["new masked"] = lambda: K.incidence_gather(u, v, w, mask=mask)
                checks["parent masked chain"] = checks["new masked"] = incidence_gather_ref(u, v, w, mask)
                nbytes["parent masked chain"] = nbytes["new masked"] = E * (9 + size) + n * size
            for name, want in checks.items():
                same = bits_equal(fns[name](), want)
                if not same:
                    failed.append((shape, str(dtype), name))
                print(f"  {shape} {str(dtype)[6:]} {name}: bit-equal to the plain version: {same}", flush=True)
            del plain, checks
            times = timed(fns, reps)
            l2 = {side: k * 32 / 1e6 for side, k in sectors.items()}
            print(f"== {shape} {str(dtype)[6:]} [{E}, {n}]: lookups' sectors u {sectors['u']} ({l2['u']:.1f} MB), "
                  f"v {sectors['v']} ({l2['v']:.1f} MB); streams {E * (8 + size) / 1e6:.1f} MB, w "
                  f"{n * size / 1e6:.1f} MB; {reps} replays a timing, in turns", flush=True)
            for name, ts in times.items():
                b = nbytes[name] / HBM_BYTES_PER_S * 1e3
                extra = f"; {E * 32 / min(ts) / 1e9:.2f} TB/s of 32-byte sectors" if name == "l2" else ""
                print(f"  {shape} {str(dtype)[6:]} {name:20s} device ms {ts[0]:.4f} / {ts[1]:.4f}; bound {b:.4f} "
                      f"(bytes; {b / min(ts):.0%} of it){extra}", flush=True)
            del fns

            # the step direction: the parent's and the new, gather and read sources; at the bucket the masked
            # serving chain as it ran (the parent's gather, ones, where, the multiply, the parent's read form)
            # against the fused pass (one step_direction launch, the gather and the edge mask inside)
            h = torch.rand(E, generator=gen, device=dev, dtype=dtype) * 2.0
            x = torch.rand(E, generator=gen, device=dev, dtype=dtype)
            scale = float(torch.tensor(1.0 / float(make_eta(n + 1, 0.1)), dtype=dtype))
            g = incidence_gather_ref(u, v, w)
            fns = {"direction parent gather": parent_direction(h, x, scale, gather=(u, v, w)),
                   "direction new gather": lambda: K.step_direction(h, x, scale, gather=(u, v, w)),
                   "direction parent read": parent_direction(h, x, scale, g=g),
                   "direction new read": lambda: K.step_direction(h, x, scale, g=g)}
            want = {name: step_direction_ref(h, x, scale, gather=(u, v, w)) for name in fns}
            stream = E * (8 + 3 * size) + n * size
            nbytes = {"direction parent gather": stream, "direction new gather": stream,
                      "direction parent read": 4 * E * size, "direction new read": 4 * E * size}
            if mask is not None:
                before_gather = variant("parent", u, v, w)

                def before():
                    gm = before_gather() * torch.where(mask, torch.ones(E, dtype=dtype, device=dev), 0.0)
                    return parent_direction(h, x, scale, g=gm)()

                fns["masked chain before"] = before
                fns["masked fused"] = lambda: K.step_direction(h, x, scale, gather=(u, v, w, mask, None))
                want["masked chain before"] = want["masked fused"] = step_direction_ref(
                    h, x, scale, gather=(u, v, w, mask, None))
                nbytes["masked fused"] = E * (9 + 3 * size) + n * size
                nbytes["masked chain before"] = (E * (8 + size) + n * size + E * size + E * (1 + 2 * size)
                                                 + 3 * E * size + 4 * E * size)
            for name, fn in fns.items():
                d, dmax = fn()
                same = bits_equal(d, want[name][0]) and bits_equal(dmax, want[name][1])
                if not same:
                    failed.append((shape, str(dtype), name))
                print(f"  {shape} {str(dtype)[6:]} {name}: d and max(d) bit-equal to the plain version: {same}",
                      flush=True)
            del want, d
            times = timed(fns, reps)
            for name, ts in times.items():
                b = nbytes[name] / HBM_BYTES_PER_S * 1e3
                print(f"  {shape} {str(dtype)[6:]} {name:24s} device ms {ts[0]:.4f} / {ts[1]:.4f}; bound {b:.4f} "
                      f"(bytes; {b / min(ts):.0%} of it)", flush=True)
            del fns, w, h, x, g
            torch.cuda.empty_cache()
        del u, v, mask
        torch.cuda.empty_cache()
    if failed:
        print(f"gather_ab: not bit-equal: {failed}", file=sys.stderr)
        return 1
    print("gather_ab: every form bit-equal to its plain version")
    return 0


if __name__ == "__main__":
    sys.exit(main())

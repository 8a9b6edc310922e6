#!/usr/bin/env python3
"""Time design alternatives of the bf16 flash-attention kernel on one GPU.

    python3 tools/flash_ab.py [VARIANT ...]      # default: all variants
    python3 tools/flash_ab.py --check            # only derive the sources (no GPU)

Each variant is the committed ``csrc/flash_attention.cu`` with one design
choice changed by a text substitution (which must apply). Every variant is
built by ``loader.build`` into its own directory under ``kernels/build/ab``
and run in its own process: two builds of the kernel library do not work in
one process. The variants run in two passes, the second in reverse order,
on the flash rows of ``chip_smoke.py`` (bf16) and a long bidirectional d 80
row; each run is checked against the plain version at ``chip_smoke.py``'s
bf16 bars (elementwise and whole-tensor) and timed as ``chip_smoke.py``
times it (one call captured in a CUDA graph). Prints one line per (row,
variant, pass); exits non-zero if a variant fails to build or run, or is
outside a bar on any row. The substitutions are frozen at the source they
were written for: ``--check`` says whether they still apply.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "src/repro_torch/kernels/csrc/flash_attention.cu"

# variant -> [(old, new), ...] applied to the committed source
VARIANTS = {
    "base": [],
    # d 80 as five 16-column boxes with the 32-byte swizzle (no padding)
    "sw32": [("static constexpr int SW = D >= 64 ? 128 : D >= 32 ? 64 : 32;",
              "static constexpr int SW = D % 64 == 0 ? 128 : D % 32 == 0 ? 64 : 32;")],
    # d 80 as three 32-column boxes with the 64-byte swizzle (16 padded columns)
    "sw64": [("static constexpr int SW = D >= 64 ? 128 : D >= 32 ? 64 : 32;",
              "static constexpr int SW = D % 64 == 0 ? 128 : D >= 32 ? 64 : 32;")],
    # the work order: one kv head a section for every mask (head-major) ...
    "order-head": [("const int64_t kv_heads = p.causal || p.window > 0 ? l2_bytes / 2 / kv_head_bytes : 1;",
                    "const int64_t kv_heads = 1;")],
    # ... or the widest section that fits half the L2 for every mask
    "order-wide": [("const int64_t kv_heads = p.causal || p.window > 0 ? l2_bytes / 2 / kv_head_bytes : 1;",
                    "const int64_t kv_heads = l2_bytes / 2 / kv_head_bytes;")],
    # one block a work tile instead of a persistent grid
    "grid-per-tile": [("const int blocks = (int)(n_work < sms ? n_work : sms);", "const int blocks = (int)n_work;")],
    # the consumer warpgroups issue their products without taking turns
    "no-pingpong": [("    named_sync(my_turn, 256);\n", ""),
                    ("  if (cw == NC - 1) named_arrive(their_turn, 256);\n", ""),
                    ("    if (cw != NC - 1 || !last_tile) named_arrive(their_turn, 256);\n", ""),
                    ("    named_arrive(their_turn, 256);\n", "")],
    # edge tiles masked before the scaling, with a raw score that scales to about -1e30 (as first built)
    "mask-raw": [("s_acc[e] = visible(p, row[(e >> 1) & 1], k0 + 8 * (e >> 2) + 2 * tq4 + (e & 1)) ? "
                  "s_acc[e] * scale_log2\n" + " " * 93 + ": kMasked;",
                  "if (!visible(p, row[(e >> 1) & 1], k0 + 8 * (e >> 2) + 2 * tq4 + (e & 1))) "
                  "s_acc[e] = kMasked / scale_log2;"),
                 ("online_softmax(s_acc, m, l, c, open ? scale_log2 : 1.f);",
                  "online_softmax(s_acc, m, l, c, scale_log2);")],
    # three consumer warpgroups (192 query rows) at d <= 80, 160 registers a consumer thread
    "nc3": [("static constexpr int NC = 2;", "static constexpr int NC = D <= 80 ? 3 : 2;"),
            ("CONSUMER_REGS = 240;", "CONSUMER_REGS = NC == 2 ? 240 : 160;")],
}

ROWS = [  # tag, B, S, Hq, Hkv, d, causal, window: chip_smoke.py's bf16 flash rows and a long d 80 row
    ("a", 16, 1500, 16, 16, 80, False, None),
    ("b", 1, 4096, 24, 8, 128, True, None),
    ("c", 1, 6144, 48, 8, 128, True, 4096),
    ("d80-s4096", 4, 4096, 16, 16, 80, False, None),
]


def variant_source(name: str) -> str:
    src = SOURCE.read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) < 1:
            raise ValueError(f"variant {name}: {old!r} not found in {SOURCE.name}")
        src = src.replace(old, new)
    return src


def run_one(name: str, rep: int) -> bool:
    """Build variant ``name`` and time it on ROWS (in this process only);
    whether it is within both bars on every row."""
    import torch

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    from repro_torch import kernels as K
    from repro_torch.kernels import loader
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    csrc = loader.BUILD_DIR / "ab" / name / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    csrc.mkdir(parents=True)
    for f in loader.CSRC.glob("*.cu*"):
        shutil.copy(f, csrc / f.name)
    (csrc / SOURCE.name).write_text(variant_source(name))
    loader.CSRC, loader.BUILD_DIR = csrc, csrc.parent / "build"
    _, build_s = loader.build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    all_ok = True
    for tag, B, S, Hq, Hkv, d, causal, window in ROWS:
        q = torch.randn(B, S, Hq, d, generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn(B, S, Hkv, d, generator=gen, device="cuda").bfloat16() for _ in range(2))
        ref = flash_attention_plain(q, k, v, causal=causal, window=window).float()
        diff = (K.flash_attention(q, k, v, causal=causal, window=window).float() - ref).abs()
        rel = (diff.norm() / ref.norm()).item()
        ok = bool((diff <= 2e-2 * (1 + ref.abs())).all()) and rel <= chip_smoke.FLASH_REL_L2_BAR
        all_ok = all_ok and ok
        ms = chip_smoke.device_ms(lambda: K.flash_attention(q, k, v, causal=causal, window=window), 30)
        tflops = 4 * B * Hq * d * chip_smoke.scored_pairs(S, causal, window) / (ms * 1e-3) / 1e12
        print(f"{tag:10s} {name:14s} pass {rep}: {ms:.4f} ms {tflops:6.1f} TFLOP/s max_abs_err "
              f"{diff.max().item():.3g} relative L2 {rel:.3g} within bars {ok} (build {build_s:.1f} s)", flush=True)
        del q, k, v, ref, diff
        torch.cuda.empty_cache()
    return all_ok


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--one"]:
        return 0 if run_one(args[1], int(args[2])) else 1
    check = args[:1] == ["--check"]
    names = [a for a in args if not a.startswith("--")] or list(VARIANTS)
    for name in names:
        variant_source(name)  # every substitution applies
    if check:
        print(f"{len(names)} variants derive from {SOURCE.name}")
        return 0
    rc = 0
    for rep, order in enumerate((names, names[::-1])):
        for name in order:
            rc |= subprocess.run([sys.executable, __file__, "--one", name, str(rep)], env=os.environ).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())

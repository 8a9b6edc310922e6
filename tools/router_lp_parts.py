#!/usr/bin/env python3
"""Where the f32 routing LP of ``chip_smoke.py`` phase 11 parts card from CPU.

    python3 tools/router_lp_parts.py

Phase 11 (a)'s model (mixtral-8x22b at full width, one layer, seed 0, the
``mwu`` router) takes one train step on phase 11's batch; the routing LP
of its forward (the logits the router saw) is then solved on the card and
on the CPU (the kernels' plain versions) at budgets of 1 to 16
iterations, in f32 and in f64, with the router's ls_eps and with ls_eps
moved by 1e-6 either way (an exact tie in the search's stop rule would
move with it). Prints one JSON line a pair: probes, iterations and the
largest |x difference|. Needs a CUDA device.
"""
from __future__ import annotations

import json
import sys
from dataclasses import replace
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    if not torch.cuda.is_available():
        print("router_lp_parts: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.configs import get, shapes
    from repro_torch.core import solve_lanes
    from repro_torch.data import TokenPipeline
    from repro_torch.models import Model
    from repro_torch.models.layers import moe
    from repro_torch.train import AdamWConfig, make_train_state, make_train_step

    cfg = cs.replace_moe(replace(get("mixtral-8x22b"), n_layers=cs.TRAIN_LAYERS), router="mwu")
    S = shapes.SHAPES["train_4k"].seq_len
    model = Model(cfg, device="cuda", seed=0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in TokenPipeline(cfg.vocab_size, S, 1, seed=0).batch_at(0).items()}
    spans = cs._Spans(moe, ("routing_lp",), keep=("routing_lp",))
    try:
        make_train_step(model, AdamWConfig(**cs.TRAIN_OPT), 1, cs.TRAIN_LOSS_CHUNK)(make_train_state(model), batch)
    finally:
        spans.restore()
    logits = spans.calls["routing_lp"][0][0][0].detach()[0]  # the forward's, group 0
    del model, spans
    torch.cuda.empty_cache()
    _, cap = moe.dispatch_shape(cfg, S)
    base = moe.router_options(cfg.moe.mwu_iters)
    for dtype in (torch.float32, torch.float64):
        probs = torch.softmax(logits.to(dtype), dim=-1)
        for ls in (None, base.ls_tol * (1 + 1e-6), base.ls_tol * (1 - 1e-6)):
            for iters in (1, 2, 3, 4, 6, 16):
                opts = replace(base, max_iter=iters, ls_eps=ls)
                card = solve_lanes([(*moe.routing_ops(probs, cfg.moe.top_k, cap), None, None)], opts).lane(0)
                cpu = solve_lanes([(*moe.routing_ops(probs.cpu(), cfg.moe.top_k, cap), None, None)], opts).lane(0)
                print(json.dumps(dict(dtype=str(dtype).split(".")[-1], ls_eps=opts.ls_tol, budget=iters,
                                      probes=[card.ls_probes, cpu.ls_probes], iters=[card.iters, cpu.iters],
                                      max_abs_dx=float((card.x.cpu() - cpu.x).abs().max()))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

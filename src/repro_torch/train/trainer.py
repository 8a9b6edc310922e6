"""Fault-tolerant training loop.

Port of ``repro.train.trainer``. Invariants that make restarts exact:
  * the data pipeline is stateless-seekable: batch = f(seed, step);
  * checkpoints bundle (params, opt state, step) and commit atomically;
  * on start, the trainer restores the newest valid checkpoint and
    *continues at the exact step*: a restarted run is bit for bit the
    uninterrupted run (tests/test_torch_checkpoint.py on the CPU,
    ``chip_smoke.py`` phase 11 (b) on the card).

Straggler posture: a per-step wall-clock watchdog records slow steps
(``slow_steps``); checkpoints are written asynchronously (one-deep
pipeline), the state copied to host memory before the next step updates
it in place.

One device: ``mesh=`` raises ``NotImplementedError`` (the port has no
``launch/mesh.py`` yet, ROADMAP queue 1 item 15.4).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from ..checkpoint import ckpt as ckpt_lib
from ..data.synthetic import TokenPipeline
from ..models import Model
from .optimizer import AdamWConfig
from .step import TrainState, make_train_state, make_train_step

__all__ = ["TrainerConfig", "Trainer"]


@dataclass
class TrainerConfig:
    steps: int = 100
    seq_len: int = 128
    global_batch: int = 8
    seed: int = 0
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    log_every: int = 10
    microbatches: int = 1
    loss_chunk: int = 512
    straggler_factor: float = 3.0  # step > factor * median => flagged
    opt: AdamWConfig = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=1000)


class Trainer:
    """``Trainer(model_cfg, tc, device="cuda")``: a ``Model`` initialized from
    ``tc.seed`` on ``device``, the token pipeline of ``tc``, and ``run()``."""

    def __init__(self, model_cfg, tc: TrainerConfig, mesh=None, device="cuda"):
        if mesh is not None:
            raise NotImplementedError("Trainer(mesh=...): the port trains on one device; launch/mesh.py is not "
                                      "ported yet (ROADMAP queue 1 item 15.4)")
        self.cfg = model_cfg
        self.tc = tc
        self.device = torch.device(device)
        self.model = Model(model_cfg, device=self.device, seed=tc.seed)
        self.pipe = TokenPipeline(model_cfg.vocab_size, tc.seq_len, tc.global_batch, tc.seed)
        self.step_fn = make_train_step(self.model, tc.opt, tc.microbatches, tc.loss_chunk)
        self.last_metrics = {}
        self.slow_steps: list[int] = []

    def _init_state(self) -> tuple[TrainState, int]:
        state = make_train_state(self.model)
        start = 0
        if self.tc.ckpt_dir:
            restored, step = ckpt_lib.restore_latest(self.tc.ckpt_dir, state)
            if restored is not None:
                state, start = restored, int(step)
        return state, start

    def run(self) -> TrainState:
        state, start = self._init_state()
        times = []
        for it in range(start, self.tc.steps):
            batch = {k: torch.from_numpy(v).to(self.device) for k, v in self.pipe.batch_at(it).items()}
            t0 = time.perf_counter()
            state, metrics = self.step_fn(state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            times.append(dt)
            # straggler watchdog (elastic trigger in pod deployments)
            med = sorted(times)[len(times) // 2]
            if len(times) > 5 and dt > self.tc.straggler_factor * med:
                self.slow_steps.append(it)
            if self.tc.ckpt_dir and (it + 1) % self.tc.ckpt_every == 0:
                ckpt_lib.save_async(self.tc.ckpt_dir, it + 1, state)
            if (it + 1) % self.tc.log_every == 0:
                print(f"step {it+1}: loss={metrics['loss']:.4f} "
                      f"gnorm={metrics['grad_norm']:.3f} {dt*1e3:.0f}ms", flush=True)
            self.last_metrics = metrics
        if self.tc.ckpt_dir:
            ckpt_lib.save_async(self.tc.ckpt_dir, self.tc.steps, state)
            ckpt_lib.wait_pending()
        self.final_state = state
        return state

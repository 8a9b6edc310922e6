"""Deterministic, stateless-seekable synthetic token pipeline.

The port's own copy of ``repro.data.synthetic`` (numpy only): the same
stream, array for array.

``batch_at(seed, step)`` is a pure function -> restarts after failure
reproduce the exact stream (fault-tolerance invariant; DESIGN.md §5).
The generator mixes a per-(step, position) hash into token ids and packs
multiple short "documents" per sequence with EOS separators so the CE
loss has realistic structure (not uniform noise).
"""
from __future__ import annotations

import numpy as np

__all__ = ["TokenPipeline"]


class TokenPipeline:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int, seed: int = 0,
                 mean_doc_len: int = 256, eos_id: int = 0):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = global_batch
        self.seed = seed
        self.mean_doc = mean_doc_len
        self.eos = eos_id

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        B, S = self.batch, self.seq
        # Markov-ish stream: next token depends on previous through a
        # per-batch random linear congruence => learnable structure.
        a = rng.integers(1, self.vocab - 1, size=(B, 1), dtype=np.int64) | 1
        c = rng.integers(0, self.vocab - 1, size=(B, 1), dtype=np.int64)
        noise = rng.integers(0, self.vocab, size=(B, S), dtype=np.int64)
        toks = np.empty((B, S), np.int64)
        toks[:, 0] = noise[:, 0]
        for t in range(1, S):
            det = (a[:, 0] * toks[:, t - 1] + c[:, 0]) % self.vocab
            use_noise = (noise[:, t] % 17) == 0  # ~6% noise
            toks[:, t] = np.where(use_noise, noise[:, t], det)
        # document breaks
        n_docs = max(1, S // self.mean_doc)
        for _ in range(n_docs):
            pos = rng.integers(0, S, size=B)
            toks[np.arange(B), pos] = self.eos
        tokens = toks.astype(np.int32)
        targets = np.roll(tokens, -1, axis=1)
        mask = np.ones((B, S), np.float32)
        mask[:, -1] = 0.0  # no target for the last position
        return {"tokens": tokens, "targets": targets, "loss_mask": mask}

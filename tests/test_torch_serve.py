"""The port's serving engine (``repro_torch.serve``) vs ``repro.serve``, on the CPU.

Both engines get the reference's parameters (``Model.init``; the port's
through ``Engine.load``, i.e. ``load_jax_params``) and the same prompts,
made from seeds with numpy, of unequal lengths: each group of ``slots``
prompts is right-padded with token 0 and run teacher-forced through decode
steps, then sampled.

Greedy tokens are compared step by step. Where a reference step's top-1 /
top-2 margin is under the logits bar (1e-5 of the logits' scale, the f32
bar of tests/test_torch_decode.py), the argmax is decided by rounding: the
test prints that step and compares that request no further. With a
temperature the streams differ (``jax.random`` against a
``torch.Generator``), so the draws are held to their distribution.
"""
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.models import Model as RefModel
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import ServeConfig as RefServeConfig
from repro_torch.configs import get
from repro_torch.models import Model
from repro_torch.serve import Engine, ServeConfig

LOGITS_BAR = 1e-5
MAX_NEW = 8
LENGTHS = (5, 11, 8)  # three prompts of unequal length: two groups of slots 2


def _prompts(cfg, seed: int = 3) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, n).astype(np.int32) for n in LENGTHS]


def _engines(arch: str, sc: dict):
    """(reference engine, port engine) of the reduced config, loaded with
    the same parameters."""
    rcfg, cfg = ref_get(arch).reduced(), get(arch).reduced()
    params = RefModel(rcfg, fsdp=False).init(jax.random.PRNGKey(1))
    ref = RefEngine(rcfg, RefServeConfig(**sc))
    ref.load(params)
    eng = Engine(cfg, ServeConfig(**sc), device="cpu")
    eng.load(jax.tree.map(np.asarray, params))
    return ref, eng


@pytest.mark.parametrize("arch", ["yi-34b", "mixtral-8x22b", "recurrentgemma-9b", "mamba2-1.3b", "internvl2-26b"])
def test_greedy_generate_matches_reference(arch):
    """Three prompts of unequal length in slots of 2 (two groups), 8 new
    tokens each, greedy: the port's tokens are the reference's up to the
    first step whose margin is under the bar."""
    ref, eng = _engines(arch, dict(max_len=32, slots=2))
    seen = []  # the logits of each reference sampling step: (group, step) in order
    sample = ref._sample

    def recording(logits):
        seen.append(np.asarray(logits)[:, -1, : ref.cfg.vocab_size])
        return sample(logits)

    ref._sample = recording
    prompts = _prompts(eng.cfg)
    want = ref.generate(prompts, max_new=MAX_NEW)
    got = eng.generate(prompts, max_new=MAX_NEW)
    assert [len(g) for g in got] == [MAX_NEW] * len(prompts)
    compared = 0
    for r in range(len(prompts)):
        group, slot = divmod(r, 2)
        for step in range(MAX_NEW):
            lg = seen[group * MAX_NEW + step][slot]
            top = np.sort(lg)[::-1]
            if top[0] - top[1] < LOGITS_BAR * np.abs(lg).max():
                print(f"{arch} request {r} step {step}: the reference's top-1/top-2 margin {top[0] - top[1]:.3g} "
                      f"is under the logits bar; not compared from here on")
                break
            assert got[r][step] == want[r][step] == int(np.argmax(lg)), (arch, r, step)
            compared += 1
    assert compared >= len(prompts) * MAX_NEW // 2


def test_engine_equals_hand_decode_loop():
    """The engine's tokens equal a loop of decode_step + argmax over the
    same model, its prompts right-padded with 0 as the engine pads them."""
    cfg = get("mixtral-8x22b-mwu").reduced()
    eng = Engine(cfg, ServeConfig(max_len=32, slots=4), device="cpu")
    eng.load(Model(cfg, device="cpu", seed=2))
    prompts = _prompts(cfg, seed=4)
    got = eng.generate(prompts, max_new=MAX_NEW)
    toks = np.zeros((len(prompts), max(LENGTHS)), np.int32)
    for i, p in enumerate(prompts):
        toks[i, : len(p)] = p
    want = []
    with torch.inference_mode():
        caches = eng.model.init_caches(len(prompts), 32)
        for t in range(toks.shape[1]):
            lg, caches = eng.model.decode_step(caches, torch.tensor(toks[:, t: t + 1]))
        for _ in range(MAX_NEW):
            cur = torch.argmax(lg[:, -1, : cfg.vocab_size], dim=-1)
            want.append(cur.tolist())
            lg, caches = eng.model.decode_step(caches, cur[:, None])
    assert got == [list(c) for c in zip(*want)]


def test_temperature_draws():
    """Seeded draws repeat, stay below vocab_size (the pad-vocab slots are
    never drawn, however large their logits), and follow softmax(logits / T)
    over 20,000 draws from fixed logits."""
    cfg = replace(get("yi-34b").reduced(), vocab_size=250)  # padded to 256
    T, n = 0.7, 20_000
    lg = torch.tensor(np.random.default_rng(5).standard_normal(cfg.padded_vocab), dtype=torch.float32) * 2
    lg[cfg.vocab_size:] = 50.0
    logits = lg.expand(n, 1, -1)
    a, b = (Engine(cfg, ServeConfig(temperature=T, seed=7), device="cpu") for _ in range(2))
    draws = a._sample(logits)
    assert torch.equal(draws, b._sample(logits))
    assert not torch.equal(draws, a._sample(logits))  # the generator moves on
    assert int(draws.max()) < cfg.vocab_size and draws.shape == (n,)
    p = torch.softmax(lg[: cfg.vocab_size].double() / T, dim=0).numpy()
    freq = np.bincount(draws.numpy(), minlength=cfg.vocab_size) / n
    # 5 standard deviations of each frequency, plus a floor for the rarest tokens
    assert np.all(np.abs(freq - p) <= 5 * np.sqrt(p * (1 - p) / n) + 1e-4), np.abs(freq - p).max()


def test_temperature_generate_repeats():
    """generate with a temperature: the same seed gives the same tokens."""
    cfg = get("recurrentgemma-9b").reduced()
    model = Model(cfg, device="cpu", seed=3)
    outs = []
    for _ in range(2):
        eng = Engine(cfg, ServeConfig(max_len=32, slots=2, temperature=1.0, seed=11), device="cpu")
        eng.load(model)
        outs.append(eng.generate(_prompts(cfg), max_new=MAX_NEW))
    assert outs[0] == outs[1]
    assert all(0 <= t < cfg.vocab_size for out in outs[0] for t in out)


def test_engine_load_and_generate_checks():
    cfg = get("yi-34b").reduced()
    eng = Engine(cfg, ServeConfig(max_len=8), device="cpu")
    with pytest.raises(RuntimeError, match="before load"):
        eng.generate([np.arange(3)])
    with pytest.raises(ValueError, match="does not fit"):
        eng.load(Model(get("minitron-4b").reduced(), device="cpu"))
    eng.load(Model(cfg, device="cpu"))
    with pytest.raises(ValueError, match="max_new"):
        eng.generate([np.arange(3)], max_new=0)
    with pytest.raises(ValueError, match="overflow"):  # 6 prompt steps + 3 new > max_len 8, no window
        eng.generate([np.arange(1, 7)], max_new=4)

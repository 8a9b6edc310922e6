"""The port's KV cache, prefill and decode vs ``repro.models``, on the CPU.

The reference's parameters (``Model.init``) are carried across with
``load_jax_params``; tokens are made from seeds with numpy. Bars: decode
and prefill against the reference's at 1e-5 (f32, the two differ in the
order of their sums; tests/test_torch_models.py's bar), decode against the
port's own forward at tests/test_layers.py:33-73's bars (2e-3 for the dense
arch, 5e-3 for the others). MoE configs run at ``capacity_factor = E`` so
that no token is dropped where a decode step routes B tokens and the
forward all of them (tests/test_layers.py:58-61).

The ``mwu`` router's LP in f32 is decided by rounding beyond its first
few iterations (tests/test_torch_moe.py's docstring), so a decode step of
mixtral-8x22b-mwu is held as the layer is there: each step's routing LP in
f64 against the reference's, and the step's logits against the
reference's decode handed the port's routes through a host callback.

A decode step's LP is small (B tokens x E experts), and the search's
completion refinement at the router's ls_eps 1/4 often ends on an exact
tie of its stop rule ``h - lo <= ls_eps * h`` (after an accept and two
rejects: h = hi/2, lo = 3 hi/8), which an ulp of the Newton step decides
(ROADMAP queue 3, "Refinement bisection tie"); the two packages then take
one probe more or fewer and stop at another alpha. Such an LP is held to
the reference at ls_eps nudged by 1e-12 either way, which breaks the tie
one way or the other and moves nothing else beyond rounding; the test
prints each tie and fails if ties are more than a quarter of the LPs.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.models import Model as RefModel
from repro.models.layers import attention as ref_att
from repro.models.layers import moe as ref_moe
from repro_torch.configs import get
from repro_torch.core import solve_lanes
from repro_torch.models import DecodeCaches, Model, load_jax_params
from repro_torch.models.layers import attention, moe
from test_torch_moe import LAYER_TOL, X_TOL_F64, _ref_lp

TOL = 1e-5
TIE_NUDGE = 1e-12  # relative nudge of ls_eps that breaks the refinement's exact tie
B, STEPS = 2, 12
PROMPT = 40  # past the reduced window 16 and attn_chunk 16
DECODE_ARCHS = ["yi-34b", "mixtral-8x22b", "recurrentgemma-9b", "mamba2-1.3b"]
FORWARD_BAR = {"yi-34b": 2e-3, "mixtral-8x22b": 5e-3, "recurrentgemma-9b": 5e-3, "mamba2-1.3b": 5e-3,
               "internvl2-26b": 2e-3}  # tests/test_layers.py:33-73 (internvl2: the dense bar)


def _no_drop(cfg):
    if cfg.moe is None:
        return cfg
    return replace(cfg, moe=replace(cfg.moe, capacity_factor=float(cfg.moe.n_experts)))


def _setup(arch: str, impl: str = "pallas", seed: int = 1):
    """(reference model, its params, port model) at the reduced config."""
    rcfg = replace(_no_drop(ref_get(arch).reduced()), attn_impl=impl)
    cfg = replace(_no_drop(get(arch).reduced()), attn_impl=impl)
    ref = RefModel(rcfg, fsdp=False)
    params = ref.init(jax.random.PRNGKey(seed))
    return ref, params, load_jax_params(Model(cfg, device="cpu"), jax.tree.map(np.asarray, params))


def _tokens(cfg, S: int, seed: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _close(got: torch.Tensor, ref, tol=TOL, what=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol, rtol=tol, err_msg=what)


def _ref_layer_caches(ref: RefModel, caches) -> list:
    """The reference's DecodeCaches in the port's layer order (repetition r
    of pattern position j is layer r * k + j, then the tail)."""
    k = len(ref.pattern_unit)
    out = [None] * (ref.reps * k)
    for j, stacked in enumerate(caches.scanned):
        for r in range(ref.reps):
            out[r * k + j] = jax.tree.map(lambda a: a[r], stacked)
    return out + list(caches.tail)


def _close_caches(got: DecodeCaches, ref_model: RefModel, ref_caches, tol=TOL):
    assert got.pos == int(ref_caches.pos)
    for i, (c, rc) in enumerate(zip(got.layers, _ref_layer_caches(ref_model, ref_caches))):
        assert type(c).__name__ == type(rc).__name__
        for name in c._fields:
            a, want = getattr(c, name), np.asarray(getattr(rc, name))
            if a.dtype in (torch.int32, torch.int64):
                np.testing.assert_array_equal(a.numpy(), want, err_msg=f"layer {i} {name}")
            else:
                _close(a, want, tol, what=f"layer {i} {name}")


# ----------------------------------------------------------------------
# the cache
# ----------------------------------------------------------------------


@pytest.mark.parametrize("arch,max_len", [("yi-34b", 24), ("mixtral-8x22b", 24), ("mixtral-8x22b", 8)])
def test_init_kv_cache_matches_reference(arch, max_len):
    """max_len slots, min(max_len, window) for a window; every slot empty (-1)."""
    rcfg, cfg = ref_get(arch).reduced(), get(arch).reduced()
    ref = ref_att.init_kv_cache(rcfg, 3, max_len, jnp.float32)
    got = attention.init_kv_cache(cfg, 3, max_len, torch.float32, "cpu")
    for name in ("k", "v", "slot_pos"):
        a, want = getattr(got, name), np.asarray(getattr(ref, name))
        assert tuple(a.shape) == want.shape and str(a.dtype).split(".")[-1] == str(want.dtype), name
        np.testing.assert_array_equal(a.numpy(), want)
    assert got.k.shape[1] == (min(max_len, 16) if cfg.sliding_window else max_len)


def test_prefill_past_window_writes_last_positions():
    """S 40 into a ring of 16: slot_pos is the reference's [32..39, 24..31]
    (its scatter's last write wins), and K, V are the reference's."""
    ref, params, model = _setup("mixtral-8x22b")
    toks = _tokens(model.cfg, PROMPT)
    _, ref_caches = ref.prefill(params, {"tokens": jnp.asarray(toks)}, 64)
    with torch.inference_mode():
        _, caches = model.prefill({"tokens": torch.tensor(toks)}, 64)
    want = np.r_[np.arange(32, 40), np.arange(24, 32)]
    for c, rc in zip(caches.layers, _ref_layer_caches(ref, ref_caches)):
        np.testing.assert_array_equal(np.asarray(rc.slot_pos), want)
        np.testing.assert_array_equal(c.slot_pos.numpy(), want)
    _close_caches(caches, ref, ref_caches)


def test_cache_overflow_raises():
    """A cache without a window holds max_len positions; the reference's
    .at[].set drops a write past them silently, the port raises."""
    _, _, model = _setup("yi-34b")
    toks = torch.tensor(_tokens(model.cfg, 5))
    with torch.inference_mode():
        caches = model.init_caches(B, 4)
        for t in range(4):
            _, caches = model.decode_step(caches, toks[:, t:t + 1])
        with pytest.raises(ValueError, match="overflow"):
            model.decode_step(caches, toks[:, 4:5])
        with pytest.raises(ValueError, match="overflow"):
            model.prefill({"tokens": toks}, 4)


def test_ring_below_window_overflow_raises():
    """A ring of max_len 8 slots under a window of 16 holds positions
    0..7; the reference wraps past them silently and evicts keys still
    inside the window, the port raises (a whole window's ring wraps)."""
    _, _, model = _setup("mixtral-8x22b")
    toks = torch.tensor(_tokens(model.cfg, 17))
    with torch.inference_mode():
        caches = model.init_caches(B, 8)
        assert caches.layers[0].k.shape[1] == 8 < model.cfg.sliding_window
        for t in range(8):
            _, caches = model.decode_step(caches, toks[:, t:t + 1])
        with pytest.raises(ValueError, match="below the window"):
            model.decode_step(caches, toks[:, 8:9])
        with pytest.raises(ValueError, match="below the window"):
            model.prefill({"tokens": toks[:, :9]}, 8)
        _, caches = model.prefill({"tokens": toks}, 16)  # a whole window's ring: 17 > 16 slots wraps
        assert sorted(caches.layers[0].slot_pos.tolist()) == list(range(1, 17))


def test_attention_cache_takes_start_only():
    """With a cache the positions come from start: passing positions too,
    or no start, raises."""
    _, _, model = _setup("yi-34b")
    blk, cfg = model.blocks[0], model.cfg
    x = torch.zeros(B, 1, cfg.d_model)
    cache = attention.init_kv_cache(cfg, B, 4, torch.float32, "cpu")
    with pytest.raises(ValueError, match="no positions"):
        attention.attention_apply(blk.attn, x, cfg, positions=torch.zeros(1, dtype=torch.int32), cache=cache,
                                  start=0)
    with pytest.raises(ValueError, match="no positions"):
        attention.attention_apply(blk.attn, x, cfg, cache=cache)


def test_decode_leaves_caches_unchanged():
    """A step returns new caches: the same step from the same caches gives
    the same logits bit for bit, and the caches it was given are as they were."""
    _, _, model = _setup("recurrentgemma-9b")
    toks = torch.tensor(_tokens(model.cfg, PROMPT + 1))
    with torch.inference_mode():
        _, caches = model.prefill({"tokens": toks[:, :PROMPT]}, 64)
        before = [[t.clone() for t in c] for c in caches.layers]
        a, ca = model.decode_step(caches, toks[:, PROMPT:])
        b, _ = model.decode_step(caches, toks[:, PROMPT:])
    assert torch.equal(a, b) and ca.pos == caches.pos + 1 == PROMPT + 1
    for c, saved in zip(caches.layers, before):
        assert all(torch.equal(t, s) for t, s in zip(c, saved))


# ----------------------------------------------------------------------
# decode and prefill against the reference
# ----------------------------------------------------------------------


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_matches_reference_decode(arch):
    """12 decode steps from empty caches (16 positions: a full ring of the
    window 16), each step's logits and the final caches at 1e-5."""
    ref, params, model = _setup(arch)
    toks = _tokens(model.cfg, STEPS)
    ref_step = jax.jit(ref.decode_step)
    ref_caches = ref.init_caches(B, 16)
    with torch.inference_mode():
        caches = model.init_caches(B, 16)
        for t in range(STEPS):
            want, ref_caches = ref_step(params, ref_caches, jnp.asarray(toks[:, t:t + 1]))
            got, caches = model.decode_step(caches, torch.tensor(toks[:, t:t + 1]))
            assert got.shape == (B, 1, model.cfg.padded_vocab)
            _close(got, want, what=f"step {t}")
    _close_caches(caches, ref, ref_caches)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_matches_forward(arch):
    """tests/test_layers.py's identity for the port: decode position by
    position equals the port's own parallel forward."""
    _, _, model = _setup(arch)
    toks = torch.tensor(_tokens(model.cfg, STEPS))
    with torch.inference_mode():
        full = model.logits(model({"tokens": toks}))
        caches = model.init_caches(B, 16)
        outs = []
        for t in range(STEPS):
            lg, caches = model.decode_step(caches, toks[:, t:t + 1])
            outs.append(lg)
    bar = FORWARD_BAR[arch]
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), full.numpy(), atol=bar, rtol=bar)


@pytest.mark.parametrize("impl", ["pallas", "chunked"])
@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_prefill_matches_reference(arch, impl):
    """A prompt of 40 tokens (past the window 16 and attn_chunk 16): the last
    logits and every layer's cache at 1e-5 against the reference's prefill
    (which attends with its chunked path); then two decode steps."""
    ref, params, model = _setup(arch, impl)
    toks = _tokens(model.cfg, PROMPT + 2)
    want, ref_caches = ref.prefill(params, {"tokens": jnp.asarray(toks[:, :PROMPT])}, 64)
    with torch.inference_mode():
        got, caches = model.prefill({"tokens": torch.tensor(toks[:, :PROMPT])}, 64)
        assert got.shape == (B, 1, model.cfg.padded_vocab)
        _close(got, want)
        _close_caches(caches, ref, ref_caches)
        ref_step = jax.jit(ref.decode_step)
        for t in range(PROMPT, PROMPT + 2):
            want, ref_caches = ref_step(params, ref_caches, jnp.asarray(toks[:, t:t + 1]))
            got, caches = model.decode_step(caches, torch.tensor(toks[:, t:t + 1]))
            _close(got, want, what=f"step {t}")


def test_prefill_then_decode_matches_forward_past_window():
    """The identity chip_smoke.py phase 10 (a) checks at full width: prefill
    past the window, then decode steps; the last step's logits equal the
    last row of a forward over all the tokens (relative L2 1e-3)."""
    _, _, model = _setup("mixtral-8x22b")
    toks = torch.tensor(_tokens(model.cfg, PROMPT + 4))
    with torch.inference_mode():
        _, caches = model.prefill({"tokens": toks[:, :PROMPT]}, 64)
        slots = caches.layers[0].slot_pos.clone()
        for t in range(PROMPT, PROMPT + 4):
            lg, caches = model.decode_step(caches, toks[:, t:t + 1])
        full = model.logits(model({"tokens": toks})[:, -1:])
    assert sorted(slots.tolist()) == list(range(PROMPT - 16, PROMPT))
    assert sorted(caches.layers[0].slot_pos.tolist()) == list(range(PROMPT + 4 - 16, PROMPT + 4))
    assert float((lg - full).norm() / full.norm()) <= 1e-3


def _vlm_prompt(cfg, n_text: int, seed: int = 6):
    """internvl2's prompt: n_vision_patches patches (N(0, 0.02^2), as configs/shapes.py makes them) and
    n_text tokens."""
    rng = np.random.default_rng(seed)
    return {"patches": (rng.standard_normal((B, cfg.n_vision_patches, cfg.d_model)) * 0.02).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (B, n_text)).astype(np.int32)}


def test_vision_text_prefill_and_decode_match_reference():
    """internvl2: a prefill of 8 patches and 32 tokens (past attn_chunk 16),
    then three text-only decode steps, against the reference's prefill and
    decode_step: the logits and every layer's cache at 1e-5."""
    ref, params, model = _setup("internvl2-26b")
    cfg = model.cfg
    prompt = _vlm_prompt(cfg, PROMPT - cfg.n_vision_patches)
    more = _tokens(cfg, 3, seed=7)
    want, ref_caches = ref.prefill(params, {k: jnp.asarray(v) for k, v in prompt.items()}, 64)
    ref_step = jax.jit(ref.decode_step)
    with torch.inference_mode():
        got, caches = model.prefill({k: torch.tensor(v) for k, v in prompt.items()}, 64)
        assert got.shape == (B, 1, cfg.padded_vocab) and caches.pos == PROMPT
        _close(got, want)
        _close_caches(caches, ref, ref_caches)
        for t in range(3):
            want, ref_caches = ref_step(params, ref_caches, jnp.asarray(more[:, t:t + 1]))
            got, caches = model.decode_step(caches, torch.tensor(more[:, t:t + 1]))
            _close(got, want, what=f"step {t}")
    _close_caches(caches, ref, ref_caches)


def test_vision_text_decode_matches_forward():
    """internvl2: prefill with patches, then text-only decode steps; each
    step's logits against the port's forward over the patches and all the
    tokens (the dense bar)."""
    _, _, model = _setup("internvl2-26b")
    cfg = model.cfg
    prompt = {k: torch.tensor(v) for k, v in _vlm_prompt(cfg, 4).items()}
    more = torch.tensor(_tokens(cfg, STEPS, seed=8))
    with torch.inference_mode():
        full = model.logits(model({"patches": prompt["patches"], "tokens": torch.cat([prompt["tokens"], more], 1)}))
        lg, caches = model.prefill(prompt, 32)
        outs = [lg]
        for t in range(STEPS - 1):
            lg, caches = model.decode_step(caches, more[:, t:t + 1])
            outs.append(lg)
    n = cfg.n_vision_patches + 4
    bar = FORWARD_BAR["internvl2-26b"]
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), full[:, n - 1:n + STEPS - 1].numpy(), atol=bar,
                               rtol=bar)


def test_ssm_decode_leaves_caches_unchanged():
    """mamba2: a step returns new states (conv window in the compute dtype,
    f32 SSM state) and leaves the given ones as they were."""
    _, _, model = _setup("mamba2-1.3b")
    toks = torch.tensor(_tokens(model.cfg, PROMPT + 1))
    with torch.inference_mode():
        _, caches = model.prefill({"tokens": toks[:, :PROMPT]}, 64)
        before = [[t.clone() for t in c] for c in caches.layers]
        a, ca = model.decode_step(caches, toks[:, PROMPT:])
        b, _ = model.decode_step(caches, toks[:, PROMPT:])
    assert torch.equal(a, b) and ca.pos == PROMPT + 1
    for c, new, saved in zip(caches.layers, ca.layers, before):
        assert type(c).__name__ == "SSMState" and int(new.pos) == PROMPT + 1
        assert all(torch.equal(t, s) for t, s in zip(c, saved))
        assert c.ssm.dtype == torch.float32 and c.conv.dtype == model.dt.compute


# ----------------------------------------------------------------------
# decode through the MWU LP router
# ----------------------------------------------------------------------


def _port_lp(probs: np.ndarray, k: int, cap: int, iters: int, nudge: float = 0.0):
    opts = moe.router_options(iters)
    opts = replace(opts, ls_eps=opts.eps * (1.0 + nudge))
    return solve_lanes([(*moe.routing_ops(torch.tensor(probs), k, cap), None, None)], opts).lane(0)


def _lp_agrees(got, want) -> bool:
    same = (got.iters, got.ls_probes, got.status) == (int(want.iters), int(want.ls_probes), int(want.status))
    return same and np.abs(got.x.numpy() - np.asarray(want.x)).max() <= X_TOL_F64


def _check_lp(probs: np.ndarray, k: int, cap: int, iters: int, what: str) -> bool:
    """The port's LP against the reference's in f64; True if they agree at
    the router's ls_eps, False if only at ls_eps nudged (the recorded tie)."""
    want = _ref_lp(probs, k, cap, iters)
    if _lp_agrees(_port_lp(probs, k, cap, iters), want):
        return True
    nudged = [n for n in (-TIE_NUDGE, TIE_NUDGE) if _lp_agrees(_port_lp(probs, k, cap, iters, n), want)]
    got = _port_lp(probs, k, cap, iters)
    assert nudged, (f"{what}: the routing LP differs from the reference's at every ls_eps: port "
                    f"{(got.iters, got.ls_probes, got.status)}, reference "
                    f"{(int(want.iters), int(want.ls_probes), int(want.status))}")
    print(f"{what}: the refinement's stop rule ties (ROADMAP queue 3): the reference takes "
          f"{int(want.ls_probes)} probes, the port {got.ls_probes}; equal at ls_eps * (1 {nudged[0]:+g})")
    return False


def test_mwu_decode_matches_reference_given_routes(monkeypatch):
    """mixtral-8x22b-mwu: a decode step routes B 2 tokens a layer through
    one routing LP (one lane). At each of 12 steps: every layer's LP in f64
    against the reference's (x within 1e-9, the same iterations, probes and
    status; at a tie of the refinement, at ls_eps nudged: module docstring),
    and the step's logits against the reference's decode step given the
    port's routes (a host callback), at the layer bar 2e-4."""
    ref, params, model = _setup("mixtral-8x22b-mwu")
    cfg, m = model.cfg, model.cfg.moe
    toks = _tokens(cfg, STEPS)
    seen = []  # one entry a layer call, in order
    route = moe.mwu_route

    def recording(logits, k, capacity, mwu_iters=16):
        idx, gate = route(logits, k, capacity, mwu_iters)
        seen.append(dict(logits=logits.numpy().copy(), k=k, capacity=capacity, iters=mwu_iters, idx=idx.numpy(),
                         gate=gate.numpy()))
        return idx, gate

    given_routes = []

    def port_routes(lg):
        want = given_routes.pop(0)
        np.testing.assert_allclose(lg, want["logits"], atol=1e-5)
        return want["idx"].astype(np.int32), want["gate"]

    def given(lg, k, capacity, mwu_iters=16):
        shapes = (jax.ShapeDtypeStruct(lg.shape[:-1] + (k,), jnp.int32),
                  jax.ShapeDtypeStruct(lg.shape[:-1] + (k,), jnp.float32))
        return jax.pure_callback(port_routes, shapes, lg, vmap_method="expand_dims")

    monkeypatch.setattr(moe, "mwu_route", recording)
    monkeypatch.setattr(ref_moe, "mwu_route", given)
    ref_step = jax.jit(ref.decode_step)
    ref_caches = ref.init_caches(B, 16)
    agreed = []
    with torch.inference_mode():
        caches = model.init_caches(B, 16)
        for t in range(STEPS):
            seen.clear()
            got, caches = model.decode_step(caches, torch.tensor(toks[:, t:t + 1]))
            assert len(seen) == cfg.n_layers
            for layer, rec in enumerate(seen):  # one token group of B tokens a layer: a (1, B, E) LP
                assert rec["logits"].shape == (1, B, m.n_experts)
                assert (rec["k"], rec["capacity"], rec["iters"]) == (m.top_k, moe.dispatch_shape(cfg, B)[1],
                                                                     m.mwu_iters)
                probs = np.asarray(jax.nn.softmax(jnp.asarray(rec["logits"][0], jnp.float64), axis=-1))
                agreed.append(_check_lp(probs, rec["k"], rec["capacity"], rec["iters"], f"step {t} layer {layer}"))
            given_routes.extend(seen)
            want, ref_caches = ref_step(params, ref_caches, jnp.asarray(toks[:, t:t + 1]))
            assert not given_routes  # the reference asked for every layer's routes
            _close(got, want, tol=LAYER_TOL, what=f"step {t}")
    assert len(agreed) == STEPS * cfg.n_layers and 4 * agreed.count(False) <= len(agreed), agreed

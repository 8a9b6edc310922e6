"""The port's RG-LRU block vs the reference's, on the CPU at f32.

The same numpy inputs and the reference's parameters (``rglru_init`` of
``repro.models.layers.rglru``, carried across as numpy arrays) go through
the JAX module and ``repro_torch.models.layers.rglru``. Bar: 1e-5 abs and
rel unless a test says otherwise; both sides compute in f32 and differ in
the order of their sums and, in the scan, of their products (the
reference's ``associative_scan`` combines the elements in another tree
than the port's doubling steps).
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.models.layers import rglru as ref_rg
from repro_torch.configs import get
from repro_torch.models.layers import rglru as rg

TOL = 1e-5


def _cfgs(rnn_width=None):
    rcfg, cfg = ref_get("recurrentgemma-9b").reduced(), get("recurrentgemma-9b").reduced()
    if rnn_width is not None:
        rcfg, cfg = replace(rcfg, rnn_width=rnn_width), replace(cfg, rnn_width=rnn_width)
    return rcfg, cfg


def _params(rcfg, seed=0):
    """The reference's parameters as numpy, with a nonzero conv bias."""
    p = jax.tree.map(np.asarray, ref_rg.rglru_init(jax.random.PRNGKey(seed), rcfg, jnp.float32))
    p["conv_b"] = (np.random.default_rng(seed).standard_normal(p["conv_b"].shape) * 0.1).astype(np.float32)
    return p


def _j(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _t(p):
    return {k: torch.tensor(v) for k, v in p.items()}


def _close(got, ref, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol, rtol=tol)


def _x(shape, seed=1, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_init_shapes_and_dtypes(dtype):
    """The reference's groups, shapes and dtypes; wa, wi and lam stay f32 whatever the param dtype."""
    rcfg, cfg = _cfgs()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = ref_rg.rglru_init(jax.random.PRNGKey(0), rcfg, jdt)
    got = rg.rglru_init(torch.Generator().manual_seed(0), cfg, dtype, "cpu")
    assert set(got) == set(ref)
    for name, r in ref.items():
        assert tuple(got[name].shape) == r.shape, name
        assert str(got[name].dtype).removeprefix("torch.") == str(r.dtype), name
    np.testing.assert_allclose(got["lam"].numpy(), np.asarray(ref["lam"]), rtol=1e-7)
    assert not got["conv_b"].any()


def test_rglru_state_init():
    rcfg, cfg = _cfgs()
    ref = ref_rg.init_rglru_state(rcfg, 3)
    got = rg.init_rglru_state(cfg, 3, device="cpu")
    for name in ("conv", "h", "pos"):
        r, g = getattr(ref, name), getattr(got, name)
        assert tuple(g.shape) == r.shape and str(g.dtype).removeprefix("torch.") == str(r.dtype), name
        assert not g.any()


def test_gates():
    rcfg, _ = _cfgs()
    p = _params(rcfg)
    xi = _x((2, 9, rcfg.rnn_width), scale=2.0)
    ra, rb = ref_rg._gates(_j(p), jnp.asarray(xi))
    ga, gb = rg._gates(_t(p), torch.tensor(xi))
    assert ga.dtype == gb.dtype == torch.float32
    _close(ga, ra)
    _close(gb, rb)


@pytest.mark.parametrize("window", [False, True], ids=["zeros", "carried"])
def test_conv(window):
    rcfg, _ = _cfgs()
    p = _params(rcfg)
    x = _x((2, 7, rcfg.rnn_width))
    win = _x((2, 3, rcfg.rnn_width), seed=2) if window else None
    ref, ref_win = ref_rg._conv(_j(p), jnp.asarray(x), None if win is None else jnp.asarray(win))
    got, got_win = rg._conv(_t(p), torch.tensor(x), None if win is None else torch.tensor(win))
    _close(got, ref)
    np.testing.assert_array_equal(got_win.numpy(), np.asarray(ref_win))


@pytest.mark.parametrize("S", [1, 2, 3, 17, 64, 1000])
def test_scan_matches_sequential_recurrence(S):
    """The doubling scan vs h_t = a_t h_{t-1} + b_t one step at a time, a in the gates' range (0, 1)."""
    rng = np.random.default_rng(S)
    a = torch.tensor(rng.uniform(0.5, 0.9999, (2, S, 8)).astype(np.float32))
    b = torch.tensor(rng.standard_normal((2, S, 8)).astype(np.float32))
    got = rg._scan(a, b)
    h, ref = torch.zeros(2, 8), []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        ref.append(h)
    _close(got, torch.stack(ref, dim=1))


@pytest.mark.parametrize("rnn_width", [None, 96], ids=["reduced", "w96"])
@pytest.mark.parametrize("S", [1, 17, 40])
def test_rglru_apply(S, rnn_width):
    rcfg, cfg = _cfgs(rnn_width)
    p = _params(rcfg)
    x = _x((2, S, cfg.d_model))
    ref, ref_state = ref_rg.rglru_apply(_j(p), jnp.asarray(x), rcfg)
    got, state = rg.rglru_apply(_t(p), torch.tensor(x), cfg)
    assert ref_state is None and state is None
    assert got.shape == (2, S, cfg.d_model) and got.dtype == torch.float32
    _close(got, ref)


def test_rglru_apply_with_state():
    """A carried state (conv window, h, pos) folded into the first step, and the state it returns."""
    rcfg, cfg = _cfgs()
    p = _params(rcfg)
    B, S, w = 2, 23, cfg.rnn_width
    x = _x((B, S, cfg.d_model))
    conv, h = _x((B, 3, w), seed=2), _x((B, w), seed=3, scale=1.0)
    ref, ref_state = ref_rg.rglru_apply(_j(p), jnp.asarray(x), rcfg,
                                        state=ref_rg.RGLRUState(jnp.asarray(conv), jnp.asarray(h), jnp.asarray(5)))
    got, state = rg.rglru_apply(_t(p), torch.tensor(x), cfg,
                                state=rg.RGLRUState(torch.tensor(conv), torch.tensor(h), torch.tensor(5)))
    _close(got, ref)
    _close(state.conv, ref_state.conv)
    _close(state.h, ref_state.h)
    assert int(state.pos) == int(ref_state.pos) == 5 + S


def test_rglru_apply_in_two_pieces():
    """The first 20 tokens with a fresh state, then the last 20 from the state they leave, equal the 40 at once."""
    _, cfg = _cfgs()
    p = _t(_params(_cfgs()[0]))
    x = torch.tensor(_x((2, 40, cfg.d_model)))
    whole, _ = rg.rglru_apply(p, x, cfg)
    first, st = rg.rglru_apply(p, x[:, :20], cfg, state=rg.init_rglru_state(cfg, 2, device="cpu"))
    second, st = rg.rglru_apply(p, x[:, 20:], cfg, state=st)
    _close(torch.cat([first, second], dim=1), whole)
    assert int(st.pos) == 40


def test_rglru_decode_40_steps():
    """40 decode steps from an empty state, each output and state against the reference's."""
    rcfg, cfg = _cfgs()
    p = _params(rcfg)
    x = _x((2, 40, cfg.d_model))
    rp, tp = _j(p), _t(p)
    rstate, state = ref_rg.init_rglru_state(rcfg, 2), rg.init_rglru_state(cfg, 2, device="cpu")
    for t in range(40):
        ref, rstate = ref_rg.rglru_decode(rp, jnp.asarray(x[:, t:t + 1]), rcfg, rstate)
        got, state = rg.rglru_decode(tp, torch.tensor(x[:, t:t + 1]), cfg, state)
        assert got.shape == (2, 1, cfg.d_model)
        _close(got, ref)
        _close(state.h, rstate.h)
        _close(state.conv, rstate.conv)
    assert int(state.pos) == 40


def test_rglru_scan_matches_decode_loop():
    """The reference's identity (tests/test_layers.py): the full-sequence scan equals a loop of decode steps."""
    rcfg, cfg = _cfgs()
    p = _t(_params(rcfg))
    x = torch.tensor(_x((2, 17, cfg.d_model)))
    out_scan, _ = rg.rglru_apply(p, x, cfg)
    state, outs = rg.init_rglru_state(cfg, 2, device="cpu"), []
    for t in range(17):
        o, state = rg.rglru_decode(p, x[:, t:t + 1], cfg, state)
        outs.append(o)
    _close(out_scan, torch.cat(outs, dim=1))

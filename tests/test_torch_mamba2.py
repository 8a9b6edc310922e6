"""The port's Mamba-2 SSD layer vs the reference's, on the CPU.

The same numpy inputs and the reference's parameters (``mamba2_init`` of
``repro.models.layers.mamba2``, carried across as numpy arrays) go through
the JAX module (x64 on, as tests/conftest.py sets it) and
``repro_torch.models.layers.mamba2``. Bars: 1e-5 abs and rel at f32 for
the SSD and the layer (both sides compute in f32 and differ in the order
of their sums: the port contracts over each B/C group once and applies the
decays to the other factor), 1e-6 for the conv (the same K products in the
same order), and the reference's own 1e-4 against the sequential
recurrence oracle of tests/test_layers.py::test_ssd_matches_naive_recurrence
at f32 (1e-10 at f64).

The reference's ``_ssd_chunked`` cannot run at f64: its scan starts from
an f32 zero state, and an f64 update promotes the carry, which
``lax.scan`` refuses. The port carries the inputs' dtype, so at f64 it is
held to the f64 oracle alone.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.models.layers import mamba2 as ref_m2
from repro_torch.configs import get
from repro_torch.models.layers import mamba2 as m2

TOL = 1e-5


def _cfgs(**kw):
    rcfg, cfg = ref_get("mamba2-1.3b").reduced(), get("mamba2-1.3b").reduced()
    if kw:
        rcfg, cfg = replace(rcfg, ssm=replace(rcfg.ssm, **kw)), replace(cfg, ssm=replace(cfg.ssm, **kw))
    return rcfg, cfg


def _params(rcfg, seed=0):
    """The reference's parameters as numpy, with a nonzero conv bias and D
    and dt_bias off their init (so that a wrong skip or bias shows)."""
    p = jax.tree.map(np.asarray, ref_m2.mamba2_init(jax.random.PRNGKey(seed), rcfg, jnp.float32))
    rng = np.random.default_rng(seed)
    for name in ("conv_b", "D", "dt_bias"):
        p[name] = (p[name] + rng.standard_normal(p[name].shape) * 0.1).astype(np.float32)
    return p


def _j(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _t(p):
    return {k: torch.tensor(v) for k, v in p.items()}


def _close(got, ref, tol=TOL, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=tol, rtol=tol, err_msg=what)


def _x(shape, seed=1, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _ssd_inputs(B, S, H, Pd, G, N, seed=0, dtype=np.float32):
    """tests/test_layers.py::test_ssd_matches_naive_recurrence's draws."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, Pd))
    dt = rng.random((B, S, H)) * 0.5 + 0.05
    A = np.log(rng.random(H) * 4 + 0.5)
    Bm = rng.standard_normal((B, S, G, N))
    Cm = rng.standard_normal((B, S, G, N))
    return tuple(a.astype(dtype) for a in (x, dt, A, Bm, Cm))


def _naive_ssd(x, dt, A, Bm, Cm):
    """The sequential recurrence of tests/test_layers.py, in f64."""
    x, dt, A, Bm, Cm = (np.asarray(a, np.float64) for a in (x, dt, A, Bm, Cm))
    B, S, H, Pd = x.shape
    N, rep = Bm.shape[3], H // Bm.shape[2]
    Bh, Ch = np.repeat(Bm, rep, axis=2), np.repeat(Cm, rep, axis=2)
    h, ys, a = np.zeros((B, H, N, Pd)), np.zeros((B, S, H, Pd)), -np.exp(A)
    for t in range(S):
        h = h * np.exp(a[None, :] * dt[:, t])[..., None, None] + np.einsum("bhn,bhp->bhnp", Bh[:, t],
                                                                            x[:, t] * dt[:, t][..., None])
        ys[:, t] = np.einsum("bhn,bhnp->bhp", Ch[:, t], h)
    return ys, h


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba2_init_shapes_and_dtypes(dtype):
    """The reference's names, shapes and dtypes; A_log, D and dt_bias are f32
    whatever the param dtype, with the reference's values."""
    rcfg, cfg = _cfgs()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = ref_m2.mamba2_init(jax.random.PRNGKey(0), rcfg, jdt)
    got = m2.mamba2_init(torch.Generator().manual_seed(0), cfg, dtype, "cpu")
    assert set(got) == set(ref) == {"in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias", "norm_scale", "out_proj"}
    for name, r in ref.items():
        assert tuple(got[name].shape) == r.shape, name
        assert str(got[name].dtype).removeprefix("torch.") == str(r.dtype), name
    for name in ("A_log", "D", "dt_bias", "norm_scale", "conv_b"):
        np.testing.assert_allclose(got[name].float().numpy(), np.asarray(ref[name], np.float32), rtol=1e-6,
                                   err_msg=name)


def test_ssm_state_init():
    rcfg, cfg = _cfgs()
    ref = ref_m2.init_ssm_state(rcfg, 3)
    got = m2.init_ssm_state(cfg, 3, device="cpu")
    for name in ("conv", "ssm", "pos"):
        r, g = getattr(ref, name), getattr(got, name)
        assert tuple(g.shape) == r.shape and str(g.dtype).removeprefix("torch.") == str(r.dtype), name
        assert not g.any()


@pytest.mark.parametrize("S", [23, 3, 20], ids=["S23", "below-chunk", "whole-chunks"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_ssd_matches_naive_recurrence(S, dtype):
    """tests/test_layers.py's oracle at its shapes (B 2, H 4, P 8, G 2, N 6,
    chunk 5): y and the final state, 1e-4 at f32 (its bar), 1e-10 at f64."""
    args = _ssd_inputs(2, S, 4, 8, 2, 6, dtype=dtype)
    y, h = m2._ssd_chunked(*(torch.tensor(a) for a in args), chunk=5)
    ys, hs = _naive_ssd(*args)
    tol = 1e-4 if dtype == np.float32 else 1e-10
    assert y.dtype == h.dtype == torch.tensor(args[0]).dtype
    _close(y, ys, tol)
    _close(h, hs, tol)
    if dtype == np.float64:  # the reference's scan refuses f64 inputs (module docstring)
        with pytest.raises(TypeError, match="carry"):
            ref_m2._ssd_chunked(*(jnp.asarray(a) for a in args), chunk=5)


@pytest.mark.parametrize("S", [23, 3, 20, 64], ids=["S23", "below-chunk", "whole-chunks", "S64"])
@pytest.mark.parametrize("G", [1, 2])
def test_ssd_matches_reference(S, G):
    """The port's _ssd_chunked vs the reference's at f32: y and the final state."""
    args = _ssd_inputs(2, S, 4, 8, G, 6, seed=S)
    ref_y, ref_h = ref_m2._ssd_chunked(*(jnp.asarray(a) for a in args), chunk=5)
    y, h = m2._ssd_chunked(*(torch.tensor(a) for a in args), chunk=5)
    assert y.shape == (2, S, 4, 8) and h.shape == (2, 4, 6, 8)
    _close(y, ref_y)
    _close(h, ref_h)


def test_segsum_and_its_gradient_are_finite():
    """_segsum equals the reference's (-inf above the diagonal), and the
    gradient of exp(_segsum) is finite where the unmasked upper triangle
    would overflow exp (log-decays of -60 a step: cs_i - cs_j reaches +1800)."""
    a = torch.full((2, 3, 31), -60.0, dtype=torch.float32, requires_grad=True)
    got = m2._segsum(a)
    ref = np.asarray(ref_m2._segsum(jnp.asarray(a.detach().numpy())))
    np.testing.assert_array_equal(np.isneginf(got.detach().numpy()), np.isneginf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got.detach().numpy()[fin], ref[fin], rtol=1e-6)
    torch.exp(got).sum().backward()
    assert bool(torch.isfinite(a.grad).all())


@pytest.mark.parametrize("window", [False, True], ids=["zeros", "carried"])
def test_causal_conv(window):
    rcfg, cfg = _cfgs()
    p = _params(rcfg)
    C = p["conv_w"].shape[1]
    x = _x((2, 7, C))
    win = _x((2, 3, C), seed=2) if window else None
    ref, ref_win = ref_m2._causal_conv(jnp.asarray(x), jnp.asarray(p["conv_w"]), jnp.asarray(p["conv_b"]),
                                       None if win is None else jnp.asarray(win))
    got, got_win = m2._causal_conv(torch.tensor(x), torch.tensor(p["conv_w"]), torch.tensor(p["conv_b"]),
                                   None if win is None else torch.tensor(win))
    _close(got, ref, 1e-6)
    np.testing.assert_array_equal(got_win.numpy(), np.asarray(ref_win))


def test_causal_conv_window_keeps_the_activation_dtype():
    """A bf16 activation with an f32 window: the new window is bf16, as the
    reference's (the conv state after a prefill is in the compute dtype)."""
    _, cfg = _cfgs()
    p = m2.mamba2_init(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    x = torch.randn(2, 5, p["conv_w"].shape[1]).to(torch.bfloat16)
    _, win = m2._causal_conv(x, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype),
                             torch.zeros(2, 3, x.shape[2]))
    assert win.dtype == torch.bfloat16 and torch.equal(win, x[:, -3:])


@pytest.mark.parametrize("S", [1, 7, 17, 40])
def test_mamba2_apply(S):
    """The layer without a state against the reference's (chunk 8 of the reduced config)."""
    rcfg, cfg = _cfgs()
    p = _params(rcfg)
    x = _x((2, S, cfg.d_model))
    ref, ref_state = ref_m2.mamba2_apply(_j(p), jnp.asarray(x), rcfg)
    got, state = m2.mamba2_apply(_t(p), torch.tensor(x), cfg)
    assert ref_state is None and state is None
    assert got.shape == (2, S, cfg.d_model) and got.dtype == torch.float32
    _close(got, ref)


@pytest.mark.parametrize("ngroups", [1, 2])
def test_mamba2_apply_with_state_at_start_zero(ngroups):
    """A state at position 0 with a carried conv window (the reference uses
    it, and drops state.ssm): the output and the new state (conv, ssm, pos)."""
    rcfg, cfg = _cfgs(ngroups=ngroups)
    p = _params(rcfg)
    B, S = 2, 21
    x = _x((B, S, cfg.d_model))
    conv = _x((B, 3, p["conv_w"].shape[1]), seed=2)
    ssm = np.zeros(m2.init_ssm_state(cfg, B, device="cpu").ssm.shape, np.float32)
    ref, rs = ref_m2.mamba2_apply(_j(p), jnp.asarray(x), rcfg,
                                  state=ref_m2.SSMState(jnp.asarray(conv), jnp.asarray(ssm), jnp.asarray(0)))
    got, st = m2.mamba2_apply(_t(p), torch.tensor(x), cfg,
                              state=m2.SSMState(torch.tensor(conv), torch.tensor(ssm), torch.tensor(0)), start=0)
    _close(got, ref)
    for name in ("conv", "ssm"):
        _close(getattr(st, name), getattr(rs, name), what=name)
    assert int(st.pos) == int(rs.pos) == S


@pytest.mark.parametrize("S", [1, 9])
def test_mamba2_apply_with_state_past_start_raises(S):
    """The reference's apply with a state drops state.ssm (ROADMAP
    "Reference state"): continuing a sequence through it is refused."""
    _, cfg = _cfgs()
    p = m2.mamba2_init(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    state = m2.init_ssm_state(cfg, 2, device="cpu")
    x = torch.zeros(2, S, cfg.d_model)
    for start in (5, None):
        with pytest.raises(ValueError, match="position 0"):
            m2.mamba2_apply(p, x, cfg, state=state, start=start)


def test_mamba2_decode_steps():
    """12 decode steps from an empty state, each output and state against the reference's."""
    rcfg, cfg = _cfgs()
    p = _params(rcfg)
    x = _x((2, 12, cfg.d_model))
    rp, tp = _j(p), _t(p)
    rstate, state = ref_m2.init_ssm_state(rcfg, 2), m2.init_ssm_state(cfg, 2, device="cpu")
    for t in range(12):
        ref, rstate = ref_m2.mamba2_decode(rp, jnp.asarray(x[:, t:t + 1]), rcfg, rstate)
        got, state = m2.mamba2_decode(tp, torch.tensor(x[:, t:t + 1]), cfg, state)
        assert got.shape == (2, 1, cfg.d_model)
        _close(got, ref, what=f"step {t}")
        _close(state.ssm, rstate.ssm, what=f"ssm {t}")
        _close(state.conv, rstate.conv, what=f"conv {t}")
    assert int(state.pos) == 12


@pytest.mark.parametrize("S", [8, 19])
def test_mamba2_apply_then_decode_matches_apply(S):
    """A prompt through the apply with a fresh state, then decode steps from
    the state it leaves, equals the apply over all the tokens: the state
    the apply hands over (conv window and SSM state) is the one decode reads."""
    rcfg, cfg = _cfgs()
    p = _t(_params(rcfg))
    x = torch.tensor(_x((2, S + 5, cfg.d_model)))
    whole, _ = m2.mamba2_apply(p, x, cfg)
    first, state = m2.mamba2_apply(p, x[:, :S], cfg, state=m2.init_ssm_state(cfg, 2, device="cpu"), start=0)
    outs = [first]
    for t in range(S, S + 5):
        o, state = m2.mamba2_decode(p, x[:, t:t + 1], cfg, state)
        outs.append(o)
    _close(torch.cat(outs, dim=1), whole.detach())
    assert int(state.pos) == S + 5

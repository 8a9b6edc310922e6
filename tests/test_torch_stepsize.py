"""Step-size rules of the port vs the reference, at f64 on fixed states.

The same numpy (y, z, dy, dz) go through ``repro.core.stepsize`` and
``repro_torch.core.stepsize`` (the port on the CPU: its probes run the
probe kernel's plain version). The bars: the same alpha within ls_eps
(relative), the same ``completes`` and the same probe count.

The states are chosen off the refinement bisection's tie
``h - lo == ls_eps * h``: there an alpha one ulp apart decides whether one
more probe is taken (ROADMAP.md, queue 3).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stepsize as R
from repro_torch import kernels as K
from repro_torch.core import stepsize as T
from repro_torch.kernels.linesearch_probe import ops as probe_ops

LS_EPS = 0.1


def _state(seed, kind="far", mp=12, mc=9):
    """A mid-solve MWU state with a feasible step (f(1) >= 1; cf.
    tests/test_stepsize.py). ``kind``: covering values far from 1, within
    a few steps of 1 ("near"), or within one step ("done")."""
    rng = np.random.default_rng(seed)
    y = rng.random(mp) * 0.3
    dy = rng.random(mp) * 1e-3
    dz = rng.random(mc) * 4e-3 + 1e-4
    z = rng.random(mc) * 0.3
    if kind == "near":
        z = 1.0 - dz * rng.uniform(0.5, 3.0, mc)
    elif kind == "done":
        z = 1.0 - dz * rng.uniform(0.2, 0.9, mc)
    return y, z, dy, dz


def _masks(seed, mp=12, mc=9):
    rng = np.random.default_rng(seed + 1000)
    pm = rng.random(mp) > 0.3
    cm = rng.random(mc) > 0.3
    pm[0] = cm[0] = True
    return pm, cm


CASES = [(seed, kind) for seed in range(6) for kind in ("far", "near", "done")]


@functools.lru_cache(maxsize=None)
def _ref_rule(rule):
    # jit once per rule: an eager call would trace its while_loops anew
    return jax.jit(getattr(R, rule), static_argnames=("ls_eps",))


def _run(rule, seed, kind, masked, alpha0):
    y, z, dy, dz = _state(seed, kind)
    pm, cm = _masks(seed) if masked else (None, None)
    eta = 50.0
    ref = _ref_rule(rule)(*map(jnp.asarray, (y, z, dy, dz)), jnp.asarray(eta),
                           None if pm is None else jnp.asarray(pm), None if cm is None else jnp.asarray(cm),
                           ls_eps=LS_EPS, alpha0=None if alpha0 is None else jnp.asarray(alpha0))
    got = getattr(T, rule)(*map(torch.from_numpy, (y, z, dy, dz)), eta,
                           None if pm is None else torch.from_numpy(pm), None if cm is None else torch.from_numpy(cm),
                           ls_eps=LS_EPS, alpha0=alpha0)
    return ref, got


@pytest.mark.parametrize("alpha0", [None, 50.0], ids=["cold", "warm"])
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("rule", ["binary_search_step", "newton_step", "standard_step"])
def test_step_rule_parity(rule, masked, alpha0):
    completing = 0
    for seed, kind in CASES:
        ref, got = _run(rule, seed, kind, masked, alpha0)
        assert got.completes == bool(ref.completes), (seed, kind)
        assert got.probes == int(ref.probes), (seed, kind, got.probes, int(ref.probes))
        assert abs(got.alpha - float(ref.alpha)) <= LS_EPS * float(ref.alpha), (seed, kind, got.alpha)
        completing += got.completes
    assert 0 < completing < len(CASES)  # both branches of the search are exercised


@pytest.mark.parametrize("alpha0", [None, 1.0, 37.0])
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_newton_step_takes_host_loop_off_card(monkeypatch, masked, alpha0):
    """On CPU tensors newton_step runs a host loop and launches nothing: a
    masked state through _newton_step_host, an unmasked one through the
    search wrapper, whose CPU path is its plain version (the same loop over
    plain probes); both give _newton_step_host's result."""
    calls = []
    host, plain = T._newton_step_host, probe_ops.newton_search_ref
    monkeypatch.setattr(T, "_newton_step_host", lambda *a, **k: calls.append("host") or host(*a, **k))
    monkeypatch.setattr(probe_ops, "newton_search_ref", lambda *a, **k: calls.append("plain") or plain(*a, **k))
    K.reset_launch_counts()
    for seed, kind in CASES:
        args = [torch.from_numpy(t) for t in _state(seed, kind)]
        pm, cm = (torch.from_numpy(m) for m in _masks(seed)) if masked else (None, None)
        got = T.newton_step(*args, 50.0, pm, cm, ls_eps=LS_EPS, alpha0=alpha0)
        assert got == host(*args, 50.0, pm, cm, ls_eps=LS_EPS, alpha0=alpha0)
        if not masked:
            y, z, dy, dz = args
            alpha, probes, completes = K.newton_search(y, dy, z, dz, 50.0, LS_EPS, alpha0).tolist()
            assert (alpha, int(probes), bool(completes)) == tuple(got)
    assert calls == (["host"] * len(CASES) if masked else ["plain"] * (2 * len(CASES)))
    assert K.launch_counts() == {name: 0 for name in K.KERNELS}


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_probe_fn_parity(masked):
    y, z, dy, dz = _state(3)
    pm, cm = _masks(3) if masked else (None, None)
    eta = 60.0
    ref = R.make_probe_fn(*map(jnp.asarray, (y, z, dy, dz)), eta, None if pm is None else jnp.asarray(pm),
                          None if cm is None else jnp.asarray(cm), with_grad=True)
    got = T.make_probe_fn(*map(torch.from_numpy, (y, z, dy, dz)), eta,
                          None if pm is None else torch.from_numpy(pm), None if cm is None else torch.from_numpy(cm),
                          with_grad=True)
    for alpha in (0.5, 5.0, 300.0):
        for a, b in zip(got(alpha), ref(jnp.asarray(alpha))):
            np.testing.assert_allclose(a, float(b), rtol=1e-9, atol=1e-12)


def test_f_monotone_decreasing():
    """Prop 4.2: f(alpha) = Phi/Psi is monotone decreasing on R+."""
    for seed in range(5):
        probe = T.make_probe_fn(*map(torch.from_numpy, _state(seed)), 50.0)
        fs = np.array([probe(a).f for a in np.geomspace(0.25, 4096.0, 20)])
        fs = fs[np.isfinite(fs)]
        assert (np.diff(fs) <= 1e-9).all(), fs


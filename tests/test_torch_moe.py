"""The port's MoE layer and its MWU LP router vs ``repro.models.layers.moe``.

Inputs are made from seeds with numpy, in f32 unless a test says
otherwise, and go through the reference (JAX, CPU) and the port
(``device="cpu"``: the MWU kernels' plain versions).

The routing LP in f32 is decided by rounding beyond its first few
iterations: at eta ~ 300 the Newton search's step ``a - (f - 1)/f'`` is a
cancellation, so an ulp of difference grows about threefold an iteration.
Measured on the CPU: the reference's own x moves by 8.9e-3 (skewed case)
and 2.4e-2 (random case, T 256) when its tokens are permuted, an LP
symmetry, and its iteration count moves from 4 to 5; at T 6,144 its
sequential f32 sums put x 2.8e-2 from the f64 trajectory. No f32 solve
meets 1e-4 against another over the whole budget. So the router is held
(1) in f64, over the whole budget, to the reference's LP (the same
operators and options at f64): x within 1e-9, the same iterations, probes
and status, the same routes; (2) in f32, over its first three iterations,
where rounding has not yet grown: x within 1e-4 (tests/test_kernels.py's
f32 bar) and the same probes; (3) in f32 over the whole budget, by the
claims of the reference's own test (tests/test_layers.py:175-193): load
and drops no worse than top-k. The layer with the ``mwu`` router is held
to the reference's layer given the same routes (2e-4,
tests/test_layers.py:172).
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.core import MWUOptions as RefOptions
from repro.core import OnesRow as RefOnesRow
from repro.core import VStack as RefVStack
from repro.core.mwu import solve as ref_solve
from repro.models.layers import moe as ref_moe
from repro_torch.configs import get
from repro_torch.core import solve_lanes
from repro_torch.models.layers import moe

LAYER_TOL = 2e-4  # tests/test_layers.py:172
X_TOL_F32 = 1e-4  # tests/test_kernels.py's f32 bar
X_TOL_F64 = 1e-9  # f64 rounding grown by the same ~3x an iteration (measured <= 1e-10)
MARGIN = 1e-4  # routes compared on tokens whose k-th / (k+1)-th margin exceeds this


def _skewed():
    """tests/test_layers.py:175's logits: everyone loves experts 0 and 1."""
    rng = np.random.default_rng(0)
    T, E = 256, 8
    logits = rng.standard_normal((T, E)) * 0.1
    logits[:, 0] += 3.0
    logits[:, 1] += 2.5
    return logits.astype(np.float32)


def _random(T=256, E=8, seed=1):
    return np.random.default_rng(seed).standard_normal((T, E)).astype(np.float32)


# (logits, k, capacity, mwu_iters); capacity as tests/test_layers.py takes it
CASES = {
    "skewed-16": (_skewed, 2, 80, 16),
    "skewed-64": (_skewed, 2, 80, 64),
    "random-16": (_random, 2, 80, 16),
}


def _probs(logits) -> np.ndarray:
    return np.asarray(jax.nn.softmax(jnp.asarray(logits, jnp.float32), axis=-1))


def _ref_lp(probs: np.ndarray, k: int, cap: int, iters: int):
    """The reference's routing LP (moe.py:154-173) over probs, its constants
    in probs' dtype."""
    T, E = probs.shape
    dt = jnp.asarray(probs).dtype
    affin = jnp.asarray(probs.reshape(-1))
    P = RefVStack(ops=(ref_moe.ExpertCapRows(inv_cap=jnp.full((E,), 1.0 / cap, dt), T=T), ref_moe.BoxRows(n=T * E)))
    C = RefVStack(ops=(ref_moe.TokenSumRows(inv_k=jnp.asarray(1.0 / k, dt), T=T, E=E),
                       RefOnesRow(c=affin, inv_bound=jnp.asarray(1.0 / jnp.maximum(affin.sum() * 0.5, 1e-6)))))
    return ref_solve(P, C, RefOptions(eps=0.25, step_rule="newton", max_iter=iters, check_packing=False))


def _port_lp(probs: np.ndarray, k: int, cap: int, iters: int):
    return solve_lanes([(*moe.routing_ops(torch.tensor(probs), k, cap), None, None)],
                       moe.router_options(iters)).lane(0)


def _route_sets(idx) -> np.ndarray:
    return np.sort(np.asarray(idx), axis=-1)


def _margin(x: np.ndarray, probs: np.ndarray, k: int) -> np.ndarray:
    """Each token's gap between its k-th and (k+1)-th score (the rounding's)."""
    s = -np.sort(-(x + 1e-6 * probs), axis=-1)
    return s[:, k - 1] - s[:, k]


def _t(a):
    return torch.tensor(np.asarray(a))


# ----------------------------------------------------------------------
# operators
# ----------------------------------------------------------------------


def _operators(T=37, E=5, k=2) -> dict:
    """name -> (reference operator, port operator)."""
    inv_cap = (1.0 / np.random.default_rng(3).integers(5, 20, E)).astype(np.float32)
    return {
        "ExpertCapRows": (ref_moe.ExpertCapRows(inv_cap=jnp.asarray(inv_cap), T=T),
                          moe.ExpertCapRows(inv_cap=_t(inv_cap), T=T)),
        "TokenSumRows": (ref_moe.TokenSumRows(inv_k=jnp.asarray(1.0 / k, jnp.float32), T=T, E=E),
                         moe.TokenSumRows(inv_k=torch.tensor(1.0 / k, dtype=torch.float32), T=T, E=E)),
        "BoxRows": (ref_moe.BoxRows(n=T * E), moe.BoxRows(n=T * E)),
    }


@pytest.mark.parametrize("which", ["ExpertCapRows", "TokenSumRows", "BoxRows"])
def test_operators_match_reference(which):
    ref, op = _operators()[which]
    assert op.shape == ref.shape and op.nnz == ref.nnz
    m, n = op.shape
    rng = np.random.default_rng(4)
    x = rng.random(n).astype(np.float32)
    w = rng.random(m).astype(np.float32)
    for got, want in [(op.matvec(_t(x)), ref.matvec(jnp.asarray(x))),
                      (op.rmatvec(_t(w)), ref.rmatvec(jnp.asarray(w))),
                      (op.colmax(), ref.colmax()),
                      (op.colmax(_t(w)), ref.colmax(jnp.asarray(w)))]:
        assert got.dtype == torch.float32 and tuple(got.shape) == np.asarray(want).shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    # the transposed products agree with the materialized matrix
    A = op.materialize(torch.float64)
    np.testing.assert_allclose(op.rmatvec(_t(w).double()).numpy(), A.T.numpy() @ w, rtol=1e-12)
    assert op.as_gather(_t(w)) is None


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_topk_route_matches_reference(k, ties):
    """Equal idx (the lower index first on ties, as jax.lax.top_k) and gates."""
    logits = _random(T=64, E=16, seed=k)
    if ties:  # few distinct values a row: many exact ties
        logits = np.round(logits * 2) / 2
    ref_idx, ref_gate = ref_moe.topk_route(jnp.asarray(logits), k)
    idx, gate = moe.topk_route(_t(logits), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(gate.numpy(), np.asarray(ref_gate), atol=1e-6)


@pytest.mark.parametrize("case", list(CASES))
def test_routing_lp_matches_reference_f64(case):
    """The whole budget at f64: x, iterations, probes, status; then the
    rounding's routes on every token past the margin."""
    make, k, cap, iters = CASES[case]
    probs = _probs(make()).astype(np.float64)
    ref = _ref_lp(probs, k, cap, iters)
    got = _port_lp(probs, k, cap, iters)
    assert got.x.dtype == torch.float64
    assert (got.iters, got.ls_probes, got.status) == (int(ref.iters), int(ref.ls_probes), int(ref.status))
    x, xr = got.x.numpy().reshape(probs.shape), np.asarray(ref.x).reshape(probs.shape)
    np.testing.assert_allclose(x, xr, atol=X_TOL_F64, rtol=0)
    idx, _ = moe.round_plan(_t(x), _t(probs), k, torch.float64)
    ref_idx = jax.lax.top_k(jnp.asarray(xr + 1e-6 * probs), k)[1]
    past = _margin(x, probs, k) > MARGIN
    np.testing.assert_array_equal(_route_sets(idx)[past], _route_sets(ref_idx)[past])


@pytest.mark.parametrize("iters", [1, 2, 3])
@pytest.mark.parametrize("case", ["skewed-16", "random-16"])
def test_routing_lp_first_iterations_match_reference_f32(case, iters):
    """The forward's own f32 LP over its first iterations: x within 1e-4,
    the same probes (the module docstring says why not beyond)."""
    make, k, cap, _ = CASES[case]
    probs = _probs(make())
    ref = _ref_lp(probs, k, cap, iters)
    got = _port_lp(probs, k, cap, iters)
    assert got.x.dtype == torch.float32
    assert (got.iters, got.ls_probes, got.status) == (int(ref.iters), int(ref.ls_probes), int(ref.status))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), atol=X_TOL_F32, rtol=0)


@pytest.mark.parametrize("iters", [16, 64])
def test_mwu_router_load_no_worse_than_topk(iters):
    """tests/test_layers.py:175-193's claims, for the port's router at f32."""
    logits = _skewed()
    T, E, k = logits.shape[0], logits.shape[1], 2
    cap = int(T * k / E * 1.25)
    idx_top, _ = moe.topk_route(_t(logits), k)
    idx_mwu, gate = moe.mwu_route(_t(logits), k, cap, mwu_iters=iters)
    assert idx_mwu.shape == (T, k) and gate.dtype == torch.float32
    np.testing.assert_allclose(gate.sum(-1).numpy(), 1.0, rtol=1e-6)
    load_top = moe.expert_load(idx_top, E).numpy()
    load_mwu = moe.expert_load(idx_mwu, E).numpy()
    assert load_mwu.sum() == T * k and load_mwu.max() <= load_top.max(), (load_top, load_mwu)
    assert np.maximum(load_mwu - cap, 0).sum() <= np.maximum(load_top - cap, 0).sum()
    np.testing.assert_array_equal(load_top, np.asarray(ref_moe.expert_load(jnp.asarray(idx_top.numpy()), E)))


def test_router_lanes_equal_their_own_solves():
    """G groups are G lanes of one solve_lanes call; each equals the solve
    of its group alone bit for bit (x, iterations, probes), and so do the
    routes; two runs are equal bit for bit."""
    logits = np.stack([_random(T=128, seed=5), _skewed()[:128]])
    k, cap = 2, 40
    probs, res = moe.routing_lp(_t(logits), k, cap, 16)
    for g in range(2):
        _, alone = moe.routing_lp(_t(logits[g:g + 1]), k, cap, 16)
        assert torch.equal(res.x[g], alone.x[0])
        assert (res.iters[g], res.ls_probes[g], res.status[g]) == (alone.iters[0], alone.ls_probes[0], alone.status[0])
        idx_g, gate_g = moe.mwu_route(_t(logits[g]), k, cap)
        idx, gate = moe.mwu_route(_t(logits), k, cap)
        assert torch.equal(idx[g], idx_g) and torch.equal(gate[g], gate_g)
    _, again = moe.routing_lp(_t(logits), k, cap, 16)
    assert torch.equal(again.x, res.x)


# ----------------------------------------------------------------------
# the layer
# ----------------------------------------------------------------------


def _moe_cfgs(arch: str, G: int):
    """(reference config, port config): the reduced config at f32; dbrx keeps
    its 16 experts and top-4."""
    cfgs = []
    for get_fn in (ref_get, get):
        cfg = replace(get_fn(arch).reduced(), moe_dispatch_groups=G)
        if arch.startswith("dbrx"):
            cfg = replace(cfg, moe=replace(cfg.moe, n_experts=16, top_k=4))
        cfgs.append(cfg)
    return cfgs


def _layer_inputs(cfg, B=2, S=24, seed=5):
    """The reference's init, and tokens that share a component, so that the
    router favours some experts and the capacity rule drops tokens."""
    params = {k: np.asarray(v) for k, v in ref_moe.moe_init(jax.random.PRNGKey(seed), cfg, jnp.float32).items()}
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, cfg.d_model)) + 2.0 * rng.standard_normal(cfg.d_model)
    return params, x.astype(np.float32)


def _dropped(cfg, idx_groups) -> int:
    G, cap = moe.dispatch_shape(cfg, idx_groups.shape[0] * idx_groups.shape[1])
    return int(sum(np.maximum(moe.expert_load(idx, cfg.moe.n_experts).numpy() - cap, 0).sum() for idx in idx_groups))


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "dbrx-132b"])
def test_moe_apply_topk_matches_reference(arch, G):
    """The default capacity (1.25): tokens are dropped."""
    rcfg, cfg = _moe_cfgs(arch, G)
    params, x = _layer_inputs(cfg)
    ref = ref_moe.moe_apply({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x), rcfg)
    got = moe.moe_apply({k: _t(v) for k, v in params.items()}, _t(x), cfg)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=LAYER_TOL, rtol=LAYER_TOL)
    Gr, _ = moe.dispatch_shape(cfg, x.shape[0] * x.shape[1])
    logits = (_t(x).reshape(Gr, -1, cfg.d_model) @ _t(params["router"]))
    assert _dropped(cfg, moe.topk_route(logits, cfg.moe.top_k)[0]) > 0  # the capacity rule ran


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("arch", ["mixtral-8x22b-mwu", "dbrx-132b-mwu"])
def test_moe_apply_mwu_matches_reference_given_routes(arch, G, monkeypatch):
    """The mwu layer runs the port's router unchanged; the reference's layer
    is handed the routes the port chose (its router replaced by a host
    callback), since f32 rounding decides some routes (module docstring).
    The logits each router saw agree within 1e-5; the layer within 2e-4."""
    rcfg, cfg = _moe_cfgs(arch, G)
    params, x = _layer_inputs(cfg)
    seen = {}
    route = moe.mwu_route

    def recording(logits, k, capacity, mwu_iters=16):
        seen.update(logits=logits.numpy(), k=k, capacity=capacity, mwu_iters=mwu_iters)
        seen["idx"], seen["gate"] = route(logits, k, capacity, mwu_iters)
        return seen["idx"], seen["gate"]

    monkeypatch.setattr(moe, "mwu_route", recording)
    got = moe.moe_apply({k: _t(v) for k, v in params.items()}, _t(x), cfg)
    G_used, cap = moe.dispatch_shape(cfg, x.shape[0] * x.shape[1])
    assert (seen["k"], seen["capacity"], seen["mwu_iters"]) == (cfg.moe.top_k, cap, cfg.moe.mwu_iters)
    assert seen["logits"].shape == (G_used, x.shape[0] * x.shape[1] // G_used, cfg.moe.n_experts)
    assert _dropped(cfg, seen["idx"]) > 0  # the capacity rule ran

    def port_routes(lg):  # all groups at once (vmap_method="expand_dims")
        np.testing.assert_allclose(lg, seen["logits"], atol=1e-5)
        return seen["idx"].numpy().astype(np.int32), seen["gate"].numpy()

    def given(lg, k, capacity, mwu_iters=16):
        shapes = (jax.ShapeDtypeStruct(lg.shape[:-1] + (k,), jnp.int32),
                  jax.ShapeDtypeStruct(lg.shape[:-1] + (k,), jnp.float32))
        return jax.pure_callback(port_routes, shapes, lg, vmap_method="expand_dims")

    monkeypatch.setattr(ref_moe, "mwu_route", given)
    ref = ref_moe.moe_apply({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x), rcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=LAYER_TOL, rtol=LAYER_TOL)


@pytest.mark.parametrize("router", ["topk", "mwu"])
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "dbrx-132b"])
def test_moe_apply_no_drop_matches_expert_loop(arch, router):
    """capacity_factor = E (no token dropped), against a per-expert loop
    (tests/test_layers.py:160-172's oracle, in numpy)."""
    _, cfg = _moe_cfgs(arch, 1)
    cfg = replace(cfg, moe=replace(cfg.moe, router=router, capacity_factor=float(cfg.moe.n_experts)))
    params, x = _layer_inputs(cfg, seed=6)
    p = {k: _t(v) for k, v in params.items()}
    got = moe.moe_apply(p, _t(x), cfg).numpy().reshape(-1, cfg.d_model)
    xt = x.reshape(-1, cfg.d_model)
    logits = _t(xt) @ p["router"]
    T, (_, cap) = xt.shape[0], moe.dispatch_shape(cfg, xt.shape[0])
    idx, gate = (moe.topk_route(logits, cfg.moe.top_k) if router == "topk"
                 else moe.mwu_route(logits, cfg.moe.top_k, cap, cfg.moe.mwu_iters))
    idx, gate = idx.numpy(), gate.numpy()
    y = np.zeros_like(xt)
    silu = lambda a: a / (1 + np.exp(-a))  # noqa: E731
    for e in range(cfg.moe.n_experts):
        oe = (silu(xt @ params["wg"][e]) * (xt @ params["wu"][e])) @ params["wd"][e]
        for j in range(cfg.moe.top_k):
            sel = idx[:, j] == e
            y[sel] += gate[sel, j, None] * oe[sel]
    np.testing.assert_allclose(got, y, atol=LAYER_TOL, rtol=LAYER_TOL)


@pytest.mark.parametrize("arch", ["mixtral-8x22b-mwu", "dbrx-132b"])
def test_moe_apply_repeats_bit_for_bit(arch):
    _, cfg = _moe_cfgs(arch, 2)
    params, x = _layer_inputs(cfg, seed=7)
    p = {k: _t(v) for k, v in params.items()}
    a, b = moe.moe_apply(p, _t(x), cfg), moe.moe_apply(p, _t(x), cfg)
    assert torch.equal(a, b)


def test_dispatch_shape_is_the_reference_rule():
    """moe.py:269-275: G halved until it divides T, capacity up to a multiple of 8, at least 8."""
    cfg = get("mixtral-8x22b")
    assert moe.dispatch_shape(cfg, 6144) == (1, 1920)
    assert moe.dispatch_shape(replace(cfg, moe_dispatch_groups=4), 6) == (2, 8)
    assert moe.dispatch_shape(get("dbrx-132b"), 48) == (1, 16)

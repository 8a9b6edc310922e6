"""The masked forms of the port's kernel functions, on the CPU.

Padded rows of a served request, and gen-match's rows with no lower bound,
reach the kernels as row masks (one byte a row). On the CPU each wrapper
runs its masked plain version; here they are held against the reference's
masked expressions on the same numpy inputs: ``jnp.where`` softmax and
min/max (``repro.core.smoothing``, ``repro.core.mwu``), the masked
``make_probe_fn`` and ``newton_step`` (``repro.core.stepsize``). Bars:
softmax and probe within 1e-4 at f32 and 1e-10 at f64 (tests/test_kernels.py),
min and max exact, the search's alpha within ls_eps and its probes and
``completes`` equal, on the states of tests/test_torch_stepsize.py (off the
refinement bisection's tie, ROADMAP.md queue 3). Then the MWU loop: a
masked Newton lane runs the search's step form, reads the host once a loop
iteration, and equals the solve whose step comes from ``_newton_step_host``
each iteration, bit for bit.
"""
import functools
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stepsize as R
from repro_torch import kernels as K
from repro_torch.api import MWUOptions, Solver
from repro_torch.core import mwu
from repro_torch.core import stepsize as T
from repro_torch.graphs import bipartite_ratings, build, erdos, generalized_matching_problem
from repro_torch.kernels.linesearch_probe import ops as probe_ops
from repro_torch.lpserve import BucketSpec, pad_problem
from test_torch_stepsize import CASES, LS_EPS, _masks, _state

DTYPES = [np.float32, np.float64]
TOLS = {np.float32: 1e-4, np.float64: 1e-10}
EPS = 0.1


def _bits(x: float) -> bytes:
    return struct.pack("d", x)


def _keep(rng, n, share=0.6):
    k = rng.random(n) < share
    k[rng.integers(0, n)] = True
    return k


# -------------------------------------------------------------- softmax --
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [3, 127, 1030, 9999])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_masked_softmax_matches_reference(n, sign, dtype):
    """lse over the kept rows and w = softmax there, 0 elsewhere (exactly)."""
    rng = np.random.default_rng(n)
    v = rng.standard_normal(n).astype(dtype)
    keep = _keep(rng, n)
    eta = 211.0
    lse, w = K.softmax_weights(torch.from_numpy(v), eta, sign=sign, keep=torch.from_numpy(keep))
    a = jnp.where(keep, (sign * eta) * jnp.asarray(v), -jnp.inf)
    lse_r, w_r = jax.nn.logsumexp(a), jax.nn.softmax(a)
    assert lse.dtype == w.dtype == torch.from_numpy(v).dtype
    np.testing.assert_allclose(float(lse), float(lse_r), rtol=TOLS[dtype])
    np.testing.assert_allclose(w.numpy(), np.asarray(w_r), atol=TOLS[dtype])
    assert (w.numpy()[~keep] == 0.0).all()
    # uint8 masks are the same one byte a row
    lse8, w8 = K.softmax_weights(torch.from_numpy(v), eta, sign=sign, keep=torch.from_numpy(keep.astype(np.uint8)))
    assert torch.equal(w8, w) and float(lse8) == float(lse)


def test_masked_smoothing_goes_through_the_kernel(monkeypatch):
    """smax_and_weights / smin_and_weights hand ``where`` to the softmax
    kernel as its row mask, for every ``where``."""
    from repro_torch.core import smoothing

    calls = []
    kernel = smoothing.softmax_weights
    monkeypatch.setattr(smoothing, "softmax_weights", lambda *a, **k: calls.append(k.get("keep")) or kernel(*a, **k))
    v = torch.rand(50, dtype=torch.float64)
    mask = torch.rand(50) > 0.5
    smoothing.smax_and_weights(v, 30.0, where=mask)
    smoothing.smin_and_weights(v, 30.0, where=None)
    assert calls[0] is mask and calls[1] is None


def test_fully_masked_rows_give_no_nan():
    """Every row masked out: lse -inf, weights 0, min +inf (the kernels'
    empty-state identities), never NaN."""
    v = torch.rand(9, dtype=torch.float64)
    none = torch.zeros(9, dtype=torch.bool)
    lse, w = K.softmax_weights(v, 5.0, keep=none)
    assert float(lse) == -np.inf and (w == 0).all()
    r = K.linesearch_probe(v, v, 0.5, 5.0, keep=none).tolist()
    assert r[0] == -np.inf and r[2] == np.inf
    _, mn, mx = K.axpy_reduce(v, v, 0.5, keep=none)
    assert float(mn) == np.inf and float(mx) == -np.inf


# ---------------------------------------------------------------- probe --
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,nz", [(9, 1), (1024, 77), (3333, 3333)])
def test_masked_probe2_matches_reference(n, nz, dtype):
    """Both sides, each over its kept rows: lse, <softmax, d> and min, as the
    reference's masked probe computes them."""
    rng = np.random.default_rng(n + nz)
    y, z = rng.random(n).astype(dtype), rng.random(nz).astype(dtype)
    dy, dz = (rng.random(n) * 1e-3).astype(dtype), (rng.random(nz) * 1e-3).astype(dtype)
    ky, kz = _keep(rng, n), _keep(rng, nz)
    alpha, eta = 7.5, 97.0
    got = K.linesearch_probe2(*map(torch.from_numpy, (y, dy, z, dz)), alpha, eta, p_keep=torch.from_numpy(ky),
                              c_keep=torch.from_numpy(kz)).tolist()
    want = []
    for x, dx, k, sign in ((y, dy, ky, 1.0), (z, dz, kz, -1.0)):
        v = jnp.asarray(x) + alpha * jnp.asarray(dx)
        a = jnp.where(k, (sign * eta) * v, -jnp.inf)
        want += [float(jax.nn.logsumexp(a)), float(jnp.dot(jax.nn.softmax(a), jnp.asarray(dx))),
                 float(jnp.min(jnp.where(k, v, jnp.inf)))]
    for a, b in zip(got, want):
        assert abs(a - b) <= TOLS[dtype] * max(1.0, abs(b)), (a, b)
    assert got[2] == want[2] and got[5] == want[5]  # the min is exact


def test_masked_probe_fn_matches_reference():
    """make_probe_fn over masked probes gives the reference's masked probe
    (f, phi, psi, slopes, min z) within 1e-9."""
    y, z, dy, dz = _state(3)
    pm, cm = _masks(3)
    ref = R.make_probe_fn(*map(jnp.asarray, (y, z, dy, dz)), 60.0, jnp.asarray(pm), jnp.asarray(cm), with_grad=True)
    got = T.make_probe_fn(*map(torch.from_numpy, (y, z, dy, dz)), 60.0, torch.from_numpy(pm), torch.from_numpy(cm))
    for alpha in (0.5, 5.0, 300.0):
        for a, b in zip(got(alpha), ref(jnp.asarray(alpha))):
            np.testing.assert_allclose(a, float(b), rtol=1e-9, atol=1e-12)


# --------------------------------------------------------------- search --
@functools.lru_cache(maxsize=None)
def _ref_newton():
    return jax.jit(R.newton_step, static_argnames=("ls_eps",))


def _ref_search(y, z, dy, dz, pm, cm, alpha0):
    return _ref_newton()(*map(jnp.asarray, (y, z, dy, dz)), jnp.asarray(50.0), jnp.asarray(pm), jnp.asarray(cm),
                         ls_eps=LS_EPS, alpha0=None if alpha0 is None else jnp.asarray(alpha0))


# warm starts as in tests/test_torch_stepsize.py: from 37, _state(0, "done")
# lands on the refinement bisection's tie (12 probes against the
# reference's 13, ROADMAP.md queue 3)
@pytest.mark.parametrize("alpha0", [None, 1.0, 50.0], ids=["cold", "warm1", "warm50"])
def test_masked_newton_search_matches_reference(alpha0):
    """The search's host form over masked rows against the reference's
    masked newton_step: probes and completes equal, alpha within ls_eps."""
    completing = 0
    for seed, kind in CASES:
        y, z, dy, dz = _state(seed, kind)
        pm, cm = _masks(seed)
        ref = _ref_search(y, z, dy, dz, pm, cm, alpha0)
        alpha, probes, completes = K.newton_search(*map(torch.from_numpy, (y, dy, z, dz)), 50.0, LS_EPS, alpha0,
                                                   p_keep=torch.from_numpy(pm), c_keep=torch.from_numpy(cm)).tolist()
        assert (int(probes), bool(completes)) == (int(ref.probes), bool(ref.completes)), (seed, kind)
        assert abs(alpha - float(ref.alpha)) <= LS_EPS * float(ref.alpha), (seed, kind)
        completing += bool(completes)
    assert 0 < completing < len(CASES)


@pytest.mark.parametrize("alpha_prev", [1.0, 50.0])
@pytest.mark.parametrize("d_max", [1e-3, 0.0], ids=["dmax>0", "dmax=0"])
def test_masked_newton_step_form_matches_reference(d_max, alpha_prev):
    """The step form over masked rows: the record's alpha, probes and
    completes are the host form's, bit for bit, and the reference's at its
    bars; step and bad follow Alg. 2 lines 8 and 12; alpha_prev moves only
    when the step is taken."""
    for seed, kind in CASES:
        y, z, dy, dz = _state(seed, kind)
        pm, cm = _masks(seed)
        t = [torch.from_numpy(a) for a in (y, dy, z, dz)]
        keep = dict(p_keep=torch.from_numpy(pm), c_keep=torch.from_numpy(cm))
        host = K.newton_search(*t, 50.0, LS_EPS, alpha_prev, **keep).tolist()
        ap = torch.tensor([alpha_prev], dtype=torch.float64)
        rec = K.newton_search(*t, 50.0, LS_EPS, ap, d_max=torch.tensor(d_max, dtype=torch.float64), **keep).tolist()
        assert [_bits(v) for v in rec[:3]] == [_bits(v) for v in host]
        ref = _ref_search(y, z, dy, dz, pm, cm, alpha_prev)
        assert (int(rec[1]), bool(rec[2])) == (int(ref.probes), bool(ref.completes)), (seed, kind)
        assert abs(rec[0] - float(ref.alpha)) <= LS_EPS * float(ref.alpha)
        bad = d_max <= 0 or rec[0] < 1
        assert rec[4] == float(bad) and _bits(rec[3]) == _bits(0.0 if bad else rec[0])
        assert _bits(float(ap)) == _bits(alpha_prev if bad else rec[0])


# ----------------------------------------------------------------- axpy --
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [3, 1030, 9999])
def test_masked_axpy_min_max_match_reference(n, dtype):
    """The update covers every row (bit-equal to the unmasked update); min
    and max run over the kept rows, exactly as jnp.where's."""
    rng = np.random.default_rng(n)
    y, dy = rng.standard_normal(n).astype(dtype), rng.random(n).astype(dtype)
    keep = _keep(rng, n)
    out, mn, mx = K.axpy_reduce(torch.from_numpy(y), torch.from_numpy(dy), 3.25, keep=torch.from_numpy(keep))
    plain, _, _ = K.axpy_reduce(torch.from_numpy(y), torch.from_numpy(dy), 3.25)
    assert torch.equal(out, plain)
    v = jnp.asarray(y) + jnp.asarray(3.25, dtype) * jnp.asarray(dy)
    assert float(mn) == float(jnp.min(jnp.where(keep, v, jnp.inf)))
    assert float(mx) == float(jnp.max(jnp.where(keep, v, -jnp.inf)))
    red = torch.zeros(2, dtype=torch.float64)
    K.axpy_reduce(torch.from_numpy(y), torch.from_numpy(dy), torch.tensor([3.25], dtype=torch.float64), red=red,
                  keep=torch.from_numpy(keep))
    assert red.tolist() == [float(mn), float(mx)]


# ------------------------------------------------------------- the loop --
def _masked_problems():
    g = bipartite_ratings(60, 40, avg_ratings=6.0, seed=1)
    s, deg = g.bipartite_split, g.degrees()
    lb, ub = np.zeros(g.n), np.ones(g.n)
    lb[:s] = np.minimum(1, deg[:s])
    ub[:s], ub[s:] = 5, 8
    gen = generalized_matching_problem(g, lb, ub, device="cpu")
    match = pad_problem(build("match", erdos(60, 160, seed=0), device="cpu"), BucketSpec(128, 256))
    vcover = pad_problem(build("vcover", erdos(60, 160, seed=1), device="cpu"), BucketSpec(128, 256))
    return {"gen-match": (gen, 1.0), "padded match": (match, match.lo), "padded vcover": (vcover, vcover.hi)}


@pytest.mark.parametrize("case", ["gen-match", "padded match", "padded vcover"])
def test_masked_lane_equals_host_rule_solve(case, monkeypatch):
    """A masked Newton lane of solve_lanes takes the search's step form (one
    record row a loop iteration, no _newton_step_host, no read of its own):
    its result equals, bit for bit, the solve whose every step comes from
    _newton_step_host (the masked host loop) as a host rule."""
    prob, bound = _masked_problems()[case]
    monkeypatch.setitem(T.STEP_RULES, "newton-host", T._newton_step_host)
    host = Solver(MWUOptions(eps=EPS, step_rule="newton-host")).feasible(prob, bound)
    calls = []
    record, loop = T._newton_step_host, mwu.newton_step_record
    monkeypatch.setattr(T, "_newton_step_host", lambda *a, **k: calls.append("host") or record(*a, **k))
    monkeypatch.setattr(mwu, "newton_step_record", lambda *a, **k: calls.append("record") or loop(*a, **k))
    got = Solver(MWUOptions(eps=EPS, step_rule="newton")).feasible(prob, bound)
    assert calls == ["record"] * got.iters and got.iters > 0
    assert (got.status, got.iters, got.ls_probes) == (host.status, host.iters, host.ls_probes)
    assert _bits(got.max_px) == _bits(host.max_px) and _bits(got.min_cx) == _bits(host.min_cx)
    assert torch.equal(got.x, host.x)


def test_masked_lane_iteration_matches_reference(monkeypatch):
    """A served match lane's first iteration (the padded edges masked in P)
    against the reference's ``_iteration`` on the same padded operators:
    the packing gradient goes into the step direction as a gather with the
    edge mask (no lone gather, no multiply of its own), whose d is bit for
    bit the reference's rmatvec, ratio and d chain on the same inputs; the
    iteration's record (status, probes, the alpha within ls_eps) and the
    state after it (x, the masked max of y and min of z, within ls_eps)
    agree with the reference's carry."""
    from repro.core import mwu as RM
    from repro.core import operators as RO
    from repro.core import stepsize as RS
    from repro_torch.core import operators as TO

    padded = pad_problem(build("match", erdos(60, 160, seed=0), device="cpu"), BucketSpec(128, 256))
    bound = float(padded.lo)
    P, C, pm, cm = padded.instantiate(bound)
    assert P.edge_mask is not None and not bool(P.edge_mask.all()) and cm is None
    calls, gathers = [], []
    fused, lone = mwu.step_direction, TO.incidence_gather
    monkeypatch.setattr(mwu, "step_direction",  # x is the lane's state, updated in place after: kept as it was
                        lambda h, x, *a, **k: calls.append(((h, x.clone(), *a), k, fused(h, x, *a, **k))) or calls[-1][2])
    monkeypatch.setattr(TO, "incidence_gather", lambda *a, **k: gathers.append(a) or lone(*a, **k))
    res, trace = mwu.solve_traced(P, C, MWUOptions(eps=EPS, step_rule="newton", max_iter=1), p_mask=pm)
    monkeypatch.undo()
    assert res.iters == 1 and len(calls) == 1 and gathers == []
    (h, x, scale), kw, (d, d_max) = calls[0]
    assert kw["g"] is None
    u, v, wp, mask, weights = kw["gather"]
    assert mask is P.edge_mask and weights is None

    RP = RO.Incidence(u=jnp.asarray(u.numpy()), v=jnp.asarray(v.numpy()), n_vertices=P.n_vertices,
                      edge_mask=jnp.asarray(mask.numpy()))
    RC = RO.OnesRow(c=jnp.asarray(C.c.numpy()), inv_bound=jnp.asarray(C.inv_bound.numpy()))
    jpm = jnp.asarray(pm.numpy())
    # the step direction on the port's own inputs, by the reference's chain
    g = RP.rmatvec(jnp.asarray(wp.numpy()))
    tiny = jnp.finfo(jnp.float64).tiny
    hj, xj = jnp.asarray(h.numpy()), jnp.asarray(x.numpy())
    d_ref = scale * jnp.maximum(0.0, 1.0 - jnp.where(hj > tiny, g / jnp.maximum(hj, tiny), jnp.inf)) * xj
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_ref))
    assert float(d_max) == float(jnp.max(d_ref)) > 0.0

    # the reference's iteration from its own start
    eta = jnp.asarray(RM.make_eta(P.shape[0] + C.shape[0], EPS), jnp.float64)
    x0 = RM.init_x(RP, EPS, jnp.float64)
    carry = RM._Carry(x=x0, y=RP.matvec(x0), z=RC.matvec(x0), it=jnp.int32(0), probes=jnp.int32(0),
                      alpha_prev=jnp.ones((), jnp.float64), status=jnp.int32(0))
    nxt = RM._iteration(RP, RC, eta, 1.0 / eta, RS.STEP_RULES["newton"], EPS, jpm, None, None, carry)
    assert (int(nxt.status), int(nxt.probes)) == (mwu.Status.RUNNING, res.ls_probes)
    assert abs(trace["alpha"][0] - float(nxt.alpha_prev)) <= EPS * float(nxt.alpha_prev)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(nxt.x), rtol=EPS, atol=0)
    assert abs(res.max_px - float(RM._masked_max(nxt.y, jpm))) <= EPS * res.max_px
    assert abs(res.min_cx - float(jnp.min(nxt.z))) <= EPS * res.min_cx


def test_masked_lanes_read_once_a_loop_iteration(monkeypatch):
    """Masked Newton lanes read the host once a loop iteration for all lanes
    (the record), plus once to start and once to finish: the masked min of
    z and max of y come from the record, not from reads of their own. The
    step form's plain version, which stands for one launch, is not counted."""
    probs = [pad_problem(build("match", erdos(*dims, seed=s), device="cpu"), BucketSpec(128, 256))
             for s, dims in enumerate([(60, 160), (100, 240)])]
    lanes = [p.instantiate(b) for p in probs for b in (p.lo, p.hi)]
    reads = []
    for name in ("item", "tolist"):
        method = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name, lambda t, _m=method, _n=name: reads.append(_n) or _m(t))
    plain = probe_ops.newton_step_ref

    def uncounted(*a, **k):
        n = len(reads)
        out = plain(*a, **k)
        del reads[n:]
        return out

    monkeypatch.setattr(probe_ops, "newton_step_ref", uncounted)
    res = mwu.solve_lanes(lanes, MWUOptions(eps=EPS, step_rule="newton"))
    monkeypatch.undo()
    assert len(reads) == int(res.iters.max()) + 2 and set(reads) == {"tolist"}
    assert K.launch_counts() == {name: 0 for name in K.KERNELS}

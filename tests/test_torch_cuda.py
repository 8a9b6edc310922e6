"""The port on the card: each CUDA kernel vs its plain version, solves and
an encoder forward on the card vs the same on the CPU.

Every test here is marked ``cuda`` and skips where no card is present.
The file imports neither jax nor ``repro``, so on a machine with a card
and without jax it runs alone, skipping the repo's conftest.py:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import struct

import numpy as np
import pytest
import torch

from dataclasses import replace

from repro_torch import kernels as K
from repro_torch.api import MWUOptions, Solver, Status, stack_problems
from repro_torch.configs import get
from repro_torch.core import MPCOptions, mpc_solve, solve
from repro_torch.graphs import (bipartite_ratings, build, erdos, generalized_matching_lp, generalized_matching_problem,
                                rgg)
from repro_torch.kernels.axpy_reduce.ref import axpy_reduce_ref
from repro_torch.kernels.flash_attention.ref import flash_attention_plain
from repro_torch.core import operators as ops
from repro_torch.kernels.incidence_gather.ref import incidence_gather_ref
from repro_torch.kernels.incidence_scatter import segments
from repro_torch.kernels.incidence_scatter.ref import incidence_scatter_ref
from repro_torch.kernels.step_direction.ref import step_direction_ref
from repro_torch.core import stepsize
from repro_torch.kernels.linesearch_probe.ref import (binary_search_ref, linesearch_probe2_ref, linesearch_probe_ref,
                                                     newton_search_ref)
from repro_torch.kernels.softmax_weights.ref import softmax_weights_ref
from repro_torch.lpserve import BucketSpec, LPEngine, LPServeConfig, pad_problem
from repro_torch.models import Model
from repro_torch.models.layers import rglru as rg

EPS = 0.1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 3, 1030, 300_000])
def test_kernels_match_plain_on_card(cuda, n, dtype):
    """Bars of tests/test_kernels.py; the gather and the axpy are bit-equal
    (one rounded add; y + alpha*dy rounded twice, no FMA)."""
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    gen = torch.Generator().manual_seed(n)
    y = torch.rand(n, generator=gen, dtype=dtype)
    dy = torch.rand(n, generator=gen, dtype=dtype) * 1e-3
    yc, dyc = y.to(cuda), dy.to(cuda)
    K.reset_launch_counts()

    lse, w = K.softmax_weights(yc, 211.0, sign=-1.0)
    lse_r, w_r = softmax_weights_ref(y, 211.0, sign=-1.0)
    assert abs(float(lse) - float(lse_r)) <= tol * max(1.0, abs(float(lse_r)))
    assert float((w.cpu() - w_r).abs().max()) <= tol

    for sign in (1.0, -1.0):
        got = K.linesearch_probe(yc, dyc, 7.5, 97.0, sign=sign).cpu()
        ref = linesearch_probe_ref(y, dy, 7.5, 97.0, sign=sign)
        assert float((got - ref).abs().max()) <= tol * max(1.0, float(ref.abs().max()))
        assert float(got[2]) == float(ref[2])  # min(y + alpha dy): exact
    got = K.linesearch_probe2(yc, dyc, yc[: n // 2 + 1], dyc[: n // 2 + 1], 7.5, 97.0).cpu()
    ref = linesearch_probe2_ref(y, dy, y[: n // 2 + 1], dy[: n // 2 + 1], 7.5, 97.0)
    assert float((got - ref).abs().max()) <= tol * max(1.0, float(ref.abs().max()))

    out, mn, mx = K.axpy_reduce(yc, dyc, 3.25)
    out_r, mn_r, mx_r = axpy_reduce_ref(y, dy, 3.25)
    assert torch.equal(out.cpu(), out_r)
    assert float(mn) == float(mn_r) and float(mx) == float(mx_r)

    idx = torch.randint(0, n, (2 * n + 7,), generator=gen, dtype=torch.int32)
    jdx = idx.flip(0).contiguous()
    g = K.incidence_gather(idx.to(cuda), jdx.to(cuda), yc)
    assert torch.equal(g.cpu(), incidence_gather_ref(idx, jdx, y))
    torch.cuda.synchronize()
    assert K.launch_counts() == {"incidence_gather": 1, "softmax_weights": 1, "linesearch_probe": 3,
                                 "newton_search": 0, "binary_search": 0, "axpy_reduce": 1, "flash_attention": 0,
                                 "incidence_scatter": 0, "step_direction": 0}


def _bits(x: float) -> bytes:
    return struct.pack("d", x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 3, 255, 256, 257, 9999, 497_959])
@pytest.mark.parametrize("nz", ["1", "n"])
def test_probe2_and_softmax_match_plain_on_card(cuda, n, nz, dtype):
    """The two-sided probe (one launch) and the one-launch softmax weights
    against their plain versions at the bars of tests/test_kernels.py, the
    probe's mins exact, Sum w = 1; two launches on one input bitwise equal."""
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    m = 1 if nz == "1" else n
    gen = torch.Generator().manual_seed(n + m)
    y, z = torch.rand(n, generator=gen, dtype=dtype), torch.rand(m, generator=gen, dtype=dtype)
    dy, dz = (torch.rand(k, generator=gen, dtype=dtype) * 1e-3 for k in (n, m))
    eta = float(10 * np.log(n + m + 1) / 0.1)  # the solver's eta at this size
    args = [t.to(cuda) for t in (y, dy, z, dz)]
    K.reset_launch_counts()
    got, again = (K.linesearch_probe2(*args, 7.5, eta) for _ in range(2))
    ref = linesearch_probe2_ref(y, dy, z, dz, 7.5, eta)
    assert torch.equal(got, again)
    got = got.cpu()
    assert float((got - ref).abs().max()) <= tol * max(1.0, float(ref.abs().max()))
    assert float(got[2]) == float(ref[2]) and float(got[5]) == float(ref[5])

    (lse, w), (lse2, w2) = (K.softmax_weights(args[2], eta, sign=-1.0) for _ in range(2))
    lse_r, w_r = softmax_weights_ref(z, eta, sign=-1.0)
    assert torch.equal(w, w2) and float(lse) == float(lse2)
    assert abs(float(lse) - float(lse_r)) <= tol * max(1.0, abs(float(lse_r)))
    assert float((w.cpu() - w_r).abs().max()) <= tol
    assert abs(float(w.sum()) - 1.0) <= tol
    torch.cuda.synchronize()
    assert K.launch_counts()["linesearch_probe"] == 2 and K.launch_counts()["softmax_weights"] == 2


@pytest.mark.cuda
def test_one_launch_reductions_on_views_on_card(cuda):
    """Vectors off 16-byte alignment (views at an odd offset) take the
    kernels' scalar loads: the same values as the plain versions."""
    base = torch.rand(20_001, dtype=torch.float64, device=cuda)
    v, dv = base[1:], base[:-1] * 1e-3
    lse, w = K.softmax_weights(v, 80.0)
    lse_r, w_r = softmax_weights_ref(v, 80.0)
    assert float((w - w_r).abs().max()) <= 1e-10 and abs(float(lse - lse_r)) <= 1e-10 * abs(float(lse_r))
    got = K.linesearch_probe2(v, dv, base[3:700], base[2:699] * 1e-3, 2.5, 80.0)
    ref = linesearch_probe2_ref(v, dv, base[3:700], base[2:699] * 1e-3, 2.5, 80.0)
    assert float((got - ref).abs().max()) <= 1e-10 * max(1.0, float(ref.abs().max()))


@pytest.mark.cuda
def test_one_launch_reductions_beyond_one_wave_on_card(cuda):
    """40M elements: many more tiles than the co-resident grid has blocks,
    so each block walks many tiles and the grid barrier still completes."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    y = torch.rand(40_000_000, generator=gen, device=cuda, dtype=torch.float64)
    dy = torch.rand(40_000_000, generator=gen, device=cuda, dtype=torch.float64) * 1e-3
    lse, w = K.softmax_weights(y, 30.0)
    lse_r, w_r = softmax_weights_ref(y, 30.0)
    assert float((w - w_r).abs().max()) <= 1e-10 and abs(float(lse - lse_r)) <= 1e-10 * abs(float(lse_r))
    z, dz = y[:5].clone() * 0.3, dy[:5].clone()
    got = stepsize.newton_step(y * 0.3, z, dy, dz, 30.0, ls_eps=0.1, alpha0=1.0)
    host = stepsize._newton_step_host(y * 0.3, z, dy, dz, 30.0, ls_eps=0.1, alpha0=1.0)
    assert (_bits(got.alpha), got.probes, got.completes) == (_bits(host.alpha), host.probes, host.completes)


def _search_state(n, m, kind, seed, dtype, device):
    """A mid-solve state (tests/test_torch_stepsize.py's _state) at n packing
    and m covering rows; kind "below" is "far" with a packing step 300x as
    large, so that f(1) < 1 and the search backs off below alpha = 1."""
    rng = np.random.default_rng(seed)
    y, dy = rng.random(n) * 0.3, rng.random(n) * 1e-3
    dz = rng.random(m) * 4e-3 + 1e-4
    z = rng.random(m) * 0.3
    if kind == "near":
        z = 1.0 - dz * rng.uniform(0.5, 3.0, m)
    elif kind == "done":
        z = 1.0 - dz * rng.uniform(0.2, 0.9, m)
    elif kind == "below":
        dy = dy * 300.0
    return [torch.from_numpy(t).to(dtype).to(device) for t in (y, z, dy, dz)]


@pytest.mark.cuda
@pytest.mark.parametrize("alpha0", [None, 1.0, 37.0])
@pytest.mark.parametrize("kind", ["far", "near", "done", "below"])
@pytest.mark.parametrize("m", ["1", "n"])
@pytest.mark.parametrize("n", [1, 12, 300, 9999, 497_959])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_newton_search_matches_host_loop_on_card(cuda, dtype, n, m, kind, alpha0):
    """The search kernel (one launch, one host read) against the host loop
    over the two-sided probe kernel on the same state: the same alpha bit
    for bit, the same probes and completes. Its step form (max(d) and the
    warm start alpha_prev read from device memory) gives the same three,
    and the step and bad flag of the MWU iteration: step = alpha and
    alpha_prev = alpha when max(d) > 0 and alpha >= 1, else step 0, bad,
    alpha_prev kept (max(d) = 0 below, and the "below" states' alpha < 1)."""
    y, z, dy, dz = _search_state(n, 1 if m == "1" else n, kind, n, dtype, cuda)
    eta = float(10 * np.log(n + z.shape[0]) / 0.1) if n > 12 else 50.0
    host = stepsize._newton_step_host(y, z, dy, dz, eta, ls_eps=0.1, alpha0=alpha0)
    K.reset_launch_counts()
    got = stepsize.newton_step(y, z, dy, dz, eta, ls_eps=0.1, alpha0=alpha0)
    assert K.launch_counts()["newton_search"] == 1 and K.launch_counts()["linesearch_probe"] == 0
    assert (_bits(got.alpha), got.probes, got.completes) == (_bits(host.alpha), host.probes, host.completes)
    if kind == "below":
        assert host.alpha < 1
    start = 1.0 if alpha0 is None else alpha0
    host = stepsize._newton_step_host(y, z, dy, dz, eta, ls_eps=0.1, alpha0=start)
    for d_max in (1e-3, 0.0):
        alpha_prev = torch.tensor([start], dtype=torch.float64, device=cuda)
        out = torch.full((7,), -1.0, dtype=torch.float64, device=cuda)
        rec = stepsize.newton_step_record(y, z, dy, dz, eta, 0.1, torch.tensor(d_max, dtype=dtype, device=cuda),
                                          alpha_prev, out=out[1:6])
        alpha, probes, completes, step, bad = rec.tolist()
        assert (_bits(alpha), int(probes), bool(completes)) == (_bits(host.alpha), host.probes, host.completes)
        want_bad = d_max <= 0 or host.alpha < 1
        assert bool(bad) == want_bad and _bits(step) == _bits(0.0 if want_bad else host.alpha)
        assert _bits(float(alpha_prev)) == _bits(start if want_bad else host.alpha)
        assert out[0].item() == out[6].item() == -1.0  # nothing written outside the record


@pytest.mark.cuda
@pytest.mark.parametrize("alpha0", [None, 1.0, 37.0])
@pytest.mark.parametrize("kind", ["far", "near", "done", "below"])
@pytest.mark.parametrize("m", ["1", "n"])
@pytest.mark.parametrize("n", [1, 12, 300, 9999, 497_959])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_binary_search_matches_host_loop_on_card(cuda, dtype, n, m, kind, alpha0):
    """The binary search kernel (one launch, one host read) against the host
    loop over the two-sided probe kernel on the same state
    (stepsize._binary_search_step_host): the same alpha bit for bit, the
    same probes and completes; within ls_eps of its plain version (the same
    loop over plain PyTorch probes) where alpha >= 1. Its step
    form gives the same three, and the step, bad flag and alpha_prev as the
    MWU iteration decides them, at max(d) > 0 and max(d) = 0."""
    y, z, dy, dz = _search_state(n, 1 if m == "1" else n, kind, n, dtype, cuda)
    eta = float(10 * np.log(n + z.shape[0]) / 0.1) if n > 12 else 50.0
    host = stepsize._binary_search_step_host(y, z, dy, dz, eta, ls_eps=0.1, alpha0=alpha0)
    K.reset_launch_counts()
    got = stepsize.binary_search_step(y, z, dy, dz, eta, ls_eps=0.1, alpha0=alpha0)
    counts = K.launch_counts()
    assert (counts["binary_search"], counts["linesearch_probe"], counts["newton_search"]) == (1, 0, 0)
    assert (_bits(got.alpha), got.probes, got.completes) == (_bits(host.alpha), host.probes, host.completes)
    if kind == "below":
        assert host.alpha < 1
    if host.alpha >= 1:  # a step the loop takes; far below 1 the f32 probes are rounding noise
        alpha, _, completes = binary_search_ref(y, dy, z, dz, eta, 0.1, alpha0).tolist()
        assert got.completes == bool(completes) and abs(got.alpha - alpha) <= 0.1 * max(got.alpha, alpha)
    start = 1.0 if alpha0 is None else alpha0
    host = stepsize._binary_search_step_host(y, z, dy, dz, eta, ls_eps=0.1, alpha0=start)
    for d_max in (1e-3, 0.0):
        alpha_prev = torch.tensor([start], dtype=torch.float64, device=cuda)
        out = torch.full((7,), -1.0, dtype=torch.float64, device=cuda)
        rec = stepsize.binary_step_record(y, z, dy, dz, eta, 0.1, torch.tensor(d_max, dtype=dtype, device=cuda),
                                          alpha_prev, out=out[1:6])
        alpha, probes, completes, step, bad = rec.tolist()
        assert (_bits(alpha), int(probes), bool(completes)) == (_bits(host.alpha), host.probes, host.completes)
        want_bad = d_max <= 0 or host.alpha < 1
        assert bool(bad) == want_bad and _bits(step) == _bits(0.0 if want_bad else host.alpha)
        assert _bits(float(alpha_prev)) == _bits(start if want_bad else host.alpha)
        assert out[0].item() == out[6].item() == -1.0  # nothing written outside the record


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_standard_step_record_on_card(cuda, dtype, masked):
    """The standard rule's record on the card (plain tensor operations, no
    kernel of its own): alpha 1, probes 0, completes as standard_step, the
    iteration's decision on max(d), nothing read back."""
    for kind in ("far", "near", "done"):
        y, z, dy, dz = _search_state(300, 300, kind, 300, dtype, cuda)
        cm = _keep(300, 7, cuda) if masked else None
        want = stepsize.standard_step(y, z, dy, dz, 50.0, None, cm)
        for d_max in (1e-3, 0.0):
            ap = torch.tensor([5.0], dtype=torch.float64, device=cuda)
            rec = stepsize.standard_step_record(y, z, dy, dz, 50.0, 0.1, torch.tensor(d_max, dtype=dtype, device=cuda),
                                                ap, c_mask=cm).tolist()
            assert rec == [1.0, 0.0, float(want.completes), float(d_max > 0), float(d_max <= 0)]
            assert float(ap) == (1.0 if d_max > 0 else 5.0)


# Both sides of each threshold of the search kernel's plan
# (csrc/search_plan.cuh) on this card's grid G, as (packing rows, covering
# rows, the plan's path): one tile a block, then the grid split (two tiles
# for some blocks), the most tiles held (three), one row more (four tiles,
# streamed); and the covering side's last held and first streamed length.
_PLAN_EDGES = {"1 tile": lambda g, t: ((g - 1) * t, 1, "shared memory"),
               "2 tiles": lambda g, t: ((g - 1) * t + 1, 1, "shared memory"),
               "3 tiles, most held": lambda g, t: (3 * (g - 1) * t, 1, "shared memory"),
               "4 tiles, streamed": lambda g, t: (3 * (g - 1) * t + 1, 1, "streamed"),
               "cover held": lambda g, t: (1, 3 * (g - 1) * t, "shared memory"),
               "cover streamed": lambda g, t: (1, 3 * (g - 1) * t + 1, "streamed")}


@pytest.mark.cuda
@pytest.mark.parametrize("edge", list(_PLAN_EDGES))
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("rule", ["newton", "binary"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_search_at_plan_thresholds_on_card(cuda, dtype, rule, masked, edge):
    """The search kernel at both sides of every held/streamed threshold of
    its plan: the plan takes the expected path; the lone search and the
    step form give the host loop's alpha bit for bit (with probes and
    completes), as the MWU iteration decides on it; a second launch and
    launches on two streams at once give the same bits; so does the lone
    probe, the body of both."""
    from repro_torch.kernels.linesearch_probe.ops import search_plan

    big = search_plan(1 << 30, 1, dtype)
    tile = 256 * (64 // (torch.finfo(dtype).bits // 8))
    n, m, path = _PLAN_EDGES[edge](big["gy"] + big["gz"], tile)
    assert search_plan(n, m, dtype)["path"] == path
    y, z, dy, dz = _search_state(n, m, "far", n + m, dtype, cuda)
    pm = _keep(n, 5, cuda) if masked and n > 1 else None
    cm = _keep(m, 6, cuda) if masked and m > 1 else None
    eta = float(10 * np.log(n + m) / 0.1)
    host_fn, lone_fn, record_fn = {
        "newton": (stepsize._newton_step_host, stepsize.newton_step, stepsize.newton_step_record),
        "binary": (stepsize._binary_search_step_host, stepsize.binary_search_step, stepsize.binary_step_record)}[rule]
    host = host_fn(y, z, dy, dz, eta, pm, cm, ls_eps=0.1, alpha0=1.0)
    lone = lone_fn(y, z, dy, dz, eta, pm, cm, ls_eps=0.1, alpha0=1.0)
    assert (_bits(lone.alpha), lone.probes, lone.completes) == (_bits(host.alpha), host.probes, host.completes)
    d_max = torch.tensor(1e-3, dtype=dtype, device=cuda)

    def record():
        alpha_prev = torch.ones(1, dtype=torch.float64, device=cuda)
        return record_fn(y, z, dy, dz, eta, 0.1, d_max, alpha_prev, p_mask=pm, c_mask=cm), alpha_prev

    rec, alpha_prev = record()
    alpha, probes, completes, step, bad = rec.tolist()
    assert (_bits(alpha), int(probes), bool(completes)) == (_bits(host.alpha), host.probes, host.completes)
    want_bad = host.alpha < 1
    assert bool(bad) == want_bad and _bits(step) == _bits(0.0 if want_bad else host.alpha)
    assert _bits(float(alpha_prev)) == _bits(1.0 if want_bad else host.alpha)
    probe = K.linesearch_probe2(y, dy, z, dz, 7.5, eta, p_keep=pm, c_keep=cm)
    again = record()
    assert torch.equal(again[0], rec) and torch.equal(again[1], alpha_prev)
    assert torch.equal(K.linesearch_probe2(y, dy, z, dz, 7.5, eta, p_keep=pm, c_keep=cm), probe)
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    torch.cuda.synchronize()
    outs = []
    for st in streams:
        with torch.cuda.stream(st):
            outs.append([(record(), K.linesearch_probe2(y, dy, z, dz, 7.5, eta, p_keep=pm, c_keep=cm))
                         for _ in range(3)])
    torch.cuda.synchronize()
    for res in outs:
        for (r, ap), pr in res:
            assert torch.equal(r, rec) and torch.equal(ap, alpha_prev) and torch.equal(pr, probe)


@pytest.mark.cuda
@pytest.mark.parametrize("alpha0", [None, 37.0])
@pytest.mark.parametrize("kind", ["far", "near", "done"])
@pytest.mark.parametrize("n", [1, 300, 497_959])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_newton_search_near_plain_search_on_card(cuda, dtype, n, kind, alpha0):
    """The search kernel against its plain version, the same loop over plain
    PyTorch probes (no code shared with the kernel's sweep and fold): the
    same completes, alpha within ls_eps * alpha (the search's resolution;
    the probes differ by rounding)."""
    y, z, dy, dz = _search_state(n, 1, kind, n, dtype, cuda)
    eta = float(10 * np.log(n + 1) / 0.1) if n > 12 else 50.0
    got = stepsize.newton_step(y, z, dy, dz, eta, ls_eps=0.1, alpha0=alpha0)
    alpha, _, completes = newton_search_ref(y, dy, z, dz, eta, 0.1, alpha0).tolist()
    assert got.completes == bool(completes)
    assert abs(got.alpha - alpha) <= 0.1 * max(got.alpha, alpha), (tuple(got), alpha)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 1030, 3_000_001])
def test_axpy_device_step_matches_host_float_on_card(cuda, n, dtype):
    """The axpy with its step read from device memory against the host-float
    form: the same bits, in place and into a caller's out, with [min, max]
    written into the caller's float64 slot."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    y = torch.rand(n, generator=gen, device=cuda, dtype=dtype)
    dy = torch.rand(n, generator=gen, device=cuda, dtype=dtype) * 1e-3
    for alpha in (3.25, 1.0 / 3.0, 0.0, 987.654321):
        out, mn, mx = K.axpy_reduce(y, dy, alpha)
        step = torch.tensor([alpha], dtype=torch.float64, device=cuda)
        red = torch.zeros(4, dtype=torch.float64, device=cuda)
        rows = torch.empty(2, n + 64, dtype=dtype, device=cuda)
        rows[1, 1:n + 1] = y  # an odd offset: the row is off 16-byte alignment
        K.reset_launch_counts()
        got, gmn, gmx = K.axpy_reduce(rows[1, 1:n + 1], dy, step, out=rows[1, 1:n + 1], red=red[1:3])
        assert K.launch_counts()["axpy_reduce"] == 1
        assert torch.equal(got, out) and got.data_ptr() == rows[1, 1:].data_ptr()
        assert _bits(float(mn)) == _bits(float(gmn)) and _bits(float(mx)) == _bits(float(gmx))
        assert red[0].item() == red[3].item() == 0.0
        assert torch.equal(out, axpy_reduce_ref(y, dy, alpha)[0])


@pytest.mark.cuda
def test_one_launch_reductions_on_two_streams_on_card(cuda):
    """Launches on two streams at once keep their partials apart: each gives
    its plain version's values."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    ins = [torch.rand(4, 2_000_000, generator=gen, device=cuda, dtype=torch.float64) * s for s in (1.0, 1.5)]
    streams = [torch.cuda.Stream(cuda) for _ in ins]
    torch.cuda.synchronize()
    outs = []
    for x, st in zip(ins, streams):
        with torch.cuda.stream(st):
            y, dy, z, dz = x[0], x[1] * 1e-3, x[2], x[3] * 1e-3
            outs.append([(K.linesearch_probe2(y, dy, z, dz, 2.5, 40.0), K.softmax_weights(y, 40.0)[1])
                         for _ in range(20)])
    torch.cuda.synchronize()
    for x, res in zip(ins, outs):
        y, dy, z, dz = x[0], x[1] * 1e-3, x[2], x[3] * 1e-3
        ref, w_r = linesearch_probe2_ref(y, dy, z, dz, 2.5, 40.0), softmax_weights_ref(y, 40.0)[1]
        for got, w in res:
            assert float((got - ref).abs().max()) <= 1e-10 * max(1.0, float(ref.abs().max()))
            assert float((w - w_r).abs().max()) <= 1e-10


@pytest.mark.cuda
def test_card_wrappers_reject_bad_inputs(cuda):
    x = torch.rand(10, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        K.axpy_reduce(x.half(), x.half(), 1.0)
    with pytest.raises(ValueError):
        K.softmax_weights(x[::2], 1.0)  # not contiguous
    with pytest.raises(TypeError):
        i64 = torch.zeros(3, dtype=torch.int64, device=cuda)
        K.incidence_gather(i64, i64, x)
    with pytest.raises(ValueError):
        K.linesearch_probe(x, x[:5], 1.0, 1.0)


def _power_law_incidence(n_users, n_items, E, device, seed=0):
    """An Incidence laid out as bmatch's: u (users) ascending, v (items) of
    Zipf popularity as graphs/generators.py draws it (item = n_items / rank,
    rank = U^-2 at zipf_a 1.5), so item 0 takes ~E / sqrt(n_items) entries:
    a segment much longer than one merge tile (2,048 items)."""
    gen = torch.Generator().manual_seed(seed)
    u = torch.randint(0, n_users, (E,), generator=gen, dtype=torch.int32).sort().values
    item = (n_items * torch.rand(E, generator=gen, dtype=torch.float64) ** 2).to(torch.int32)
    v = n_users + torch.clamp(item, max=n_items - 1)
    return ops.Incidence(u=u.to(device), v=v.to(device), n_vertices=n_users + n_items)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(3, 2, 1), (50, 7, 40), (2_000, 300, 400_000), (60_000, 17_770, 3_000_000)])
def test_incidence_scatter_matches_plain_on_card(cuda, shape, dtype):
    """Incidence.matvec on the card (the segmented-sum kernel) against the
    plain version on the same segments, within the reductions' bars of
    tests/test_kernels.py relative to max(1, |plain|); two calls and a call
    on another stream give the same bits. The largest shapes hold a segment
    of ~10^5 entries (tens of merge tiles) and rows of degree 0."""
    n_users, n_items, E = shape
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    op = _power_law_incidence(n_users, n_items, E, cuda, seed=E)
    a, b = op.csr
    assert a.src is None and (b.src is not None or E == 1)  # u sorted: no permutation on its side
    x = torch.rand(E, generator=torch.Generator(device=cuda).manual_seed(1), device=cuda, dtype=dtype)
    K.reset_launch_counts()
    got, again = op.matvec(x), op.matvec(x)
    stream = torch.cuda.Stream(cuda)
    stream.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(stream):
        other = op.matvec(x)
    torch.cuda.synchronize()
    assert K.launch_counts()["incidence_scatter"] == 3
    ref = incidence_scatter_ref(x, a, b)
    assert torch.equal(got, again) and torch.equal(got, other)
    assert float(((got - ref).abs() / ref.abs().clamp(min=1.0)).max()) <= tol
    # the v side in one piece (no slabs of x) and in slabs of a few values
    for slab_cols in (E, max(E // 37, 1)):
        s = segments(op.v, op.n_vertices, E, slab_cols=slab_cols)
        got, again = K.incidence_scatter(x, a, s), K.incidence_scatter(x, a, s)
        assert torch.equal(got, again)
        assert float(((got - ref).abs() / ref.abs().clamp(min=1.0)).max()) <= tol
        if E >= 400_000 and slab_cols == E:
            assert int((s.offsets[1:] - s.offsets[:-1]).max()) > 4 * 2048
    if E == 3_000_000:
        assert b.slabs > 1  # the operator's own layout: slabs of SLAB_COLS values


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_incidence_scatter_orders_and_edges_on_card(cuda, dtype):
    """The scatter's one cooperative launch against its plain version, within
    the bars above: the operator's interleaved dispatch order, the
    side-major one and a random permutation of the tiles give the same
    bits; a hot row spread over hundreds of merge tiles, with an edge mask,
    weights and base; n = 1 and E = 1."""
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    gen = torch.Generator(device=cuda).manual_seed(4)
    op = _power_law_incidence(60_000, 17_770, 3_000_000, cuda, seed=3)
    a, b = op.csr
    side_major = torch.arange(a.tiles + b.tiles, dtype=torch.int32, device=cuda)
    assert b.slabs > 1 and not torch.equal(op.scatter_order, side_major)
    x = torch.rand(3_000_000, generator=gen, device=cuda, dtype=dtype)
    got = op.matvec(x)
    for order in (side_major, torch.randperm(a.tiles + b.tiles, generator=gen, device=cuda).to(torch.int32)):
        assert torch.equal(K.incidence_scatter(x, a, b, order=order), got)
    ref = incidence_scatter_ref(x, a, b)
    assert float(((got - ref).abs() / ref.abs().clamp(min=1.0)).max()) <= tol

    E, n = 1_200_000, 2_001  # v: every edge on vertex 2000, one segment of ~586 merge tiles
    u = torch.randint(0, n - 1, (E,), generator=gen, device=cuda, dtype=torch.int32).sort().values
    v = torch.full((E,), n - 1, dtype=torch.int32, device=cuda)
    keep = torch.rand(E, generator=gen, device=cuda) > 0.1
    wt = torch.randint(1, 4, (E,), generator=gen, device=cuda).to(torch.float64)
    a, b = (segments(r, n, E, wt=wt, keep=keep) for r in (u, v))
    assert int((b.offsets[1:] - b.offsets[:-1]).max()) > 200 * 2048
    x = torch.rand(E, generator=gen, device=cuda, dtype=dtype)
    base = torch.rand(n, generator=gen, device=cuda, dtype=dtype)
    got, again = (K.incidence_scatter(x, a, b, base=base) for _ in range(2))
    ref = incidence_scatter_ref(x, a, b, base)
    assert torch.equal(got, again)
    assert float(((got - ref).abs() / ref.abs().clamp(min=1.0)).max()) <= tol

    one = ops.Incidence(u=torch.zeros(1, dtype=torch.int32, device=cuda),
                        v=torch.zeros(1, dtype=torch.int32, device=cuda), n_vertices=1)
    x = torch.tensor([0.7], dtype=dtype, device=cuda)
    assert torch.equal(one.matvec(x), x + x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_scatter_operators_match_cpu_on_card(cuda, dtype):
    """Every operator that scatters on the card (masked, weighted, base,
    interleaved sources, COO both ways) against its CPU index_add_ product
    on the same inputs, within the bars above; integer-valued inputs give
    the same bits (every partial sum is exact)."""
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    g = rgg(9, seed=2)
    rng = np.random.default_rng(3)
    u, v = torch.as_tensor(g.u), torch.as_tensor(g.v)
    mask = torch.as_tensor(rng.random(g.m) > 0.3)
    wts = torch.as_tensor(rng.integers(1, 4, g.m).astype(np.float64))
    rows, cols = (torch.as_tensor(rng.integers(0, k, 3 * g.m).astype(np.int32)) for k in (g.n, g.m))
    vals = torch.as_tensor(rng.integers(0, 3, 3 * g.m).astype(np.float64))

    def build(dev):
        t = dict(u=u.to(dev), v=v.to(dev), n_vertices=g.n)
        return [ops.Incidence(**t), ops.Incidence(**t, weights=wts.to(dev), edge_mask=mask.to(dev)),
                ops.AdjacencyPlusId(**t), ops.AdjacencyPlusId(**t, edge_mask=mask.to(dev)),
                ops.VertexEdgePair(**t, edge_mask=mask.to(dev)),
                ops.Coo(rows=rows.to(dev), cols=cols.to(dev), vals=vals.to(dev), _shape=(g.n, g.m))]

    K.reset_launch_counts()
    for cpu_op, card_op in zip(build("cpu"), build(cuda)):
        for prod in ("matvec", "rmatvec") if isinstance(cpu_op, ops.Coo) else ("matvec",):
            n_in = cpu_op.shape[1] if prod == "matvec" else cpu_op.shape[0]
            for x in (torch.as_tensor(rng.random(n_in)).to(dtype), torch.as_tensor(rng.integers(0, 9, n_in)).to(dtype)):
                ref = getattr(cpu_op, prod)(x)
                got = getattr(card_op, prod)(x.to(cuda)).cpu()
                assert float(((got - ref).abs() / ref.abs().clamp(min=1.0)).max()) <= tol, (type(cpu_op), prod)
            assert torch.equal(got, ref), (type(cpu_op), prod)  # the integer-valued x
    assert K.launch_counts()["incidence_scatter"] == 14


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("E", [1, 5, 1030, 3_000_000])
def test_step_direction_matches_plain_on_card(cuda, E, dtype):
    """d bit-equal to the plain eager chain, in both sources (gather and
    read), with h <= tiny, g = 0, x = 0, a NaN-free zero direction and the
    exact max; two launches and two streams give the same bits."""
    gen = torch.Generator().manual_seed(E)
    n = max(E // 7, 2)
    u, v = (torch.randint(0, n, (E,), generator=gen, dtype=torch.int32) for _ in range(2))
    w = torch.rand(n, generator=gen, dtype=dtype) * 2e-3
    h = torch.rand(E, generator=gen, dtype=dtype) * 2e-3
    x = torch.rand(E, generator=gen, dtype=dtype)
    tiny = torch.finfo(dtype).tiny
    h[::5], x[1::7], w[::3] = tiny, 0.0, 0.0  # h <= tiny, x = 0, g = 0 where both ends are 0
    scale = float(torch.tensor(1 / 211.7, dtype=dtype))
    g = incidence_gather_ref(u, v, w)
    d_ref, m_ref = step_direction_ref(h, x, scale, gather=(u, v, w))
    dev = [t.to(cuda) for t in (u, v, w, h, x, g)]
    K.reset_launch_counts()
    for kw in (dict(gather=tuple(dev[:3])), dict(g=dev[5])):
        d, m = K.step_direction(dev[3], dev[4], scale, **kw)
        d2, m2 = K.step_direction(dev[3], dev[4], scale, **kw)
        assert torch.equal(d.cpu(), d_ref) and torch.equal(d, d2)
        assert float(m) == float(m_ref) == float(m2)
    d0, m0 = K.step_direction(dev[3], dev[4] * 0.0, scale, g=dev[5])  # a zero direction
    assert float(m0) == 0.0 and not bool(d0.any())
    assert K.launch_counts()["step_direction"] == 5


def _bits_of(t: torch.Tensor) -> torch.Tensor:
    """A float tensor's bits as integers on the host: equal bits, NaN and signed zero included."""
    return t.cpu().reshape(-1).view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def _same_bits(got: torch.Tensor, card_plain: torch.Tensor, host_plain: torch.Tensor) -> bool:
    """got bit for bit the plain version run on the card (NaN and signed zero
    included), and the host's plain version where that is not NaN (a NaN's
    payload is the processor's: the card's and the host's differ)."""
    nan = host_plain.reshape(-1).isnan()
    return (torch.equal(_bits_of(got), _bits_of(card_plain)) and torch.equal(got.cpu().reshape(-1).isnan(), nan)
            and torch.equal(_bits_of(got)[~nan], _bits_of(host_plain)[~nan]))


def _factor_inputs(E, dtype, seed):
    """Edges over E // 7 vertices with w holding inf and -0.0 (so that a
    masked or zero-weight edge gives NaN or a signed zero), a mask and
    weights with zeros: the gather's and the step direction's edge factor."""
    gen = torch.Generator().manual_seed(seed)
    n = max(E // 7, 3)
    u = torch.randint(0, n, (E + 1,), generator=gen, dtype=torch.int32)
    v = torch.randint(0, n, (E + 1,), generator=gen, dtype=torch.int32)
    w = torch.rand(n, generator=gen, dtype=dtype) * 2e-3
    w[0], w[1], w[2] = float("inf"), -0.0, -1e-3
    mask = torch.rand(E + 1, generator=gen) > 0.3
    weights = torch.rand(E + 1, generator=gen, dtype=dtype) + 0.5
    weights[::5] = 0.0
    return u, v, w, mask, weights


FACTOR_FORMS = {"plain": (False, False), "masked": (True, False), "weighted": (False, True),
                "masked_weighted": (True, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("E", [1, 5, 1030, 4099, 3_000_001])
@pytest.mark.parametrize("form", list(FACTOR_FORMS))
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset"])
def test_gather_forms_match_plain_on_card(cuda, offset, form, E, dtype):
    """The lone gather and the step direction's gather source in every form
    (plain, masked, weighted, both) bit for bit their plain versions
    (``_same_bits``: NaN and signed zero included), on 16-byte aligned
    tensors and on views one element off; one launch each."""
    u, v, w, mask, weights = _factor_inputs(E, dtype, E + 7 * offset)
    with_mask, with_weights = FACTOR_FORMS[form]
    cut = slice(offset, offset + E)
    host = (u[cut], v[cut], w, mask[cut] if with_mask else None, weights[cut] if with_weights else None)
    dev = [None if t is None else t.to(cuda) for t in (u, v, w, mask, weights)]
    card = (dev[0][cut], dev[1][cut], dev[2], dev[3][cut] if with_mask else None,
            dev[4][cut] if with_weights else None)
    K.reset_launch_counts()
    got = K.incidence_gather(*card)
    assert _same_bits(got, incidence_gather_ref(*card), incidence_gather_ref(*host))
    gen = torch.Generator().manual_seed(E)
    h = torch.rand(E + 1, generator=gen, dtype=dtype) * 2e-3
    x = torch.rand(E + 1, generator=gen, dtype=dtype)
    h[::4] = torch.finfo(dtype).tiny
    hc, xc = h.to(cuda)[cut], x.to(cuda)[cut]
    scale = float(torch.tensor(1 / 211.7, dtype=dtype))
    d_host, m_host = step_direction_ref(h[cut], x[cut], scale, gather=host)
    d_card, m_card = step_direction_ref(hc, xc, scale, gather=card)
    d, m = K.step_direction(hc, xc, scale, gather=card)
    assert _same_bits(d, d_card, d_host) and _same_bits(m, m_card, m_host)
    d_read, _ = K.step_direction(hc, xc, scale, g=got)  # the read source on the gathered g: the same d
    assert _same_bits(d_read, d_card, d_host)
    torch.cuda.synchronize()
    assert K.launch_counts()["incidence_gather"] == 1 and K.launch_counts()["step_direction"] == 2


@pytest.mark.cuda
def test_card_masked_match_lane_launches_no_lone_gather(cuda):
    """A served match lane (padded, its padded edges masked) and a padded
    weighted one: the packing gradient is gathered inside the step direction
    with the edge factor, one step_direction launch a lane iteration and no
    lone gather; the lane equals its CPU solve's status, and repeats bit for
    bit."""
    opts = MWUOptions(eps=EPS, step_rule="newton")
    padded = pad_problem(build("match", erdos(700, 2500, seed=5), device=cuda), BucketSpec(1024, 4096))
    bound = float(padded.lo)
    K.reset_launch_counts()
    lane = Solver(opts).feasible(padded, bound)
    counts = K.launch_counts()
    assert counts["incidence_gather"] == 0 and counts["step_direction"] == lane.iters > 0
    assert counts["newton_search"] == lane.iters and counts["axpy_reduce"] == 3 * lane.iters
    again = Solver(opts).feasible(padded, bound)
    assert torch.equal(again.x, lane.x) and again.iters == lane.iters
    cpu = Solver(opts).feasible(pad_problem(build("match", erdos(700, 2500, seed=5), device="cpu"),
                                            BucketSpec(1024, 4096)), bound)
    assert cpu.status == lane.status
    P, C, pm, cm = padded.instantiate(bound)
    weighted = ops.Incidence(u=P.u, v=P.v, n_vertices=P.n_vertices, edge_mask=P.edge_mask,
                             weights=torch.rand(P.u.shape[0], generator=torch.Generator(device=cuda).manual_seed(0),
                                                device=cuda, dtype=torch.float64) + 0.5)
    K.reset_launch_counts()
    res = solve(weighted, C, opts, p_mask=pm, c_mask=cm)
    counts = K.launch_counts()
    assert counts["incidence_gather"] == 0 and counts["step_direction"] == res.iters > 0


@pytest.mark.cuda
def test_new_wrappers_reject_bad_inputs(cuda):
    x = torch.rand(10, device=cuda, dtype=torch.float64)
    idx = torch.zeros(10, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        K.step_direction(x, x, 0.5)  # neither g nor gather
    with pytest.raises(TypeError):
        K.step_direction(x, x, 0.5, gather=(idx.long(), idx.long(), x))
    with pytest.raises(ValueError):
        K.step_direction(x[:5], x, 0.5, g=x)
    op = ops.Incidence(u=idx, v=idx + 1, n_vertices=2)
    with pytest.raises(ValueError):
        op.matvec(x[:9])  # 9 values for 10 edges


def _problem(family, device):
    if family in ("bmatch", "gen-match"):
        g = bipartite_ratings(60, 40, avg_ratings=6.0, seed=1)
        if family == "bmatch":
            return build("bmatch", g, device=device)
        s, deg = g.bipartite_split, g.degrees()
        lb, ub = np.zeros(g.n), np.ones(g.n)
        lb[:s] = np.minimum(1, deg[:s])
        ub[:s], ub[s:] = 5, 8
        return generalized_matching_problem(g, lb, ub, device=device)
    return build(family, rgg(8, seed=0), device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["match", "bmatch", "vcover", "dom-set", "dense-sub", "gen-match"])
def test_card_solve_matches_cpu(cuda, family):
    """The same instance on the card (CUDA kernels) and on the CPU (plain
    versions), at the solver bars of tests/test_torch_solver.py."""
    opts = MWUOptions(eps=EPS, step_rule="newton")
    cpu = Solver(opts).solve(_problem(family, "cpu"))
    K.reset_launch_counts()
    card = Solver(opts).solve(_problem(family, cuda))
    assert card.status == cpu.status == Status.FEASIBLE
    if family != "gen-match":
        assert card.bound == pytest.approx(cpu.bound, rel=1e-5)
        assert card.objective == pytest.approx(cpu.objective, rel=2 * EPS)
    counts = K.launch_counts()
    # a second card solve repeats the first bit for bit (no atomics in the scatter)
    again = Solver(opts).solve(_problem(family, cuda))
    assert (again.mwu_iters_total, again.ls_probes_total, again.feasibility_calls) == \
        (card.mwu_iters_total, card.ls_probes_total, card.feasibility_calls)
    assert np.array_equal(again.x, card.x) and _bits(again.objective) == _bits(card.objective)
    assert counts["softmax_weights"] > 0 and counts["axpy_reduce"] > 0
    assert counts["incidence_scatter"] > 0 and counts["step_direction"] == card.mwu_iters_total
    # dom-set's ops are scatter-based; match and bmatch gather inside the
    # step-direction kernel; the others' transposed products gather
    assert (counts["incidence_gather"] > 0) == (family not in ("dom-set", "match", "bmatch"))
    # every Newton search runs on the card in one launch, masked (gen-match) or not
    assert counts["newton_search"] == card.mwu_iters_total
    assert counts["linesearch_probe"] == 0


def _lane_bounds(prob, cpu_bound):
    """Four bounds around a solve's certified bound, each far enough from it
    (30% and more: the (1+eps) band is 10%) that its status does not hang
    on an ulp."""
    if prob.bound_mode == "none":
        return np.ones(4)
    return cpu_bound * np.asarray([0.5, 0.7, 1.5, 2.0])


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["match", "bmatch", "vcover", "dom-set", "dense-sub", "gen-match"])
def test_card_solve_batch_lanes_equal_feasible(cuda, family):
    """A 4-lane card batch: each lane equals the card's feasible() at its
    bound bit for bit; the statuses equal the CPU batch's at the same
    bounds; a Solver of batch_width 4 runs its rounds through solve_batch."""
    opts = MWUOptions(eps=EPS, step_rule="newton")
    solver = Solver(opts)
    prob, cpu_prob = _problem(family, cuda), _problem(family, "cpu")
    bounds = _lane_bounds(prob, solver.solve(cpu_prob).bound)
    batch = solver.solve_batch(prob, bounds)
    cpu = solver.solve_batch(cpu_prob, bounds)
    assert batch.x.shape == (4, prob.n_vars) and batch.x.device.type == "cuda"
    assert list(batch.status) == list(cpu.status)
    for j, b in enumerate(bounds):
        res = solver.feasible(prob, float(b))
        assert (int(batch.status[j]), int(batch.iters[j]), int(batch.ls_probes[j])) == \
            (res.status, res.iters, res.ls_probes), j
        assert _bits(float(batch.max_px[j])) == _bits(res.max_px) and _bits(float(batch.min_cx[j])) == _bits(res.min_cx)
        assert torch.equal(batch.x[j], res.x), j


@pytest.mark.cuda
def test_card_solve_batch_reads_once_an_iteration(cuda, monkeypatch):
    """Newton lanes of an unmasked problem read the host once a loop
    iteration for all lanes (the record), plus once to start and once to
    finish; two stacked instances run over their own operators and equal
    their own card solves."""
    prob = build("bmatch", bipartite_ratings(300, 80, avg_ratings=8.0, seed=2), device=cuda)
    prob.P.csr  # built at the operator's first card product, once
    solver = Solver(MWUOptions(eps=EPS, step_rule="newton"))
    reads = []
    for name in ("item", "tolist"):
        method = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name, lambda t, _m=method, _n=name: reads.append(_n) or _m(t))
    batch = solver.solve_batch(prob, np.geomspace(prob.lo, prob.hi, 4))
    monkeypatch.undo()
    assert len(reads) == int(batch.iters.max()) + 2 and set(reads) == {"tolist"}
    probs = [build("match", erdos(300, 1500, seed=s), device=cuda) for s in (3, 4)]
    bounds = [p.lo for p in probs]
    batch = solver.solve_batch(stack_problems(probs), bounds, batched_problem=True)
    for j, (p, b) in enumerate(zip(probs, bounds)):
        res = solver.feasible(p, b)
        assert (int(batch.status[j]), int(batch.iters[j])) == (res.status, res.iters) and torch.equal(batch.x[j], res.x)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["match", "bmatch", "vcover"])
def test_card_binary_solve_matches_cpu(cuda, family):
    """The binary step rule on the card: one launch of the binary search
    kernel a lane iteration (its step form), no lone probe; bars as above."""
    opts = MWUOptions(eps=EPS, step_rule="binary")
    cpu = Solver(opts).solve(_problem(family, "cpu"))
    K.reset_launch_counts()
    card = Solver(opts).solve(_problem(family, cuda))
    assert card.status == cpu.status == Status.FEASIBLE
    assert card.bound == pytest.approx(cpu.bound, rel=1e-5)
    assert card.objective == pytest.approx(cpu.objective, rel=2 * EPS)
    counts = K.launch_counts()
    assert counts["binary_search"] == card.mwu_iters_total
    assert counts["linesearch_probe"] == 0 and counts["newton_search"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["binary", "std"])
def test_card_rule_solve_reads_once_an_iteration(cuda, rule, monkeypatch):
    """Binary and standard lanes read the host once a loop iteration for all
    lanes (the record), plus once to start and once to finish."""
    prob = build("match", erdos(300, 1500, seed=3), device=cuda)
    prob.P.csr  # built at the operator's first card product, once
    reads = []
    for name in ("item", "tolist"):
        method = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name, lambda t, _m=method, _n=name: reads.append(_n) or _m(t))
    batch = Solver(MWUOptions(eps=EPS, step_rule=rule, max_iter=3000)).solve_batch(prob, [prob.lo, prob.hi])
    monkeypatch.undo()
    assert len(reads) == int(batch.iters.max()) + 2 and set(reads) == {"tolist"}


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [True, False], ids=["c_mask", "no_mask"])
def test_card_mpc_solve_matches_cpu(cuda, masked):
    """mpc_solve on the card (the scatter and gather kernels for its
    products) against the CPU: the same iterations, the violation trace and
    x within rel 1e-9."""
    g = bipartite_ratings(300, 140, avg_ratings=18.0, seed=0)
    deg, s = g.degrees(), g.bipartite_split
    lb, ub = np.zeros(g.n), np.ones(g.n)
    lb[:s], ub[:s], ub[s:] = np.minimum(3, deg[:s]), 5, 200
    runs = {}
    for device in ("cpu", cuda):
        P, C, mask = generalized_matching_lp(g, lb, ub, device=device)
        K.reset_launch_counts()
        runs[str(device)] = mpc_solve(P, C, MPCOptions(eps=0.05, max_iter=3000), c_mask=mask if masked else None)
        counts = K.launch_counts()
    (x_cpu, tr_cpu), (x, tr) = runs["cpu"], runs[str(cuda)]
    assert tr["iters"] == tr_cpu["iters"]
    np.testing.assert_allclose(tr["max_violation"], tr_cpu["max_violation"], rtol=1e-9, atol=0)
    np.testing.assert_allclose(x, x_cpu, rtol=1e-9, atol=0)
    assert counts["incidence_scatter"] > 0 and counts["incidence_gather"] > 0


FLASH_TOLS = {torch.float32: 3e-5, torch.bfloat16: 2e-2}  # tests/test_kernels.py


def _qkv(shape_q, shape_kv, dtype, device, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=gen).to(dtype).to(device) for s in (shape_q, shape_kv, shape_kv)]


def _check_flash(q, k, v, causal, window):
    """One kernel launch against the plain version at the bar of q's dtype."""
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's f32 products in full f32
    K.reset_launch_counts()
    got = K.flash_attention(q, k, v, causal=causal, window=window)
    ref = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert K.launch_counts()["flash_attention"] == 1
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = FLASH_TOLS[q.dtype]
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 24), (True, 200), (False, None)])
@pytest.mark.parametrize("S", [1, 16, 63, 64, 127, 128, 129, 130])
@pytest.mark.parametrize("dh", [16, 32, 64, 80, 128, 256])
def test_flash_attention_matches_plain_on_card(cuda, dh, S, causal, window, dtype):
    """The sweep of tests/test_kernels.py (GQA 4 over 2 heads) at every head dim, with S on both sides of the
    64-row warpgroup (bf16) and block (f32) edges and the 128-row tile edge (bf16; also two 64-key tiles at
    d 256), and windows inside one tile (24) and across two or more (200)."""
    q, k, v = _qkv((2, S, 4, dh), (2, S, 2, dh), dtype, cuda, S + dh)
    _check_flash(q, k, v, causal, window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(False, None), (True, 200), (False, 100)])
@pytest.mark.parametrize("dh,hq,hkv,S", [(16, 8, 2, 1500), (32, 6, 2, 1500), (64, 6, 1, 1500), (80, 16, 16, 1500),
                                         (128, 8, 1, 1500), (256, 16, 1, 1500), (256, 4, 1, 40),
                                         (256, 16, 1, 2500)])
def test_flash_attention_long_rows_on_card(cuda, dh, hq, hkv, S, causal, window, dtype):
    """Many key tiles and a ragged tail (S 1500: 11.7 bf16 tiles of 128 keys, 23.4 of 64 at d 256; 46.9 f32
    tiles of 32 up to d 80, 93.75 of 16 from d 128), GQA groups 1, 3, 4, 6, 8 and 16 (recurrentgemma's MQA);
    bidirectional, causal-windowed and bidirectional-windowed. At d 256 also tests/test_torch_flash_attention.py's
    MQA case (4 over 1 heads, S 40) and recurrentgemma's row in small (16 over 1 heads, S 2,500)."""
    q, k, v = _qkv((1, S, hq, dh), (1, S, hkv, dh), dtype, cuda, dh + S % 1500)
    _check_flash(q, k, v, causal, window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [80, 128, 256])
def test_flash_attention_ring_wraps_on_card(cuda, dh, dtype):
    """S 4096 causal at 2 heads: the key tiles pass the stage ring many times (bf16: 32 tiles through 4
    stages at d 80, 2 at 128, 64 tiles through 2 at 256; f32: 128 tiles at d 80 and 256 from d 128 through 2
    stages)."""
    q, k, v = _qkv((1, 4096, 2, dh), (1, 4096, 2, dh), dtype, cuda, 7)
    _check_flash(q, k, v, True, None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 80, 128])
def test_flash_attention_fused_qkv_views_on_card(cuda, dh, dtype):
    """q, k and v as strided views of one fused (B, S, 3, H, d) projection: the kernels read strides (the bf16
    kernel through its tensor maps), nothing is copied."""
    gen = torch.Generator().manual_seed(dh)
    qkv = torch.randn(2, 300, 3, 4, dh, generator=gen).to(dtype).to(cuda)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous() and q.stride(1) == 3 * 4 * dh
    _check_flash(q, k, v, False, None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_many_blocks_on_card(cuda, dtype):
    """B*Hq = 65,600 (batch 4,100 x 16 heads): more blocks than the 65,535 of a grid's y axis and than
    many waves of 132 SMs; both bodies take a flat grid (bf16 a persistent one)."""
    q, k, v = _qkv((4100, 3, 16, 16), (4100, 3, 16, 16), dtype, cuda, 1)
    _check_flash(q, k, v, True, None)


@pytest.mark.cuda
def test_flash_attention_rejects_bad_inputs(cuda):
    q, k, v = _qkv((1, 8, 2, 32), (1, 8, 2, 32), torch.float32, cuda, 0)
    with pytest.raises(TypeError):
        K.flash_attention(q.half(), k.half(), v.half())  # no float16 kernel
    with pytest.raises(ValueError):
        K.flash_attention(*_qkv((1, 8, 2, 48), (1, 8, 2, 48), torch.float32, cuda, 0))  # head dim 48
    with pytest.raises(ValueError):
        K.flash_attention(q, k.cpu(), v)
    wide = _qkv((1, 8, 2, 34), (1, 8, 2, 34), torch.float32, cuda, 0)
    with pytest.raises(ValueError):
        K.flash_attention(*(t[..., :32] for t in wide))  # head stride of 136 bytes: rows not 16-byte aligned
    with pytest.raises(ValueError):
        K.flash_attention(q, k[:, :, :1].expand(1, 8, 3, 32), v)  # 2 query heads over 3 kv heads
    # B*Hq 65,540 in f32 is taken (a flat grid), and matches the plain version at 3e-5
    _check_flash(*_qkv((1, 2, 65540, 16), (1, 2, 65540, 16), torch.float32, cuda, 0), True, None)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["hubert-cut", "hubert-xlarge", "minitron-4b", "starcoder2-15b", "rg-cut",
                                  "recurrentgemma-9b"])
def test_model_forward_card_matches_cpu(cuda, arch):
    """Model.forward + logits at S 40 > attn_chunk 16, attn_impl pallas, f32:
    the card (flash kernel, cuBLAS) vs the CPU (plain versions), the same
    weights. "hubert-cut" is hubert at its real d_head 80 and MHA, 2 layers
    of width 160; "rg-cut" recurrentgemma at its real d_head 256 and MQA, 5
    layers (rglru, rglru, attn, rglru, rglru) of width 128; the others are
    the configs' reduced(). Bar 1e-4 of the largest logit: f32 on both
    sides, sums in other orders."""
    torch.backends.cuda.matmul.allow_tf32 = False
    if arch == "hubert-cut":
        cfg = replace(get("hubert-xlarge"), n_layers=2, d_model=160, n_heads=2, n_kv_heads=2, d_head=80, d_ff=640,
                      attn_chunk=16, dtype="float32", param_dtype="float32", attn_impl="pallas")
    elif arch == "rg-cut":
        cfg = replace(get("recurrentgemma-9b"), n_layers=5, d_model=128, n_heads=2, n_kv_heads=1, d_head=256,
                      d_ff=256, vocab_size=256, rnn_width=128, sliding_window=16, attn_chunk=16, dtype="float32",
                      param_dtype="float32", attn_impl="pallas")
    else:
        cfg = replace(get(arch).reduced(), attn_impl="pallas")
    cpu = Model(cfg, device="cpu", seed=1)
    card = Model(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(2)
    if cfg.modality == "audio_frames":
        batch = {"frames": torch.randn(2, 40, cfg.d_model, generator=gen) * 0.02}
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 40), generator=gen)}
    K.reset_launch_counts()
    with torch.inference_mode():
        ref = cpu.logits(cpu(batch))
        got = card.logits(card({k: t.to(cuda) for k, t in batch.items()})).cpu()
    assert K.launch_counts()["flash_attention"] == cfg.pattern().count("attn")
    V = cfg.vocab_size
    assert torch.equal(got[..., V:], ref[..., V:])
    scale = ref[..., :V].abs().max()
    torch.testing.assert_close(got[..., :V] / scale, ref[..., :V] / scale, atol=1e-4, rtol=0)


# -- masked forms: padded rows of served requests, gen-match's free rows ------
def _keep(n, seed, device, share=0.6):
    gen = torch.Generator().manual_seed(seed)
    k = torch.rand(n, generator=gen) < share
    k[n // 2] = True
    return k.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 3, 1030, 300_000, 1_048_576])
def test_masked_kernels_match_plain_on_card(cuda, n, dtype):
    """The masked softmax, two-sided probe and axpy against their masked
    plain versions: the bars of tests/test_kernels.py, the mins and maxes
    exact, weights exactly 0 off the mask, the update bit-equal to the
    unmasked one."""
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    gen = torch.Generator().manual_seed(n)
    y, z = (torch.rand(n, generator=gen, dtype=dtype) for _ in range(2))
    dy, dz = (torch.rand(n, generator=gen, dtype=dtype) * 1e-3 for _ in range(2))
    ky, kz = _keep(n, 1, "cpu"), _keep(n, 2, "cpu")
    c = {k: v.to(cuda) for k, v in dict(y=y, z=z, dy=dy, dz=dz, ky=ky, kz=kz).items()}
    eta = float(10 * np.log(2 * n + 1) / 0.1)
    K.reset_launch_counts()
    for sign, v, k in ((1.0, "y", "ky"), (-1.0, "z", "kz")):
        lse, w = K.softmax_weights(c[v], eta, sign=sign, keep=c[k])
        lse_r, w_r = softmax_weights_ref(dict(y=y, z=z)[v], eta, sign=sign, keep=dict(ky=ky, kz=kz)[k])
        assert abs(float(lse) - float(lse_r)) <= tol * max(1.0, abs(float(lse_r)))
        assert float((w.cpu() - w_r).abs().max()) <= tol and not w[~c[k]].any()
    got = K.linesearch_probe2(c["y"], c["dy"], c["z"], c["dz"], 7.5, eta, p_keep=c["ky"], c_keep=c["kz"]).cpu()
    ref = linesearch_probe2_ref(y, dy, z, dz, 7.5, eta, ky, kz)
    assert float((got - ref).abs().max()) <= tol * max(1.0, float(ref.abs().max()))
    assert float(got[2]) == float(ref[2]) and float(got[5]) == float(ref[5])
    out, mn, mx = K.axpy_reduce(c["y"], c["dy"], 3.25, keep=c["ky"])
    out_r, mn_r, mx_r = axpy_reduce_ref(y, dy, 3.25, ky)
    assert torch.equal(out.cpu(), out_r) and torch.equal(out, K.axpy_reduce(c["y"], c["dy"], 3.25)[0])
    assert float(mn) == float(mn_r) and float(mx) == float(mx_r)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert (counts["softmax_weights"], counts["linesearch_probe"], counts["axpy_reduce"]) == (2, 1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [5, 9999, 1_048_576])
def test_masked_kernels_keep_unmasked_bits_on_card(cuda, n, dtype):
    """A kept row's arithmetic is the unmasked kernel's: an all-true mask
    gives the unmasked bits in every kernel (the search's record too), and a
    partial mask gives the unmasked kernel's bits on the same vectors with
    the masked-out rows sent to a = -inf (y to -inf on the sign +1 side, z
    to +inf on the sign -1 side, whose min they then leave alone)."""
    y, z, dy, dz = _search_state(n, n, "far", n, dtype, cuda)
    eta = float(10 * np.log(2 * n) / 0.1)
    ones = torch.ones(n, dtype=torch.bool, device=cuda)
    for sign, v in ((1.0, y), (-1.0, z)):
        (lse, w), (lse1, w1) = K.softmax_weights(v, eta, sign=sign), K.softmax_weights(v, eta, sign=sign, keep=ones)
        assert torch.equal(w, w1) and _bits(float(lse)) == _bits(float(lse1))
    probe = K.linesearch_probe2(y, dy, z, dz, 7.5, eta)
    assert torch.equal(probe, K.linesearch_probe2(y, dy, z, dz, 7.5, eta, p_keep=ones, c_keep=ones))
    search = K.newton_search(y, dy, z, dz, eta, 0.1, 1.0)
    assert torch.equal(search, K.newton_search(y, dy, z, dz, eta, 0.1, 1.0, p_keep=ones, c_keep=ones))
    out, mn, mx = K.axpy_reduce(y, dy, 3.25)
    out1, mn1, mx1 = K.axpy_reduce(y, dy, 3.25, keep=ones)
    assert torch.equal(out, out1) and (float(mn), float(mx)) == (float(mn1), float(mx1))

    ky, kz = _keep(n, 3, cuda), _keep(n, 4, cuda)
    y_off, z_off = torch.where(ky, y, -torch.inf), torch.where(kz, z, torch.inf)
    lse, w = K.softmax_weights(y, eta, keep=ky)
    lse_u, w_u = K.softmax_weights(y_off, eta)
    assert torch.equal(w, w_u) and _bits(float(lse)) == _bits(float(lse_u))
    got = K.linesearch_probe2(y, dy, z, dz, 7.5, eta, p_keep=ky, c_keep=kz).tolist()
    unm = K.linesearch_probe2(y_off, dy, z_off, dz, 7.5, eta).tolist()
    assert [_bits(v) for v in got[:2] + got[3:]] == [_bits(v) for v in unm[:2] + unm[3:]]
    assert got[2] == float(torch.where(ky, y + 7.5 * dy, torch.inf).min())


@pytest.mark.cuda
@pytest.mark.parametrize("alpha0", [None, 1.0, 37.0])
@pytest.mark.parametrize("kind", ["far", "near", "done", "below"])
@pytest.mark.parametrize("n", [12, 9999, 1_048_576])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_masked_newton_search_matches_host_loop_on_card(cuda, dtype, n, kind, alpha0):
    """The masked search kernel in both forms against the host loop over the
    masked probe kernel (stepsize._newton_step_host with the masks): alpha
    bit for bit, probes and completes equal, step and bad as Alg. 2 decides
    them; and within ls_eps of its plain version (the masked host loop over
    plain probes) on the far, near and done states, as the unmasked
    near-plain test holds them (the "below" states back off to alpha ~1e-7,
    where f32 probes are rounding noise)."""
    y, z, dy, dz = _search_state(n, n, kind, n, dtype, cuda)
    pm, cm = _keep(n, 5, cuda), _keep(n, 6, cuda)
    eta = float(10 * np.log(2 * n) / 0.1) if n > 12 else 50.0
    host = stepsize._newton_step_host(y, z, dy, dz, eta, pm, cm, ls_eps=0.1, alpha0=alpha0)
    K.reset_launch_counts()
    got = stepsize.newton_step(y, z, dy, dz, eta, pm, cm, ls_eps=0.1, alpha0=alpha0)
    assert K.launch_counts()["newton_search"] == 1 and K.launch_counts()["linesearch_probe"] == 0
    assert (_bits(got.alpha), got.probes, got.completes) == (_bits(host.alpha), host.probes, host.completes)
    if kind != "below":
        alpha, _, completes = newton_search_ref(y, dy, z, dz, eta, 0.1, alpha0, pm, cm).tolist()
        assert got.completes == bool(completes) and abs(got.alpha - alpha) <= 0.1 * max(got.alpha, alpha)
    start = 1.0 if alpha0 is None else alpha0
    host = stepsize._newton_step_host(y, z, dy, dz, eta, pm, cm, ls_eps=0.1, alpha0=start)
    for d_max in (1e-3, 0.0):
        alpha_prev = torch.tensor([start], dtype=torch.float64, device=cuda)
        rec = stepsize.newton_step_record(y, z, dy, dz, eta, 0.1, torch.tensor(d_max, dtype=dtype, device=cuda),
                                          alpha_prev, p_mask=pm, c_mask=cm).tolist()
        assert (_bits(rec[0]), int(rec[1]), bool(rec[2])) == (_bits(host.alpha), host.probes, host.completes)
        bad = d_max <= 0 or host.alpha < 1
        assert bool(rec[4]) == bad and _bits(rec[3]) == _bits(0.0 if bad else host.alpha)
        assert _bits(float(alpha_prev)) == _bits(start if bad else host.alpha)


@pytest.mark.cuda
@pytest.mark.parametrize("alpha0", [None, 1.0, 37.0])
@pytest.mark.parametrize("kind", ["far", "near", "done", "below"])
@pytest.mark.parametrize("n", [12, 9999, 1_048_576])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_masked_binary_search_matches_host_loop_on_card(cuda, dtype, n, kind, alpha0):
    """The masked binary search kernel in both forms against the host loop
    over the masked probe kernel (stepsize._binary_search_step_host with
    the masks): alpha bit for bit, probes and completes equal, step and bad
    as Alg. 2 decides them; and within ls_eps of its plain version (the
    masked host loop over plain probes) where alpha >= 1."""
    y, z, dy, dz = _search_state(n, n, kind, n, dtype, cuda)
    pm, cm = _keep(n, 5, cuda), _keep(n, 6, cuda)
    eta = float(10 * np.log(2 * n) / 0.1) if n > 12 else 50.0
    host = stepsize._binary_search_step_host(y, z, dy, dz, eta, pm, cm, ls_eps=0.1, alpha0=alpha0)
    K.reset_launch_counts()
    got = stepsize.binary_search_step(y, z, dy, dz, eta, pm, cm, ls_eps=0.1, alpha0=alpha0)
    assert K.launch_counts()["binary_search"] == 1 and K.launch_counts()["linesearch_probe"] == 0
    assert (_bits(got.alpha), got.probes, got.completes) == (_bits(host.alpha), host.probes, host.completes)
    if host.alpha >= 1:
        alpha, _, completes = binary_search_ref(y, dy, z, dz, eta, 0.1, alpha0, pm, cm).tolist()
        assert got.completes == bool(completes) and abs(got.alpha - alpha) <= 0.1 * max(got.alpha, alpha)
    start = 1.0 if alpha0 is None else alpha0
    host = stepsize._binary_search_step_host(y, z, dy, dz, eta, pm, cm, ls_eps=0.1, alpha0=start)
    for d_max in (1e-3, 0.0):
        alpha_prev = torch.tensor([start], dtype=torch.float64, device=cuda)
        rec = stepsize.binary_step_record(y, z, dy, dz, eta, 0.1, torch.tensor(d_max, dtype=dtype, device=cuda),
                                          alpha_prev, p_mask=pm, c_mask=cm).tolist()
        assert (_bits(rec[0]), int(rec[1]), bool(rec[2])) == (_bits(host.alpha), host.probes, host.completes)
        bad = d_max <= 0 or host.alpha < 1
        assert bool(rec[4]) == bad and _bits(rec[3]) == _bits(0.0 if bad else host.alpha)
        assert _bits(float(alpha_prev)) == _bits(start if bad else host.alpha)


@pytest.mark.cuda
def test_card_wrappers_reject_bad_masks(cuda):
    x = torch.rand(10, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        K.softmax_weights(x, 1.0, keep=torch.ones(10, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        K.axpy_reduce(x, x, 1.0, keep=torch.ones(9, dtype=torch.bool, device=cuda))
    with pytest.raises(ValueError):
        K.linesearch_probe2(x, x, x, x, 1.0, 1.0, c_keep=torch.ones(10, dtype=torch.bool))  # on the host
    with pytest.raises(ValueError):
        K.newton_search(x, x, x, x, 1.0, 0.1, p_keep=torch.ones(20, dtype=torch.bool, device=cuda)[::2])


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["match", "vcover"])
def test_card_lpserve_round_lanes_equal_feasible(cuda, family, monkeypatch):
    """Served requests on the card: each lane of each engine round equals
    feasible() of its padded request at its bound, bit for bit; a round
    whose requests' CSR exists reads the host once a loop iteration plus
    three times (start, finish, the lanes' x); no round calls the host
    loop of the search; the engine's answers agree with the CPU engine's
    (found, feasible, objective within 2*eps)."""
    opts = MWUOptions(eps=EPS, step_rule="newton")
    sizes = [(300, 1500), (500, 1800), (420, 1200)]

    def probs(device):
        return [build(family, erdos(*sizes[i], seed=i), device=device) for i in range(3)]

    rounds, reads, counting = [], [], [False]
    solve_stack = Solver.solve_stack

    def record(self, problems, bounds):
        n = len(reads)
        batch = solve_stack(self, problems, bounds)
        rounds.append((list(problems), list(bounds), batch, len(reads) - n))
        return batch

    for name in ("item", "tolist", "cpu"):
        method = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name,
                            lambda t, *a, _m=method, _n=name, **k: (counting[0] and reads.append(_n)) or _m(t, *a, **k))
    monkeypatch.setattr(Solver, "solve_stack", record)
    monkeypatch.setattr(stepsize, "_newton_step_host", None)  # a call would raise
    engine = LPEngine(LPServeConfig(opts=opts, lanes=4))
    for p in probs(cuda):
        engine.submit(p)
    engine.step()  # the first round builds the requests' CSR
    counting[0] = True
    engine.run()
    counting[0] = False
    monkeypatch.undo()
    assert len(rounds) >= 2
    for problems, bounds, batch, n_reads in rounds[1:]:
        assert n_reads <= int(batch.iters.max()) + 3, (n_reads, batch.iters)
    solver = Solver(opts)
    for problems, bounds, batch, _ in rounds:
        for j, (p, b) in enumerate(zip(problems, bounds)):
            res = solver.feasible(p, b)
            assert (int(batch.status[j]), int(batch.iters[j]), int(batch.ls_probes[j])) == \
                (res.status, res.iters, res.ls_probes)
            assert _bits(float(batch.min_cx[j])) == _bits(res.min_cx) and torch.equal(batch.x[j], res.x)
    cpu = LPEngine(LPServeConfig(opts=opts, lanes=4)).solve_many(probs("cpu"))
    for r, want in enumerate(cpu):
        got = engine.result(r)
        assert (got.found, got.feasible) == (want.found, want.feasible) == (True, True)
        assert got.objective == pytest.approx(want.objective, rel=2 * EPS)


@pytest.mark.cuda
def test_card_padded_solve_is_masked_on_card(cuda):
    """A padded request solved alone on the card: the same status, bound and
    objective bars against the unpadded card solve and the padded CPU
    solve, padded variables frozen, every search on the card."""
    opts = MWUOptions(eps=EPS, step_rule="newton")
    prob = build("match", erdos(700, 2500, seed=5), device=cuda)
    padded = pad_problem(prob, BucketSpec(1024, 4096))
    K.reset_launch_counts()
    got = Solver(opts, batch_width=1).solve(padded)
    counts = K.launch_counts()
    plain = Solver(opts, batch_width=1).solve(prob)
    cpu = Solver(opts, batch_width=1).solve(pad_problem(build("match", erdos(700, 2500, seed=5), device="cpu"),
                                                         BucketSpec(1024, 4096)))
    assert got.feasible and cpu.feasible and plain.feasible
    assert got.bound == pytest.approx(cpu.bound, rel=1e-5) and got.objective == pytest.approx(cpu.objective, rel=2 * EPS)
    assert abs(got.objective - plain.objective) <= EPS * plain.objective
    assert np.ptp(got.x[prob.n_vars:]) == 0.0
    assert counts["newton_search"] == got.mwu_iters_total and counts["linesearch_probe"] == 0


@pytest.mark.cuda
def test_rglru_scan_matches_decode_loop_on_card(cuda):
    """The reference's identity (tests/test_layers.py) on the card at f32: the full-sequence scan equals a
    loop of decode steps from an empty state, at recurrentgemma's reduced widths and S 300 (9 doubling steps)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get("recurrentgemma-9b").reduced()
    p = rg.rglru_init(torch.Generator(device=cuda).manual_seed(0), cfg, torch.float32, cuda)
    x = torch.randn(2, 300, cfg.d_model, generator=torch.Generator(device=cuda).manual_seed(1), device=cuda) * 0.3
    with torch.inference_mode():
        out, _ = rg.rglru_apply(p, x, cfg)
        state, outs = rg.init_rglru_state(cfg, 2, device=cuda), []
        for t in range(x.shape[1]):
            o, state = rg.rglru_decode(p, x[:, t:t + 1], cfg, state)
            outs.append(o)
    torch.testing.assert_close(out, torch.cat(outs, dim=1), atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_rglru_scan_matches_sequential_loop_on_card(cuda):
    """The doubling scan at recurrentgemma-9b's forward shape (B 2, S 8192, w 4096, f32) against a sequential
    f64 loop, with a in (0.9, 0.999) so that the carry lives for hundreds of steps and every doubling step and
    product of a counts (at the init's a of ~0.007 the decode identity above cannot see them). Bar 1e-5,
    relative L2 and elementwise of 1 + |h| (~1e-7 on the CPU)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    a = 0.9 + 0.099 * torch.rand(2, 8192, 4096, generator=gen, device=cuda)
    b = torch.randn(2, 8192, 4096, generator=gen, device=cuda)
    h = rg._scan(a, b).double()
    ref, hd = torch.empty_like(h), torch.zeros_like(h[:, 0])
    for t in range(a.shape[1]):
        hd = torch.addcmul(b[:, t].double(), a[:, t].double(), hd)
        ref[:, t] = hd
    assert ((h - ref).norm() / ref.norm()).item() <= 1e-5
    assert bool(((h - ref).abs() <= 1e-5 * (1 + ref.abs())).all())


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["match", "bmatch", "vcover", "dom-set"])
def test_card_identity_plan_equals_solver(cuda, family):
    """MeshPlan() on the card: DistSolver's search and batch equal Solver's bit for bit."""
    from repro_torch.dist import DistSolver, MeshPlan

    g = bipartite_ratings(400, 90, avg_ratings=9.0, seed=2) if family == "bmatch" else erdos(600, 2400, seed=3)
    prob = build(family, g, device=cuda)
    opts = MWUOptions(eps=EPS)
    ref, got = Solver(opts).solve(prob), DistSolver(opts, plan=MeshPlan()).solve(prob)
    assert (got.status, got.objective, got.bound, got.feasibility_calls, got.mwu_iters_total) == (
        ref.status, ref.objective, ref.bound, ref.feasibility_calls, ref.mwu_iters_total)
    assert np.array_equal(got.x, ref.x)
    bounds = [prob.lo, (prob.lo * prob.hi) ** 0.5, prob.hi]
    a, b = Solver(opts).solve_batch(prob, bounds), DistSolver(opts, plan=MeshPlan()).solve_batch(prob, bounds)
    assert torch.equal(a.x, b.x) and np.array_equal(a.iters, b.iters) and np.array_equal(a.max_px, b.max_px)


DIST_CARD_CODE = """
import hashlib
import numpy as np
from repro_torch import kernels as K
from repro_torch.api import MWUOptions, Solver
from repro_torch.dist import DistSolver, MeshPlan
from repro_torch.graphs import bipartite_ratings, build, erdos

report = {"rank": RANK}
for family, g in [("bmatch", bipartite_ratings(3000, 400, avg_ratings=12.0, seed=4)), ("vcover", erdos(900, 3500, seed=5))]:
    prob = build(family, g, device="cuda")
    K.reset_launch_counts()
    sol = DistSolver(MWUOptions(eps=0.1), plan=MeshPlan(pod=2)).solve(prob)
    launches = K.launch_counts()
    one = Solver(MWUOptions(eps=0.1)).solve(prob)
    x = sol.x
    if family == "bmatch":  # max Mx on the host
        cert = float((np.bincount(g.u, x, g.n) + np.bincount(g.v, x, g.n)).max())
    else:  # min over edges of x[u] + x[v]
        cert = float((x[g.u] + x[g.v]).min())
    report[family] = {"status": int(sol.status), "objective": sol.objective, "bound": sol.bound,
                      "iters": sol.mwu_iters_total, "x": hashlib.sha256(x.tobytes()).hexdigest(), "cert": cert,
                      "single_objective": one.objective, "launches": launches, "device": str(sol.last_result.x.device)}
print(json.dumps(report))
"""


@pytest.mark.cuda
def test_card_two_ranks_share_the_card(cuda):
    """Two gloo ranks on cuda:0 with MeshPlan(pod=2): edge slabs (bmatch) and
    column slabs (vcover) through the CUDA kernels; both ranks return the same
    result, which passes its certificate on the host and lies within 2*eps of
    the single-device solve's objective."""
    from test_torch_ranks import run_ranks

    ranks = run_ranks(DIST_CARD_CODE, world=2, timeout=600.0)
    assert ranks[0]["bmatch"] == ranks[1]["bmatch"] and ranks[0]["vcover"] == ranks[1]["vcover"]
    b, v = ranks[0]["bmatch"], ranks[0]["vcover"]
    assert b["status"] == v["status"] == Status.FEASIBLE
    assert b["cert"] <= 1 + 1e-9 and v["cert"] >= 1 - 1e-9
    for d in (b, v):
        assert d["objective"] == pytest.approx(d["single_objective"], rel=2 * EPS)
        assert d["device"].startswith("cuda")
    # the slab runs went through the kernels: the step direction once a lane
    # iteration on each rank, the scatter and the search too
    for d in (b, v):
        assert d["launches"]["step_direction"] == d["iters"] and d["launches"]["newton_search"] == d["iters"]
        assert d["launches"]["incidence_scatter"] > 0 and d["launches"]["axpy_reduce"] == 3 * d["iters"]
    assert b["launches"]["incidence_gather"] == 0  # edge slabs, padded or not, gather inside the step direction


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_card_slab_scatter_zero_rows_and_repeats(cuda, dtype):
    """An edge slab's operator (repro_torch.dist.pod_slab) keeps the global
    vertex rows with only its own edges, one of them padded and masked: its
    card product equals the plain version on the CPU (the rows of no slab
    edge exactly 0) and repeats bit for bit."""
    from repro_torch.dist import pod_slab

    g = bipartite_ratings(5000, 700, avg_ratings=11.0, seed=6)
    prob = build("bmatch", g, device="cpu", dtype=dtype)
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    pod = next(p for p in (2, 3, 4, 5, 6, 7) if g.m % p)  # an edge count that pads
    for k in range(pod):
        P = pod_slab(prob, pod, k).P
        assert P.edge_mask is not None and bool(P.edge_mask.all()) == (k < pod - 1)
        x = torch.rand(P.u.shape[0], generator=torch.Generator().manual_seed(k), dtype=dtype)
        want = P.matvec(x)
        card = ops.Incidence(u=P.u.to(cuda), v=P.v.to(cuda), n_vertices=P.n_vertices,
                             edge_mask=P.edge_mask.to(cuda))
        got = card.matvec(x.to(cuda))
        assert torch.equal(got, card.matvec(x.to(cuda)))
        empty = want == 0
        assert bool(empty.any()) and bool((got.cpu()[empty] == 0).all())
        assert float(((got.cpu() - want).abs() / want.abs().clamp(min=1.0)).max()) <= tol


def _router_logits(T: int, E: int, seed: int) -> torch.Tensor:
    return torch.randn(1, T, E, generator=torch.Generator().manual_seed(seed))


@pytest.mark.cuda
@pytest.mark.parametrize("T, E, k", [(256, 8, 2), (6144, 8, 2), (768, 16, 4)])
def test_moe_router_lp_card_matches_cpu(cuda, T, E, k):
    """chip_smoke.py phase 9 (a) at three shapes (mixtral's T 6,144 x E 8
    among them): the routing LP on the card vs the CPU. f64 over the whole
    budget: x within 1e-4, the same iterations, probes and status, the same
    routes on tokens past the 1e-4 margin. f32 (the forward's LP) over its
    first three iterations, before rounding grows (tests/test_torch_moe.py's
    docstring): x within 1e-4, the same probes."""
    from repro_torch.core import solve_lanes
    from repro_torch.models.layers import moe

    logits = _router_logits(T, E, T + E)
    cap = max(8, -(-int(np.ceil(T * k * 1.25 / E)) // 8) * 8)
    opts = moe.router_options(16)
    p64 = torch.softmax(logits[0].double(), dim=-1)
    card = solve_lanes([(*moe.routing_ops(p64.to(cuda), k, cap), None, None)], opts).lane(0)
    cpu = solve_lanes([(*moe.routing_ops(p64, k, cap), None, None)], opts).lane(0)
    assert (card.iters, card.ls_probes, card.status) == (cpu.iters, cpu.ls_probes, cpu.status)
    x_card, x_cpu = card.x.cpu().reshape(T, E), cpu.x.reshape(T, E)
    assert float((x_card - x_cpu).abs().max()) <= 1e-4
    idx_card, _ = moe.round_plan(x_card, p64, k, torch.float64)
    idx_cpu, _ = moe.round_plan(x_cpu, p64, k, torch.float64)
    s = torch.sort(x_cpu + 1e-6 * p64, dim=-1, descending=True).values
    past = s[:, k - 1] - s[:, k] > 1e-4
    assert torch.equal(torch.sort(idx_card, -1).values[past], torch.sort(idx_cpu, -1).values[past])
    _, card3 = moe.routing_lp(logits.to(cuda), k, cap, 3)
    _, cpu3 = moe.routing_lp(logits, k, cap, 3)
    assert card3.ls_probes.tolist() == cpu3.ls_probes.tolist() and card3.iters.tolist() == cpu3.iters.tolist()
    assert float((card3.x.cpu() - cpu3.x).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("router", ["topk", "mwu"])
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "dbrx-132b"])
def test_moe_dispatch_combine_match_expert_loop_on_card(cuda, arch, router):
    """Phase 9 (b) at the reduced width: moe_apply at capacity_factor = E
    (no token dropped), f32 with TF32 off, against a loop over the experts
    on the card within 2e-4 (tests/test_layers.py:172); and the forward's
    bf16 layer repeats bit for bit."""
    import torch.nn.functional as F

    from repro_torch.models.layers import moe

    cfg = get(arch).reduced()
    cfg = replace(cfg, moe=replace(cfg.moe, router=router, capacity_factor=float(cfg.moe.n_experts)))
    m = cfg.moe
    gen = torch.Generator(device=cuda).manual_seed(3)
    p = moe.moe_init(gen, cfg, torch.float32, cuda)
    x = torch.randn(2, 300, cfg.d_model, generator=gen, device=cuda)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = moe.moe_apply(p, x, cfg).reshape(-1, cfg.d_model)
        xt = x.reshape(-1, cfg.d_model)
        logits = (x.reshape(1, -1, cfg.d_model) @ p["router"]).float()
        _, cap = moe.dispatch_shape(cfg, xt.shape[0])
        idx, gate = moe.topk_route(logits, m.top_k) if router == "topk" else moe.mwu_route(logits, m.top_k, cap)
        idx, gate = idx[0], gate[0]
        y = torch.zeros_like(xt)
        for e in range(m.n_experts):
            oe = (F.silu(xt @ p["wg"][e]) * (xt @ p["wu"][e])) @ p["wd"][e]
            for j in range(m.top_k):
                sel = idx[:, j] == e
                y[sel] += gate[sel, j, None] * oe[sel]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert bool(((got - y).abs() <= 2e-4 * (1 + y.abs())).all())
    xb = x.to(torch.bfloat16)
    assert torch.equal(moe.moe_apply(p, xb, cfg), moe.moe_apply(p, xb, cfg))


@pytest.mark.cuda
def test_moe_router_lanes_equal_their_own_solves_on_card(cuda):
    """Phase 9 (c): logits split into two dispatch groups run as two lanes of
    one solve_lanes call on the card; each equals its own G 1 solve bit for
    bit (x, iterations, probes), and a second run repeats."""
    from repro_torch.models.layers import moe

    logits = _router_logits(6144, 8, 11).reshape(2, 3072, 8).to(cuda)
    k, cap = 2, 960
    _, both = moe.routing_lp(logits, k, cap, 16)
    for g in range(2):
        _, alone = moe.routing_lp(logits[g:g + 1], k, cap, 16)
        assert torch.equal(both.x[g], alone.x[0])
        assert (both.iters[g], both.ls_probes[g]) == (alone.iters[0], alone.ls_probes[0])
    K.reset_launch_counts()
    _, again = moe.routing_lp(logits, k, cap, 16)
    assert torch.equal(again.x, both.x)
    n = int(again.iters.sum())
    counts = K.launch_counts()
    assert counts["newton_search"] == counts["step_direction"] == n and counts["axpy_reduce"] == 3 * n
    assert counts["softmax_weights"] == 2 * n and counts["incidence_scatter"] == counts["incidence_gather"] == 0


# -- KV cache, prefill, decode and the serving engine -------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "recurrentgemma-9b"])
def test_prefill_flash_matches_chunked_on_card(cuda, arch):
    """Prefill of 40 tokens (past the window 16 and attn_chunk 16) at f32
    with TF32 off: with ``pallas`` (the flash kernel once an attn layer)
    against ``chunked`` on the card, the same weights: the last logits and
    every cache within 1e-4 of their scale; then a decode step on each."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = replace(get(arch).reduced(), attn_impl="pallas")
    if cfg.moe is not None:
        cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    model = Model(cfg, device=cuda, seed=1)
    toks = torch.randint(0, cfg.vocab_size, (2, 41), generator=torch.Generator().manual_seed(2)).to(cuda)
    out = {}
    for impl in ("pallas", "chunked"):
        model.cfg = replace(cfg, attn_impl=impl)
        K.reset_launch_counts()
        with torch.inference_mode():
            lg, caches = model.prefill({"tokens": toks[:, :40]}, 64)
            step, _ = model.decode_step(caches, toks[:, 40:])
        flash = K.launch_counts()["flash_attention"]
        assert flash == (cfg.pattern().count("attn") if impl == "pallas" else 0)
        out[impl] = (lg, caches, step)
    (lg, ca, st), (lg2, ca2, st2) = out["pallas"], out["chunked"]
    for a, b in [(lg, lg2), (st, st2)] + [(x, y) for c, c2 in zip(ca.layers, ca2.layers) for x, y in zip(c, c2)]:
        if a.dtype.is_floating_point:
            scale = b.abs().max().clamp(min=1.0)
            torch.testing.assert_close(a / scale, b / scale, atol=1e-4, rtol=0)
        else:
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_decode_repeats_bit_for_bit_on_card(cuda):
    """mixtral-8x22b-mwu, bf16 compute: prefill then 8 decode steps, twice
    from the same caches: the same logits bit for bit (the router's LP on
    the card, the combine without atomics)."""
    cfg = replace(get("mixtral-8x22b-mwu").reduced(), dtype="bfloat16", attn_impl="pallas")
    model = Model(cfg, device=cuda, seed=4)
    toks = torch.randint(0, cfg.vocab_size, (4, 48), generator=torch.Generator().manual_seed(5)).to(cuda)
    with torch.inference_mode():
        _, start = model.prefill({"tokens": toks[:, :40]}, 64)
        runs = []
        for _ in range(2):
            caches, logits = start, []
            for t in range(40, 48):
                lg, caches = model.decode_step(caches, toks[:, t:t + 1])
                logits.append(lg)
            runs.append(torch.cat(logits, dim=1))
    assert torch.equal(runs[0], runs[1]) and bool(torch.isfinite(runs[0]).all())


@pytest.mark.cuda
def test_engine_launches_on_card(cuda):
    """Engine.generate with the mwu router on the card: no flash launch
    while decoding, and the router's kernels once (search, step direction),
    twice (softmax) and three times (axpy) a router lane iteration, nothing
    else; two engines over the same model give the same tokens."""
    from repro_torch.models.layers import moe
    from repro_torch.serve import Engine, ServeConfig

    cfg = get("mixtral-8x22b-mwu").reduced()
    model = Model(cfg, device=cuda, seed=6)
    prompts = [np.arange(1, n + 1, dtype=np.int32) * 7 % cfg.vocab_size for n in (5, 9, 12)]
    iters = []
    lp = moe.routing_lp

    def counting(*a, **kw):
        probs, res = lp(*a, **kw)
        iters.append(int(res.iters.sum()))
        return probs, res

    moe.routing_lp = counting
    try:
        outs = []
        for _ in range(2):
            eng = Engine(cfg, ServeConfig(max_len=32, slots=4), device=cuda)
            eng.load(model)
            iters.clear()
            K.reset_launch_counts()
            outs.append(eng.generate(prompts, max_new=6))
            counts = K.launch_counts()
    finally:
        moe.routing_lp = lp
    assert outs[0] == outs[1]
    steps = max(len(p) for p in prompts) + 6 - 1
    assert len(iters) == steps * cfg.n_layers
    n = sum(iters)
    want = dict(newton_search=n, step_direction=n, softmax_weights=2 * n, axpy_reduce=3 * n)
    assert counts == {name: want.get(name, 0) for name in counts}, (counts, want)


# -- training ----------------------------------------------------------------
def _train_batch(cfg, device, B=2, S=32):
    from repro_torch.data import TokenPipeline

    return {k: torch.from_numpy(v).to(device) for k, v in TokenPipeline(cfg.vocab_size, S, B, seed=0).batch_at(0).items()}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["minitron-4b", "mixtral-8x22b", "recurrentgemma-9b"])
def test_train_step_card_matches_cpu(cuda, arch):
    """A reduced train step on the card against the same step on the CPU, f32
    with TF32 off: the loss within rel 1e-5, every gradient within 1e-4 of its
    tensor's largest CPU entry (sums in other orders), then the AdamW step's
    parameters within 2 lr where the CPU gradient is below 1e-4 of its
    tensor's largest entry (the first step is ~lr sign(g)) and 1e-4 lr plus 2
    ulp elsewhere; the card's step repeats bit for bit."""
    from repro_torch.train import AdamWConfig, chunked_ce_loss, make_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    cfg = get(arch).reduced()
    cpu = Model(cfg, device="cpu", seed=3)
    init = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    loss_cpu = chunked_ce_loss(cpu, _train_batch(cfg, "cpu"))
    loss_cpu.backward()
    grads = {n: p.grad.clone() for n, p in cpu.named_parameters()}
    make_train_step(cpu, opt)(make_train_state(cpu), _train_batch(cfg, "cpu"))
    runs = []
    for _ in range(2):
        card = Model(cfg, device=cuda)
        with torch.no_grad():
            for n, p in card.named_parameters():
                p.copy_(init[n])
        loss = chunked_ce_loss(card, _train_batch(cfg, cuda))
        loss.backward()
        g = {n: p.grad.cpu() for n, p in card.named_parameters()}
        _, m = make_train_step(card, opt)(make_train_state(card), _train_batch(cfg, cuda))
        runs.append((loss.item(), g, float(m["loss"]), {n: p.detach().cpu() for n, p in card.named_parameters()}))
    assert runs[0][0] == runs[1][0] and runs[0][2] == runs[1][2]
    assert all(torch.equal(runs[0][3][n], runs[1][3][n]) for n in init)
    loss, g, _, after = runs[0]
    torch.testing.assert_close(loss, loss_cpu.item(), rtol=1e-5, atol=0)
    lr = 5e-4  # lr_at(opt, 0)
    for n, p in cpu.named_parameters():
        scale = grads[n].abs().max().clamp(min=1e-30)
        assert ((g[n] - grads[n]).abs() <= 1e-4 * scale).all(), n
        small = grads[n].abs() <= 1e-4 * scale
        bar = torch.where(small, 2 * lr * 1.1, 1e-4 * lr) + 2 * torch.finfo(torch.float32).eps * p.detach().abs() + 1e-9
        assert ((after[n] - p.detach()).abs() <= bar).all(), n


@pytest.mark.cuda
def test_mwu_train_step_repeats_and_launches_on_card(cuda):
    """mixtral-8x22b-mwu reduced with remat="full" on the card: the router's
    LP runs in the forward and again in the recompute, so one step launches
    the router's kernels for two LP solves a layer (search and step
    direction once, softmax twice, axpy three times a lane iteration, no
    flash); two steps from the same state give the same loss and
    parameters bit for bit."""
    from repro_torch.models.layers import moe
    from repro_torch.train import AdamWConfig, make_train_state, make_train_step

    cfg = replace(get("mixtral-8x22b-mwu").reduced(), remat="full", dtype="bfloat16")
    iters = []
    lp = moe.routing_lp

    def counting(*a, **kw):
        probs, res = lp(*a, **kw)
        iters.append(int(res.iters.sum()))
        return probs, res

    moe.routing_lp = counting
    runs = []
    try:
        for _ in range(2):
            model = Model(cfg, device=cuda, seed=5)
            iters.clear()
            K.reset_launch_counts()
            _, m = make_train_step(model, AdamWConfig())(make_train_state(model), _train_batch(cfg, cuda))
            counts = K.launch_counts()
            runs.append((float(m["loss"]), [p.detach().cpu() for p in model.parameters()]))
    finally:
        moe.routing_lp = lp
    assert runs[0][0] == runs[1][0] and all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    assert len(iters) == 2 * cfg.n_layers
    n = sum(iters)
    want = dict(newton_search=n, step_direction=n, softmax_weights=2 * n, axpy_reduce=3 * n)
    assert counts == {name: want.get(name, 0) for name in counts}, (counts, want)


# -- the ssm block kind and the vision_text modality ---------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("G, S", [(1, 300), (2, 77)])
def test_ssm_ssd_card_matches_cpu(cuda, G, S):
    """_ssd_chunked on the card against the same code on the CPU, f32 with
    TF32 off (chunk 64: S 300 pads the last chunk, S 77 two chunks): y and
    the final state within 1e-5 of their scale."""
    from repro_torch.models.layers import mamba2 as m2

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(S)
    x = torch.randn(2, S, 8, 16, generator=gen)
    dt = torch.rand(2, S, 8, generator=gen) * 0.5 + 0.05
    A = torch.log(torch.rand(8, generator=gen) * 4 + 0.5)
    Bm, Cm = (torch.randn(2, S, G, 32, generator=gen) for _ in range(2))
    want = m2._ssd_chunked(x, dt, A, Bm, Cm, chunk=64)
    got = m2._ssd_chunked(*(t.to(cuda) for t in (x, dt, A, Bm, Cm)), chunk=64)
    for g, w in zip(got, want):
        scale = w.abs().max()
        torch.testing.assert_close(g.cpu() / scale, w / scale, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_ssm_layer_and_decode_card_match_cpu(cuda):
    """mamba2_apply over 40 tokens with a fresh state, then 8 mamba2_decode
    steps, on the card against the CPU at f32 with TF32 off (reduced widths,
    chunk 8): outputs and states within 1e-5 of their scale."""
    from repro_torch.models.layers import mamba2 as m2

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get("mamba2-1.3b").reduced()
    p = m2.mamba2_init(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    x = torch.randn(2, 48, cfg.d_model, generator=torch.Generator().manual_seed(1)) * 0.3
    runs = []
    for dev in ("cpu", cuda):
        pd = {k: v.to(dev) for k, v in p.items()}
        out, state = m2.mamba2_apply(pd, x[:, :40].to(dev), cfg, state=m2.init_ssm_state(cfg, 2, device=dev), start=0)
        outs = [out]
        for t in range(40, 48):
            o, state = m2.mamba2_decode(pd, x[:, t:t + 1].to(dev), cfg, state)
            outs.append(o)
        runs.append([torch.cat(outs, dim=1), state.conv, state.ssm])
    for g, w in zip(runs[1], runs[0]):
        scale = w.abs().max().clamp(min=1.0)
        torch.testing.assert_close(g.cpu() / scale, w / scale, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_ssm_model_decode_matches_forward_on_card(cuda):
    """mamba2 reduced on the card, f32 with TF32 off: a prefill of 40 tokens
    and 8 decode steps, each step's logits within 5e-3 of the forward over
    all the tokens (tests/test_layers.py's bar); the bf16 run repeats bit
    for bit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get("mamba2-1.3b").reduced()
    toks = torch.randint(0, cfg.vocab_size, (2, 48), generator=torch.Generator().manual_seed(2)).to(cuda)
    model = Model(cfg, device=cuda, seed=1)
    with torch.inference_mode():
        full = model.logits(model({"tokens": toks}))
        lg, caches = model.prefill({"tokens": toks[:, :40]}, 64)
        outs = []
        for t in range(40, 48):
            outs.append(lg)
            lg, caches = model.decode_step(caches, toks[:, t:t + 1])
        torch.testing.assert_close(torch.cat(outs + [lg], dim=1), full[:, 39:], atol=5e-3, rtol=5e-3)
        bf = Model(replace(cfg, dtype="bfloat16"), device=cuda, seed=1)
        runs = []
        for _ in range(2):
            lg, caches = bf.prefill({"tokens": toks[:, :40]}, 64)
            for t in range(40, 48):
                lg, caches = bf.decode_step(caches, toks[:, t:t + 1])
            runs.append(lg)
    assert torch.equal(runs[0], runs[1]) and bool(torch.isfinite(runs[0]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "internvl2-26b"], ids=["ssm", "vlm"])
def test_ssm_vlm_train_step_card_matches_cpu(cuda, arch):
    """A reduced train step of mamba2 (the ssm stack) and internvl2 (patches
    before the tokens) on the card against the CPU, f32 with TF32 off: the
    loss within rel 1e-5, every gradient finite and within 1e-4 of its
    tensor's largest CPU entry; the card's step repeats bit for bit."""
    from repro_torch.train import AdamWConfig, chunked_ce_loss, make_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get(arch).reduced()
    batch = _train_batch(cfg, "cpu")
    if cfg.modality == "vision_text":
        n = cfg.n_vision_patches
        batch["patches"] = torch.randn(2, n, cfg.d_model, generator=torch.Generator().manual_seed(3)) * 0.1
        batch["tokens"] = batch["tokens"][:, n:]
    cpu = Model(cfg, device="cpu", seed=3)
    init = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    loss_cpu = chunked_ce_loss(cpu, batch)
    loss_cpu.backward()
    runs = []
    for _ in range(2):
        card = Model(cfg, device=cuda)
        with torch.no_grad():
            for n, p in card.named_parameters():
                p.copy_(init[n])
        cb = {k: v.to(cuda) for k, v in batch.items()}
        loss = chunked_ce_loss(card, cb)
        loss.backward()
        g = {n: p.grad.cpu() for n, p in card.named_parameters()}
        make_train_step(card, AdamWConfig())(make_train_state(card), cb)
        runs.append((loss.item(), g, [p.detach().cpu() for p in card.parameters()]))
    assert runs[0][0] == runs[1][0] and all(torch.equal(a, b) for a, b in zip(runs[0][2], runs[1][2]))
    torch.testing.assert_close(runs[0][0], loss_cpu.item(), rtol=1e-5, atol=0)
    for n, p in cpu.named_parameters():
        scale = p.grad.abs().max().clamp(min=1e-30)
        assert bool(torch.isfinite(runs[0][1][n]).all()), n
        assert ((runs[0][1][n] - p.grad).abs() <= 1e-4 * scale).all(), n


@pytest.mark.cuda
def test_vlm_prefill_flash_matches_chunked_on_card(cuda):
    """internvl2 reduced at f32 with TF32 off: a prefill of 8 patches and 40
    tokens with ``pallas`` (flash once a layer) against ``chunked``, the same
    weights: the last logits and every cache within 1e-4 of their scale;
    then three text-only decode steps on each."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = replace(get("internvl2-26b").reduced(), attn_impl="pallas")
    model = Model(cfg, device=cuda, seed=1)
    gen = torch.Generator().manual_seed(2)
    prompt = {"patches": (torch.randn(2, cfg.n_vision_patches, cfg.d_model, generator=gen) * 0.02).to(cuda),
              "tokens": torch.randint(0, cfg.vocab_size, (2, 40), generator=gen).to(cuda)}
    more = torch.randint(0, cfg.vocab_size, (2, 3), generator=gen).to(cuda)
    out = {}
    for impl in ("pallas", "chunked"):
        model.cfg = replace(cfg, attn_impl=impl)
        K.reset_launch_counts()
        with torch.inference_mode():
            lg, caches = model.prefill(prompt, 64)
            assert caches.pos == 48
            steps = []
            for t in range(3):
                st, caches = model.decode_step(caches, more[:, t:t + 1])
                steps.append(st)
        assert K.launch_counts()["flash_attention"] == (cfg.n_layers if impl == "pallas" else 0)
        out[impl] = [lg, torch.cat(steps, dim=1)] + [x for c in caches.layers for x in c]
    for a, b in zip(out["pallas"], out["chunked"]):
        if a.dtype.is_floating_point:
            scale = b.abs().max().clamp(min=1.0)
            torch.testing.assert_close(a / scale, b / scale, atol=1e-4, rtol=0)
        else:
            assert torch.equal(a, b)


# -- the dry run (repro_torch.launch) against the card -----------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["yi-34b", "qwen1.5-32b", "starcoder2-15b", "minitron-4b", "mamba2-1.3b",
                                  "dbrx-132b", "mixtral-8x22b", "internvl2-26b", "hubert-xlarge",
                                  "recurrentgemma-9b"])
def test_launch_abstract_build(cuda, arch):
    """The abstract build of each in-repo config: every parameter on meta at
    the shape and dtype a build on the card gives it (reduced() built on the
    card beside it), nothing drawn, at full size in no time."""
    cfg = get(arch)
    full = Model(cfg, device="meta")
    assert all(p.is_meta for p in full.parameters())
    assert sum(p.numel() for p in full.parameters()) > 1e9 or arch == "hubert-xlarge"
    small = replace(cfg.reduced(), n_layers=cfg.reduced().n_layers)
    on_meta = {n: (p.shape, p.dtype) for n, p in Model(small, device="meta").named_parameters()}
    on_card = {n: (p.shape, p.dtype) for n, p in Model(small, device=cuda).named_parameters()}
    assert on_meta == on_card


def _launch_case(name: str):
    """A config at a width the card measures in a moment, bf16 over f32 as the
    in-repo configs, and its step: (config, B, S, step)."""
    from repro_torch.configs.shapes import ShapeCell

    narrow = dict(d_model=1024, n_heads=8, d_head=128, d_ff=4096, vocab_size=16384, remat="full")
    if name == "mixtral forward":
        base = get("mixtral-8x22b")
        cfg = replace(base, n_layers=4, n_kv_heads=2, sliding_window=1024, attn_impl="pallas",
                      moe=replace(base.moe, d_ff=4096), **narrow)
        return cfg, ShapeCell("forward", 2048, 1, "forward")
    if name == "mixtral train":
        base = get("mixtral-8x22b")
        cfg = replace(base, n_layers=2, n_kv_heads=2, sliding_window=1024, moe=replace(base.moe, d_ff=4096), **narrow)
        return cfg, ShapeCell("train", 2048, 1, "train")
    if name in ("mamba2 forward", "mamba2 train"):
        cfg = replace(get("mamba2-1.3b"), n_layers=6, d_model=1024, vocab_size=16384)
        return cfg, ShapeCell(name.split()[1], 2048, 1, name.split()[1])
    cfg = replace(get("internvl2-26b"), n_layers=2, n_kv_heads=2, n_vision_patches=256,
                  attn_impl="pallas" if name == "internvl2 forward" else "chunked", **narrow)
    return cfg, ShapeCell(name.split()[1], 2048, 1, name.split()[1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mixtral forward", "mixtral train", "mamba2 forward", "mamba2 train",
                                  "internvl2 forward", "internvl2 train"])
def test_launch_counts_match_card(cuda, name):
    """Phase 13 (b) of chip_smoke.py at a reduced size: the dry run's count
    of a run on meta (``run_cell`` on a (1, 1) mesh) against the op counter
    around the same run on the card: FLOPs and HBM bytes within 1% (they
    differ only where a kernel runs in place of its plain version, and both
    are charged alike), the reckoned peak within 15% of
    ``max_memory_allocated`` (less what was allocated before the model)."""
    from repro_torch.configs.shapes import input_specs
    from repro_torch.launch import dryrun
    from repro_torch.train import AdamWConfig, make_train_state, make_train_step
    from repro_torch.utils.opcount import OpCounter

    cfg, cell = _launch_case(name)
    rec = dryrun.run_cell(cfg, cell, "one card", mesh={"data": 1, "model": 1})
    assert rec["ok"]
    gen = torch.Generator(device=cuda).manual_seed(0)
    batch = {}
    for k, (shape, dtype) in input_specs(cfg, cell).items():
        batch[k] = (torch.randint(0, cfg.vocab_size, shape, generator=gen, device=cuda, dtype=dtype)
                    if dtype == torch.int32 else torch.randn(shape, generator=gen, device=cuda) * 0.02)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = Model(cfg, device=cuda, seed=0)
    if cell.step == "train":
        state = make_train_state(model)
        step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=2), 1, 512)
        run = lambda: step(state, batch)
        grad = torch.enable_grad()
    else:
        run = lambda: model(batch)
        grad = torch.inference_mode()
    with grad:
        run()  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        with OpCounter() as c:
            run()
        torch.cuda.synchronize()
    card = c.report
    rel_f = abs(rec["counts"]["flops"] - card.flops) / card.flops
    rel_b = abs(rec["counts"]["hbm_bytes"] - card.hbm_bytes) / card.hbm_bytes
    rel_p = (rec["memory"]["peak_bytes"] - peak) / peak
    print(f"{name}: FLOPs {rec['counts']['flops']:.6g} vs {card.flops:.6g} ({rel_f:.3g}); bytes "
          f"{rec['counts']['hbm_bytes']:.6g} vs {card.hbm_bytes:.6g} ({rel_b:.3g}); peak "
          f"{rec['memory']['peak_bytes'] / 1e9:.3f} GB vs {peak / 1e9:.3f} GB ({rel_p:+.1%}); kernel calls "
          f"{rec['counts']['kernel_calls']} vs {card.kernel_calls}")
    assert rel_f <= 0.01 and rel_b <= 0.01
    assert rec["counts"]["kernel_calls"] == card.kernel_calls
    assert abs(rel_p) <= 0.15

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
from repro_torch.graphs import bipartite_ratings, build, erdos, generalized_matching_problem, rgg
from repro_torch.kernels.axpy_reduce.ref import axpy_reduce_ref
from repro_torch.kernels.flash_attention.ref import flash_attention_plain
from repro_torch.core import operators as ops
from repro_torch.kernels.incidence_gather.ref import incidence_gather_ref
from repro_torch.kernels.incidence_scatter import segments
from repro_torch.kernels.incidence_scatter.ref import incidence_scatter_ref
from repro_torch.kernels.step_direction.ref import step_direction_ref
from repro_torch.core import stepsize
from repro_torch.kernels.linesearch_probe.ref import linesearch_probe2_ref, linesearch_probe_ref, newton_search_ref
from repro_torch.kernels.softmax_weights.ref import softmax_weights_ref
from repro_torch.models import Model

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
                                 "newton_search": 0, "axpy_reduce": 1, "flash_attention": 0,
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
    # unmasked Newton searches run on the card in one launch each; masked
    # ones (gen-match) run the host loop over plain probes
    assert (counts["newton_search"] > 0) == (family != "gen-match")
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
    """The binary step rule on the card: a host loop over the two-sided
    probe kernel, one launch a probe; bars as above."""
    opts = MWUOptions(eps=EPS, step_rule="binary")
    cpu = Solver(opts).solve(_problem(family, "cpu"))
    K.reset_launch_counts()
    card = Solver(opts).solve(_problem(family, cuda))
    assert card.status == cpu.status == Status.FEASIBLE
    assert card.bound == pytest.approx(cpu.bound, rel=1e-5)
    assert card.objective == pytest.approx(cpu.objective, rel=2 * EPS)
    counts = K.launch_counts()
    assert counts["linesearch_probe"] > 0 and counts["newton_search"] == 0


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
@pytest.mark.parametrize("dh", [16, 32, 64, 80, 128])
def test_flash_attention_matches_plain_on_card(cuda, dh, S, causal, window, dtype):
    """The sweep of tests/test_kernels.py (GQA 4 over 2 heads) at every head dim, with S on both sides of the
    64-row warpgroup (bf16) and block (f32) edges and the 128-row tile edge (bf16), and windows inside one tile
    (24) and across two or more (200)."""
    q, k, v = _qkv((2, S, 4, dh), (2, S, 2, dh), dtype, cuda, S + dh)
    _check_flash(q, k, v, causal, window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(False, None), (True, 200), (False, 100)])
@pytest.mark.parametrize("dh,hq,hkv", [(16, 8, 2), (32, 6, 2), (64, 6, 1), (80, 16, 16), (128, 8, 1)])
def test_flash_attention_long_rows_on_card(cuda, dh, hq, hkv, causal, window, dtype):
    """Many key tiles and a ragged tail (S 1500: 11.7 bf16 tiles of 128 keys; 46.9 f32 tiles of 32 up to
    d 80, 93.75 of 16 at d 128), GQA groups 1, 3, 4, 6 and 8; bidirectional, causal-windowed and
    bidirectional-windowed."""
    q, k, v = _qkv((1, 1500, hq, dh), (1, 1500, hkv, dh), dtype, cuda, dh)
    _check_flash(q, k, v, causal, window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [80, 128])
def test_flash_attention_ring_wraps_on_card(cuda, dh, dtype):
    """S 4096 causal at 2 heads: the key tiles pass the stage ring many times (bf16: 32 tiles through 4
    stages at d 80, 2 at 128; f32: 128 tiles at d 80 and 256 at d 128 through 2 stages)."""
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
@pytest.mark.parametrize("arch", ["hubert-cut", "hubert-xlarge", "minitron-4b", "starcoder2-15b"])
def test_model_forward_card_matches_cpu(cuda, arch):
    """Model.forward + logits at S 40 > attn_chunk 16, attn_impl pallas, f32:
    the card (flash kernel, cuBLAS) vs the CPU (plain versions), the same
    weights. "hubert-cut" is hubert at its real d_head 80 and MHA, 2 layers
    of width 160; the others are the configs' reduced(). Bar 1e-4 of the
    largest logit: f32 on both sides, sums in other orders."""
    torch.backends.cuda.matmul.allow_tf32 = False
    if arch == "hubert-cut":
        cfg = replace(get("hubert-xlarge"), n_layers=2, d_model=160, n_heads=2, n_kv_heads=2, d_head=80, d_ff=640,
                      attn_chunk=16, dtype="float32", param_dtype="float32", attn_impl="pallas")
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
    assert K.launch_counts()["flash_attention"] == cfg.n_layers
    V = cfg.vocab_size
    assert torch.equal(got[..., V:], ref[..., V:])
    scale = ref[..., :V].abs().max()
    torch.testing.assert_close(got[..., :V] / scale, ref[..., :V] / scale, atol=1e-4, rtol=0)

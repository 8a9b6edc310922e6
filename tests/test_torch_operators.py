"""Operators and smoothing of the port vs the reference, on the CPU at f64.

The same numpy inputs go through each ``repro.core`` operator and its
``repro_torch.core`` counterpart: matvec, rmatvec, colmax (with and
without a row scale) and materialize, masks included (cf.
tests/test_operators.py), and the masked and weighted incidence gather
bit for bit at f32 and f64. The scatter-adds sum in another order than
XLA's, hence the 1e-12 absolute and 1e-13 relative bars; gathers and
maxima are exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import operators as R
from repro.core import smoothing as RS
from repro_torch.core import operators as T
from repro_torch.core import smoothing as TS
from repro_torch.kernels.incidence_gather.ref import incidence_gather_ref

ATOL, RTOL = 1e-12, 1e-13
GRAPHS = ["grid6", "rgg10", "kron8", "er", "path", "star", "triangle"]
SMALL = {"path", "star", "triangle"}  # materialize() is checked on these


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _pair(kind, g, rng, masked):
    """(reference op, port op) of ``kind`` on graph g."""
    u, v = g.u, g.v
    mask = rng.random(g.m) > 0.3 if masked else None
    jm = None if mask is None else _j(mask)
    tm = None if mask is None else _t(mask)
    if kind == "incidence":
        w = rng.random(g.m) + 0.5 if masked else None
        return (R.Incidence(u=_j(u), v=_j(v), n_vertices=g.n, weights=None if w is None else _j(w), edge_mask=jm),
                T.Incidence(u=_t(u), v=_t(v), n_vertices=g.n, weights=None if w is None else _t(w), edge_mask=tm))
    if kind == "adjacency":
        return (R.AdjacencyPlusId(u=_j(u), v=_j(v), n_vertices=g.n, edge_mask=jm),
                T.AdjacencyPlusId(u=_t(u), v=_t(v), n_vertices=g.n, edge_mask=tm))
    if kind == "vertex_edge_pair":
        return (R.VertexEdgePair(u=_j(u), v=_j(v), n_vertices=g.n, edge_mask=jm),
                T.VertexEdgePair(u=_t(u), v=_t(v), n_vertices=g.n, edge_mask=tm))
    if kind == "interweaved":
        return R.InterweavedId(n_edges=g.m, edge_mask=jm), T.InterweavedId(n_edges=g.m, edge_mask=tm)
    if kind == "transposed":
        r, t = _pair("incidence", g, rng, masked)
        return R.Transposed(r), T.Transposed(t)
    if kind == "scaled":
        r, t = _pair("incidence", g, rng, masked)
        s = rng.random(g.n) + 0.1
        return R.ScaledRows(scale=_j(s), inner=r), T.ScaledRows(scale=_t(s), inner=t)
    if kind == "ones_row":
        c = rng.random(g.m)
        return (R.OnesRow(c=_j(c), inv_bound=_j(np.float64(0.37))),
                T.OnesRow(c=_t(c), inv_bound=_t(np.float64(0.37))))
    if kind == "coo":
        nnz = 3 * g.m
        rows = rng.integers(0, g.n, nnz).astype(np.int32)
        cols = rng.integers(0, g.m, nnz).astype(np.int32)
        vals = rng.random(nnz)
        return (R.Coo(rows=_j(rows), cols=_j(cols), vals=_j(vals), _shape=(g.n, g.m)),
                T.Coo(rows=_t(rows), cols=_t(cols), vals=_t(vals), _shape=(g.n, g.m)))
    if kind == "vstack":
        a, b = _pair("scaled", g, rng, masked), _pair("coo", g, rng, masked)
        return R.VStack(ops=(a[0], b[0])), T.VStack(ops=(a[1], b[1]))
    if kind == "dense":
        mat = rng.random((7, 5)) * (rng.random((7, 5)) < 0.6)
        return R.Dense(mat=_j(mat)), T.Dense(mat=_t(mat))
    raise ValueError(kind)


KINDS = ["incidence", "adjacency", "vertex_edge_pair", "interweaved", "transposed", "scaled", "ones_row", "coo",
         "vstack", "dense"]


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("kind", KINDS)
def test_operator_parity(kind, masked, small_graphs):
    rng = np.random.default_rng(len(kind) + 10 * masked)
    for gname in GRAPHS:
        ref, port = _pair(kind, small_graphs[gname], rng, masked)
        assert tuple(port.shape) == tuple(ref.shape) and port.nnz == ref.nnz
        m, n = ref.shape
        x, y, s = rng.random(n), rng.random(m), rng.random(m) + 0.1
        np.testing.assert_allclose(_np(port.matvec(_t(x))), _np(ref.matvec(_j(x))), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(_np(port.rmatvec(_t(y))), _np(ref.rmatvec(_j(y))), rtol=RTOL, atol=ATOL)
        cm, rcm = port.colmax(), ref.colmax()
        assert _np(cm).dtype == _np(rcm).dtype, (kind, _np(cm).dtype, _np(rcm).dtype)
        np.testing.assert_array_equal(_np(cm), _np(rcm))
        np.testing.assert_allclose(_np(port.colmax(_t(s))), _np(ref.colmax(_j(s))), rtol=RTOL, atol=ATOL)
        if gname in SMALL:
            np.testing.assert_allclose(_np(port.materialize()), _np(ref.materialize()), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["masked", "weighted", "masked_weighted"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_incidence_edge_factor_matches_reference(kind, dtype, small_graphs):
    """A masked, weighted or masked-and-weighted Incidence: its rmatvec (the
    gather with the edge factor in one pass) and the gather its as_gather
    hands the step direction, bit for bit the reference's rmatvec
    ``g * _w`` and the port's plain chain (``_weighted``), under ScaledRows
    too; a weight of 0 and a masked edge give an exact 0."""
    rng = np.random.default_rng(len(kind) + int(dtype == np.float64))
    for gname in GRAPHS:
        g = small_graphs[gname]
        mask = rng.random(g.m) > 0.3 if "masked" in kind else None
        wt = rng.random(g.m) + 0.5 if "weighted" in kind else None
        if wt is not None:
            wt[::5] = 0.0
        ref = R.Incidence(u=_j(g.u), v=_j(g.v), n_vertices=g.n, weights=None if wt is None else _j(wt),
                          edge_mask=None if mask is None else _j(mask))
        port = T.Incidence(u=_t(g.u), v=_t(g.v), n_vertices=g.n, weights=None if wt is None else _t(wt),
                           edge_mask=None if mask is None else _t(mask))
        y, s = rng.random(g.n).astype(dtype), (rng.random(g.n) + 0.1).astype(dtype)
        want = np.asarray(ref.rmatvec(_j(y)))
        got = port.rmatvec(_t(y))
        assert got.dtype == _t(y).dtype
        np.testing.assert_array_equal(_np(got), want)
        np.testing.assert_array_equal(_np(incidence_gather_ref(*port.as_gather(_t(y)))), want)
        assert torch.equal(got, port._weighted(incidence_gather_ref(port.u, port.v, _t(y))))
        scaled_ref, scaled = R.ScaledRows(scale=_j(s), inner=ref), T.ScaledRows(scale=_t(s), inner=port)
        want = np.asarray(scaled_ref.rmatvec(_j(y)))
        np.testing.assert_array_equal(_np(scaled.rmatvec(_t(y))), want)
        np.testing.assert_array_equal(_np(incidence_gather_ref(*scaled.as_gather(_t(y)))), want)
        zero = np.zeros(g.m, bool) if mask is None else ~mask
        zero |= np.zeros(g.m, bool) if wt is None else wt == 0.0
        assert not _np(got)[zero].any()


def test_transposed_colmax_rowmax_cases(small_graphs):
    """Transposed.colmax goes through _rowmax for Dense, Coo and Incidence."""
    rng = np.random.default_rng(11)
    g = small_graphs["er"]
    for kind in ("dense", "coo", "incidence"):
        ref, port = _pair(kind, g, rng, masked=kind == "incidence")
        ref, port = R.Transposed(ref), T.Transposed(port)
        s = rng.random(ref.shape[0]) + 0.1
        np.testing.assert_array_equal(_np(port.colmax()), _np(ref.colmax()))
        np.testing.assert_allclose(_np(port.colmax(_t(s))), _np(ref.colmax(_j(s))), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_smoothing_parity(dtype, masked):
    """smax/smin and their weights, masked (plain path) and unmasked (kernel function)."""
    rng = np.random.default_rng(6)
    v = rng.random(500).astype(dtype)
    mask = rng.random(500) > 0.5 if masked else None
    jm, tm = (None, None) if mask is None else (_j(mask), _t(mask))
    eta = 80.0
    tol = 1e-5 if dtype == np.float32 else 1e-12
    for rf, tf in [(RS.smax_and_weights, TS.smax_and_weights), (RS.smin_and_weights, TS.smin_and_weights)]:
        rs, rw = rf(_j(v), jnp.asarray(eta, dtype), where=jm)
        ts, tw = tf(_t(v), eta, where=tm)
        assert tw.dtype == torch.from_numpy(v).dtype
        np.testing.assert_allclose(float(ts), float(rs), rtol=tol)
        np.testing.assert_allclose(tw.numpy(), np.asarray(rw), atol=tol)
    for rf, tf in [(RS.smax, TS.smax), (RS.smin, TS.smin), (RS.smax_weights, TS.smax_weights),
                   (RS.smin_weights, TS.smin_weights)]:
        np.testing.assert_allclose(_np(tf(_t(v), eta, where=tm)), _np(rf(_j(v), eta, where=jm)), rtol=tol, atol=tol)


def test_smoothing_bounds_and_no_overflow():
    rng = np.random.default_rng(0)
    v = torch.as_tensor(rng.random(100))
    eta = 10.0 * np.log(100) / 0.1
    assert float(TS.smax(v, eta)) >= float(v.max())
    assert float(TS.smax(v, eta)) <= float(v.max()) + np.log(100) / eta + 1e-12
    assert float(TS.smin(v, eta)) <= float(v.min())
    assert float(TS.smin(v, eta)) >= float(v.min()) - np.log(100) / eta - 1e-12
    big = torch.tensor([1e3, 0.0, -1e3], dtype=torch.float64)
    assert np.isfinite(float(TS.smax(big, 1e4))) and np.isfinite(float(TS.smin(big, 1e4)))
    assert torch.isfinite(TS.smax_weights(big, 1e4)).all()
    _, w = TS.smax_and_weights(big, 1e4)
    assert torch.isfinite(w).all() and abs(float(w.sum()) - 1.0) < 1e-12

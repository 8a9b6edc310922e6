"""The step direction's plain version and the operators' gather source, on
the CPU.

``step_direction``'s plain version, in both of its sources (g gathered as
``w[u] + w[v]``, or g given), against the reference's expression
(src/repro/core/mwu.py, the ratio, d and max_d lines of ``_iteration``)
on the same numpy inputs: d bit for bit and max(d) exact, at f32 and f64,
with h <= tiny, g = 0, x = 0 and a zero direction among the inputs. The
reference's g is its own gather (``Incidence.rmatvec``), masked and
weighted too: the gather source then carries the edge factor (the mask,
one byte an edge, and the weights), and d stays bit for bit the
reference's chain ``(w[u] + w[v]) * _w``. ``as_gather`` returns ``(u, v,
w, mask, weights)`` for an Incidence (mask and weights None where it has
none), ``(u, v, scale*w, ...)`` under ``ScaledRows`` and None for every
other operator.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import operators as R
from repro_torch import kernels as K
from repro_torch.core import operators as T
from repro_torch.kernels.incidence_gather.ref import incidence_gather_ref
from repro_torch.kernels.step_direction.ref import step_direction_ref


def _reference_direction(g, h, x, scale, dtype):
    """src/repro/core/mwu.py's step direction, as its _iteration writes it."""
    tiny = jnp.finfo(dtype).tiny
    ratio = jnp.where(h > tiny, g / jnp.maximum(h, tiny), jnp.inf)
    d = scale * jnp.maximum(0.0, 1.0 - ratio) * x
    return np.asarray(d), float(jnp.max(d))


def _inputs(g_graph, dtype, seed, zero_x=False):
    rng = np.random.default_rng(seed)
    n, m = g_graph.n, g_graph.m
    w = (rng.random(n) * 2e-3).astype(dtype)
    w[::4] = 0.0  # g = 0 where both ends are 0
    h = (rng.random(m) * 2e-3).astype(dtype)
    h[::5] = np.finfo(dtype).tiny  # h <= tiny: ratio inf, d 0
    h[1::11] = 0.0
    x = rng.random(m).astype(dtype)
    x[2::7] = 0.0
    if zero_x:
        x[:] = 0.0
    scale = float(np.asarray(1.0 / 211.7, dtype))  # held in the loop dtype, as the solver holds it
    return w, h, x, scale


@pytest.mark.parametrize("zero_x", [False, True], ids=["direction", "zero_direction"])
@pytest.mark.parametrize("source", ["gather", "read"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("gname", ["grid6", "rgg10", "kron8", "er", "star"])
def test_plain_step_direction_matches_reference(gname, dtype, source, zero_x, small_graphs):
    g_graph = small_graphs[gname]
    w, h, x, scale = _inputs(g_graph, dtype, len(gname), zero_x)
    ref_op = R.Incidence(u=jnp.asarray(g_graph.u), v=jnp.asarray(g_graph.v), n_vertices=g_graph.n)
    g_ref = ref_op.rmatvec(jnp.asarray(w))
    d_ref, max_ref = _reference_direction(g_ref, jnp.asarray(h), jnp.asarray(x), scale, dtype)
    u, v = torch.as_tensor(g_graph.u), torch.as_tensor(g_graph.v)
    if source == "gather":
        kw = dict(gather=(u, v, torch.as_tensor(w)))
    else:
        kw = dict(g=torch.as_tensor(np.array(g_ref)))
    d, d_max = step_direction_ref(torch.as_tensor(h), torch.as_tensor(x), scale, **kw)
    assert d.dtype == torch.as_tensor(x).dtype and d_max.dim() == 0
    np.testing.assert_array_equal(d.numpy(), d_ref)
    assert float(d_max) == max_ref
    assert (float(d_max) == 0.0) == zero_x
    wd, wmax = K.step_direction(torch.as_tensor(h), torch.as_tensor(x), scale, **kw)  # CPU: the plain version
    assert torch.equal(wd, d) and float(wmax) == float(d_max)


FACTORS = ["masked", "weighted", "masked_weighted"]


def _factor(kind, m, dtype, seed):
    """(mask, weights) of an edge factor of kind ``kind`` over m edges, numpy."""
    rng = np.random.default_rng(seed)
    mask = rng.random(m) > 0.3 if "masked" in kind else None
    weights = (rng.random(m) + 0.5).astype(dtype) if "weighted" in kind else None
    if weights is not None:
        weights[::6] = 0.0  # a zero weight on a kept edge
    return mask, weights


@pytest.mark.parametrize("kind", FACTORS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("gname", ["grid6", "rgg10", "kron8", "er", "star"])
def test_plain_step_direction_with_edge_factor_matches_reference(gname, dtype, kind, small_graphs):
    """The gather source with an edge factor: g = (w[u] + w[v]) * _w, as the
    reference's masked or weighted Incidence.rmatvec computes it, then its
    ratio and d chain (src/repro/core/mwu.py:179-184); d bit for bit, max(d)
    exact, the wrapper's plain version the same."""
    g_graph = small_graphs[gname]
    w, h, x, scale = _inputs(g_graph, dtype, len(gname) + 3)
    mask, weights = _factor(kind, g_graph.m, dtype, len(gname))
    ref_op = R.Incidence(u=jnp.asarray(g_graph.u), v=jnp.asarray(g_graph.v), n_vertices=g_graph.n,
                         weights=None if weights is None else jnp.asarray(weights),
                         edge_mask=None if mask is None else jnp.asarray(mask))
    d_ref, max_ref = _reference_direction(ref_op.rmatvec(jnp.asarray(w)), jnp.asarray(h), jnp.asarray(x), scale, dtype)
    gather = (torch.as_tensor(g_graph.u), torch.as_tensor(g_graph.v), torch.as_tensor(w),
              None if mask is None else torch.as_tensor(mask), None if weights is None else torch.as_tensor(weights))
    d, d_max = step_direction_ref(torch.as_tensor(h), torch.as_tensor(x), scale, gather=gather)
    np.testing.assert_array_equal(d.numpy(), d_ref)
    assert float(d_max) == max_ref
    wd, wmax = K.step_direction(torch.as_tensor(h), torch.as_tensor(x), scale, gather=gather)
    assert torch.equal(wd, d) and float(wmax) == float(d_max)


def test_step_direction_needs_one_source():
    x = torch.ones(3, dtype=torch.float64)
    with pytest.raises(ValueError):
        K.step_direction(x, x, 0.5)
    idx = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        K.step_direction(x, x, 0.5, g=x, gather=(idx, idx, x))


def _incidence(g, **kw):
    return T.Incidence(u=torch.as_tensor(g.u), v=torch.as_tensor(g.v), n_vertices=g.n, **kw)


def test_as_gather_sources(small_graphs):
    g = small_graphs["rgg10"]
    rng = np.random.default_rng(0)
    y = torch.as_tensor(rng.random(g.n))
    scale = torch.as_tensor(rng.random(g.n) + 0.1)
    inc = _incidence(g)
    u, v, w, mask, weights = inc.as_gather(y)
    assert u is inc.u and v is inc.v and w is y and mask is None and weights is None
    u, v, w, mask, weights = T.ScaledRows(scale=scale, inner=inc).as_gather(y)
    assert u is inc.u and v is inc.v and torch.equal(w, scale * y) and mask is None and weights is None
    assert torch.equal(T.ScaledRows(scale=scale, inner=inc).rmatvec(y), w.index_select(0, u) + w.index_select(0, v))
    # masked and weighted operators hand over their edge factor: the mask as
    # it is, the weights converted once per dtype and kept on the operator
    weighted = _incidence(g, weights=torch.as_tensor(rng.random(g.m)))
    masked = _incidence(g, edge_mask=torch.as_tensor(rng.random(g.m) > 0.5))
    both = _incidence(g, weights=weighted.weights, edge_mask=masked.edge_mask)
    for op in (weighted, masked, both, T.ScaledRows(scale=scale, inner=both)):
        inner = op.inner if isinstance(op, T.ScaledRows) else op
        for dtype in (torch.float64, torch.float32):
            yd = y.to(dtype)
            u, v, w, mask, weights = op.as_gather(yd)
            assert u is inner.u and v is inner.v and mask is inner.edge_mask
            assert (weights is None) == (inner.weights is None)
            if weights is not None:
                assert weights.dtype == w.dtype and weights is op.as_gather(yd)[4]  # converted once
            want = inner._weighted(incidence_gather_ref(u, v, w))  # the plain chain
            assert torch.equal(op.rmatvec(yd), want) and torch.equal(incidence_gather_ref(u, v, w, mask, weights), want)
    e = torch.as_tensor(g.u)
    others = [T.Transposed(inc),
              T.AdjacencyPlusId(u=inc.u, v=inc.v, n_vertices=g.n), T.VertexEdgePair(u=inc.u, v=inc.v, n_vertices=g.n),
              T.InterweavedId(n_edges=g.m), T.OnesRow(c=torch.ones(g.m, dtype=torch.float64),
                                                    inv_bound=torch.tensor(0.5, dtype=torch.float64)),
              T.Coo(rows=e, cols=e, vals=torch.ones(g.m, dtype=torch.float64), _shape=(g.n, g.n)),
              T.VStack(ops=(T.ScaledRows(scale=scale, inner=inc),)),
              T.Dense(mat=torch.ones(3, 4, dtype=torch.float64))]
    for op in others:
        assert op.as_gather(y) is None, type(op).__name__

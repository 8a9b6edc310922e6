"""The step direction's plain version and the operators' gather source, on
the CPU.

``step_direction``'s plain version, in both of its sources (g gathered as
``w[u] + w[v]``, or g given), against the reference's expression
(src/repro/core/mwu.py, the ratio, d and max_d lines of ``_iteration``)
on the same numpy inputs: d bit for bit and max(d) exact, at f32 and f64,
with h <= tiny, g = 0, x = 0 and a zero direction among the inputs. The
reference's g is its own gather (``Incidence.rmatvec``). ``as_gather``
returns ``(u, v, w)`` for a plain Incidence, ``(u, v, scale*w)`` under
``ScaledRows`` and None for every other operator.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import operators as R
from repro_torch import kernels as K
from repro_torch.core import operators as T
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
    u, v, w = inc.as_gather(y)
    assert u is inc.u and v is inc.v and w is y
    u, v, w = T.ScaledRows(scale=scale, inner=inc).as_gather(y)
    assert u is inc.u and v is inc.v and torch.equal(w, scale * y)
    assert torch.equal(T.ScaledRows(scale=scale, inner=inc).rmatvec(y), w.index_select(0, u) + w.index_select(0, v))
    weighted = _incidence(g, weights=torch.as_tensor(rng.random(g.m)))
    masked = _incidence(g, edge_mask=torch.as_tensor(rng.random(g.m) > 0.5))
    e = torch.as_tensor(g.u)
    others = [weighted, masked, T.ScaledRows(scale=scale, inner=weighted), T.Transposed(inc),
              T.AdjacencyPlusId(u=inc.u, v=inc.v, n_vertices=g.n), T.VertexEdgePair(u=inc.u, v=inc.v, n_vertices=g.n),
              T.InterweavedId(n_edges=g.m), T.OnesRow(c=torch.ones(g.m, dtype=torch.float64),
                                                    inv_bound=torch.tensor(0.5, dtype=torch.float64)),
              T.Coo(rows=e, cols=e, vals=torch.ones(g.m, dtype=torch.float64), _shape=(g.n, g.n)),
              T.VStack(ops=(T.ScaledRows(scale=scale, inner=inc),)),
              T.Dense(mat=torch.ones(3, 4, dtype=torch.float64))]
    for op in others:
        assert op.as_gather(y) is None, type(op).__name__

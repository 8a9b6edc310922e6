"""The scatter products' CSR segments and the segmented sum's plain version,
on the CPU.

* The segments each operator kind builds (``csr``: Incidence, AdjacencyPlusId,
  VertexEdgePair, Coo; masked and weighted, u sorted and unsorted, rows of
  degree 0) equal a CSR built with numpy (a stable argsort and bincount).
* ``incidence_scatter``'s plain version on those segments equals the JAX
  package's ``matvec`` on the same seeded numpy inputs: within 1e-10 at
  f64 and 1e-4 at f32 (sums in another order than XLA's scatter), bit for
  bit on integer-valued data (every partial sum is exact).
* Every operator's CPU product is still today's ``index_add_`` expression,
  bit for bit (the card path alone goes through the kernel).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import operators as R
from repro_torch import kernels as K
from repro_torch.core import operators as T
from repro_torch.kernels.incidence_scatter import MERGE_TILE, segments
from repro_torch.kernels.incidence_scatter.ref import incidence_scatter_ref

KINDS = ["incidence", "incidence_masked", "adjacency", "adjacency_masked", "vertex_edge_pair",
         "vertex_edge_pair_masked", "coo"]
ORDERS = ["sorted", "shuffled"]
TOLS = {np.float64: 1e-10, np.float32: 1e-4}


def _edges(small_graphs, gname, order, seed):
    """u, v of a small graph with 7 isolated vertices appended (rows of
    degree 0); "shuffled" permutes the edges, so u is unsorted."""
    g = small_graphs[gname]
    u, v = g.u, g.v
    if order == "shuffled":
        p = np.random.default_rng(seed).permutation(g.m)
        u, v = u[p], v[p]
    return u, v, g.n + 7


def _ops(kind, u, v, n, rng):
    """(reference op, port op, the numpy CSR of each side) for ``kind``."""
    m = len(u)
    mask = rng.random(m) > 0.3 if kind.endswith("masked") else None
    j, t = jnp.asarray, torch.as_tensor
    jm, tm = (None, None) if mask is None else (j(mask), t(mask))
    e = np.arange(m, dtype=np.int32)
    if kind.startswith("incidence"):
        w = rng.integers(1, 5, m).astype(np.float64) if mask is not None else None
        ref = R.Incidence(u=j(u), v=j(v), n_vertices=n, weights=None if w is None else j(w), edge_mask=jm)
        port = T.Incidence(u=t(u), v=t(v), n_vertices=n, weights=None if w is None else t(w), edge_mask=tm)
        sides = [(u, n, e, w, mask), (v, n, e, w, mask)]
    elif kind.startswith("adjacency"):
        ref = R.AdjacencyPlusId(u=j(u), v=j(v), n_vertices=n, edge_mask=jm)
        port = T.AdjacencyPlusId(u=t(u), v=t(v), n_vertices=n, edge_mask=tm)
        sides = [(u, n, v, None, mask), (v, n, u, None, mask)]
    elif kind.startswith("vertex_edge_pair"):
        ref = R.VertexEdgePair(u=j(u), v=j(v), n_vertices=n, edge_mask=jm)
        port = T.VertexEdgePair(u=t(u), v=t(v), n_vertices=n, edge_mask=tm)
        sides = [(u, n, 2 * e, None, mask), (v, n, 2 * e + 1, None, mask)]
    else:
        nnz = 3 * m
        rows = rng.integers(0, n, nnz).astype(np.int32)
        cols = rng.integers(0, m, nnz).astype(np.int32)
        vals = rng.integers(0, 3, nnz).astype(np.float64)
        ref = R.Coo(rows=j(rows), cols=j(cols), vals=j(vals), _shape=(n, m))
        port = T.Coo(rows=t(rows), cols=t(cols), vals=t(vals), _shape=(n, m))
        sides = [(rows, n, cols, vals, None), (cols, m, rows, vals, None)]
    return ref, port, sides


def _np_csr(row_of, n_rows, src, wt, keep):
    """offsets, src and wt in CSR order, with numpy: stable argsort, bincount."""
    e = np.arange(len(row_of)) if keep is None else np.flatnonzero(keep)
    order = e[np.argsort(row_of[e], kind="stable")]
    offsets = np.concatenate([[0], np.cumsum(np.bincount(row_of[e], minlength=n_rows))])
    return offsets, src[order], None if wt is None else wt[order]


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("kind", KINDS)
def test_csr_matches_numpy(kind, order, small_graphs):
    rng = np.random.default_rng(KINDS.index(kind))
    for gname in ("grid6", "kron8", "star", "triangle"):
        u, v, n = _edges(small_graphs, gname, order, len(gname))
        _, port, sides = _ops(kind, u, v, n, rng)
        for seg, (row_of, n_rows, src, wt, keep) in zip(port.csr, sides):
            offsets, src_r, wt_r = _np_csr(row_of, n_rows, src, wt, keep)
            assert seg.rows == n_rows and seg.nnz == len(src_r)
            assert seg.offsets.dtype == torch.int64 and np.array_equal(seg.offsets.numpy(), offsets)
            got_src = np.arange(seg.nnz) if seg.src is None else seg.src.numpy()
            assert seg.src is None or seg.src.dtype == torch.int32
            np.testing.assert_array_equal(got_src, src_r)
            if wt_r is None:
                assert seg.wt is None
            else:
                np.testing.assert_array_equal(seg.wt.numpy(), wt_r)
            if kind != "coo":
                assert (np.diff(offsets)[-7:] == 0).all()  # the isolated vertices


def test_sorted_unmasked_side_keeps_no_permutation(small_graphs):
    """A graph's u comes sorted (Graph.from_edges): its side stores no
    permutation; the v side stores one."""
    g = small_graphs["rgg10"]
    a, b = T.Incidence(u=torch.as_tensor(g.u), v=torch.as_tensor(g.v), n_vertices=g.n).csr
    assert a.src is None and b.src is not None and b.src.dtype == torch.int32
    s = segments(torch.as_tensor(g.v), g.n, g.m, keep=torch.ones(g.m, dtype=torch.bool))
    assert torch.equal(s.offsets, b.offsets) and torch.equal(s.src, b.src)


def _products(kind):
    return ("matvec", "rmatvec") if kind == "coo" else ("matvec",)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("kind", KINDS)
def test_plain_scatter_matches_reference(kind, order, dtype, small_graphs):
    """The plain segmented sum (the kernel's oracle) against the JAX
    package's matvec; bit for bit on integer-valued x."""
    rng = np.random.default_rng(7 + KINDS.index(kind))
    for gname in ("grid6", "rgg10", "kron8", "er", "path"):
        u, v, n = _edges(small_graphs, gname, order, 3)
        ref, port, _ = _ops(kind, u, v, n, rng)
        for k, prod in enumerate(_products(kind)):
            size = ref.shape[1] if prod == "matvec" else ref.shape[0]
            for x in (rng.random(size).astype(dtype), rng.integers(0, 9, size).astype(dtype)):
                want = np.asarray(getattr(ref, prod)(jnp.asarray(x)))
                base = torch.as_tensor(x) if kind.startswith("adjacency") else None
                segs = port.csr if kind != "coo" else (port.csr[k],)
                got = incidence_scatter_ref(torch.as_tensor(x), *segs, base=base)
                assert got.dtype == torch.as_tensor(x).dtype
                via_wrapper = K.incidence_scatter(torch.as_tensor(x), *segs, base=base)
                assert torch.equal(got, via_wrapper)  # the CPU wrapper is the plain version
                np.testing.assert_allclose(got.numpy(), want, rtol=TOLS[dtype], atol=TOLS[dtype])
            np.testing.assert_array_equal(got.numpy(), want)  # the integer-valued x


def _index_add_product(port, kind, prod, x):
    """The operators' CPU products as index_add_ computed them before the
    card path went through the segmented sum."""
    if kind.startswith("incidence"):
        xw = x if port.weights is None and port.edge_mask is None else x * port._w(x.dtype)
        out = torch.zeros(port.n_vertices, dtype=x.dtype)
        return out.index_add_(0, port.u, xw).index_add_(0, port.v, xw)
    if kind.startswith("adjacency"):
        xu, xv = (T._masked(x.index_select(0, i), port.edge_mask) for i in (port.u, port.v))
        return x.clone().index_add_(0, port.u, xv).index_add_(0, port.v, xu)
    if kind.startswith("vertex_edge_pair"):
        z2 = x.view(-1, 2)
        zu, zv = (T._masked(z2[:, k], port.edge_mask) for k in (0, 1))
        return torch.zeros(port.n_vertices, dtype=x.dtype).index_add_(0, port.u, zu).index_add_(0, port.v, zv)
    if prod == "matvec":
        out = torch.zeros(port.shape[0], dtype=x.dtype)
        return out.index_add_(0, port.rows, port.vals.to(x.dtype) * x.index_select(0, port.cols))
    out = torch.zeros(port.shape[1], dtype=x.dtype)
    return out.index_add_(0, port.cols, port.vals.to(x.dtype) * x.index_select(0, port.rows))


@pytest.mark.parametrize("kind", KINDS)
def test_cpu_products_unchanged(kind, small_graphs):
    """On the CPU every operator keeps its index_add_ product bit for bit,
    and builds no segments for it."""
    rng = np.random.default_rng(21 + KINDS.index(kind))
    for gname in ("rgg10", "kron8", "er"):
        u, v, n = _edges(small_graphs, gname, "shuffled", 5)
        _, port, _ = _ops(kind, u, v, n, rng)
        for prod in _products(kind):
            size = port.shape[1] if prod == "matvec" else port.shape[0]
            x = torch.as_tensor(rng.random(size))
            assert torch.equal(getattr(port, prod)(x), _index_add_product(port, kind, prod, x))
        assert "csr" not in port.__dict__


def _merge_path_rows(offsets, d):
    """Rows consumed at item d of the merge of the row ends offsets[1:] with
    the entries 0, 1, ...: a binary search along the diagonal (Merrill and
    Garland), as a block would run it."""
    n, nnz = len(offsets) - 1, int(offsets[-1])
    lo, hi = max(d - nnz, 0), min(d, n)
    while lo < hi:
        mid = (lo + hi) // 2
        if offsets[mid + 1] <= d - mid - 1:
            lo = mid + 1
        else:
            hi = mid
    return lo


@pytest.mark.parametrize("shape", ["empty_rows", "hot_row", "uniform"])
def test_merge_splits_match_merge_path_search(shape):
    """The tile splits computed with the CSR equal the merge-path search at
    every tile start, for rows of degree 0, one segment of many tiles and
    many short rows."""
    rng = np.random.default_rng(len(shape))
    n = 5_000
    deg = {"empty_rows": rng.poisson(0.2, n), "hot_row": rng.poisson(2.0, n), "uniform": rng.poisson(9.0, n)}[shape]
    if shape == "hot_row":
        deg[17] = 40_000
    offsets = np.concatenate([[0], np.cumsum(deg)])
    seg = segments(torch.as_tensor(np.repeat(np.arange(n), deg).astype(np.int32)), n, int(deg.sum()))
    np.testing.assert_array_equal(seg.offsets.numpy(), offsets)
    items = n + int(offsets[-1])
    want = [_merge_path_rows(offsets, min(t * MERGE_TILE, items)) for t in range(-(-items // MERGE_TILE) + 1)]
    assert seg.splits.tolist() == want


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("slab_cols", [97, 500, 10**9])
def test_slabbed_segments(slab_cols, dtype):
    """A side read through a permutation, cut into slabs of x (rows = slab *
    span + row - lo, slab-major, at most one CSR row for every 8 entries):
    the CSR equals numpy's, and the plain sum equals the reference's matvec
    (bit for bit on integer-valued x). A bipartite graph of few items gives
    the v side a short row span, so it takes many slabs."""
    from repro_torch.graphs import bipartite_ratings

    g = bipartite_ratings(300, 20, avg_ratings=10.0, seed=1)
    rng = np.random.default_rng(slab_cols)
    u, v, n, m = torch.as_tensor(g.u), torch.as_tensor(g.v), g.n, g.m
    keep = rng.random(m) > 0.2
    wt = rng.integers(1, 4, m).astype(np.float64)
    a = segments(u, n, m, wt=torch.as_tensor(wt), keep=torch.as_tensor(keep), slab_cols=slab_cols)
    b = segments(v, n, m, wt=torch.as_tensor(wt), keep=torch.as_tensor(keep), slab_cols=slab_cols)
    for seg, rows_of in ((a, g.u), (b, g.v)):
        e = np.flatnonzero(keep)
        r = rows_of[e]
        lo, span = int(r.min()), int(r.max() - r.min() + 1)
        in_order = np.all(np.diff(e[np.argsort(r, kind="stable")]) >= 0)  # x read in order once grouped
        k = 1 if in_order else max(1, min(-(-m // slab_cols), len(e) // (8 * span)))
        if k == 1:
            lo, span, key = 0, n, r
        else:
            key = (e * k // m) * span + (r - lo)
        order = e[np.argsort(key, kind="stable")]
        assert (seg.lo, seg.span, seg.slabs) == (lo, span, k)
        np.testing.assert_array_equal(seg.offsets.numpy(),
                                      np.concatenate([[0], np.cumsum(np.bincount(key, minlength=k * span))]))
        np.testing.assert_array_equal(seg.src.numpy(), order)
        np.testing.assert_array_equal(seg.wt.numpy(), wt[order])
    if slab_cols == 97:
        assert b.slabs > 8 and a.slabs == 1  # the v side reads x out of order; the u side in order
    ref = R.Incidence(u=jnp.asarray(g.u), v=jnp.asarray(g.v), n_vertices=n, weights=jnp.asarray(wt),
                      edge_mask=jnp.asarray(keep))
    for x in (rng.random(m).astype(dtype), rng.integers(0, 9, m).astype(dtype)):
        want = np.asarray(ref.matvec(jnp.asarray(x)))
        got = incidence_scatter_ref(torch.as_tensor(x), a, b).numpy()
        np.testing.assert_allclose(got, want, rtol=TOLS[dtype], atol=TOLS[dtype])
    np.testing.assert_array_equal(got, want)

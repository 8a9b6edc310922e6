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
* The kernel's dispatch order over both sides' merge tiles
  (``dispatch_order``) equals a numpy reckoning from the CSR: every tile
  once, each side in its own order, the in-order side's tiles of slab k
  next to the slabbed side's slab-k tiles, the same on every build, and
  side-major where there is nothing to interleave (one side, an empty,
  unslabbed or out-of-order side, both sides in slabs).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import operators as R
from repro_torch import kernels as K
from repro_torch.core import operators as T
from repro_torch.kernels.incidence_scatter import MERGE_TILE, dispatch_order, segments
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


def _ratings(n_users=3_000, n_items=40, seed=1):
    """A bipartite graph whose v side (few items, many ratings) is cut into
    slabs of x at 5,000 values a slab: ~56k edges, some 57 merge tiles."""
    from repro_torch.graphs import bipartite_ratings

    g = bipartite_ratings(n_users, n_items, avg_ratings=30.0, seed=seed)
    return g, torch.as_tensor(g.u), torch.as_tensor(g.v)


def _np_dispatch_order(sides):
    """The dispatch order reckoned with numpy from the CSR alone: each tile's
    start by the merge-path search; where one side is in slabs and the other
    reads x in ascending order, tiles sorted by (slab of x they start
    reading, in-order side first), stably; else side-major."""
    tiles = [-(-(s.slabs * s.span + s.nnz) // MERGE_TILE) for s in sides]
    ids = np.arange(sum(tiles))
    if len(sides) == 1 or (sides[0].slabs > 1) == (sides[1].slabs > 1):
        return ids
    cut = 0 if sides[0].slabs > 1 else 1
    flat = sides[1 - cut]
    at_flat = np.arange(flat.nnz) if flat.src is None else flat.src.numpy()
    if flat.nnz == 0 or np.any(np.diff(at_flat) < 0):
        return ids
    keys = []
    for k, (s, t) in enumerate(zip(sides, tiles)):
        offsets = s.offsets.numpy()
        starts = [_merge_path_rows(offsets, d * MERGE_TILE) for d in range(t)]  # CSR rows before each tile
        if k == cut:
            keys.append(2 * (np.minimum(starts, s.slabs * s.span - 1) // s.span) + 1)
        else:
            first = np.minimum(np.arange(t) * MERGE_TILE - np.asarray(starts), s.nnz - 1)
            keys.append(2 * (at_flat[first] * sides[cut].slabs // s.cols))
    return np.argsort(np.concatenate(keys), kind="stable")


ORDER_CASES = ["interleaved", "swapped", "masked", "weighted", "unslabbed", "one_side", "empty_side",
               "both_slabbed", "out_of_order_unslabbed"]


def _order_case(case):
    g, u, v = _ratings()
    n, m = g.n, g.m
    keep = torch.as_tensor(np.random.default_rng(5).random(m) > 0.25)
    wt = torch.as_tensor(np.random.default_rng(6).integers(1, 4, m).astype(np.float64))
    side = {"interleaved": lambda: (segments(u, n, m, slab_cols=5_000), segments(v, n, m, slab_cols=5_000)),
            "swapped": lambda: (segments(v, n, m, slab_cols=5_000), segments(u, n, m, slab_cols=5_000)),
            "masked": lambda: (segments(u, n, m, keep=keep, slab_cols=5_000),
                               segments(v, n, m, keep=keep, slab_cols=5_000)),
            "weighted": lambda: (segments(u, n, m, wt=wt, keep=keep, slab_cols=5_000),
                                 segments(v, n, m, wt=wt, keep=keep, slab_cols=5_000)),
            "unslabbed": lambda: (segments(u, n, m), segments(v, n, m)),
            "one_side": lambda: (segments(v, n, m, slab_cols=5_000),),
            "empty_side": lambda: (segments(u, n, m, keep=torch.zeros(m, dtype=torch.bool), slab_cols=5_000),
                                   segments(v, n, m, slab_cols=5_000)),
            "both_slabbed": lambda: (segments(u, n, n, src=v, slab_cols=97), segments(v, n, n, src=u, slab_cols=97)),
            "out_of_order_unslabbed": lambda: (segments(v, n, m, slab_cols=10**9),
                                               segments(v, n, m, slab_cols=5_000))}[case]
    return side()


@pytest.mark.parametrize("case", ORDER_CASES)
def test_dispatch_order_matches_numpy(case):
    """The kernel's dispatch order over both sides' merge tiles against a
    numpy reckoning from the CSR: every tile of both sides exactly once,
    each side's tiles in their own order, and the same order from a second
    build of the segments."""
    sides = _order_case(case)
    order = dispatch_order(*sides)
    assert order.dtype == torch.int32
    want = _np_dispatch_order(sides)
    np.testing.assert_array_equal(order.numpy(), want)
    tiles = [s.tiles for s in sides]
    assert sorted(order.tolist()) == list(range(sum(tiles)))
    o = order.numpy()
    assert np.all(np.diff(o[o < tiles[0]]) > 0) and np.all(np.diff(o[o >= tiles[0]]) > 0)
    assert torch.equal(dispatch_order(*_order_case(case)), order)
    interleaved = case in ("interleaved", "swapped", "masked", "weighted")
    assert interleaved != torch.equal(order, torch.arange(sum(tiles), dtype=torch.int32))


@pytest.mark.parametrize("case", ["interleaved", "swapped", "masked"])
def test_dispatch_order_groups_tiles_by_slab(case):
    """Along the interleaved order the slab of x each tile starts reading
    never decreases, and slab k's tiles of the in-order side come right
    before the slabbed side's slab-k tiles: the in-order side's tiles that
    read x[k C, (k + 1) C) sit with slab k."""
    sides = _order_case(case)
    cut = 0 if sides[0].slabs > 1 else 1
    flat, slabbed = sides[1 - cut], sides[cut]
    order = dispatch_order(*sides).numpy()
    t_first = sides[0].tiles
    slab, is_cut = [], []
    for t in order:
        k, local = (0, t) if t < t_first else (1, t - t_first)
        s = sides[k]
        start = int(s.splits[local])  # CSR rows before the tile
        if k == cut:
            slab.append(min(start, s.slabs * s.span - 1) // s.span)
        else:
            j = min(local * MERGE_TILE - start, s.nnz - 1)
            x_at = j if s.src is None else int(s.src[j])
            slab.append(x_at * slabbed.slabs // flat.cols)
        is_cut.append(k == cut)
    slab, is_cut = np.asarray(slab), np.asarray(is_cut)
    assert np.all(np.diff(2 * slab + is_cut) >= 0)
    assert len(set(slab[is_cut].tolist())) == slabbed.slabs > 8  # every slab has tiles of the slabbed side
    for k in range(slabbed.slabs):
        run = np.flatnonzero(slab == k)
        assert np.all(np.diff(run) == 1)  # slab k's tiles of both sides are one run


def test_segments_ordered_flag():
    """``ordered`` says whether the entries, in CSR order, read x at
    ascending indices; a side cut into slabs never does."""
    g, u, v = _ratings()
    n, m = g.n, g.m
    keep = torch.as_tensor(np.random.default_rng(5).random(m) > 0.25)
    for s, want in ((segments(u, n, m), True), (segments(u, n, m, keep=keep), True),
                    (segments(v, n, m, slab_cols=10**9), False), (segments(v, n, m, slab_cols=5_000), False),
                    (segments(u, n, n, src=v), False), (segments(u[:1], n, 1), True)):
        assert s.ordered == want
        at = np.arange(s.nnz) if s.src is None else s.src.numpy()
        assert want == bool(np.all(np.diff(at) >= 0))
    assert segments(v, n, m, slab_cols=5_000).slabs > 1


def test_cpu_scatter_ignores_order(small_graphs):
    """On the CPU the wrapper is the plain version whatever order it is
    given: the order only schedules the kernel's tiles."""
    g, u, v = _ratings()
    a, b = segments(u, g.n, g.m, slab_cols=5_000), segments(v, g.n, g.m, slab_cols=5_000)
    x = torch.as_tensor(np.random.default_rng(2).random(g.m))
    want = incidence_scatter_ref(x, a, b)
    for order in (dispatch_order(a, b), torch.arange(a.tiles + b.tiles, dtype=torch.int32)):
        assert torch.equal(K.incidence_scatter(x, a, b, order=order), want)

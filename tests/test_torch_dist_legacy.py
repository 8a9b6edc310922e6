"""The port's deprecated ``core.mwu_dist`` shims and ``sparsela.distributed``'s
grid products vs the reference's, on the CPU.

Mirrors tests/test_distributed.py on a 2 x 2 grid of four gloo ranks
(``test_torch_ranks.run_ranks``, one start for the module): the shims at
that file's bars against the reference's single-device solve, and
``mx_local``, ``mtw_local`` and ``vertex_psum_lse`` on G = 2 against the
whole products, within 1e-12. In-process: the partition round trip, and
the one-rank shim (``mesh=None``) against the reference's.
"""
import numpy as np
import pytest

from repro.core import Incidence as RefIncidence
from repro.core import MWUOptions as RefOptions
from repro.core import OnesRow as RefOnesRow
from repro.core import mwu as ref_mwu
from repro.graphs import kron as ref_kron
from repro.graphs import rgg as ref_rgg
from repro.graphs.baselines import greedy_maximal_matching as ref_greedy
from repro_torch.graphs import Graph, rgg
from repro_torch.sparsela import partition_edges
from test_torch_ranks import run_ranks

RANK_CODE = """
import warnings
import numpy as np
with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    import repro_torch.core.mwu_dist as MD
    import repro_torch.core.mwu_dist
deprecations = [str(w.message) for w in caught if issubclass(w.category, DeprecationWarning)]
from repro_torch.dist import MeshPlan
from repro_torch.graphs import rgg
from repro_torch.graphs.baselines import greedy_maximal_matching
from repro_torch.sparsela import partition_edges
from repro_torch.sparsela.distributed import Grid, mtw_local, mx_local, vertex_psum_lse

report = {"rank": RANK, "deprecations": deprecations}
mesh = MeshPlan(pod=2, data=2)

g = rgg(9, seed=1)
bound = float(greedy_maximal_matching(g))
res = MD.dist_matching_solve(partition_edges(g, grid=2), g.n, bound, mesh, eps=0.1, max_iter=5000, device="cpu")
report["match"] = {"status": int(res.status), "objective": res.objective, "max_px": float(res.max_px),
                   "iters": int(res.iters), "x_shape": list(res.x.shape), "x_sum": float(res.x.sum())}

g8 = rgg(8, seed=0)
res = MD.dist_matching_solve(partition_edges(g8, grid=2), g8.n, g8.n * 2.0, mesh, eps=0.1, max_iter=2000,
                             device="cpu")
report["infeasible"] = {"status": int(res.status)}

part = partition_edges(g, grid=2)
fn = MD.make_pod_parallel_solver(mesh, 2, part.block, g.n, g.m, max_iter=4000, device="cpu")
status, iters, obj, max_px = fn([bound, g.n * 2.0], part.u_loc, part.v_loc, part.mask)
report["pod_parallel"] = {"status": status.tolist(), "objective": obj.tolist()}

# the grid products on G = 2, against the whole products
grid = Grid.build(2)
i, j = grid.i, grid.j
rng = np.random.default_rng(0)
x_cells = rng.random(part.u_loc.shape)  # one value an edge slot (padding slots masked out)
w = rng.random(part.n_pad)
a = 3.0 * rng.standard_normal(part.n_pad)
u_loc, v_loc = torch.as_tensor(part.u_loc[i, j].astype(np.int64)), torch.as_tensor(part.v_loc[i, j].astype(np.int64))
mask = torch.as_tensor(part.mask[i, j])
blk = slice(i * part.block, (i + 1) * part.block)
y = mx_local(u_loc, v_loc, mask, torch.as_tensor(x_cells[i, j]), part.block, grid)
gl = mtw_local(u_loc, v_loc, mask, torch.as_tensor(w[blk]), grid)
lse, e, s = vertex_psum_lse(torch.as_tensor(a[blk]), grid)
# whole: every real edge's global endpoints and its value
I, J, Kc = np.nonzero(part.mask)
gu = part.u_loc[I, J, Kc] + I * part.block
gv = part.v_loc[I, J, Kc] + J * part.block
xv = x_cells[I, J, Kc]
y_full = np.bincount(gu, xv, part.n_pad) + np.bincount(gv, xv, part.n_pad)
g_full = np.where(part.mask[i, j], w[part.u_loc[i, j] + i * part.block] + w[part.v_loc[i, j] + j * part.block], 0.0)
m = a.max()
report["grid"] = {"mx": float(np.abs(y.numpy() - y_full[blk]).max()),
                  "mtw": float(np.abs(gl.numpy() - g_full).max()),
                  "lse": abs(float(lse) - float(m + np.log(np.exp(a - m).sum()))),
                  "softmax": float(np.abs((e / s).numpy() - np.exp(a[blk] - m) / np.exp(a - m).sum()).max()),
                  "edges": int(part.mask.sum()), "m": g.m}
print(json.dumps(report))
"""


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(RANK_CODE, world=4)


def _ref_single(g, bound, max_iter):
    """The reference's single-device binary-rule solve (tests/test_distributed.py's oracle)."""
    import jax.numpy as jnp

    P = RefIncidence(u=jnp.asarray(g.u), v=jnp.asarray(g.v), n_vertices=g.n)
    C = RefOnesRow(c=jnp.ones((g.m,)), inv_bound=jnp.asarray(1.0 / bound))
    return ref_mwu.solve(P, C, RefOptions(eps=0.1, step_rule="binary", max_iter=max_iter))


def test_shims_warn_once(ranks):
    for r in ranks:
        assert len(r["deprecations"]) == 1 and "repro_torch.dist" in r["deprecations"][0]


def test_dist_matching_matches_single_device(ranks):
    g = ref_rgg(9, seed=1)
    bound = float(ref_greedy(g))
    ref = _ref_single(g, bound, 5000)
    for r in ranks:
        assert r["match"] == ranks[0]["match"]
    d = ranks[0]["match"]
    assert d["status"] == 1 and int(ref.status) == 1  # FEASIBLE
    ref_obj = float(np.sum(np.asarray(ref.x)))
    assert abs(d["objective"] - ref_obj) / ref_obj < 0.15
    assert d["max_px"] <= 1.1 + 1e-6
    assert abs(d["iters"] - int(ref.iters)) <= 10
    assert d["x_shape"][:2] == [2, 2] and d["x_sum"] == pytest.approx(d["objective"], rel=1e-12)


def test_dist_infeasible_detection(ranks):
    assert all(r["infeasible"]["status"] in (2, 3) for r in ranks)  # INFEASIBLE / ITER_LIMIT


def test_pod_parallel_bounds(ranks):
    """Two bounds solved concurrently, one per lane group of the (2, 2) plan."""
    for r in ranks:
        assert r["pod_parallel"]["status"][0] == 1  # feasible bound
        assert r["pod_parallel"]["status"][1] in (2, 3)  # infeasible bound


@pytest.mark.parametrize("what", ["mx", "mtw", "lse", "softmax"])
def test_grid_products(ranks, what):
    """mx_local, mtw_local and vertex_psum_lse on every rank of the 2 x 2 grid
    equal the whole products within 1e-12."""
    for r in ranks:
        assert r["grid"]["edges"] == r["grid"]["m"]
        assert r["grid"][what] <= 1e-12, (r["rank"], r["grid"])


def test_partition_roundtrip():
    """Every real edge appears exactly once with its global ids (the reference's test, on the port)."""
    g = ref_kron(8, seed=3, edgefactor=8)
    part = partition_edges(Graph(n=g.n, u=g.u, v=g.v), grid=4)
    got = []
    for i in range(4):
        for j in range(4):
            msk = part.mask[i, j]
            got.append(np.stack([part.u_loc[i, j][msk] + i * part.block, part.v_loc[i, j][msk] + j * part.block], 1))
    got = np.concatenate(got)
    want = np.stack([g.u, g.v], 1)
    np.testing.assert_array_equal(got[np.lexsort(got.T[::-1])], want[np.lexsort(want.T[::-1])])


def test_dist_matching_one_rank_meets_reference():
    """mesh=None: one rank, the same shim in both packages, at the bars above."""
    import warnings

    from repro.sparsela.partition import partition_edges as ref_partition
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from repro.core.mwu_dist import dist_matching_solve as ref_dms
        from repro_torch.core.mwu_dist import dist_matching_solve

    g = ref_rgg(8, seed=2)
    bound = float(ref_greedy(g))
    ref = ref_dms(ref_partition(g, grid=2), g.n, bound, None, eps=0.1, max_iter=5000)
    got = dist_matching_solve(partition_edges(rgg(8, seed=2), grid=2), g.n, bound, None, eps=0.1, max_iter=5000,
                              device="cpu")
    assert int(got.status) == int(ref.status) == 1
    assert got.objective == pytest.approx(float(ref.objective), rel=0.15)
    assert abs(int(got.iters) - int(ref.iters)) <= 10
    assert tuple(got.x.shape) == tuple(np.asarray(ref.x).shape)

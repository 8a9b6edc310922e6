"""The port on the card: each CUDA kernel vs its plain version, and solves
on the card vs the same solves on the CPU.

Every test here is marked ``cuda`` and skips where no card is present.
The file imports neither jax nor ``repro``, so on a machine with a card
and without jax it runs alone, skipping the repo's conftest.py:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.api import MWUOptions, Solver, Status
from repro_torch.graphs import bipartite_ratings, build, generalized_matching_problem, rgg
from repro_torch.kernels.axpy_reduce.ref import axpy_reduce_ref
from repro_torch.kernels.incidence_gather.ref import incidence_gather_ref
from repro_torch.kernels.linesearch_probe.ref import linesearch_probe_ref
from repro_torch.kernels.softmax_weights.ref import softmax_weights_ref

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

    out, mn, mx = K.axpy_reduce(yc, dyc, 3.25)
    out_r, mn_r, mx_r = axpy_reduce_ref(y, dy, 3.25)
    assert torch.equal(out.cpu(), out_r)
    assert float(mn) == float(mn_r) and float(mx) == float(mx_r)

    idx = torch.randint(0, n, (2 * n + 7,), generator=gen, dtype=torch.int32)
    jdx = idx.flip(0).contiguous()
    g = K.incidence_gather(idx.to(cuda), jdx.to(cuda), yc)
    assert torch.equal(g.cpu(), incidence_gather_ref(idx, jdx, y))
    torch.cuda.synchronize()
    assert K.launch_counts() == {"incidence_gather": 1, "softmax_weights": 1, "linesearch_probe": 2,
                                 "axpy_reduce": 1}


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
    assert counts["softmax_weights"] > 0 and counts["axpy_reduce"] > 0
    assert (counts["incidence_gather"] > 0) == (family != "dom-set")  # dom-set's ops are scatter-based
    assert (counts["linesearch_probe"] > 0) == (family != "gen-match")  # masked probes stay plain

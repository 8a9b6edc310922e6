"""A whole run with the timed path broken underneath comes out not
correct: once for each fault a cell of this benchmark can have (one card,
so no exchange between chips)."""
import numpy as np
import pytest

from lpbench import harness

from .conftest import SERVE

CELLS = ["bmatch-netflix.solve", "vcover-kron.solve", SERVE]


def _run(name, tiny, root_of):
    return harness.run_cell(name, 2**31 + 23, 0.3, False, device="cpu", overrides=tiny[name], root=root_of(name))


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, tiny, root_of):
    assert _run(name, tiny, root_of)["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_step_that_leaves_the_state_unchanged(name, tiny, root_of, monkeypatch):
    """Every MWU update moves x, y and z by a step of 0."""
    import repro_torch.core.mwu as mwu

    real = mwu.axpy_reduce
    monkeypatch.setattr(mwu, "axpy_reduce", lambda y, dy, alpha, **kw: real(y, dy, alpha * 0, **kw))
    out = _run(name, tiny, root_of)
    assert not out["correct"] and out["checks"]["unsolved"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_half_the_lanes_left_out(name, tiny, root_of, monkeypatch):
    """A round solves the first half of its lanes and gives the rest the
    mean of their results: the bound search then trusts bounds nobody
    solved, and a served request gets another request's x."""
    from repro_torch.api import solver as api_solver

    real = api_solver.solve_lanes

    def half(lanes, opts, **kw):
        res = real(lanes[: max(1, len(lanes) // 2)], opts, **kw)
        k = len(lanes)

        def fill(a):
            a = np.asarray(a)
            return np.concatenate([a, np.repeat(a.mean(keepdims=True).astype(a.dtype), k - len(a))])

        import torch

        x = torch.cat([res.x, res.x.mean(0, keepdim=True).expand(k - res.x.shape[0], -1)])
        return type(res)(x=x, status=np.concatenate([res.status, np.repeat(res.status[:1], k - len(res.status))]),
                         iters=fill(res.iters), ls_probes=fill(res.ls_probes), max_px=fill(res.max_px),
                         min_cx=fill(res.min_cx))

    monkeypatch.setattr(api_solver, "solve_lanes", half)
    assert not _run(name, tiny, root_of)["correct"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("what", ["x", "objective"])
def test_answer_altered_where_it_is_produced(name, what, tiny, root_of, monkeypatch):
    """The certificate (the Solver's and the engine's) hands back an x
    scaled by 1.001, or an objective 0.1% off."""
    from repro_torch.api import solver as api_solver
    from repro_torch.lpserve import engine

    real = api_solver.certify_solution

    def altered(*args, **kw):
        sol = real(*args, **kw)
        if what == "x":
            sol.x = sol.x * 1.001
        else:
            sol.objective *= 1.001
        return sol

    monkeypatch.setattr(api_solver, "certify_solution", altered)
    monkeypatch.setattr(engine, "certify_solution", altered)
    assert not _run(name, tiny, root_of)["correct"]

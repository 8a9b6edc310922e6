"""Declarative problem specs for the solver facade, in PyTorch.

Port of ``repro.api.problem``. A :class:`Problem` describes one graph LP:
the implicit operators (P packing rows, C covering rows), an optional
linear objective, optional row masks, search bounds, and metadata (sense,
kind, how the search bound enters the feasibility LP). It is a plain
dataclass of tensors; ``device`` and ``dtype`` say where its tensors live
and in which float type its bound-dependent rows are built.

``bound_mode`` declares how a candidate bound M builds the feasibility
LP ``exists x >= 0 : P x <= 1, C x >= 1`` (paper §2.2, §3):

* ``objective_covering`` — max <c,x> : covering row <c,x>/M >= 1 (packing LPs)
* ``objective_packing``  — min <c,x> : packing  row <c,x>/M <= 1 (covering LPs)
* ``scale_packing``      — scale every packing row by 1/M (densest subgraph's
                           density bound D, eq. 15)
* ``callable``           — escape hatch: ``make_ops(M) -> (P, C)``
* ``none``               — pure feasibility, no bound search

:func:`problem_from_numpy` rebuilds a Problem from plain fields (operators
as dicts keyed by class name, arrays as numpy), so that a test can hand
the very instance of a reference ``repro.api.Problem`` to the port.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ..core.operators import OPS, LinOp, OnesRow, ScaledRows

__all__ = ["Problem", "SENSES", "BOUND_MODES", "problem_from_numpy"]

SENSES = ("max", "min", "feasibility")
BOUND_MODES = ("objective_covering", "objective_packing", "scale_packing", "callable", "none")


@dataclass
class Problem:
    """One graph LP, declaratively. ``graph`` is host-side metadata only."""

    name: str
    kind: str  # "packing" | "covering" | "densest" | "mixed"
    sense: str  # see SENSES
    bound_mode: str  # see BOUND_MODES
    P: LinOp | None = None
    C: LinOp | None = None
    c: Any = None  # optional (n,) nonnegative objective
    p_mask: Any = None  # optional (m_p,) bool
    c_mask: Any = None  # optional (m_c,) bool
    lo: Any = 1.0  # search bracket (feasible side depends on sense)
    hi: Any = 1.0
    n_vars: int = 0
    nnz: int = 0
    make_ops: Callable | None = None  # bound_mode="callable" only
    graph: Any = None  # metadata
    device: Any = "cuda"
    dtype: torch.dtype = torch.float64

    def __post_init__(self):
        if self.sense not in SENSES:
            raise ValueError(f"sense must be one of {SENSES}, got {self.sense!r}")
        if self.bound_mode not in BOUND_MODES:
            raise ValueError(f"bound_mode must be one of {BOUND_MODES}, got {self.bound_mode!r}")

    # -- feasibility instantiation ------------------------------------
    def instantiate(self, bound=None):
        """Build (P, C, p_mask, c_mask) for one candidate bound (a host float)."""
        if self.bound_mode == "none":
            return self.P, self.C, self.p_mask, self.c_mask
        if bound is None:
            raise ValueError(f"problem {self.name!r} needs a bound (mode {self.bound_mode!r})")
        if self.bound_mode == "callable":
            P, C = self.make_ops(bound)
            return P, C, self.p_mask, self.c_mask
        if self.bound_mode in ("objective_covering", "objective_packing"):
            inv = torch.tensor(1.0 / float(bound), dtype=self.c.dtype, device=self.c.device)
            row = OnesRow(c=self.c, inv_bound=inv)
            if self.bound_mode == "objective_covering":
                return self.P, row, self.p_mask, None
            return row, self.C, None, self.c_mask
        # scale_packing: divide every packing row by the bound
        ones = torch.ones(self.P.shape[0], dtype=self.dtype, device=self.device)
        return ScaledRows(scale=ones / float(bound), inner=self.P), self.C, self.p_mask, self.c_mask

    @property
    def feasible_side(self) -> str:
        """"max" problems are feasible for small bounds, "min"/densest for large ones."""
        return "lo" if self.sense == "max" else "hi"

    def solve(self, opts=None, **solver_kwargs):
        """Solve with a default :class:`repro_torch.api.Solver`."""
        from .solver import Solver

        return Solver(opts, **solver_kwargs).solve(self)


def _tensor(a: np.ndarray, device, dtype) -> torch.Tensor:
    if np.issubdtype(a.dtype, np.integer):
        return torch.tensor(a.astype(np.int32), device=device)
    if a.dtype == np.bool_:
        return torch.tensor(a, device=device)
    return torch.tensor(a, device=device).to(dtype)


def _from_fields(value, device, dtype):
    if isinstance(value, dict) and "op" in value:
        cls = OPS[value["op"]]
        kw = {k: _from_fields(v, device, dtype) for k, v in value.items() if k != "op"}
        if "device" in {f.name for f in dataclasses.fields(cls)}:
            kw["device"] = device
        return cls(**kw)
    if isinstance(value, (tuple, list)):
        return tuple(_from_fields(v, device, dtype) for v in value)
    if isinstance(value, np.ndarray):
        return _tensor(value, device, dtype)
    return value


def problem_from_numpy(fields: dict, *, device="cuda", dtype: torch.dtype = torch.float64) -> Problem:
    """A port :class:`Problem` from plain fields.

    ``fields`` holds the Problem's fields by name; an operator is a dict
    with its class name under ``"op"`` and its own fields (nested
    operators as dicts, ``VStack.ops`` as a tuple), arrays as numpy. Index
    arrays become int32 tensors, bool arrays masks, float arrays tensors
    of ``dtype``; all on ``device``.
    """
    kw = {k: _from_fields(v, device, dtype) for k, v in fields.items()}
    for k in ("lo", "hi"):
        if k in kw:
            kw[k] = float(kw[k])
    return Problem(**kw, device=device, dtype=dtype)

"""The plain reference for bipartite matching, ``max 1.x : M x <= 1`` with
one variable an edge and one packing row a vertex: NumPy, SciPy, PyTorch.

It imports nothing of the program. It gets the graph arrays the benchmark
made (the ones the program was handed) and, to judge, an answer's ``x``,
objective and certified bound as plain numbers, and works out on its own:

* :func:`exact_optimum`: the LP is integral, so its optimum is the size of
  a maximum matching (Hopcroft-Karp, SciPy's C code);
* :func:`judge`, in float64 on the arrays' device: ``feas_excess``, how far
  ``x`` breaks the LP (``max(M x) - 1``, and ``-min(x)``); ``obj_err``, the
  objective against ``sum(x)``, relative; ``opt_gap``, how far the
  objective falls below the optimum, relative; ``bound_gap``, how far the
  certified bound lies beyond what the optimum allows: a bound found
  feasible within (1+eps) has ``bound <= (1+eps) opt``, so a sound answer
  reads at most 0.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import maximum_bipartite_matching


def exact_optimum(n: int, u: np.ndarray, v: np.ndarray, split: int) -> float:
    """Users are ``[0, split)``, items ``[split, n)``; every edge ``u < split <= v``."""
    biadj = sp.csr_matrix((np.ones(u.size, np.int8), (u, v - split)), shape=(split, n - split))
    return float((maximum_bipartite_matching(biadj, perm_type="column") >= 0).sum())


def judge(n: int, u: torch.Tensor, v: torch.Tensor, x, objective: float, bound: float, opt: float,
          eps: float) -> dict:
    x = torch.as_tensor(np.asarray(x, np.float64), device=u.device)
    loads = torch.zeros(n, dtype=torch.float64, device=u.device)
    loads.index_add_(0, u.long(), x).index_add_(0, v.long(), x)
    excess = max(float(loads.max()) - 1.0, -float(x.min()))
    total = float(x.sum())
    return {"feas_excess": excess, "obj_err": abs(objective - total) / max(abs(total), 1e-300),
            "opt_gap": (opt - objective) / opt, "bound_gap": bound / ((1.0 + eps) * opt) - 1.0}

"""The plain reference for vertex cover, ``min 1.x : M^T x >= 1`` with one
variable a vertex and one covering row an edge: NumPy, SciPy, PyTorch.

It imports nothing of the program. It gets the graph arrays the benchmark
made (the ones the program was handed) and, to judge, an answer's ``x``,
objective and certified bound as plain numbers, and works out on its own:

* :func:`exact_optimum`: the LP is half-integral, and its optimum is half
  the size of a maximum matching of the bipartite double cover (each vertex
  twice, an edge ``u v`` as ``u v'`` and ``v u'``), by LP duality and
  Konig's theorem (Hopcroft-Karp, SciPy's C code);
* :func:`judge`, in float64 on the arrays' device: ``feas_excess``, how far
  ``x`` breaks the LP (``1 - min(M^T x)``, and ``-min(x)``); ``obj_err``,
  the objective against ``sum(x)``, relative; ``opt_gap``, how far the
  objective lies above the optimum, relative; ``bound_gap``, how far the
  certified bound lies beyond what the optimum allows: a bound found
  feasible within (1+eps) has ``bound >= opt / (1+eps)``, so a sound answer
  reads at most 0.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import maximum_bipartite_matching


def exact_optimum(n: int, u: np.ndarray, v: np.ndarray, split=None) -> float:
    rows, cols = np.concatenate([u, v]), np.concatenate([v, u])
    biadj = sp.csr_matrix((np.ones(rows.size, np.int8), (rows, cols)), shape=(n, n))
    return int((maximum_bipartite_matching(biadj, perm_type="column") >= 0).sum()) / 2.0


def judge(n: int, u: torch.Tensor, v: torch.Tensor, x, objective: float, bound: float, opt: float,
          eps: float) -> dict:
    x = torch.as_tensor(np.asarray(x, np.float64), device=u.device)
    excess = max(1.0 - float((x[u.long()] + x[v.long()]).min()), -float(x.min()))
    total = float(x.sum())
    return {"feas_excess": excess, "obj_err": abs(objective - total) / max(abs(total), 1e-300),
            "opt_gap": (objective - opt) / opt, "bound_gap": opt / ((1.0 + eps) * bound) - 1.0}

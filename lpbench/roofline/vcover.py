"""HBM bytes that any implementation of one MWU iteration of vertex cover
must move, from the problem's shapes alone.

The LP is ``min 1.x : M^T x >= 1`` with one variable per vertex (``n``)
and one covering row per edge (``m``). Counted, each once:

* the edge endpoints, two int32 a edge (``8 m``), read once per **loop**
  iteration and shared by the lanes of a round (each covering row reads
  its two endpoints' ``x``);
* ``x``, one float64 a vertex, read once and written once per **lane**
  iteration (``16 n``).

Left out, so that the sum stays a lower bound: the covering rows' state
``z = M^T x`` and their softmax weights (an implementation may recompute
them from ``x`` and the endpoints each iteration), the objective row, and
every second pass. On Kronecker graphs (about 14 edges a vertex) the
endpoints bound it.
"""
from __future__ import annotations


def iteration_bytes(n_vertices: int, n_edges: int) -> tuple[float, float]:
    """``(bytes a loop iteration, bytes a lane iteration)``."""
    return 8.0 * n_edges, 16.0 * n_vertices

"""HBM bytes that any implementation of one MWU iteration of bipartite
matching must move, from the problem's shapes alone.

The LP is ``max 1.x : M x <= 1`` with one variable per edge (``m`` of
them) and one packing row per vertex. Counted, each once:

* the edge endpoints, two int32 a edge (``8 m``), read once per **loop**
  iteration: the lanes of a round share the graph, so one pass over it
  can serve them all;
* ``x``, one float64 per edge, read once and written once per **lane**
  iteration (``16 m``): every lane moves its own ``x``.

Left out, so that the sum stays a lower bound whatever a later change
fuses: the vertex loads ``y`` and the objective row's state (``O(n)``, a
few MB against GBs of ``x``), the weights and the step direction (an
implementation may recompute them from ``y`` and the endpoints), and
every second pass over an operand. At the Netflix shape ``x`` bounds it:
16 of every 24 bytes.
"""
from __future__ import annotations


def iteration_bytes(n_vertices: int, n_edges: int) -> tuple[float, float]:
    """``(bytes a loop iteration, bytes a lane iteration)``."""
    return 8.0 * n_edges, 16.0 * n_edges

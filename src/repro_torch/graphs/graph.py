"""Graph container used across the port (copy of ``repro.graphs.graph``).

Edges are stored once (u < v canonical order for undirected graphs),
deduplicated, self-loop free — matching the paper's assumptions (§3).
Host-side state is numpy; the problem builders copy ``u``/``v`` to the
solve's device as int32 tensors. The fields are the reference ``Graph``'s,
so ``Graph(n=g.n, u=g.u, v=g.v, name=g.name,
bipartite_split=g.bipartite_split)`` carries a reference graph over as is.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["Graph"]


@dataclass
class Graph:
    n: int  # |V|
    u: np.ndarray  # (m,) int32 endpoint 0
    v: np.ndarray  # (m,) int32 endpoint 1
    name: str = "graph"
    bipartite_split: int | None = None  # first right-vertex id for bipartite graphs

    def __post_init__(self):
        self.u = np.asarray(self.u, np.int32)
        self.v = np.asarray(self.v, np.int32)
        assert self.u.shape == self.v.shape

    @property
    def m(self) -> int:
        return int(self.u.shape[0])

    @staticmethod
    def from_edges(n: int, edges: np.ndarray, name: str = "graph", bipartite_split=None) -> "Graph":
        """Canonicalize: drop self loops, sort endpoints, dedupe."""
        e = np.asarray(edges, np.int64).reshape(-1, 2)
        e = e[e[:, 0] != e[:, 1]]
        lo = np.minimum(e[:, 0], e[:, 1])
        hi = np.maximum(e[:, 0], e[:, 1])
        key = lo * n + hi
        _, idx = np.unique(key, return_index=True)
        return Graph(n=n, u=lo[idx].astype(np.int32), v=hi[idx].astype(np.int32),
                     name=name, bipartite_split=bipartite_split)

    def degrees(self) -> np.ndarray:
        d = np.zeros(self.n, np.int64)
        np.add.at(d, self.u, 1)
        np.add.at(d, self.v, 1)
        return d

    def adjacency_lists(self):
        """CSR-style neighbor lists (host side, for combinatorial baselines)."""
        src = np.concatenate([self.u, self.v])
        dst = np.concatenate([self.v, self.u])
        eid = np.tile(np.arange(self.m, dtype=np.int32), 2)
        order = np.argsort(src, kind="stable")
        deg = np.bincount(src, minlength=self.n)
        ptr = np.zeros(self.n + 1, np.int64)
        np.cumsum(deg, out=ptr[1:])
        return ptr, dst[order].astype(np.int32), eid[order]

    def validate(self):
        assert self.u.min(initial=0) >= 0 and self.v.max(initial=-1) < self.n
        assert np.all(self.u < self.v), "edges must be canonical (u < v)"
        if self.bipartite_split is not None:
            s = self.bipartite_split
            assert np.all(self.u < s) and np.all(self.v >= s), "not bipartite"
        return True

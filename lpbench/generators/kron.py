"""Graph500 stochastic Kronecker graphs, made on the device.

A frozen copy of the semantics of ``repro_torch.graphs.kron`` and of the
Graph500 specification's generator, drawn with torch from a seed:
``edgefactor * 2**scale`` edge samples, each endpoint pair chosen one bit
level at a time with the initiator probabilities ``A, B, C`` (``D = 1 - A -
B - C``), then every vertex relabelled by one random permutation. Self
loops are dropped and the rest made canonical (``u < v``, no repeats,
sorted by ``(u, v)``), as ``Graph.from_edges`` makes them.
"""
from __future__ import annotations

import torch


def generate(params: dict, gen: torch.Generator, device) -> dict:
    scale, ef = int(params["scale"]), int(params["edgefactor"])
    a, b, c = float(params["A"]), float(params["B"]), float(params["C"])
    n, m = 1 << scale, ef << scale
    ab, c_norm, a_norm = a + b, c / (1.0 - (a + b)), a / (a + b)
    i = torch.zeros(m, dtype=torch.int64, device=device)
    j = torch.zeros(m, dtype=torch.int64, device=device)
    for bit in range(scale):
        r = torch.rand(2, m, dtype=torch.float64, device=device, generator=gen)
        ii = r[0] > ab
        jj = r[1] > torch.where(ii, c_norm, a_norm)
        i += ii.to(torch.int64) << bit
        j += jj.to(torch.int64) << bit
        del r, ii, jj
    perm = torch.randperm(n, device=device, generator=gen)
    i, j = perm[i], perm[j]
    keep = i != j
    i, j = i[keep], j[keep]
    key = torch.unique(torch.minimum(i, j) * n + torch.maximum(i, j))
    del i, j, keep
    return {"n": n, "u": (key // n).to(torch.int32), "v": (key % n).to(torch.int32), "bipartite_split": None}

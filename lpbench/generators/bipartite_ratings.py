"""User-item rating graphs of the Netflix Prize shape, made on the device.

A frozen copy of the semantics of ``repro_torch.graphs.bipartite_ratings``
(users on the left ``[0, n_users)``, items on the right ``[n_users,
n_users + n_items)``, one edge a rating), drawn with torch from a seed:

* each user rates ``max(Poisson(avg_ratings), min_ratings)`` items;
* an item is ``floor(n_items / r) mod n_items`` for ``r`` Pareto with
  shape ``zipf_a - 1`` and scale 1, so item popularity falls off as a
  power law (``r = U ** (-1 / (zipf_a - 1))`` for ``U`` uniform on (0, 1]);
* repeated ratings of one item by one user are one edge.

Edges come back canonical (``u < v``, no self loops, no repeats) and sorted
by ``(u, v)``, as ``Graph.from_edges`` orders them.
"""
from __future__ import annotations

import torch


def generate(params: dict, gen: torch.Generator, device) -> dict:
    n_users, n_items = int(params["n_users"]), int(params["n_items"])
    avg, floor = float(params["avg_ratings"]), int(params["min_ratings"])
    shape = float(params["zipf_a"]) - 1.0
    rate = torch.full((n_users,), avg, dtype=torch.float64, device=device)
    counts = torch.poisson(rate, generator=gen).clamp_(min=floor).to(torch.int64)
    users = torch.repeat_interleave(torch.arange(n_users, device=device), counts)
    uni = 1.0 - torch.rand(users.numel(), dtype=torch.float64, device=device, generator=gen)  # (0, 1]
    items = torch.floor(n_items * uni.pow_(1.0 / shape)).to(torch.int64).remainder_(n_items)
    del uni
    key = torch.unique(users * n_items + items)  # sorted: by user, then item
    del users, items
    u = (key // n_items).to(torch.int32)
    v = (key % n_items + n_users).to(torch.int32)
    return {"n": n_users + n_items, "u": u, "v": v, "bipartite_split": n_users}

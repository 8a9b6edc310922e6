"""Plain PyTorch version of the incidence scatter, from the CSR segments."""
from __future__ import annotations

import torch

from .csr import Segments


def incidence_scatter_ref(x: torch.Tensor, a: Segments, b: Segments | None = None,
                          base: torch.Tensor | None = None) -> torch.Tensor:
    """out[r] = base[r] + the sums of row r's segments of ``a`` and ``b``,
    each segment summed by ``torch.segment_reduce`` over its entries' values
    (a side cut into slabs: its slabs' sums added by ``sum``)."""
    out = torch.zeros(a.rows, dtype=x.dtype, device=x.device) if base is None else base.clone()
    for s in (a, b):
        if s is None:
            continue
        vals = x[: s.nnz] if s.src is None else x.index_select(0, s.src)
        if s.wt is not None:
            vals = s.wt.to(x.dtype) * vals
        part = torch.segment_reduce(vals, "sum", offsets=s.offsets)
        if s.slabs > 1:
            part = part.view(s.slabs, s.span).sum(0)
        out[s.lo:s.lo + s.span] += part
    return out

"""Incidence gather ``g[e] = w[u[e]] + w[v[e]]`` (the product M^T w), with
the edge factor of a masked or weighted operator.

Port of ``repro.kernels.incidence_gather``. A CUDA ``w`` launches the
hand-written kernel of ``csrc/incidence_gather.cu``; a CPU ``w`` takes the
plain version in ``ref.py``. A CUDA call never falls back: it launches or
raises.
"""
from __future__ import annotations

import torch

from .. import loader
from .ref import incidence_gather_ref


def check_factor(name: str, like: torch.Tensor, u: torch.Tensor, mask: torch.Tensor | None,
                 weights: torch.Tensor | None) -> tuple:
    """Check an edge factor's parts for a kernel: the mask one byte an edge
    (``loader.check_keep`` against ``u``), the weights a vector of
    ``like``'s dtype and of u's length; return their addresses (None where
    absent)."""
    if weights is not None:
        loader.check_vectors(name, like, weights)
        if weights.shape[0] != u.shape[0]:
            raise ValueError(f"{name}: {weights.shape[0]} weights for {u.shape[0]} edges")
    return loader.check_keep(name, u, mask), None if weights is None else weights.data_ptr()


@loader.counted("incidence_gather", lambda r, u, v, w, *a, **k: {loader.dtype_rate(w.dtype): u.shape[0]})
def incidence_gather(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor, mask: torch.Tensor | None = None,
                     weights: torch.Tensor | None = None) -> torch.Tensor:
    """g[e] = w[u[e]] + w[v[e]] in w's dtype; ``u``, ``v`` int32 of one
    length. With ``mask`` (bool, one byte an edge) or ``weights`` (w's
    dtype) g is multiplied by the edge factor in the same pass:
    ``weights[e]`` (1 without) where ``mask[e]``, else 0."""
    if w.device.type == "cpu":
        return incidence_gather_ref(u, v, w, mask, weights)
    dtype = loader.check_vectors("incidence_gather", w)
    E = loader.check_indices("incidence_gather", w, u, v)
    mask_ptr, weights_ptr = check_factor("incidence_gather", w, u, mask, weights)
    g = torch.empty(E, dtype=dtype, device=w.device)
    with torch.cuda.device(w.device):
        rc = loader.kernel_fn("rt_incidence_gather", dtype)(
            u.data_ptr(), v.data_ptr(), w.data_ptr(), mask_ptr, weights_ptr, g.data_ptr(), E, loader.stream_handle(w)
        )
    loader.check_status(rc, "incidence_gather")
    loader.LAUNCHES["incidence_gather"] += 1
    return g

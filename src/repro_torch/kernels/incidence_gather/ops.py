"""Incidence gather ``g[e] = w[u[e]] + w[v[e]]`` (the product M^T w).

Port of ``repro.kernels.incidence_gather``. A CUDA ``w`` launches the
hand-written kernel of ``csrc/incidence_gather.cu``; a CPU ``w`` takes the
plain version in ``ref.py``. A CUDA call never falls back: it launches or
raises.
"""
import torch

from .. import loader
from .ref import incidence_gather_ref


def incidence_gather(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """g[e] = w[u[e]] + w[v[e]] in w's dtype; ``u``, ``v`` int32 of one length."""
    if w.device.type == "cpu":
        return incidence_gather_ref(u, v, w)
    dtype = loader.check_vectors("incidence_gather", w)
    E = loader.check_indices("incidence_gather", w, u, v)
    g = torch.empty(E, dtype=dtype, device=w.device)
    with torch.cuda.device(w.device):
        rc = loader.kernel_fn("rt_incidence_gather", dtype)(
            u.data_ptr(), v.data_ptr(), w.data_ptr(), g.data_ptr(), E, loader.stream_handle(w)
        )
    loader.check_status(rc, "incidence_gather")
    loader.LAUNCHES["incidence_gather"] += 1
    return g

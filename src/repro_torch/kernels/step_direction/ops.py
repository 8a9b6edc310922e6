"""Step direction of the MWU iteration with its max, in one launch.

``d = scale * max(0, 1 - g/h) * x`` and ``max(d)`` (paper Alg. 2 lines
7-8), g either given (read) or gathered as ``w[u] + w[v]`` (the incidence
gather, computed in registers and never written). A CUDA ``x`` launches
the hand-written kernel of ``csrc/step_direction.cu``; a CPU ``x`` takes
the plain version in ``ref.py``. d is bit-equal to the plain version.
"""
from __future__ import annotations

import functools

import torch

from .. import loader
from .ref import step_direction_ref


@functools.lru_cache(maxsize=None)
def _ticket(device: torch.device, stream: int) -> torch.Tensor:
    """The kernel's last-block counter, one per (device, stream): zero, and
    left at zero by every launch."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def step_direction(h: torch.Tensor, x: torch.Tensor, scale: float, g: torch.Tensor | None = None,
                   gather: tuple | None = None):
    """Returns ``(d, dmax)``, dmax a 0-d tensor on x's device. Give either
    ``g`` or ``gather = (u, v, w)`` (int32 u, v of x's length; w a vector)."""
    if (g is None) == (gather is None):
        raise ValueError("step_direction: give exactly one of g and gather")
    if x.device.type == "cpu":
        return step_direction_ref(h, x, scale, g, gather)
    u = v = w = None
    if gather is not None:
        u, v, w = gather
        dtype = loader.check_vectors("step_direction", h, x, w)
        E = loader.check_indices("step_direction", x, u, v)
    else:
        dtype = loader.check_vectors("step_direction", h, x, g)
        E = g.shape[0]
    if h.shape[0] != x.shape[0] or E != x.shape[0]:
        raise ValueError(f"step_direction: h, x and g of {h.shape[0]}, {x.shape[0]} and {E} values")
    if E == 0:
        raise ValueError("step_direction: empty vector")
    nb = loader.partial_blocks(E)
    d = torch.empty(E, dtype=dtype, device=x.device)
    part = torch.empty(nb, dtype=dtype, device=x.device)
    dmax = torch.empty((), dtype=dtype, device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        stream = loader.stream_handle(x)
        rc = loader.kernel_fn("rt_step_direction", dtype)(
            ptr(u), ptr(v), ptr(w), ptr(g), h.data_ptr(), x.data_ptr(), float(scale), torch.finfo(dtype).tiny, E, nb,
            d.data_ptr(), part.data_ptr(), _ticket(x.device, stream).data_ptr(), dmax.data_ptr(), stream,
        )
    loader.check_status(rc, "step_direction")
    loader.LAUNCHES["step_direction"] += 1
    return d, dmax

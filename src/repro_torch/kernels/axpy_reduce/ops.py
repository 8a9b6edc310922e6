"""Fused update ``out = y + alpha*dy`` with ``min(out)`` and ``max(out)``.

Port of ``repro.kernels.axpy_reduce``: the MWU loop's x, y and z updates,
whose min and max serve the loop condition without another pass. A CUDA
``y`` launches the hand-written kernel of ``csrc/axpy_reduce.cu``; a CPU
``y`` takes the plain version in ``ref.py``.
"""
import torch

from .. import loader
from .ref import axpy_reduce_ref


def axpy_reduce(y: torch.Tensor, dy: torch.Tensor, alpha: float):
    """Returns ``(out, min, max)``; min and max are 0-d tensors on y's device.
    ``alpha`` is a host float."""
    if y.device.type == "cpu":
        return axpy_reduce_ref(y, dy, alpha)
    dtype = loader.check_vectors("axpy_reduce", y, dy)
    n = y.shape[0]
    if n == 0:
        raise ValueError("axpy_reduce: empty vector")
    if dy.shape[0] != n:
        raise ValueError(f"axpy_reduce: y has {n} entries, dy {dy.shape[0]}")
    nb = loader.partial_blocks(n)
    out = torch.empty(n, dtype=dtype, device=y.device)
    part = torch.empty(2 * nb, dtype=dtype, device=y.device)
    red = torch.empty(2, dtype=dtype, device=y.device)
    with torch.cuda.device(y.device):
        rc = loader.kernel_fn("rt_axpy_reduce", dtype)(
            y.data_ptr(), dy.data_ptr(), float(alpha), n, nb, out.data_ptr(), part.data_ptr(), red.data_ptr(),
            loader.stream_handle(y),
        )
    loader.check_status(rc, "axpy_reduce")
    loader.LAUNCHES["axpy_reduce"] += 1
    return out, red[0], red[1]

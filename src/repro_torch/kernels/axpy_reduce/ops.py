"""Fused update ``out = y + alpha*dy`` with ``min(out)`` and ``max(out)``.

Port of ``repro.kernels.axpy_reduce``: the MWU loop's x, y and z updates,
whose min and max serve the loop condition without another pass. A CUDA
``y`` launches the hand-written kernel of ``csrc/axpy_reduce.cu``; a CPU
``y`` takes the plain version in ``ref.py``.

``alpha`` is a host float, or a float64 tensor of one value on y's
device (the device form: the kernel reads the step from memory, so the
host reads nothing before the update). Both forms round alpha to y's
dtype and give the same bits. An optional row mask ``keep`` (bool or
uint8, one byte a row) limits min and max to the rows it keeps; the update
covers every row.
"""
import torch

from .. import loader
from .ref import axpy_reduce_ref


@loader.counted("axpy_reduce", lambda r, y, *a, **k: {loader.dtype_rate(y.dtype): 4 * y.shape[0]})
def axpy_reduce(y: torch.Tensor, dy: torch.Tensor, alpha, *, out: torch.Tensor | None = None,
                red: torch.Tensor | None = None, keep: torch.Tensor | None = None):
    """Returns ``(out, min, max)``; min and max are float64 0-d tensors on
    y's device (exact: y's dtype widened). ``out`` (y's shape and dtype;
    it may be y itself, an update in place) receives the update and ``red``
    (a contiguous float64 2-vector, e.g. a slice of a lane record) receives
    ``[min, max]`` when given."""
    if y.device.type == "cpu":
        o, mn, mx = axpy_reduce_ref(y, dy, alpha, keep)
        if out is not None:
            o = out.copy_(o)
        if red is not None:
            red.copy_(torch.stack([mn, mx]))
            mn, mx = red[0], red[1]
        return o, mn, mx
    dtype = loader.check_vectors("axpy_reduce", y, dy, *([] if out is None else [out]))
    n = y.shape[0]
    if n == 0:
        raise ValueError("axpy_reduce: empty vector")
    if dy.shape[0] != n or (out is not None and out.shape[0] != n):
        raise ValueError(f"axpy_reduce: y has {n} entries, dy {dy.shape[0]}"
                         + ("" if out is None else f", out {out.shape[0]}"))
    keep_ptr = loader.check_keep("axpy_reduce", y, keep)
    alpha_dev = None
    if isinstance(alpha, torch.Tensor):
        loader.check_slot("axpy_reduce", y, alpha, 1, "alpha")
        alpha_dev = alpha
    if red is None:
        red = torch.empty(2, dtype=torch.float64, device=y.device)
    loader.check_slot("axpy_reduce", y, red, 2, "red")
    nb = loader.partial_blocks(n)
    if out is None:
        out = torch.empty(n, dtype=dtype, device=y.device)
    part = torch.empty(2 * nb, dtype=dtype, device=y.device)
    with torch.cuda.device(y.device):
        rc = loader.kernel_fn("rt_axpy_reduce", dtype)(
            y.data_ptr(), dy.data_ptr(), keep_ptr, 0.0 if alpha_dev is not None else float(alpha),
            None if alpha_dev is None else alpha_dev.data_ptr(), n, nb, out.data_ptr(), part.data_ptr(),
            red.data_ptr(), loader.stream_handle(y),
        )
    loader.check_status(rc, "axpy_reduce")
    loader.LAUNCHES["axpy_reduce"] += 1
    return out, red[0], red[1]

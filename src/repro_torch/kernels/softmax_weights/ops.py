"""Fused softmax weights: ``lse = logsumexp(sign*eta*v)`` and ``w = softmax(sign*eta*v)``.

Port of ``repro.kernels.softmax_weights``. A CUDA ``v`` launches the
hand-written kernel of ``csrc/softmax_weights.cu``; a CPU ``v`` takes the
plain version in ``ref.py``. ``smax_eta(v) = lse/eta`` (sign +1) and
``smin_eta(v) = -lse/eta`` (sign -1).
"""
import torch

from .. import loader
from .ref import softmax_weights_ref


def softmax_weights(v: torch.Tensor, eta: float, sign: float = 1.0):
    """Returns ``(lse, w)``: a 0-d tensor and a vector, both in v's dtype and
    on v's device. ``eta`` is a host float."""
    if v.device.type == "cpu":
        return softmax_weights_ref(v, eta, sign)
    dtype = loader.check_vectors("softmax_weights", v)
    n = v.shape[0]
    if n == 0:
        raise ValueError("softmax_weights: empty vector")
    stats = torch.empty(2, dtype=dtype, device=v.device)
    w = torch.empty(n, dtype=dtype, device=v.device)
    with torch.cuda.device(v.device):
        part = loader.scratch("softmax_weights", v, 2)
        rc = loader.kernel_fn("rt_softmax_weights", dtype)(
            v.data_ptr(), float(sign) * float(eta), n, part.data_ptr(), stats.data_ptr(), w.data_ptr(),
            loader.stream_handle(v),
        )
    loader.check_status(rc, "softmax_weights")
    loader.LAUNCHES["softmax_weights"] += 1
    return stats[1], w

"""Fused line-search probe over one constraint vector pair (y, dy).

Port of ``repro.kernels.linesearch_probe``. With ``v = y + alpha*dy`` and
``a = sign*eta*v`` it returns ``[logsumexp(a), <softmax(a), dy>, min(v)]``:
the smoothed-max piece of Psi/Phi, its Newton slope and the completion
test, from one read of each vector. A CUDA ``y`` launches the hand-written
kernel of ``csrc/linesearch_probe.cu``; a CPU ``y`` takes the plain
version in ``ref.py``.
"""
import torch

from .. import loader
from .ref import linesearch_probe_ref


def linesearch_probe(y: torch.Tensor, dy: torch.Tensor, alpha: float, eta: float, sign: float = 1.0,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """``[lse, slope, min_v]`` as a 3-vector in y's dtype on y's device.

    ``alpha`` and ``eta`` are host floats. ``out`` (a contiguous 3-vector)
    receives the result when given, so that a caller can read several
    probes back to the host in one copy.
    """
    if y.device.type == "cpu":
        r = linesearch_probe_ref(y, dy, alpha, eta, sign)
        return r if out is None else out.copy_(r)
    dtype = loader.check_vectors("linesearch_probe", y, dy)
    n = y.shape[0]
    if n == 0:
        raise ValueError("linesearch_probe: empty vector")
    if dy.shape[0] != n:
        raise ValueError(f"linesearch_probe: y has {n} entries, dy {dy.shape[0]}")
    if out is None:
        out = torch.empty(3, dtype=dtype, device=y.device)
    else:
        loader.check_vectors("linesearch_probe", y, out)
        if out.shape[0] != 3:
            raise ValueError("linesearch_probe: out must hold 3 values")
    nb = loader.partial_blocks(n)
    part = torch.empty(4 * nb, dtype=dtype, device=y.device)
    with torch.cuda.device(y.device):
        rc = loader.kernel_fn("rt_linesearch_probe", dtype)(
            y.data_ptr(), dy.data_ptr(), float(alpha), float(sign) * float(eta), n, nb, part.data_ptr(),
            out.data_ptr(), loader.stream_handle(y),
        )
    loader.check_status(rc, "linesearch_probe")
    loader.LAUNCHES["linesearch_probe"] += 1
    return out

"""Plain PyTorch version of the fused update (dtype-preserving)."""
import torch


def axpy_reduce_ref(y: torch.Tensor, dy: torch.Tensor, alpha):
    """(y + alpha*dy, min, max) with min and max as float64 0-d tensors;
    ``alpha`` a host float or a one-value tensor (read as a host float)."""
    out = y + float(alpha) * dy
    return out, out.min().double(), out.max().double()

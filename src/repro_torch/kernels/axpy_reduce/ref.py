"""Plain PyTorch version of the fused update (dtype-preserving)."""
import torch


def axpy_reduce_ref(y: torch.Tensor, dy: torch.Tensor, alpha: float):
    """(y + alpha*dy, min, max) with min and max as 0-d tensors."""
    out = y + alpha * dy
    return out, out.min(), out.max()

"""Plain PyTorch version of the fused update (dtype-preserving)."""
import torch


def axpy_reduce_ref(y: torch.Tensor, dy: torch.Tensor, alpha, keep: torch.Tensor | None = None):
    """(y + alpha*dy, min, max) with min and max as float64 0-d tensors;
    ``alpha`` a host float or a one-value tensor (read as a host float).
    With ``keep``, min and max run over the kept rows (+inf and -inf where
    none is kept); the update covers every row."""
    out = y + float(alpha) * dy
    if keep is None:
        return out, out.min().double(), out.max().double()
    return out, torch.where(keep, out, torch.inf).min().double(), torch.where(keep, out, -torch.inf).max().double()

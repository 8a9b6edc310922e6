"""Plain PyTorch version of the line-search probe (dtype-preserving)."""
import torch


def linesearch_probe_ref(y: torch.Tensor, dy: torch.Tensor, alpha: float, eta: float, sign: float = 1.0):
    """[lse, slope, min_v] for v = y + alpha*dy and a = sign*eta*v, as one vector."""
    v = y + alpha * dy
    a = (sign * eta) * v
    m = a.max()
    e = torch.exp(a - m)
    s = e.sum()
    lse = m + torch.log(s)
    slope = (e * dy).sum() / s
    return torch.stack([lse, slope, v.min()])

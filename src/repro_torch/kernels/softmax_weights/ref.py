"""Plain PyTorch version of the softmax-weights kernel (dtype-preserving)."""
import torch


def softmax_weights_ref(v: torch.Tensor, eta: float, sign: float = 1.0):
    """(lse, w): lse = logsumexp(a), w = exp(a - lse), with a = sign*eta*v."""
    a = (sign * eta) * v
    m = a.max()
    s = torch.exp(a - m).sum()
    lse = m + torch.log(s)
    return lse, torch.exp(a - lse)

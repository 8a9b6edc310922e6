"""Plain PyTorch version of the softmax-weights kernel (dtype-preserving)."""
import torch


def softmax_weights_ref(v: torch.Tensor, eta: float, sign: float = 1.0, keep: torch.Tensor | None = None):
    """(lse, w): lse = logsumexp(a), w = exp(a - lse), with a = sign*eta*v.

    Rows where ``keep`` is False count as a = -inf: they are left out of lse
    and their weight is exactly 0. The masked form is the reference's masked
    expression (``repro.core.smoothing``'s ``where`` path: the weights are
    e / sum(e), rounded as there), so the CPU's masked solves keep its bits.
    """
    a = (sign * eta) * v
    if keep is None:
        m = a.max()
        s = torch.exp(a - m).sum()
        lse = m + torch.log(s)
        return lse, torch.exp(a - lse)
    a = torch.where(keep, a, -torch.inf)
    m = a.max()
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))  # every row masked out: lse = -inf, not NaN
    e = torch.exp(a - m)
    s = e.sum()
    return m + torch.log(s), torch.where(keep, e / s, 0.0)

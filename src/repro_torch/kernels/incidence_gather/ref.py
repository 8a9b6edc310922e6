"""Plain PyTorch version of the incidence gather (dtype-preserving)."""
import torch


def incidence_gather_ref(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """g[e] = w[u[e]] + w[v[e]]; ``index_select`` takes the int32 indices as they are."""
    return w.index_select(0, u) + w.index_select(0, v)

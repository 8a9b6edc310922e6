"""MPCSolver baseline: stateless gradient descent with adaptive error, in PyTorch.

Port of ``repro.core.gradient_descent``: the comparison algorithm of
Makari et al. [31] (after Awerbuch & Khandekar's stateless distributed
gradient descent [7]), as the paper's Appendix A.3 describes it, for the
Figure-3 convergence study. It minimizes

    Gamma(x) = sum_i exp(mu (P_i x - 1)) + sum_i exp(mu (1 - C_i x))

by multiplicative coordinate updates: coordinates whose covering pull
exceeds their packing pull (C^T z vs P^T y) are scaled up, the opposite
scaled down. The *adaptive error* strategy starts with a coarse internal
tolerance eps' >> eps (mu ~ log(m)/eps' small => big moves) and tightens
eps' whenever progress stagnates, warm-starting from the current x.

The constants are the reference's (mu = ln(3m/eps)/eps', multiplicative
step beta = eps'/8, stagnation window + halving). Each iteration runs the
operators' products (on the card the scatter and gather kernels) and
plain tensor code for the exponentials, clips and factors, in the
operators' float type; its violation is read back once (``float(viol)``),
as the reference reads it, for the stagnation logic.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .operators import LinOp

__all__ = ["MPCOptions", "mpc_solve"]


@dataclass(frozen=True)
class MPCOptions:
    eps: float = 0.05  # target relative error (Makari et al. use 0.05)
    eps_internal0: float = 1.0  # initial adaptive internal error
    max_iter: int = 20000
    stagnation_window: int = 50
    stagnation_rtol: float = 1e-3
    beta_factor: float = 0.125  # beta = beta_factor * eps'


def _mpc_iter(P: LinOp, C: LinOp, x, mu: float, beta: float, x_max: float, c_mask):
    """One multiplicative update of x; returns (x, max violation as a 0-d tensor)."""
    y = torch.exp(torch.clamp(mu * (P.matvec(x) - 1.0), -60.0, 60.0))
    zc = C.matvec(x)
    z = torch.exp(torch.clamp(mu * (1.0 - zc), -60.0, 60.0))
    if c_mask is not None:
        z = torch.where(c_mask, z, 0.0)
    gp = P.rmatvec(y)  # packing push (wants x smaller)
    gc = C.rmatvec(z)  # covering pull (wants x larger)
    up = gc > (1.0 + beta) * gp
    dn = gp > (1.0 + beta) * gc
    one = torch.ones_like(x)
    fac = torch.where(up, one * (1.0 + beta), torch.where(dn, one * (1.0 - beta), one))
    x2 = torch.clamp(x * fac, 1e-30, x_max)
    z2 = C.matvec(x2)
    min_c = torch.where(c_mask, z2, torch.inf).min() if c_mask is not None else z2.min()
    viol = torch.clamp(torch.maximum(P.matvec(x2).max() - 1.0, 1.0 - min_c), min=0.0)
    return x2, viol


def mpc_solve(P: LinOp, C: LinOp, opts: MPCOptions = MPCOptions(), c_mask=None):
    """Run MPCSolver; returns (x as a numpy array, trace dict) with the
    per-iteration violation, as the reference does."""
    m = P.shape[0] + C.shape[0]
    n = P.shape[1]
    # the operators' float type (the reference's canonical float under x64)
    cm = P.colmax()
    dt = torch.promote_types(cm.dtype, C.colmax().dtype)
    dt = dt if dt.is_floating_point else torch.float64  # repro: noqa[RPR003] an integer operator's float type: the reference's canonical float under x64

    # start tiny like MWU so packing starts satisfied
    cm = cm.to(dt)
    safe = torch.where(cm > 0, cm, 1.0)
    x = (opts.eps / (n * safe)).to(dt)
    x_max = float(n)  # generous cap

    eps_i = opts.eps_internal0
    viols = []
    it = 0
    best_recent = np.inf
    window_count = 0
    while it < opts.max_iter:
        mu = float(np.log(3 * m / opts.eps) / eps_i)
        beta = opts.beta_factor * eps_i
        x, viol = _mpc_iter(P, C, x, mu, beta, x_max, c_mask)
        v = float(viol)  # the one host read of an iteration
        viols.append(v)
        it += 1
        if v <= opts.eps:
            break
        # adaptive error: tighten eps' when stagnating (Appendix A.3)
        if v < best_recent * (1.0 - opts.stagnation_rtol):
            best_recent = v
            window_count = 0
        else:
            window_count += 1
            if window_count >= opts.stagnation_window:
                eps_i = max(eps_i / 2.0, opts.eps)
                best_recent = np.inf
                window_count = 0
    return x.cpu().numpy(), {"max_violation": np.asarray(viols), "iters": it}

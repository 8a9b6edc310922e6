"""Fused line-search probe, and the Newton step-size search over it.

Port of ``repro.kernels.linesearch_probe``. With ``v = y + alpha*dy`` and
``a = sign*eta*v`` a probe returns ``[logsumexp(a), <softmax(a), dy>,
min(v)]``: the smoothed-max piece of Psi/Phi, its Newton slope and the
completion test, from one read of each vector. :func:`linesearch_probe2`
evaluates both sides of a step-size probe (packing side y with sign +1,
covering side z with sign -1) in one launch; :func:`newton_search` runs
the whole Newton search of ``core.stepsize.newton_step`` over such probes
in one launch, and in its step form also decides the MWU iteration's
step there. CUDA tensors launch the hand-written kernel of
``csrc/linesearch_probe.cu`` (a lone probe is the search kernel's
one-probe case); CPU tensors take the plain versions in ``ref.py``.
"""
import torch

from .. import loader
from .ref import linesearch_probe2_ref, linesearch_probe_ref, newton_search_ref, newton_step_ref


def _launch(name, y, dy, z, dz, nz, se_y, se_z, alpha, out):
    dtype, dev = y.dtype, y.device
    with torch.cuda.device(dev):
        part = loader.scratch("linesearch_probe", y, 4)
        rc = loader.kernel_fn("rt_linesearch_probe2", dtype)(
            y.data_ptr(), dy.data_ptr(), y.shape[0], float(se_y), z.data_ptr(), dz.data_ptr(), nz, float(se_z),
            float(alpha), part.data_ptr(), out.data_ptr(), loader.stream_handle(y),
        )
    loader.check_status(rc, name)
    loader.LAUNCHES["linesearch_probe"] += 1
    return out


def _check(name, y, dy):
    n = y.shape[0]
    if n == 0:
        raise ValueError(f"{name}: empty vector")
    if dy.shape[0] != n:
        raise ValueError(f"{name}: a vector has {n} entries, its step {dy.shape[0]}")


def _out(name, out, like, size):
    if out is None:
        return torch.empty(size, dtype=like.dtype, device=like.device)
    loader.check_vectors(name, like, out)
    if out.shape[0] != size:
        raise ValueError(f"{name}: out must hold {size} values")
    return out


def linesearch_probe(y: torch.Tensor, dy: torch.Tensor, alpha: float, eta: float, sign: float = 1.0,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """``[lse, slope, min_v]`` as a 3-vector in y's dtype on y's device.

    ``alpha`` and ``eta`` are host floats. ``out`` (a contiguous 3-vector)
    receives the result when given.
    """
    if y.device.type == "cpu":
        r = linesearch_probe_ref(y, dy, alpha, eta, sign)
        return r if out is None else out.copy_(r)
    loader.check_vectors("linesearch_probe", y, dy)
    _check("linesearch_probe", y, dy)
    out = _out("linesearch_probe", out, y, 3)
    return _launch("linesearch_probe", y, dy, y, dy, 0, float(sign) * float(eta), 0.0, alpha, out)


def linesearch_probe2(y: torch.Tensor, dy: torch.Tensor, z: torch.Tensor, dz: torch.Tensor, alpha: float,
                      eta: float, out: torch.Tensor | None = None) -> torch.Tensor:
    """Both sides of a step-size probe in one launch: ``[lse_y, slope_y,
    min_y, lse_z, slope_z, min_z]``, the packing side (y, dy) at sign +1
    and the covering side (z, dz) at sign -1, as a 6-vector in y's dtype on
    y's device. ``out`` (a contiguous 6-vector) receives it when given, so
    that the caller reads a probe back in one copy."""
    if y.device.type == "cpu":
        r = linesearch_probe2_ref(y, dy, z, dz, alpha, eta)
        return r if out is None else out.copy_(r)
    loader.check_vectors("linesearch_probe2", y, dy, z, dz)
    _check("linesearch_probe2", y, dy)
    _check("linesearch_probe2", z, dz)
    out = _out("linesearch_probe2", out, y, 6)
    return _launch("linesearch_probe2", y, dy, z, dz, z.shape[0], float(eta), -float(eta), alpha, out)


def newton_search(y: torch.Tensor, dy: torch.Tensor, z: torch.Tensor, dz: torch.Tensor, eta: float, ls_eps: float,
                  alpha0=None, *, d_max: torch.Tensor | None = None, out: torch.Tensor | None = None) -> torch.Tensor:
    """The warm-started, safeguarded Newton step-size search of
    ``core.stepsize.newton_step`` for an unmasked problem, in one launch:
    ``[alpha, probes, completes]`` as a float64 3-vector on y's device,
    which the caller reads once. On the card it gives the same alpha (bit
    for bit), probes and completes as the host loop over
    :func:`linesearch_probe2`; on the CPU it is that loop over the plain
    probe (``ref.newton_search_ref``).

    The step form (``d_max`` given: the iteration's max(d), a one-value
    tensor of y's dtype) leaves the MWU iteration's step on the device.
    ``alpha0`` is then the lane's previous step, a float64 tensor of one
    value on y's device: the warm start, overwritten with alpha when the
    step is taken. It returns the record ``[alpha, probes, completes,
    step, bad]`` (``ref.newton_step_ref``), into ``out`` (a contiguous
    float64 5-vector) when given.
    """
    step = d_max is not None
    if y.device.type == "cpu":
        r = newton_step_ref(y, dy, z, dz, eta, ls_eps, d_max, alpha0) if step else \
            newton_search_ref(y, dy, z, dz, eta, ls_eps, alpha0)
        return r if out is None else out.copy_(r)
    dtype = loader.check_vectors("newton_search", y, dy, z, dz)
    _check("newton_search", y, dy)
    _check("newton_search", z, dz)
    dev = y.device
    size = 5 if step else 3
    if step:
        if d_max.dtype != dtype or d_max.device != dev or d_max.numel() != 1:
            raise ValueError(f"newton_search: d_max must be one {dtype} value on {dev}")
        loader.check_slot("newton_search", y, alpha0, 1, "alpha0 (the step form's alpha_prev)")
    if out is None:
        out = torch.empty(size, dtype=torch.float64, device=dev)
    loader.check_slot("newton_search", y, out, size, "out")
    with torch.cuda.device(dev):
        part = loader.scratch("newton_search", y, 8)
        rc = loader.kernel_fn("rt_newton_search", dtype)(
            y.data_ptr(), dy.data_ptr(), y.shape[0], z.data_ptr(), dz.data_ptr(), z.shape[0], float(eta),
            float(ls_eps), 0.0 if step or alpha0 is None else float(alpha0), not step and alpha0 is not None,
            torch.finfo(dtype).tiny, part.data_ptr(), out.data_ptr(), d_max.data_ptr() if step else None,
            alpha0.data_ptr() if step else None, loader.stream_handle(y),
        )
    loader.check_status(rc, "newton_search")
    loader.LAUNCHES["newton_search"] += 1
    return out

"""Fused line-search probe, and the step-size searches over it.

Port of ``repro.kernels.linesearch_probe``. With ``v = y + alpha*dy`` and
``a = sign*eta*v`` a probe returns ``[logsumexp(a), <softmax(a), dy>,
min(v)]``: the smoothed-max piece of Psi/Phi, its Newton slope and the
completion test, from one read of each vector. :func:`linesearch_probe2`
evaluates both sides of a step-size probe (packing side y with sign +1,
covering side z with sign -1) in one launch; :func:`newton_search` and
:func:`binary_search` run the whole search of ``core.stepsize.newton_step``
and ``core.stepsize.binary_search_step`` over such probes in one launch,
and in their step form also decide the MWU iteration's step there. CUDA
tensors launch the hand-written kernel of ``csrc/linesearch_probe.cu``
(a lone probe is the search kernel's one-probe case); CPU tensors take
the plain versions in ``ref.py``.

Each side may carry a row mask (``p_keep`` for (y, dy), ``c_keep`` for
(z, dz); bool or uint8, one byte a row): the rows it does not keep count
as a = -inf and are left out of min v, as the masked rows of
``core.stepsize.make_probe_fn``. A kept row's arithmetic is the unmasked
kernel's, so an all-true mask gives the unmasked bits.

:func:`search_plan` tells how the kernel sweeps two sides of given
lengths on the card: its blocks a side, and whether each block holds its
tiles' inputs in shared memory between sweeps or reads them from device
memory at every sweep.
"""
import ctypes

import torch

from .. import loader
from .ref import (binary_search_ref, binary_step_ref, linesearch_probe2_ref, linesearch_probe_ref,
                  newton_search_ref, newton_step_ref)


def _scratch(name, y):
    """The kernel's scratch on y's stream: its partials' tagged slots and the
    hand-off words, zeroed once when made (the generation starts at 0)."""
    return loader.scratch(name, y, loader.load().rt_search_scratch_states(), zeroed=True)


def _launch(name, y, dy, ky, z, dz, kz, nz, se_y, se_z, alpha, out):
    dtype, dev = y.dtype, y.device
    with torch.cuda.device(dev):
        part = _scratch("linesearch_probe", y)
        rc = loader.kernel_fn("rt_linesearch_probe2", dtype)(
            y.data_ptr(), dy.data_ptr(), ky, y.shape[0], float(se_y), z.data_ptr(), dz.data_ptr(), kz, nz,
            float(se_z), float(alpha), part.data_ptr(), out.data_ptr(), loader.stream_handle(y),
        )
    loader.check_status(rc, name)
    loader.LAUNCHES["linesearch_probe"] += 1
    return out


def search_plan(ny: int, nz: int, dtype: torch.dtype, device=None) -> dict:
    """The search kernel's plan (``csrc/search_plan.cuh``) for sides of ny
    and nz elements of ``dtype`` on a CUDA device: ``gy`` and ``gz`` blocks
    a side, ``tiles`` (most tiles a block sweeps) and ``path``, "shared
    memory" (the inputs held there from the first sweep on) or "streamed"
    (read from device memory at every sweep).
    A lone probe and both searches take the same plan."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"search_plan: dtype must be float32 or float64, got {dtype}")
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        rc = loader.load().rt_search_plan(int(ny), int(nz), torch.finfo(dtype).bits // 8, out)
    loader.check_status(rc, "search_plan")
    return dict(gy=out[0], gz=out[1], tiles=out[2], path="shared memory" if out[3] else "streamed")


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


def _sweeps_flops(extra: int):
    """FLOPs of a search: 9 a row of both sides for every sweep, the probes
    (the record's second entry) and ``extra`` more."""
    def flops(r, y, dy, z, dz, *a, **k):
        return {loader.dtype_rate(y.dtype): 9 * (y.shape[0] + z.shape[0]) * (int(r[1]) + extra)}
    return flops


@loader.counted("linesearch_probe", lambda r, y, *a, **k: {loader.dtype_rate(y.dtype): 9 * y.shape[0]})
def linesearch_probe(y: torch.Tensor, dy: torch.Tensor, alpha: float, eta: float, sign: float = 1.0,
                     out: torch.Tensor | None = None, keep: torch.Tensor | None = None) -> torch.Tensor:
    """``[lse, slope, min_v]`` as a 3-vector in y's dtype on y's device.

    ``alpha`` and ``eta`` are host floats. ``out`` (a contiguous 3-vector)
    receives the result when given.
    """
    if y.device.type == "cpu":
        r = linesearch_probe_ref(y, dy, alpha, eta, sign, keep)
        return r if out is None else out.copy_(r)
    loader.check_vectors("linesearch_probe", y, dy)
    _check("linesearch_probe", y, dy)
    ky = loader.check_keep("linesearch_probe", y, keep)
    out = _out("linesearch_probe", out, y, 3)
    return _launch("linesearch_probe", y, dy, ky, y, dy, None, 0, float(sign) * float(eta), 0.0, alpha, out)


@loader.counted("linesearch_probe", lambda r, y, dy, z, *a, **k: {loader.dtype_rate(y.dtype):
                                                                   9 * (y.shape[0] + z.shape[0])})
def linesearch_probe2(y: torch.Tensor, dy: torch.Tensor, z: torch.Tensor, dz: torch.Tensor, alpha: float,
                      eta: float, out: torch.Tensor | None = None, *, p_keep: torch.Tensor | None = None,
                      c_keep: torch.Tensor | None = None) -> torch.Tensor:
    """Both sides of a step-size probe in one launch: ``[lse_y, slope_y,
    min_y, lse_z, slope_z, min_z]``, the packing side (y, dy) at sign +1
    and the covering side (z, dz) at sign -1, as a 6-vector in y's dtype on
    y's device. ``out`` (a contiguous 6-vector) receives it when given, so
    that the caller reads a probe back in one copy."""
    if y.device.type == "cpu":
        r = linesearch_probe2_ref(y, dy, z, dz, alpha, eta, p_keep, c_keep)
        return r if out is None else out.copy_(r)
    loader.check_vectors("linesearch_probe2", y, dy, z, dz)
    _check("linesearch_probe2", y, dy)
    _check("linesearch_probe2", z, dz)
    ky, kz = loader.check_keep("linesearch_probe2", y, p_keep), loader.check_keep("linesearch_probe2", z, c_keep)
    out = _out("linesearch_probe2", out, y, 6)
    return _launch("linesearch_probe2", y, dy, ky, z, dz, kz, z.shape[0], float(eta), -float(eta), alpha, out)


def _search(name: str, y, dy, z, dz, eta, ls_eps, alpha0, d_max, out, p_keep, c_keep) -> torch.Tensor:
    """One launch of the search kernel of rule ``name`` ("newton_search" or
    "binary_search"), checked as both wrappers take their arguments."""
    step = d_max is not None
    dtype = loader.check_vectors(name, y, dy, z, dz)
    _check(name, y, dy)
    _check(name, z, dz)
    ky, kz = loader.check_keep(name, y, p_keep), loader.check_keep(name, z, c_keep)
    dev = y.device
    size = 5 if step else 3
    if step:
        if d_max.dtype != dtype or d_max.device != dev or d_max.numel() != 1:
            raise ValueError(f"{name}: d_max must be one {dtype} value on {dev}")
        loader.check_slot(name, y, alpha0, 1, "alpha0 (the step form's alpha_prev)")
    if out is None:
        out = torch.empty(size, dtype=torch.float64, device=dev)
    loader.check_slot(name, y, out, size, "out")
    with torch.cuda.device(dev):
        part = _scratch(name, y)
        rc = loader.kernel_fn("rt_" + name, dtype)(
            y.data_ptr(), dy.data_ptr(), ky, y.shape[0], z.data_ptr(), dz.data_ptr(), kz, z.shape[0], float(eta),
            float(ls_eps), 0.0 if step or alpha0 is None else float(alpha0), not step and alpha0 is not None,
            torch.finfo(dtype).tiny, part.data_ptr(), out.data_ptr(), d_max.data_ptr() if step else None,
            alpha0.data_ptr() if step else None, loader.stream_handle(y),
        )
    loader.check_status(rc, name)
    loader.LAUNCHES[name] += 1
    return out


@loader.counted("newton_search", _sweeps_flops(1))
def newton_search(y: torch.Tensor, dy: torch.Tensor, z: torch.Tensor, dz: torch.Tensor, eta: float, ls_eps: float,
                  alpha0=None, *, d_max: torch.Tensor | None = None, out: torch.Tensor | None = None,
                  p_keep: torch.Tensor | None = None, c_keep: torch.Tensor | None = None) -> torch.Tensor:
    """The warm-started, safeguarded Newton step-size search of
    ``core.stepsize.newton_step``, over the rows the masks keep, in one launch:
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
    if y.device.type == "cpu":
        r = newton_step_ref(y, dy, z, dz, eta, ls_eps, d_max, alpha0, p_keep, c_keep) if d_max is not None else \
            newton_search_ref(y, dy, z, dz, eta, ls_eps, alpha0, p_keep, c_keep)
        return r if out is None else out.copy_(r)
    return _search("newton_search", y, dy, z, dz, eta, ls_eps, alpha0, d_max, out, p_keep, c_keep)


@loader.counted("binary_search", _sweeps_flops(2))
def binary_search(y: torch.Tensor, dy: torch.Tensor, z: torch.Tensor, dz: torch.Tensor, eta: float, ls_eps: float,
                  alpha0=None, *, d_max: torch.Tensor | None = None, out: torch.Tensor | None = None,
                  p_keep: torch.Tensor | None = None, c_keep: torch.Tensor | None = None) -> torch.Tensor:
    """The binary step-size search of ``core.stepsize.binary_search_step``
    (Alg. 3: exponential bracket, bisection, completion test and
    refinement), over the rows the masks keep, in one launch. Arguments,
    forms and results are :func:`newton_search`'s: on the card the same
    alpha (bit for bit), probes and completes as the host loop over
    :func:`linesearch_probe2`; on the CPU that loop over the plain probe
    (``ref.binary_search_ref``, ``ref.binary_step_ref`` in the step form).
    """
    if y.device.type == "cpu":
        r = binary_step_ref(y, dy, z, dz, eta, ls_eps, d_max, alpha0, p_keep, c_keep) if d_max is not None else \
            binary_search_ref(y, dy, z, dz, eta, ls_eps, alpha0, p_keep, c_keep)
        return r if out is None else out.copy_(r)
    return _search("binary_search", y, dy, z, dz, eta, ls_eps, alpha0, d_max, out, p_keep, c_keep)

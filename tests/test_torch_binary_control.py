"""The binary search kernel's control logic, compiled for the host.

``csrc/binary_control.cuh`` is the controller that ``search_kernel`` runs
on the card between the probes of a binary step-size search (Alg. 3). It
uses no CUDA type, so it is compiled here with the host's C++ compiler
(``__device__`` and the correctly rounded double intrinsics defined as
plain, uncontracted operations, as tests/test_torch_newton_control.py
compiles the Newton controller) and driven with the port's plain two-sided
probe, masked or not. On the same state it must give the host loop's
result (``stepsize._binary_search_step_host``) bit for bit: alpha, probes
and completes, with one sweep per probe plus the alpha = 0 sweep and the
completion test's sweep. The states take every phase of the search:
doubling, halving, completion while doubling, completion in the bisection,
and the refinement. On the card, tests/test_torch_cuda.py holds the whole
kernel against the host loop the same way.
"""
import ctypes
import shutil
import struct
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import stepsize
from repro_torch.kernels.linesearch_probe.ref import linesearch_probe2_ref

HEADER = Path(stepsize.__file__).resolve().parent.parent / "kernels" / "csrc" / "binary_control.cuh"

SHIM = r"""
#define __device__
#define __forceinline__ inline
static inline double __dadd_rn(double a, double b) { volatile double r = a + b; return r; }
static inline double __dsub_rn(double a, double b) { volatile double r = a - b; return r; }
static inline double __dmul_rn(double a, double b) { volatile double r = a * b; return r; }
static inline double __ddiv_rn(double a, double b) { volatile double r = a / b; return r; }
#include "binary_control.cuh"
extern "C" void* ctl_new(double eta, double ls_eps, double tiny, double alpha0, int has_alpha0) {
  return new rt::BinaryControl(rt::SearchArgs{eta, ls_eps, tiny, alpha0, has_alpha0});
}
extern "C" int ctl_step(void* c, const double* r, double* next) {
  const double w[6] = {r[0], r[1], r[2], r[3], r[4], r[5]};
  return static_cast<rt::BinaryControl*>(c)->step(w, next);
}
// alpha, probes, completes; then the phases the search took: doublings,
// halvings, bisection steps, refinement steps, completion while doubling,
// completion in the bisection
extern "C" void ctl_result(void* c, double* out) {
  auto* k = static_cast<rt::BinaryControl*>(c);
  const double r[9] = {k->a, (double)k->probes(), (double)k->completes, (double)(k->n_up - 1), (double)k->n_dn,
                       (double)k->n_bin, (double)k->n_ref, (double)k->completed_up,
                       (double)(k->done && !k->completed_up)};
  for (int j = 0; j < 9; ++j) out[j] = r[j];
  delete k;
}
"""


@pytest.fixture(scope="module")
def control(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++ or c++) to build the controller")
    tmp = tmp_path_factory.mktemp("binary_control")
    (tmp / "control.cpp").write_text(SHIM)
    lib = tmp / "libcontrol.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC", "-I", str(HEADER.parent),
                    "-o", str(lib), str(tmp / "control.cpp")], check=True, capture_output=True)
    c = ctypes.CDLL(str(lib))
    c.ctl_new.restype = ctypes.c_void_p
    c.ctl_new.argtypes = [ctypes.c_double] * 4 + [ctypes.c_int]
    c.ctl_step.restype = ctypes.c_int
    c.ctl_step.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double)]
    c.ctl_result.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)]
    return c


def _search(control, y, z, dy, dz, eta, ls_eps, alpha0, pm, cm):
    """The kernel's loop: probe where the controller asks until it stops."""
    c = control.ctl_new(eta, ls_eps, torch.finfo(y.dtype).tiny, 0.0 if alpha0 is None else alpha0, alpha0 is not None)
    alpha, sweeps = ctypes.c_double(0.0), 0
    while True:
        r = (ctypes.c_double * 6)(*linesearch_probe2_ref(y, dy, z, dz, alpha.value, eta, pm, cm).tolist())
        sweeps += 1
        if not control.ctl_step(c, r, ctypes.byref(alpha)):
            break
    out = (ctypes.c_double * 9)()
    control.ctl_result(c, out)
    return out[0], int(out[1]), bool(out[2]), sweeps, tuple(int(v) for v in out[3:])


def _state(seed, kind, n, m, dtype):
    """tests/test_torch_newton_control.py's mid-solve states at n packing and
    m covering rows; "below" is "far" with a packing step 300x as large, so
    that f(1) < 1 and the search halves below alpha = 1."""
    rng = np.random.default_rng(seed)
    y, dy = rng.random(n) * 0.3, rng.random(n) * 1e-3
    dz = rng.random(m) * 4e-3 + 1e-4
    z = rng.random(m) * 0.3
    if kind == "near":
        z = 1.0 - dz * rng.uniform(0.5, 3.0, m)
    elif kind == "done":
        z = 1.0 - dz * rng.uniform(0.2, 0.9, m)
    elif kind == "below":
        dy = dy * 300.0
    return [torch.from_numpy(t).to(dtype) for t in (y, z, dy, dz)]


def _masks(seed, n, m):
    rng = np.random.default_rng(seed + 1000)
    pm, cm = rng.random(n) > 0.3, rng.random(m) > 0.3
    pm[0] = cm[0] = True
    return torch.from_numpy(pm), torch.from_numpy(cm)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("kind", ["far", "near", "done", "below"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_control_matches_host_loop(control, dtype, kind, masked):
    phases = np.zeros(6, np.int64)
    for seed in range(6):
        for n, m in ((12, 9), (300, 1), (1, 1), (50, 50)):
            for alpha0 in (None, 1.0, 37.0, 1e-9, 5e6):
                for eta in (50.0, 500.0):
                    y, z, dy, dz = _state(seed, kind, n, m, dtype)
                    pm, cm = _masks(seed, n, m) if masked else (None, None)
                    host = stepsize._binary_search_step_host(y, z, dy, dz, eta, pm, cm, ls_eps=0.1, alpha0=alpha0)
                    alpha, probes, completes, sweeps, took = _search(control, y, z, dy, dz, eta, 0.1, alpha0, pm, cm)
                    case = (seed, n, m, alpha0, eta, tuple(host), (alpha, probes, completes))
                    assert struct.pack("d", alpha) == struct.pack("d", host.alpha), case
                    assert (probes, completes) == (host.probes, host.completes), case
                    assert sweeps == probes + 2, case  # the alpha = 0 sweep and the completion test's
                    phases += np.asarray(took) > 0
    # the phases taken somewhere in the case: doubling, halving, bisection,
    # refinement, completion while doubling, completion in the bisection
    want = {"far": (1, 1, 1, 1, 1, 0), "near": (1, 1, 1, 1, 1, 1), "done": (0, 1, 1, 1, 1, 1),
            "below": (0, 1, 1, 0, 0, 0)}[kind]
    assert tuple(int(p > 0) for p in phases) == want, phases

// The control logic of the binary step-size search (paper Alg. 3) that
// search_kernel (linesearch_probe.cu) runs on the card: the host loop of
// kernels/linesearch_probe/ref.py (binary_search_loop over
// two_sided_probe_fn, with its alpha = 0 sweep), operation for operation
// in double with explicit roundings (nothing contracted into an FMA), as
// the host runs it in Python floats. The phases, in the host's order: the
// first probe at max(alpha0, 1); doubling while f >= 1 and min z < 1;
// halving while f < 1; the bracket; the bisection; the completion test
// min(z + alpha dz) >= 1 at the chosen alpha, read from one more sweep at
// alpha that is not counted as a probe (its min z is the host's masked min
// of z + alpha dz, rounded alike); then the completion refinement shared
// with the Newton controller. Like NewtonControl it touches no memory and
// no CUDA type, so tests/test_torch_binary_control.py compiles it for the
// host and holds it against the host loop on the CPU.
#pragma once

#include "newton_control.cuh"

namespace rt {

struct BinaryControl : SearchBase {
  enum Stage { kZero, kFirst, kUp, kDown, kBin, kComplete, kRefine };

  Stage stage = kZero;
  Probe p0 = {}, p_up = {}, p_dn = {};
  double a0 = 0, a_up = 0, a_dn = 0, lb = 0, ub = 0, beta = 0;
  int n_up = 0, n_dn = 0, n_exp = 0, n_bin = 0;
  bool completed_up = false, done = false;

  __device__ explicit BinaryControl(const SearchArgs& args) : SearchBase(args) {}

  __device__ int probes() const { return n_exp + n_bin + n_ref; }

  // upward exponential phase: double while f >= 1, stop on covering completion
  __device__ bool up_loop(double* next) {
    if (p_up.f >= 1 && p_up.min_z < 1 && n_up < kMaxExpIters) {
      a_up = __dmul_rn(a_up, 2.0);
      *next = a_up;
      stage = kUp;
      return true;
    }
    completed_up = p_up.f >= 1 && p_up.min_z >= 1;
    a_dn = a0;
    p_dn = p0;
    n_dn = 0;
    return down_loop(next);
  }

  // downward exponential phase (the warm start overshot): halve while f < 1
  __device__ bool down_loop(double* next) {
    if (p_dn.f < 1 && a_dn > 1e-12 && n_dn < kMaxExpIters) {
      a_dn = __ddiv_rn(a_dn, 2.0);
      *next = a_dn;
      stage = kDown;
      return true;
    }
    // the bracket [lb, ub] with f(lb) >= 1 > f(ub)
    const bool need_down = p0.f < 1;
    lb = need_down ? a_dn : __ddiv_rn(a_up, 2.0);
    ub = need_down ? __dmul_rn(a_dn, 2.0) : a_up;
    n_exp = need_down ? 1 + n_dn : n_up;
    n_bin = 0;
    done = completed_up;
    return bin_loop(next);
  }

  __device__ bool bin_loop(double* next) {
    if (!done && __dsub_rn(ub, lb) > __dmul_rn(c.ls_eps, lb) && n_bin < kMaxBinIters) {
      beta = __dmul_rn(0.5, __dadd_rn(lb, ub));
      *next = beta;
      stage = kBin;
      return true;
    }
    a = completed_up ? a_up : lb;
    *next = a;  // the completion test's sweep
    stage = kComplete;
    return true;
  }

  __device__ bool step(const double (&r)[6], double* next) {
    switch (stage) {
      case kZero:
        zero(r);
        a0 = c.has_alpha0 ? fmax_nan(c.alpha0, 1.0) : 1.0;
        *next = a0;
        stage = kFirst;
        return true;
      case kFirst:
        p0 = eval(r);
        a_up = a0;
        p_up = p0;
        n_up = 1;
        return up_loop(next);
      case kUp:
        p_up = eval(r);
        n_up += 1;
        return up_loop(next);
      case kDown:
        p_dn = eval(r);
        n_dn += 1;
        return down_loop(next);
      case kBin: {
        const Probe p = eval(r);
        const bool ok = p.f >= 1;
        done = ok && p.min_z >= 1;
        if (ok)
          lb = beta;
        else
          ub = beta;
        n_bin += 1;
        return bin_loop(next);
      }
      case kComplete:
        completes = r[5] >= 1;
        n_ref = 0;
        if (!completes) return false;
        stage = kRefine;
        return refine_start(a, next);
      case kRefine:
        return refine_take(r[5], next);
    }
    return false;
  }
};

}  // namespace rt

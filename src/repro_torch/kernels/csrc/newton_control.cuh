// The control logic of the Newton step-size search that newton_search_kernel
// (linesearch_probe.cu) runs on the card: the host loop of
// kernels/linesearch_probe/ref.py (newton_search_loop over
// two_sided_probe_fn, with its alpha = 0 sweep, and refine_completion),
// operation for operation in double with explicit roundings (nothing
// contracted into an FMA), as the host runs it in Python floats. It touches no memory and
// no CUDA type, so tests/test_torch_newton_control.py also compiles it for
// the host and holds it against the host loop on the CPU.
#pragma once

#include <math.h>

namespace rt {

constexpr int kMaxNewtonIters = 30;  // ref.py's caps, the reference's
constexpr int kMaxBackoffIters = 64;
constexpr int kMaxBinIters = 64;

// NaN-propagating max and min, as ref.py's fmax and fmin.
__device__ __forceinline__ double fmax_nan(double a, double b) {
  return (a != a || b != b) ? (double)NAN : (a >= b ? a : b);
}
__device__ __forceinline__ double fmin_nan(double a, double b) {
  return (a != a || b != b) ? (double)NAN : (a <= b ? a : b);
}

struct SearchArgs {
  double eta, ls_eps, tiny, alpha0;  // tiny: finfo(T).tiny
  int has_alpha0;
};

// step() takes the six values of the probe it asked for (widened from T)
// and returns whether it wants another, at *next; the loops are those of
// the host, entered and resumed in order.
struct NewtonControl {
  enum Stage { kZero, kFirst, kNewton, kBackoff, kRefine };
  struct Probe {
    double f, phi, psi, dphi, dpsi, min_z;
  };

  SearchArgs c;
  Stage stage = kZero;
  double lse_y0 = 0, lse_z0 = 0, a = 0, a2 = 0, lo = 0, h = 0, mid = 0;
  Probe p = {};
  int n = 0, n_bo = 0, n_ref = 0;
  bool done = false, completes = false;

  __device__ explicit NewtonControl(const SearchArgs& args) : c(args) {}

  // two_sided_probe_fn's probe
  __device__ Probe eval(const double (&r)[6]) const {
    Probe q;
    q.psi = __ddiv_rn(__dsub_rn(r[0], lse_y0), c.eta);
    q.phi = __ddiv_rn(-__dsub_rn(r[3], lse_z0), c.eta);
    q.f = q.psi <= c.tiny ? (double)INFINITY : __ddiv_rn(q.phi, fmax_nan(q.psi, c.tiny));  // ratio
    q.dpsi = r[1];
    q.dphi = r[4];
    q.min_z = r[5];
    return q;
  }

  __device__ bool newton_loop(double* next) {
    if (!done && n < kMaxNewtonIters) {
      const double psi2 = fmax_nan(__dmul_rn(p.psi, p.psi), c.tiny);
      const double fp = fmin_nan(__ddiv_rn(__dsub_rn(__dmul_rn(p.dphi, p.psi), __dmul_rn(p.phi, p.dpsi)), psi2),
                                 -c.tiny);
      const double raw = __dsub_rn(a, __ddiv_rn(__dsub_rn(p.f, 1.0), fp));
      a2 = fmax_nan(fmin_nan(fmax_nan(raw, __dmul_rn(a, 0.125)), __dmul_rn(a, 8.0)), 1e-12);
      *next = a2;
      stage = kNewton;
      return true;
    }
    n_bo = 0;
    return backoff_loop(next);
  }

  __device__ bool backoff_loop(double* next) {
    if (p.f < 1 && n_bo < kMaxBackoffIters) {
      a = __dmul_rn(a, __dsub_rn(1.0, c.ls_eps));
      *next = a;
      stage = kBackoff;
      return true;
    }
    completes = p.min_z >= 1 && p.f >= 1;
    n_ref = 0;
    if (!completes) return false;
    lo = 0.0;
    h = a;
    return refine_loop(next);
  }

  __device__ bool refine_loop(double* next) {
    if (__dsub_rn(h, lo) > __dmul_rn(c.ls_eps, h) && n_ref < kMaxBinIters) {
      mid = __dmul_rn(0.5, __dadd_rn(lo, h));
      *next = mid;
      stage = kRefine;
      return true;
    }
    a = fmax_nan(h, 1.0);
    return false;
  }

  __device__ bool step(const double (&r)[6], double* next) {
    switch (stage) {
      case kZero:
        lse_y0 = r[0];
        lse_z0 = r[3];
        a = c.has_alpha0 ? fmax_nan(c.alpha0, 1e-6) : 1.0;
        *next = a;
        stage = kFirst;
        return true;
      case kFirst:
        p = eval(r);
        n = 1;
        done = false;
        return newton_loop(next);
      case kNewton: {
        const Probe p2 = eval(r);
        done = fabs(__dsub_rn(a2, a)) <= __dmul_rn(c.ls_eps, a) || (p2.f >= 1 && p2.min_z >= 1);
        a = a2;
        p = p2;
        n += 1;
        return newton_loop(next);
      }
      case kBackoff:
        p = eval(r);
        n_bo += 1;
        return backoff_loop(next);
      case kRefine:
        if (r[5] >= 1)
          h = mid;
        else
          lo = mid;
        n_ref += 1;
        return refine_loop(next);
    }
    return false;
  }
};

}  // namespace rt

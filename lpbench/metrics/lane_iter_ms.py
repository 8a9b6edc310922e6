"""Kernels: kernel-busy milliseconds (the profiler's union of the kernels
in the window, without copies or memsets, so the certificate's copy of x
to the host is not counted) a lane iteration of the window's solves."""


def read(rec):
    if rec.mode != "solver" or rec.trace is None or rec.trace.kernel_busy_s <= 0:
        return None
    iters = sum(sol.mwu_iters_total for _, sol in rec.window.answers)
    return 1e3 * rec.trace.kernel_busy_s / iters if iters else None

"""MWU loop and lanes: lane iterations a solve, the mean over the window's
solves (``Solution.mwu_iters_total``, the program's counter)."""
import statistics


def read(rec):
    if rec.mode != "solver" or not rec.window.answers:
        return None
    return statistics.fmean(sol.mwu_iters_total for _, sol in rec.window.answers)

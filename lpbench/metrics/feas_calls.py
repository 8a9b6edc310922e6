"""Bound search: feasibility calls a solve, the mean over the window's
solves (``Solution.feasibility_calls``, the program's counter)."""
import statistics


def read(rec):
    if rec.mode != "solver" or not rec.window.answers:
        return None
    return statistics.fmean(sol.feasibility_calls for _, sol in rec.window.answers)

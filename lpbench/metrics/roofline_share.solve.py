"""Kernels: the window's needed HBM bytes (``roofline/<family>.py``, from
the problem's shapes and the lane and loop iterations) at the card's peak
bandwidth, as a share of the window's wall time, in the solver cells."""
from lpbench.metrics import _shares


def read(rec):
    return _shares.roofline_share(rec) if rec.mode == "solver" else None

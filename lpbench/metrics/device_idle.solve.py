"""Device: the share of the traced window in which no operation ran on
the card (the profiler's trace), in the solver cells."""
from lpbench.metrics import _shares


def read(rec):
    return _shares.idle_share(rec) if rec.mode == "solver" else None

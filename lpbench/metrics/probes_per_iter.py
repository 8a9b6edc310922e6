"""Step size: line-search probes a lane iteration over the window's solves
(``Solution.ls_probes_total`` over ``Solution.mwu_iters_total``)."""


def read(rec):
    if rec.mode != "solver":
        return None
    iters = sum(sol.mwu_iters_total for _, sol in rec.window.answers)
    return sum(sol.ls_probes_total for _, sol in rec.window.answers) / iters if iters else None

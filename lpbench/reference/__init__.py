"""The plain reference that decides ``correct``: one file per LP family,
``<family>.py``, with ``exact_optimum(n, u, v, split)`` and ``judge(n, u, v,
x, objective, bound, opt, eps)``; each imports nothing of the program."""

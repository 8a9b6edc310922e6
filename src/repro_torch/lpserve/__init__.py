"""repro_torch.lpserve — shape-bucketed continuous-batching serving for graph LPs.

Port of ``repro.lpserve``, on top of :mod:`repro_torch.api`: heterogeneous
:class:`~repro_torch.api.Problem` requests are padded into shape buckets
(:mod:`.bucketing`), batched onto fixed lane slots, and driven through one
batched feasibility loop a round with continuous lane refill
(:mod:`.engine`); per-bucket serving counters come from :mod:`.stats`.
Padded rows reach the kernels as row masks, so every lane of a round keeps
its Newton search on the card. Typical use::

    from repro_torch.lpserve import LPEngine, LPServeConfig
    from repro_torch.graphs import build, erdos

    engine = LPEngine(LPServeConfig(lanes=8))
    rids = [engine.submit(build("match", erdos(50 * (i + 1), 140 * (i + 1), seed=i)))
            for i in range(16)]
    solutions = engine.run()          # {rid: Solution}
    print(engine.stats()["batches"])  # far fewer than feasibility calls

``python -m repro_torch.lpserve`` runs the serving demo (``--device cpu``
off the card).
"""
from .bucketing import BucketPolicy, BucketSpec, pad_problem, pad_problems, padding_waste, problem_dims
from .engine import BoundSearch, LPEngine, LPServeConfig
from .stats import BucketStats, aggregate

__all__ = [
    "BucketPolicy",
    "BucketSpec",
    "pad_problem",
    "pad_problems",
    "padding_waste",
    "problem_dims",
    "BoundSearch",
    "LPEngine",
    "LPServeConfig",
    "BucketStats",
    "aggregate",
]

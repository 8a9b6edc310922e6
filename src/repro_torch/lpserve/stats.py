"""Serving counters: what the batching engine actually bought you (port of
``repro.lpserve.stats``, the same counters and keys).

One :class:`BucketStats` per (problem family, bucket) pair, aggregated
by :func:`aggregate` into the flat dict ``LPEngine.stats()`` returns.
The numbers that matter operationally:

* ``batches`` vs ``requests`` — continuous batching is working iff
  batches ≪ requests x calls-per-request;
* ``lane_occupancy`` — fraction of launched lanes carrying a real
  request (the rest re-ran a duplicate to keep the launch shape static);
* ``padding_waste`` — fraction of bucket edge slots spent on padding
  (bucket ladder tuning signal);
* ``compile_cache_hits`` — dispatches of a launch shape seen before;
  the port compiles no per-shape program (its kernels are built once), so
  ``compiles`` counts the first dispatch of each (family, bucket, lanes)
  shape, as the reference counts it where it cannot read its jit cache;
* ``latency_p50_s`` / ``latency_p99_s`` — submit-to-solution wall time.

An engine with a mesh (``LPServeConfig(mesh=MeshPlan(...))``) adds its
``"mesh"`` section to these in ``LPEngine.stats()``: the reference's seven
keys, from the plan and the distributed solver's ``dist_stats``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["BucketStats", "aggregate"]


@dataclass
class BucketStats:
    """Counters for one (family, bucket) dispatch group."""

    family: str
    bucket: str
    requests: int = 0  # admitted
    completed: int = 0  # solutions delivered
    not_found: int = 0  # completed without a feasible certificate
    batches: int = 0  # batched dispatch rounds
    lane_rounds: int = 0  # lanes launched (batches x lane width)
    occupied_lane_rounds: int = 0  # lanes carrying a distinct live request
    feasibility_calls: int = 0  # real feasibility probes consumed
    mwu_iters: int = 0  # total MWU iterations across real lanes
    batch_seconds: float = 0.0  # wall time inside solve_batch
    compiles: int = 0  # dispatches of a launch shape not seen before
    compile_cache_hits: int = 0  # dispatches of one seen before
    edge_slots_used: int = 0  # bucket edge capacity over occupied lanes
    real_edges_used: int = 0  # real edges over occupied lanes
    latencies_s: list[float] = field(default_factory=list)

    @property
    def lane_occupancy(self) -> float:
        return self.occupied_lane_rounds / self.lane_rounds if self.lane_rounds else 0.0

    @property
    def padding_waste(self) -> float:
        if not self.edge_slots_used:
            return 0.0
        return 1.0 - self.real_edges_used / self.edge_slots_used

    def latency_quantile(self, q: float) -> float:
        if not self.latencies_s:
            return float("nan")
        return float(np.percentile(np.asarray(self.latencies_s), q))

    def as_dict(self) -> dict:
        return {
            "family": self.family,
            "bucket": self.bucket,
            "requests": self.requests,
            "completed": self.completed,
            "not_found": self.not_found,
            "batches": self.batches,
            "lane_rounds": self.lane_rounds,
            "lane_occupancy": round(self.lane_occupancy, 4),
            "padding_waste": round(self.padding_waste, 4),
            "feasibility_calls": self.feasibility_calls,
            "mwu_iters": self.mwu_iters,
            "batch_seconds": round(self.batch_seconds, 4),
            "compiles": self.compiles,
            "compile_cache_hits": self.compile_cache_hits,
            "latency_p50_s": round(self.latency_quantile(50), 4),
            "latency_p99_s": round(self.latency_quantile(99), 4),
        }


def aggregate(buckets) -> dict:
    """Flatten per-bucket counters into the engine-level stats dict."""
    buckets = list(buckets)
    lat = [t for b in buckets for t in b.latencies_s]
    lane_rounds = sum(b.lane_rounds for b in buckets)
    occupied = sum(b.occupied_lane_rounds for b in buckets)
    slots = sum(b.edge_slots_used for b in buckets)
    real = sum(b.real_edges_used for b in buckets)
    return {
        "requests": sum(b.requests for b in buckets),
        "completed": sum(b.completed for b in buckets),
        "not_found": sum(b.not_found for b in buckets),
        "batches": sum(b.batches for b in buckets),
        "feasibility_calls": sum(b.feasibility_calls for b in buckets),
        "mwu_iters": sum(b.mwu_iters for b in buckets),
        "batch_seconds": round(sum(b.batch_seconds for b in buckets), 4),
        "lane_occupancy": round(occupied / lane_rounds, 4) if lane_rounds else 0.0,
        "padding_waste": round(1.0 - real / slots, 4) if slots else 0.0,
        "compiles": sum(b.compiles for b in buckets),
        "compile_cache_hits": sum(b.compile_cache_hits for b in buckets),
        "latency_p50_s": float(np.percentile(lat, 50)) if lat else float("nan"),
        "latency_p99_s": float(np.percentile(lat, 99)) if lat else float("nan"),
        "buckets": {f"{b.family}/{b.bucket}": b.as_dict() for b in buckets},
    }

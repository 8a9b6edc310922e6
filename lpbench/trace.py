"""Reduce a ``torch.profiler`` run over the measured window to a summary.

The profiler keeps its events in memory; nothing is written to disk. The
raw events are read (``prof.profiler.kineto_results.events()``), without
the profiler's Python tree of them, which would take minutes. The window
is the benchmark's own ``window`` span. From the device's events
inside it come ``busy_s`` (the union of their intervals),
``kernel_busy_s`` (the same over kernels alone: no copy, no memset), the device
operations that took the most time, and the idle gaps between them, each
named by what the host was doing there: the benchmark's innermost span
(``solve``, ``engine.step``, ``submit``, ``result``) and the innermost
host operation the profiler saw, if any.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

SPANS = ("solve", "engine.step", "submit", "result")
NOT_KERNELS = ("Memcpy", "Memset")


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_busy_s: float
    device_ops: list = field(default_factory=list)  # [[name, seconds], ...], most first
    idle_gaps: list = field(default_factory=list)  # [[what the host did, seconds], ...], most first


def _device(evt) -> str:
    return str(evt.device_type()).rsplit(".", 1)[-1]


def _is_device_op(evt) -> bool:
    """A device operation: not a span's device-side annotation."""
    return (_device(evt) == "CUDA" and not evt.is_user_annotation() and evt.name() not in SPANS
            and evt.name() != "window")


def _innermost(starts: list, spans: list, t: float, look: int = 64):
    """The name of the latest-starting of the ``look`` spans of ``spans``
    (sorted by start) that start last before ``t`` and cover it, or None."""
    k = bisect.bisect_right(starts, t) - 1
    for k in range(k, max(k - look, -1), -1):
        if spans[k][1] >= t:
            return spans[k][2]
    return None


def _union_s(intervals: list) -> float:
    """Seconds covered by ``intervals`` (nanosecond pairs, sorted)."""
    total, cur_s, cur_e = 0, None, None
    for s, t in intervals:
        if cur_s is None or s > cur_e:
            total += 0 if cur_s is None else cur_e - cur_s
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    return 1e-9 * (total + (0 if cur_s is None else cur_e - cur_s))


def summarize(events, top: int = 10) -> TraceSummary:
    """``events``: the profiler's raw events of one window."""
    window = next(e for e in events if e.name() == "window" and _device(e) == "CPU")
    w0, w1 = window.start_ns(), window.end_ns()
    dev, kern, host, ours = [], [], [], []
    by_name: dict = defaultdict(float)
    for e in events:
        s, t, name = e.start_ns(), e.end_ns(), e.name()
        if _is_device_op(e):
            if t > w0 and s < w1:
                s, t = max(s, w0), min(t, w1)
                dev.append((s, t))
                if not name.startswith(NOT_KERNELS):
                    kern.append((s, t))
                by_name[name] += (t - s) * 1e-9
        elif _device(e) != "CPU":
            continue
        elif name in SPANS:
            ours.append((s, t, name))
        elif name != "window":
            host.append((s, t, name))
    dev.sort()
    kern.sort()
    gaps, cur_e = [], w0
    for s, t in dev:
        if s > cur_e:
            gaps.append((cur_e, s))
        cur_e = max(cur_e, t)
    gaps.append((cur_e, w1))
    host.sort()
    ours.sort()
    hs, os_ = [h[0] for h in host], [o[0] for o in ours]
    idle: dict = defaultdict(float)
    for a, b in gaps:
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        label = f"{_innermost(os_, ours, mid) or 'harness'}/{_innermost(hs, host, mid) or 'python'}"
        idle[label] += (b - a) * 1e-9
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
    return TraceSummary(window_s=(w1 - w0) * 1e-9, busy_s=_union_s(dev), kernel_busy_s=_union_s(kern),
                        device_ops=rank(by_name), idle_gaps=rank(idle))

"""The roofline's bytes on a tiny graph, worked out by hand."""
import pytest

from lpbench import harness, load, spec


class _Sol:
    def __init__(self, iters):
        self.mwu_iters_total = iters


def _instance(n, m):
    import numpy as np

    return harness.Instance(n=n, u=np.zeros(m, np.int32), v=np.ones(m, np.int32), split=None, base=0)


# a path of 4 vertices, 3 edges: endpoints 2 x 4 B x 3 = 24 B a loop iteration;
# x read and written, 16 B a variable, a lane iteration: bmatch has 3
# (edges), vcover 4 (vertices)
@pytest.mark.parametrize("family,per_loop,per_lane", [("bmatch", 24.0, 48.0), ("vcover", 24.0, 64.0)])
def test_iteration_bytes_by_hand(family, per_loop, per_lane):
    roof = spec.roofline({"family": family})
    assert roof.iteration_bytes(4, 3) == (per_loop, per_lane)


def test_window_bytes_share_the_loop_not_the_lanes():
    roof = spec.roofline({"family": "bmatch"})
    w = load.Window(rounds=[(10, 25), (5, 5)])  # a round of lanes sharing 10 loop iterations, then a lone lane
    # 10 x 24 + 25 x 48 + 5 x 24 + 5 x 48
    assert harness._roof_bytes(roof, w, [_instance(4, 3)], "solver") == 1800.0


def test_engine_bytes_count_each_request_alone():
    roof = spec.roofline({"family": "vcover"})
    w = load.Window(answers=[(0, _Sol(7)), (1, _Sol(2))])
    # request 0 on (4, 3): 7 x (24 + 64); request 1 on (8, 5): 2 x (40 + 128)
    assert harness._roof_bytes(roof, w, [_instance(4, 3), _instance(8, 5)], "engine") == 7 * 88 + 2 * 168


def test_share_is_none_without_a_peak():
    from lpbench.metrics import _shares

    rec = harness.Record(mode="solver", window=load.Window(seconds=2.0), roof_bytes=6.7e12,
                         hbm_bytes_per_s=None)
    assert _shares.roofline_share(rec) is None
    rec.hbm_bytes_per_s = 3.35e12
    assert _shares.roofline_share(rec) == pytest.approx(100.0)

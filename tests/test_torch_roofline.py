"""The port's roofline and op counter vs ``repro.utils.roofline`` /
``repro.utils.hlo``, on the CPU.

* ``model_flops_estimate`` is the reference's arithmetic: equal exactly for
  every (arch x shape), ``-mwu`` variants included.
* The ring formulas of ``opcount.wire_bytes`` are the closed forms of
  ``tests/test_hlo_analyzer.py::test_collective_wire_formula``.
* Dot FLOPs of one forward of each arch's ``reduced()`` config cut to one
  repetition of its pattern unit (the reference's trip count fails under
  jax 0.9, ``test_scan_trip_count_multiplies``), attention and the SSD in
  one chunk (so that no scan over chunks hides a product from the
  reference's analyzer): the port's count on meta against
  ``analyze_hlo(...).dot_flops`` of the reference's forward compiled on one
  CPU device, within DOT_REL. Every arch but mamba2-1.3b agrees exactly;
  mamba2's SSD einsums with a broadcast dim are products for XLA and
  elementwise work for ``torch.einsum`` (or the other way), 2.9% of its dot
  FLOPs on this config. DOT_REL = 5% is above that and below any missing
  projection (a layer's smallest product is over 10% of these counts).
* The counter: the same counts on meta and on the CPU; views charged
  nothing; a kernel call charged as one op with its own formula, not the
  plain version's passes; the roofline terms from a count.
"""
import json
import math
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as ref_get
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.models import Model as RefModel
from repro.utils.hlo import analyze_hlo
from repro.utils.roofline import model_flops_estimate as ref_model_flops
from repro_torch import kernels as K
from repro_torch.configs import ARCH_IDS, get
from repro_torch.configs.shapes import SHAPES
from repro_torch.models import Model
from repro_torch.utils import roofline
from repro_torch.utils.opcount import OpCounter, OpReport, wire_bytes

ARCHS = ARCH_IDS + ["mixtral-8x22b-mwu", "dbrx-132b-mwu"]
DOT_REL = 0.05  # see the module docstring; the measured shares are printed


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_estimate_equals_reference(arch):
    for name in SHAPES:
        assert roofline.model_flops_estimate(get(arch), SHAPES[name]) == \
            ref_model_flops(ref_get(arch), REF_SHAPES[name]), name


def test_collective_wire_formula():
    # the reference's test: one all-reduce of f32[128, 128] over 4 ranks
    assert wire_bytes("all-reduce", 128 * 128 * 4, 4) == pytest.approx(98304.0)
    for g in (2, 4, 16, 256):
        size = 1 << 20
        assert wire_bytes("all-reduce", size, g) == 2 * (g - 1) / g * size
        assert wire_bytes("all-gather", size, g) == (g - 1) / g * size
        assert wire_bytes("reduce-scatter", size, g) == (g - 1) * size
        assert wire_bytes("all-to-all", size, g) == (g - 1) / g * size
        assert wire_bytes("permute", size, g) == size
    r = OpReport()
    r.reckon("all-reduce", 1000, 1)  # one rank: nothing on the wire
    r.reckon("all-gather", 1600, 16, count=3)
    assert r.collective_wire_bytes == 3 * 15 / 16 * 1600 and r.n_collectives == 3


def test_collectives_issued_are_counted():
    """A c10d all_reduce over a fake group of 4 is counted as issued, with
    its group size, in a subprocess (no default group left in this one)."""
    prog = f"""
import sys; sys.modules["jax"] = None; sys.path.insert(0, {str(Path(__file__).resolve().parents[1] / "src")!r})
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.utils.opcount import OpCounter
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
g = dist.new_group([0, 1, 2, 3])
with OpCounter() as c:
    dist.all_reduce(torch.ones(256), group=g)
    dist.all_reduce(torch.ones(10), op=dist.ReduceOp.MAX)
print(json.dumps(c.report.as_dict()["collectives"]))
"""
    res = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    got = {(c["kind"], c["group"], c["source"]): c for c in json.loads(res.stdout.strip().splitlines()[-1])}
    assert got[("all-reduce", 4, "issued")]["bytes"] == 1024
    assert got[("all-reduce", 4, "issued")]["wire_bytes"] == 2 * 3 / 4 * 1024
    assert got[("all-reduce", 8, "issued")]["bytes"] == 40


def test_static_cost_terms_per_dtype():
    t = roofline.static_cost_terms({"bf16": 989e12, "f32": 67e12}, 3.35e12, 0.0)
    assert t["compute_s"] == pytest.approx(2.0) and t["memory_s"] == pytest.approx(1.0)
    assert t["bottleneck"] == "compute" and t["step_time_lb_s"] == pytest.approx(2.0)
    with pytest.raises(ValueError, match="unknown"):
        roofline.static_cost_terms({"int8": 1.0}, 0.0, 0.0)
    r = OpReport(flops_by_dtype={"bf16": 989e12}, dot_flops=989e12, hbm_bytes=0.0)
    out = roofline.roofline_terms(r, n_devices=2, model_flops=989e12)
    assert out["model_flops_ratio"] == pytest.approx(0.5) and out["mfu_upper_bound"] == pytest.approx(0.5)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_counts_on_meta_equal_counts_on_cpu(arch):
    cfg = get(arch).reduced()
    counts = []
    for dev in ("cpu", "meta"):
        model = Model(cfg, device=dev)
        batch = _batch(cfg, 2, 24, dev)
        with torch.inference_mode(), OpCounter() as c:
            model(batch)
        counts.append(c.report.as_dict())
    assert counts[0] == counts[1]
    assert counts[0]["dot_flops"] > 0 and counts[0]["hbm_bytes"] > 0


def test_views_free_and_kernel_charged_once():
    x = torch.randn(64, 32)
    with OpCounter() as c:
        x.view(32, 64).t()[:, :4].unsqueeze(0)
    assert c.report.n_ops == 0 and c.report.hbm_bytes == 0
    with OpCounter() as c:
        y = x + 1.0
    assert c.report.hbm_bytes == 2 * x.numel() * 4 and c.report.fusion_flops == x.numel()
    # flash: one op, 4 d FLOPs a scored pair a query head (3x in f32, TF32), q k v read, o written
    q, k, v = (torch.randn(1, 64, 4, 16) for _ in range(3))
    with OpCounter() as c:
        K.flash_attention(q, k, v, causal=True)
    pairs = 64 * 65 // 2
    assert c.report.kernel_calls == {"flash_attention": 1} and c.report.n_ops == 1
    assert c.report.flops_by_dtype == {"tf32": 3 * 4 * 4 * 16 * pairs}
    assert c.report.hbm_bytes == 4 * q.numel() * 4
    # an axpy in place: y read and written once, dy read once
    y, dy = torch.randn(1000, dtype=torch.float64), torch.randn(1000, dtype=torch.float64)
    with OpCounter() as c:
        K.axpy_reduce(y, dy, 0.5, out=y)
    assert c.report.kernel_calls == {"axpy_reduce": 1} and c.report.flops_by_dtype == {"f64": 4000}
    assert c.report.hbm_bytes == 3 * 8000 + 2 * 8  # y, dy, y; min and max


def test_peak_live_bytes():
    with OpCounter() as c:
        a = torch.empty(1000)  # 4,000 bytes
        b = a * 2  # 8,000 live
        del a
        d = b + 1  # a freed: 8,000 live again
    assert c.report.peak_live_bytes == 8000
    del b, d


def _batch(cfg, B, S, dev):
    rng = np.random.default_rng(0)
    if cfg.modality == "audio_frames":
        return {"frames": torch.tensor(rng.standard_normal((B, S, cfg.d_model)).astype(np.float32), device=dev)}
    if cfg.modality == "vision_text":
        npt = cfg.n_vision_patches
        return {"patches": torch.zeros(B, npt, cfg.d_model, device=dev),
                "tokens": torch.tensor(rng.integers(0, cfg.vocab_size, (B, S - npt)), device=dev)}
    return {"tokens": torch.tensor(rng.integers(0, cfg.vocab_size, (B, S)), device=dev)}


def _one_unit(cfg, S):
    """One repetition of the pattern unit, attention and the SSD in one
    chunk of S: the reference's scans over chunks have no trip count under
    jax 0.9, so its analyzer would count one chunk of each."""
    cfg = replace(cfg, n_layers=len(cfg.block_pattern or (cfg.pattern()[0],)), attn_chunk=S)
    return cfg if cfg.ssm is None else replace(cfg, ssm=replace(cfg.ssm, chunk=S))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dot_flops_match_reference_hlo(arch):
    B, S = 2, 32
    ref_cfg = _one_unit(ref_get(arch).reduced(), S)
    ref = RefModel(ref_cfg, fsdp=False)
    params = jax.eval_shape(ref.init, jax.random.PRNGKey(0))
    batch = {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.float32 if v.is_floating_point() else jnp.int32)
             for k, v in _batch(get(arch).reduced(), B, S, "meta").items()}
    text = jax.jit(ref.forward).lower(params, batch).compile().as_text()
    ref_dots = analyze_hlo(text).dot_flops

    model = Model(_one_unit(get(arch).reduced(), S), device="meta")
    with torch.inference_mode(), OpCounter() as c:
        model(_batch(model.cfg, B, S, "meta"))
    rel = abs(c.report.dot_flops - ref_dots) / ref_dots
    print(f"{arch}: dot FLOPs port {c.report.dot_flops:.6g}, reference HLO {ref_dots:.6g}, relative {rel:.4f}")
    assert rel <= DOT_REL, (c.report.dot_flops, ref_dots)
    assert math.isfinite(rel)

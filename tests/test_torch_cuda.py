"""The port on the card: each CUDA kernel vs its plain version, solves and
an encoder forward on the card vs the same on the CPU.

Every test here is marked ``cuda`` and skips where no card is present.
The file imports neither jax nor ``repro``, so on a machine with a card
and without jax it runs alone, skipping the repo's conftest.py:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from dataclasses import replace

from repro_torch import kernels as K
from repro_torch.api import MWUOptions, Solver, Status
from repro_torch.configs import get
from repro_torch.graphs import bipartite_ratings, build, generalized_matching_problem, rgg
from repro_torch.kernels.axpy_reduce.ref import axpy_reduce_ref
from repro_torch.kernels.flash_attention.ref import flash_attention_plain
from repro_torch.kernels.incidence_gather.ref import incidence_gather_ref
from repro_torch.kernels.linesearch_probe.ref import linesearch_probe_ref
from repro_torch.kernels.softmax_weights.ref import softmax_weights_ref
from repro_torch.models import Model

EPS = 0.1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 3, 1030, 300_000])
def test_kernels_match_plain_on_card(cuda, n, dtype):
    """Bars of tests/test_kernels.py; the gather and the axpy are bit-equal
    (one rounded add; y + alpha*dy rounded twice, no FMA)."""
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    gen = torch.Generator().manual_seed(n)
    y = torch.rand(n, generator=gen, dtype=dtype)
    dy = torch.rand(n, generator=gen, dtype=dtype) * 1e-3
    yc, dyc = y.to(cuda), dy.to(cuda)
    K.reset_launch_counts()

    lse, w = K.softmax_weights(yc, 211.0, sign=-1.0)
    lse_r, w_r = softmax_weights_ref(y, 211.0, sign=-1.0)
    assert abs(float(lse) - float(lse_r)) <= tol * max(1.0, abs(float(lse_r)))
    assert float((w.cpu() - w_r).abs().max()) <= tol

    for sign in (1.0, -1.0):
        got = K.linesearch_probe(yc, dyc, 7.5, 97.0, sign=sign).cpu()
        ref = linesearch_probe_ref(y, dy, 7.5, 97.0, sign=sign)
        assert float((got - ref).abs().max()) <= tol * max(1.0, float(ref.abs().max()))
        assert float(got[2]) == float(ref[2])  # min(y + alpha dy): exact

    out, mn, mx = K.axpy_reduce(yc, dyc, 3.25)
    out_r, mn_r, mx_r = axpy_reduce_ref(y, dy, 3.25)
    assert torch.equal(out.cpu(), out_r)
    assert float(mn) == float(mn_r) and float(mx) == float(mx_r)

    idx = torch.randint(0, n, (2 * n + 7,), generator=gen, dtype=torch.int32)
    jdx = idx.flip(0).contiguous()
    g = K.incidence_gather(idx.to(cuda), jdx.to(cuda), yc)
    assert torch.equal(g.cpu(), incidence_gather_ref(idx, jdx, y))
    torch.cuda.synchronize()
    assert K.launch_counts() == {"incidence_gather": 1, "softmax_weights": 1, "linesearch_probe": 2,
                                 "axpy_reduce": 1, "flash_attention": 0}


@pytest.mark.cuda
def test_card_wrappers_reject_bad_inputs(cuda):
    x = torch.rand(10, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        K.axpy_reduce(x.half(), x.half(), 1.0)
    with pytest.raises(ValueError):
        K.softmax_weights(x[::2], 1.0)  # not contiguous
    with pytest.raises(TypeError):
        i64 = torch.zeros(3, dtype=torch.int64, device=cuda)
        K.incidence_gather(i64, i64, x)
    with pytest.raises(ValueError):
        K.linesearch_probe(x, x[:5], 1.0, 1.0)


def _problem(family, device):
    if family in ("bmatch", "gen-match"):
        g = bipartite_ratings(60, 40, avg_ratings=6.0, seed=1)
        if family == "bmatch":
            return build("bmatch", g, device=device)
        s, deg = g.bipartite_split, g.degrees()
        lb, ub = np.zeros(g.n), np.ones(g.n)
        lb[:s] = np.minimum(1, deg[:s])
        ub[:s], ub[s:] = 5, 8
        return generalized_matching_problem(g, lb, ub, device=device)
    return build(family, rgg(8, seed=0), device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["match", "bmatch", "vcover", "dom-set", "dense-sub", "gen-match"])
def test_card_solve_matches_cpu(cuda, family):
    """The same instance on the card (CUDA kernels) and on the CPU (plain
    versions), at the solver bars of tests/test_torch_solver.py."""
    opts = MWUOptions(eps=EPS, step_rule="newton")
    cpu = Solver(opts).solve(_problem(family, "cpu"))
    K.reset_launch_counts()
    card = Solver(opts).solve(_problem(family, cuda))
    assert card.status == cpu.status == Status.FEASIBLE
    if family != "gen-match":
        assert card.bound == pytest.approx(cpu.bound, rel=1e-5)
        assert card.objective == pytest.approx(cpu.objective, rel=2 * EPS)
    counts = K.launch_counts()
    assert counts["softmax_weights"] > 0 and counts["axpy_reduce"] > 0
    assert (counts["incidence_gather"] > 0) == (family != "dom-set")  # dom-set's ops are scatter-based
    assert (counts["linesearch_probe"] > 0) == (family != "gen-match")  # masked probes stay plain


FLASH_TOLS = {torch.float32: 3e-5, torch.bfloat16: 2e-2}  # tests/test_kernels.py


def _qkv(shape_q, shape_kv, dtype, device, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=gen).to(dtype).to(device) for s in (shape_q, shape_kv, shape_kv)]


def _check_flash(q, k, v, causal, window):
    """One kernel launch against the plain version at the bar of q's dtype."""
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's f32 products in full f32
    K.reset_launch_counts()
    got = K.flash_attention(q, k, v, causal=causal, window=window)
    ref = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert K.launch_counts()["flash_attention"] == 1
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = FLASH_TOLS[q.dtype]
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 24), (True, 200), (False, None)])
@pytest.mark.parametrize("S", [1, 16, 63, 64, 127, 128, 129, 130])
@pytest.mark.parametrize("dh", [16, 32, 64, 80, 128])
def test_flash_attention_matches_plain_on_card(cuda, dh, S, causal, window, dtype):
    """The sweep of tests/test_kernels.py (GQA 4 over 2 heads) at every head dim, with S on both sides of the
    bf16 kernel's 64-row warpgroup and 128-row tile edges, and windows inside one tile (24) and across two (200)."""
    q, k, v = _qkv((2, S, 4, dh), (2, S, 2, dh), dtype, cuda, S + dh)
    _check_flash(q, k, v, causal, window)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,window", [(False, None), (True, 200), (False, 100)])
@pytest.mark.parametrize("dh,hq,hkv", [(16, 8, 2), (32, 6, 2), (64, 6, 1), (80, 16, 16), (128, 8, 1)])
def test_flash_attention_long_rows_on_card(cuda, dh, hq, hkv, causal, window):
    """Many key tiles and a ragged tail (S 1500 = 11.7 tiles of 128), GQA groups 1, 3, 4, 6 and 8; bf16,
    bidirectional, causal-windowed and bidirectional-windowed."""
    q, k, v = _qkv((1, 1500, hq, dh), (1, 1500, hkv, dh), torch.bfloat16, cuda, dh)
    _check_flash(q, k, v, causal, window)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [80, 128])
def test_flash_attention_ring_wraps_on_card(cuda, dh):
    """S 4096 causal at 2 heads: 32 key tiles pass the stage ring (4 stages at d 80, 2 at 128) many times."""
    q, k, v = _qkv((1, 4096, 2, dh), (1, 4096, 2, dh), torch.bfloat16, cuda, 7)
    _check_flash(q, k, v, True, None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 80, 128])
def test_flash_attention_fused_qkv_views_on_card(cuda, dh, dtype):
    """q, k and v as strided views of one fused (B, S, 3, H, d) projection: the kernels read strides (the bf16
    kernel through its tensor maps), nothing is copied."""
    gen = torch.Generator().manual_seed(dh)
    qkv = torch.randn(2, 300, 3, 4, dh, generator=gen).to(dtype).to(cuda)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous() and q.stride(1) == 3 * 4 * dh
    _check_flash(q, k, v, False, None)


@pytest.mark.cuda
def test_flash_attention_many_blocks_on_card(cuda):
    """B*Hq = 65,600 (batch 4,100 x 16 heads) in bf16: more blocks than the 65,535 of a grid's y axis and
    than many waves of 132 SMs; the bf16 kernel walks a flat grid."""
    q, k, v = _qkv((4100, 3, 16, 16), (4100, 3, 16, 16), torch.bfloat16, cuda, 1)
    _check_flash(q, k, v, True, None)


@pytest.mark.cuda
def test_flash_attention_rejects_bad_inputs(cuda):
    q, k, v = _qkv((1, 8, 2, 32), (1, 8, 2, 32), torch.float32, cuda, 0)
    with pytest.raises(TypeError):
        K.flash_attention(q.half(), k.half(), v.half())  # no float16 kernel
    with pytest.raises(ValueError):
        K.flash_attention(*_qkv((1, 8, 2, 48), (1, 8, 2, 48), torch.float32, cuda, 0))  # head dim 48
    with pytest.raises(ValueError):
        K.flash_attention(q, k.cpu(), v)
    wide = _qkv((1, 8, 2, 34), (1, 8, 2, 34), torch.float32, cuda, 0)
    with pytest.raises(ValueError):
        K.flash_attention(*(t[..., :32] for t in wide))  # head stride of 136 bytes: rows not 16-byte aligned
    with pytest.raises(ValueError):
        K.flash_attention(q, k[:, :, :1].expand(1, 8, 3, 32), v)  # 2 query heads over 3 kv heads
    with pytest.raises(ValueError):  # the f32 body's grid holds at most 65,535 (batch, head) pairs
        K.flash_attention(*_qkv((1, 2, 65540, 16), (1, 2, 65540, 16), torch.float32, cuda, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["hubert-cut", "hubert-xlarge", "minitron-4b", "starcoder2-15b"])
def test_model_forward_card_matches_cpu(cuda, arch):
    """Model.forward + logits at S 40 > attn_chunk 16, attn_impl pallas, f32:
    the card (flash kernel, cuBLAS) vs the CPU (plain versions), the same
    weights. "hubert-cut" is hubert at its real d_head 80 and MHA, 2 layers
    of width 160; the others are the configs' reduced(). Bar 1e-4 of the
    largest logit: f32 on both sides, sums in other orders."""
    torch.backends.cuda.matmul.allow_tf32 = False
    if arch == "hubert-cut":
        cfg = replace(get("hubert-xlarge"), n_layers=2, d_model=160, n_heads=2, n_kv_heads=2, d_head=80, d_ff=640,
                      attn_chunk=16, dtype="float32", param_dtype="float32", attn_impl="pallas")
    else:
        cfg = replace(get(arch).reduced(), attn_impl="pallas")
    cpu = Model(cfg, device="cpu", seed=1)
    card = Model(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(2)
    if cfg.modality == "audio_frames":
        batch = {"frames": torch.randn(2, 40, cfg.d_model, generator=gen) * 0.02}
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 40), generator=gen)}
    K.reset_launch_counts()
    with torch.inference_mode():
        ref = cpu.logits(cpu(batch))
        got = card.logits(card({k: t.to(cuda) for k, t in batch.items()})).cpu()
    assert K.launch_counts()["flash_attention"] == cfg.n_layers
    V = cfg.vocab_size
    assert torch.equal(got[..., V:], ref[..., V:])
    scale = ref[..., :V].abs().max()
    torch.testing.assert_close(got[..., :V] / scale, ref[..., :V] / scale, atol=1e-4, rtol=0)

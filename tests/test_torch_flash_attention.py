"""The port's flash attention vs the reference's Pallas kernel.

On the CPU ``repro_torch.kernels.flash_attention`` runs its plain version
(its tensors lie on the CPU). It is held against the reference's
``flash_attention(..., impl="pallas")`` in interpret mode, on the sweep and
at the bars of tests/test_kernels.py: 3e-5 at f32, 2e-2 at bf16 (the
reference rounds the softmax weights to bf16 at other places).

The CUDA kernel itself is held against this plain version on the card in
tests/test_torch_cuda.py. Its f32 body multiplies on the TF32 tensor cores
in three passes of split operands (3xTF32); ``test_tf32_split_plan`` shows
on the sweep why one pass is not enough for the f32 bar.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as ref_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as ref_folded
from repro_torch.kernels import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

TOLS = {"float32": 3e-5, "bfloat16": 2e-2}


def _inputs(rng, shape_q, shape_kv, dtype):
    arrs = [rng.standard_normal(s).astype(np.float32) for s in (shape_q, shape_kv, shape_kv)]
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    # the same values: the bf16 rounding of jnp, carried across through f32
    th = [torch.tensor(np.asarray(a.astype(jnp.float32))).to(getattr(torch, dtype)) for a in jx]
    return jx, th


SWEEP_S = [16, 63, 130]
SWEEP_MASKS = [(True, None), (True, 24), (False, None)]


@pytest.mark.parametrize("S", SWEEP_S)
@pytest.mark.parametrize("causal,window", SWEEP_MASKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_sweep(S, causal, window, dtype):
    rng = np.random.default_rng(S)
    B, Hq, Hkv, dh = 2, 4, 2, 32
    (q, k, v), (tq, tk, tv) = _inputs(rng, (B, S, Hq, dh), (B, S, Hkv, dh), dtype)
    ref = ref_flash(q, k, v, causal=causal, window=window, block_q=32, block_k=32, impl="pallas")
    got = flash_attention(tq, tk, tv, causal=causal, window=window, block_q=32, block_k=32)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, S, Hq, dh)
    tol = TOLS[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("dh", [16, 80])
def test_flash_attention_gqa_groups(dh):
    """GQA group folding: each q head attends its own kv head; d 80 is hubert's."""
    rng = np.random.default_rng(0)
    B, S, Hq, Hkv = 1, 32, 8, 2
    (q, k, v), (tq, tk, tv) = _inputs(rng, (B, S, Hq, dh), (B, S, Hkv, dh), "float32")
    ref = ref_flash(q, k, v, causal=True, block_q=16, block_k=16, impl="pallas")
    got = flash_attention(tq, tk, tv, causal=True, block_q=16, block_k=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-5)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 5), (False, 7)])
def test_folded_plain_version_matches_reference_oracle(causal, window):
    """The folded-layout plain version vs the reference's jnp oracle, Sq != Sk included."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((3, 11, 16)).astype(np.float32)
    kv = rng.standard_normal((2, 3, 13, 16)).astype(np.float32)
    ref = ref_folded(jnp.asarray(q), jnp.asarray(kv[0]), jnp.asarray(kv[1]), causal=causal, window=window)
    got = flash_attention_ref(torch.from_numpy(q), torch.from_numpy(kv[0]), torch.from_numpy(kv[1]),
                              causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32), atol=3e-5)


def _tf32_rna(x):
    """cvt.rna.tf32.f32 on f32 bit patterns: 10 mantissa bits, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_product(a, b, passes):
    """a @ b with TF32 operands and f32 sums: one pass (big * big), or the
    kernel's three (small * big + big * small + big * big, small terms first)."""
    a_big, b_big = _tf32_rna(a), _tf32_rna(b)
    if passes == 1:
        return a_big @ b_big
    a_small, b_small = _tf32_rna(a - a_big), _tf32_rna(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _tf32_attention(q, k, v, causal, window, passes):
    """The f32 kernel's numerics with its products emulated: scores scaled
    after the dot, the -1e30 mask, l summed before P meets V, acc / max(l, 1e-30)."""
    B, S, Hq, dh = q.shape

    def fold(t):  # (B, S, H, dh) -> (B * Hq, S, dh), each kv head repeated for its query heads
        return t.transpose(1, 2).repeat_interleave(Hq // t.shape[2], dim=1).reshape(B * Hq, S, dh)

    qf, kf, vf = fold(q), fold(k), fold(v)
    s = _tf32_product(qf, kf.transpose(1, 2), passes) * torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32)
    i = torch.arange(S)
    ok = torch.ones(S, S, dtype=torch.bool)
    if causal:
        ok &= i[None, :] <= i[:, None]
    if window is not None:
        ok &= i[None, :] > i[:, None] - window
    s = s.masked_fill(~ok, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    out = _tf32_product(p, vf, passes) / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(B, Hq, S, dh).transpose(1, 2)


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("S", SWEEP_S)
@pytest.mark.parametrize("causal,window", SWEEP_MASKS)
def test_tf32_split_plan(S, causal, window, passes):
    """Why the f32 kernel multiplies three times: on the sweep's inputs at d 32, products of TF32 operands
    in one pass miss the f32 bar against the reference's Pallas kernel, and the 3xTF32 split holds it."""
    rng = np.random.default_rng(S)
    B, Hq, Hkv, dh = 2, 4, 2, 32
    (q, k, v), (tq, tk, tv) = _inputs(rng, (B, S, Hq, dh), (B, S, Hkv, dh), "float32")
    ref = np.asarray(ref_flash(q, k, v, causal=causal, window=window, block_q=32, block_k=32, impl="pallas"))
    got = _tf32_attention(tq, tk, tv, causal, window, passes).numpy()
    tol = TOLS["float32"]
    excess = np.max(np.abs(got - ref) / (tol * (1 + np.abs(ref))))  # > 1: outside the bar
    if passes == 3:
        assert excess <= 1.0, excess
    else:
        assert excess > 1.0, excess

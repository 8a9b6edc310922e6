"""The port's flash attention vs the reference's Pallas kernel.

On the CPU ``repro_torch.kernels.flash_attention`` runs its plain version
(its tensors lie on the CPU). It is held against the reference's
``flash_attention(..., impl="pallas")`` in interpret mode, on the sweep and
at the bars of tests/test_kernels.py: 3e-5 at f32, 2e-2 at bf16 (the
reference rounds the softmax weights to bf16 at other places).

The CUDA kernel itself is held against this plain version on the card in
tests/test_torch_cuda.py.
"""
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


@pytest.mark.parametrize("S", [16, 63, 130])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 24), (False, None)])
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

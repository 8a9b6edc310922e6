"""The port's kernel functions vs the reference's Pallas kernels.

On the CPU each ``repro_torch.kernels`` wrapper runs its plain version
(its tensors lie on the CPU); it is held against the reference's Pallas
kernel in interpret mode (``impl="pallas"``), at the sizes and bars of
tests/test_kernels.py: the gather bit-exact, softmax and probe within
1e-4 at f32 and 1e-10 at f64, axpy within min(TOL, 1e-6). The two-sided
probe is held against two calls of the reference's probe, one a side.

The CUDA kernels themselves are held against these plain versions on the
card in tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.axpy_reduce.ops import axpy_reduce as ref_axpy
from repro.kernels.incidence_gather.ops import incidence_gather as ref_gather
from repro.kernels.linesearch_probe.ops import linesearch_probe as ref_probe
from repro.kernels.softmax_weights.ops import softmax_weights as ref_softmax
from repro_torch import kernels as K
from repro_torch.kernels import loader

SIZES = [3, 127, 1024, 1030, 4096, 9999]
DTYPES = [np.float32, np.float64]
TOLS = {np.float32: 1e-4, np.float64: 1e-10}
TORCH = {np.float32: torch.float32, np.float64: torch.float64}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
def test_incidence_gather(n, dtype):
    rng = np.random.default_rng(n)
    E = 2 * n + 5
    u = rng.integers(0, n, E).astype(np.int32)
    v = rng.integers(0, n, E).astype(np.int32)
    w = rng.standard_normal(n).astype(dtype)
    g = K.incidence_gather(torch.from_numpy(u), torch.from_numpy(v), torch.from_numpy(w))
    assert g.dtype == TORCH[dtype]
    np.testing.assert_array_equal(g.numpy(), np.asarray(ref_gather(jnp.asarray(u), jnp.asarray(v),
                                                                   jnp.asarray(w), impl="pallas")))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_softmax_weights(n, sign, dtype):
    rng = np.random.default_rng(n)
    tol = TOLS[dtype]
    v = rng.standard_normal(n).astype(dtype)
    lse, w = K.softmax_weights(torch.from_numpy(v), 211.0, sign=sign)
    lse_r, w_r = ref_softmax(jnp.asarray(v), jnp.asarray(211.0, dtype), sign=sign, impl="pallas")
    assert w.dtype == lse.dtype == TORCH[dtype]
    np.testing.assert_allclose(float(lse), float(lse_r), rtol=tol)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_r), atol=tol)
    np.testing.assert_allclose(float(w.sum()), 1.0, rtol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_linesearch_probe(n, sign, dtype):
    rng = np.random.default_rng(n)
    tol = TOLS[dtype]
    y = rng.random(n).astype(dtype)
    dy = (rng.random(n) * 1e-3).astype(dtype)
    out = torch.empty(5, dtype=TORCH[dtype])
    got = K.linesearch_probe(torch.from_numpy(y), torch.from_numpy(dy), 7.5, 97.0, sign=sign, out=out[1:4])
    assert got.data_ptr() == out[1:4].data_ptr() and got.dtype == TORCH[dtype]
    ref = ref_probe(jnp.asarray(y), jnp.asarray(dy), jnp.asarray(7.5, dtype), jnp.asarray(97.0, dtype),
                    sign=sign, impl="pallas")
    for a, b in zip(got.tolist(), ref):
        assert abs(a - float(b)) < tol, (sign, a, float(b))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,nz", [(9, 1), (1024, 1), (3333, 1), (9, 9), (1024, 77), (3333, 3333)])
def test_linesearch_probe2(n, nz, dtype):
    """Both sides in one call: (y, dy) at sign +1, then (z, dz) at sign -1."""
    rng = np.random.default_rng(n + nz)
    tol = TOLS[dtype]
    y, z = rng.random(n).astype(dtype), rng.random(nz).astype(dtype)
    dy, dz = (rng.random(n) * 1e-3).astype(dtype), (rng.random(nz) * 1e-3).astype(dtype)
    out = torch.empty(6, dtype=TORCH[dtype])
    got = K.linesearch_probe2(*map(torch.from_numpy, (y, dy, z, dz)), 7.5, 97.0, out=out)
    assert got.data_ptr() == out.data_ptr() and got.dtype == TORCH[dtype]
    ref = [float(v) for x, dx, sign in ((y, dy, 1.0), (z, dz, -1.0))
           for v in ref_probe(jnp.asarray(x), jnp.asarray(dx), jnp.asarray(7.5, dtype), jnp.asarray(97.0, dtype),
                              sign=sign, impl="pallas")]
    for a, b in zip(got.tolist(), ref):
        assert abs(a - b) < tol, (a, b)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
def test_axpy_reduce(n, dtype):
    rng = np.random.default_rng(n)
    tol = min(TOLS[dtype], 1e-6)
    y = rng.standard_normal(n).astype(dtype)
    dy = rng.random(n).astype(dtype)
    out, mn, mx = K.axpy_reduce(torch.from_numpy(y), torch.from_numpy(dy), 3.25)
    out_r, mn_r, mx_r = ref_axpy(jnp.asarray(y), jnp.asarray(dy), jnp.asarray(3.25, dtype), impl="pallas")
    assert out.dtype == TORCH[dtype]
    np.testing.assert_allclose(out.numpy(), np.asarray(out_r), atol=tol)
    assert abs(float(mn) - float(mn_r)) < tol
    assert abs(float(mx) - float(mx_r)) < tol


def test_partial_blocks_geometry():
    """One partial per 256-thread block, capped at one per resident block."""
    assert loader.partial_blocks(1) == 1
    assert loader.partial_blocks(256) == 1 and loader.partial_blocks(257) == 2
    assert loader.partial_blocks(98_609_647) == loader.MAX_PARTIALS == 132 * 8


def test_cpu_calls_launch_nothing():
    """CPU tensors take the plain versions and leave the launch counts at 0."""
    K.reset_launch_counts()
    x = torch.rand(50, dtype=torch.float64)
    K.axpy_reduce(x, x, 0.5)
    K.softmax_weights(x, 3.0)
    K.linesearch_probe(x, x, 0.5, 3.0)
    K.linesearch_probe2(x, x, x[:3], x[:3], 0.5, 3.0)
    K.newton_search(x, x * 1e-3, x[:3], x[:3] * 1e-3, 3.0, 0.1)
    K.incidence_gather(torch.zeros(4, dtype=torch.int32), torch.ones(4, dtype=torch.int32), x)
    assert K.launch_counts() == {name: 0 for name in K.KERNELS}


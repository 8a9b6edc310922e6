"""repro_torch — the MWU graph-LP solver ported to PyTorch and CUDA.

The port of the JAX package ``repro`` (which stays as its reference),
module for module: ``graphs`` (host graphs, generators, baselines,
builders), ``core`` (operators, smoothing, step size, the MWU loop),
``api`` (``Problem``, ``Solver``) and ``kernels`` (hand-written CUDA
kernels for Hopper, each with a plain PyTorch version). It imports
``torch``, numpy and scipy, never ``jax`` or ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
the default dtype is float64.
"""
__version__ = "0.1.0"

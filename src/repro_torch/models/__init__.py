"""LM plane of the port: configs' models built from layers, in PyTorch.

``Model(cfg, device=...)`` runs the full-sequence forward of the ``attn``
architectures (dense GQA decoders and the hubert encoder);
``load_jax_params`` carries the reference's parameters across.
"""
from .model import Model, load_jax_params

__all__ = ["Model", "load_jax_params"]

"""LM plane of the port: configs' models built from layers, in PyTorch.

``Model(cfg, device=...)`` runs the full-sequence forward (with
rematerialization when training), prefill and decode of every in-repo
config: the ``attn`` architectures (dense GQA decoders, the hubert
encoder, internvl2's ``vision_text`` decoder, and the MoE decoders mixtral
and dbrx with the ``topk`` or the MWU LP router), mamba2's ``ssm`` stack
and recurrentgemma's ``rglru``/``attn`` hybrid; ``load_jax_params``
carries the reference's parameters across (its training state:
``repro_torch.train.load_jax_train_state``).
"""
from .model import DecodeCaches, Model, load_jax_params

__all__ = ["Model", "DecodeCaches", "load_jax_params"]

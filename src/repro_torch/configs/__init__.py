"""Per-architecture configs of the LM plane, copied from ``repro.configs``.

The same ten architectures with the same numbers, ``reduced()`` and the
registry (``get``, ``ARCH_IDS``, the ``-mwu`` suffix); ``shapes`` holds the
input-shape cells (``SHAPES``, ``input_specs``, ``concrete_inputs``).
"""
from .base import ModelConfig, MoEConfig, SSMConfig
from .registry import ARCH_IDS, all_configs, get

__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "ARCH_IDS", "get", "all_configs"]

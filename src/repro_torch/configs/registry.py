"""Architecture registry: ``get(arch_id)`` -> ModelConfig.

One module per assigned architecture (exact pool numbers); IDs match the
assignment table. ``mwu-graph`` is the paper's own workload as a
dry-runnable config (distributed MWU on a synthetic graph).
"""
from __future__ import annotations

from importlib import import_module

ARCH_IDS = [
    "yi-34b",
    "qwen1.5-32b",
    "starcoder2-15b",
    "minitron-4b",
    "mamba2-1.3b",
    "dbrx-132b",
    "mixtral-8x22b",
    "internvl2-26b",
    "hubert-xlarge",
    "recurrentgemma-9b",
]

_MODULES = {
    "yi-34b": "yi_34b",
    "qwen1.5-32b": "qwen1_5_32b",
    "starcoder2-15b": "starcoder2_15b",
    "minitron-4b": "minitron_4b",
    "mamba2-1.3b": "mamba2_1_3b",
    "dbrx-132b": "dbrx_132b",
    "mixtral-8x22b": "mixtral_8x22b",
    "internvl2-26b": "internvl2_26b",
    "hubert-xlarge": "hubert_xlarge",
    "recurrentgemma-9b": "recurrentgemma_9b",
}


def get(arch_id: str):
    if arch_id.endswith("-mwu"):  # MoE variant with the MWU LP router
        base = get(arch_id[: -len("-mwu")])
        from dataclasses import replace

        assert base.moe is not None, f"{arch_id}: MWU router needs an MoE arch"
        return replace(base, name=arch_id, moe=replace(base.moe, router="mwu"))
    mod = import_module(f".{_MODULES[arch_id]}", package=__package__)
    return mod.CONFIG


def all_configs():
    return {a: get(a) for a in ARCH_IDS}

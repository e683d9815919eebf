"""Model configurations of the port: the deformable-DETR family
(``detr_family``) and the reference's ten LM architectures, each module
with a published-width ``CONFIG`` and a ``SMOKE`` config for the CPU
tests."""
from __future__ import annotations

import importlib

_ARCH_MODULES = {
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "grok-1-314b": "repro_torch.configs.grok_1_314b",
    "granite-20b": "repro_torch.configs.granite_20b",
    "minitron-8b": "repro_torch.configs.minitron_8b",
    "minitron-4b": "repro_torch.configs.minitron_4b",
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "mamba2-130m": "repro_torch.configs.mamba2_130m",
    "llava-next-34b": "repro_torch.configs.llava_next_34b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
}

#: the reference's ten architectures, in its order
ARCH_IDS = list(_ARCH_MODULES)


def get_config(arch: str):
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


def get_smoke_config(arch: str):
    return importlib.import_module(_ARCH_MODULES[arch]).SMOKE


def get_detr_config(name: str):
    """A deformable-DETR family config (``configs/detr_family.CONFIGS``)."""
    from repro_torch.configs.detr_family import CONFIGS
    return CONFIGS[name]

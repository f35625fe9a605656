"""Assigned-architecture registry: ``get_config(arch_id)``.

One module per architecture (exact configs from the task brief, sources in
each file's docstring).  ``--arch <id>`` in the launchers resolves here.
"""
from __future__ import annotations

import importlib

ARCH_IDS = (
    "llama3_2_3b",
    "stablelm_12b",
    "h2o_danube3_4b",
    "olmo_1b",
    "phi3_5_moe",
    "mixtral_8x7b",
    "hubert_xlarge",
    "falcon_mamba_7b",
    "zamba2_2_7b",
    "internvl2_2b",
)

# accept the dashed names from the brief too
ALIASES = {
    "llama3.2-3b": "llama3_2_3b",
    "stablelm-12b": "stablelm_12b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "olmo-1b": "olmo_1b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe",
    "mixtral-8x7b": "mixtral_8x7b",
    "hubert-xlarge": "hubert_xlarge",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "zamba2-2.7b": "zamba2_2_7b",
    "internvl2-2b": "internvl2_2b",
}

def _module(arch: str):
    arch = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    return _module(arch).SMOKE_CONFIG

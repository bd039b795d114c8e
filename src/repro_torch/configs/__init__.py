"""Assigned-architecture registry: one module per arch, exact public configs.

Each module exports ``CONFIG`` (the full assignment-spec config) and
``reduced()`` (a same-family, CPU-smoke-test-sized config).

The port's copy of :mod:`repro.configs` (data only): the same ``ARCHS``,
``ALIASES``, full and reduced configurations.  The dense, moe, ssm and
hybrid families run in the port so far
(:mod:`repro_torch.models.transformer`).

Beside the architectures, ``WORKLOADS`` names the model-reduction
workloads: ``gw_greedy`` (:mod:`repro_torch.configs.gw_greedy`), the
paper's Blue Waters build, which sizes :mod:`repro_torch.launch.reduce`.
"""

import importlib

ARCHS = [
    "llama4_maverick_400b_a17b",
    "mixtral_8x7b",
    "starcoder2_15b",
    "stablelm_3b",
    "granite_3_8b",
    "qwen1_5_110b",
    "mamba2_780m",
    "llama_3_2_vision_11b",
    "recurrentgemma_9b",
    "seamless_m4t_medium",
]

# model-reduction workloads (not architectures): module names
WORKLOADS = ["gw_greedy"]

# CLI ids (dashes) -> module names
ALIASES = {a.replace("_", "-"): a for a in ARCHS}
ALIASES.update({
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "mixtral-8x7b": "mixtral_8x7b",
    "starcoder2-15b": "starcoder2_15b",
    "stablelm-3b": "stablelm_3b",
    "granite-3-8b": "granite_3_8b",
    "qwen1.5-110b": "qwen1_5_110b",
    "mamba2-780m": "mamba2_780m",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "seamless-m4t-medium": "seamless_m4t_medium",
})


def get_config(name: str):
    mod = importlib.import_module(
        f"repro_torch.configs.{ALIASES.get(name, name)}"
    )
    return mod.CONFIG


def get_reduced(name: str):
    mod = importlib.import_module(
        f"repro_torch.configs.{ALIASES.get(name, name)}"
    )
    return mod.reduced()


def arch_ids():
    return [
        "llama4-maverick-400b-a17b", "mixtral-8x7b", "starcoder2-15b",
        "stablelm-3b", "granite-3-8b", "qwen1.5-110b", "mamba2-780m",
        "llama-3.2-vision-11b", "recurrentgemma-9b", "seamless-m4t-medium",
    ]

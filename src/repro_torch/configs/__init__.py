"""Architecture registry (a copy of the reference's, as data): one module per
arch, CONFIG + SMOKE."""
from __future__ import annotations

import importlib

ARCHS = [
    "llama_3_2_vision_11b",
    "xlstm_350m",
    "seamless_m4t_medium",
    "deepseek_67b",
    "starcoder2_15b",
    "stablelm_1_6b",
    "granite_3_8b",
    "moonshot_v1_16b_a3b",
    "arctic_480b",
    "recurrentgemma_2b",
]

# CLI ids use dashes (--arch llama-3.2-vision-11b)
CLI_IDS = {
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "xlstm-350m": "xlstm_350m",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "deepseek-67b": "deepseek_67b",
    "starcoder2-15b": "starcoder2_15b",
    "stablelm-1.6b": "stablelm_1_6b",
    "granite-3-8b": "granite_3_8b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "arctic-480b": "arctic_480b",
    "recurrentgemma-2b": "recurrentgemma_2b",
}


def get(name: str, smoke: bool = False):
    mod_name = CLI_IDS.get(name, name)
    mod = importlib.import_module(f".{mod_name}", __name__)
    return mod.SMOKE if smoke else mod.CONFIG


def all_archs():
    return list(CLI_IDS.keys())

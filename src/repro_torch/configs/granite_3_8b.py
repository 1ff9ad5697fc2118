"""granite-3-8b [dense] — GQA.

40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155
[hf:ibm-granite/granite-3.0-2b-base; hf]
"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12800, vocab=49155,
    layer_pattern=("attn",),
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=0,
    d_ff=128, vocab=512)

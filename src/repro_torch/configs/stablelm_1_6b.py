"""stablelm-1.6b [dense] — MHA (kv=32).

24L d_model=2048 32H d_ff=5632 vocab=100352
[hf:stabilityai/stablelm-2-1_6b; unverified]
"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=5632, vocab=100352,
    layer_pattern=("attn",),
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=0,
    d_ff=128, vocab=512)

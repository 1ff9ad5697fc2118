"""starcoder2-15b [dense] — GQA, RoPE.

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152
[arXiv:2402.19173; hf]
"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4,
    d_ff=24576, vocab=49152,
    layer_pattern=("attn",), rope_theta=100000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=0,
    d_ff=128, vocab=512)

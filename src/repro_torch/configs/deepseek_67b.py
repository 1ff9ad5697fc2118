"""deepseek-67b [dense] — llama-arch GQA decoder.

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400
[arXiv:2401.02954; hf]
"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab=102400,
    layer_pattern=("attn",),
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=0,
    d_ff=128, vocab=512)

"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1 attn : 2 recurrent.

26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000, window=2048
[arXiv:2402.19427; hf]
Pattern (rglru, rglru, local_attn) cycled; 26 = 8*3 + 2 leaves a 2-layer
remainder (rglru, rglru), matching Griffin's tail.
"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab=256000,
    layer_pattern=("rglru", "rglru", "local_attn"), window=2048,
    d_recurrent=2560,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=5, d_model=64, n_heads=2, n_kv_heads=1, head_dim=0,
    d_ff=128, vocab=512, window=32, d_recurrent=64)

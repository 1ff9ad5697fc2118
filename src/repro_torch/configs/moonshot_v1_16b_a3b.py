"""moonshot-v1-16b-a3b [moe] — kimi/moonlight, 64 experts top-6.

48L d_model=2048 16H d_ff(expert)=1408 vocab=163840, MoE 64e top-6
[hf:moonshotai/Moonlight-16B-A3B; hf]
MoE dispatch/combine runs on the engine's segment-aggregation primitive
(DESIGN.md §5 — token->expert routing as bipartite mrTriplets).
"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=0, vocab=163840,
    n_experts=64, top_k=6, d_ff_expert=1408,
    layer_pattern=("attn",),
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=0,
    vocab=512, n_experts=8, top_k=2, d_ff_expert=32)

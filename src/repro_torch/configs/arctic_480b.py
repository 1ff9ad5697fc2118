"""arctic-480b [moe] — 128 experts top-2 + dense residual.

35L d_model=7168 56H (GQA kv=8) d_ff=4864, MoE 128e top-2, vocab=32000
[hf:Snowflake/snowflake-arctic-base; hf]
Dense residual: a d_ff dense FFN runs in parallel with the MoE each layer.
"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab=32000,
    n_experts=128, top_k=2, d_ff_expert=4864, dense_residual=True,
    layer_pattern=("attn",),
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=0,
    d_ff=64, vocab=512, n_experts=8, top_k=2, d_ff_expert=32)

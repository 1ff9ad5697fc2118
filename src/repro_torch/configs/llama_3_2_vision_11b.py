"""llama-3.2-vision-11b [vlm] — cross-attn image layers every 5.

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
Vision frontend is a STUB: input_specs provides precomputed patch
embeddings (1601 CLIP-style patches -> padded to 1664 for tiling).
"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=128256,
    layer_pattern=("attn",), cross_attn_every=5,
    n_context_tokens=1664, rope_theta=500000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=5, d_model=64, n_heads=4, n_kv_heads=2, head_dim=0,
    d_ff=128, vocab=512, n_context_tokens=16)

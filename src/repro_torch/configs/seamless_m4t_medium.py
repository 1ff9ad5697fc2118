"""seamless-m4t-medium [audio] — encoder-decoder, multimodal.

12L (enc) + 12L (dec) d_model=1024 16H d_ff=4096 vocab=256206
[arXiv:2308.11596; hf]
Audio frontend is a STUB: input_specs provides precomputed frame embeddings
(decoder seq = seq_len; encoder frames = seq_len // 4, speech downsampling).
"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206,
    layer_pattern=("attn",), enc_layers=12,
    n_context_tokens=1024, frontend_downsample=4,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=0, d_ff=128, vocab=512, n_context_tokens=16)

"""xlstm-350m [ssm] — sLSTM + mLSTM blocks (3:1 mLSTM:sLSTM, xLSTM[7:1]-style
ratio rounded to the 24-layer budget; assignment config is 'unverified').

24L d_model=1024 4H d_ff=0 vocab=50304 [arXiv:2405.04517]
d_ff=0: xLSTM blocks carry their own up/down projections; no separate FFN.
"""
import dataclasses
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    layer_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    mlstm_chunk=64,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, n_heads=2, head_dim=0, vocab=512)

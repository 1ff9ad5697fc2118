"""Architecture config schema + the assigned input-shape grid."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                      # dense FFN width (0 = no dense FFN)
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    dense_residual: bool = False   # arctic: dense FFN in parallel with MoE
    # --- layer pattern (cycled over n_layers) ---
    # block types: attn | local_attn | mlstm | slstm | rglru
    layer_pattern: tuple[str, ...] = ("attn",)
    window: int = 0                # local attention window
    d_recurrent: int = 0           # RG-LRU width (0 -> d_model)
    mlstm_chunk: int = 64
    # --- multimodal ---
    cross_attn_every: int = 0      # vlm: cross-attn sublayer every k-th layer
    n_context_tokens: int = 0      # image patches / audio frames (stub frontend)
    enc_layers: int = 0            # enc-dec: encoder depth (decoder = n_layers)
    frontend_downsample: int = 1   # enc seq = seq_len // this (audio)
    # --- misc ---
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.d_recurrent == 0 and "rglru" in self.layer_pattern:
            object.__setattr__(self, "d_recurrent", self.d_model)

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def attention_free(self) -> bool:
        return not any(t.startswith("attn") or t == "local_attn"
                       for t in self.layer_pattern)

    @property
    def subquadratic(self) -> bool:
        """Can this arch run 500k-token contexts? (SSM/hybrid/linear)."""
        return all(t in ("mlstm", "slstm", "rglru", "local_attn")
                   for t in self.layer_pattern)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


# The assigned input-shape grid (applies to every architecture).
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runnable?, reason-if-not).  Encodes the assignment's skip rules."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("full-attention KV at 524k tokens is quadratic-cost; "
                       "skipped per assignment (runs for SSM/hybrid only)")
    return True, ""

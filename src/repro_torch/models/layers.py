"""Shared LM layers: norms, rotary embeddings, attention, MLP, embedding.

The port of `repro/models/layers.py`.  Parameters are plain nested dicts of
tensors whose key paths equal the reference's value tree
(`layers.split_params(...)[0]`), so `models.convert` carries the
reference's weights across by path.  Each cast sits where the reference
has it: f32 parameters, bf16 inputs to every einsum, f32 norm, rope,
softmax and logits.  Attention over a context goes through
`kernels.ops.flash_attention` (the CUDA kernel on the card); the decode
step's self-attention over its cache stays plain torch, as the reference
keeps it plain jnp.
"""
from __future__ import annotations

import torch

from ..kernels import ops as kops

BF16 = torch.bfloat16


def normal(shape: tuple, scale: float, *,
           generator: torch.Generator | None, device) -> torch.Tensor:
    """f32 N(0, scale^2) drawn on `device` from `generator` (None: the
    default generator; the meta device draws nothing)."""
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.float32).mul_(scale)


# ---------------------------------------------------------------------------
# Primitive layers
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6):
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * gamma


def init_rms(d: int, *, device) -> torch.Tensor:
    return torch.ones(d, dtype=torch.float32, device=device)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., in] @ w [in, out] with bf16 compute, f32 params."""
    return torch.einsum("...i,io->...o", x.to(BF16), w.to(BF16)).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """x [B, H, L, Dh]; positions [B, L] (absolute)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[:, None, :, None].float() * freqs       # [B, 1, L, half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------
def init_attention(cfg, *, generator: torch.Generator, device,
                   lead: tuple = ()) -> dict:
    """wq [d, Hq, Dh], wk/wv [d, Hkv, Dh], wo [Hq, Dh, d]; `lead` stacks
    layers on leading axes."""
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(generator=generator, device=device)
    return {"wq": normal(lead + (d, hq, dh), d ** -0.5, **kw),
            "wk": normal(lead + (d, hkv, dh), d ** -0.5, **kw),
            "wv": normal(lead + (d, hkv, dh), d ** -0.5, **kw),
            "wo": normal(lead + (hq, dh, d), (hq * dh) ** -0.5, **kw)}


def project_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B, L, d] @ w [d, H, Dh] -> [B, H, L, Dh] in bf16."""
    return torch.einsum("bld,dhk->bhlk", x.to(BF16), w.to(BF16))


def merge_heads(o: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """o [B, H, L, Dh] @ w [H, Dh, d] -> [B, L, d] in `dtype`."""
    return torch.einsum("bhlk,hkd->bld", o.to(BF16), w.to(BF16)).to(dtype)


def attention(p: dict, x: torch.Tensor, positions: torch.Tensor, *, cfg,
              causal: bool = True, window: int | None = None, kv=None,
              kv_offset: int = 0, mode: str = "auto"):
    """Self attention.  kv=(k_cache, v_cache) attends over the cache with
    the new keys written at kv_offset.  Returns (out, (k, v))."""
    if window is not None:
        raise NotImplementedError(
            "sliding-window attention (_windowed_attention) is not ported "
            "yet: ROADMAP Queue 1 slice 10")
    q = rope(project_heads(x, p["wq"]), positions, cfg.rope_theta)
    k = rope(project_heads(x, p["wk"]), positions, cfg.rope_theta)
    v = project_heads(x, p["wv"])
    if kv is not None:
        k_cache, v_cache = kv
        l = x.shape[1]
        k_full, v_full = k_cache.clone(), v_cache.clone()
        k_full[:, :, kv_offset:kv_offset + l] = k.to(k_cache.dtype)
        v_full[:, :, kv_offset:kv_offset + l] = v.to(v_cache.dtype)
        out = kops.flash_attention(q, k_full, v_full, causal=causal,
                                   kv_offset=kv_offset, mode=mode)
        new_kv = (k_full, v_full)
    else:
        out = kops.flash_attention(q, k, v, causal=causal, mode=mode)
        new_kv = (k, v)
    return merge_heads(out, p["wo"], x.dtype), new_kv


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int) -> torch.Tensor:
    """Single-token attention over a cache (a bandwidth-bound
    matrix-vector product; plain torch, as the reference keeps it plain).

    q [B, Hq, 1, Dh]; caches [B, Hkv, Lc, Dh]; slots with index > pos are
    masked (a full ring buffer passes pos >= Lc - 1: nothing masked)."""
    b, hq, _, dh = q.shape
    hkv, lc = k_cache.shape[1], k_cache.shape[2]
    qf = q.float().reshape(b, hkv, hq // hkv, dh) * dh ** -0.5
    scores = torch.einsum("bhgd,bhld->bhgl", qf, k_cache.float())
    mask = torch.arange(lc, device=q.device) <= pos
    scores = torch.where(mask, scores, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgl,bhld->bhgd", probs, v_cache.float())
    return out.reshape(b, hq, 1, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def init_mlp(cfg, *, generator: torch.Generator, device, lead: tuple = (),
             d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    kw = dict(generator=generator, device=device)
    return {"wi": normal(lead + (d, f), d ** -0.5, **kw),
            "wg": normal(lead + (d, f), d ** -0.5, **kw),
            "wo": normal(lead + (f, d), f ** -0.5, **kw)}


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = torch.nn.functional.silu(dense(x, p["wg"])) * dense(x, p["wi"])
    return dense(h, p["wo"])


# ---------------------------------------------------------------------------
# Embedding + tied LM head
# ---------------------------------------------------------------------------
def init_embed(cfg, *, generator: torch.Generator, device) -> dict:
    return {"tok": normal((cfg.vocab, cfg.d_model), cfg.d_model ** -0.5,
                          generator=generator, device=device)}


def embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens]


def lm_logits(p_embed: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied LM head: f32 logits [B, L, vocab]."""
    return torch.einsum("bld,vd->blv", x.to(BF16),
                        p_embed["tok"].to(BF16)).float()


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Cross entropy over the vocab axis with an f32 logsumexp; the mean
    over tokens, or over the tokens `mask` keeps."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels.long()[..., None],
                                dim=-1)[..., 0]
    loss = lse - gold
    if mask is not None:
        mask = mask.to(loss.dtype)
        return (loss * mask).sum() / torch.clamp(mask.sum(), min=1)
    return loss.mean()

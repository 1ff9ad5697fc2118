"""Model assembly: ModelConfig -> parameters, the training forward and
loss, decode state and one decode step.

The port of `repro/models/transformer.py`, in the reference's stacked
layout: layer i of a model with layer period P lives in `blocks/slot{i % P}`
at index i // P of a leading n_super axis (period lcm(pattern,
cross_attn_every), so every slot has one structure), and a Python loop over
n_super takes the place of `lax.scan`.  Ported: attention blocks (global
and local) with dense MLPs and cross-attention sublayers, for decoding; and
mLSTM and sLSTM blocks, for the full-sequence forward (training) and for
decoding.  The training forward through attention blocks needs the flash
backward; it, MoE, RG-LRU and encoder-decoder models raise
NotImplementedError (ROADMAP Queue 1 slice 10).

The forward keeps every activation for the backward: the reference's
`jax.checkpoint` around each super-layer is a memory knob, and xlstm-350m's
batch 8 x seq 1024 step fits one 80 GB card without recompute.

Cross-attention (`_cross_attention`) is where decoding reaches the flash
kernel: its keys and values come from a fixed context, recomputed every
step as in the reference.  The mLSTM blocks' forward reaches the mLSTM
kernels, and their backward the backward kernel.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from ..configs.base import ModelConfig
from ..core.tree import tree_leaves
from ..kernels import ops as kops
from . import layers as L
from . import recurrent as R

_PENDING = "is not ported yet: ROADMAP Queue 1 slice 10"


def _pattern(cfg: ModelConfig) -> tuple[list[str], int, int]:
    """(types per super-layer, n_super, n_remainder); the period is
    lcm(pattern, cross_attn_every) so each slot is homogeneous."""
    period = len(cfg.layer_pattern)
    if cfg.cross_attn_every:
        period = math.lcm(period, cfg.cross_attn_every)
    types = [cfg.layer_pattern[i % len(cfg.layer_pattern)]
             for i in range(period)]
    n_super, rem = divmod(cfg.n_layers, period)
    return types, n_super, rem


def _layer_has_cross(cfg: ModelConfig, layer_idx: int) -> bool:
    if cfg.is_encdec:
        return True
    if cfg.cross_attn_every:
        return (layer_idx + 1) % cfg.cross_attn_every == 0
    return False


_ATTN = ("attn", "local_attn")
_RECURRENT = ("mlstm", "slstm")


def _check_supported(cfg: ModelConfig, kind: str, *,
                     training: bool = False) -> None:
    if cfg.is_encdec:
        raise NotImplementedError(f"encoder-decoder models {_PENDING}")
    if kind not in _ATTN + _RECURRENT:
        raise NotImplementedError(f"{kind} blocks {_PENDING}")
    if cfg.family == "moe":
        raise NotImplementedError(f"MoE blocks {_PENDING}")
    if training and kind in _ATTN:
        raise NotImplementedError(
            f"the training forward through {kind} blocks needs the flash "
            f"backward, which {_PENDING}")


def _init_block(cfg: ModelConfig, kind: str, *, with_cross: bool,
                lead: tuple, generator: torch.Generator, device) -> dict:
    """One block's parameters, stacked on `lead` leading axes."""
    _check_supported(cfg, kind)
    kw = dict(generator=generator, device=device)
    ones = lambda: L.init_rms(cfg.d_model, device=device).expand(  # noqa: E731
        lead + (cfg.d_model,)).clone()
    if kind in _RECURRENT:
        init = R.init_mlstm if kind == "mlstm" else R.init_slstm
        return {"ln1": ones(), "mix": init(cfg, lead=lead, **kw)}
    p: dict[str, Any] = {"ln1": ones(),
                         "attn": L.init_attention(cfg, lead=lead, **kw)}
    if cfg.d_ff:
        p["ln2"] = ones()
        p["mlp"] = L.init_mlp(cfg, lead=lead, **kw)
    if with_cross:
        p["lnx"] = ones()
        p["xattn"] = L.init_attention(cfg, lead=lead, **kw)
    return p


def init_model(cfg: ModelConfig, *, generator: torch.Generator,
               device) -> dict:
    """Random parameters drawn on `device` from `generator` (f32), in the
    reference's tree layout; no host copy of the weights is made."""
    types, n_super, rem = _pattern(cfg)
    period = len(types)
    kw = dict(generator=generator, device=device)
    params: dict[str, Any] = {
        "embed": L.init_embed(cfg, **kw),
        "final_norm": L.init_rms(cfg.d_model, device=device)}
    if n_super > 0:
        params["blocks"] = {
            f"slot{j}": _init_block(cfg, types[j],
                                    with_cross=_layer_has_cross(cfg, j),
                                    lead=(n_super,), **kw)
            for j in range(period)}
    if rem:
        params["rem"] = {
            f"layer{i}": _init_block(
                cfg, types[i % period],
                with_cross=_layer_has_cross(cfg, n_super * period + i),
                lead=(), **kw)
            for i in range(rem)}
    if cfg.n_context_tokens:
        # modality frontend stub: one projection of precomputed embeddings
        params["frontend"] = {"proj": L.normal(
            (cfg.d_model, cfg.d_model), cfg.d_model ** -0.5, **kw)}
    return params


def param_count(params: dict) -> int:
    return sum(t.numel() for t in tree_leaves(params))


# ---------------------------------------------------------------------------
# Forward (training)
# ---------------------------------------------------------------------------
def _apply_block(p: dict, x: torch.Tensor, cfg: ModelConfig, kind: str, *,
                 mode: str = "auto") -> torch.Tensor:
    """Full-sequence block application, x [B, L, D] -> x'."""
    _check_supported(cfg, kind, training=True)
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "mlstm":
        return x + R.mlstm_block(p["mix"], h, chunk=cfg.mlstm_chunk,
                                 mode=mode)
    return x + R.slstm_block(p["mix"], h)


def _run_stack(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
               mode: str = "auto") -> torch.Tensor:
    types, n_super, rem = _pattern(cfg)
    for s in range(n_super):
        for j, t in enumerate(types):
            x = _apply_block(_index(params["blocks"][f"slot{j}"], s), x, cfg,
                             t, mode=mode)
    for i in range(rem):
        x = _apply_block(params["rem"][f"layer{i}"], x, cfg,
                         types[i % len(types)], mode=mode)
    return x


def forward(params: dict, batch: dict, cfg: ModelConfig, *,
            mode: str = "auto") -> torch.Tensor:
    """batch {"tokens" [B, S]} -> f32 logits [B, S, vocab]."""
    if cfg.is_encdec or cfg.n_context_tokens:
        raise NotImplementedError(f"the training forward of {cfg.name} "
                                  f"{_PENDING}")
    x = L.embed(params["embed"], batch["tokens"])
    x = _run_stack(params, x, cfg, mode=mode)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.lm_logits(params["embed"], x)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig, *,
            mode: str = "auto") -> torch.Tensor:
    """Mean next-token cross entropy of batch {"tokens", "labels"[, "mask"]}."""
    logits = forward(params, batch, cfg, mode=mode)
    return L.softmax_xent(logits, batch["labels"], batch.get("mask"))


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------
def _init_block_state(cfg: ModelConfig, kind: str, batch: int, kv_len: int,
                      *, lead: tuple, device) -> dict:
    _check_supported(cfg, kind)
    if kind == "mlstm":
        return R.mlstm_init_state(batch, cfg.n_heads, cfg.head_dim,
                                  lead=lead, device=device)
    if kind == "slstm":
        return R.slstm_init_state(batch, cfg.d_model, lead=lead,
                                  device=device)
    cache_len = (min(kv_len, cfg.window) if kind == "local_attn" and cfg.window
                 else kv_len)
    shape = lead + (batch, cfg.n_kv_heads, cache_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=L.BF16, device=device),
            "v": torch.zeros(shape, dtype=L.BF16, device=device)}


def init_decode_state(cfg: ModelConfig, batch: int, kv_len: int, *,
                      device) -> dict:
    """Zero decode state (bf16 KV caches, f32 recurrent states), stacked per
    slot as the parameters are."""
    types, n_super, rem = _pattern(cfg)
    period = len(types)
    state: dict[str, Any] = {}
    if n_super > 0:
        state["blocks"] = {
            f"slot{j}": _init_block_state(cfg, types[j], batch, kv_len,
                                          lead=(n_super,), device=device)
            for j in range(period)}
    if rem:
        state["rem"] = {
            f"layer{i}": _init_block_state(cfg, types[i % period], batch,
                                           kv_len, lead=(), device=device)
            for i in range(rem)}
    return state


def _cross_attention(p: dict, x: torch.Tensor, ctx: torch.Tensor,
                     cfg: ModelConfig, mode: str) -> torch.Tensor:
    """Queries from x, keys and values from a fixed context (image patches
    or encoder output); non-causal flash attention over the context."""
    q = L.project_heads(x, p["wq"])
    k = L.project_heads(ctx, p["wk"])
    v = L.project_heads(ctx, p["wv"])
    o = kops.flash_attention(q, k, v, causal=False, mode=mode)
    return L.merge_heads(o, p["wo"], x.dtype)


def _apply_block_decode(p: dict, x: torch.Tensor, pos: int, state: dict,
                        cfg: ModelConfig, kind: str, *,
                        cross_ctx: torch.Tensor | None = None,
                        mode: str = "auto") -> torch.Tensor:
    """One token through one block: x [B, 1, D] -> x'.  Writes this
    position's keys and values into `state`'s caches, or the block's new
    recurrent state into `state`, in place."""
    _check_supported(cfg, kind)
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind in _RECURRENT:
        step = R.mlstm_step if kind == "mlstm" else R.slstm_step
        y, new = step(p["mix"], h, state)
        for k, t in new.items():
            state[k].copy_(t)
        return x + y
    cache_len = state["k"].shape[2]
    slot = pos % cache_len              # ring buffer (= pos at full length)
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                           device=x.device)
    q = L.rope(L.project_heads(h, p["attn"]["wq"]), positions, cfg.rope_theta)
    k = L.rope(L.project_heads(h, p["attn"]["wk"]), positions, cfg.rope_theta)
    v = L.project_heads(h, p["attn"]["wv"])
    state["k"][:, :, slot] = k[:, :, 0].to(state["k"].dtype)
    state["v"][:, :, slot] = v[:, :, 0].to(state["v"].dtype)
    o = L.decode_attention(q, state["k"], state["v"], min(pos, cache_len - 1))
    x = x + L.merge_heads(o, p["attn"]["wo"], x.dtype)
    if "xattn" in p and cross_ctx is not None:
        hx = L.rms_norm(x, p["lnx"], cfg.norm_eps)
        x = x + _cross_attention(p["xattn"], hx, cross_ctx, cfg, mode)
    if "mlp" in p:
        x = x + L.mlp(p["mlp"], L.rms_norm(x, p["ln2"], cfg.norm_eps))
    return x


def _index(tree: dict, i: int) -> dict:
    """Layer i of a slot's stacked tree (views, no copy)."""
    return {k: _index(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def decode_step(params: dict, state: dict, tokens: torch.Tensor, pos: int,
                cfg: ModelConfig, *, cross_ctx: torch.Tensor | None = None,
                mode: str = "auto") -> tuple[torch.Tensor, dict]:
    """One decode step: tokens [B, 1] at position `pos` -> (logits
    [B, 1, V] f32, new state).  The caller's state is left as it was: the
    caches are copied once and the copy is updated in place."""
    types, n_super, rem = _pattern(cfg)
    period = len(types)
    if (cfg.is_encdec or cfg.n_context_tokens) and cross_ctx is None:
        raise ValueError(f"decoding {cfg.name} needs its context (cross_ctx)")
    new_state = {part: {name: {k: t.clone() for k, t in st.items()}
                        for name, st in slots.items()}
                 for part, slots in state.items()}
    x = L.embed(params["embed"], tokens)
    for s in range(n_super):
        for j, t in enumerate(types):
            st = _index(new_state["blocks"][f"slot{j}"], s)
            x = _apply_block_decode(_index(params["blocks"][f"slot{j}"], s),
                                    x, pos, st, cfg, t, cross_ctx=cross_ctx,
                                    mode=mode)
    for i in range(rem):
        x = _apply_block_decode(params["rem"][f"layer{i}"], x, pos,
                                new_state["rem"][f"layer{i}"], cfg,
                                types[i % period], cross_ctx=cross_ctx,
                                mode=mode)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.lm_logits(params["embed"], x), new_state

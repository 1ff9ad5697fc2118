"""Model assembly: ModelConfig -> parameters, the training forward and
loss, decode state and one decode step.

The port of `repro/models/transformer.py`, in the reference's stacked
layout: layer i of a model with layer period P lives in `blocks/slot{i % P}`
at index i // P of a leading n_super axis (period lcm(pattern,
cross_attn_every), so every slot has one structure), and a Python loop over
n_super takes the place of `lax.scan`.  Every block kind of the reference
is ported, for the full-sequence forward (training) and for decoding:
attention blocks (global, and local through `_windowed_attention`) with a
dense MLP or an MoE (`models.moe`, beside a dense MLP where the config has
a dense residual) and cross-attention sublayers; mLSTM, sLSTM and RG-LRU
blocks; the encoder of encoder-decoder models (non-causal attention blocks
and a final norm, over the frontend's projection of the context) and the
frontend stub that projects the context tokens of the others.  As in the
reference, a decode step takes its context as `cross_ctx` as given: no
encoder runs while serving.

`forward` and `loss_fn` take the reference's `remat` (default True): each
super-layer runs under `torch.utils.checkpoint`, so its activations are
recomputed in the backward, as the reference's `jax.checkpoint` around
`super_layer` recomputes them; the remainder layers and the encoder keep
theirs, as in the reference.  sLSTM blocks keep theirs too: their forward
is a loop over time that launches per step, so recomputing it would double
the step's host-bound part for the little memory it holds.  The
checkpointed regions are the runs of other blocks between them.  The
values are the same either way: routing, the only data-dependent step, is
a deterministic function of the block's input.

Attention reaches the flash kernels (forward, and on the card the backward
kernel through its autograd Function); cross-attention's keys and values
come from a fixed context, recomputed every decode step as in the
reference.  The mLSTM blocks' forward reaches the mLSTM kernels, and their
backward the backward kernel.
"""
from __future__ import annotations

import itertools
import math
from typing import Any

import torch
import torch.utils.checkpoint

from ..configs.base import ModelConfig
from ..core.tree import tree_leaves
from ..kernels import ops as kops
from . import layers as L
from . import moe as M
from . import perf
from . import recurrent as R


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


def _init_block(cfg: ModelConfig, kind: str, *, with_cross: bool,
                lead: tuple, generator: torch.Generator, device) -> dict:
    """One block's parameters, stacked on `lead` leading axes."""
    kw = dict(generator=generator, device=device)
    ones = lambda: L.init_rms(cfg.d_model, device=device).expand(  # noqa: E731
        lead + (cfg.d_model,)).clone()
    if kind in _RECURRENT:
        init = R.init_mlstm if kind == "mlstm" else R.init_slstm
        return {"ln1": ones(), "mix": init(cfg, lead=lead, **kw)}
    if kind == "rglru":
        p: dict[str, Any] = {"ln1": ones(),
                             "mix": R.init_rglru(cfg, lead=lead, **kw)}
    elif kind in _ATTN:
        p = {"ln1": ones(), "attn": L.init_attention(cfg, lead=lead, **kw)}
    else:
        raise ValueError(kind)
    moe = cfg.family == "moe" and kind in _ATTN
    if moe:
        p["ln2"] = ones()
        p["moe"] = M.init_moe(cfg, lead=lead, **kw)
    if cfg.d_ff and (cfg.dense_residual or not moe):
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
    if cfg.is_encdec:
        params["enc"] = {
            "blocks": _init_block(cfg, "attn", with_cross=False,
                                  lead=(cfg.enc_layers,), **kw),
            "final_norm": L.init_rms(cfg.d_model, device=device)}
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
def _moe_sublayer(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x + the MoE of rms_norm(x), plus the dense MLP of the same input
    where the config has a dense residual."""
    h2 = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    mo, _ = M.moe_block(p["moe"], h2, cfg)
    if "mlp" in p:
        mo = mo + L.mlp(p["mlp"], h2)
    return x + mo


def _apply_block(p: dict, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ModelConfig, kind: str, *, causal: bool = True,
                 cross_ctx: torch.Tensor | None = None,
                 mode: str = "auto") -> torch.Tensor:
    """Full-sequence block application, x [B, L, D] -> x'."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "mlstm":
        return x + R.mlstm_block(
            p["mix"], h, chunk=perf.get("mlstm_chunk", cfg.mlstm_chunk),
            mode=mode)
    if kind == "slstm":
        return x + R.slstm_block(p["mix"], h)
    if kind == "rglru":
        x = x + R.rglru_block(p["mix"], h)
    else:
        window = cfg.window if kind == "local_attn" else None
        a, _ = L.attention(p["attn"], h, positions, cfg=cfg, causal=causal,
                           window=window, mode=mode)
        x = x + a
        if "xattn" in p and cross_ctx is not None:
            hx = L.rms_norm(x, p["lnx"], cfg.norm_eps)
            x = x + _cross_attention(p["xattn"], hx, cross_ctx, cfg, mode)
        if "moe" in p:
            return _moe_sublayer(p, x, cfg)
    if "mlp" in p:
        x = x + L.mlp(p["mlp"], L.rms_norm(x, p["ln2"], cfg.norm_eps))
    return x


def _run_stack(params: dict, x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig, *, cross_ctx: torch.Tensor | None = None,
               mode: str = "auto", remat: bool = True) -> torch.Tensor:
    types, n_super, rem = _pattern(cfg)

    def run(x, s, slots, cross_ctx):
        for j in slots:
            x = _apply_block(_index(params["blocks"][f"slot{j}"], s), x,
                             positions, cfg, types[j], cross_ctx=cross_ctx,
                             mode=mode)
            x = perf.constrain(x, "act_spec")
        return x

    # the super-layer's slots in runs, sLSTM or not: the sLSTM runs are
    # not recomputed (see the module docstring).  The reference's
    # remat_policy changes what its checkpoint keeps, not a value: the port
    # recomputes the whole run under every policy (`perf`).
    runs = [list(g) for _, g in itertools.groupby(
        range(len(types)), key=lambda j: types[j] == "slstm")]
    recompute = remat and torch.is_grad_enabled()
    for s in range(n_super):
        for slots in runs:
            if recompute and types[slots[0]] != "slstm":
                # cross_ctx (the encoder's output or the projected context)
                # goes in as an input, so its gradient flows back through
                # the recomputed cross-attention
                x = torch.utils.checkpoint.checkpoint(
                    run, x, s, slots, cross_ctx, use_reentrant=False)
            else:
                x = run(x, s, slots, cross_ctx)
    for i in range(rem):
        x = _apply_block(params["rem"][f"layer{i}"], x, positions, cfg,
                         types[i % len(types)], cross_ctx=cross_ctx,
                         mode=mode)
    return x


def _frontend(params: dict, ctx: torch.Tensor) -> torch.Tensor:
    """The frontend stub: a projection of precomputed patch or frame
    embeddings [B, T, D]."""
    return L.dense(ctx, params["frontend"]["proj"])


def _encode(params: dict, ctx: torch.Tensor, cfg: ModelConfig,
            mode: str) -> torch.Tensor:
    """The encoder of an encoder-decoder model: the frontend, the encoder's
    non-causal attention blocks (not recomputed, as the reference's encoder
    scan has no checkpoint) and its final norm."""
    e = _frontend(params, ctx)
    b, t = e.shape[:2]
    pos = torch.arange(t, dtype=torch.int32, device=e.device).expand(b, t)
    for i in range(cfg.enc_layers):
        e = _apply_block(_index(params["enc"]["blocks"], i), e, pos, cfg,
                         "attn", causal=False, mode=mode)
    return L.rms_norm(e, params["enc"]["final_norm"], cfg.norm_eps)


def forward(params: dict, batch: dict, cfg: ModelConfig, *,
            mode: str = "auto", remat: bool = True) -> torch.Tensor:
    """batch {"tokens" [B, S], and "context" [B, T, D] for a model with
    context tokens or an encoder} -> f32 logits [B, S, vocab]."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = perf.constrain(L.embed(params["embed"], tokens), "act_spec")
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    cross_ctx = None
    if cfg.is_encdec:
        cross_ctx = _encode(params, batch["context"], cfg, mode)
    elif cfg.n_context_tokens:
        cross_ctx = _frontend(params, batch["context"])
    x = _run_stack(params, x, positions, cfg, cross_ctx=cross_ctx, mode=mode,
                   remat=remat)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return L.lm_logits(params["embed"], x)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig, *,
            mode: str = "auto", remat: bool = True) -> torch.Tensor:
    """Mean next-token cross entropy of batch {"tokens", "labels"[, "mask"]}."""
    logits = forward(params, batch, cfg, mode=mode, remat=remat)
    return L.softmax_xent(logits, batch["labels"], batch.get("mask"))


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------
def _init_block_state(cfg: ModelConfig, kind: str, batch: int, kv_len: int,
                      *, lead: tuple, device) -> dict:
    if kind == "mlstm":
        return R.mlstm_init_state(batch, cfg.n_heads, cfg.head_dim,
                                  lead=lead, device=device)
    if kind == "slstm":
        return R.slstm_init_state(batch, cfg.d_model, lead=lead,
                                  device=device)
    if kind == "rglru":
        return R.rglru_init_state(batch, cfg.d_recurrent, lead=lead,
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
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind in _RECURRENT + ("rglru",):
        step = {"mlstm": R.mlstm_step, "slstm": R.slstm_step,
                "rglru": R.rglru_step}[kind]
        y, new = step(p["mix"], h, state)
        for k, t in new.items():
            state[k].copy_(t)
        x = x + y
        if "mlp" in p:
            x = x + L.mlp(p["mlp"], L.rms_norm(x, p["ln2"], cfg.norm_eps))
        return x
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
    if "moe" in p:
        return _moe_sublayer(p, x, cfg)
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

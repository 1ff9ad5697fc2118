"""Chunkwise mLSTM on the GPU: wrapper of csrc/mlstm.cu, forward and
backward under one `torch.autograd.Function`.

Replaces `src/repro/kernels/mlstm.py:mlstm_chunked` (pallas_call at :102);
its gradient, which the reference takes by autodiff of the plain scan, is
the backward kernel.  One CTA owns (batch*head, a tile of TV value columns)
and walks the chunks, keeping C[:, tile] and n in shared memory; the TPU
kernel's whole [Dh, Dh] state does not fit one CTA at Dh 256.  The forward
saves each chunk's entry state (C [B*H, NC, Dh, Dh], n [B*H, NC, Dh]) only
when a gradient will be taken; the backward walks the chunks in reverse
from those states, writes dq/dk/dlogi/dlogf per tile and sums the tiles in
a fixed order.  What bounds it is the f32 operations on the CUDA cores.
See the source for the design notes.

On CPU tensors `mlstm_chunked` runs the plain version (`kernels/ref.py`,
gradient by autograd); on CUDA tensors it launches the kernels or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build, ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRIES = {"launch_fwd": [_P] * 8 + [_I] * 4 + [_P],
            "launch_bwd": [_P] * 18 + [_I] * 4 + [_P]}
SMEM_LIMIT = 227 * 1024        # dynamic shared memory a CTA may take (H100)
TILES = (64, 32, 16)           # value-column tiles, widest first
_NT, _DS = 256, 16             # threads per CTA, Dh slice (csrc/mlstm.cu)

plain = ref.mlstm_chunked


@functools.lru_cache(maxsize=32)
def source(w: int, tv: int) -> str:
    """CUDA source for chunk length w and value tile tv."""
    return build.template("mlstm").replace(
        "//@GENERATED@", f"#define W {w}\n#define TV {tv}")


def smem_bytes(bwd: bool, w: int, tv: int, dh: int) -> int:
    """Dynamic shared memory of one CTA: the floats laid out at the top of
    `mlstm_bwd` (bwd) or `mlstm_fwd` in csrc/mlstm.cu.  The launchers
    take this size as an argument; the source keeps no copy of it."""
    qs, aw, tvp = _DS + 1, w + 1, tv + 1
    if bwd:
        n = (2 * dh * tvp + 2 * dh + 2 * w * tvp + 2 * w * aw + 3 * w * qs
             + 15 * w + _NT + 16 * w + 4)
    else:
        n = dh * tvp + dh + w * tvp + w * aw + 2 * w * qs + 8 * w + 4
    return 4 * n


def tiling(w: int, dh: int) -> int:
    """The widest value tile that both kernels fit in shared memory and
    that Dh (rounded up to 16) fills.  The forward takes the backward's
    tile even under no_grad, where a wider one might fit, so that one
    build per chunk length serves a training step."""
    if w % 16 or not 16 <= w <= 128:
        raise ValueError(f"mlstm: chunk length {w}; a multiple of 16 in "
                         "[16, 128]")
    for tv in TILES:
        if (tv <= -(-dh // 16) * 16 or tv == TILES[-1]) and \
                smem_bytes(True, w, tv, dh) <= SMEM_LIMIT:
            return tv
    raise ValueError(f"mlstm: Dh {dh} at chunk {w} does not fit shared memory")


def _prepare(q, k, v, logi, logf, chunk: int):
    b, h, l, dh = q.shape
    w = min(chunk, l)
    if l % w:
        raise ValueError(f"mlstm: L {l} is not a multiple of chunk {w}")
    args = [t.float().contiguous() for t in (q, k, v, logi, logf)]
    check = functools.partial(build.check_arg, "mlstm")
    for name, t in zip(("q", "k", "v"), args[:3]):
        check(t, torch.float32, (b, h, l, dh), name)
    for name, t in zip(("logi", "logf"), args[3:]):
        check(t, torch.float32, (b, h, l), name)
    tv = tiling(w, dh)
    return args, (b, h, l, dh, w, tv), build.load_entries(
        "mlstm", source(w, tv), _ENTRIES)


def forward(q, k, v, logi, logf, *, chunk: int, states: bool):
    """Launch the forward kernel: (out [B, H, L, Dh] f32, C states, n
    states); the states (each chunk's entry state) only when asked."""
    (q, k, v, logi, logf), (b, h, l, dh, w, tv), lib = _prepare(
        q, k, v, logi, logf, chunk)
    out = torch.empty_like(q)
    c_st = n_st = None
    if states:
        c_st = torch.empty((b * h, l // w, dh, dh), device=q.device)
        n_st = torch.empty((b * h, l // w, dh), device=q.device)
    nullp = ctypes.c_void_p(None)
    err = lib.launch_fwd(*map(build.ptr, (q, k, v, logi, logf, out)),
                         build.ptr(c_st) if states else nullp,
                         build.ptr(n_st) if states else nullp,
                         b * h, l, dh, smem_bytes(False, w, tv, dh),
                         build.stream())
    build.check(err, "mlstm_fwd")
    forward.launches += 1
    return out, c_st, n_st


def backward(q, k, v, logi, logf, out, dout, c_st, n_st, *, chunk: int):
    """Launch the backward kernel and then `mlstm_sum_tiles` four times (the
    fixed-order sum over the value tiles of dq, dk, dlogi, dlogf); counted
    as one `mlstm_bwd` launch.  Returns (dq, dk, dv [B, H, L, Dh], dlogi,
    dlogf [B, H, L])."""
    (q, k, v, logi, logf), (b, h, l, dh, w, tv), lib = _prepare(
        q, k, v, logi, logf, chunk)
    out, dout = out.contiguous(), dout.float().contiguous()
    check = functools.partial(build.check_arg, "mlstm")
    check(dout, torch.float32, (b, h, l, dh), "dout")
    check(c_st, torch.float32, (b * h, l // w, dh, dh), "C states")
    check(n_st, torch.float32, (b * h, l // w, dh), "n states")
    nt = -(-dh // tv)
    dq_p, dk_p = (torch.empty((nt,) + q.shape, device=q.device)
                  for _ in range(2))
    dli_p, dlf_p = (torch.empty((nt,) + logi.shape, device=q.device)
                    for _ in range(2))
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dlogi, dlogf = torch.empty_like(logi), torch.empty_like(logf)
    err = lib.launch_bwd(*map(build.ptr, (
        q, k, v, logi, logf, out, dout, c_st, n_st, dq_p, dk_p, dli_p, dlf_p,
        dq, dk, dv, dlogi, dlogf)), b * h, l, dh, smem_bytes(True, w, tv, dh),
        build.stream())
    build.check(err, "mlstm_bwd")
    backward.launches += 1
    return dq, dk, dv, dlogi, dlogf


forward.launches = 0
backward.launches = 0


class _MlstmChunked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, logi, logf, chunk):
        out, c_st, n_st = forward(q, k, v, logi, logf, chunk=chunk,
                                  states=True)
        ctx.save_for_backward(q, k, v, logi, logf, out, c_st, n_st)
        ctx.chunk = chunk
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, logi, logf, out, c_st, n_st = ctx.saved_tensors
        grads = backward(q, k, v, logi, logf, out, dout, c_st, n_st,
                         chunk=ctx.chunk)
        return (*(g.to(x.dtype) for g, x in zip(grads, ctx.saved_tensors)),
                None)


def mlstm_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  logi: torch.Tensor, logf: torch.Tensor, *,
                  chunk: int = 128) -> torch.Tensor:
    """Arguments and result as `kernels.ref.mlstm_chunked`.  The chunk-entry
    states are written only when autograd will need them (grad mode on and
    an input that requires grad)."""
    if q.device.type != "cuda":
        return plain(q, k, v, logi, logf, chunk=chunk)
    args = (q, k, v, logi, logf)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _MlstmChunked.apply(*args, chunk)
    return forward(*args, chunk=chunk, states=False)[0]

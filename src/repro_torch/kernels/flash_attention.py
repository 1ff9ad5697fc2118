"""GQA flash attention on the GPU: wrapper of csrc/flash_attention.cu.

Replaces `src/repro/kernels/flash_attention.py:flash_attention`
(pallas_call at :121).  One CTA per (batch, KV head, query tile) walks the
KV tiles with an online f32 softmax; the `group` query heads of a KV head
share each K/V tile through shared memory, and a decode step (Lq = 1) takes
a CTA of `group` rows whose warps split the keys.  At the serve shape
memory bounds it (the K and V bytes); at prefill shapes the tensor-core
operations do, which this first kernel leaves on the CUDA cores.  See the
source for the design notes.

On CPU tensors the wrapper runs the plain version (`kernels/ref.py`); on
CUDA tensors it launches the kernel or raises.  Inputs that are not
contiguous (an einsum's permuted output) are copied first.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build, ref

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float]
             + [ctypes.c_int] * 6 + [ctypes.c_void_p])
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 227 * 1024        # dynamic shared memory a CTA may take (H100)
WARPS = 8                      # warps per CTA: row quads x key splits

plain = ref.flash_attention


@functools.lru_cache(maxsize=1)
def source() -> str:
    return build.template("flash_attention")


def tiling(group: int, lq: int, dh: int, elem: int) -> tuple[int, int, int]:
    """(tq, n_rq, ks): query positions per CTA, row quads, key splits.  A
    CTA holds group * tq <= 32 rows (at least one position per head) in
    row quads of four; the warps left over split every KV tile's keys, as
    many as the shared memory allows."""
    tq = max(1, min(lq, 32 // group))
    n_rq = -(-group * tq // 4)
    ks = max(1, WARPS // n_rq)
    while ks > 1 and smem_bytes(n_rq * 4, ks, dh, elem) > SMEM_LIMIT:
        ks //= 2
    return tq, n_rq, ks


def smem_bytes(rows: int, ks: int, dh: int, elem: int) -> int:
    """Shared memory of one CTA, in the kernel's layout: the scaled f32
    query rows, the K and V tiles of 32*ks rows padded to `tile_stride`
    (dh + 4 / elem elements), the f32 merge area of ks partial states."""
    return (rows * dh * 4 + 2 * 32 * ks * (dh + 4 // elem) * elem
            + ks * rows * (dh + 2) * 4)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    kv_offset: int = 0) -> torch.Tensor:
    """Arguments and result as `kernels.ref.flash_attention`."""
    if q.device.type != "cuda":
        return plain(q, k, v, causal=causal, scale=scale, kv_offset=kv_offset)
    b, hq, lq, dh = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_attention: dtype {q.dtype}; bf16 or f32")
    if hq % hkv or dh % 8 or dh > 128:
        raise ValueError(f"flash_attention: Hq {hq}, Hkv {hkv}, Dh {dh}: "
                         "Hq a multiple of Hkv, Dh a multiple of 8 <= 128")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    check = functools.partial(build.check_arg, "flash_attention")
    check(q, q.dtype, (b, hq, lq, dh), "q")
    check(k, q.dtype, (b, hkv, lk, dh), "k")
    check(v, q.dtype, (b, hkv, lk, dh), "v")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte aligned")
    out = torch.empty_like(q)
    tq, n_rq, ks = tiling(hq // hkv, lq, dh, q.element_size())
    lib = build.load("flash_attention", source(), _ARGTYPES)
    err = lib.launch(build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out),
                     _DTYPE_CODE[q.dtype], b, hq, hkv, lq, lk, dh,
                     dh ** -0.5 if scale is None else scale, int(causal),
                     kv_offset, tq, n_rq, ks,
                     smem_bytes(n_rq * 4, ks, dh, q.element_size()),
                     build.stream())
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

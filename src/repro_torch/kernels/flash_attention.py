"""GQA flash attention on the GPU: wrapper of csrc/flash_attention.cu.

Replaces `src/repro/kernels/flash_attention.py:flash_attention`
(pallas_call at :121).  `plan` picks one of four bodies by shape alone
(Rg = group x Lq, the query rows of one (batch, KV head)):

- "decode": bf16, Dh a multiple of 16, Rg <= 16 (the serve step: Lq 1 at
  group 4).  An mma.sync kernel whose warps each take 16 keys of a 64-key
  tile (the TMA unit fills a 2-stage ring, both stages in flight), with
  the keys cut into splits so that the grid has at least 2 x 132 CTAs
  where the keys allow; the last CTA of a row tile merges the splits'
  partial states in split order.  Bound: bytes.
- "tensor_core": bf16, Dh a multiple of 16 to 128, Rg > 16 (prefill).
  One warpgroup of 128 threads owns 64 rows; S = Q K^T and O += P V run
  as wgmma over a 3-stage ring of 64-key K/V tiles that the TMA unit
  fills; the keys are split only where the row tiles leave SMs without a
  CTA.  Bound: operations.
- "tensor_core_wide": bf16, Dh a multiple of 16 in (128, 256], Rg > 16
  (recurrentgemma's Dh 256): the same kernel built with two warpgroups
  that share 64 rows, each holding half of O's columns (one warpgroup
  would need 2 x Dh / 2 f32 a thread for O and a tile's P V); S's two
  halves meet in shared memory; a 2-stage TMA ring.  Bound: operations.
- "cuda_core": f32, Dh not a multiple of 16, and bf16 above Dh 128 at
  Rg <= 16: the CUDA-core kernel over row tiles of up to 16 rows, its keys
  split the same way.

The kernel reads q, k and v through their (batch, head, position) strides
and needs unit stride only on Dh: the wrapper copies an input only when its
last stride is not 1 or its rows are not 16-byte aligned.  `launches`,
`copies` (inputs copied) and `bodies` (launches by body) count.  On CPU
tensors the wrapper runs the plain version (`kernels/ref.py`); on CUDA
tensors it launches the kernel or raises.  See the source for the design
notes.

The gradient: `flash_attention_lse` also returns each row's log-sum-exp
(every body writes it into a buffer the wrapper passes), and
`flash_attention_bwd` wraps csrc/flash_attention_bwd.cu (a dQ kernel, then
a dK/dV kernel, both wgmma on TMA-fed tiles; `bwd_plan` lays out both),
which reads it.  On CUDA tensors that require grad `flash_attention` runs
forward and backward through `_Flash`, a `torch.autograd.Function` that
saves the log-sum-exp.  On CPU tensors all are the plain versions, and
autograd differentiates the plain forward.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import struct
from typing import NamedTuple

import torch

from . import build, ref

_ARGTYPES = [ctypes.c_char_p, ctypes.c_void_p]     # packed Args, stream
# csrc/flash_attention.cu:Args: 7 pointers, 9 strides, B Hq Hkv Lq Lk,
# scale, causal kv_offset hc tq head_tiles pos_tiles kv_end split_keys
# n_splits smem dtype body
_PTRS = struct.Struct("<7Q")             # q, k, v, out, part, count, lse
_TAIL = struct.Struct("<9q5if12i")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_BODY_CODE = {"cuda_core": 0, "tensor_core": 1, "decode": 2,
              "tensor_core_wide": 3}
SMEM_LIMIT = 227 * 1024        # dynamic shared memory a CTA may take (H100)
SMS = 132                      # streaming multiprocessors (H100 SXM)
THREADS = 128                  # one warpgroup: every body but the wide one
WIDE_THREADS = 256             # the wide body: two warpgroups
STAGES, DEC_STAGES = 3, 2      # K/V ring stages; the decode body's
WIDE_STAGES = 2                # the wide body's
SIMT_ROWS, SIMT_BK = 16, 32    # CUDA-core body: rows per CTA, keys per tile
TC_ROWS, TC_BN = 64, 64        # mma bodies: rows per CTA (decode 16), keys
                               # per tile
DECODE_ROWS = 16               # group x Lq at or below which "decode" runs
TC_MAX_DH = 128                # tensor_core's and decode's largest Dh
MAX_DH = 256                   # the largest head dimension any body takes
# two warpgroups' exchange of an m64n64 f32 accumulator each (the wide
# body's S halves, the backward's P and dP): [2][32][128 threads] f32
XCHG = 2 * 32 * 128 * 4
# csrc/flash_attention_bwd.cu: threads (two warpgroups), TMA ring stages,
# rows of a wgmma tile (query rows, keys; the ring's tiles); above
# BWD_SPLIT_DH both warpgroups share 64 rows on column halves (a CTA owns
# 64 rows and uses the 32 KB exchange), at or below it each owns 64 (128)
BWD_THREADS, BWD_STAGES, BWD_BLK = 256, 2, 64
BWD_SPLIT_DH = 128

plain = ref.flash_attention


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def source(dh: int) -> str:
    """The kernel source specialised to head dimension `dh`."""
    return f"#define DH {dh}\n" + build.template("flash_attention")


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call runs.  A CTA owns `heads` query heads of one KV group
    times `positions` query positions; head tile ht and position tile pt
    hold heads ht*heads + r // positions and positions pt*positions +
    r % positions of row r.  `splits` cut the keys [0, kv_end) that any
    row can see; `key_range` is the part of one split that the CTAs of one
    position tile visit (the kernel's `key_range`)."""
    body: str
    heads: int
    positions: int
    head_tiles: int
    pos_tiles: int
    block_k: int
    stages: int
    kv_end: int
    split_keys: int
    splits: tuple
    grid: tuple
    threads: int
    smem: int
    copy: tuple
    lq: int
    causal: bool
    kv_offset: int

    @property
    def rows(self) -> int:
        return self.heads * self.positions

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    def key_range(self, pos_tile: int, split: int) -> tuple[int, int]:
        last_pos = min(self.lq - 1, pos_tile * self.positions
                       + self.positions - 1)
        lo, hi = self.splits[split]
        if self.causal:
            hi = min(hi, last_pos + self.kv_offset + 1)
        return lo, max(lo, hi)


def readable(shape, stride, elem: int) -> bool:
    """Whether the kernel reads a [B, H, L, Dh] tensor in place: unit
    stride on Dh and 16-byte aligned rows (a dimension of size 1 has no
    stride to check)."""
    return stride[3] == 1 and all(s * elem % 16 == 0 or n == 1
                                  for n, s in zip(shape[:3], stride[:3]))


def plan(q_shape, k_shape, dtype, *, causal: bool, kv_offset: int = 0,
         strides=None) -> Plan:
    """The body, CTA shape, key splits, grid and shared memory of one call
    with q [B, Hq, Lq, Dh] and k/v [B, Hkv, Lk, Dh] of `dtype`; `strides`
    (q's, k's, v's, in elements; contiguous when None) decide which inputs
    the wrapper copies first.  The shape picks the body."""
    group, dh = q_shape[1] // k_shape[1], q_shape[3]
    rows = group * q_shape[2]
    if dtype != torch.bfloat16 or dh % 16 or (dh > TC_MAX_DH
                                              and rows <= DECODE_ROWS):
        body = "cuda_core"
    elif dh > TC_MAX_DH:
        body = "tensor_core_wide"
    else:
        body = "decode" if rows <= DECODE_ROWS else "tensor_core"
    return _layout(body, q_shape, k_shape, dtype, causal=causal,
                   kv_offset=kv_offset, strides=strides)


def _layout(body: str, q_shape, k_shape, dtype, *, causal: bool,
            kv_offset: int, strides) -> Plan:
    """`plan` for a given body, which the shape must allow."""
    b, hq, lq, dh = q_shape
    hkv, lk = k_shape[1], k_shape[2]
    group = hq // hkv
    elem = dtype.itemsize
    kv_end = max(0, min(lk, lq + kv_offset)) if causal else lk
    if body != "cuda_core":
        dhp = _cdiv(dh, 64) * 64    # rows padded to 64-column swizzle blocks
        if body == "decode":
            cap, stages = DECODE_ROWS, DEC_STAGES
            # the K/V ring, Q and the ring's mbarriers
            smem = (DEC_STAGES * 2 * TC_BN + DECODE_ROWS) * dhp * 2 \
                + 8 * DEC_STAGES
        elif body == "tensor_core_wide":
            cap, stages = TC_ROWS, WIDE_STAGES
            # Q, the K/V ring, the exchange of S halves and the mbarriers
            smem = (1 + 2 * WIDE_STAGES) * TC_BN * dhp * 2 + XCHG \
                + 8 * WIDE_STAGES
        else:
            cap, stages = TC_ROWS, STAGES
            # Q, the K/V ring and its mbarriers
            smem = (1 + 2 * STAGES) * TC_BN * dhp * 2 + 8 * STAGES
        bk, per_sm = TC_BN, 2
    else:
        cap, bk, per_sm, stages = SIMT_ROWS, SIMT_BK, 4, STAGES
    hc = min(group, cap)
    tq = max(1, min(lq, cap // hc))
    head_tiles, pos_tiles = _cdiv(group, hc), _cdiv(lq, tq)
    if body == "cuda_core":
        smem = hc * tq * dh * 4 + STAGES * 2 * bk * (dh * elem + 16)
    # split the keys only where the row tiles leave SMs without a CTA, into
    # enough splits for 2 x 132 CTAs (4 x 132 on the CUDA cores, whose
    # CTAs are lighter), each a whole number of key tiles
    tiles = b * hkv * head_tiles * pos_tiles
    want = 1 if tiles >= SMS else min(_cdiv(per_sm * SMS, tiles),
                                      max(1, _cdiv(kv_end, bk)))
    split_keys = max(bk, _cdiv(_cdiv(kv_end, want), bk) * bk)
    n_splits = max(1, _cdiv(kv_end, split_keys))
    splits = tuple((s * split_keys, min((s + 1) * split_keys, kv_end))
                   for s in range(n_splits))
    if strides is None:
        copy = (False, False, False)
    else:
        copy = tuple(not readable(shape, st, elem) for shape, st in
                     zip((q_shape, k_shape, k_shape), strides))
    return Plan(body=body, heads=hc, positions=tq, head_tiles=head_tiles,
                pos_tiles=pos_tiles, block_k=bk, stages=stages,
                kv_end=kv_end, split_keys=split_keys, splits=splits,
                grid=(pos_tiles * head_tiles * n_splits, hkv, b),
                threads=WIDE_THREADS if body == "tensor_core_wide"
                else THREADS, smem=smem, copy=copy, lq=lq,
                causal=bool(causal), kv_offset=kv_offset)


# the split merge's arrival counters, zeroed once and reset by the merging
# CTA, one buffer per (device, stream): the launches of one stream use it
# in turn, and launches on two streams never share one
_counters: dict[tuple, torch.Tensor] = {}


def _counter(device, stream: int, n: int) -> torch.Tensor:
    key = (device, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = _counters[key] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                           device=device)
    return buf


def _stream(device) -> int:
    """The current CUDA stream of `device`, by the raw query where this
    torch build has it (it skips building a Stream object)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(device.index)
    return torch.cuda.current_stream(device).cuda_stream


class _Call(NamedTuple):
    """What every call of one signature shares: the plan, the packed
    arguments after the six pointers, and the library's entry."""
    plan: Plan
    tail: bytes
    copy: tuple          # inputs to copy first (the plan's, or unaligned)
    launch: object


def _make_call(p: Plan, shapes, strides, dtype, aligned, causal: bool,
               scale: float | None, kv_offset: int, launch) -> _Call:
    """The launch record of plan `p` for library entry `launch`."""
    (b, hq, lq, dh), (_, hkv, lk, _), _ = shapes
    copy = tuple(c or not a for c, a in zip(p.copy, aligned))
    # a copied input is contiguous
    st = [(sh[1] * sh[2] * sh[3], sh[2] * sh[3], sh[3], 1) if c else tuple(s)
          for sh, s, c in zip(shapes, strides, copy)]
    tail = _TAIL.pack(
        *st[0][:3], *st[1][:3], *st[2][:3], b, hq, hkv, lq, lk,
        dh ** -0.5 if scale is None else scale, int(causal), kv_offset,
        p.heads, p.positions, p.head_tiles, p.pos_tiles, p.kv_end,
        p.split_keys, len(p.splits), p.smem, _DTYPE_CODE[dtype],
        _BODY_CODE[p.body])
    return _Call(p, tail, copy, launch)


@functools.lru_cache(maxsize=256)
def _prepare(shapes, dtypes, on_cuda, strides, aligned, causal: bool,
             kv_offset: int, scale) -> _Call:
    """Check one call signature and plan it (raises on what the kernel
    does not take)."""
    (b, hq, lq, dh), k_shape, v_shape = shapes
    hkv, lk = k_shape[1], k_shape[2]
    if dtypes[0] not in _DTYPE_CODE:
        raise ValueError(f"flash_attention: dtype {dtypes[0]}; bf16 or f32")
    if hq % hkv or dh % 8 or dh > MAX_DH:
        raise ValueError(f"flash_attention: Hq {hq}, Hkv {hkv}, Dh {dh}: "
                         f"Hq a multiple of Hkv, Dh a multiple of 8 <= "
                         f"{MAX_DH}")
    for name, shape, dt, cuda in zip("kv", shapes[1:], dtypes[1:],
                                     on_cuda):
        if not cuda or dt != dtypes[0] or tuple(shape) != (b, hkv, lk, dh):
            raise ValueError(f"flash_attention: {name} must be a CUDA "
                             f"{dtypes[0]} tensor of shape "
                             f"{(b, hkv, lk, dh)}, got {dt} {tuple(shape)}"
                             f"{'' if cuda else ' off the card'}")
    p = plan(shapes[0], k_shape, dtypes[0], causal=causal,
             kv_offset=kv_offset, strides=strides)
    lib = build.load("flash_attention", source(shapes[0][3]), _ARGTYPES)
    return _make_call(p, shapes, strides, dtypes[0], aligned, causal, scale,
                      kv_offset, lib.launch)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    kv_offset: int = 0) -> torch.Tensor:
    """Arguments and result as `kernels.ref.flash_attention`; on CUDA
    tensors that require grad, differentiable through the backward
    kernel."""
    if not q.is_cuda:
        return plain(q, k, v, causal=causal, scale=scale, kv_offset=kv_offset)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Flash.apply(q, k, v, bool(causal), scale, kv_offset)
    return _forward(q, k, v, bool(causal), scale, kv_offset, False)[0]


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, scale: float | None = None,
                        kv_offset: int = 0):
    """(out, lse): `flash_attention`'s output and each row's log-sum-exp,
    f32 [B, Hq, Lq] in units of log2 of S * scale, +inf for a row that
    sees no key (`kernels.ref.flash_lse`).  Not differentiable."""
    if not q.is_cuda:
        return (plain(q, k, v, causal=causal, scale=scale,
                      kv_offset=kv_offset),
                ref.flash_lse(q, k, causal=causal, scale=scale,
                              kv_offset=kv_offset))
    return _forward(q, k, v, bool(causal), scale, kv_offset, True)


def _forward(q, k, v, causal: bool, scale, kv_offset: int, with_lse: bool):
    call = _prepare((q.shape, k.shape, v.shape), (q.dtype, k.dtype, v.dtype),
                    (k.is_cuda, v.is_cuda),
                    (q.stride(), k.stride(), v.stride()),
                    (q.data_ptr() % 16 == 0, k.data_ptr() % 16 == 0,
                     v.data_ptr() % 16 == 0), causal, kv_offset, scale)
    return _run(q, k, v, call, with_lse)


def _run(q, k, v, call: _Call, with_lse: bool):
    """(out, lse or None) of one launch."""
    p = call.plan
    if any(call.copy):
        q, k, v = (t.clone(memory_format=torch.contiguous_format) if c else t
                   for t, c in zip((q, k, v), call.copy))
        flash_attention.copies += sum(call.copy)
    dev = q.device
    stream = _stream(dev)
    out = torch.empty(q.shape, dtype=q.dtype, device=dev)
    lse = (torch.empty(q.shape[:3], dtype=torch.float32, device=dev)
           if with_lse else None)
    part = count = None
    if len(p.splits) > 1:
        # the splits' partial states, per call: the caching allocator hands
        # the block to the next call on this stream only after this one
        b, hkv, dh = q.shape[0], k.shape[1], q.shape[3]
        n_tiles = b * hkv * p.head_tiles * p.pos_tiles
        part = torch.empty(n_tiles * len(p.splits) * p.rows * (dh + 2),
                           dtype=torch.float32, device=dev)
        count = _counter(dev, stream, n_tiles)
    args = _PTRS.pack(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), 0 if part is None else part.data_ptr(),
                      0 if count is None else count.data_ptr(),
                      0 if lse is None else lse.data_ptr()) + call.tail
    build.check(call.launch(args, stream), "flash_attention")
    flash_attention.launches += 1
    flash_attention.bodies[p.body] += 1
    return out, lse


flash_attention.launches = 0
flash_attention.copies = 0           # inputs copied before a launch
flash_attention.bodies = collections.Counter()   # launches by plan body


class _Flash(torch.autograd.Function):
    """The forward kernel, which also writes the log-sum-exp, and the
    gradient through the backward kernel, which reads it."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, kv_offset):
        out, lse = _forward(q, k, v, causal, scale, kv_offset, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, kv_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale, kv_offset = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse=lse,
                                         causal=causal, scale=scale,
                                         kv_offset=kv_offset)
        return dq, dk, dv, None, None, None


# ------------------------------------------------------------- backward
@functools.lru_cache(maxsize=None)
def bwd_source(dh: int) -> str:
    """The backward kernels' source specialised to head dimension `dh`."""
    return f"#define DH {dh}\n" + build.template("flash_attention_bwd")


# csrc/flash_attention_bwd.cu:Args: 11 pointers, 15 strides, B Hq Hkv Lq
# Lk Lq_pad causal kv_offset smem_dq smem_dkv, scale (and 4 bytes of
# padding to the struct's 8-byte alignment)
_BWD_PTRS = struct.Struct("<11Q")
_BWD_TAIL = struct.Struct("<15q10if4x")


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """How one backward call runs.  Both kernels run `BWD_THREADS` threads,
    two warpgroups over 64-row wgmma tiles.  At `split` (Dh above
    BWD_SPLIT_DH) both warpgroups own the same 64 rows and each half of the
    output columns; else each owns 64 rows of its own.  dQ CTAs own `rows`
    query rows of one head and walk key tiles of BWD_BLK; dK/dV CTAs own
    `rows` keys of one KV head and walk the group's heads and query tiles
    of BWD_BLK.  The log-sum-exp and D scratch is [B, Hq, lq_pad]."""
    dh: int
    lq: int
    lk: int
    causal: bool
    kv_offset: int
    split: bool
    rows: int
    lq_pad: int
    grid_dq: tuple
    grid_dkv: tuple
    smem_dq: int
    smem_dkv: int
    copy: tuple          # q, k, v, out, dout copied first

    def dq_keys(self, qt: int) -> tuple[int, int]:
        """The keys [0, hi) that dQ CTA row tile `qt` walks, in tiles of
        BWD_BLK (the last may run past Lk; past keys are masked)."""
        last = min(self.lq, (qt + 1) * self.rows) - 1
        hi = self.lk
        if self.causal:
            hi = max(0, min(hi, last + self.kv_offset + 1))
        return 0, _cdiv(hi, BWD_BLK) * BWD_BLK

    def dkv_queries(self, kt: int) -> tuple[int, int]:
        """The query rows [lo, hi) that dK/dV CTA key tile `kt` walks for
        each head of its group, in tiles of BWD_BLK."""
        first = max(0, kt * self.rows - self.kv_offset) if self.causal else 0
        lo = first // BWD_BLK * BWD_BLK
        if first >= self.lq:
            return lo, lo
        return lo, _cdiv(self.lq, BWD_BLK) * BWD_BLK


def bwd_plan(q_shape, k_shape, *, causal: bool, kv_offset: int = 0,
             strides=None, aligned=(True,) * 5) -> BwdPlan:
    """The backward's grids, shared memory and walks for q [B, Hq, Lq, Dh]
    and k/v [B, Hkv, Lk, Dh] in bf16; `strides` (q's, k's, v's, out's,
    dout's; contiguous when None) and `aligned` (their data pointers on 16
    bytes) decide which inputs the wrapper copies first."""
    b, hq, lq, dh = q_shape
    hkv, lk = k_shape[1], k_shape[2]
    split = dh > BWD_SPLIT_DH
    rows = BWD_BLK if split else 2 * BWD_BLK
    lq_pad = _cdiv(lq, rows) * rows
    tile = BWD_BLK * _cdiv(dh, 64) * 64 * 2     # bytes of a 64-row tile
    xchg = XCHG if split else 0
    blocks = rows // BWD_BLK
    bars = (BWD_STAGES + 1) * 8
    # Q and dO of the CTA, the K/V ring, exchange, lse and D, mbarriers
    smem_dq = 2 * blocks * tile + BWD_STAGES * 2 * tile + xchg \
        + 2 * rows * 4 + bars
    # K and V of the CTA, the Q/dO ring, exchange, the ring's lse and D
    smem_dkv = 2 * blocks * tile + BWD_STAGES * 2 * tile + xchg \
        + BWD_STAGES * 2 * BWD_BLK * 4 + bars
    shapes = (q_shape, k_shape, k_shape, q_shape, q_shape)
    copy = tuple(not a if strides is None else
                 not (a and readable(sh, st, 2))
                 for sh, st, a in zip(shapes, strides or shapes, aligned))
    return BwdPlan(dh=dh, lq=lq, lk=lk, causal=bool(causal),
                   kv_offset=kv_offset, split=split, rows=rows,
                   lq_pad=lq_pad, grid_dq=(lq_pad // rows, hq, b),
                   grid_dkv=(_cdiv(lk, rows), hkv, b),
                   smem_dq=smem_dq, smem_dkv=smem_dkv, copy=copy)


def bwd_library(dh: int):
    """The backward library built for head dimension `dh`."""
    return build.load_entries("flash_attention_bwd", bwd_source(dh), {
        "launch": _ARGTYPES, "layout": [ctypes.c_void_p]})


def bwd_layout(dh: int) -> dict:
    """What the built library lays out (its `layout` entry)."""
    buf = (ctypes.c_int * 7)()
    bwd_library(dh).layout(ctypes.cast(buf, ctypes.c_void_p))
    keys = ("smem_dq", "smem_dkv", "rows", "blk", "stages", "threads",
            "split")
    return dict(zip(keys, buf))


def flash_attention_bwd(q, k, v, out, dout, *, lse=None, causal: bool = True,
                        scale: float | None = None, kv_offset: int = 0):
    """(dq, dk, dv) of `flash_attention(q, k, v)` = out at cotangent
    `dout`, as `kernels.ref.flash_attention_backward`.  On CUDA tensors:
    bf16, Dh a multiple of 16 to 256, and `lse` the forward's log-sum-exp
    (`flash_attention_lse`, f32 [B, Hq, Lq]); inputs read through their
    strides (copied only where a row is not 16-byte aligned or Dh not unit
    stride, counted in `copies`).  On CPU tensors the plain backward, which
    needs no lse."""
    if not q.is_cuda:
        return ref.flash_attention_backward(q, k, v, out, dout, causal=causal,
                                            scale=scale, kv_offset=kv_offset)
    b, hq, lq, dh = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    ins = (q, k, v, out, dout)
    want = ((b, hq, lq, dh), (b, hkv, lk, dh), (b, hkv, lk, dh),
            (b, hq, lq, dh), (b, hq, lq, dh))
    if hq % hkv or dh % 16 or dh > MAX_DH or any(
            not t.is_cuda or t.dtype != torch.bfloat16 or tuple(t.shape) != w
            for t, w in zip(ins, want)) or lse is None or not lse.is_cuda \
            or lse.dtype != torch.float32 or tuple(lse.shape) != (b, hq, lq) \
            or not lse.is_contiguous():
        raise ValueError(
            "flash_attention_bwd: q/out/dout [B, Hq, Lq, Dh] and k/v "
            "[B, Hkv, Lk, Dh], CUDA bf16, Hq a multiple of Hkv, Dh a "
            f"multiple of 16 to {MAX_DH}, lse contiguous CUDA f32 [B, Hq, "
            "Lq]; got " + ", ".join(f"{t.device} {t.dtype} {tuple(t.shape)}"
                                    for t in ins) + f", lse "
            + ("None" if lse is None else
               f"{lse.device} {lse.dtype} {tuple(lse.shape)}"))
    p = bwd_plan(q.shape, k.shape, causal=causal, kv_offset=kv_offset,
                 strides=tuple(t.stride() for t in ins),
                 aligned=tuple(t.data_ptr() % 16 == 0 for t in ins))
    if any(p.copy):
        ins = tuple(t.clone(memory_format=torch.contiguous_format) if c
                    else t for t, c in zip(ins, p.copy))
        flash_attention_bwd.copies += sum(p.copy)
    dq = torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
    dk = torch.empty(k.shape, dtype=torch.bfloat16, device=q.device)
    dv = torch.empty(v.shape, dtype=torch.bfloat16, device=q.device)
    if lq == 0 or lk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    stats = torch.empty((2, b, hq, p.lq_pad), dtype=torch.float32,
                        device=q.device)
    strides = [s for t in ins for s in t.stride()[:3]]
    args = _BWD_PTRS.pack(*(t.data_ptr() for t in ins), lse.data_ptr(),
                          dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                          stats[0].data_ptr(),
                          stats[1].data_ptr()) + _BWD_TAIL.pack(
        *strides, b, hq, hkv, lq, lk, p.lq_pad, int(causal), kv_offset,
        p.smem_dq, p.smem_dkv, dh ** -0.5 if scale is None else scale)
    lib = bwd_library(dh)
    build.check(lib.launch(args, _stream(q.device)), "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.copies = 0       # inputs copied before a launch

"""GQA flash attention on the GPU: wrapper of csrc/flash_attention.cu.

Replaces `src/repro/kernels/flash_attention.py:flash_attention`
(pallas_call at :121).  `plan` picks one of three bodies by shape alone
(Rg = group x Lq, the query rows of one (batch, KV head)):

- "decode": bf16, Dh a multiple of 16, Rg <= 16 (the serve step: Lq 1 at
  group 4).  An mma.sync kernel whose warps each take 16 keys of a 64-key
  tile (the TMA unit fills a 2-stage ring, both stages in flight), with
  the keys cut into splits so that the grid has at least 2 x 132 CTAs
  where the keys allow; the last CTA of a row tile merges the splits'
  partial states in split order.  Bound: bytes.
- "tensor_core": bf16, Dh a multiple of 16, Rg > 16 (prefill).  One
  warpgroup of 128 threads owns 64 rows; S = Q K^T and O += P V run as
  wgmma over a 3-stage ring of 64-key K/V tiles that the TMA unit fills;
  the keys are split only where the row tiles leave SMs without a CTA.
  Bound: operations.
- "cuda_core": f32, or Dh not a multiple of 16: the CUDA-core kernel over
  row tiles of up to 16 rows, its keys split the same way.

The kernel reads q, k and v through their (batch, head, position) strides
and needs unit stride only on Dh: the wrapper copies an input only when its
last stride is not 1 or its rows are not 16-byte aligned.  `launches`,
`copies` (inputs copied) and `bodies` (launches by body) count.  On CPU
tensors the wrapper runs the plain version (`kernels/ref.py`); on CUDA
tensors it launches the kernel or raises.  See the source for the design
notes.
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
# csrc/flash_attention.cu:Args: 6 pointers, 9 strides, B Hq Hkv Lq Lk,
# scale, causal kv_offset hc tq head_tiles pos_tiles kv_end split_keys
# n_splits smem dtype body
_PTRS = struct.Struct("<6Q")             # q, k, v, out, part, count
_TAIL = struct.Struct("<9q5if12i")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_BODY_CODE = {"cuda_core": 0, "tensor_core": 1, "decode": 2}
SMEM_LIMIT = 227 * 1024        # dynamic shared memory a CTA may take (H100)
SMS = 132                      # streaming multiprocessors (H100 SXM)
THREADS = 128                  # every body: four warps, one warpgroup
STAGES, DEC_STAGES = 3, 2      # K/V ring stages; the decode body's
SIMT_ROWS, SIMT_BK = 16, 32    # CUDA-core body: rows per CTA, keys per tile
TC_ROWS, TC_BN = 64, 64        # mma bodies: rows per CTA (decode 16), keys
                               # per tile
DECODE_ROWS = 16               # group x Lq at or below which "decode" runs

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
    body = ("cuda_core" if dtype != torch.bfloat16 or dh % 16 else
            "decode" if group * q_shape[2] <= DECODE_ROWS else "tensor_core")
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
                threads=THREADS, smem=smem, copy=copy, lq=lq,
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
    if hq % hkv or dh % 8 or dh > 128:
        raise ValueError(f"flash_attention: Hq {hq}, Hkv {hkv}, Dh {dh}: "
                         "Hq a multiple of Hkv, Dh a multiple of 8 <= 128")
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
    """Arguments and result as `kernels.ref.flash_attention`."""
    if not q.is_cuda:
        return plain(q, k, v, causal=causal, scale=scale, kv_offset=kv_offset)
    call = _prepare((q.shape, k.shape, v.shape), (q.dtype, k.dtype, v.dtype),
                    (k.is_cuda, v.is_cuda),
                    (q.stride(), k.stride(), v.stride()),
                    (q.data_ptr() % 16 == 0, k.data_ptr() % 16 == 0,
                     v.data_ptr() % 16 == 0), bool(causal), kv_offset, scale)
    return _run(q, k, v, call)


def _run(q, k, v, call: _Call) -> torch.Tensor:
    p = call.plan
    if any(call.copy):
        q, k, v = (t.clone(memory_format=torch.contiguous_format) if c else t
                   for t, c in zip((q, k, v), call.copy))
        flash_attention.copies += sum(call.copy)
    dev = q.device
    stream = _stream(dev)
    out = torch.empty(q.shape, dtype=q.dtype, device=dev)
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
                      0 if count is None else count.data_ptr()) + call.tail
    build.check(call.launch(args, stream), "flash_attention")
    flash_attention.launches += 1
    flash_attention.bodies[p.body] += 1
    return out


flash_attention.launches = 0
flash_attention.copies = 0           # inputs copied before a launch
flash_attention.bodies = collections.Counter()   # launches by plan body

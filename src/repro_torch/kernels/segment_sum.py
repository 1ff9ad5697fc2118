"""CSR segment sum on the GPU: wrapper of csrc/segment_sum.cu.

Replaces `src/repro/kernels/segment_sum.py:segment_sum` (pallas_call at
:101), the unfused plan's float-sum aggregation.  The messages come in the
aggregation side's CSR order; the graph's row pointers (`agg_ptr`) delimit
the segments and their piece tables (`agg_pieces`, `kernels/segorder.py`)
cut each into pieces of at most `segorder.SEG_PIECE` entries, so the wrapper
builds nothing.  Each lane sums one piece's live entries in ascending order,
skipping dead ones, and a second pass adds the pieces of the long segments
in piece order: the order of `csrc/segorder.cuh`, which the fused triplet
kernel shares, so the two match bit for bit.  Bytes bound it: every live
message read once, the result written once.

On a CPU tensor it runs the plain version (`kernels/ref.py`); on a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build, ref, segorder
from .triplet import check_pieces

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P]

plain = ref.segment_sum


@functools.lru_cache(maxsize=256)
def source() -> str:
    return build.template("segment_sum")


def segment_sum(msgs: torch.Tensor, live: torch.Tensor, ptr: torch.Tensor,
                pieces: segorder.Pieces | None = None) -> torch.Tensor:
    """Arguments and results as `kernels.ref.segment_sum`; on the card
    `pieces` are the piece tables of `ptr` (CUDA tensors)."""
    if msgs.device.type != "cuda":
        return plain(msgs, live, ptr)
    nl, e_blk = live.shape
    v = ptr.shape[1] - 1
    m = msgs.reshape(nl * e_blk, -1).to(torch.float32).contiguous()
    n_p, n_m = check_pieces("segment_sum", pieces, nl, v)
    check = functools.partial(build.check_arg, "segment_sum")
    check(m, torch.float32, (nl * e_blk, m.shape[1]), "msgs")
    check(live, torch.bool, (nl, e_blk), "live")
    check(ptr, torch.int32, (nl, v + 1), "ptr")
    d = m.shape[1]
    out = torch.empty((nl * v, d), dtype=torch.float32, device=msgs.device)
    part = torch.empty((max(nl * (n_p - v), 1), d), dtype=torch.float32,
                       device=msgs.device)
    lib = build.load("segment_sum", source(), _ARGTYPES)
    err = lib.launch(build.ptr(m), d, build.ptr(live), build.ptr(ptr),
                     build.ptr(pieces.ptr), build.ptr(pieces.seg),
                     build.ptr(pieces.multi), nl, v, e_blk, n_p, n_m,
                     build.ptr(out), build.ptr(part), build.stream())
    build.check(err, "segment_sum")
    segment_sum.launches += 1
    return out.reshape((nl, v) + tuple(msgs.shape[2:])).to(msgs.dtype)


segment_sum.launches = 0

"""CSR segment sum on the GPU: wrapper of csrc/segment_sum.cu.

Replaces `src/repro/kernels/segment_sum.py:segment_sum` (pallas_call at
:101), the unfused plan's float-sum aggregation.  The messages come in the
aggregation side's CSR order and the graph's row pointers (`agg_ptr`)
delimit the segments, so the wrapper builds nothing.  One thread per
(segment, column) adds the live entries of its range sequentially in
ascending order, skipping dead ones, so it matches the fused triplet kernel
bit for bit.  Memory bounds it: every live message read once, the result
written once.

On a CPU tensor it runs the plain version (`kernels/ref.py`); on a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build, ref

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p]

plain = ref.segment_sum


@functools.lru_cache(maxsize=256)
def source() -> str:
    return build.template("segment_sum")


def segment_sum(msgs: torch.Tensor, live: torch.Tensor,
                ptr: torch.Tensor) -> torch.Tensor:
    """Arguments and results as `kernels.ref.segment_sum`."""
    if msgs.device.type != "cuda":
        return plain(msgs, live, ptr)
    nl, e_blk = live.shape
    v = ptr.shape[1] - 1
    m = msgs.reshape(nl * e_blk, -1).to(torch.float32).contiguous()
    check = functools.partial(build.check_arg, "segment_sum")
    check(m, torch.float32, (nl * e_blk, m.shape[1]), "msgs")
    check(live, torch.bool, (nl, e_blk), "live")
    check(ptr, torch.int32, (nl, v + 1), "ptr")
    out = torch.empty((nl * v, m.shape[1]), dtype=torch.float32,
                      device=msgs.device)
    lib = build.load("segment_sum", source(), _ARGTYPES)
    err = lib.launch(build.ptr(m), m.shape[1], build.ptr(live), build.ptr(ptr),
                     nl, v, e_blk, build.ptr(out), build.stream())
    build.check(err, "segment_sum")
    segment_sum.launches += 1
    return out.reshape((nl, v) + tuple(msgs.shape[2:])).to(msgs.dtype)


segment_sum.launches = 0

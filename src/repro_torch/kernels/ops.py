"""Kernel dispatch for the engine.

kernel_mode, one switch for the whole engine:
  "auto" — the kernel wrapper, which decides by the tensors' device: the
           plain version for CPU tensors, the CUDA kernel for CUDA tensors
           (launched, or an error — never a silent fallback);
  "ref"  — the plain PyTorch version on any device (tests, comparisons).
("unfused" is decided by the engine before it reaches this module.)
"""
from __future__ import annotations

from . import flash_attention as _flash
from . import mlstm as _mlstm
from . import ref
from . import segment_sum as _segsum
from . import spmv as _spmv
from . import superstep as _superstep
from . import triplet as _triplet

MODES = ("auto", "ref")


def _plain(mode: str) -> bool:
    """Does this kernel_mode ask for the plain version?"""
    if mode not in MODES:
        raise ValueError(f"kernel_mode {mode!r}; one of {MODES} or 'unfused'")
    return mode == "ref"


def segment_sum(msgs, live, ptr, pieces=None, *, mode: str = "auto"):
    """CSR segment sum of live messages [nl, E, ...]; [nl, V, ...].  The
    kernel takes `ptr`'s piece tables (`kernels/segorder.py`)."""
    if _plain(mode):
        return ref.segment_sum(msgs, live, ptr)
    return _segsum.segment_sum(msgs, live, ptr, pieces)


def triplet(x, ev, src_slot, dst_slot, live, ptr, perm, spec, *,
            to: str = "dst", reduce: str = "sum", mode: str = "auto",
            pieces=None, xscale=None):
    """Fused gather + map + segment-reduce; (out [S, dm] f32, cnt [S]).
    The kernel takes `ptr`'s piece tables (`kernels/segorder.py`); x may be
    a narrow-resident payload with its scale plane `xscale`."""
    if _plain(mode):
        return ref.fused_triplet(x, ev, src_slot, dst_slot, live, ptr, perm,
                                 spec, to=to, reduce=reduce, xscale=xscale)
    return _triplet.fused_triplet(x, ev, src_slot, dst_slot, live, ptr, perm,
                                  spec, to=to, reduce=reduce, pieces=pieces,
                                  xscale=xscale)


def superstep_apply(msgs, rflags, send, rng, xs, vid, vmask, spec, *,
                    reduce: str = "sum", mode: str = "auto"):
    """Fused combine + vprog + changed over the routed message leaves and
    the vertex leaves; (new vertex leaves, changed [nl, V_blk] bool)."""
    fn = ref.fused_apply if _plain(mode) else _superstep.fused_apply
    return fn(msgs, rflags, send, rng, xs, vid, vmask, spec, reduce=reduce)


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None, kv_offset: int = 0,
                    mode: str = "auto"):
    """GQA attention, q [B, Hq, Lq, Dh], k/v [B, Hkv, Lk, Dh] -> [B, Hq,
    Lq, Dh] in q's dtype, with the Pallas kernel's semantics.
    Differentiable on both devices: on the CPU (and in "ref") autograd
    differentiates the plain version; on CUDA tensors the gradient is the
    backward kernel (`kernels.flash_attention.flash_attention_bwd`)."""
    fn = ref.flash_attention if _plain(mode) else _flash.flash_attention
    return fn(q, k, v, causal=causal, scale=scale, kv_offset=kv_offset)


def mlstm_chunked(q, k, v, logi, logf, *, chunk: int = 128,
                  mode: str = "auto"):
    """Chunkwise mLSTM, q/k/v [B, H, L, Dh] (q pre-scaled), logi/logf
    [B, H, L] -> out [B, H, L, Dh] f32; differentiable (the kernel path's
    gradient is the backward kernel)."""
    fn = ref.mlstm_chunked if _plain(mode) else _mlstm.mlstm_chunked
    return fn(q, k, v, logi, logf, chunk=chunk)


def spmv(x, w, src_slot, dst_slot, tiles, active_src_blocks, v_mir: int, *,
         mode: str = "auto", vb: int = 512):
    """out[v] = sum over live edges into v of w[e] * x[src e] (`tiles` from
    `kernels.spmv.build_tiles`; `active_src_blocks` skips stale source
    blocks)."""
    fn = _spmv.plain if _plain(mode) else _spmv.spmv
    return fn(x, w, src_slot, dst_slot, tiles, active_src_blocks, v_mir,
              vb=vb)


_COUNTED = {"triplet": _triplet.fused_triplet,
            "apply": _superstep.fused_apply,
            "segment_sum": _segsum.segment_sum,
            "flash_attention": _flash.flash_attention,
            "flash_attention_bwd": _flash.flash_attention_bwd,
            "mlstm_fwd": _mlstm.forward,
            "mlstm_bwd": _mlstm.backward,
            "spmv": _spmv.spmv}


def launch_counts() -> dict[str, int]:
    """Launches of each CUDA kernel since the last reset; "triplet" counts
    every variant, "triplet_<variant>" each x encoding on its own
    (`kernels.triplet.variant`)."""
    counts = {name: fn.launches for name, fn in _COUNTED.items()}
    counts.update({f"triplet_{k}": n
                   for k, n in _triplet.fused_triplet.variants.items()})
    return counts


def reset_launch_counts() -> None:
    for fn in _COUNTED.values():
        fn.launches = 0
    _triplet.fused_triplet.variants.clear()


def add_launch_counts(delta: dict[str, int]) -> None:
    """Add launches that no wrapper call made: a CUDA graph's replay runs
    the launches its capture recorded (`core.capture`), so each replay
    adds them, and `launch_counts` keeps counting launches on the card.
    Keys as `launch_counts`."""
    variants = _triplet.fused_triplet.variants
    for name, n in delta.items():
        if name.startswith("triplet_"):
            key = name[len("triplet_"):]
            variants[key] = variants.get(key, 0) + n
        else:
            _COUNTED[name].launches += n

"""Chunkwise mLSTM on the GPU: wrapper of csrc/mlstm_tc.cu and
csrc/mlstm.cu, forward and backward under one `torch.autograd.Function`.

Replaces `src/repro/kernels/mlstm.py:mlstm_chunked` (pallas_call at :102);
its gradient, which the reference takes by autodiff of the plain scan, is
the backward kernel.  `plan` picks one of two bodies by shape alone:

- "tensor_core" (csrc/mlstm_tc.cu): chunk 16-128 and Dh 16-256, both
  multiples of 16.  The sequential part and the chunk work are split: a
  chunk-state scan (one [TK, TV] tile of C a CTA, in registers, walking
  the chunks) writes every chunk's entry state, then one CTA a chunk forms
  the chunk's output from it (q k^T once per chunk); the backward is the
  same pair in reverse (a dC scan, then one CTA a chunk for dq, dk, dv and
  the gate gradients).  Products run as mma.sync TF32 in three terms
  (hi*hi + hi*lo + lo*hi), f32 accuracy; operand tiles stream through a
  ring of `stages` cp.async stages.  The forward writes the chunk-entry
  states on every call and, unless a gradient will be taken, frees them
  before it returns.
- "cuda_core" (csrc/mlstm.cu): the other shapes (Dh 8-256 not a multiple
  of 16).  One CTA owns (batch*head, a tile of TV value columns) and walks
  the chunks on the CUDA cores, keeping C[:, tile] and n in shared memory;
  the states are written only when a gradient will be taken, and the
  backward sums its per-tile partials in tile order.

Each launcher counts one call (`forward.launches`, `backward.launches`;
`bodies` by body) whatever number of kernels it starts.  On CPU tensors
`mlstm_chunked` runs the plain version (`kernels/ref.py`, gradient by
autograd); on CUDA tensors it launches the kernels or raises.  See the
sources for the design notes.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import torch

from . import build, ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRIES = {"launch_fwd": [_P] * 8 + [_I] * 4 + [_P],
            "launch_bwd": [_P] * 18 + [_I] * 4 + [_P]}
_TC_ENTRIES = {"launch_tc_fwd": [_P] * 11 + [_I] * 2 + [_P],
               "launch_tc_bwd": [_P] * 21 + [_I] * 2 + [_P],
               "mlstm_tc_layout": [_I, _I, _P]}
SMEM_LIMIT = 227 * 1024        # dynamic shared memory a CTA may take (H100)
TILES = (64, 32, 16)           # CUDA-core body: value-column tiles
_NT, _DS = 256, 16             # CUDA-core body: threads, Dh slice
STAGES = 2                     # tensor-core body: cp.async ring stages

plain = ref.mlstm_chunked


@functools.lru_cache(maxsize=32)
def source(w: int, tv: int) -> str:
    """CUDA-core body's source for chunk length w and value tile tv."""
    return build.template("mlstm").replace(
        "//@GENERATED@", f"#define W {w}\n#define TV {tv}")


@functools.lru_cache(maxsize=32)
def tc_source(w: int, dh: int, tk: int, tv: int, stages: int) -> str:
    """Tensor-core body's source for chunk w, head dimension dh, scan tile
    tk x tv and `stages` ring stages."""
    return build.template("mlstm_tc").replace(
        "//@GENERATED@", f"#define W {w}\n#define D {dh}\n#define TK {tk}\n"
        f"#define TV {tv}\n#define STAGES {stages}")


def smem_bytes(bwd: bool, w: int, tv: int, dh: int) -> int:
    """CUDA-core body: dynamic shared memory of one CTA, the floats laid
    out at the top of `mlstm_bwd` (bwd) or `mlstm_fwd` in csrc/mlstm.cu.
    The launchers take this size as an argument; the source keeps no copy
    of it."""
    qs, aw, tvp = _DS + 1, w + 1, tv + 1
    if bwd:
        n = (2 * dh * tvp + 2 * dh + 2 * w * tvp + 2 * w * aw + 3 * w * qs
             + 15 * w + _NT + 16 * w + 4)
    else:
        n = dh * tvp + dh + w * tvp + w * aw + 2 * w * qs + 8 * w + 4
    return 4 * n


def tiling(w: int, dh: int) -> int:
    """CUDA-core body: the widest value tile that both kernels fit in
    shared memory and that Dh (rounded up to 16) fills.  The forward takes
    the backward's tile even under no_grad, where a wider one might fit,
    so that one build per chunk length serves a training step."""
    _check_chunk(w)
    for tv in TILES:
        if (tv <= -(-dh // 16) * 16 or tv == TILES[-1]) and \
                smem_bytes(True, w, tv, dh) <= SMEM_LIMIT:
            return tv
    raise ValueError(f"mlstm: Dh {dh} at chunk {w} does not fit shared memory")


def _check_chunk(w: int) -> None:
    if w % 16 or not 16 <= w <= 128:
        raise ValueError(f"mlstm: chunk length {w}; a multiple of 16 in "
                         "[16, 128]")


def tc_smem(kernel: str, w: int, dh: int, tk: int, tv: int,
            stages: int) -> int:
    """Tensor-core body: dynamic shared memory of one CTA of `kernel`
    ("scan_fwd", "scan_bwd", "out", "bwd_chunk"), a model of csrc/
    mlstm_tc.cu's constexpr SCAN_F, SCAN_B, OUT_F and BWD_F for `plan`,
    which must decide on the CPU what fits.  The launchers take the
    source's own sizes (`layout` reads them); chip_smoke.py and the card
    tests hold the two equal."""
    pa, pb = (lambda x: x + 4), (lambda x: x + 8)
    ks, kq, k1 = 16, 16 if dh % 32 else 32, 8 if w > 64 else 16
    if kernel.startswith("scan"):
        sb = w * pb(tk) + w * pb(tv)
        if kernel == "scan_fwd":   # or the state tile staged on its way out
            sb = max(sb + 2 * w, tk * (tv + 4))
        else:
            sb += 4 * w + tk * pb(tv) + tk
        return 4 * (stages * sb + 2 * w + 8)
    if kernel == "out":
        sb = max(2 * w * pa(kq), 16 * pb(dh), w * pa(ks) + 16 * pb(dh))
        return 4 * (stages * sb + w * pa(w) + 6 * w + dh)
    sb = max(4 * w * pa(k1), w * pa(ks) + dh * pa(ks),
             w * pa(ks) + 16 * pb(dh))
    cg = 4 if w % 32 == 0 and dh % 32 == 0 else 2
    return 4 * (stages * sb + w * pb(w) + w * pa(w) + 12 * w + 2 * cg * w
                + (w // 16) * w + 2 * dh)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How chunk `w` at head dimension `dh` runs.  Tensor-core body: the
    scan tile tk x tv, ring stages and each kernel's shared memory;
    CUDA-core body: the value tile tv and shared memory."""
    body: str
    w: int
    dh: int
    tk: int
    tv: int
    stages: int
    smem: dict

    def source(self) -> str:
        if self.body == "cuda_core":
            return source(self.w, self.tv)
        return tc_source(self.w, self.dh, self.tk, self.tv, self.stages)


def _tc_plan(w: int, dh: int, tk: int, tv: int, stages: int) -> Plan | None:
    """The tensor-core pair at scan tile tk x tv (multiples of 16 dividing
    dh) with the deepest ring <= `stages` at which every kernel fits
    shared memory; None if none does (scripts/mlstm_kernel_sweep.py lays
    out its variants with it)."""
    if tk % 16 or tv % 16 or dh % tk or dh % tv:
        raise ValueError(f"mlstm: scan tile {tk} x {tv} at Dh {dh}")
    for st in range(stages, 1, -1):
        smem = {k: tc_smem(k, w, dh, tk, tv, st) for k in
                ("scan_fwd", "out", "scan_bwd", "bwd_chunk")}
        if max(smem.values()) <= SMEM_LIMIT:
            return Plan("tensor_core", w, dh, tk, tv, st, smem)
    return None


@functools.lru_cache(maxsize=None)
def plan(w: int, dh: int) -> Plan:
    """The body for chunk w and head dimension dh, by shape alone: the
    tensor-core pair where w and dh are multiples of 16 (dh <= 256; scan
    tile the largest of 64, 32, 16 dividing dh, STAGES ring stages or
    fewer where they do not fit), else the CUDA-core body.  Raises for a
    chunk the kernels do not take."""
    _check_chunk(w)
    if dh % 16 == 0 and 16 <= dh <= 256:
        t = next(t for t in (64, 32, 16) if dh % t == 0)
        pl = _tc_plan(w, dh, t, t, STAGES)
        if pl is not None:
            return pl
    tv = tiling(w, dh)
    return Plan("cuda_core", w, dh, 0, tv, 0,
                {"fwd": smem_bytes(False, w, tv, dh),
                 "bwd": smem_bytes(True, w, tv, dh)})


def layout(pl: Plan, bh: int, l: int) -> dict:
    """What the tensor-core body's launchers run for B*H = bh and length l,
    read from the built library (csrc/mlstm_tc.cu:mlstm_tc_layout): each
    kernel's dynamic shared memory in bytes, the grids and the threads of
    a CTA.  Builds the library; needs nvcc."""
    if pl.body != "tensor_core":
        raise ValueError(f"mlstm: layout of a {pl.body} plan")
    lib = build.load_entries("mlstm", pl.source(), _TC_ENTRIES)
    v = (ctypes.c_int * 11)()
    lib.mlstm_tc_layout(bh, l, v)
    return {"smem": dict(zip(("scan_fwd", "out", "scan_bwd", "bwd_chunk"),
                             v[:4])),
            "grids": {"scan": tuple(v[4:7]), "chunk": tuple(v[7:9])},
            "threads": {"scan": v[9], "chunk": v[10]}}


def _prepare(pl: Plan, q, k, v, logi, logf, chunk: int):
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
    if (pl.w, pl.dh) != (w, dh):
        raise ValueError(f"mlstm: plan for chunk {pl.w}, Dh {pl.dh} given "
                         f"chunk {w}, Dh {dh}")
    entries = _ENTRIES if pl.body == "cuda_core" else _TC_ENTRIES
    return args, (b, h, l, dh, w), build.load_entries(
        "mlstm", pl.source(), entries)


def _plan_of(q, chunk: int) -> Plan:
    return plan(min(chunk, q.shape[2]), q.shape[3])


def forward(q, k, v, logi, logf, *, chunk: int, states: bool):
    """Launch the forward: (out [B, H, L, Dh] f32, saved), where `saved`
    holds what `backward` needs (the chunk-entry states, and for the
    tensor-core body the rows' cum, m and den) when `states`, else None."""
    return _forward(_plan_of(q, chunk), q, k, v, logi, logf, chunk, states)


def backward(q, k, v, logi, logf, out, dout, saved, *, chunk: int):
    """Launch the backward from the forward's `saved`; returns (dq, dk, dv
    [B, H, L, Dh], dlogi, dlogf [B, H, L])."""
    return _backward(_plan_of(q, chunk), q, k, v, logi, logf, out, dout,
                     saved, chunk)


def _forward(pl: Plan, q, k, v, logi, logf, chunk: int, states: bool):
    (q, k, v, logi, logf), (b, h, l, dh, w), lib = _prepare(
        pl, q, k, v, logi, logf, chunk)
    out = torch.empty_like(q)
    bh, nc = b * h, l // w
    dev = q.device
    if pl.body == "cuda_core":
        c_st = n_st = None
        if states:
            c_st = torch.empty((bh, nc, dh, dh), device=dev)
            n_st = torch.empty((bh, nc, dh), device=dev)
        nullp = ctypes.c_void_p(None)
        err = lib.launch_fwd(*map(build.ptr, (q, k, v, logi, logf, out)),
                             build.ptr(c_st) if states else nullp,
                             build.ptr(n_st) if states else nullp,
                             bh, l, dh, pl.smem["fwd"], build.stream())
        saved = (c_st, n_st) if states else None
    else:
        c_st = torch.empty((bh, nc, dh, dh), device=dev)
        n_st = torch.empty((bh, nc, dh), device=dev)
        cum, m, den = (torch.empty_like(logi) for _ in range(3))
        err = lib.launch_tc_fwd(*map(build.ptr, (
            q, k, v, logi, logf, out, c_st, n_st, cum, m, den)), bh, l,
            build.stream())
        saved = (c_st, n_st, cum, m, den) if states else None
    build.check(err, "mlstm_fwd")
    forward.launches += 1
    forward.bodies[pl.body] += 1
    return out, saved


def _backward(pl: Plan, q, k, v, logi, logf, out, dout, saved, chunk: int):
    (q, k, v, logi, logf), (b, h, l, dh, w), lib = _prepare(
        pl, q, k, v, logi, logf, chunk)
    out, dout = out.contiguous(), dout.float().contiguous()
    bh, nc = b * h, l // w
    check = functools.partial(build.check_arg, "mlstm")
    check(out, torch.float32, (b, h, l, dh), "out")
    check(dout, torch.float32, (b, h, l, dh), "dout")
    check(saved[0], torch.float32, (bh, nc, dh, dh), "C states")
    check(saved[1], torch.float32, (bh, nc, dh), "n states")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dlogi, dlogf = torch.empty_like(logi), torch.empty_like(logf)
    dev = q.device
    if pl.body == "cuda_core":
        c_st, n_st = saved
        nt = -(-dh // pl.tv)
        dq_p, dk_p = (torch.empty((nt,) + q.shape, device=dev)
                      for _ in range(2))
        dli_p, dlf_p = (torch.empty((nt,) + logi.shape, device=dev)
                        for _ in range(2))
        err = lib.launch_bwd(*map(build.ptr, (
            q, k, v, logi, logf, out, dout, c_st, n_st, dq_p, dk_p, dli_p,
            dlf_p, dq, dk, dv, dlogi, dlogf)), bh, l, dh, pl.smem["bwd"],
            build.stream())
    else:
        c_st, n_st, cum, m, den = saved
        for name, t in (("cum", cum), ("m", m), ("den", den)):
            check(t, torch.float32, (b, h, l), name)
        g, dden = torch.empty_like(logi), torch.empty_like(logi)
        dc_st, dn_st = torch.empty_like(c_st), torch.empty_like(n_st)
        part = torch.empty((bh, nc, (dh // pl.tk) * (dh // pl.tv)),
                           device=dev)
        err = lib.launch_tc_bwd(*map(build.ptr, (
            q, k, v, logi, out, dout, c_st, n_st, cum, m, den, g, dden,
            dc_st, dn_st, part, dq, dk, dv, dlogi, dlogf)), bh, l,
            build.stream())
    build.check(err, "mlstm_bwd")
    backward.launches += 1
    backward.bodies[pl.body] += 1
    return dq, dk, dv, dlogi, dlogf


forward.launches = 0
backward.launches = 0
forward.bodies = collections.Counter()
backward.bodies = collections.Counter()


class _MlstmChunked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, logi, logf, chunk):
        out, saved = forward(q, k, v, logi, logf, chunk=chunk, states=True)
        ctx.save_for_backward(q, k, v, logi, logf, out, *saved)
        ctx.chunk = chunk
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, logi, logf, out, *saved = ctx.saved_tensors
        grads = backward(q, k, v, logi, logf, out, dout, saved,
                         chunk=ctx.chunk)
        return (*(g.to(x.dtype) for g, x in zip(grads, ctx.saved_tensors)),
                None)


def mlstm_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  logi: torch.Tensor, logf: torch.Tensor, *,
                  chunk: int = 128) -> torch.Tensor:
    """Arguments and result as `kernels.ref.mlstm_chunked`.  What the
    backward needs is kept only when autograd will take a gradient (grad
    mode on and an input that requires grad)."""
    if q.device.type != "cuda":
        return plain(q, k, v, logi, logf, chunk=chunk)
    args = (q, k, v, logi, logf)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _MlstmChunked.apply(*args, chunk)
    return forward(*args, chunk=chunk, states=False)[0]

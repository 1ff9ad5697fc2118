"""The fused mrTriplets sweep on the GPU: wrapper of csrc/triplet.cu.

Replaces `src/repro/kernels/triplet.py:fused_triplet` (pallas_call at :447).
Each slot's CSR range is cut into pieces of at most `segorder.SEG_PIECE`
edges (the graph's piece tables, `kernels/segorder.py`); a warp evaluates
the map UDF (generated C from `kernels/udf.py`) once per live edge of 32
pieces' span, each lane reduces one piece in ascending order, and a second
pass combines the pieces of the long slots in piece order: the summation
order of `csrc/segorder.cuh`, which `segment_sum.cu` shares.  What bounds it
on the card is bytes: per live edge the index streams, the edge payload and
the used endpoint rows (random gathers).  See the source for the design.

The kernel also reads the reference's encoded tiles (the `have_scale` body
of `_make_kernel`, `_spread_scale_tile`): x may be bf16, or a
narrow-resident payload (int8, int16, fp8 e4m3 / e5m2) with its int8 scale
plane `xscale`, one power-of-two exponent per `ref.SCALE_GROUP` rows of a
partition and column.  Each used endpoint row is converted exactly to f32
and scaled by 2^e in registers before the UDF, so the kernel on (payload,
xscale) equals the kernel on the decoded f32 rows bit for bit.
`fused_triplet.variants` counts the launches of each x encoding.

On a CPU tensor the wrapper runs the plain version (`kernels/ref.py`); on a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import build, ref, segorder, udf

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, ctypes.c_longlong, _P, ctypes.c_longlong, _P, _P, _P, _P,
             _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]

# x dtype -> (variant name, CUDA element type)
X_TYPES = {torch.float32: ("f32", "float"),
           torch.bfloat16: ("bf16", "__nv_bfloat16"),
           torch.int8: ("int8", "signed char"),
           torch.int16: ("int16", "short"),
           torch.float8_e4m3fn: ("e4m3", "__nv_fp8_e4m3"),
           torch.float8_e5m2: ("e5m2", "__nv_fp8_e5m2")}

plain = ref.fused_triplet


@dataclasses.dataclass(frozen=True)
class TripletUdf:
    """The map UDF as the kernel runs it: an IR whose inputs load columns
    of the packed staging rows ("xs" source mirror row, "ev" edge row, "xd"
    destination mirror row) and whose outputs are the dm message columns."""

    ir: udf.IR
    dm: int

    def uses(self, array: str) -> bool:
        return any(op.kind == "in" and op.args[0] == array
                   for op in self.ir.ops)


def variant(x_dtype: torch.dtype, scaled: bool) -> str:
    """Name of the kernel variant that reads x of this dtype: "f32", "bf16",
    "int8_scale", "e4m3_scale", ..."""
    return X_TYPES[x_dtype][0] + ("_scale" if scaled else "")


@functools.lru_cache(maxsize=256)
def source(spec: TripletUdf, reduce: str, to: str,
           permuted: bool | None = None, x_dtype: torch.dtype = torch.float32,
           scaled: bool = False, dx: int = 0) -> str:
    """CUDA source of the kernel specialised to this UDF and reduce.
    `permuted` (default: to == "src") walks each slot's CSR range through
    the `perm` edge order instead of the stored order.  Any x but plain f32
    (`x_dtype`, `scaled`: a scale plane rides along) loads its dx-column
    rows into registers."""
    if permuted is None:
        permuted = to == "src"
    rows = x_dtype != torch.float32 or scaled
    def load(arr, col, dt):
        return f"({udf.C_TYPE[dt]})({arr}[{col}])"

    lines, outs = udf.emit(spec.ir, load, "t")
    gen = [f"#define DM {spec.dm}",
           f"#define IDENT {udf.c_const(ref.REDUCE_IDENTITY[reduce], 'f32')}",
           f"#define REDUCE(a, b) {udf.REDUCE_C[reduce]}",
           f"#define PERMUTED {int(permuted)}",
           f"#define USE_SRC {int(spec.uses('xs'))}",
           f"#define USE_DST {int(spec.uses('xd'))}",
           f"#define X_T {X_TYPES[x_dtype][1]}",
           f"#define X_ROWS {int(rows)}",
           f"#define HAVE_SCALE {int(scaled)}",
           f"#define DX {max(dx, 1) if rows else 0}",
           udf.PRELUDE,
           "__device__ __forceinline__ void udf_msg(const float* xs, "
           "const float* ev, const float* xd, float* msg) {",
           *[f"  {l}" for l in lines],
           *[f"  msg[{i}] = (float)({o});" for i, o in enumerate(outs)],
           "}"]
    return build.template("triplet").replace("//@GENERATED@", "\n".join(gen))


def check_pieces(kernel: str, pieces, nl: int, v: int) -> tuple[int, int]:
    """Raise unless `pieces` are int32 CUDA piece tables of nl partitions
    of v segments (`segorder.Pieces`); (pieces per partition, segments of
    several pieces)."""
    if not isinstance(pieces, segorder.Pieces):
        raise ValueError(f"{kernel}: pieces must be segorder.Pieces, got "
                         f"{type(pieces).__name__}")
    n_p = pieces.seg.shape[-1]
    if n_p % segorder.WARP or n_p < v:
        raise ValueError(f"{kernel}: {n_p} pieces a partition is no "
                         f"multiple of {segorder.WARP} at least {v}")
    check = functools.partial(build.check_arg, kernel)
    check(pieces.ptr, torch.int32, (nl, v + 1), "pieces.ptr")
    check(pieces.seg, torch.int32, (nl, n_p), "pieces.seg")
    check(pieces.multi, torch.int32, (pieces.multi.shape[0],), "pieces.multi")
    return n_p, pieces.multi.shape[0]


def fused_triplet(x, ev, src_slot, dst_slot, live, ptr, perm,
                  spec: TripletUdf, *, to: str = "dst", reduce: str = "sum",
                  pieces: segorder.Pieces | None = None, xscale=None):
    """Arguments and results as `kernels.ref.fused_triplet`; on the card
    `pieces` are the piece tables of `ptr` (CUDA tensors)."""
    if x.device.type != "cuda":
        return plain(x, ev, src_slot, dst_slot, live, ptr, perm, spec,
                     to=to, reduce=reduce, xscale=xscale)
    nl, e_blk = src_slot.shape
    v_mir = ptr.shape[1] - 1
    s = nl * v_mir
    n_p, n_m = check_pieces("triplet", pieces, nl, v_mir)
    check = functools.partial(build.check_arg, "triplet")
    if x.dtype not in X_TYPES:
        raise ValueError(f"triplet: x of dtype {x.dtype}; one of "
                         f"{tuple(X_TYPES)}")
    check(x, x.dtype, (s, x.shape[1]), "x")
    if xscale is not None:
        nb = -(-v_mir // ref.SCALE_GROUP)
        check(xscale, torch.int8, (nl * nb, x.shape[1]), "xscale")
    check(ev, torch.float32, (nl * e_blk, ev.shape[1]), "ev")
    check(src_slot, torch.int32, (nl, e_blk), "src_slot")
    check(dst_slot, torch.int32, (nl, e_blk), "dst_slot")
    check(live, torch.bool, (nl, e_blk), "live")
    check(ptr, torch.int32, (nl, v_mir + 1), "ptr")
    if perm is not None:
        check(perm, torch.int32, (nl, e_blk), "perm")
    out = torch.empty((s, spec.dm), dtype=torch.float32, device=x.device)
    cnt = torch.empty((s,), dtype=torch.float32, device=x.device)
    # scratch rows of the pieces after a slot's first (segorder.cuh)
    rows = max(nl * (n_p - v_mir), 1)
    part = torch.empty((rows, spec.dm), dtype=torch.float32, device=x.device)
    part_cnt = torch.empty((rows,), dtype=torch.int32, device=x.device)
    scaled = xscale is not None
    lib = build.load("triplet", source(spec, reduce, to, perm is not None,
                                       x.dtype, scaled, x.shape[1]),
                     _ARGTYPES)
    nullp = ctypes.c_void_p(None)
    err = lib.launch(build.ptr(x), build.ptr(xscale) if scaled else nullp,
                     x.shape[1], build.ptr(ev), ev.shape[1],
                     build.ptr(src_slot), build.ptr(dst_slot),
                     build.ptr(live), build.ptr(ptr),
                     build.ptr(perm) if perm is not None else nullp,
                     build.ptr(pieces.ptr), build.ptr(pieces.seg),
                     build.ptr(pieces.multi), nl, v_mir, e_blk, n_p, n_m,
                     build.ptr(out), build.ptr(cnt), build.ptr(part),
                     build.ptr(part_cnt), build.stream())
    build.check(err, "triplet")
    fused_triplet.launches += 1
    name = variant(x.dtype, scaled)
    fused_triplet.variants[name] = fused_triplet.variants.get(name, 0) + 1
    return out, cnt


fused_triplet.launches = 0
fused_triplet.variants = {}

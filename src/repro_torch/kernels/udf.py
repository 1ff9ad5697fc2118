"""User functions inside a CUDA kernel: trace -> small IR -> CUDA C.

The Pallas kernels trace the user's UDF into their body (`tile_fn`,
`apply_fn`).  The port does the same at the source level:

  1. `core.analysis.trace_udf` records `make_fx(vmap(udf))` over one scalar
     per element (the graph the join-elimination slice is taken on);
  2. `lower` turns the sliced aten graph into an `IR`: a tuple of scalar ops
     in topological order, hashable, so it keys the kernel build;
  3. `emit` writes the IR as CUDA C statements that a kernel template
     splices in, one local per op;
  4. `evaluate` runs the same IR with torch ops — the plain versions of the
     kernels use it, and the tests hold it against the UDF itself.

Supported: elementwise add/sub/mul/div/neg/abs/minimum/maximum/where,
integer remainder (floor semantics, the sign of the divisor, as torch and
`jnp` `%` compute it; the emitted C corrects C's truncating `%`),
comparisons, logical ops, casts (`_to_copy`), constants, the float math
ops exp/log/log1p/expm1/sqrt/rsqrt/reciprocal/tanh/sigmoid/sin/cos/atan/
atan2/floor/ceil/sign, pow with a scalar exponent, clamp/clamp_min/
clamp_max, and the value-preserving view ops as no-ops, on leaves of rank 0
or 1.  A rank-1 value lowers to one scalar op per element (select, slice,
cat, stack and broadcasting pick and spread them), so the IR itself stays
scalar and a rank-1 leaf is one packed column per element.  Reductions over
a rank-1 value lower where the result does not depend on the order of the
terms: amax/amin (and max/min's values) to a chain of max/min ops, an
integer or bool sum to a chain of integer adds, argmax to a chain of
strict comparisons (the first largest index, a NaN first, as torch
picks).  A float sum, dot or matmul
inside a UDF stays outside the IR on purpose: the unfused plan adds its
terms in an order torch does not pin, so the fused plan could not equal it
bit for bit.  Anything outside the IR makes `lower` return None and the
engine plans the unfused path.

Exactness rules the emitted C keeps: float constants are written as the
exact bit pattern of the f32 (`__int_as_float(0x...)`), every op rounds on
its own (the build passes --fmad=false, so `a + b * c` never contracts into
an FMA), integers stay in integer registers, and the math ops call the
accurate libm functions (`expf`, `logf`, ...), never the `__expf`
intrinsics.  bf16/f16 values live in f32 registers and every op of those
dtypes rounds its f32 result to the dtype, as torch computes them; a
constant in such an op must be exact in the dtype (torch would keep it in
f32), else the UDF plans unfused.
"""
from __future__ import annotations

import dataclasses
import operator
import struct
from typing import Callable

import numpy as np
import torch

aten = torch.ops.aten

_DTYPES = {torch.float32: "f32", torch.float64: "f64",
           torch.bfloat16: "bf16", torch.float16: "f16", torch.int32: "i32",
           torch.int64: "i64", torch.int16: "i16", torch.int8: "i8",
           torch.uint8: "u8", torch.bool: "bool"}
TORCH_DTYPE = {v: k for k, v in _DTYPES.items()}
FLOATS = ("f32", "f64", "bf16", "f16")
NARROW = ("bf16", "f16")           # held in f32 registers, rounded per op
C_TYPE = {"f32": "float", "f64": "double", "bf16": "float", "f16": "float",
          "i32": "int", "i64": "long long", "i16": "short",
          "i8": "signed char", "u8": "unsigned char", "bool": "bool"}

_BINARY = {
    aten.add.Tensor: "add", aten.add.Scalar: "add",
    aten.sub.Tensor: "sub", aten.sub.Scalar: "sub",
    aten.rsub.Tensor: "rsub", aten.rsub.Scalar: "rsub",
    aten.mul.Tensor: "mul", aten.mul.Scalar: "mul",
    aten.div.Tensor: "div", aten.div.Scalar: "div",
    aten.minimum.default: "min", aten.maximum.default: "max",
    aten.remainder.Tensor: "rem", aten.remainder.Scalar: "rem",
}
_COMPARE = {
    aten.gt.Tensor: ">", aten.gt.Scalar: ">", aten.ge.Tensor: ">=",
    aten.ge.Scalar: ">=", aten.lt.Tensor: "<", aten.lt.Scalar: "<",
    aten.le.Tensor: "<=", aten.le.Scalar: "<=", aten.eq.Tensor: "==",
    aten.eq.Scalar: "==", aten.ne.Tensor: "!=", aten.ne.Scalar: "!=",
}
_LOGICAL = {
    aten.logical_and.default: "&&", aten.logical_or.default: "||",
    aten.logical_xor.default: "!=", aten.bitwise_and.Tensor: "&&",
    aten.bitwise_or.Tensor: "||", aten.bitwise_xor.Tensor: "!=",
}
_UNARY = {aten.neg.default: "neg", aten.abs.default: "abs",
          aten.logical_not.default: "not", aten.bitwise_not.default: "not",
          aten.sign.default: "sign"}
# float math: integer inputs promote to the float output dtype first
_MATH = {aten.exp.default: "exp", aten.log.default: "log",
         aten.log1p.default: "log1p", aten.expm1.default: "expm1",
         aten.sqrt.default: "sqrt", aten.rsqrt.default: "rsqrt",
         aten.reciprocal.default: "reciprocal", aten.tanh.default: "tanh",
         aten.sigmoid.default: "sigmoid", aten.sin.default: "sin",
         aten.cos.default: "cos", aten.atan.default: "atan",
         aten.floor.default: "floor", aten.ceil.default: "ceil"}
# reductions over the element axis of a [B, k] value, and the op that
# chains the k terms; each leaves the value independent of the order
_REDUCE = {aten.amax.default: "max", aten.amin.default: "min",
           aten.max.dim: "max", aten.min.dim: "min",
           aten.sum.dim_IntList: "add"}
_CLAMP = {aten.clamp.default: (1, 2), aten.clamp.Tensor: (1, 2),
          aten.clamp_min.default: (1, None), aten.clamp_min.Tensor: (1, None),
          aten.clamp_max.default: (None, 1), aten.clamp_max.Tensor: (None, 1)}
# ops that only re-lay the element axis of a [B, k] value (beside the
# value-preserving core.analysis.NOOP_OPS)
_SHAPE_OPS = {aten.unsqueeze.default, aten.squeeze.dim, aten.squeeze.dims,
              aten.squeeze.default}


@dataclasses.dataclass(frozen=True)
class Op:
    """One scalar op.  kind/args:
      in      (array, col)        load of column `col` of input `array`
      const   (value,)            python value, already rounded to dtype
      cast    (a,)
      add|sub|mul|div|min|max (a, b)   computed in this op's dtype
      rem     (a, b)              integer remainder, floor semantics
      cmp     (symbol, a, b)      operands already cast to the promoted type
      logic   (symbol, a, b)      on bools
      neg|abs|not|sign (a,)
      exp|log|...|ceil (a,)       the float math ops of _MATH
      atan2   (a, b)
      pow     (a, exponent)       python float exponent
      where   (cond, a, b)
    Operand entries are indices of earlier ops."""

    kind: str
    args: tuple
    dtype: str


@dataclasses.dataclass(frozen=True)
class IR:
    ops: tuple[Op, ...]
    outputs: tuple[int, ...]


class _Unsupported(Exception):
    pass


def _round(value, dt: str):
    if dt == "bool":
        return bool(value)
    if dt in NARROW:
        return float(torch.tensor(value, dtype=TORCH_DTYPE[dt]).float())
    if dt in FLOATS:
        return float(np.float32(value)) if dt == "f32" else float(value)
    return int(value)


def _width(shape: tuple) -> int:
    return int(np.prod(shape)) if shape else 1


def lower(tr, inputs: list) -> IR | None:
    """Lower a traced UDF to an IR.  `inputs[i]` is the (array, col) the
    i-th flat placeholder loads from — its first column; a rank-1 leaf of
    width k loads columns col .. col+k-1 — or None where the caller cannot
    supply it (join-eliminated side): referencing such an input fails the
    lowering.  The IR's outputs are the output leaves' columns in flat
    order.  Returns None for any op outside the supported set."""
    try:
        return _lower(tr, inputs)
    except _Unsupported:
        return None


def _lower(tr, inputs: list) -> IR:
    # imported here: core imports this module's users (kernels.ops)
    from ..core.analysis import NOOP_OPS, TRACE_BATCH
    ops: list[Op] = []
    index: dict = {}          # fx node -> tuple of op indices, one per element
    casts: dict = {}

    def add(kind, args, dt) -> int:
        ops.append(Op(kind, tuple(args), dt))
        return len(ops) - 1

    def dt_str(torch_dt) -> str:
        if torch_dt not in _DTYPES:
            raise _Unsupported(torch_dt)
        return _DTYPES[torch_dt]

    def cast(i: int, dt: str) -> int:
        if ops[i].dtype == dt:
            return i
        if dt in NARROW and ops[i].kind == "const" and \
                _round(ops[i].args[0], dt) != _round(ops[i].args[0], "f32"):
            raise _Unsupported(dt)   # torch keeps such a constant in f32
        if (i, dt) not in casts:
            casts[(i, dt)] = add("cast", (i,), dt)
        return casts[(i, dt)]

    def operand(x, dt: str, n: int = 1) -> list[int]:
        """Op indices of `x`'s elements cast to `dt`, broadcast to n."""
        if isinstance(x, torch.fx.Node):
            idx = [cast(i, dt) for i in index[x]]
        elif isinstance(x, (bool, int, float)):
            if dt in NARROW and _round(x, dt) != _round(x, "f32"):
                raise _Unsupported(x)
            idx = [add("const", (_round(x, dt),), dt)]
        else:
            raise _Unsupported(x)
        if len(idx) == 1:
            return idx * n
        if len(idx) != n:
            raise _Unsupported(x)
        return idx

    def elem_dim(d: int, nd: int) -> None:
        """The op works on the element axis (dim 1 of a [B, k] value)."""
        if d not in (1, -1) or nd != 2:
            raise _Unsupported(d)

    place = {n: i for i, n in enumerate(tr.placeholders)}
    for node in tr.gm.graph.nodes:
        if node not in tr.needed or node.op == "output":
            continue
        val = node.meta.get("val")
        if node.op == "call_function" and node.target is operator.getitem:
            if node.args[1] != 0 or node.args[0] not in index:
                raise _Unsupported(node)    # max/min's indices
            index[node] = index[node.args[0]]
            continue
        if node.op == "call_function" and node.target in (aten.max.dim,
                                                          aten.min.dim):
            val = val[0]                    # (values, indices)
        if not isinstance(val, torch.Tensor) or val.dim() > 2 or (
                val.dim() >= 1 and val.shape[0] != TRACE_BATCH):
            raise _Unsupported(node)    # one scalar or vector per element
        width = val.shape[1] if val.dim() == 2 else 1
        out_dt = dt_str(val.dtype)
        if node.op == "placeholder":
            src = inputs[place[node]]
            if src is None:
                raise _Unsupported(node)
            index[node] = tuple(add("in", (src[0], src[1] + j), out_dt)
                                for j in range(width))
            continue
        if node.op == "get_attr":
            t = getattr(tr.gm, node.target)
            if t.dim() != 0:
                raise _Unsupported(node)
            index[node] = (add("const", (_round(t.item(), out_dt),), out_dt),)
            continue
        if node.op != "call_function":
            raise _Unsupported(node)
        t, a = node.target, node.args
        kw = dict(node.kwargs)
        if t in _SHAPE_OPS or t in NOOP_OPS or t is aten._to_copy.default or (
                t is aten.permute.default and list(a[1]) == list(
                    range(len(a[1])))):
            r = operand(a[0], out_dt, width)
        elif t is aten.scalar_tensor.default:
            r = [add("const", (_round(a[0], out_dt),), out_dt)]
        elif t is aten.select.int:
            elem_dim(a[1], a[0].meta["val"].dim())
            r = [cast(index[a[0]][a[2]], out_dt)]
        elif t is aten.slice.Tensor:
            elem_dim(a[1] if len(a) > 1 else 0, a[0].meta["val"].dim())
            lo = a[2] if len(a) > 2 and a[2] is not None else 0
            hi = a[3] if len(a) > 3 and a[3] is not None else None
            step = a[4] if len(a) > 4 else 1
            r = [cast(i, out_dt) for i in index[a[0]][slice(lo, hi, step)]]
        elif t in (aten.cat.default, aten.stack.default):
            d = a[1] if len(a) > 1 else 0
            if t is aten.stack.default and d in (1, -1):
                d = 1
            elif t is aten.cat.default:
                elem_dim(d, a[0][0].meta["val"].dim())
            else:
                raise _Unsupported(node)
            r = [i for x in a[0] for i in operand(x, out_dt, len(index[x]))]
        elif t in _BINARY:
            if kw.get("alpha", 1) != 1 or kw.get("rounding_mode") is not None:
                raise _Unsupported(node)
            kind = _BINARY[t]
            x, y = (a[1], a[0]) if kind == "rsub" else (a[0], a[1])
            kind = "sub" if kind == "rsub" else kind
            if (kind == "div" and out_dt not in FLOATS) or (
                    kind == "rem" and out_dt in FLOATS + ("bool",)):
                raise _Unsupported(node)    # int div, float remainder
            r = [add(kind, (i, j), out_dt) for i, j in zip(
                operand(x, out_dt, width), operand(y, out_dt, width))]
        elif t in _COMPARE:
            cdt = dt_str(torch.result_type(*[
                x.meta["val"] if isinstance(x, torch.fx.Node) else x
                for x in a[:2]]))
            r = [add("cmp", (_COMPARE[t], i, j), "bool") for i, j in zip(
                operand(a[0], cdt, width), operand(a[1], cdt, width))]
        elif t in _LOGICAL:
            if out_dt != "bool":
                raise _Unsupported(node)
            r = [add("logic", (_LOGICAL[t], i, j), "bool") for i, j in zip(
                operand(a[0], "bool", width), operand(a[1], "bool", width))]
        elif t in _UNARY:
            kind = _UNARY[t]
            if (kind == "not") != (out_dt == "bool"):
                raise _Unsupported(node)
            r = [add(kind, (i,), out_dt) for i in operand(a[0], out_dt, width)]
        elif t in _MATH:
            kind = _MATH[t]
            if out_dt not in FLOATS:
                if kind not in ("floor", "ceil"):
                    raise _Unsupported(node)
                r = operand(a[0], out_dt, width)   # integer floor: itself
            else:
                r = [add(kind, (i,), out_dt)
                     for i in operand(a[0], out_dt, width)]
        elif t is aten.atan2.default:
            if out_dt not in FLOATS:
                raise _Unsupported(node)
            r = [add("atan2", (i, j), out_dt) for i, j in zip(
                operand(a[0], out_dt, width), operand(a[1], out_dt, width))]
        elif t in _REDUCE:
            src_val = a[0].meta["val"]
            dims = a[1] if len(a) > 1 else kw.get("dim")
            dims = list(dims) if isinstance(dims, (list, tuple)) else [dims]
            kind = _REDUCE[t]
            if src_val.dim() != 2 or [d % 2 for d in dims] != [1] or (
                    kind == "add" and (out_dt in FLOATS or dt_str(
                        src_val.dtype) in FLOATS)):
                raise _Unsupported(node)    # float sums: see the docstring
            terms = operand(a[0], out_dt, src_val.shape[1])
            acc = terms[0]
            for j in terms[1:]:
                acc = add(kind, (acc, j), out_dt)
            r = [acc]
        elif t is aten.argmax.default:
            src_val = a[0].meta["val"]
            d = a[1] if len(a) > 1 else kw.get("dim")
            sdt = dt_str(src_val.dtype)
            if src_val.dim() != 2 or d is None or d % 2 != 1 or \
                    (a[2] if len(a) > 2 else kw.get("keepdim", False)) or \
                    sdt == "bool":
                raise _Unsupported(node)
            # a chain over the k terms: a later term wins only when strictly
            # greater, so the first largest index stays; a float NaN beats
            # any number and the first NaN stays, as torch decides
            terms = index[a[0]]
            best, at = terms[0], add("const", (0,), out_dt)
            for j, x in enumerate(terms[1:], 1):
                win = add("cmp", (">", x, best), "bool")
                if sdt in FLOATS:
                    nan_over_num = add("logic", (
                        "&&", add("cmp", ("!=", x, x), "bool"),
                        add("cmp", ("==", best, best), "bool")), "bool")
                    win = add("logic", ("||", win, nan_over_num), "bool")
                best = add("where", (win, x, best), sdt)
                at = add("where", (win, add("const", (j,), out_dt), at),
                         out_dt)
            r = [at]
        elif t is aten.pow.Tensor_Scalar:
            if out_dt not in FLOATS or not isinstance(a[1], (int, float)) \
                    or (out_dt in NARROW and float(a[1]) not in POW_SPECIAL):
                raise _Unsupported(node)
            r = [add("pow", (i, float(a[1])), out_dt)
                 for i in operand(a[0], out_dt, width)]
        elif t in _CLAMP:
            lo_at, hi_at = _CLAMP[t]
            lo = kw.get("min", a[lo_at] if lo_at is not None and
                        len(a) > lo_at else None)
            hi = kw.get("max", a[hi_at] if hi_at is not None and
                        len(a) > hi_at else None)
            r = operand(a[0], out_dt, width)
            if lo is not None:
                r = [add("max", (i, j), out_dt)
                     for i, j in zip(r, operand(lo, out_dt, width))]
            if hi is not None:
                r = [add("min", (i, j), out_dt)
                     for i, j in zip(r, operand(hi, out_dt, width))]
        elif t is aten.where.self:
            r = [add("where", (c, i, j), out_dt) for c, i, j in zip(
                operand(a[0], "bool", width), operand(a[1], out_dt, width),
                operand(a[2], out_dt, width))]
        else:
            raise _Unsupported(node)
        if len(r) != width:
            raise _Unsupported(node)
        index[node] = tuple(r)
    outs = []
    for node, spec in zip(tr.out_nodes(), tr.out_leaves):
        if len(spec.shape) > 1:
            raise _Unsupported(node)
        outs += operand(node, dt_str(spec.dtype), _width(spec.shape))
    return IR(ops=tuple(ops), outputs=tuple(outs))


# ----------------------------------------------------------------- CUDA C
def c_const(value, dt: str) -> str:
    """Exact C literal of a constant in its dtype."""
    if dt == "bool":
        return "true" if value else "false"
    if dt in ("f32",) + NARROW:
        bits = struct.unpack("<I", struct.pack("<f", value))[0]
        return f"__int_as_float(0x{bits:08x})"
    if dt == "f64":
        bits = struct.unpack("<Q", struct.pack("<d", value))[0]
        return f"__longlong_as_double(0x{bits:016x}LL)"
    if value == -(2**31) and dt == "i32":
        return "(-2147483647 - 1)"
    if dt == "i64":
        return f"({int(value)}LL)" if value != -(2**63) else \
            "(-9223372036854775807LL - 1)"
    return f"(({C_TYPE[dt]}){int(value)})"


# the kernels' REDUCE(a, b) macro per reduce
REDUCE_C = {"sum": "((a) + (b))", "min": "fminf((a), (b))",
            "max": "fmaxf((a), (b))"}

PRELUDE = r"""
#include <cuda_bf16.h>
#include <cuda_fp16.h>
__device__ __forceinline__ float udf_minf(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b); }
__device__ __forceinline__ float udf_maxf(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b); }
__device__ __forceinline__ double udf_mind(double a, double b) {
  return (a != a || b != b) ? __longlong_as_double(0x7ff8000000000000LL) : fmin(a, b); }
__device__ __forceinline__ double udf_maxd(double a, double b) {
  return (a != a || b != b) ? __longlong_as_double(0x7ff8000000000000LL) : fmax(a, b); }
__device__ __forceinline__ float udf_bf16(float a) {
  return __bfloat162float(__float2bfloat16_rn(a)); }
__device__ __forceinline__ float udf_f16(float a) {
  return __half2float(__float2half_rn(a)); }
"""

# accurate libm calls of the math ops (f32 name, f64 name); never the
# __expf-style intrinsics
_LIBM = {"exp": ("expf", "exp"), "log": ("logf", "log"),
         "log1p": ("log1pf", "log1p"), "expm1": ("expm1f", "expm1"),
         "sqrt": ("sqrtf", "sqrt"), "rsqrt": ("rsqrtf", "rsqrt"),
         "tanh": ("tanhf", "tanh"), "sin": ("sinf", "sin"),
         "cos": ("cosf", "cos"), "atan": ("atanf", "atan"),
         "floor": ("floorf", "floor"),
         "ceil": ("ceilf", "ceil")}
# exponents that torch's pow computes by another op (the rest call powf)
POW_SPECIAL = (2.0, 3.0, -2.0, 0.5, -0.5, -1.0)


def _math_c(kind: str, x: str, dt: str, arg=None) -> str:
    """C expression of a float math op on `x` computed in f32 (f64 for
    f64); narrow dtypes round the f32 result afterwards (emit)."""
    d = dt == "f64"
    one = "1.0" if d else "1.0f"
    if kind in _LIBM:
        return f"{_LIBM[kind][d]}({x})"
    if kind == "reciprocal":
        return f"({one} / {x})"
    if kind == "sigmoid":
        return f"({one} / ({one} + {_LIBM['exp'][d]}(-{x})))"
    if kind == "pow":
        special = {2.0: f"({x} * {x})", 3.0: f"({x} * {x} * {x})",
                   -2.0: f"({one} / ({x} * {x}))",
                   0.5: _math_c("sqrt", x, dt), -0.5: _math_c("rsqrt", x, dt),
                   -1.0: f"({one} / {x})"}
        if arg in special:
            return special[arg]
        return f"{'pow' if d else 'powf'}({x}, {c_const(arg, 'f64' if d else 'f32')})"
    raise ValueError(kind)


def emit(ir: IR, load: Callable[[str, int, str], str],
         prefix: str) -> tuple[list[str], list[str]]:
    """C statements computing the IR, one `const T <prefix>N` per op, and
    the C expression of each output.  `load(array, col, dtype)` gives the
    C expression of an input."""
    lines = []
    v = [f"{prefix}{i}" for i in range(len(ir.ops))]
    for i, op in enumerate(ir.ops):
        a, dt = op.args, op.dtype
        ct = C_TYPE[dt]
        if op.kind == "in":
            e = load(a[0], a[1], dt)
        elif op.kind == "const":
            e = c_const(a[0], dt)
        elif op.kind == "cast":
            src = ir.ops[a[0]].dtype
            e = (f"({v[a[0]]} != 0)" if dt == "bool" and src != "bool"
                 else f"({ct})({v[a[0]]})")
        elif op.kind in ("add", "sub", "mul", "div"):
            sym = {"add": "+", "sub": "-", "mul": "*", "div": "/"}[op.kind]
            e = f"({v[a[0]]} {sym} {v[a[1]]})"
        elif op.kind == "rem":
            # C's % truncates; floor semantics add the divisor to a nonzero
            # remainder whose sign differs from it
            x, y = v[a[0]], v[a[1]]
            e = (f"({ct})((({x} % {y}) != 0 && ((({x} % {y}) < 0) != "
                 f"({y} < 0))) ? ({x} % {y}) + {y} : ({x} % {y}))")
        elif op.kind in ("min", "max"):
            if dt in FLOATS:
                fn = f"udf_{op.kind}{'d' if dt == 'f64' else 'f'}"
                e = f"{fn}({v[a[0]]}, {v[a[1]]})"
            else:
                sym = "<" if op.kind == "min" else ">"
                e = f"({v[a[0]]} {sym} {v[a[1]]} ? {v[a[0]]} : {v[a[1]]})"
        elif op.kind == "cmp":
            e = f"({v[a[1]]} {a[0]} {v[a[2]]})"
        elif op.kind == "logic":
            e = f"({v[a[1]]} {a[0]} {v[a[2]]})"
        elif op.kind == "neg":
            e = f"({ct})(-{v[a[0]]})"
        elif op.kind == "abs":
            e = {"f32": f"fabsf({v[a[0]]})", "f64": f"fabs({v[a[0]]})"}.get(
                "f32" if dt in NARROW else dt,
                f"({ct})({v[a[0]]} < 0 ? -{v[a[0]]} : {v[a[0]]})")
        elif op.kind == "sign":
            e = f"({ct})((0 < {v[a[0]]}) - ({v[a[0]]} < 0))"
        elif op.kind == "not":
            e = f"(!{v[a[0]]})"
        elif op.kind == "where":
            e = f"({v[a[0]]} ? {v[a[1]]} : {v[a[2]]})"
        elif op.kind == "atan2":
            fn = "atan2" if dt == "f64" else "atan2f"
            e = f"{fn}({v[a[0]]}, {v[a[1]]})"
        elif op.kind in _LIBM or op.kind in ("reciprocal", "sigmoid", "pow"):
            e = _math_c(op.kind, v[a[0]], dt, a[1] if len(a) > 1 else None)
        else:
            raise ValueError(op.kind)
        if dt in NARROW and op.kind not in ("in", "const", "cmp", "logic",
                                            "where", "not"):
            e = f"udf_{dt}({e})"
        lines.append(f"const {ct} {v[i]} = {e};")
    return lines, [v[o] for o in ir.outputs]


# ----------------------------------------------------------- torch evaluate
_TORCH_MATH = {"exp": torch.exp, "log": torch.log, "log1p": torch.log1p,
               "expm1": torch.expm1, "sqrt": torch.sqrt, "rsqrt": torch.rsqrt,
               "reciprocal": torch.reciprocal, "tanh": torch.tanh,
               "sigmoid": torch.sigmoid, "sin": torch.sin, "cos": torch.cos,
               "atan": torch.atan,
               "floor": torch.floor, "ceil": torch.ceil, "sign": torch.sign,
               "neg": torch.neg, "abs": torch.abs,
               "not": torch.logical_not}


def evaluate(ir: IR, load: Callable[[str, int, torch.dtype], torch.Tensor],
             device=None) -> list[torch.Tensor]:
    """Run the IR with torch ops on `device`; `load(array, col, dtype)`
    returns an input column.  Constants are 0-d and broadcast against the
    loaded columns."""
    v: list[torch.Tensor] = []
    for op in ir.ops:
        a, dt = op.args, TORCH_DTYPE[op.dtype]
        if op.kind == "in":
            r = load(a[0], a[1], dt)
        elif op.kind == "const":
            r = torch.tensor(a[0], dtype=dt, device=device)
        elif op.kind == "cast":
            r = v[a[0]].to(dt)
        elif op.kind in ("add", "sub", "mul", "div", "min", "max", "atan2",
                         "rem"):
            fn = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
                  "div": torch.div, "min": torch.minimum,
                  "max": torch.maximum, "atan2": torch.atan2,
                  "rem": torch.remainder}[op.kind]
            r = fn(v[a[0]], v[a[1]])
        elif op.kind == "cmp":
            r = {">": torch.gt, ">=": torch.ge, "<": torch.lt, "<=": torch.le,
                 "==": torch.eq, "!=": torch.ne}[a[0]](v[a[1]], v[a[2]])
        elif op.kind == "logic":
            r = {"&&": torch.logical_and, "||": torch.logical_or,
                 "!=": torch.logical_xor}[a[0]](v[a[1]], v[a[2]])
        elif op.kind in _TORCH_MATH:
            r = _TORCH_MATH[op.kind](v[a[0]])
        elif op.kind == "pow":
            r = torch.pow(v[a[0]], a[1])
        elif op.kind == "where":
            r = torch.where(v[a[0]], v[a[1]], v[a[2]])
        else:
            raise ValueError(op.kind)
        v.append(r)
    return [v[o] for o in ir.outputs]

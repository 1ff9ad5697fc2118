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
comparisons, logical ops, casts (`_to_copy`), constants, and the
value-preserving view ops as no-ops, on scalar leaves.  Anything else makes
`lower` return None and the engine plans the unfused path.

Exactness rules the emitted C keeps: float constants are written as the
exact bit pattern of the f32 (`__int_as_float(0x...)`), every op rounds on
its own (the build passes --fmad=false, so `a + b * c` never contracts into
an FMA), and integers stay in integer registers.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Callable

import numpy as np
import torch

from ..core.analysis import NOOP_OPS, TRACE_BATCH, Traced

aten = torch.ops.aten

_DTYPES = {torch.float32: "f32", torch.float64: "f64", torch.int32: "i32",
           torch.int64: "i64", torch.int16: "i16", torch.int8: "i8",
           torch.uint8: "u8", torch.bool: "bool"}
TORCH_DTYPE = {v: k for k, v in _DTYPES.items()}
C_TYPE = {"f32": "float", "f64": "double", "i32": "int", "i64": "long long",
          "i16": "short", "i8": "signed char", "u8": "unsigned char",
          "bool": "bool"}

_BINARY = {
    aten.add.Tensor: "add", aten.add.Scalar: "add",
    aten.sub.Tensor: "sub", aten.sub.Scalar: "sub",
    aten.rsub.Tensor: "rsub", aten.rsub.Scalar: "rsub",
    aten.mul.Tensor: "mul", aten.mul.Scalar: "mul",
    aten.div.Tensor: "div", aten.div.Scalar: "div",
    aten.minimum.default: "min", aten.maximum.default: "max",
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
          aten.logical_not.default: "not", aten.bitwise_not.default: "not"}


@dataclasses.dataclass(frozen=True)
class Op:
    """One scalar op.  kind/args:
      in      (array, col)        load of column `col` of input `array`
      const   (value,)            python value, already rounded to dtype
      cast    (a,)
      add|sub|mul|div|min|max (a, b)   computed in this op's dtype
      cmp     (symbol, a, b)      operands already cast to the promoted type
      logic   (symbol, a, b)      on bools
      neg|abs|not (a,)
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
    if dt.startswith("f"):
        return float(np.float32(value)) if dt == "f32" else float(value)
    return int(value)


def lower(tr: Traced, inputs: list) -> IR | None:
    """Lower a traced UDF to an IR.  `inputs[i]` is the (array, col) the
    i-th flat placeholder loads from, or None where the caller cannot
    supply it (join-eliminated side): referencing such an input fails the
    lowering.  Returns None for any op outside the supported set."""
    try:
        return _lower(tr, inputs)
    except _Unsupported:
        return None


def _lower(tr: Traced, inputs: list) -> IR:
    ops: list[Op] = []
    index: dict = {}

    def add(kind, args, dt) -> int:
        ops.append(Op(kind, tuple(args), dt))
        return len(ops) - 1

    def dt_str(torch_dt) -> str:
        if torch_dt not in _DTYPES:
            raise _Unsupported(torch_dt)
        return _DTYPES[torch_dt]

    def operand(x, dt: str) -> int:
        """Op index of `x` cast to `dt` (python scalars become constants)."""
        if isinstance(x, torch.fx.Node):
            i = index[x]
            return i if ops[i].dtype == dt else add("cast", (i,), dt)
        if isinstance(x, (bool, int, float)):
            return add("const", (_round(x, dt),), dt)
        raise _Unsupported(x)

    place = {n: i for i, n in enumerate(tr.placeholders)}
    for node in tr.gm.graph.nodes:
        if node not in tr.needed or node.op == "output":
            continue
        val = node.meta.get("val")
        if node.op == "placeholder":
            src = inputs[place[node]]
            if src is None:
                raise _Unsupported(node)
            index[node] = add("in", src, dt_str(val.dtype))
            continue
        if node.op == "get_attr":
            t = getattr(tr.gm, node.target)
            if t.dim() != 0:
                raise _Unsupported(node)
            index[node] = add("const", (_round(t.item(), dt_str(t.dtype)),),
                              dt_str(t.dtype))
            continue
        if node.op != "call_function" or not isinstance(val, torch.Tensor):
            raise _Unsupported(node)
        if val.dim() > 1 or (val.dim() == 1 and val.shape[0] != TRACE_BATCH):
            raise _Unsupported(node)      # only scalar-per-element values
        out_dt = dt_str(val.dtype)
        t, a = node.target, node.args
        kw = dict(node.kwargs)
        if t in NOOP_OPS:
            index[node] = operand(a[0], out_dt)
        elif t is aten._to_copy.default:
            index[node] = operand(a[0], out_dt)
        elif t is aten.scalar_tensor.default:
            index[node] = add("const", (_round(a[0], out_dt),), out_dt)
        elif t in _BINARY:
            if kw.get("alpha", 1) != 1 or kw.get("rounding_mode") is not None:
                raise _Unsupported(node)
            kind = _BINARY[t]
            x, y = (a[1], a[0]) if kind == "rsub" else (a[0], a[1])
            kind = "sub" if kind == "rsub" else kind
            if kind == "div" and not out_dt.startswith("f"):
                raise _Unsupported(node)
            index[node] = add(kind, (operand(x, out_dt), operand(y, out_dt)),
                              out_dt)
        elif t in _COMPARE:
            cdt = dt_str(torch.result_type(*[
                x.meta["val"] if isinstance(x, torch.fx.Node) else x
                for x in a[:2]]))
            index[node] = add("cmp", (_COMPARE[t], operand(a[0], cdt),
                                      operand(a[1], cdt)), "bool")
        elif t in _LOGICAL:
            if out_dt != "bool":
                raise _Unsupported(node)
            index[node] = add("logic", (_LOGICAL[t], operand(a[0], "bool"),
                                        operand(a[1], "bool")), "bool")
        elif t in _UNARY:
            kind = _UNARY[t]
            if kind == "not" and out_dt != "bool":
                raise _Unsupported(node)
            index[node] = add(kind, (operand(a[0], out_dt),), out_dt)
        elif t is aten.where.self:
            index[node] = add("where", (operand(a[0], "bool"),
                                        operand(a[1], out_dt),
                                        operand(a[2], out_dt)), out_dt)
        else:
            raise _Unsupported(node)
    outs = []
    for node, spec in zip(tr.out_nodes(), tr.out_leaves):
        if spec.shape != ():
            raise _Unsupported(node)
        outs.append(operand(node, dt_str(spec.dtype)))
    return IR(ops=tuple(ops), outputs=tuple(outs))


# ----------------------------------------------------------------- CUDA C
def c_const(value, dt: str) -> str:
    """Exact C literal of a constant in its dtype."""
    if dt == "bool":
        return "true" if value else "false"
    if dt == "f32":
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
__device__ __forceinline__ float udf_minf(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b); }
__device__ __forceinline__ float udf_maxf(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b); }
__device__ __forceinline__ double udf_mind(double a, double b) {
  return (a != a || b != b) ? __longlong_as_double(0x7ff8000000000000LL) : fmin(a, b); }
__device__ __forceinline__ double udf_maxd(double a, double b) {
  return (a != a || b != b) ? __longlong_as_double(0x7ff8000000000000LL) : fmax(a, b); }
"""


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
        elif op.kind in ("min", "max"):
            if dt in ("f32", "f64"):
                fn = f"udf_{op.kind}{'f' if dt == 'f32' else 'd'}"
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
                dt, f"({ct})({v[a[0]]} < 0 ? -{v[a[0]]} : {v[a[0]]})")
        elif op.kind == "not":
            e = f"(!{v[a[0]]})"
        elif op.kind == "where":
            e = f"({v[a[0]]} ? {v[a[1]]} : {v[a[2]]})"
        else:
            raise ValueError(op.kind)
        lines.append(f"const {ct} {v[i]} = {e};")
    return lines, [v[o] for o in ir.outputs]


# ----------------------------------------------------------- torch evaluate
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
        elif op.kind in ("add", "sub", "mul", "div", "min", "max"):
            fn = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
                  "div": torch.div, "min": torch.minimum,
                  "max": torch.maximum}[op.kind]
            r = fn(v[a[0]], v[a[1]])
        elif op.kind == "cmp":
            r = {">": torch.gt, ">=": torch.ge, "<": torch.lt, "<=": torch.le,
                 "==": torch.eq, "!=": torch.ne}[a[0]](v[a[1]], v[a[2]])
        elif op.kind == "logic":
            r = {"&&": torch.logical_and, "||": torch.logical_or,
                 "!=": torch.logical_xor}[a[0]](v[a[1]], v[a[2]])
        elif op.kind == "neg":
            r = torch.neg(v[a[0]])
        elif op.kind == "abs":
            r = torch.abs(v[a[0]])
        elif op.kind == "not":
            r = torch.logical_not(v[a[0]])
        elif op.kind == "where":
            r = torch.where(v[a[0]], v[a[1]], v[a[2]])
        else:
            raise ValueError(op.kind)
        v.append(r)
    return [v[o] for o in ir.outputs]

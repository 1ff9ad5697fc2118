"""The fused Pregel apply on the GPU: wrapper of csrc/apply.cu.

Replaces `src/repro/kernels/superstep.py:fused_apply` (pallas_call at
:179, body `_make_apply_kernel` :46).  One CTA owns `plan().vb`
consecutive home slots of one partition q.  For each source partition pe
in ascending order it walks that partition's span of the route
(`apply_rng`, `kernels/applyroute.py`), EPT entries a thread in one round
of loads, and combines the live routed rows into an accumulator in shared
memory; then each thread loads the state of its VB / THREADS slots in one
round, substitutes the default message in each leaf's own dtype, runs the
generated vprog, keeps invisible rows' old bits and derives the changed
bit (packed inequality, or the generated `changed_fn`).  Message and vertex
leaves are read where they lie, one pointer a leaf in its own dtype; a
leaf the vprog passes through is not written (the new pytree holds the old
tensor).  Memory bounds it: the live route entries, their flags and rows,
the state columns the vprog and the changed test read, the columns
written and one changed byte a slot.

On a CPU tensor the wrapper runs the plain version (`kernels/ref.py`); on a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import build, ref, udf
from .applyroute import APPLY_GRAN

_ARGTYPES = [ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_int] * 5 + [
    ctypes.c_void_p]

plain = ref.fused_apply

SMEM_LIMIT = 232448            # 227 KB: the most a CTA can have on an H100
MAX_P = 128                    # source partitions the CTA's span table holds
VB_MAX = 1024                  # home slots a CTA owns at most
THREADS = 256                  # threads a CTA (fewer when it owns fewer slots)
EPT = 2                        # route entries a thread loads in one round
# widest message row a CTA of APPLY_GRAN slots holds in shared memory
MAX_DM = ((SMEM_LIMIT - 8 * MAX_P) // APPLY_GRAN - 1) // 4

# storage type of a leaf element and its load as f32 (message leaves may
# be bf16/f16; the plan gives the kernel f32 or int state, stored by a cast)
_STORE = {"f32": "float", "bf16": "__nv_bfloat16", "f16": "__half",
          "i32": "int", "i16": "short", "i8": "signed char",
          "u8": "unsigned char"}
_TO_F32 = {"f32": "({})", "bf16": "__bfloat162float({})",
           "f16": "__half2float({})"}


def _width(shape: tuple) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def _columns(leaves) -> list[tuple[int, int, int, str]]:
    """(leaf, first packed column, width, dtype) of each leaf."""
    out, col = [], 0
    for l, (dt, shape) in enumerate(leaves):
        out.append((l, col, _width(shape), dt))
        col += _width(shape)
    return out


@dataclasses.dataclass(frozen=True)
class ApplyUdf:
    """The apply half as the kernel runs it.

    vprog: IR with inputs ("vid", 0), ("x", col) state columns (each leaf
    staged through f32, then cast to the vprog's dtype) and ("m", col)
    combined message columns; one output per state column.
    changed: IR with inputs ("x", col) old and ("new", col) new state
    columns and one bool output, or None for packed inequality.
    msg_dtypes / defaults: per message column, the dtype the vprog sees
    (udf dtype string) and the static default substituted where no
    message arrived.
    msgs / state: per routed message leaf and per vertex leaf, its udf
    dtype string and element shape."""

    vprog: udf.IR
    changed: udf.IR | None
    msg_dtypes: tuple[str, ...]
    defaults: tuple
    msgs: tuple[tuple[str, tuple], ...]
    state: tuple[tuple[str, tuple], ...]

    @property
    def dm(self) -> int:
        return sum(_width(sh) for _, sh in self.msgs)

    @property
    def dv(self) -> int:
        return sum(_width(sh) for _, sh in self.state)

    @functools.cached_property
    def column_leaf(self) -> dict[int, tuple[int, int, int, str]]:
        """State column -> (leaf, its first column, width, dtype)."""
        return {c: (l, c0, w, dt) for l, c0, w, dt in _columns(self.state)
                for c in range(c0, c0 + w)}

    @functools.cached_property
    def written(self) -> tuple[bool, ...]:
        """Per vertex leaf: does the vprog compute it?  A leaf whose every
        output is its own ("x", col) input in its own dtype is passed
        through, neither written nor copied."""
        ops, outs = self.vprog.ops, self.vprog.outputs
        return tuple(any(
            ops[outs[c]].kind != "in" or ops[outs[c]].args != ("x", c)
            or ops[outs[c]].dtype != dt for c in range(c0, c0 + w))
            for _, c0, w, dt in _columns(self.state))

    @functools.cached_property
    def reads(self) -> frozenset:
        """State columns the kernel reads on every row: the vprog's inputs,
        and the changed test's (packed inequality: every written column
        and, for the NaN test, every float column passed through)."""
        leaf = self.column_leaf
        ops = self.vprog.ops
        need = _needed(ops, [o for c, o in enumerate(self.vprog.outputs)
                             if self.written[leaf[c][0]]])
        got = {ops[i].args[1] for i in need
               if ops[i].kind == "in" and ops[i].args[0] == "x"}
        if self.changed is None:
            got |= {c for c, (l, _, _, dt) in leaf.items()
                    if self.written[l] or dt in udf.FLOATS}
        else:
            got |= {op.args[1] for op in self.changed.ops if op.kind == "in"
                    and (op.args[0] == "x"
                         or not self.written[leaf[op.args[1]][0]])}
        return frozenset(got)

    @property
    def reads_vid(self) -> bool:
        return any(op.kind == "in" and op.args[0] == "vid"
                   for op in self.vprog.ops)


def _needed(ops, roots) -> set[int]:
    """Indices of the ops the roots depend on (themselves included)."""
    seen, stack = set(), list(roots)
    while stack:
        i = stack.pop()
        if i in seen:
            continue
        seen.add(i)
        op = ops[i]
        if op.kind in ("in", "const"):
            continue
        args = (op.args[1:] if op.kind in ("cmp", "logic")
                else op.args[:1] if op.kind == "pow" else op.args)
        stack.extend(args)
    return seen


@dataclasses.dataclass(frozen=True)
class Plan:
    """CTA shape of the apply kernel.  vb: home slots a CTA owns (a
    multiple of APPLY_GRAN and of threads); threads; lanes: threads that
    share one route entry's row in the combine; stride: f32 words per
    accumulator row in shared memory (odd, so a column read across a warp
    hits 32 banks); smem: dynamic shared memory bytes, the accumulator and
    a hit byte a slot (the launch adds 8 B a source partition for the span
    table)."""

    vb: int
    threads: int
    lanes: int
    stride: int
    smem: int

    def grid(self, nl: int, v_blk: int) -> tuple[int, int]:
        """(CTAs along the home slots, partitions)."""
        return -(-v_blk // self.vb), nl


def plan(dm: int, dv: int) -> Plan:
    """The CTA shape for message rows of dm f32 columns and dv state
    columns: as many home slots as fit 227 KB of shared memory beside a
    span table of MAX_P partitions, at most VB_MAX (half that for rows of
    more than 64 columns, whose threads hold more registers), THREADS
    threads or one a slot.  VB is a whole number of granules of
    APPLY_GRAN and, past THREADS, of THREADS (the kernel gives each thread
    VB / THREADS slots)."""
    if not 1 <= dm <= MAX_DM:
        raise ValueError(f"apply: message width {dm} outside [1, {MAX_DM}]")
    stride = dm | 1
    per_slot = 4 * stride + 1
    cap = VB_MAX if dm + dv <= 64 else VB_MAX // 2
    vb = min(cap, (SMEM_LIMIT - 8 * MAX_P) // per_slot // APPLY_GRAN
             * APPLY_GRAN)
    if vb > THREADS:            # THREADS is a whole number of granules
        vb -= vb % THREADS
    return Plan(vb=vb, threads=min(THREADS, vb),
                lanes=min(32, 1 << (dm - 1).bit_length()), stride=stride,
                smem=-(-vb * per_slot // 16) * 16)


def _msg_col(spec: ApplyUdf) -> list[str]:
    """Body of msg_col(a, r, c): column c of routed row r, as f32."""
    lines = []
    for l, c0, w, dt in _columns(spec.msgs):
        load = _TO_F32.get(dt, "(float)({})").format(
            f"((const {_STORE[dt]}*)a.m[{l}])[r * {w} + (c - {c0})]")
        lines.append(f"if (c < {c0 + w}) return {load};")
    lines.append("return 0.0f;")
    return lines


def _raw(spec: ApplyUdf, c: int) -> str:
    """C expression of state column c of slot s, in its leaf's dtype."""
    l, c0, w, dt = spec.column_leaf[c]
    return f"((const {_STORE[dt]}*)a.x[{l}])[s * {w} + {c - c0}]"


def _f32(spec: ApplyUdf, c: int) -> str:
    """State column c of slot s, staged to f32."""
    return _TO_F32.get(spec.column_leaf[c][3], "(float)({})").format(
        _raw(spec, c))


def _loads(spec: ApplyUdf) -> list[str]:
    """The state each of a thread's SPT slots reads, in one round: the mask,
    the columns in `reads` (staged to f32) and vid if the vprog reads it."""
    regs = [("bool", "vmr", "a.vmask[s] != 0", "false")]
    regs += [("float", f"xr{c}", _f32(spec, c), "0.0f")
             for c in sorted(spec.reads)]
    if spec.reads_vid:
        regs.append(("int", "vidr", "a.vid[s]", "0"))
    lines = [f"{t} {n}[SPT];" for t, n, _, _ in regs]
    lines += ["#pragma unroll", "for (int u = 0; u < SPT; ++u) {",
              "  const int i = threadIdx.x + u * THREADS;",
              "  const long long s = (long long)q * a.v_blk + v0 + i;"]
    lines += [f"  {n}[u] = i < nv ? {e} : {z};" for _, n, e, z in regs]
    return lines + ["}"]


def _slot_body(spec: ApplyUdf) -> list[str]:
    """Per home slot s (the u-th of the thread): messages, vprog, changed,
    stores."""
    ct = udf.C_TYPE
    leaf = spec.column_leaf
    body = ["const bool vm = vmr[u];"]
    for c, (dt, dflt) in enumerate(zip(spec.msg_dtypes, spec.defaults)):
        body.append(f"const {ct[dt]} m{c} = exists ? ({ct[dt]})(acc[{c}]) "
                    f": {udf.c_const(dflt, dt)};")
    body += [f"const float x{c} = xr{c}[u];" for c in sorted(spec.reads)]

    def load_vp(arr, col, dt):
        if arr == "vid":
            return f"({ct[dt]})(vidr[u])"
        if arr == "m":
            return f"({ct[dt]})(m{col})"
        # a column outside `reads` feeds only outputs of leaves passed
        # through, which are not stored: its load is dead code
        x = f"x{col}" if col in spec.reads else _f32(spec, col)
        return f"({ct[dt]})({x})"

    lines, outs = udf.emit(spec.vprog, load_vp, "vp")
    body += lines
    written = [c for c in range(spec.dv) if spec.written[leaf[c][0]]]
    body += [f"const float n{c} = (float)({outs[c]});" for c in written]
    body.append("bool chg = false;")
    if spec.changed is None:
        for c in range(spec.dv):
            if c in written:
                body.append(f"chg = chg || (n{c} != x{c});")
            elif leaf[c][3] in udf.FLOATS:  # a float passed through: NaN
                body.append(f"chg = chg || (x{c} != x{c});")
    else:
        def load_ch(arr, col, dt):
            v = "n" if arr == "new" and col in written else "x"
            return f"({ct[dt]})({v}{col})"
        lines, (out,) = udf.emit(spec.changed, load_ch, "cf")
        body += lines + [f"chg = (bool)({out});"]
    for c in written:
        l, c0, w, dt = leaf[c]
        body.append(f"{{ {_STORE[dt]}* o = ({_STORE[dt]}*)a.o[{l}]; "
                    f"if (vm) o[s * {w} + {c - c0}] = ({_STORE[dt]})(n{c}); "
                    f"else o[s * {w} + {c - c0}] = {_raw(spec, c)}; }}")
    body.append("a.changed[s] = (unsigned char)(chg && vm);")
    return body


@functools.lru_cache(maxsize=256)
def source(spec: ApplyUdf, reduce: str) -> str:
    """CUDA source of the kernel specialised to this vprog, its leaves'
    layout and the reduce."""
    pl = plan(spec.dm, spec.dv)
    gen = [f"#define DM {spec.dm}", f"#define VB {pl.vb}",
           f"#define THREADS {pl.threads}", f"#define LANES {pl.lanes}",
           f"#define EPT {EPT}",
           f"#define STRIDE {pl.stride}", f"#define SMEM {pl.smem}",
           f"#define NMSG {len(spec.msgs)}", f"#define NSTATE {len(spec.state)}",
           f"#define IDENT {udf.c_const(ref.REDUCE_IDENTITY[reduce], 'f32')}",
           f"#define REDUCE(a, b) {udf.REDUCE_C[reduce]}", udf.PRELUDE]
    return (build.template("apply")
            .replace("//@GENERATED@", "\n".join(gen))
            .replace("//@MSGCOL@", "\n  ".join(_msg_col(spec)))
            .replace("//@LOADS@", "\n  ".join(_loads(spec)))
            .replace("//@APPLY@", "\n    ".join(_slot_body(spec))))


def fused_apply(msgs, rflags, send, rng, xs, vid, vmask, spec: ApplyUdf, *,
                reduce: str = "sum"):
    """Arguments and results as `kernels.ref.fused_apply`."""
    if vid.device.type != "cuda":
        return plain(msgs, rflags, send, rng, xs, vid, vmask, spec,
                     reduce=reduce)
    lib = build.load("apply", source(spec, reduce), _ARGTYPES)
    return _launch(lib, msgs, rflags, send, rng, xs, vid, vmask, spec)


def _launch(lib, msgs, rflags, send, rng, xs, vid, vmask, spec: ApplyUdf):
    """Check the arguments, allocate the written leaves and `changed`, and
    launch the kernel of `lib`, a build of `source(spec, ...)`."""
    nl, p, k = send.shape
    v_blk = vid.shape[1]
    if p > MAX_P:
        raise ValueError(f"apply: {p} source partitions, at most {MAX_P}")
    check = functools.partial(build.check_arg, "apply")
    check(send, torch.int32, (nl, p, k), "send")
    check(rflags, torch.bool, (nl, p, k), "rflags")
    check(rng, torch.int32, (nl, p, -(-v_blk // APPLY_GRAN) + 1), "rng")
    for l, (m, (dt, shape)) in enumerate(zip(msgs, spec.msgs, strict=True)):
        check(m, udf.TORCH_DTYPE[dt], (nl, p, k) + shape, f"message leaf {l}")
    for l, (x, (dt, shape)) in enumerate(zip(xs, spec.state, strict=True)):
        check(x, udf.TORCH_DTYPE[dt], (nl, v_blk) + shape, f"vertex leaf {l}")
    check(vid, torch.int32, (nl, v_blk), "vid")
    check(vmask, torch.bool, (nl, v_blk), "vmask")
    outs = [torch.empty_like(x) if w else None
            for x, w in zip(xs, spec.written)]
    chg = torch.empty((nl, v_blk), dtype=torch.bool, device=vid.device)
    ptrs = [send, rflags, rng, vid, vmask, chg, *msgs, *xs, *outs]
    arr = (ctypes.c_void_p * len(ptrs))(
        *[None if t is None else t.data_ptr() for t in ptrs])
    err = lib.launch(arr, nl, p, k, v_blk, rng.shape[2], build.stream())
    build.check(err, "apply")
    fused_apply.launches += 1
    return [x if o is None else o for x, o in zip(xs, outs)], chg


fused_apply.launches = 0

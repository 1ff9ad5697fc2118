"""The fused Pregel apply on the GPU: wrapper of csrc/apply.cu.

Replaces `src/repro/kernels/superstep.py:fused_apply` (pallas_call at
:179).  One thread per home slot combines its routed aggregates in
ascending source-partition order through the inverse route
(`apply_inv[q, v, pe]` = the entry j of source partition pe's route that
carries home row v, or -1), substitutes the default message in each leaf's
own dtype, runs the generated vprog, selects on visibility and derives the
changed bit (packed inequality, or the generated `changed_fn`).  Memory
bounds it: P inverse-route entries, the live routed rows and the state row
in, the new state row and changed flag out.

On a CPU tensor the wrapper runs the plain version (`kernels/ref.py`); on a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import build, ref, udf

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3

plain = ref.fused_apply


@dataclasses.dataclass(frozen=True)
class ApplyUdf:
    """The apply half as the kernel runs it.

    vprog: IR with inputs ("vid", 0), ("x", col) packed state columns and
    ("m", leaf) combined messages; one output per state column.
    changed: IR with inputs ("x", col) old and ("new", col) new state
    columns and one bool output, or None for packed inequality.
    msg_dtypes / defaults: per message leaf, its dtype (udf dtype string)
    and the static default substituted where no message arrived."""

    vprog: udf.IR
    changed: udf.IR | None
    msg_dtypes: tuple[str, ...]
    defaults: tuple
    dm: int
    dv: int


@functools.lru_cache(maxsize=256)
def source(spec: ApplyUdf, reduce: str) -> str:
    """CUDA source of the kernel specialised to this vprog and reduce."""
    ct = udf.C_TYPE
    body = []
    for l, (dt, dflt) in enumerate(zip(spec.msg_dtypes, spec.defaults)):
        body.append(f"const {ct[dt]} m{l} = exists ? ({ct[dt]})(acc[{l}]) "
                    f": {udf.c_const(dflt, dt)};")

    def load_vp(arr, col, dt):
        return {"vid": f"({ct[dt]})(vid[s])", "x": f"({ct[dt]})(xr[{col}])",
                "m": f"({ct[dt]})(m{col})"}[arr]

    lines, outs = udf.emit(spec.vprog, load_vp, "vp")
    body += lines + [f"nw[{c}] = (float)({o});" for c, o in enumerate(outs)]
    body.append("for (int c = 0; c < DV; ++c) nw[c] = vm ? nw[c] : xr[c];")
    if spec.changed is None:
        body.append("for (int c = 0; c < DV; ++c) chg = chg || (nw[c] != xr[c]);")
    else:
        def load_ch(arr, col, dt):
            return f"({ct[dt]})({'xr' if arr == 'x' else 'nw'}[{col}])"
        lines, (out,) = udf.emit(spec.changed, load_ch, "cf")
        body += lines + [f"chg = (bool)({out});"]
    body.append("chg = chg && vm;")
    gen = [f"#define DM {spec.dm}", f"#define DV {spec.dv}",
           f"#define IDENT {udf.c_const(ref.REDUCE_IDENTITY[reduce], 'f32')}",
           f"#define REDUCE(a, b) {udf.REDUCE_C[reduce]}", udf.PRELUDE]
    return (build.template("apply")
            .replace("//@GENERATED@", "\n".join(gen))
            .replace("//@APPLY@", "\n  ".join(body)))




def fused_apply(pay, live, inv, x, vid, vmask, spec: ApplyUdf, *,
                reduce: str = "sum"):
    """Arguments and results as `kernels.ref.fused_apply`."""
    if x.device.type != "cuda":
        return plain(pay, live, inv, x, vid, vmask, spec, reduce=reduce)
    nl, v_blk, p = inv.shape
    s = nl * v_blk
    r = pay.shape[0]
    k = r // max(nl * p, 1)
    check = functools.partial(build.check_arg, "apply")
    check(pay, torch.float32, (nl * p * k, spec.dm), "pay")
    check(live, torch.bool, (r,), "live")
    check(inv, torch.int32, (nl, v_blk, p), "inv")
    check(x, torch.float32, (s, spec.dv), "x")
    check(vid, torch.int32, (s,), "vid")
    check(vmask, torch.bool, (s,), "vmask")
    new = torch.empty((s, spec.dv), dtype=torch.float32, device=x.device)
    chg = torch.empty((s,), dtype=torch.float32, device=x.device)
    lib = build.load("apply", source(spec, reduce), _ARGTYPES)
    err = lib.launch(build.ptr(pay), build.ptr(live), build.ptr(inv),
                     build.ptr(x), build.ptr(vid), build.ptr(vmask),
                     nl, p, k, v_blk, build.ptr(new), build.ptr(chg),
                     build.stream())
    build.check(err, "apply")
    fused_apply.launches += 1
    return new, chg


fused_apply.launches = 0

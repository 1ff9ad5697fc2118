"""The port's kernels (plain versions here) against the JAX reference.

Each plain version runs on the same numpy-seeded inputs as the reference's
jnp oracle and its Pallas kernel in interpret mode: min/max and counts must
match exactly, f32 sums within rtol 1e-6 (the three sum in different
orders).  The UDF IR is evaluated in torch and held against the UDF.
On the CPU the kernel wrappers take the plain versions and launch nothing.
"""
import functools
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.core import Graph as RefGraph  # noqa: E402
from repro.core import mrtriplets as ref_mt  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_kref  # noqa: E402
from repro.kernels import segment_sum as ref_segsum  # noqa: E402
from repro.kernels import spmv as jspmv  # noqa: E402
from repro.kernels.triplet import flatten_tiles  # noqa: E402
from repro_torch.core import Graph, analysis  # noqa: E402
from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.core import mrtriplets as mt  # noqa: E402
from repro_torch.core.graph import _degree_msg  # noqa: E402
from repro_torch.core.tree import ElemSpec, tree_leaves  # noqa: E402
from repro_torch.data import rmat  # noqa: E402
from repro_torch.kernels import ops, ref, udf  # noqa: E402
from repro_torch.kernels import segment_sum as seg_mod  # noqa: E402
from repro_torch.kernels import spmv as spmv_mod  # noqa: E402
from repro_torch.kernels import superstep as app_mod  # noqa: E402
from repro_torch.kernels import triplet as tri_mod  # noqa: E402

P = 4
F32, I32 = ElemSpec((), torch.float32), ElemSpec((), torch.int32)


@functools.lru_cache(maxsize=None)
def _graphs(vdata, seed=3, p=P):
    gd = rmat(7, 4, seed=seed)
    g = Graph.from_edges(gd.src, gd.dst, num_partitions=p, device="cpu")
    rg = RefGraph.from_edges(gd.src, gd.dst, num_partitions=p)
    g = g.replace(vdata={k: torch.from_numpy(v) for k, v in vdata(g).items()})
    rg = rg.replace(vdata={k: jnp.asarray(v) for k, v in vdata(g).items()})
    return g, rg


def _send_f(sv, ev, dv):
    return {"m": torch.maximum(sv["a"], dv["b"]) * ev["w"]}


def _send_i(sv, ev, dv):
    return {"m": sv["c"]}


def _tile_f(sv, ev, dv):
    return jnp.maximum(sv[:, 0:1], dv[:, 1:2]) * ev[:, 0:1]


def _tile_i(sv, ev, dv):
    return sv[:, 0:1]


def _vdata_f(g):
    rng = np.random.default_rng(0)
    shape = tuple(g.s.home_vid.shape)
    return {"a": rng.normal(size=shape).astype(np.float32),
            "b": rng.normal(size=shape).astype(np.float32)}


def _vdata_i(g):
    rng = np.random.default_rng(1)
    return {"c": rng.integers(0, 5000, tuple(g.s.home_vid.shape)).astype(np.int32)}


def _ref_triplet(host, x, ev, live, tile_fn, dm, to, reduce, mode):
    """The reference's oracle / Pallas sweep on the port's [P, N, D] inputs."""
    nl, v_mir, dx = x.shape
    vb = 512
    n_vb = -(-v_mir // vb)
    v_pad = n_vb * vb
    xp = np.zeros((nl, v_pad, dx), np.float32)
    xp[:, :v_mir] = x
    off = (np.arange(nl) * v_pad)[:, None]
    tiles = (None if mode == "ref" else
             flatten_tiles(host.tiles[to], e_blk=host.e_blk, n_vb=n_vb))
    out, cnt = ref_ops.triplet(
        jnp.asarray(xp.reshape(nl * v_pad, dx)),
        jnp.asarray(ev.reshape(nl * host.e_blk, -1)),
        jnp.asarray((host.src_slot + off).reshape(-1)),
        jnp.asarray((host.dst_slot + off).reshape(-1)),
        jnp.asarray(live.reshape(-1)), tiles, tile_fn, nl * v_pad, dm,
        to=to, reduce=reduce, mode=mode)
    out = np.asarray(out).reshape(nl, v_pad, dm)[:, :v_mir]
    return out, np.asarray(cnt).reshape(nl, v_pad)[:, :v_mir]


@pytest.mark.parametrize("mode", ["ref", "interpret"])
@pytest.mark.parametrize("to", ["dst", "src"])
@pytest.mark.parametrize("reduce,payload", [
    ("sum", "f"), ("min", "f"), ("max", "f"), ("min", "i")])
def test_triplet_plain_matches_reference(reduce, payload, to, mode):
    vdata = _vdata_f if payload == "f" else _vdata_i
    send = _send_f if payload == "f" else _send_i
    g, rg = _graphs(vdata)
    s = g.s
    spec = mt.fused_plan(g, send, reduce).kernel
    rng = np.random.default_rng(5)
    cols = [np.asarray(v)[..., None] for v in vdata(g).values()]
    home = np.concatenate(cols, -1)                     # [P, V_blk, D]
    # mirror rows: each slot holds its vertex's home row values
    mvid = s.mirror_vid.numpy()
    part, row = g.host.local_row(np.maximum(mvid, 0).reshape(-1))
    x = home[part, row].reshape(P, s.v_mir, -1).astype(np.float32)
    ev = rng.normal(size=(P, s.e_blk, 1)).astype(np.float32)
    live = s.edge_mask.numpy() & (rng.random((P, s.e_blk)) < 0.7)
    out, cnt = ref.fused_triplet(
        torch.from_numpy(x.reshape(P * s.v_mir, -1)),
        torch.from_numpy(ev.reshape(P * s.e_blk, 1)), s.src_slot, s.dst_slot,
        torch.from_numpy(live), s.agg_ptr[to],
        s.src_perm if to == "src" else None, spec, to=to, reduce=reduce)
    want, wcnt = _ref_triplet(rg.host, x, ev, live,
                              _tile_f if payload == "f" else _tile_i, 1, to,
                              reduce, mode)
    np.testing.assert_array_equal(cnt.numpy().reshape(P, s.v_mir), wcnt)
    got = out.numpy().reshape(P, s.v_mir, 1)
    if reduce == "sum":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def _pr_vprog(vid, v, msg):
    return {"a": 0.15 + 0.85 * msg["m"], "b": v["b"]}


def _pr_vprog_j(vid, v, msg):
    return {"a": 0.15 + 0.85 * msg["m"], "b": v["b"]}


def _chg(old, new):
    return torch.abs(new["a"] - old["a"]) > 0.05


def _chg_j(old, new):
    return jnp.abs(new["a"] - old["a"]) > 0.05


def _mx_send(sv, ev, dv):
    return {"m": sv["a"]}


def _mx_vprog(vid, v, msg):
    return {"a": torch.maximum(v["a"], msg["m"]), "b": v["b"]}


def _mx_vprog_j(vid, v, msg):
    return {"a": jnp.maximum(v["a"], msg["m"]), "b": v["b"]}


def _cc_vprog_j(vid, v, msg):
    return {"c": jnp.minimum(v["c"], msg["m"])}


def _cc_vprog(vid, v, msg):
    return {"c": torch.minimum(v["c"], msg["m"])}


def _vdata_nan(g):
    """_vdata_f with NaN in the passed-through leaf b at every 7th row."""
    v = _vdata_f(g)
    v["b"].reshape(-1)[::7] = np.nan
    return v


def _vdata_pad(g):
    """CC's int32 state: the home ids, INT_PAD on the padding rows."""
    return {"c": g.s.home_vid.numpy().copy()}


def _vdata_bf16(g):
    rng = np.random.default_rng(2)
    shape = tuple(g.s.home_vid.shape)
    return {"a": rng.normal(size=shape).astype(np.float32),
            "w": rng.uniform(0.5, 2.0, shape).astype(np.float32)}


def _vdata_w2(g):
    rng = np.random.default_rng(3)
    shape = tuple(g.s.home_vid.shape)
    return {"a": rng.normal(size=shape + (2,)).astype(np.float32),
            "b": rng.normal(size=shape).astype(np.float32)}


def _vdata_delta(g):
    rng = np.random.default_rng(4)
    shape = tuple(g.s.home_vid.shape)
    return {"deg": rng.integers(1, 9, shape).astype(np.float32),
            "delta": rng.uniform(0.0, 0.5, shape).astype(np.float32),
            "pr": rng.uniform(0.15, 2.0, shape).astype(np.float32)}


def _bf_send(sv, ev, dv):
    """A bf16 message: routed in bf16, combined in f32."""
    return {"m": (sv["a"] * ev["w"]).to(torch.bfloat16)}


def _bf_vprog(vid, v, msg):
    return {"a": 0.15 + 0.85 * msg["m"] * v["w"], "w": v["w"]}


def _bf_vprog_j(vid, v, msg):
    return {"a": 0.15 + 0.85 * msg["m"] * v["w"], "w": v["w"]}


def _w2_send(sv, ev, dv):
    return {"m": sv["a"] * 2.0}


def _w2_vprog(vid, v, msg):
    return {"a": 0.5 * v["a"] + msg["m"], "b": v["b"]}


def _w2_vprog_j(vid, v, msg):
    return {"a": 0.5 * v["a"] + msg["m"], "b": v["b"]}


def _vdata_w120(g):
    rng = np.random.default_rng(6)
    shape = tuple(g.s.home_vid.shape)
    return {"a": rng.normal(size=shape + (120,)).astype(np.float32),
            "b": rng.normal(size=shape).astype(np.float32)}


def _vdata_a(g):
    rng = np.random.default_rng(7)
    return {"a": rng.normal(size=tuple(g.s.home_vid.shape)).astype(
        np.float32)}


def _w60_send(sv, ev, dv):
    return {"m": sv["a"] * torch.ones(60)}


def _w60_vprog(vid, v, msg):
    return {"a": 0.5 * v["a"] + msg["m"][0] + msg["m"][31] + msg["m"][59]}


def _w60_vprog_j(vid, v, msg):
    return {"a": 0.5 * v["a"] + msg["m"][0] + msg["m"][31] + msg["m"][59]}


_DELTA_VPROG, _DELTA_CHG = alg.delta_pagerank_fns(0.15, 1e-3)


def _delta_vprog_j(vid, v, msg):
    new_pr = v["pr"] + (1.0 - 0.15) * msg["m"]
    return {**v, "pr": new_pr, "delta": new_pr - v["pr"]}


def _delta_chg_j(old, new):
    return jnp.abs(new["pr"] - old["pr"]) > 1e-3


APPLY_CASES = {
    # name: (vdata, send, vprog, ref vprog, reduce, changed, ref changed,
    #        default, partitions)
    "sum": (_vdata_f, _send_f, _pr_vprog, _pr_vprog_j, "sum", None, None, 0.0,
            P),
    "sum_changed_fn": (_vdata_f, _send_f, _pr_vprog, _pr_vprog_j, "sum",
                       _chg, _chg_j, 0.0, P),
    "max": (_vdata_f, _mx_send, _mx_vprog, _mx_vprog_j, "max", None, None,
            -1.0, P),
    "min_int": (_vdata_i, _send_i, _cc_vprog, _cc_vprog_j, "min", None, None,
                2**31 - 1, P),
    "bf16_message": (_vdata_bf16, _bf_send, _bf_vprog, _bf_vprog_j, "sum",
                     None, None, 0.0, P),
    "width2_leaf": (_vdata_w2, _w2_send, _w2_vprog, _w2_vprog_j, "sum", None,
                    None, 0.0, P),
    "int_pad_invisible": (_vdata_pad, _send_i, _cc_vprog, _cc_vprog_j, "min",
                          None, None, 2**31 - 1, P),
    "nan_passthrough": (_vdata_nan, _send_f, _pr_vprog, _pr_vprog_j, "sum",
                        None, None, 0.0, P),
    "delta_changed_fn": (_vdata_delta, alg.delta_pagerank_send, _DELTA_VPROG,
                         _delta_vprog_j, "sum", _DELTA_CHG, _delta_chg_j, 0.0,
                         P),
    "sum_p1": (_vdata_f, _send_f, _pr_vprog, _pr_vprog_j, "sum", None, None,
               0.0, 1),
    "min_int_p3": (_vdata_i, _send_i, _cc_vprog, _cc_vprog_j, "min", None,
                   None, 2**31 - 1, 3),
    # message widths whose CTA the plan rounds to whole threads (VB 768 at
    # dm 60, 256 at dm 120; the card's cases run on partitions wider than
    # the CTA)
    "wide_msg60_p1": (_vdata_a, _w60_send, _w60_vprog, _w60_vprog_j, "sum",
                       None, None, 0.0, 1),
    "wide_leaf120_p2": (_vdata_w120, _w2_send, _w2_vprog, _w2_vprog_j,
                         "sum", None, None, 0.0, 2),
}


def _apply_case(case):
    """(g, rg, port plan, reference plan) of an APPLY_CASES case;
    int_pad_invisible also hides every 5th real vertex."""
    vdata, send, vprog, vprog_j, reduce, chg, chg_j, dflt, p = \
        APPLY_CASES[case]
    g, rg = _graphs(vdata, p=p)
    if case == "int_pad_invisible":
        vm = g.vmask.numpy().copy()
        vm.reshape(-1)[::5] = False
        g = g.replace(vmask=torch.from_numpy(vm), vmask_full=False)
        rg = rg.replace(vmask=jnp.asarray(vm), vmask_full=False)
    is_int = isinstance(dflt, int)
    d_t = {"m": torch.tensor(dflt, dtype=torch.int32 if is_int
                             else torch.float32)}
    d_j = {"m": jnp.int32(dflt) if is_int else jnp.float32(dflt)}
    plan = mt._plan_apply(g, vprog, send, reduce, chg, d_t, None)
    rplan = ref_mt._plan_apply(rg, vprog_j, send_j(send), reduce, chg_j, d_j,
                               None)
    return g, rg, plan, rplan


def _apply_inputs(g, plan, seed=11):
    """Routed messages (numpy, exact in the message leaf's dtype) and
    flags for the route to dst."""
    send_idx = g.s.routes["dst"][0].numpy()
    rng = np.random.default_rng(seed)
    shape = send_idx.shape + tuple(plan.msg_specs[0].shape)
    if plan.msg_specs[0].dtype == torch.int32:
        recv = rng.integers(0, 5000, shape).astype(np.int32)
    else:
        recv = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
            udf.TORCH_DTYPE[plan.kernel.msgs[0][0]]).float().numpy()
    rflags = (send_idx >= 0) & (rng.random(send_idx.shape) < 0.8)
    return recv, rflags


def _same_bits(a, b):
    """Bit equality (NaNs included)."""
    if a.dtype.is_floating_point:
        bits = {4: torch.int32, 2: torch.int16}[a.element_size()]
        a, b = a.view(bits), b.view(bits)
    return torch.equal(a, b)


@pytest.mark.parametrize("mode", ["ref", "interpret"])
@pytest.mark.parametrize("case", sorted(APPLY_CASES))
def test_apply_plain_matches_reference(case, mode):
    """The port's plain apply against the reference's fused_apply_home on
    the visible rows (sums within rtol = atol = 1e-6, the rest exact, the
    changed bits exact); the port's invisible rows keep their old bits and
    a passed-through leaf comes back as the same tensor."""
    reduce = APPLY_CASES[case][4]
    g, rg, plan, rplan = _apply_case(case)
    assert plan is not None and rplan is not None
    recv, rflags = _apply_inputs(g, plan)
    mdt = udf.TORCH_DTYPE[plan.kernel.msgs[0][0]]    # the routed leaf's
    new, changed = mt.fused_apply_home(
        g, {"m": torch.from_numpy(recv).to(mdt)}, torch.from_numpy(rflags),
        "dst", reduce, plan, "ref")
    vprog_j, chg_j = APPLY_CASES[case][3], APPLY_CASES[case][6]
    rnew, rchanged = ref_mt.fused_apply_home(
        rg, {"m": jnp.asarray(recv).astype(str(mdt).removeprefix("torch."))},
        jnp.asarray(rflags), "dst", reduce, rplan, vprog_j, chg_j, mode)
    np.testing.assert_array_equal(changed.numpy(), np.asarray(rchanged))
    vm = g.vmask.numpy()
    written = dict(zip(sorted(g.vdata), plan.kernel.written))  # leaf order
    for k in new:
        assert new[k].dtype == g.vdata[k].dtype
        got, want = new[k].float().numpy()[vm], np.asarray(rnew[k])[vm]
        if reduce == "sum":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)
        assert _same_bits(new[k][~g.vmask], g.vdata[k][~g.vmask])
        if not written[k]:
            assert new[k] is g.vdata[k]
    if case == "nan_passthrough":
        nan = np.isnan(g.vdata["b"].numpy()) & vm
        assert nan.any() and changed.numpy()[nan].all()


@pytest.mark.parametrize("case", sorted(APPLY_CASES))
def test_apply_source_generates(case):
    """The kernel's source is generated here for every case (the card only
    compiles it): every marker filled, the CTA's defines from `plan`."""
    _, _, plan, _ = _apply_case(case)
    src = app_mod.source(plan.kernel, APPLY_CASES[case][4])
    pl = app_mod.plan(plan.dm, plan.dv)
    assert "//@" not in src
    assert f"#define VB {pl.vb}\n" in src
    assert f"#define THREADS {pl.threads}\n" in src


def send_j(send):
    """The jnp twin of a torch send UDF used above."""
    return {_send_f: lambda sv, ev, dv: {"m": jnp.maximum(sv["a"], dv["b"])
                                         * ev["w"]},
            _send_i: lambda sv, ev, dv: {"m": sv["c"]},
            _mx_send: lambda sv, ev, dv: {"m": sv["a"]},
            _w2_send: lambda sv, ev, dv: {"m": sv["a"] * 2.0},
            _w60_send: lambda sv, ev, dv: {"m": sv["a"] * jnp.ones(60)},
            _bf_send: lambda sv, ev, dv: {
                "m": (sv["a"] * ev["w"]).astype(jnp.bfloat16)},
            alg.delta_pagerank_send: lambda sv, ev, dv: {
                "m": sv["delta"] / sv["deg"] * ev["w"]}}[send]


def _csr_case(rng, nl, e, v):
    """A [nl, e] slab whose partitions each hold a sorted prefix of segment
    ids in [0, v): (ptr [nl, v+1] int32, live [nl, e], flat ids [nl*e] with
    the dead and padding entries outside [0, nl*v))."""
    n = rng.integers(e // 2, e, nl)
    ptr = np.zeros((nl, v + 1), np.int32)
    ids = np.full((nl, e), nl * v + 5, np.int64)
    for q in range(nl):
        seg = np.sort(rng.integers(0, v, n[q]))
        ptr[q] = np.searchsorted(seg, np.arange(v + 1))
        ids[q, :n[q]] = seg + q * v
    live = (np.arange(e)[None, :] < n[:, None]) & (rng.random((nl, e)) < 0.9)
    ids = np.where(live, ids, -1).astype(np.int32).reshape(-1)
    return ptr, live, ids


@pytest.mark.parametrize("d", [1, 3])
def test_segment_sum_plain_matches_reference(d):
    rng = np.random.default_rng(d)
    nl, e, v = 3, 700, 90
    ptr, live, ids = _csr_case(rng, nl, e, v)
    msgs = rng.normal(size=(nl, e, d)).astype(np.float32)
    got = ref.segment_sum(torch.from_numpy(msgs), torch.from_numpy(live),
                          torch.from_numpy(ptr))
    assert got.shape == (nl, v, d)
    flat = jnp.asarray(msgs.reshape(nl * e, d))
    want = ref_kref.segment_sum(flat, jnp.asarray(ids), nl * v)
    kern = ref_segsum.segment_sum(flat, jnp.asarray(ids), nl * v,
                                  edge_block=128, vertex_block=128,
                                  interpret=True)
    got = got.numpy().reshape(nl * v, d)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(kern), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ UDF IR
def _kitchen(sv, ev, dv):
    a, b, c = sv["a"], dv["a"], sv["i"]
    x = torch.where((a > b) & ~(b >= 0.25), a - b, -b) / (torch.abs(a) + 1.5)
    y = torch.minimum(a, b) + torch.maximum(a * 3.0, ev["w"])
    z = (c + 7) * 2 - dv["i"]
    k = ((c > 3) | (a <= b)) ^ (c == 2)
    return {"x": x, "y": y, "z": z, "k": k.to(torch.float32),
            "zf": c.to(torch.float32) * 0.5, "n": torch.neg(c),
            "cmp": (a != 0.5) & torch.logical_not(c < 0)}


def _more_senior(sv, ev, dv):
    return {"n": torch.where(sv["age"] > dv["age"], 1.0, 0.0)}


UDFS = {
    "pagerank_send": (alg.pagerank_send, {"deg": F32, "pr": F32}),
    "cc_send": (alg.cc_send, {"cc": I32}),
    "degree": (_degree_msg, {"x": F32}),
    "more_senior": (_more_senior, {"age": F32}),
    "kitchen": (_kitchen, {"a": F32, "i": I32}),
}


@pytest.mark.parametrize("name", sorted(UDFS))
def test_udf_ir_matches_udf(name):
    fn, vex = UDFS[name]
    eex = {"w": F32}
    tr = analysis.trace_udf(fn, vex, eex, vex)
    nv = len(vex)
    inputs = ([("s", i) for i in range(nv)] + [("e", 0)]
              + [("d", i) for i in range(nv)])
    ir = udf.lower(tr, inputs)
    assert ir is not None
    rng = np.random.default_rng(9)
    n = 64

    def make(specs):
        return {k: (torch.from_numpy(rng.normal(size=n).astype(np.float32))
                    if s.dtype == torch.float32 else
                    torch.from_numpy(rng.integers(-5, 6, n).astype(np.int32)))
                for k, s in specs.items()}

    sv, ev, dv = make(vex), make(eex), make(vex)
    arrays = {"s": list(sv.values()), "e": list(ev.values()),
              "d": list(dv.values())}
    got = udf.evaluate(ir, lambda arr, col, dt: arrays[arr][col].to(dt))
    # the port flattens dicts in sorted key order, as jax.tree does
    want = tree_leaves(torch.func.vmap(fn)(sv, ev, dv))
    assert len(got) == len(want)
    for g_, w_ in zip(got, want):
        assert g_.dtype == w_.dtype
        assert torch.equal(g_.expand(n), w_)


def _math(sv, ev, dv):
    a, b = sv["a"], dv["a"]
    pos = torch.abs(a) + 0.5
    return {"e": torch.exp(a * 0.5), "l": torch.log(pos) + torch.log1p(pos),
            "x": torch.expm1(b) - torch.sqrt(pos) * torch.rsqrt(pos),
            "t": torch.tanh(a) + torch.sigmoid(b) * torch.sin(a)
            - torch.cos(b) / torch.reciprocal(pos),
            "f": torch.floor(a * 3.0) + torch.ceil(b) + torch.sign(a - b),
            "p": torch.pow(a, 2) + torch.pow(pos, 3.0) - torch.pow(pos, 0.5)
            + torch.pow(pos, -1.0) + torch.pow(pos, 1.7) + torch.pow(pos, -2),
            "c": torch.clamp(a, -0.5, 0.5) + torch.clamp(b, min=0.0)
            + torch.clamp_max(a, 0.25) + torch.clamp(b, max=sv["a"]),
            "ie": torch.exp(sv["i"]), "if": torch.floor(sv["i"])}


def _vector(sv, ev, dv):
    v, w = sv["v"], dv["v"]
    return {"m": v * ev["w"] + w, "s": v[0] - w[-1],
            "c": torch.cat([v[1:], torch.exp(w[:1])]),
            "q": torch.stack([v[2], ev["w"]]), "k": sv["a"]}


def _narrow(sv, ev, dv):
    h, g = sv["h"], dv["h"]
    return {"m": h * g + h / (g + 2.0), "e": torch.exp(h), "c": h.float() * 3.0,
            "p": torch.pow(h, 2), "k": torch.maximum(h, g) - 0.5,
            "f": sv["f16"] * dv["f16"] - 0.25}


F16, BF16 = ElemSpec((), torch.float16), ElemSpec((), torch.bfloat16)
V3 = ElemSpec((3,), torch.float32)
NEW_UDFS = {"math": (_math, {"a": F32, "i": I32}),
            "vector": (_vector, {"a": F32, "v": V3}),
            "narrow": (_narrow, {"f16": F16, "h": BF16})}


@pytest.mark.parametrize("name", sorted(NEW_UDFS))
def test_udf_ir_math_vector_narrow_matches_udf(name):
    """Math ops, rank-1 leaves (one column per element) and bf16/f16
    arithmetic: the IR's torch evaluation equals the UDF bit for bit."""
    fn, vex = NEW_UDFS[name]
    eex = {"w": F32}
    tr = analysis.trace_udf(fn, vex, eex, vex)
    starts = np.cumsum([0] + [int(np.prod(s.shape)) for s in vex.values()])
    inputs = ([("s", int(c)) for c in starts[:-1]] + [("e", 0)]
              + [("d", int(c)) for c in starts[:-1]])
    ir = udf.lower(tr, inputs)
    assert ir is not None
    rng = np.random.default_rng(10)
    n = 64

    def make(specs):
        out = {}
        for k, sp in specs.items():
            if sp.dtype == torch.int32:
                out[k] = torch.from_numpy(rng.integers(-5, 6, n).astype(np.int32))
            else:
                out[k] = torch.from_numpy(rng.normal(size=(n,) + sp.shape)
                                          .astype(np.float32)).to(sp.dtype)
        return out

    sv, ev, dv = make(vex), make(eex), make(vex)
    cols = {a: [c for leaf in tree_leaves(t)
                for c in leaf.reshape(n, -1).unbind(1)]
            for a, t in (("s", sv), ("e", ev), ("d", dv))}
    got = udf.evaluate(ir, lambda arr, col, dt: cols[arr][col].to(dt))
    want = [c for leaf in tree_leaves(torch.func.vmap(fn)(sv, ev, dv))
            for c in leaf.reshape(n, -1).unbind(1)]
    assert len(got) == len(want)
    for g_, w_ in zip(got, want):
        assert g_.dtype == w_.dtype
        torch.testing.assert_close(g_.expand(n), w_, rtol=0, atol=0,
                                   equal_nan=True)
    if name == "narrow":        # per-op rounding to the narrow dtype in C
        lines, _ = udf.emit(ir, lambda a, c, d: f"{a}[{c}]", "t")
        assert any("udf_bf16(" in l for l in lines)
        assert any("udf_f16(" in l for l in lines)
    if name == "math":          # accurate libm, never the fast intrinsics
        text = "\n".join(udf.emit(ir, lambda a, c, d: f"{a}[{c}]", "t")[0])
        assert "expf(" in text and "__expf" not in text


def test_narrow_constant_outside_dtype_plans_unfused():
    """torch keeps a python scalar in f32 inside a bf16 op; the IR would
    round it to bf16, so such a UDF plans unfused."""
    vex = {"h": BF16}
    inputs = [("s", 0), ("e", 0), ("d", 0)]
    ok = analysis.trace_udf(lambda sv, ev, dv: {"m": sv["h"] * 0.5},
                            vex, {"w": F32}, vex)
    bad = analysis.trace_udf(lambda sv, ev, dv: {"m": sv["h"] * 0.1},
                             vex, {"w": F32}, vex)
    assert udf.lower(ok, inputs) is not None
    assert udf.lower(bad, inputs) is None


def test_udf_outside_ir_plans_unfused():
    g, _ = _graphs(_vdata_f)

    def erf_send(sv, ev, dv):
        return {"m": torch.erf(sv["a"])}

    def atan_send(sv, ev, dv):
        return {"m": torch.atan(sv["a"])}

    def exp_send(sv, ev, dv):
        return {"m": torch.exp(sv["a"])}

    assert mt.plan_of(g, erf_send, "sum") == "unfused"
    assert mt.plan_of(g, atan_send, "sum") == "fused"
    assert mt.plan_of(g, exp_send, "sum") == "fused"
    assert mt.plan_of(g, _send_f, "sum") == "fused"


def test_emitted_constants_are_exact_f32_bits():
    bits = struct.unpack("<I", struct.pack("<f", np.float32(0.85)))[0]
    assert udf.c_const(float(np.float32(0.85)), "f32") == f"__int_as_float(0x{bits:08x})"
    assert udf.c_const(-(2**31), "i32") == "(-2147483647 - 1)"
    g, _ = _graphs(_vdata_f)
    g = g.replace(vdata={"deg": g.vdata["a"], "pr": g.vdata["b"]})
    plan = mt._plan_apply(g, alg.pagerank_vprog(0.15), alg.pagerank_send,
                          "sum", None, {"m": torch.tensor(0.0)}, None)
    src = app_mod.source(plan.kernel, "sum")
    assert f"__int_as_float(0x{bits:08x})" in src
    gi, _ = _graphs(_vdata_i)
    plan = mt._plan_apply(gi, _cc_vprog, _send_i, "min", None,
                          {"m": torch.tensor(2**31 - 1, dtype=torch.int32)}, None)
    src = app_mod.source(plan.kernel, "min")
    # the int default substitutes as an int literal, never via a float
    assert "const int m0 = exists ? (int)(acc[0]) : ((int)2147483647);" in src
    assert "//@" not in src and "//@" not in tri_mod.source(
        mt.fused_plan(gi, _send_i, "min").kernel, "min", "src")


def test_wrappers_on_cpu_run_plain_and_launch_nothing():
    g, _ = _graphs(_vdata_f)
    s = g.s
    spec = mt.fused_plan(g, _send_f, "sum").kernel
    ops.reset_launch_counts()
    x = torch.rand(P * s.v_mir, 2)
    ev = torch.rand(P * s.e_blk, 1)
    args = (x, ev, s.src_slot, s.dst_slot, s.edge_mask, s.agg_ptr["dst"], None,
            spec)
    a = tri_mod.fused_triplet(*args)
    b = ref.fused_triplet(*args)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    msgs = torch.rand(P, s.e_blk, 1)
    assert torch.equal(seg_mod.segment_sum(msgs, s.edge_mask, s.agg_ptr["dst"]),
                       ref.segment_sum(msgs, s.edge_mask, s.agg_ptr["dst"]))
    assert ops.launch_counts() == {"triplet": 0, "apply": 0, "segment_sum": 0,
                                   "flash_attention": 0,
                                   "flash_attention_bwd": 0, "mlstm_fwd": 0,
                                   "mlstm_bwd": 0, "spmv": 0}
    with pytest.raises(ValueError):
        ops.triplet(*args, mode="pallas")


# ----------------------------------------------------------------- spmv
def _spmv_case(e, v, d, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    mask = rng.random(e) > 0.15
    w = (rng.normal(size=e) * mask).astype(np.float32)
    x = rng.normal(size=(v, d)).astype(np.float32)
    return src, dst, mask, w, x


@pytest.mark.parametrize("e,v,d,eb,vb", [
    (500, 100, 1, 128, 64), (2000, 500, 8, 256, 128), (64, 16, 4, 32, 16)])
def test_spmv_sweep_matches_reference(e, v, d, eb, vb):
    """The reference's spmv sweep (tests/test_kernels.py:test_spmv_sweep):
    the port's spmv (the triplet kernel's plain version on the CPU) against
    the reference's Pallas spmv in interpret mode and its oracle
    `fused_gather_segment_sum`, rtol and atol 1e-4."""
    src, dst, mask, w, x = _spmv_case(e, v, d, 0)
    tiles = spmv_mod.build_tiles(src, dst, mask, v)
    got = ops.spmv(*map(torch.from_numpy, (x, w, src, dst)), tiles, None, v,
                   vb=vb)
    jt = jspmv.build_tiles(src, dst, mask, v, eb=eb, vb=vb)
    kern = jspmv.spmv(*map(jnp.asarray, (x, w, src, dst, jt["perm"],
                                         jt["chunk_dst"], jt["chunk_src"])),
                      None, v, eb=eb, vb=vb, interpret=True)
    want = ref_kref.fused_gather_segment_sum(*map(jnp.asarray, (x, w, src, dst)),
                                         v)
    assert got.shape == (v, d) and got.dtype == torch.float32
    for other in (kern, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(other), rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_allclose(
        ops.spmv(*map(torch.from_numpy, (x, w, src, dst)), tiles, None, v,
                 mode="ref").numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_spmv_active_block_skip_matches_reference():
    """Block-level skipStale (tests/test_kernels.py:test_spmv_active_block_
    skip): only sources in the active block 0 contribute."""
    rng = np.random.default_rng(1)
    v, e = 128, 400
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    w = np.ones(e, np.float32)
    x = rng.normal(size=(v, 2)).astype(np.float32)
    active = np.zeros(-(-v // 32), bool)
    active[0] = True
    tiles = spmv_mod.build_tiles(src, dst, np.ones(e, bool), v)
    got = ops.spmv(*map(torch.from_numpy, (x, w, src, dst)), tiles,
                   torch.from_numpy(active), v, vb=32)
    jt = jspmv.build_tiles(src, dst, np.ones(e, bool), v, eb=64, vb=32)
    kern = jspmv.spmv(*map(jnp.asarray, (x, w, src, dst, jt["perm"],
                                         jt["chunk_dst"], jt["chunk_src"])),
                      jnp.asarray(active), v, eb=64, vb=32, interpret=True)
    want = ref_kref.fused_gather_segment_sum(*map(jnp.asarray, (
        x, w * (src < 32), src, dst)), v)
    for other in (kern, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(other), rtol=1e-4,
                                   atol=1e-4)
    plain = ops.spmv(*map(torch.from_numpy, (x, w, src, dst)), tiles,
                     torch.from_numpy(active), v, vb=32, mode="ref")
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_spmv_tiles_are_dst_csr():
    src, dst, mask, _, _ = _spmv_case(300, 40, 1, 2)
    t = spmv_mod.build_tiles(src, dst, mask, 40)
    live = np.flatnonzero(mask)
    n = live.size
    assert t["ptr"][-1] == n and t["ptr"].dtype == np.int32
    assert sorted(t["perm"][:n]) == sorted(live)
    assert np.all(np.diff(dst[t["perm"][:n]]) >= 0)
    for vtx in range(40):
        seg = t["perm"][t["ptr"][vtx]:t["ptr"][vtx + 1]]
        assert np.all(dst[seg] == vtx) and np.all(np.diff(seg) > 0)
    with pytest.raises(ValueError):
        spmv_mod.build_tiles(src, dst, mask, 10)

"""The port's CUDA kernels on the card, against their plain versions.

Every test carries the `cuda` marker and takes the `cuda` fixture, which
skips when there is no CUDA card; the decision is made there, never while
the module is imported.  On a machine with one card and nvcc:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q

The graphs are small (rmat(10, 8), P=4, and the hub graph: rmat(10, 8)
joined to a symmetrized star whose centre has 2048 edges each way, so its
slots span many pieces of SEG_PIECE edges): this checks that every kernel
variant the slice generates builds, launches and computes what its plain
version computes, including UDFs that `chip_smoke.py` does not run (delta
PageRank's changed_fn, quickstart's `more_senior`, every IR op).  Min/max,
counts and the apply kernel must match exactly.  The triplet and
segment_sum kernels must equal `ref.ordered_segment_reduce`, the model of
their shared summation order (`csrc/segorder.cuh`), bit for bit; the
triplet sums are also held within rtol 1e-5 of the plain version, whose
`index_add_` adds with atomics on the card.  End to end, the card's fused
plan equals its unfused plan bit for bit, CC equals the CPU run exactly and
PageRank equals it within rtol 1e-5, atol 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import Graph, analysis, with_wire  # noqa: E402
from repro_torch.core import wire as wire_mod  # noqa: E402
from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.core import mrtriplets as mt  # noqa: E402
from repro_torch.core.tree import ElemSpec, tree_map  # noqa: E402
from repro_torch.data import rmat, star, symmetrize  # noqa: E402
from repro_torch.data.graphs import GraphData  # noqa: E402
from repro_torch.kernels import ops, ref, segorder, udf  # noqa: E402
from repro_torch.kernels import segment_sum as seg_mod  # noqa: E402
from repro_torch.kernels import superstep as app_mod  # noqa: E402
from repro_torch.kernels import triplet as tri_mod  # noqa: E402

P = 4
GD = rmat(10, 8, seed=42)
SGD = symmetrize(GD)
_STAR = symmetrize(star(2049))
HUB = GraphData(np.concatenate([GD.src, _STAR.src]),
                np.concatenate([GD.dst, _STAR.dst]), 2049)
F32, I32 = ElemSpec((), torch.float32), ElemSpec((), torch.int32)
pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


def _graph(gd, device, vdata=None):
    g = Graph.from_edges(gd.src, gd.dst, num_partitions=P, device=device)
    if vdata is not None:
        g = g.replace(vdata={k: torch.from_numpy(v).to(device)
                             for k, v in vdata(g).items()})
    return g


def _vdata_f(g):
    rng = np.random.default_rng(0)
    shape = tuple(g.s.home_vid.shape)
    return {"a": rng.normal(size=shape).astype(np.float32),
            "b": rng.normal(size=shape).astype(np.float32)}


def _vdata_i(g):
    rng = np.random.default_rng(1)
    return {"c": rng.integers(0, 5000, tuple(g.s.home_vid.shape))
            .astype(np.int32)}


def _send_f(sv, ev, dv):
    return {"m": torch.maximum(sv["a"], dv["b"]) * ev["w"]}


def _send_i(sv, ev, dv):
    return {"m": sv["c"]}


def _more_senior(sv, ev, dv):
    return {"n": torch.where(sv["a"] > dv["a"], 1.0, 0.0)}


def _kitchen(sv, ev, dv):
    a, b, c = sv["a"], dv["a"], sv["i"]
    x = torch.where((a > b) & ~(b >= 0.25), a - b, -b) / (torch.abs(a) + 1.5)
    y = torch.minimum(a, b) + torch.maximum(a * 3.0, ev["w"])
    z = (c + 7) * 2 - dv["i"]
    k = ((c > 3) | (a <= b)) ^ (c == 2)
    return {"x": x, "y": y, "z": z, "k": k.to(torch.float32),
            "zf": c.to(torch.float32) * 0.5, "n": torch.neg(c),
            "cmp": (a != 0.5) & torch.logical_not(c < 0)}


def _triplet_inputs(g, dx, seed):
    s, dev = g.s, g.device
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(P * s.v_mir, dx))
                         .astype(np.float32)).to(dev)
    ev = torch.from_numpy(rng.normal(size=(P * s.e_blk, 1))
                          .astype(np.float32)).to(dev)
    live = (s.edge_mask.cpu() & torch.from_numpy(
        rng.random((P, s.e_blk)) < 0.7)).to(dev)
    return x, ev, live


def _check_triplet(g, spec, x, ev, live, to, reduce):
    s = g.s
    args = (x, ev, s.src_slot, s.dst_slot, live, s.agg_ptr[to],
            s.agg_perm[to], spec)
    before = tri_mod.fused_triplet.launches
    out, cnt = tri_mod.fused_triplet(*args, to=to, reduce=reduce,
                                     pieces=s.agg_pieces[to])
    want, wcnt = ref.fused_triplet(*args, to=to, reduce=reduce)
    exact, ecnt = ref.ordered_triplet(*args, s.agg_pieces[to], reduce=reduce)
    torch.cuda.synchronize()
    assert tri_mod.fused_triplet.launches == before + 1
    assert out.is_cuda and torch.equal(cnt, wcnt) and torch.equal(cnt, ecnt)
    assert torch.equal(out, exact)
    if reduce == "sum":
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    else:
        assert torch.equal(out, want)
    return out, want


def _longest_slot(g, to):
    return int(torch.diff(g.s.agg_ptr[to], dim=1).max())


@pytest.mark.parametrize("to", ["dst", "src"])
@pytest.mark.parametrize("reduce,payload", [
    ("sum", "f"), ("min", "f"), ("max", "f"), ("min", "i")])
def test_triplet_kernel_matches_plain(reduce, payload, to, cuda):
    vdata, send = (_vdata_f, _send_f) if payload == "f" else (_vdata_i, _send_i)
    g = _graph(GD, cuda, vdata)
    spec = mt.fused_plan(g, send, reduce).kernel
    x, ev, live = _triplet_inputs(g, 2 if payload == "f" else 1, seed=5)
    if payload == "i":
        x = x.abs().mul(1000).round()
    _check_triplet(g, spec, x, ev, live, to, reduce)


def _vec3_data(g):
    rng = np.random.default_rng(8)
    return {"v": rng.normal(size=tuple(g.s.home_vid.shape) + (3,))
            .astype(np.float32)}


def _vec3_send(sv, ev, dv):
    return {"m": sv["v"] * ev["w"]}


@pytest.mark.parametrize("to", ["dst", "src"])
@pytest.mark.parametrize("dm", [1, 3])
@pytest.mark.parametrize("reduce", ["sum", "max"])
def test_triplet_kernel_on_hub_graph(reduce, dm, to, cuda):
    """Slots of 1000+ edges, cut into many pieces and combined by the
    second pass: bit-equal to the ordered model, counts exact."""
    vdata, send = (_vdata_f, _send_f) if dm == 1 else (_vec3_data, _vec3_send)
    g = _graph(HUB, cuda, vdata)
    assert _longest_slot(g, to) >= 8 * segorder.SEG_PIECE
    spec = mt.fused_plan(g, send, reduce).kernel
    assert spec.dm == dm
    x, ev, live = _triplet_inputs(g, 2 if dm == 1 else 3, seed=9)
    _check_triplet(g, spec, x, ev, live, to, reduce)


@pytest.mark.parametrize("graph", ["rmat", "hub"])
@pytest.mark.parametrize("reduce", ["sum", "max"])
def test_triplet_kernel_on_reversed_graph(reduce, graph, cuda):
    """The transpose's "dst" side walks the old src order (agg_perm["dst"]
    is the original src_perm): bit-equal to the ordered model.  The kernel
    with agg_perm dropped on that side (the stored order under the old src
    side's row pointers) must fail the check."""
    g = _graph(GD if graph == "rmat" else HUB, cuda, _vdata_f).reverse()
    s = g.s
    assert s.agg_perm["dst"] is not None and s.agg_perm["src"] is None
    spec = mt.fused_plan(g, _send_f, reduce).kernel
    x, ev, live = _triplet_inputs(g, 2, seed=13)
    _check_triplet(g, spec, x, ev, live, "dst", reduce)
    args = (x, ev, s.src_slot, s.dst_slot, live, s.agg_ptr["dst"])
    bad, _ = tri_mod.fused_triplet(*args, None, spec, to="dst", reduce=reduce,
                                   pieces=s.agg_pieces["dst"])
    exact, _ = ref.ordered_triplet(*args, s.agg_perm["dst"], spec,
                                   s.agg_pieces["dst"], reduce=reduce)
    torch.cuda.synchronize()
    assert not torch.equal(bad, exact)


def test_reverse_on_card(cuda):
    """Degrees and PageRank of the transpose on the card: in-degrees ==
    the original's out-degrees, fused == unfused, CPU ranks within rtol
    1e-5."""
    g = _graph(GD, cuda)
    r = g.reverse()
    assert torch.equal(r.degrees("in")[0], g.degrees("out")[0])
    assert torch.equal(r.degrees("out")[0], g.degrees("in")[0])
    a = alg.pagerank(r, num_iters=8)
    b = alg.pagerank(r, num_iters=8, kernel_mode="unfused")
    assert torch.equal(a.graph.vdata["pr"], b.graph.vdata["pr"])
    c = alg.pagerank(_graph(GD, "cpu").reverse(), num_iters=8)
    torch.testing.assert_close(a.graph.vdata["pr"].cpu(), c.graph.vdata["pr"],
                               rtol=1e-5, atol=1e-6)


def test_label_send_dm16_on_card(cuda):
    """Label propagation's send, a 16-column message (integer remainder,
    16 comparisons), on labels of both signs: bit-equal to the plain
    version and the ordered model (integer-valued sums)."""
    g = _graph(SGD, cuda).mapV(lambda vid, v: {"label": vid % 16})
    send, _ = alg.label_propagation_fns(16)
    spec = mt.fused_plan(g, send, "sum").kernel
    assert spec.dm == 16
    _, ev, live = _triplet_inputs(g, 1, seed=17)
    gen = torch.Generator().manual_seed(3)
    x = torch.randint(-40, 40, (P * g.s.v_mir, 1), generator=gen).float()
    out, want = _check_triplet(g, spec, x.to(cuda), ev, live, "dst", "sum")
    assert torch.equal(out, want)


def test_label_apply_dm16_on_card(cuda):
    """Label propagation's apply, a 16-column message through an amax and
    a first-argmax chain: bit-equal to the plain version, with ties and
    vertices without votes."""
    g = _graph(GD, cuda).mapV(lambda vid, v: {"label": vid % 16})
    send, vprog = alg.label_propagation_fns(16)
    plan = mt._plan_apply(g, vprog, send, "sum", None,
                          {"votes": torch.zeros(16)}, None)
    assert plan is not None and plan.dm == 16
    send_idx = g.s.routes["dst"][0]
    rng = np.random.default_rng(11)
    votes = rng.integers(0, 3, tuple(send_idx.shape) + (16,)).astype(
        np.float32)
    votes[rng.random(tuple(send_idx.shape)) < 0.3] = 0
    recv = {"votes": torch.from_numpy(votes).to(cuda)}
    rflags = (send_idx >= 0) & torch.from_numpy(
        rng.random(tuple(send_idx.shape)) < 0.8).to(cuda)
    before = app_mod.fused_apply.launches
    new, changed = mt.fused_apply_home(g, recv, rflags, "dst", "sum", plan,
                                       "auto")
    want, wchanged = mt.fused_apply_home(g, recv, rflags, "dst", "sum", plan,
                                         "ref")
    torch.cuda.synchronize()
    assert app_mod.fused_apply.launches == before + 1
    assert torch.equal(changed, wchanged)
    assert torch.equal(new["label"], want["label"])
    assert bool(changed.any()) and not bool(changed.all())


def test_sssp_label_propagation_triangles_on_card(cuda):
    """The slice's algorithms on the card: fused == unfused, and equal to
    the CPU run (SSSP, labels and triangle counts exactly)."""
    rng = np.random.default_rng(1)
    w = rng.uniform(0.5, 3, SGD.num_edges).astype(np.float32)
    out = {}
    for dev in (cuda, "cpu"):
        g = Graph.from_edges(SGD.src, SGD.dst, edge_values={"w": w},
                             num_partitions=P, device=dev)
        s_f, s_u = (alg.sssp(g, 0, kernel_mode=m) for m in ("auto", "unfused"))
        assert torch.equal(s_f.graph.vdata["dist"], s_u.graph.vdata["dist"])
        gl = g.mapV(lambda vid, v: {"label": vid % 16})
        l_f, l_u = (alg.label_propagation(gl, 16, num_iters=6, kernel_mode=m)
                    for m in ("auto", "unfused"))
        assert torch.equal(l_f.graph.vdata["label"], l_u.graph.vdata["label"])
        per, total, _ = alg.triangle_count(g, n_ids=SGD.num_vertices)
        out[str(dev)] = (s_f.graph.vdata["dist"], l_f.graph.vdata["label"],
                         per, total)
    for a, b in zip(out[str(cuda)], out["cpu"]):
        assert torch.equal(a.cpu(), b)


ENCODED = {"int8": ("int8", "scaled"), "e4m3": ("fp8_e4m3", "scaled"),
           "e5m2": ("fp8_e5m2", "scaled"), "int16": ("int8", "int"),
           "bf16": (None, None)}


@pytest.mark.parametrize("graph", ["rmat", "hub"])
@pytest.mark.parametrize("to", ["dst", "src"])
@pytest.mark.parametrize("reduce", ["sum", "max"])
@pytest.mark.parametrize("enc", sorted(ENCODED))
def test_triplet_kernel_on_encoded_rows(enc, reduce, to, graph, cuda):
    """The kernel on (payload, scale plane), or on bf16 rows, equals the
    kernel on the decoded f32 rows and the ordered model bit for bit;
    zeroing the scale plane must break the equality."""
    g = _graph(GD if graph == "rmat" else HUB, cuda, _vdata_f)
    s = g.s
    spec = mt.fused_plan(g, _send_f, reduce).kernel
    x, ev, live = _triplet_inputs(g, 2, seed=13)
    codec_name, kind = ENCODED[enc]
    if kind == "int":
        x = x.mul(1000).round().to(torch.int32)
    xv = x.reshape(P, s.v_mir, 2)
    if enc == "e5m2":
        xv = xv * 50.0
    xscale = None
    if codec_name is None:
        xe = x.to(torch.bfloat16)
    else:
        codec = wire_mod.make_codec(codec_name, resident=True)
        leaf = wire_mod.encode_resident(xv, codec, kind, bound=32767)
        xe = leaf.payload.reshape(P * s.v_mir, 2)
        nb = -(-s.v_mir // ref.SCALE_GROUP)
        xscale = (torch.zeros((P * nb, 2), dtype=torch.int8, device=cuda)
                  if leaf.scale is None else
                  leaf.scale.reshape(P * nb, 2).contiguous())
    dec = ref.dequant_rows(xe, xscale, P)
    if codec_name is not None:
        assert torch.equal(dec, leaf.decode().reshape(-1, 2).float())
    args = (ev, s.src_slot, s.dst_slot, live, s.agg_ptr[to],
            s.src_perm if to == "src" else None, spec)
    kw = dict(to=to, reduce=reduce, pieces=s.agg_pieces[to])
    ops.reset_launch_counts()
    out, cnt = tri_mod.fused_triplet(xe, *args, xscale=xscale, **kw)
    out_f, cnt_f = tri_mod.fused_triplet(dec, *args, **kw)
    exact, _ = ref.ordered_triplet(dec, *args, s.agg_pieces[to],
                                   reduce=reduce)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts[f"triplet_{tri_mod.variant(xe.dtype, xscale is not None)}"] \
        == 1 and counts["triplet_f32"] == 1
    assert torch.equal(out, out_f) and torch.equal(cnt, cnt_f)
    assert torch.equal(out, exact)
    if xscale is not None and bool((xscale != 0).any()):
        bad, _ = tri_mod.fused_triplet(xe, *args, xscale=torch.zeros_like(
            xscale), **kw)
        assert not torch.equal(bad, out)
    with pytest.raises(ValueError):
        tri_mod.fused_triplet(xe, *args, xscale=torch.zeros(
            (3, 2), dtype=torch.int8, device=cuda), **kw)


@pytest.mark.parametrize("codec", ["int8", "fp8_e4m3", "fp8_e5m2"])
def test_resident_pagerank_on_card(codec, cuda):
    """Resident PageRank on the card: the fused plan reads the encoded
    mirror through the encoded kernel variant every superstep, and equals
    the unfused plan bit for bit."""
    g = _graph(GD, cuda)
    g = g.replace(ex=with_wire(g.ex, codec, resident=True))
    ops.reset_launch_counts()
    r = alg.pagerank(g, num_iters=8, track_metrics=True)
    name = {"int8": "int8", "fp8_e4m3": "e4m3", "fp8_e5m2": "e5m2"}[codec]
    assert ops.launch_counts()[f"triplet_{name}_scale"] == r.supersteps
    u = alg.pagerank(g, num_iters=8, kernel_mode="unfused")
    assert torch.equal(r.graph.vdata["pr"], u.graph.vdata["pr"])
    assert r.metrics[0]["wire"] == codec


def test_resident_cc_on_card(cuda):
    """CC through an int16-packed resident mirror equals the CPU run."""
    run = lambda g: alg.connected_components(g.replace(  # noqa: E731
        ex=with_wire(g.ex, "int8", resident=True)))
    ops.reset_launch_counts()
    r, cc = _end_to_end(run, SGD, "cc", cuda)
    assert ops.launch_counts()["triplet_int16_scale"] == r.supersteps
    c, cc_c = _end_to_end(run, SGD, "cc", "cpu")
    assert torch.equal(cc, cc_c) and r.supersteps == c.supersteps


@pytest.mark.parametrize("reduce", ["sum", "max"])
def test_triplet_kernel_runs_every_ir_op(reduce, cuda):
    """A UDF using every op of the IR, run by the kernel and by the IR's
    torch evaluation on the same card."""
    vex = {"a": F32, "i": I32}
    tr = analysis.trace_udf(_kitchen, vex, {"w": F32}, vex)
    ir = udf.lower(tr, [("xs", 0), ("xs", 1), ("ev", 0), ("xd", 0),
                        ("xd", 1)])
    assert ir is not None
    spec = tri_mod.TripletUdf(ir, len(ir.outputs))
    g = _graph(GD, cuda)
    x, ev, live = _triplet_inputs(g, 2, seed=7)
    x[:, 1] = (x[:, 1] * 4).round()          # the int column, staged in f32
    _check_triplet(g, spec, x, ev, live, "dst", reduce)


def _pr_vprog(vid, v, msg):
    return {"a": 0.15 + 0.85 * msg["m"], "b": v["b"]}


def _chg(old, new):
    return torch.abs(new["a"] - old["a"]) > 0.05


def _mx_send(sv, ev, dv):
    return {"m": sv["a"]}


def _mx_vprog(vid, v, msg):
    return {"a": torch.maximum(v["a"], msg["m"]), "b": v["b"]}


def _cc_vprog(vid, v, msg):
    return {"c": torch.minimum(v["c"], msg["m"])}


def _vdata_nan(g):
    v = _vdata_f(g)
    v["b"].reshape(-1)[::7] = np.nan
    return v


def _vdata_pad(g):
    return {"c": g.s.home_vid.cpu().numpy().copy()}


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


def _w2_send(sv, ev, dv):
    return {"m": sv["a"] * 2.0}


def _w2_vprog(vid, v, msg):
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


_DELTA_VPROG, _DELTA_CHG = alg.delta_pagerank_fns(0.15, 1e-3)

APPLY_CASES = {
    # name: (vdata, send, vprog, reduce, changed_fn, default, partitions)
    "sum": (_vdata_f, _send_f, _pr_vprog, "sum", None, 0.0, P),
    "sum_changed_fn": (_vdata_f, _send_f, _pr_vprog, "sum", _chg, 0.0, P),
    "max": (_vdata_f, _mx_send, _mx_vprog, "max", None, -1.0, P),
    "min_int": (_vdata_i, _send_i, _cc_vprog, "min", None, 2**31 - 1, P),
    "bf16_message": (_vdata_bf16, _bf_send, _bf_vprog, "sum", None, 0.0, P),
    "width2_leaf": (_vdata_w2, _w2_send, _w2_vprog, "sum", None, 0.0, P),
    "int_pad_invisible": (_vdata_pad, _send_i, _cc_vprog, "min", None,
                          2**31 - 1, P),
    "nan_passthrough": (_vdata_nan, _send_f, _pr_vprog, "sum", None, 0.0, P),
    "delta_changed_fn": (_vdata_delta, alg.delta_pagerank_send, _DELTA_VPROG,
                         "sum", _DELTA_CHG, 0.0, P),
    "sum_p1": (_vdata_f, _send_f, _pr_vprog, "sum", None, 0.0, 1),
    "min_int_p3": (_vdata_i, _send_i, _cc_vprog, "min", None, 2**31 - 1, 3),
    # CTAs of VB 768 (dm 60) and 256 (dm 120) slots, rounded to whole
    # threads by the plan, on partitions wider than one CTA
    "wide_msg60_p1": (_vdata_a, _w60_send, _w60_vprog, "sum", None, 0.0, 1),
    "wide_leaf120_p2": (_vdata_w120, _w2_send, _w2_vprog, "sum", None, 0.0,
                         2),
}


def _same_bits(a, b):
    """Bit equality (NaNs included)."""
    if a.dtype.is_floating_point:
        bits = {4: torch.int32, 2: torch.int16}[a.element_size()]
        a, b = a.view(bits), b.view(bits)
    return torch.equal(a, b)


@pytest.mark.parametrize("case", sorted(APPLY_CASES))
def test_apply_kernel_matches_plain(case, cuda):
    """Both combine in ascending source partition and run the same IR, so
    they agree exactly, sums included (NaNs bit for bit); invisible rows
    keep their old bits and a leaf the vprog passes through is the old
    tensor."""
    vdata, send, vprog, reduce, chg, dflt, p = APPLY_CASES[case]
    gd = rmat(10, 8, seed=42)
    g = Graph.from_edges(gd.src, gd.dst, num_partitions=p, device=cuda)
    g = g.replace(vdata={k: torch.from_numpy(v).to(cuda)
                         for k, v in vdata(g).items()})
    if case == "int_pad_invisible":
        vm = g.vmask.clone()
        vm.reshape(-1)[::5] = False
        g = g.replace(vmask=vm, vmask_full=False)
    is_int = isinstance(dflt, int)
    dtype = torch.int32 if is_int else torch.float32
    plan = mt._plan_apply(g, vprog, send, reduce, chg,
                          {"m": torch.tensor(dflt, dtype=dtype)}, None)
    assert plan is not None
    pl = app_mod.plan(plan.dm, plan.dv)
    if case.startswith("wide_"):         # slots past the first VB / THREADS
        assert g.s.v_blk > pl.threads and pl.vb % pl.threads == 0
    send_idx = g.s.routes["dst"][0]
    rng = np.random.default_rng(11)
    shape = tuple(send_idx.shape) + tuple(plan.msg_specs[0].shape)
    recv = (rng.integers(0, 5000, shape).astype(np.int32) if is_int
            else rng.normal(size=shape).astype(np.float32))
    recv = {"m": torch.from_numpy(recv).to(
        cuda, udf.TORCH_DTYPE[plan.kernel.msgs[0][0]])}
    rflags = (send_idx >= 0) & torch.from_numpy(
        rng.random(tuple(send_idx.shape)) < 0.8).to(cuda)
    before = app_mod.fused_apply.launches
    new, changed = mt.fused_apply_home(g, recv, rflags, "dst", reduce, plan,
                                       "auto")
    want, wchanged = mt.fused_apply_home(g, recv, rflags, "dst", reduce, plan,
                                         "ref")
    torch.cuda.synchronize()
    assert app_mod.fused_apply.launches == before + 1
    assert torch.equal(changed, wchanged)
    written = dict(zip(sorted(g.vdata), plan.kernel.written))
    for k in want:
        assert new[k].dtype == want[k].dtype == g.vdata[k].dtype
        assert _same_bits(new[k], want[k]), k
        assert _same_bits(new[k][~g.vmask], g.vdata[k][~g.vmask]), k
        assert (new[k] is g.vdata[k]) == (not written[k]), k
    if case == "nan_passthrough":
        assert bool((changed & torch.isnan(g.vdata["b"])).any())


@pytest.mark.parametrize("graph", ["rmat", "hub"])
@pytest.mark.parametrize("to", ["dst", "src"])
@pytest.mark.parametrize("d", [1, 3])
def test_segment_sum_kernel_matches_plain(d, to, graph, cuda):
    """The kernel adds in the order of csrc/segorder.cuh, so it must equal
    `ref.ordered_segment_reduce` on the same messages bit for bit (run on
    the CPU, and on the card); slots of at most SEG_PIECE entries also
    equal the plain version's CPU run, which adds in ascending order."""
    g = _graph(GD if graph == "rmat" else HUB, cuda)
    s = g.s
    if graph == "hub":
        assert _longest_slot(g, to) >= 8 * segorder.SEG_PIECE
    rng = np.random.default_rng(d)
    msgs = torch.from_numpy(rng.normal(size=(P, s.e_blk, d))
                            .astype(np.float32)).to(cuda)
    live = (s.edge_mask.cpu() & torch.from_numpy(
        rng.random((P, s.e_blk)) < 0.7)).to(cuda)
    ptr, pieces = s.agg_ptr[to], s.agg_pieces[to]
    before = seg_mod.segment_sum.launches
    got = seg_mod.segment_sum(msgs, live, ptr, pieces)
    want, _ = ref.ordered_segment_reduce(msgs.cpu(), live.cpu(), ptr.cpu(),
                                         pieces)
    on_card, _ = ref.ordered_segment_reduce(msgs, live, ptr, pieces)
    plain = ref.segment_sum(msgs.cpu(), live.cpu(), ptr.cpu()).reshape(-1, d)
    torch.cuda.synchronize()
    assert seg_mod.segment_sum.launches == before + 1
    assert got.shape == (P, s.v_mir, d)
    assert torch.equal(got.cpu().reshape(-1, d), want)
    assert torch.equal(on_card.cpu(), want)
    short = (torch.diff(ptr, dim=1) <= segorder.SEG_PIECE).reshape(-1).cpu()
    assert torch.equal(want[short], plain[short])


def test_wrappers_on_cuda_raise_instead_of_falling_back(cuda):
    g = _graph(GD, cuda, _vdata_f)
    s = g.s
    spec = mt.fused_plan(g, _send_f, "sum").kernel
    x, ev, live = _triplet_inputs(g, 2, seed=5)
    pieces = s.agg_pieces["dst"]
    with pytest.raises(ValueError):
        tri_mod.fused_triplet(x, ev, s.src_slot.long(), s.dst_slot, live,
                              s.agg_ptr["dst"], None, spec, pieces=pieces)
    with pytest.raises(ValueError):         # the piece tables are required
        tri_mod.fused_triplet(x, ev, s.src_slot, s.dst_slot, live,
                              s.agg_ptr["dst"], None, spec)
    with pytest.raises(ValueError):
        tri_mod.fused_triplet(x, ev, s.src_slot, s.dst_slot, live,
                              s.agg_ptr["dst"], None, spec,
                              pieces=pieces._replace(seg=pieces.seg[:, :-1]))
    with pytest.raises(ValueError):
        seg_mod.segment_sum(torch.ones(P, s.e_blk, 1, device=cuda), live,
                            s.agg_ptr["dst"].long(), pieces)
    with pytest.raises(ValueError):
        seg_mod.segment_sum(torch.ones(P, s.e_blk, 1, device=cuda), live,
                            s.agg_ptr["dst"], pieces._replace(
                                ptr=pieces.ptr.long()))


def _end_to_end(run, gd, leaf, device):
    r = run(_graph(gd, device))
    return r, r.graph.vdata[leaf].cpu()


@pytest.mark.parametrize("graph", ["rmat", "hub"])
@pytest.mark.parametrize("tol", [0.0, 1e-3])
def test_pagerank_on_card(tol, graph, cuda):
    """Fused == unfused bit for bit on the card (both kernels sum in the
    order of csrc/segorder.cuh; the hub graph's slots span many pieces),
    and within f32 rounding of the CPU run."""
    gd = GD if graph == "rmat" else HUB
    run = lambda g, **kw: alg.pagerank(g, num_iters=12, tol=tol,  # noqa: E731
                                       track_metrics=True, **kw)
    ops.reset_launch_counts()
    r, pr = _end_to_end(run, gd, "pr", cuda)
    counts = ops.launch_counts()
    assert counts["triplet"] >= r.supersteps + 1          # + the degree pass
    assert counts["apply"] == r.supersteps
    assert (r.metrics[0]["plan"], r.metrics[0]["apply_plan"]) == \
        ("fused", "fused_apply")
    u, pr_u = _end_to_end(lambda g: run(g, kernel_mode="unfused"), gd, "pr",
                          cuda)
    assert ops.launch_counts()["segment_sum"] > 0
    assert torch.equal(pr, pr_u) and r.supersteps == u.supersteps
    c, pr_c = _end_to_end(run, gd, "pr", "cpu")
    assert r.supersteps == c.supersteps
    torch.testing.assert_close(pr, pr_c, rtol=1e-5, atol=1e-6)


def test_connected_components_on_card(cuda):
    run = lambda g, **kw: alg.connected_components(g, **kw)  # noqa: E731
    r, cc = _end_to_end(run, SGD, "cc", cuda)
    u, cc_u = _end_to_end(lambda g: run(g, kernel_mode="unfused"), SGD, "cc",
                          cuda)
    c, cc_c = _end_to_end(run, SGD, "cc", "cpu")
    assert torch.equal(cc, cc_u) and torch.equal(cc, cc_c)
    assert r.supersteps == u.supersteps == c.supersteps


def test_more_senior_on_card(cuda):
    rng = np.random.default_rng(2)
    age = lambda g: {"a": rng.integers(18, 70, tuple(g.s.home_vid.shape))  # noqa: E731
                     .astype(np.float32)}
    g = _graph(GD, cuda, age)
    vals, exists, _, m = g.mrTriplets(_more_senior, "sum")
    uvals, uexists, _, _ = g.mrTriplets(_more_senior, "sum",
                                        kernel_mode="unfused")
    gc = _graph(GD, "cpu").replace(vdata={"a": g.vdata["a"].cpu()})
    cvals, cexists, _, _ = gc.mrTriplets(_more_senior, "sum")
    assert m["plan"] == "fused"
    assert torch.equal(exists, uexists) and torch.equal(vals["n"], uvals["n"])
    assert torch.equal(exists.cpu(), cexists)
    assert torch.equal(vals["n"].cpu(), cvals["n"])


# ------------------------------------------------------- float math, scope
def _exp_send(sv, ev, dv):
    return {"m": torch.exp(sv["a"] * 0.5) * ev["w"]}


def _math_max(sv, ev, dv):
    a, b = sv["a"], dv["b"]
    pos = torch.abs(a) + 0.5
    return {"m": torch.log(pos) + torch.log1p(pos) + torch.expm1(b)
            + torch.sqrt(pos) + torch.tanh(a) + torch.sigmoid(b)
            + torch.sin(a) * torch.cos(b) + torch.floor(a * 3.0)
            + torch.ceil(b) + torch.sign(a - b) + torch.pow(a, 2)
            + torch.pow(pos, 1.7) + torch.clamp(b, -0.5, 0.5)
            + torch.reciprocal(pos)}


def _vec_data(g):
    rng = np.random.default_rng(6)
    return {"v": rng.normal(size=tuple(g.s.home_vid.shape) + (3,))
            .astype(np.float32)}


def _vec_send(sv, ev, dv):
    return {"m": torch.exp(sv["v"]) * ev["w"] + dv["v"][0]}


def _reductions_data(g):
    rng = np.random.default_rng(7)
    shape = tuple(g.s.home_vid.shape)
    return {"a": rng.normal(size=shape).astype(np.float32),
            "v": rng.normal(size=shape + (3,)).astype(np.float32),
            "r": rng.integers(-50, 50, shape + (3,)).astype(np.int32)}


def _atan_sum(sv, ev, dv):
    return {"m": torch.atan2(sv["a"], dv["a"]) * ev["w"]
            + torch.atan(dv["a"])}


def _reductions_max(sv, ev, dv):
    return {"m": sv["v"].amax() - torch.amin(dv["v"]) + sv["v"].max()
            + sv["r"].sum().to(torch.float32) * 0.01}


@pytest.mark.parametrize("case", ["exp_sum", "math_max", "vector_sum",
                                  "bf16_sum", "atan_sum", "reductions_max"])
def test_fused_equals_unfused_on_card(case, cuda):
    """The triplet kernel's libm calls (expf, logf, atanf, atan2f, ...)
    against torch's CUDA ops in the unfused plan, rank-1 leaves and their
    order-free reductions (amax, amin, an integer sum), and bf16 leaves:
    the two plans agree bit for bit on the card."""
    if case in ("atan_sum", "reductions_max"):
        g = _graph(GD, cuda, _reductions_data)
        send, reduce = {"atan_sum": (_atan_sum, "sum"),
                        "reductions_max": (_reductions_max, "max")}[case]
    elif case == "vector_sum":
        g, send, reduce = _graph(GD, cuda, _vec_data), _vec_send, "sum"
    elif case == "bf16_sum":
        g = _graph(GD, cuda, _vdata_f)
        g = g.replace(vdata={k: v.to(torch.bfloat16)
                             for k, v in g.vdata.items()})
        send, reduce = (lambda sv, ev, dv: {"m": torch.exp(sv["a"])
                                            * dv["b"]}), "sum"
    else:
        g = _graph(GD, cuda, _vdata_f)
        send, reduce = {"exp_sum": (_exp_send, "sum"),
                        "math_max": (_math_max, "max")}[case]
    assert mt.plan_of(g, send, reduce) == "fused"
    before = tri_mod.fused_triplet.launches
    vals, exists, _, m = g.mrTriplets(send, reduce)
    assert m["plan"] == "fused" and tri_mod.fused_triplet.launches == before + 1
    uvals, uexists, _, _ = g.mrTriplets(send, reduce, kernel_mode="unfused")
    assert torch.equal(exists, uexists)
    for k in vals:
        assert vals[k].dtype == uvals[k].dtype
        assert torch.equal(vals[k], uvals[k]), k


# ------------------------------------------------------------ flash kernel
FLASH_SHAPES = [
    (2, 4, 2, 64, 64, 32, True, 0),
    (1, 8, 1, 100, 100, 64, True, 0),
    (1, 4, 4, 1, 300, 32, True, 299),
    (2, 2, 2, 48, 96, 16, True, 48),
    (1, 2, 1, 64, 64, 32, False, 0),
    (1, 2, 2, 40, 72, 128, False, 0),
    (4, 32, 8, 1, 1664, 128, False, 0),       # the serve step's shape
    (1, 8, 2, 300, 700, 128, True, 400),      # chunked prefill, ragged
    (2, 8, 2, 1, 1000, 128, False, 0),        # decode, ragged last split
    (1, 4, 2, 1, 20, 64, False, 0),           # Lk below one tile
    (1, 4, 2, 40, 200, 40, True, 100),        # splits wholly masked per tile
    (1, 2, 2, 40, 90, 16, True, 0),           # Dh 16
    (1, 4, 2, 70, 150, 40, True, 10),         # Dh 40: CUDA cores in bf16
    (1, 8, 2, 4, 700, 64, True, 500),         # decode, causal over splits
    (1, 2, 2, 64, 200, 128, True, 136),       # one full tensor-core tile
    (1, 2, 2, 130, 260, 128, True, 130),      # two tiles and 2 rows
]


def _flash_body(shape, dtype):
    """The body `plan` documents for a shape (group x Lq query rows)."""
    b, hq, hkv, lq, lk, dh = shape[:6]
    if dtype == "bfloat16" and dh % 16 == 0:
        return "decode" if hq // hkv * lq <= 16 else "tensor_core"
    return "cuda_core"


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=str)
def test_flash_kernel_matches_plain(shape, dtype, causal, cuda):
    """Kernel against the plain version on the card, through the body
    `plan` documents for the shape: 3e-5 in f32; in bf16, whose output
    rounds, each output within one bf16 spacing of the plain one
    (2 * 2^-8 * |plain| + 1e-6, chip_smoke.py's `flash_limit`), which a
    dropped or mis-merged key split breaks."""
    from repro_torch.kernels import flash_attention as flash_mod
    b, hq, hkv, lq, lk, dh, _, off = shape
    rng = np.random.default_rng(lq + lk)
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(cuda).to(dt) for s in ((b, hq, lq, dh), (b, hkv, lk, dh),
                                          (b, hkv, lk, dh)))
    body = _flash_body(shape, dtype)
    before = flash_mod.flash_attention.launches
    ran = flash_mod.flash_attention.bodies[body]
    got = flash_mod.flash_attention(q, k, v, causal=causal, kv_offset=off)
    want = ref.flash_attention(q, k, v, causal=causal, kv_offset=off)
    torch.cuda.synchronize()
    assert flash_mod.flash_attention.launches == before + 1
    assert flash_mod.flash_attention.bodies[body] == ran + 1
    assert got.dtype == dt and got.shape == q.shape
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=3e-5, atol=3e-5)
    else:
        diff = (got.float() - want.float()).abs()
        limit = 2 * 2.0 ** -8 * want.float().abs() + 1e-6
        assert not bool((diff > limit).any()), (
            f"{int((diff > limit).sum())} outputs beyond one bf16 spacing; "
            f"max |err| {float(diff.max())}")


def test_flash_kernel_dead_rows_and_layouts(cuda):
    """Rows that see no key write 0.  Permuted q/k/v as the einsum of the
    cross-attention leaves them are read in place, without a copy, and give
    the same bits as contiguous copies, on every body; inputs whose Dh
    stride is not 1 are copied and still right; odd inputs raise."""
    from repro_torch.kernels import flash_attention as flash_mod
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda)
               for s in ((1, 4, 8, 32), (1, 2, 8, 32), (1, 2, 8, 32)))
    out = flash_mod.flash_attention(q, k, v, causal=True, kv_offset=-3)
    assert torch.all(out[:, :, :3] == 0)
    torch.testing.assert_close(out, ref.flash_attention(
        q, k, v, causal=True, kv_offset=-3), rtol=3e-5, atol=3e-5)

    def heads(x, h):                  # [B, L, d] -> [B, h, L, 64], permuted
        w = torch.from_numpy(rng.normal(size=(x.shape[2], h, 64))
                             .astype(np.float32) / 16).to(cuda, x.dtype)
        return torch.einsum("bld,dhk->bhlk", x, w)

    for dtype, lq, causal in ((torch.bfloat16, 1, False),
                              (torch.bfloat16, 200, True),
                              (torch.float32, 40, True)):
        x = torch.from_numpy(rng.normal(size=(2, lq, 96)).astype(np.float32))
        ctx = torch.from_numpy(rng.normal(size=(2, 300, 96))
                               .astype(np.float32))
        x, ctx = x.to(cuda, dtype), ctx.to(cuda, dtype)
        qp = heads(x, 8)
        kp = heads(ctx, 2) if not causal else heads(x, 2)
        vp = heads(ctx, 2) if not causal else heads(x, 2)
        assert not kp.is_contiguous() and (lq == 1 or not qp.is_contiguous())
        copies = flash_mod.flash_attention.copies
        got = flash_mod.flash_attention(qp, kp, vp, causal=causal)
        assert flash_mod.flash_attention.copies == copies
        flat = flash_mod.flash_attention(qp.contiguous(), kp.contiguous(),
                                         vp.contiguous(), causal=causal)
        assert torch.equal(got, flat)
        kt = kp.transpose(2, 3).contiguous().transpose(2, 3)   # Dh stride L
        got = flash_mod.flash_attention(qp, kt, vp, causal=causal)
        assert flash_mod.flash_attention.copies == copies + 1
        assert torch.equal(got, flat)
    with pytest.raises(ValueError):
        flash_mod.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        flash_mod.flash_attention(q[..., :12].contiguous(),
                                  k[..., :12].contiguous(),
                                  v[..., :12].contiguous())


def test_serve_smoke_on_card_goes_through_the_kernel(cuda):
    """llama-3.2-vision SMOKE served on the card: one cross-attention layer
    launches the flash kernel once per step, and teacher-forced decode
    steps follow the CPU steps of the same weights within bf16 rounding."""
    from repro_torch import configs as C
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    ops.reset_launch_counts()
    serve.run("llama-3.2-vision-11b", smoke=True, batch=2, prompt_len=4,
              gen=4, device="cuda")
    assert ops.launch_counts()["flash_attention"] == 4 + 3
    cfg = C.get("llama-3.2-vision-11b", smoke=True)
    cpu = torch.device("cpu")
    params, ctx, toks = serve.setup(cfg, 2, 4, cpu)
    gparams, gctx = tree_map(lambda t: t.to(cuda), params), ctx.to(cuda)
    cst = T.init_decode_state(cfg, 2, 4, device=cpu)
    gst = T.init_decode_state(cfg, 2, 4, device=cuda)
    for pos in range(4):
        tok = toks[:, pos:pos + 1]
        cl, cst = T.decode_step(params, cst, tok, pos, cfg, cross_ctx=ctx)
        gl, gst = T.decode_step(gparams, gst, tok.to(cuda), pos, cfg,
                                cross_ctx=gctx)
        torch.testing.assert_close(gl.cpu(), cl, rtol=3e-2, atol=3e-2)


# ------------------------------------------------------------ mLSTM kernels
MLSTM_SHAPES = [
    (1, 2, 64, 16, 16), (2, 1, 128, 32, 32), (1, 4, 96, 8, 48),
    (2, 2, 32, 64, 32), (1, 1, 128, 256, 64),
    (2, 2, 128, 32, 64),        # xlstm-350m SMOKE heads (Dh 32, chunk 64)
    (1, 2, 256, 64, 128), (1, 1, 256, 256, 128),
    (1, 2, 64, 64, 16), (1, 1, 64, 256, 16),   # chunk 16, scan tile 64 x 64
]


def _mlstm_inputs(b, h, l, dh, cuda, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(b, h, l, dh)) * 0.5,
            rng.normal(size=(b, h, l, dh)) * 0.5,
            rng.normal(size=(b, h, l, dh)),
            np.clip(rng.normal(size=(b, h, l)), -8, 4),
            -np.abs(rng.normal(size=(b, h, l))) * 0.2]
    return [torch.from_numpy(a.astype(np.float32)).to(cuda) for a in arrs]


@pytest.mark.parametrize("shape", MLSTM_SHAPES, ids=str)
def test_mlstm_kernels_match_plain(shape, cuda):
    """Forward within the CPU sweep's rtol/atol 2e-4 of the plain version
    on the card; the backward kernel's gradients within 1e-4 relative norm
    of autograd through the plain version, per input; each launches once;
    two runs are bit-equal (no atomics).  A tensor-core build's own shared
    memory sizes are the ones `plan` decided on.  At (1, 1, 256, 256, 128)
    the gradients read 1.9e-5 to 4.6e-5 over numpy seeds 0-4 on an NVIDIA
    H100 80GB HBM3 (scripts/mlstm_kernel_sweep.py); the plain version's own
    error against a float64 run there is up to 6.8e-5."""
    from repro_torch.kernels import mlstm as mlstm_mod
    b, h, l, dh, chunk = shape
    pl = mlstm_mod.plan(min(chunk, l), dh)
    if pl.body == "tensor_core":
        assert mlstm_mod.layout(pl, b * h, l)["smem"] == pl.smem
    ins = _mlstm_inputs(b, h, l, dh, cuda)
    a = [t.clone().requires_grad_() for t in ins]
    p = [t.clone().requires_grad_() for t in ins]
    ops.reset_launch_counts()
    out = mlstm_mod.mlstm_chunked(*a, chunk=chunk)
    want = ref.mlstm_chunked(*p, chunk=chunk)
    dout = torch.from_numpy(np.random.default_rng(1).normal(
        size=out.shape).astype(np.float32)).to(cuda)
    grads = torch.autograd.grad(out, a, dout)
    pgrads = torch.autograd.grad(want, p, dout)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["mlstm_fwd"] == counts["mlstm_bwd"] == 1
    torch.testing.assert_close(out, want, rtol=2e-4, atol=2e-4)
    for g, pg in zip(grads, pgrads):
        assert float((g - pg).norm() / pg.norm()) <= 1e-4
    out2 = mlstm_mod.mlstm_chunked(*a, chunk=chunk)
    assert torch.equal(out, out2)
    assert all(torch.equal(x, y) for x, y in
               zip(grads, torch.autograd.grad(out2, a, dout)))


def test_mlstm_without_grad_saves_no_states(cuda):
    """Under no_grad (or with inputs that need no grad) the forward writes
    no chunk-entry states and builds no graph; odd shapes raise."""
    from repro_torch.kernels import mlstm as mlstm_mod
    ins = _mlstm_inputs(2, 2, 128, 32, cuda)
    with torch.no_grad():
        before = torch.cuda.memory_allocated()
        out = mlstm_mod.mlstm_chunked(*ins, chunk=64)
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() - before == out.numel() * 4
    assert out.grad_fn is None
    with pytest.raises(ValueError):
        mlstm_mod.mlstm_chunked(*ins, chunk=40)
    with pytest.raises(ValueError):        # L 100 is no multiple of 64
        mlstm_mod.mlstm_chunked(*_mlstm_inputs(1, 1, 100, 32, cuda), chunk=64)


@pytest.mark.parametrize("hub", [False, True])
@pytest.mark.parametrize("active", [False, True])
def test_spmv_on_card_matches_plain(active, hub, cuda):
    """spmv through the triplet kernel (one launch each) against its plain
    version on the card, rtol 1e-5 (index_add_ adds with atomics), and bit
    for bit against the ordered model of the kernel's summation order
    (with a hub row of 2000 edges: many pieces)."""
    from repro_torch.kernels import spmv as spmv_mod
    rng = np.random.default_rng(4)
    v, e, d = 300, 4000, 3
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    if hub:
        dst[:2000] = 7
    mask = rng.random(e) > 0.1
    w = (rng.normal(size=e) * mask).astype(np.float32)
    x = rng.normal(size=(v, d)).astype(np.float32)
    tiles = spmv_mod.build_tiles(src, dst, mask, v)
    act = torch.from_numpy(rng.random(-(-v // 64)) < 0.5).to(cuda) \
        if active else None
    args = [torch.from_numpy(a).to(cuda) for a in (x, w, src, dst)]
    before = spmv_mod.spmv.launches
    got = ops.spmv(*args, tiles, act, v, vb=64)
    want = ops.spmv(*args, tiles, act, v, vb=64, mode="ref")
    t = {k: torch.from_numpy(a).to(cuda) for k, a in tiles.items()}
    live = spmv_mod.live_edges(args[2], act, 64, e)
    exact, _ = ref.ordered_triplet(
        args[0], args[1].reshape(e, 1), args[2].reshape(1, e),
        args[3].reshape(1, e), live.reshape(1, e), t["ptr"].reshape(1, -1),
        t["perm"].reshape(1, e), spmv_mod.linear_message(d),
        segorder.Pieces(t["piece_ptr"], t["piece_seg"], t["piece_multi"]))
    torch.cuda.synchronize()
    assert spmv_mod.spmv.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, exact)
    assert (t["piece_multi"].numel() > 0) == hub


def test_train_smoke_on_card_goes_through_the_kernels(cuda):
    """xlstm-350m SMOKE: two training steps on the card launch the mLSTM
    forward and backward kernels 3 times each per step (3 mLSTM layers) and
    follow the CPU run of the same weights and batches: losses within
    2e-3 relative (bf16 einsums round differently on the two devices)."""
    from repro_torch import configs as C
    from repro_torch.data.tokens import SyntheticLM
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_loop as tl
    cfg = C.get("xlstm-350m", smoke=True)
    step = tl.make_train_step(cfg, opt.AdamWConfig(total_steps=2,
                                                   warmup_steps=5))
    data = SyntheticLM(cfg.vocab, 128, 2, seed=0)

    def two_steps(params, device):
        state, losses = opt.init(params), []
        for i in range(2):
            batch = {k: torch.from_numpy(a).to(device)
                     for k, a in data.batch(i).items()}
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
        return losses

    cpu = tl.init_params(cfg, 0, "cpu")
    gpu = tree_map(lambda t: t.detach().to(cuda).requires_grad_(True), cpu)
    ops.reset_launch_counts()
    g = two_steps(gpu, cuda)
    counts = ops.launch_counts()
    assert counts["mlstm_fwd"] == counts["mlstm_bwd"] == 3 * 2
    np.testing.assert_allclose(g, two_steps(cpu, "cpu"), rtol=2e-3)

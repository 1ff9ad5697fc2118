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
PageRank equals it within rtol 1e-5, atol 1e-6.  The collection operators
(the hash, shuffle_by_key, reduce_by_key with f32 sums over a hub key of
more than 32 k entries, left_join, compact), the graph joins and a planned
chain equal the CPU run bit for bit.
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
    (1, 4, 2, 40, 200, 192, True, 100),       # Dh 192: the wide body in bf16
    (1, 10, 1, 70, 150, 256, True, 80),       # Dh 256, MQA group 10, splits
    (1, 10, 1, 1, 300, 256, True, 299),       # Dh 256 decode, as the ring
    (1, 10, 1, 200, 400, 256, True, 200),     # Dh 256, 4 row tiles, 1 split
    (1, 4, 2, 70, 150, 144, True, 10),        # Dh 144: a padded column block
]


def _flash_body(shape, dtype):
    """The body `plan` documents for a shape (group x Lq query rows; above
    Dh 128 the wide tensor-core body, or the CUDA-core body at 16 rows or
    fewer)."""
    b, hq, hkv, lq, lk, dh = shape[:6]
    if dtype != "bfloat16" or dh % 16:
        return "cuda_core"
    if hq // hkv * lq <= 16:
        return "decode" if dh <= 128 else "cuda_core"
    return "tensor_core" if dh <= 128 else "tensor_core_wide"


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=str)
def test_flash_kernel_lse_matches_plain(shape, dtype, causal, cuda):
    """Every body writes each row's log-sum-exp where asked: per row
    within 1e-5 relative plus 1e-4 of `ref.flash_lse` (f32 sums of the
    same terms in other orders, and in bf16 the tensor cores' truncated
    sums of the exact products: the lse is O(10)), +inf on dead rows, and
    the same output bits as the call without it."""
    from repro_torch.kernels import flash_attention as flash_mod
    b, hq, hkv, lq, lk, dh, _, off = shape
    rng = np.random.default_rng(lq + lk)
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(cuda).to(dt) for s in ((b, hq, lq, dh), (b, hkv, lk, dh),
                                          (b, hkv, lk, dh)))
    kw = dict(causal=causal, kv_offset=off)
    out, lse = flash_mod.flash_attention_lse(q, k, v, **kw)
    want = ref.flash_lse(q, k, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, flash_mod.flash_attention(q, k, v, **kw))
    assert lse.dtype == torch.float32 and lse.shape == (b, hq, lq)
    dead = torch.isinf(want)
    assert torch.equal(torch.isinf(lse), dead) and bool((lse[dead] > 0).all())
    diff = (lse[~dead] - want[~dead]).abs()
    assert bool((diff <= 1e-5 * want[~dead].abs() + 1e-4).all()), (
        f"max |lse err| {float(diff.max())}")


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


# ---------------------------------------------------- flash backward kernel
FLASH_BWD_SHAPES = [
    (2, 4, 2, 64, 64, 32, True, 0),
    (1, 10, 1, 128, 256, 256, True, 128),     # the windowed call, small
    (1, 4, 4, 77, 131, 16, True, 5),          # ragged tiles
    (1, 6, 2, 33, 65, 128, False, 0),
    (1, 2, 1, 70, 70, 64, True, -3),          # dead rows
    (2, 8, 2, 200, 700, 192, True, 400),      # Dh 192: column halves
    (1, 4, 1, 1, 300, 64, True, 299),         # one query row
    (1, 2, 2, 40, 300, 32, True, 100),        # keys no query sees
    (1, 4, 2, 90, 150, 144, True, 20),        # Dh 144: a padded column block
    (1, 10, 1, 100, 100, 256, True, -5),      # dead rows at Dh 256
    (1, 4, 2, 50, 90, 256, False, 0),         # column halves, non-causal
    (2, 2, 1, 30, 20, 256, False, 0),         # Lq, Lk below one tile
]


@pytest.mark.parametrize("shape", FLASH_BWD_SHAPES, ids=str)
def test_flash_backward_matches_plain(shape, cuda):
    """The backward kernel against `ref.flash_attention_backward` on the
    same bf16 inputs and cotangent: each gradient within 1e-2 relative norm
    (chip_smoke.py's FLASH_GRAD_REL_LIMIT: P and dS enter the tensor cores
    as one bf16 term each), finite, zero on dead rows and on keys no query
    sees, two runs bit-equal, one launch a call."""
    from repro_torch.kernels import flash_attention as flash_mod
    b, hq, hkv, lq, lk, dh, causal, off = shape
    rng = np.random.default_rng(lq * 7 + lk)
    q, k, v, dout = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                     .to(cuda, torch.bfloat16) for s in (
                         (b, hq, lq, dh), (b, hkv, lk, dh), (b, hkv, lk, dh),
                         (b, hq, lq, dh)))
    kw = dict(causal=causal, kv_offset=off)
    out, lse = flash_mod.flash_attention_lse(q, k, v, **kw)
    before = flash_mod.flash_attention_bwd.launches
    got = flash_mod.flash_attention_bwd(q, k, v, out, dout, lse=lse, **kw)
    again = flash_mod.flash_attention_bwd(q, k, v, out, dout, lse=lse, **kw)
    want = ref.flash_attention_backward(q, k, v, out, dout, **kw)
    torch.cuda.synchronize()
    assert flash_mod.flash_attention_bwd.launches == before + 2
    assert all(map(torch.equal, got, again))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert bool(torch.isfinite(g.float()).all())
        rel = (g.float() - w.float()).norm() / w.float().norm().clamp_min(
            1e-30)
        assert float(rel) <= 1e-2
    if off < 0:
        assert not bool(got[0][:, :, :-off].any())
    if causal and lk > lq + off:
        assert not bool(got[1][:, :, lq + off:].any())


def test_flash_autograd_runs_the_backward_kernel(cuda):
    """Sliding-window attention on the card: the windowed call and chunk
    0's strided call each launch the forward once and the backward once,
    no input is copied, and the gradients agree with autograd of the plain
    version within 1e-2 relative norm."""
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.models import layers as L
    rng = np.random.default_rng(11)
    base = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        cuda, torch.bfloat16) for s in ((2, 4, 128, 64), (2, 1, 128, 64),
                                        (2, 1, 128, 64), (2, 4, 128, 64))]
    fwd, bwd = flash_mod.flash_attention, flash_mod.flash_attention_bwd
    counts = (fwd.launches, bwd.launches, fwd.copies, bwd.copies)
    ins = [t.clone().requires_grad_() for t in base[:3]]
    out = L._windowed_attention(*ins, 32, "auto")
    grads = torch.autograd.grad(out, ins, base[3])
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches, fwd.copies, bwd.copies) == (
        counts[0] + 2, counts[1] + 2, counts[2], counts[3])
    pins = [t.clone().requires_grad_() for t in base[:3]]
    want = torch.autograd.grad(L._windowed_attention(*pins, 32, "ref"), pins,
                               base[3])
    for g, w in zip(grads, want):
        rel = (g.float() - w.float()).norm() / w.float().norm()
        assert float(rel) <= 1e-2


def test_flash_backward_refuses_what_it_does_not_take(cuda):
    """f32, a Dh that is not a multiple of 16 or above 256, and a missing
    or misshapen log-sum-exp raise."""
    from repro_torch.kernels import flash_attention as flash_mod
    for dh, dt, lse_shape in ((32, torch.float32, (1, 2, 8)),
                              (40, torch.bfloat16, (1, 2, 8)),
                              (272, torch.bfloat16, (1, 2, 8)),
                              (64, torch.bfloat16, None),
                              (64, torch.bfloat16, (1, 2, 7))):
        q = torch.zeros((1, 2, 8, dh), dtype=dt, device=cuda)
        k = torch.zeros((1, 1, 8, dh), dtype=dt, device=cuda)
        lse = None if lse_shape is None else torch.zeros(
            lse_shape, device=cuda)
        with pytest.raises(ValueError, match="flash_attention_bwd"):
            flash_mod.flash_attention_bwd(q, k, k, q, q, lse=lse,
                                          causal=True)


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
    backward kernel 3 times per step (3 mLSTM layers) and the forward 6
    (the per-super-layer recompute, remat=True, runs each again in the
    backward) and follow the CPU run of the same weights and batches:
    losses within 2e-3 relative (bf16 einsums round differently on the two
    devices)."""
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
    assert counts["mlstm_bwd"] == 3 * 2 and counts["mlstm_fwd"] == 2 * 3 * 2
    np.testing.assert_allclose(g, two_steps(cpu, "cpu"), rtol=2e-3)



# ------------------------------------------------------------ MoE blocks
def _grads_of_one_step(cfg, params, batch):
    """The loss and every gradient of one training step's loss_fn."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models import transformer as T
    leaves = tree_leaves(params)
    for t in leaves:
        t.grad = None
    loss = T.loss_fn(params, batch, cfg)
    loss.backward()
    grads = [t.grad for t in leaves]
    for t in leaves:
        t.grad = None
    return loss.detach(), grads


def test_arctic_smoke_serves_and_trains_on_card(cuda):
    """arctic-480b SMOKE (MoE with the dense residual's MLP beside it) on
    the card: served through `launch.serve`, its teacher-forced decode
    steps follow the CPU's within bf16 rounding (no kernel on this path:
    the decode step's self-attention is plain, as in the reference); a
    training step's loss follows the CPU's within 2e-3 relative, its flash
    launches are one forward per layer, again in the recompute, and one
    backward; two runs of the step give bit-equal gradients."""
    from repro_torch import configs as C
    from repro_torch.launch import serve
    from repro_torch.launch.train import data_for
    from repro_torch.models import transformer as T
    from repro_torch.train import train_loop as tl
    cfg = C.get("arctic-480b", smoke=True)
    ops.reset_launch_counts()
    serve.run("arctic-480b", smoke=True, batch=2, prompt_len=4, gen=4,
              device="cuda")
    assert ops.launch_counts()["flash_attention"] == 0
    cpu = torch.device("cpu")
    params, _, toks = serve.setup(cfg, 2, 4, cpu)
    assert "mlp" in params["blocks"]["slot0"] and \
        "moe" in params["blocks"]["slot0"]
    gparams = tree_map(lambda t: t.to(cuda), params)
    cst = T.init_decode_state(cfg, 2, 4, device=cpu)
    gst = T.init_decode_state(cfg, 2, 4, device=cuda)
    for pos in range(4):
        tok = toks[:, pos:pos + 1]
        cl, cst = T.decode_step(params, cst, tok, pos, cfg)
        gl, gst = T.decode_step(gparams, gst, tok.to(cuda), pos, cfg)
        torch.testing.assert_close(gl.cpu(), cl, rtol=3e-2, atol=3e-2)

    cpu_p = tl.init_params(cfg, 0, "cpu")
    gpu_p = tree_map(lambda t: t.detach().to(cuda).requires_grad_(True),
                     cpu_p)
    batch = data_for(cfg, 128, 2).batch(0)
    ops.reset_launch_counts()
    loss, grads = _grads_of_one_step(
        cfg, gpu_p, {k: torch.from_numpy(a).to(cuda)
                     for k, a in batch.items()})
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 2 * cfg.n_layers
    assert counts["flash_attention_bwd"] == cfg.n_layers
    loss2, grads2 = _grads_of_one_step(
        cfg, gpu_p, {k: torch.from_numpy(a).to(cuda)
                     for k, a in batch.items()})
    assert torch.equal(loss, loss2)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))
    closs, _ = _grads_of_one_step(cfg, cpu_p, tree_map(torch.from_numpy,
                                                       batch))
    np.testing.assert_allclose(float(loss), float(closs), rtol=2e-3)


def test_moe_block_is_bit_equal_across_runs_on_card(cuda):
    """moonshot-v1-16b-a3b SMOKE's MoE block on the card, [2, 64, 64] at
    capacity factors 1.25 and 0.05 (drops): two runs give the output and
    the gradients of x and of every leaf bit for bit, and so does a run
    under `torch.use_deterministic_algorithms`, which warns of no
    nondeterministic operation but cuBLAS's workspace setting."""
    import warnings
    from repro_torch import configs as C
    from repro_torch.models import moe as M
    cfg = C.get("moonshot-v1-16b-a3b", smoke=True)
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = {k: t.requires_grad_(True) for k, t in M.init_moe(
        cfg, generator=gen, device=cuda).items()}
    x = torch.randn((2, 64, cfg.d_model), generator=gen, device=cuda,
                    requires_grad=True)
    ct = torch.randn((2, 64, cfg.d_model), generator=gen, device=cuda)

    def run(cf):
        out, st = M.moe_block(p, x, cfg, capacity_factor=cf)
        grads = torch.autograd.grad(out, [x, *p.values()], ct)
        return [out, st["dropped"], *grads]

    for cf in (1.25, 0.05):
        first = run(cf)
        assert all(torch.equal(a, b) for a, b in zip(first, run(cf)))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                det = run(cf)
            finally:
                torch.use_deterministic_algorithms(False)
        assert all(torch.equal(a, b) for a, b in zip(first, det))
        other = [str(w.message) for w in caught
                 if "CUBLAS_WORKSPACE_CONFIG" not in str(w.message)]
        assert not other, other
    assert int(run(0.05)[1]) > 0


# --- the Pregel drivers: captured supersteps and the on-device loop ---------
def _driver_run(name, device):
    """(graph, vprog, send, gather, kwargs) of one algorithm on the small
    symmetric graph, w ~ U(0.5, 3)."""
    w = np.random.default_rng(1).uniform(0.5, 3, SGD.num_edges).astype(
        np.float32)
    g = Graph.from_edges(SGD.src, SGD.dst, edge_values={"w": w},
                         num_partitions=P, device=device)
    if name == "pagerank":
        return (alg.attach_out_degree(g).mapV(alg._pr_init),
                alg.pagerank_vprog(0.15), alg.pagerank_send, "sum",
                dict(default_msg={"m": torch.tensor(0.0)}, max_supersteps=10,
                     skip_stale=None))
    if name == "delta_pagerank":
        vprog, changed = alg.delta_pagerank_fns(0.15, 1e-3)
        g = alg.attach_out_degree(g).mapV(
            lambda vid, v: {**v, "pr": torch.tensor(0.15),
                            "delta": torch.tensor(0.15)})
        return (g, vprog, alg.delta_pagerank_send, "sum",
                dict(default_msg={"m": torch.tensor(0.0)}, max_supersteps=50,
                     skip_stale="out", changed_fn=changed))
    if name == "cc":
        return (g.mapV(alg._cc_init), alg.cc_vprog, alg.cc_send, "min",
                dict(default_msg={"m": torch.tensor(alg.IMAX,
                                                    dtype=torch.int32)}))
    assert name == "sssp"
    g = g.mapV(lambda vid, v: {"dist": torch.where(
        vid == 0, torch.tensor(0.0), torch.tensor(alg.INF32))})
    return (g, alg.sssp_vprog, alg.sssp_send, "min",
            dict(default_msg={"m": torch.tensor(alg.INF32)}))


def _eager_pregel(g, vprog, send, gather, *, default_msg, max_supersteps=50,
                  skip_stale="out", changed_fn=None, kernel_mode="auto",
                  transport=None):
    """The loop the drivers replace: `_superstep` superstep by superstep,
    eagerly, on freshly allocated tensors (under one transport policy; an
    "auto" one threads its decision as pregel_fused's carry does)."""
    import sys
    pm = sys.modules["repro_torch.core.pregel"]
    aplan = (None if kernel_mode == "unfused" else mt._plan_apply(
        g, vprog, send, gather, changed_fn, default_msg, None))
    dmsg = tree_map(lambda d: torch.as_tensor(d).to(g.device), default_msg)
    steps, ts = 0, None
    for _ in range(max_supersteps):
        g, live, m = pm._superstep(
            g, vprog=vprog, send_msg=send, gather=gather, default_msg=dmsg,
            skip_stale=skip_stale, changed_fn=changed_fn,
            kernel_mode=kernel_mode, use_cache=True, payload_bound=None,
            aplan=aplan, transport=transport, tstate=ts)
        ts = m["transport_state"] if isinstance(
            m["transport_state"], torch.Tensor) else None
        steps += 1
        if int(live) == 0:
            break
    return g, steps


def _assert_same_state(a, b):
    import sys
    from repro_torch.core import capture
    pm = sys.modules["repro_torch.core.pregel"]
    ta, sa = capture.flatten(pm._carry(a))
    tb, sb = capture.flatten(pm._carry(b))
    assert sa == sb
    for x, y in zip(ta, tb):
        assert torch.equal(x, y)


@pytest.mark.parametrize("mode", ["auto", "unfused"])
@pytest.mark.parametrize("name", ["pagerank", "delta_pagerank", "cc", "sssp"])
def test_captured_pregel_equals_eager_loop(name, mode, cuda):
    """Supersteps 2.. of `pregel` replay one captured superstep: values,
    the view, the wire log and the superstep count bit-equal to the eager
    loop, and the launch counts after the run equal the eager run's."""
    from repro_torch.core import capture, pregel
    g, vprog, send, gather, kw = _driver_run(name, cuda)
    ops.reset_launch_counts()
    want, n = _eager_pregel(g, vprog, send, gather, kernel_mode=mode, **kw)
    torch.cuda.synchronize()
    eager_counts = ops.launch_counts()
    ops.reset_launch_counts()
    capture.reset_stats()
    r = pregel(g, vprog, send, gather, kernel_mode=mode, **kw)
    torch.cuda.synchronize()
    assert capture.stats["captures"] == (1 if n > 1 else 0)
    assert ops.launch_counts() == eager_counts
    if mode == "auto":
        assert eager_counts["triplet"] > 0 and eager_counts["apply"] > 0
    elif gather == "sum":       # unfused float sums: the segment_sum kernel
        assert eager_counts["segment_sum"] > 0
    assert r.supersteps == n > 1
    _assert_same_state(r.graph, want)


@pytest.mark.parametrize("max_steps", [None, 2, 6])
@pytest.mark.parametrize("name", ["pagerank", "delta_pagerank", "cc"])
def test_pregel_fused_on_card_equals_eager_loop(name, max_steps, cuda):
    """Blocks of FUSED_BLOCK masked supersteps, replayed: bit-equal to the
    eager loop, with its superstep count, whether the run halts inside a
    block (cc, delta PageRank) or at a max_supersteps that is no multiple
    of the block; the masked supersteps add their launches."""
    import sys
    from repro_torch.core import capture, pregel_fused
    k = sys.modules["repro_torch.core.pregel"].FUSED_BLOCK
    g, vprog, send, gather, kw = _driver_run(name, cuda)
    if max_steps is not None:
        kw["max_supersteps"] = max_steps
    want, n = _eager_pregel(g, vprog, send, gather, **kw)
    ops.reset_launch_counts()
    capture.reset_stats()
    got, steps = pregel_fused(g, vprog, send, gather, **kw)
    torch.cuda.synchronize()
    assert steps.device.type == "cuda" and int(steps) == n
    assert capture.stats["captures"] == (1 if n > 1 else 0)
    blocks = -(-(n - 1) // k)
    assert ops.launch_counts()["apply"] == 1 + blocks * k
    _assert_same_state(got, want)


@pytest.mark.parametrize("codec", ["int8", "fp8_e4m3"])
def test_pregel_fused_over_resident_mirrors_on_card(codec, cuda):
    """Encoded mirrors (int8 and fp8 payloads with their scale planes) in
    the captured carry and its masked commit: bit-equal to the eager
    loop."""
    from repro_torch.core import pregel, pregel_fused
    g, vprog, send, gather, kw = _driver_run("pagerank", cuda)
    g = g.replace(ex=with_wire(g.ex, codec, resident=True))
    g = g.replace(view=None)        # mirrors start encoded, cold
    want, n = _eager_pregel(g, vprog, send, gather, **kw)
    got, steps = pregel_fused(g, vprog, send, gather, **kw)
    assert int(steps) == n
    _assert_same_state(got, want)
    r = pregel(g, vprog, send, gather, **kw)
    assert r.supersteps == n
    _assert_same_state(r.graph, want)


def test_captures_give_their_memory_back(cuda):
    """Each run's graph pool is released when the run returns: the
    memory the process reserves does not grow from run to run."""
    import gc
    from repro_torch.core import pregel, pregel_fused
    g, vprog, send, gather, kw = _driver_run("pagerank", cuda)
    reserved = []
    for _ in range(3):
        r = pregel(g, vprog, send, gather, **kw)
        out = pregel_fused(g, vprog, send, gather, **kw)
        del r, out
        gc.collect()
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved())
    assert reserved[2] <= reserved[0], reserved


def test_ref_mode_pregel_runs_eagerly_on_card(cuda):
    """kernel_mode="ref" (the plain versions, which read tables back to the
    host) runs every superstep eagerly, and equals the eager loop."""
    from repro_torch.core import capture, pregel
    g, vprog, send, gather, kw = _driver_run("cc", cuda)
    capture.reset_stats()
    r = pregel(g, vprog, send, gather, kernel_mode="ref", **kw)
    assert capture.stats["captures"] == 0 and r.supersteps > 1
    want, n = _eager_pregel(g, vprog, send, gather, kernel_mode="ref", **kw)
    assert r.supersteps == n
    _assert_same_state(r.graph, want)


# --- the transports: ragged, tiered, pipelined, adaptive, broadcast --------
def _transport(name):
    from repro_torch.core.transport import TransportPolicy
    return {"dense": None,
            "ragged": TransportPolicy("ragged", capacity_frac=0.25,
                                      cap_rounding=8),
            "tiered": TransportPolicy("ragged", capacity_frac=0.5,
                                      capacity_fracs=(0.25, 0.5, 0.125, 0.5),
                                      cap_rounding=8),
            "pipeline": TransportPolicy("ragged", capacity_frac=0.25,
                                        cap_rounding=8, pipeline=True),
            "auto": TransportPolicy("auto", cap_rounding=8, enter_frac=0.95,
                                    exit_frac=0.97)}[name]


@pytest.mark.parametrize("codec", [None, "int8"])
def test_transport_ships_on_card_equal_cpu(codec, cuda):
    """A dense, ragged (sparse and overflowing), tiered and pipelined
    routed ship and an all-gather ship on the card give the CPU's receive
    buffers, flags, branch and bytes bit for bit."""
    from repro_torch.core import transport as T
    from repro_torch.core.exchange import LocalExchange
    ex = LocalExchange(P)
    if codec is not None:
        ex = with_wire(ex, codec, delta=True)
    rng = np.random.default_rng(3)
    k = 300
    tree = {"a": rng.normal(size=(P, P, k)).astype(np.float32),
            "b": rng.normal(size=(P, P, k, 3)).astype(np.float32),
            "i": rng.integers(-100, 100, (P, P, k)).astype(np.int32)}
    for dens in (0.05, 0.2, 0.9):
        flags = rng.random((P, P, k)) < dens
        for name in ("dense", "ragged", "tiered", "pipeline"):
            out = {}
            for dev in ("cpu", cuda):
                out[str(dev)] = T.ship_transport(
                    ex, {n: torch.from_numpy(v).to(dev)
                         for n, v in tree.items()},
                    torch.from_numpy(flags).to(dev), bound=100,
                    policy=T.resolve_transport(_transport(name)))
            (r0, f0, i0), (r1, f1, i1) = out["cpu"], out[str(cuda)]
            assert torch.equal(f0, f1.cpu())
            for n in tree:
                assert torch.equal(r0[n], r1[n].cpu()), (name, dens, n)
            for f in ("bytes_shipped", "ragged", "overflow",
                      "route_active_max"):
                assert float(getattr(i0, f)) == float(getattr(i1, f)), f
            assert torch.equal(i0.route_active_frac,
                               i1.route_active_frac.cpu())
    b = 70
    block = {"x": rng.normal(size=(P, b)).astype(np.float32),
             "i": rng.integers(-100, 100, (P, b)).astype(np.int32)}
    bflags = rng.random((P, b)) < 0.5
    out = [T.allgather_ship(ex, {n: torch.from_numpy(v).to(dev)
                                 for n, v in block.items()},
                            torch.from_numpy(bflags).to(dev), bound=100)
           for dev in ("cpu", cuda)]
    assert torch.equal(out[0][1], out[1][1].cpu())
    for n in block:
        assert torch.equal(out[0][0][n], out[1][0][n].cpu())
    assert out[0][2].bytes_shipped == out[1][2].bytes_shipped


@pytest.mark.parametrize("transport", ["ragged", "tiered", "pipeline",
                                       "auto"])
@pytest.mark.parametrize("name", ["delta_pagerank", "cc"])
def test_replayed_superstep_under_each_transport_equals_eager_loop(
        name, transport, cuda):
    """pregel_fused under each transport (one policy, replayed in blocks;
    auto's decision in the carry) equals the eager loop under the same
    transport, wire log included, and the dense eager loop in values; the
    host loop `pregel` equals it too."""
    from repro_torch.core import pregel, pregel_fused
    g, vprog, send, gather, kw = _driver_run(name, cuda)
    tp = _transport(transport)
    want, n = _eager_pregel(g, vprog, send, gather, transport=tp, **kw)
    dense, nd = _eager_pregel(g, vprog, send, gather, **kw)
    assert n == nd
    for leaf in want.vdata:
        assert torch.equal(want.vdata[leaf], dense.vdata[leaf])
    got, steps = pregel_fused(g, vprog, send, gather, transport=tp, **kw)
    assert int(steps) == n
    _assert_same_state(got, want)
    r = pregel(g, vprog, send, gather, transport=tp, **kw)
    assert r.supersteps == n
    for leaf in want.vdata:
        assert torch.equal(r.graph.vdata[leaf], dense.vdata[leaf])
    assert float(r.graph.ships) == float(dense.ships)
    assert float(r.graph.bytes_accounted) == float(dense.bytes_accounted)


@pytest.mark.parametrize("codec", ["f32", "int8"])
def test_captured_pregel_over_delta_wire_equals_eager_loop(codec, cuda):
    """A delta codec's accounting (`wire.bytes_on_wire`) inside captured
    supersteps, dense and ragged: bit-equal to the eager loop, wire log
    included."""
    from repro_torch.core import pregel, pregel_fused
    g, vprog, send, gather, kw = _driver_run("cc", cuda)
    g = g.replace(ex=with_wire(g.ex, codec, delta=True))
    for name in ("dense", "ragged"):
        tp = _transport(name)
        want, n = _eager_pregel(g, vprog, send, gather, transport=tp, **kw)
        r = pregel(g, vprog, send, gather, transport=tp, **kw)
        assert r.supersteps == n
        _assert_same_state(r.graph, want)
        got, steps = pregel_fused(g, vprog, send, gather, transport=tp, **kw)
        assert int(steps) == n
        _assert_same_state(got, want)


def test_switching_plans_in_one_pregel_run(cuda):
    """The auto policy on delta PageRank (rmat(10, 8), w = 1) re-plans on
    the host: several concrete policies, each captured once, the carry
    handed between them; state equal to the dense run and the
    per-superstep records equal to the same run on the CPU; closing the
    captures gives their memory back (three runs reserve no more than
    one)."""
    import gc
    import json
    from repro_torch.core import capture
    tp = _transport("auto")
    kw = dict(num_iters=60, tol=1e-3)
    res = {}
    for dev in ("cpu", cuda):
        g = Graph.from_edges(GD.src, GD.dst, num_partitions=P, device=dev)
        capture.reset_stats()
        res[str(dev)] = alg.pagerank(g, transport=tp, track_metrics=True,
                                     **kw)
    r, rc = res[str(cuda)], res["cpu"]
    fracs = {m["transport_frac"] for m in r.metrics
             if m["transport"] == "ragged"}
    # a policy is captured at its second superstep, superstep 1's at once
    plans = [json.dumps(m["transport_plan"], sort_keys=True)
             for m in r.metrics]
    later = plans[1:]
    captured = {p for p in later
                if later.count(p) >= 2 or p == plans[0]}
    assert r.metrics[-1]["recompiles"] >= 3 and len(fracs) >= 2
    assert capture.stats["captures"] == r.metrics[-1]["captures"] \
        == len(captured) >= 2
    assert r.supersteps == rc.supersteps
    keys = ("transport", "transport_frac", "ragged", "bytes_shipped",
            "overflow_fallbacks", "recompiles", "live")
    for m, mc in zip(r.metrics, rc.metrics):
        assert {k: m[k] for k in keys} == {k: mc[k] for k in keys}
    g = Graph.from_edges(GD.src, GD.dst, num_partitions=P, device=cuda)
    dense = alg.pagerank(g, **kw)
    assert torch.equal(r.graph.vdata["pr"], dense.graph.vdata["pr"])
    reserved = []
    for _ in range(3):
        out = alg.pagerank(g, transport=tp, **kw)
        del out
        gc.collect()
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved())
    assert reserved[2] <= reserved[0], reserved


def test_broadcast_lane_on_card_equals_cleared_structure(cuda):
    """A hybrid build with a broadcast set: CC under the dense and auto
    transports equals the same structure with the broadcast tables
    cleared, and the CPU run."""
    import dataclasses
    from repro_torch.core import pregel
    out = {}
    for dev in ("cpu", cuda):
        g = Graph.from_edges(SGD.src, SGD.dst, num_partitions=P,
                             partitioner="hybrid", bcast_min_repl=3,
                             device=dev)
        assert g.s.has_bcast
        gc_ = g.replace(s=dataclasses.replace(g.s, brecv=None,
                                              p2p_routes=None))
        for name in ("dense", "auto"):
            for key, gg in (("bcast", g), ("cleared", gc_)):
                r = alg.connected_components(gg, transport=_transport(name))
                out[(str(dev), name, key)] = r
    want = out[("cpu", "dense", "cleared")].graph.vdata["cc"]
    for (dev, name, key), r in out.items():
        assert torch.equal(r.graph.vdata["cc"].cpu(), want), (dev, name, key)
    for name in ("dense", "auto"):
        assert float(out[(str(cuda), name, "bcast")].graph.bytes_shipped) \
            == float(out[("cpu", name, "bcast")].graph.bytes_shipped)


def _col_pair(keys, vals, cuda, p=P):
    from repro_torch.core import Col
    return (Col.from_numpy(keys, vals, p, device="cpu"),
            Col.from_numpy(keys, vals, p, device=cuda))


def _same_on_both(a, b):
    """Two pytrees of tensors (CPU run, card run) equal bit for bit."""
    from repro_torch.core.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y.cpu())


def _kv(n, seed, hub=None):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 5000, n).astype(np.int32)
    if hub is not None:
        keys[rng.random(n) < 0.7] = hub
    return keys, {"x": (rng.normal(size=n) * 100).astype(np.float32),
                  "i": rng.integers(-9, 9, n).astype(np.int32)}


def test_hash_on_card_equals_cpu(cuda):
    from repro_torch.core.hashing import hash_mod32, hash_mod_t
    rng = np.random.default_rng(0)
    x = np.concatenate([[-2**31, -1, 0, 1, 2**31 - 1],
                        rng.integers(-2**31, 2**31, 200000)]).astype(np.int32)
    for p in range(1, 9):
        for salt in (0, 7, 0x5EED):
            got = hash_mod_t(torch.from_numpy(x).to(cuda), p, salt).cpu()
            np.testing.assert_array_equal(got.numpy(), hash_mod32(x, p, salt))


def test_shuffle_by_key_on_card_equals_cpu(cuda):
    from repro_torch.core import shuffle_by_key
    keys, vals = _kv(20000, 1)
    cpu, card = _col_pair(keys, vals, cuda)
    for cap in (2000, 1000):        # the second overflows
        _same_on_both(*(shuffle_by_key(c.keys, c.values, c.mask, c.ex, cap)
                        for c in (cpu, card)))


def test_reduce_by_key_hub_sum_on_card_equals_cpu(cuda):
    """f32 sums over a hub key with more than 32 k entries: the scan's
    combine order gives the CPU's bits on the card."""
    keys, vals = _kv(60000, 2, hub=77)
    assert (keys == 77).sum() > 32768
    cpu, card = _col_pair(keys, vals, cuda)
    for op in ("sum", "min", "max", "mul"):
        _same_on_both(*((c.keys, c.values, c.mask, o) for c, o in
                        (cpu.reduce_by_key(op), card.reduce_by_key(op))))


def test_left_join_and_compact_on_card_equal_cpu(cuda):
    keys, vals = _kv(9000, 3)
    rk = np.unique(keys)[::2]
    right = (rk, {"r": rk.astype(np.float32) * 0.5})
    cpu, card = _col_pair(keys, vals, cuda)
    rcpu, rcard = _col_pair(*right, cuda)
    jc, oc = cpu.left_join(rcpu)
    jg, og = card.left_join(rcard)
    _same_on_both((jc.keys, jc.values, jc.mask, oc),
                  (jg.keys, jg.values, jg.mask, og))
    for width in (4000, 100):
        _same_on_both(*((c.keys, c.values, c.mask, d) for c, d in
                        (jc.compact(width), jg.compact(width))))


def test_left_join_and_chain_on_card_equal_cpu(cuda):
    """Graph.leftJoin / innerJoin and run_chain (pushdown, pruning, the
    triplet kernel) on the card equal the CPU run bit for bit."""
    from repro_torch.core import Col
    from repro_torch.core import planner as TP
    vids = np.arange(GD.num_vertices, dtype=np.int64)
    vv = {"x": (vids % 17 + 1).astype(np.float32),
          "y": (vids % 5).astype(np.float32)}
    send = lambda sv, ev, dv: {"m": sv["x"] * ev["w"]}      # noqa: E731
    bump = lambda vid, v: {"x": v["x"] + 1.0, "y": v["y"]}  # noqa: E731
    steps = [TP.MapV(bump), TP.MrTriplets(send),
             TP.Subgraph(epred=lambda sv, ev, dv: dv["y"] < 3.0),
             TP.MrTriplets(send)]
    j = lambda v, o, hit: {"x": torch.where(hit, v["x"] + o["b"], v["x"]),  # noqa: E731
                           "y": v["y"]}
    keep = vids[::11]
    out = []
    for dev in ("cpu", cuda):
        g = Graph.from_edges(GD.src, GD.dst, vertex_keys=vids,
                             vertex_values=vv,
                             default_vertex={"x": np.float32(0),
                                             "y": np.float32(0)},
                             num_partitions=P, device=dev)
        g = g.mrTriplets(send, "sum")[2]
        col = Col.from_numpy(keep.astype(np.int32),
                             {"b": np.full(len(keep), 100.0, np.float32)},
                             P, device=dev)
        gl = g.leftJoin(col, j, changed="diff")
        gi = g.innerJoin(col, j, changed="diff")
        r = TP.run_chain(gl, steps, transport="auto")
        out.append((gl.vdata, gi.vdata, gi.vmask,
                    [o[:2] for o in r.outputs], r.graph.emask,
                    r.graph.bytes_shipped))
    _same_on_both(out[0], out[1])


def test_capture_errors_raise(cuda):
    """A step that reads back to the host cannot be captured: the capture
    raises, and nothing runs it eagerly instead; nor does a step that
    changes its carry's static half.  (Last in the file: a failed capture
    leaves nothing the later tests would need, but it goes last anyway.)"""
    from repro_torch.core import capture
    carry = {"x": torch.arange(8, dtype=torch.float32, device=cuda)}

    def syncs(c):
        return {"x": c["x"] * float(c["x"].sum())}, None

    with pytest.raises(RuntimeError):
        capture.Replay(syncs, carry, capture=True)
    torch.cuda.synchronize()

    def retypes(c):
        return {"x": c["x"].double()}, None

    with pytest.raises(capture.StaticHalfChanged):
        capture.Replay(retypes, carry, capture=True)
    torch.cuda.synchronize()

    def doubles(c):
        return {"x": c["x"] * 2}, c["x"].sum()

    with capture.Replay(doubles, carry, capture=True) as rep:
        rep.run()
        out = rep.run()
        assert float(out) == 2 * 28.0
        assert torch.equal(rep.carry["x"], carry["x"] * 4)


# ---------------------------------------------------------------------------
# Fault tolerance and out-of-core residency on the card
# ---------------------------------------------------------------------------
def _faulty(g, **plan):
    from repro_torch.core.exchange import LocalExchange
    from repro_torch.core.fault import FaultPlan, FaultyExchange
    return g.replace(ex=FaultyExchange(LocalExchange(p=P), FaultPlan(**plan)))


@pytest.mark.parametrize("attempts", [(0,), (0, 1)],
                         ids=["transient", "persistent"])
@pytest.mark.parametrize("transport", ["dense", "ragged"])
def test_checked_ship_in_captured_superstep_selects_the_rung(
        transport, attempts, cuda):
    """PageRank through the captured `pregel` under a checked policy over a
    fault injector: each rung runs and the device selects by the verdicts,
    so the values equal the clean run bit for bit, and every superstep's
    wire_faults / degraded_routes equal the CPU run's (which runs the same
    programs eagerly)."""
    from repro_torch.core import pregel
    from repro_torch.core.transport import TransportPolicy
    tp = TransportPolicy(transport, capacity_frac=0.5, cap_rounding=8,
                         integrity=True)
    runs = {}
    for dev in ("cpu", cuda):
        g, vprog, send, gather, kw = _driver_run("pagerank", dev)
        clean = pregel(g, vprog, send, gather, transport=tp, **kw)
        r = pregel(_faulty(g, mode="corrupt", attempts=attempts), vprog,
                   send, gather, transport=tp, track_metrics=True, **kw)
        assert torch.equal(r.graph.vdata["pr"], clean.graph.vdata["pr"])
        runs[str(dev)] = [(m["wire_faults"], m["degraded_routes"])
                          for m in r.metrics]
    assert runs["cpu"] == runs["cuda"]
    assert sum(d for _, d in runs["cuda"]) > 0 if attempts == (0, 1) else \
        sum(f for f, _ in runs["cuda"]) > 0


def test_spill_ring_round_trips_in_the_replay_buffers(cuda):
    """Out of core on the card: the pinned copies go out after each replayed
    superstep and back before the next, in place in the replay's buffers;
    PageRank and CC equal the resident run bit for bit, and the ring's
    byte counts equal the CPU run's."""
    from repro_torch.core import pregel
    for name in ("pagerank", "cc"):
        recs = {}
        for dev in ("cpu", cuda):
            g, vprog, send, gather, kw = _driver_run(name, dev)
            full = pregel(g, vprog, send, gather, **kw)
            half = pregel(g, vprog, send, gather, working_set_frac=0.5,
                          track_metrics=True, **kw)
            assert half.supersteps == full.supersteps
            for leaf in full.graph.vdata:
                assert torch.equal(half.graph.vdata[leaf],
                                   full.graph.vdata[leaf])
            recs[str(dev)] = [(m["stream_bytes"], m["spill_host_bytes"])
                              for m in half.metrics]
        assert recs["cpu"] == recs["cuda"] and recs["cuda"][0][0] > 0


def test_snapshot_mid_replay_restores_bit_equal(cuda, tmp_path):
    """A snapshot taken between replayed supersteps (and one taken while
    half the cells are on the host) resumes bit-equal to the
    uninterrupted run: state, view and wire log."""
    from repro_torch.core import pregel
    g, vprog, send, gather, kw = _driver_run("pagerank", cuda)
    base = pregel(g, vprog, send, gather, **kw)
    for frac in (None, 0.5):
        d = str(tmp_path / f"ck{frac}")
        kw5 = dict(kw, max_supersteps=5)
        first = pregel(g, vprog, send, gather, checkpoint=d,
                       checkpoint_every=5, working_set_frac=frac, **kw5)
        assert first.supersteps == 5
        rest = pregel(g, vprog, send, gather, checkpoint=d,
                      working_set_frac=frac, **kw)
        assert first.supersteps + rest.supersteps == base.supersteps
        _assert_same_state(rest.graph, base.graph)

"""Graph operators of the PyTorch port against the JAX reference.

vertices/edges/triplets/mapE equal the reference's; subgraph (vpred,
epred, both) gives the reference's edge mask bit for bit, shares the
structure, and the next mrTriplets ships what the reference's ships (the 7
ShipMetrics fields the port holds); a pushed-down `mrTriplets(epred=)`
returns the reference's emask_pushed; reverse() gives the reference's
structure arrays byte for byte, twice gives the original tables back, and
mrTriplets on the transpose (to dst and src, sum and min) is fused ==
unfused == reference.  Also the IR's integer remainder on negative
operands.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.core import Col as RefCol  # noqa: E402
from repro.core import Graph as RefGraph  # noqa: E402
from repro.data import rmat, symmetrize  # noqa: E402
from repro_torch.core import Col, Graph, pregel  # noqa: E402
from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.core import analysis  # noqa: E402
from repro_torch.core import mrtriplets as mt  # noqa: E402
from repro_torch.core.tree import ElemSpec  # noqa: E402
from repro_torch.kernels import udf  # noqa: E402

SHIP_FIELDS = ("wire_bytes", "effective_bytes", "n_shipped",
               "bytes_accounted", "bytes_shipped", "route_width",
               "bytes_link_modeled")


def _graphs(gd, seed=0):
    vids = np.arange(gd.num_vertices, dtype=np.int64)
    rng = np.random.default_rng(seed)
    kw = dict(edge_values={"w": rng.uniform(0.5, 3, gd.num_edges).astype(
                  np.float32)},
              vertex_keys=vids,
              vertex_values={"age": (20 + vids % 50).astype(np.float32),
                             "rank": (vids * 7 % 101).astype(np.int32)},
              default_vertex={"age": np.float32(0), "rank": np.int32(0)},
              num_partitions=4)
    return (Graph.from_edges(gd.src, gd.dst, device="cpu", **kw),
            RefGraph.from_edges(gd.src, gd.dst, **kw))


@pytest.fixture(scope="module")
def graphs():
    return _graphs(rmat(8, 6, seed=11))


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tree_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(_np(a[k]), _np(b[k]), err_msg=k)


def _ship_equal(m, rm):
    for f in SHIP_FIELDS:
        assert float(_np(getattr(m, f))) == float(_np(getattr(rm, f))), f


def test_vertices_edges_triplets_equal_reference(graphs):
    g, rg = graphs
    np.testing.assert_array_equal(_np(g.vertex_ids), _np(rg.vertex_ids))
    ids, vals = g.vertices().to_numpy()
    rids, rvals = rg.vertices().to_numpy()
    np.testing.assert_array_equal(ids, _np(rids))
    _tree_equal(vals, rvals)
    for a, b in zip(g.edges()[:2] + g.edges()[3:],
                    rg.edges()[:2] + rg.edges()[3:]):
        np.testing.assert_array_equal(_np(a), _np(b))
    for a, b in zip(g.edges_to_numpy()[:2], rg.edges_to_numpy()[:2]):
        np.testing.assert_array_equal(a, b)
    sub = g.subgraph(vpred=lambda vid, v: v["age"] > 30)
    rsub = rg.subgraph(vpred=lambda vid, v: v["age"] > 30)
    for gg, rr in ((g, rg), (sub, rsub)):
        t, rt = gg.triplets(), rr.triplets()
        for i in (0, 1, 5):
            np.testing.assert_array_equal(_np(t[i]), _np(rt[i]))
        m = _np(t[5])
        for i in (2, 4):
            for k in ("age", "rank"):
                np.testing.assert_array_equal(_np(t[i][k])[m],
                                              _np(rt[i][k])[m])


# UDFs written with operators alone run on torch and jax values alike
@pytest.mark.parametrize("f", [
    lambda sv, ev, dv: {"w": sv["age"] + dv["age"] * ev["w"]},
    lambda sv, ev, dv: {"w": ev["w"] * 2, "r": sv["rank"]},
    lambda sv, ev, dv: {"w": ev["w"] + 1}])
def test_mapE_equals_reference(graphs, f):
    g, rg = graphs
    _tree_equal(g.mapE(f).edges_to_numpy()[2], rg.mapE(f).edges_to_numpy()[2])


_VPRED = lambda vid, v: v["age"] <= 40          # noqa: E731
_EPRED = lambda sv, ev, dv: (sv["rank"] < 60) & (ev["w"] > 1.0)  # noqa: E731


def _senior(sv, ev, dv):
    return {"n": torch.where(sv["age"] > dv["age"], 1.0, 0.0)}


def _ref_senior(sv, ev, dv):
    return {"n": jnp.where(sv["age"] > dv["age"], 1.0, 0.0)}


@pytest.mark.parametrize("which", ["vpred", "epred", "both"])
@pytest.mark.parametrize("warm", [False, True])
def test_subgraph_equals_reference(graphs, which, warm):
    g, rg = graphs
    if warm:      # a view filled by an earlier consumer: only flips ship
        _, _, g, _ = g.mrTriplets(_senior, "sum")
        _, _, rg, _ = rg.mrTriplets(_ref_senior, "sum")
    kw = {"vpred": _VPRED, "epred": _EPRED}
    use = {"vpred": ("vpred",), "epred": ("epred",),
           "both": ("vpred", "epred")}[which]
    young = g.subgraph(**{k: kw[k] for k in use})
    ryoung = rg.subgraph(**{k: kw[k] for k in use})
    assert young.s is g.s
    assert young.vmask_full == ryoung.vmask_full
    np.testing.assert_array_equal(_np(young.emask), _np(ryoung.emask))
    np.testing.assert_array_equal(_np(young.vmask), _np(ryoung.vmask))
    assert young.view.vis_dirs == ryoung.view.vis_dirs
    assert young.view.dirs == ryoung.view.dirs
    v, ex, _, m = young.mrTriplets(_senior, "sum")
    rv, rex, _, rm = ryoung.mrTriplets(_ref_senior, "sum")
    assert m["ships_fwd"] == rm["ships_fwd"]
    _ship_equal(m["fwd"], rm["fwd"])
    _ship_equal(m["back"], rm["back"])
    np.testing.assert_array_equal(_np(ex), _np(rex))
    np.testing.assert_array_equal(_np(v["n"]), _np(rv["n"]))


def test_subgraph_marks_only_flipped_visibility_rows(graphs):
    """A second restriction dirties the visibility rows whose bit flipped,
    and the refresh ships exactly their route entries, once."""
    from repro_torch.core import view as view_mod
    g, _ = graphs
    a = g.subgraph(vpred=_VPRED)
    assert a.view.vis_dirs == "sd" and a.view.vis_stale == ""
    vmask_b = a.vmask & (a.vdata["age"] <= 30)
    flipped = a.vmask ^ vmask_b
    view = a.view.mark_vis(flipped)
    assert view.vis_stale == "sd"
    assert torch.equal(view.vis_dirty[:, 0], flipped)
    assert torch.equal(view.vis_dirty[:, 1], flipped)
    gb = a.replace(vmask=vmask_b, view=view, vmask_full=False)
    v2, _, m, n = view_mod.refresh_view(gb, "both", leaf_mask=(False, False),
                                        with_vis=True)
    send = g.s.routes["both"][0]
    rows = torch.arange(send.shape[0])[:, None, None]
    want = ((send >= 0) & flipped[rows, send.clamp(min=0)]).sum()
    assert n == 1 and int(m.n_shipped) == int(want) > 0
    assert v2.vis_stale == "" and not bool(v2.vis_dirty.any())
    b = a.subgraph(vpred=lambda vid, v: v["age"] <= 30)
    assert torch.equal(b.view.vis, v2.vis)
    assert b.view.vis_stale == ""


@pytest.mark.parametrize("epred", [False, True])
def test_visibility_refresh_ships_as_the_reference(graphs, epred):
    """The visibility mirror's own ship (with or without an epred leaf in
    the same collective): the 7 ShipMetrics fields equal the reference's,
    the mask rides the wire as bool, and the mirror is bit-equal."""
    from repro.core import view as ref_view_mod
    from repro_torch.core import view as view_mod
    g, rg = graphs
    y = g.replace(vmask=g.vmask & (g.vdata["age"] <= 40), vmask_full=False)
    ry = rg.replace(vmask=rg.vmask & (rg.vdata["age"] <= 40),
                    vmask_full=False)
    lm = (False, epred)          # leaves: age, rank
    v, _, m, n = view_mod.refresh_view(y, "both", leaf_mask=lm,
                                       with_vis=True)
    rv, _, _, rm, rn = ref_view_mod.refresh_view(ry, "both", leaf_mask=lm,
                                                 with_vis=True)
    _ship_equal(m, rm)
    assert n == rn == 1
    np.testing.assert_array_equal(_np(v.vis), _np(rv.vis))
    assert (v.vis_dirs, v.dirs) == (rv.vis_dirs, rv.dirs)


@pytest.mark.parametrize("restricted", [False, True])
def test_pushed_down_epred_equals_reference(graphs, restricted):
    g, rg = graphs
    if restricted:
        g, rg = g.subgraph(vpred=_VPRED), rg.subgraph(vpred=_VPRED)
    for mode in ("auto", "unfused"):
        v, ex, g2, m = g.mrTriplets(_senior, "sum", epred=_EPRED,
                                    kernel_mode=mode)
        rv, rex, rg2, rm = rg.mrTriplets(_ref_senior, "sum", epred=_EPRED)
        np.testing.assert_array_equal(_np(m["emask_pushed"]),
                                      _np(rm["emask_pushed"]))
        np.testing.assert_array_equal(_np(g2.emask), _np(rg2.emask))
        np.testing.assert_array_equal(_np(v["n"]), _np(rv["n"]))
        np.testing.assert_array_equal(_np(ex), _np(rex))
        assert (m["need"], m["shipped_leaves"]) == (rm["need"],
                                                   rm["shipped_leaves"])
        _ship_equal(m["fwd"], rm["fwd"])
    # the pushed-down predicate restricts as a materialised subgraph does
    sub = g.subgraph(epred=_EPRED)
    np.testing.assert_array_equal(_np(g2.emask), _np(sub.emask))


_STRUCT = ("src_slot", "dst_slot", "src_perm", "edge_mask", "mirror_vid",
           "home_vid", "home_mask")


def test_reverse_structure_equals_reference(graphs):
    g, rg = graphs
    r, rr = g.reverse(), rg.reverse()
    for f in _STRUCT:
        a, b = _np(getattr(r.s, f)), _np(getattr(rr.s, f))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    for need in ("src", "dst", "both"):
        for a, b in zip(r.s.routes[need], rr.s.routes[need]):
            assert _np(a).tobytes() == _np(b).tobytes(), need
    for f in ("src_slot", "dst_slot", "src_perm"):
        assert (_np(getattr(r.host, f)).tobytes()
                == _np(getattr(rr.host, f)).tobytes()), f
    assert r.host is g.reverse().host and r.reverse().host is g.host
    assert r.s.agg_perm["src"] is None
    assert r.s.agg_perm["dst"] is g.s.src_perm
    # twice: the original tables
    rr2 = r.reverse()
    for f in ("src_slot", "dst_slot"):
        assert getattr(rr2.s, f) is getattr(g.s, f)
    for side in ("dst", "src"):
        assert rr2.s.agg_ptr[side] is g.s.agg_ptr[side]
        assert rr2.s.agg_pieces[side] is g.s.agg_pieces[side]
        assert rr2.s.agg_perm[side] is g.s.agg_perm[side]
        assert rr2.s.apply_rng[side] is g.s.apply_rng[side]
        assert rr2.s.routes[side] is g.s.routes[side]
    # the reversed host carries the swapped tables: a graph rebuilt from it
    # walks the same orders
    import dataclasses
    fields = {f.name: getattr(r.host, f.name)
              for f in dataclasses.fields(r.host)}
    rb = Graph.from_arrays(fields, {"age": g.vdata["age"].numpy()},
                           {"w": g.edata["w"].numpy()}, device="cpu")
    for side in ("dst", "src"):
        assert torch.equal(rb.s.agg_ptr[side], r.s.agg_ptr[side])
        pa, pb = rb.s.agg_perm[side], r.s.agg_perm[side]
        assert (pa is None) == (pb is None)
        assert pa is None or torch.equal(pa, pb)


def _rmin(sv, ev, dv):
    return {"m": sv["age"] * ev["w"] - dv["age"], "r": dv["rank"]}


def _rsum(sv, ev, dv):
    return {"m": sv["age"] * ev["w"]}


@pytest.mark.parametrize("to", ["dst", "src"])
@pytest.mark.parametrize("reduce", ["sum", "min"])
def test_reverse_mrtriplets_fused_unfused_reference(graphs, to, reduce):
    """The transpose's "dst" side walks the old src order (agg_perm): fused
    == unfused bit for bit, both equal to the reference (sums within the
    f32 reordering tolerance), degrees of the transpose == the original's
    opposite degrees."""
    g, rg = graphs
    r, rr = g.reverse(), rg.reverse()
    f = _rsum if reduce == "sum" else _rmin
    vf, ef, _, mf = r.mrTriplets(f, reduce, to=to)
    vu, eu, _, mu = r.mrTriplets(f, reduce, to=to, kernel_mode="unfused")
    rv, rex, _, rm = rr.mrTriplets(f, reduce, to=to)
    assert mf["plan"] == rm["plan"] == "fused" and mu["plan"] == "unfused"
    assert torch.equal(ef, eu)
    np.testing.assert_array_equal(_np(ef), _np(rex))
    for k in vf:
        assert torch.equal(vf[k], vu[k]), k
        if reduce == "sum":
            np.testing.assert_allclose(_np(vf[k]), _np(rv[k]), rtol=1e-6)
        else:
            np.testing.assert_array_equal(_np(vf[k]), _np(rv[k]))
    deg_r, _ = r.degrees("in" if to == "dst" else "out")
    deg_g, _ = g.degrees("out" if to == "dst" else "in")
    assert torch.equal(deg_r, deg_g)
    rdeg, _ = rr.degrees("in" if to == "dst" else "out")
    np.testing.assert_array_equal(_np(deg_r), _np(rdeg))


def test_reverse_keeps_the_view_remapped(graphs):
    g, rg = graphs
    _, _, g1, m1 = g.mrTriplets(_rsum, "sum")          # fills "s"
    _, _, rg1, _ = rg.mrTriplets(_rsum, "sum")
    r = g1.reverse()
    assert r.view.dirs == tuple({"s": "d", "": ""}[d] for d in g1.view.dirs)
    assert r.view.dirs == rg1.reverse().view.dirs
    # the reversed send reads the dst side it already holds: no ship
    def read_dst(sv, ev, dv):
        return {"m": dv["age"] * ev["w"]}
    _, _, _, m = r.mrTriplets(read_dst, "sum", to="src")
    assert m["ships_fwd"] == 0
    assert m1["ships_fwd"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_ir_argmax_first_index(dtype):
    """argmax over a rank-1 leaf lowers to a chain of strict comparisons:
    the first largest index on ties, a NaN before any number (the first
    NaN), as torch and jnp pick; evaluate == the UDF on either side, and
    the chain emits as C; argmin stays outside the IR."""
    def f(sv, ev, dv):
        return {"a": torch.argmax(sv["x"]), "b": torch.argmax(dv["x"])}
    spec = {"x": ElemSpec((5,), dtype)}
    tr = analysis.trace_udf(f, spec, {}, spec)
    ir = udf.lower(tr, [("xs", 0), ("xd", 0)])
    assert ir is not None
    lines, outs = udf.emit(ir, lambda a, c, d: f"{a}[{c}]", "t")
    assert len(outs) == 2 and lines
    rows = [[1, 3, 3, 0, 2], [0, 0, 0, 0, 0], [-1, -4, 2, -4, 2],
            [5, 4, 3, 2, 1], [1, 2, 3, 4, 5]]
    if dtype.is_floating_point:
        nan, inf = float("nan"), float("inf")
        rows += [[1, nan, 3, nan, 0], [nan, 1, nan, 2, 3], [2, 1, 0, 1, nan],
                 [-0.0, 0.0, -0.0, 0.0, -0.0], [-inf, inf, 0, inf, -inf]]
    x = torch.tensor(rows, dtype=dtype)
    cols = {"xs": x, "xd": x.flip(0)}
    got = udf.evaluate(ir, lambda a, c, d: cols[a][:, c].to(d))
    want = (x.argmax(1), x.flip(0).argmax(1))
    for g_, w_ in zip(got, want):
        assert g_.dtype == torch.int64 and torch.equal(g_, w_)
    if dtype is not torch.bfloat16:
        xn = jnp.asarray(x.numpy())
        np.testing.assert_array_equal(got[0].numpy(),
                                      np.asarray(jnp.argmax(xn, axis=1)))
    tr = analysis.trace_udf(lambda sv, ev, dv: {"a": torch.argmin(sv["x"])},
                            spec, {}, spec)
    assert udf.lower(tr, [("xs", 0), ("xd", 0)]) is None


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.int16])
def test_ir_remainder_floor_semantics(dtype):
    """aten.remainder lowers for ints with the divisor's sign (torch and
    jnp `%`), on negative operands too; the IR's evaluate equals the UDF,
    and the emitted C corrects C's truncating %."""
    def f(sv, ev, dv):
        return {"a": sv["x"] % 7, "b": sv["x"] % -5, "c": dv["x"] % sv["y"]}
    spec = {"x": ElemSpec((), dtype), "y": ElemSpec((), dtype)}
    tr = analysis.trace_udf(f, spec, {}, spec)
    ir = udf.lower(tr, [("xs", 0), ("xs", 1), ("xd", 0), ("xd", 1)])
    assert ir is not None
    assert sum(op.kind == "rem" for op in ir.ops) == 3
    lines, _ = udf.emit(ir, lambda a, c, d: f"{a}[{c}]", "t")
    assert sum("% " in ln for ln in lines) == 3
    x = torch.tensor([-17, -7, -1, 0, 1, 6, 7, 23], dtype=dtype)
    y = torch.tensor([3, -3, 4, -4, 5, -2, 7, -7], dtype=dtype)
    cols = {("xs", 0): x, ("xs", 1): y, ("xd", 0): x.flip(0),
            ("xd", 1): y}
    got = udf.evaluate(ir, lambda a, c, d: cols[(a, c)].to(d))
    want = f({"x": x, "y": y}, {}, {"x": x.flip(0), "y": y})
    for g_, k in zip(got, ("a", "b", "c")):
        assert torch.equal(g_, want[k]), k
    np.testing.assert_array_equal(want["a"].numpy(),
                                  np.asarray(jnp.asarray(x.numpy()) % 7))
    # float remainder stays outside the IR
    fspec = {"x": ElemSpec((), torch.float32), "y": ElemSpec((), dtype)}
    tr = analysis.trace_udf(lambda sv, ev, dv: {"a": sv["x"] % 2.0}, fspec,
                            {}, fspec)
    assert udf.lower(tr, [("xs", 0), ("xs", 1), ("xd", 0), ("xd", 1)]) is None


def test_label_send_plans_fused_with_a_k_column_message():
    gd = symmetrize(rmat(6, 4, seed=2))
    vids = np.arange(gd.num_vertices, dtype=np.int64)
    g = Graph.from_edges(gd.src, gd.dst, vertex_keys=vids,
                         vertex_values={"label": (vids % 16).astype(np.int32)},
                         default_vertex={"label": np.int32(0)},
                         num_partitions=4, device="cpu")
    from repro_torch.core import algorithms as alg
    send, _ = alg.label_propagation_fns(16)
    plan = mt.fused_plan(g, send, "sum")
    assert plan is not None and plan.dm == 16
    vf, ef, _, mf = g.mrTriplets(send, "sum")
    vu, eu, _, _ = g.mrTriplets(send, "sum", kernel_mode="unfused")
    assert mf["plan"] == "fused"
    assert torch.equal(vf["votes"], vu["votes"]) and torch.equal(ef, eu)


# ------------------------------------------------------------------ joins
def _vgraphs():
    """tests/test_view.py's graph: x = vid % 17 + 1, y = vid % 5."""
    gd = rmat(6, 4, seed=0)
    vids = np.arange(gd.num_vertices, dtype=np.int64)
    kw = dict(vertex_keys=vids,
              vertex_values={"x": (vids % 17 + 1).astype(np.float32),
                             "y": (vids % 5).astype(np.float32)},
              default_vertex={"x": np.float32(0), "y": np.float32(0)},
              num_partitions=4)
    return (Graph.from_edges(gd.src, gd.dst, device="cpu", **kw),
            RefGraph.from_edges(gd.src, gd.dst, **kw), gd)


@pytest.fixture(scope="module")
def vgraphs():
    return _vgraphs()


def _send_xy(sv, ev, dv):
    return {"m": sv["x"] + sv["y"]}


def _cols(vids, vals):
    return (Col.from_numpy(vids.astype(np.int32), vals, p=4, device="cpu"),
            RefCol.from_numpy(vids.astype(np.int32), vals, p=4))


def _leaves_equal(a, b):
    from repro_torch.core.tree import tree_leaves
    import jax
    la, lb = tree_leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(_np(x), _np(y))


def _view_equal(v, rv):
    assert (v is None) == (rv is None)
    if v is None:
        return
    assert (v.dirs, v.stale, v.vis_dirs, v.vis_stale) == \
        (rv.dirs, rv.stale, rv.vis_dirs, rv.vis_stale)
    _leaves_equal((v.dirty, v.vis_dirty), (rv.dirty, rv.vis_dirty))


def _joined_equal(g, rg):
    """values, masks, view state and the next ship equal the reference's."""
    _leaves_equal(g.vdata, rg.vdata)
    np.testing.assert_array_equal(_np(g.vmask), _np(rg.vmask))
    assert g.vmask_full == rg.vmask_full
    _view_equal(g.view, rg.view)
    vals, ex, _, m = g.mrTriplets(_send_xy, "sum", kernel_mode="ref")
    rvals, rex, _, rm = rg.mrTriplets(_send_xy, "sum", kernel_mode="ref")
    _tree_equal(vals, rvals)
    np.testing.assert_array_equal(_np(ex), _np(rex))
    _ship_equal(m["fwd"], rm["fwd"])


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("changed", [None, "diff"])
def test_left_join_equals_reference(vgraphs, warm, changed):
    g, rg, gd = vgraphs
    if warm:
        g, rg = (x.mrTriplets(_send_xy, "sum", kernel_mode="ref")[2]
                 for x in (g, rg))
    vids = np.arange(0, gd.num_vertices, 2, dtype=np.int64)
    col, rcol = _cols(vids, {"b": (vids * 10).astype(np.float32)})
    g2 = g.leftJoin(col, lambda v, o, hit: {
        "x": v["x"], "y": torch.where(hit, o["b"], -1.0)}, changed=changed)
    rg2 = rg.leftJoin(rcol, lambda v, o, hit: {
        "x": v["x"], "y": jnp.where(hit, o["b"], -1.0)}, changed=changed)
    _joined_equal(g2, rg2)
    out_vids, vv = g2.vertices_to_numpy()
    np.testing.assert_array_equal(
        vv["y"], np.where(out_vids % 2 == 0, out_vids * 10.0, -1.0))
    # the collection shuffles, the graph does not: no ship is logged
    assert float(g2.ships) == float(g.ships)
    assert float(g2.bytes_shipped) == float(g.bytes_shipped)


def test_left_join_default_tuple_equals_reference(vgraphs):
    g, rg, gd = vgraphs
    vids = np.arange(1, gd.num_vertices, 3, dtype=np.int64)
    col, rcol = _cols(vids, {"b": vids.astype(np.float32) + 0.5})
    g2, rg2 = g.leftJoin(col), rg.leftJoin(rcol)
    _leaves_equal(g2.vdata, rg2.vdata)
    _view_equal(g2.view, rg2.view)
    ids, (_, o, hit) = g2.vertices_to_numpy()
    np.testing.assert_array_equal(hit, ids % 3 == 1)
    np.testing.assert_array_equal(o["b"][hit], ids[hit] + 0.5)


@pytest.mark.parametrize("warm", [False, True])
def test_inner_join_equals_reference(vgraphs, warm):
    g, rg, gd = vgraphs
    if warm:
        g, rg = (x.mrTriplets(_send_xy, "sum", kernel_mode="ref")[2]
                 for x in (g, rg))
    keep = np.arange(0, gd.num_vertices, 3, dtype=np.int64)
    col, rcol = _cols(keep, {"b": np.ones(len(keep), np.float32)})
    g2 = g.innerJoin(col, lambda v, o, hit: v)
    rg2 = rg.innerJoin(rcol, lambda v, o, hit: v)
    _joined_equal(g2, rg2)
    out_vids, _ = g2.vertices_to_numpy()
    np.testing.assert_array_equal(np.sort(out_vids), keep)
    svid, dvid, _, _, _, vis = g2.triplets()
    *_, rvis = rg2.triplets()
    np.testing.assert_array_equal(_np(vis), _np(rvis))
    m = _np(vis)
    assert ((_np(svid)[m] % 3 == 0) & (_np(dvid)[m] % 3 == 0)).all()
    live = _np(g2.emask)
    want = live & (_np(svid) % 3 == 0) & (_np(dvid) % 3 == 0)
    np.testing.assert_array_equal(m, want)


def test_sparse_inner_join_ships_sparse(vgraphs):
    """The top-k join: an innerJoin hitting few vertices with
    changed="diff" re-ships only the rows it rewrote."""
    g, rg, gd = vgraphs
    gw = g.mrTriplets(_send_xy, "sum", kernel_mode="ref")[2]
    rgw = rg.mrTriplets(_send_xy, "sum", kernel_mode="ref")[2]
    keep = np.arange(0, gd.num_vertices, 11, dtype=np.int64)
    col, rcol = _cols(keep, {"b": np.full(len(keep), 100.0, np.float32)})
    g_j = gw.innerJoin(col, lambda v, o, hit: {
        "x": torch.where(hit, v["x"] + o["b"], v["x"]), "y": v["y"]},
        changed="diff")
    rg_j = rgw.innerJoin(rcol, lambda v, o, hit: {
        "x": jnp.where(hit, v["x"] + o["b"], v["x"]), "y": v["y"]},
        changed="diff")
    assert not g_j.vmask_full
    _joined_equal(g_j, rg_j)
    _, _, _, m = g_j.mrTriplets(_send_xy, "sum", kernel_mode="ref")
    assert int(m["fwd"].n_shipped) < int(g.vmask.sum())
    want, we, _, _ = g_j.replace(view=None).mrTriplets(
        _send_xy, "sum", kernel_mode="ref")
    got, ge, _, _ = g_j.mrTriplets(_send_xy, "sum", kernel_mode="ref")
    assert torch.equal(got["m"], want["m"]) and torch.equal(ge, we)


def listing5_superstep(g, vprog, send):
    """One PageRank superstep written with the dataflow operators
    (Listing 5): mrTriplets, the messages as a collection keyed by home
    vid, leftJoin, mapV."""
    vals, exists, _, _ = g.mrTriplets(send, "sum")
    msgs = Col(g.s.home_vid, vals, exists & g.vmask, g.ex)
    joined = g.leftJoin(msgs, lambda v, o, hit: {
        **v, "msg": torch.where(hit, o["m"], 0.0)})
    return joined.mapV(lambda vid, v: vprog(
        vid, {k: x for k, x in v.items() if k != "msg"}, {"m": v["msg"]}))


@pytest.mark.parametrize("partitioner", ["2d", "1d"])
def test_listing5_superstep_equals_pregel(partitioner):
    gd = rmat(8, 6, seed=4)
    g = Graph.from_edges(gd.src, gd.dst, num_partitions=3,
                         partitioner=partitioner, device="cpu")
    g = alg.attach_out_degree(g).mapV(alg._pr_init)
    vprog = alg.pagerank_vprog(0.15)
    got = listing5_superstep(g, vprog, alg.pagerank_send)
    want = pregel(g, vprog, alg.pagerank_send, "sum",
                  default_msg={"m": torch.tensor(0.0)}, max_supersteps=1,
                  skip_stale=None)
    # the vertices' rows (pregel leaves the padding rows as they were)
    vis = g.vmask
    for k in ("pr", "deg"):
        assert torch.equal(got.vdata[k][vis], want.graph.vdata[k][vis])

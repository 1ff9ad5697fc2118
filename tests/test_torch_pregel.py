"""Pregel, PageRank and connected components: port against the reference.

CC labels and superstep counts are bit-equal to the reference and to
union-find.  PageRank agrees within rtol 1e-5, atol 1e-6 (the f32 sums are
added in another order than the reference's).  The plan strings equal the
reference's, the port's fused run equals its unfused run bit for bit, and a
reference graph carried over mid-run with `Graph.from_arrays` continues to
the same result.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.core import Graph as RefGraph  # noqa: E402
from repro.core import algorithms as ref_alg  # noqa: E402
from repro.core import mrtriplets as ref_mt  # noqa: E402
from repro.core.pregel import pregel as ref_pregel  # noqa: E402
from repro.data import rmat, symmetrize  # noqa: E402
from repro_torch.core import Graph  # noqa: E402
from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.core import mrtriplets as mt  # noqa: E402
from repro_torch.core.pregel import pregel  # noqa: E402

GD = rmat(10, 8, seed=42)
SGD = symmetrize(GD)


def _pair(gd):
    return (Graph.from_edges(gd.src, gd.dst, num_partitions=4, device="cpu"),
            RefGraph.from_edges(gd.src, gd.dst, num_partitions=4))


@pytest.fixture(scope="module")
def graphs():
    return _pair(GD) + _pair(SGD)


def _visible(g, leaf):
    ids, vals = g.vertices_to_numpy()
    return ids, np.asarray(vals[leaf])


@pytest.mark.parametrize("kernel_mode", ["auto", "unfused"])
def test_connected_components_bit_exact(kernel_mode, graphs):
    _, _, SG, RSG = graphs
    r = alg.connected_components(SG, kernel_mode=kernel_mode,
                                 track_metrics=True)
    rr = ref_alg.connected_components(RSG, track_metrics=True)
    ids, cc = _visible(r.graph, "cc")
    rids, rcc = rr.graph.vertices_to_numpy()
    np.testing.assert_array_equal(ids, rids)
    np.testing.assert_array_equal(cc, np.asarray(rcc["cc"]))
    assert r.supersteps == rr.supersteps
    want = ref_alg.connected_components_reference(SGD.src, SGD.dst, ids)
    assert dict(zip(ids.tolist(), cc.tolist())) == want
    if kernel_mode == "auto":
        for k in ("plan", "apply_plan", "join_arity", "need"):
            assert r.metrics[0][k] == rr.metrics[0][k], k
        assert [m["bytes_shipped"] for m in r.metrics] == \
            [float(m["bytes_shipped"]) for m in rr.metrics]


def test_connected_components_fused_equals_unfused(graphs):
    _, _, SG, _ = graphs
    a = alg.connected_components(SG)
    b = alg.connected_components(SG, kernel_mode="unfused")
    assert torch.equal(a.graph.vdata["cc"], b.graph.vdata["cc"])
    assert a.supersteps == b.supersteps


@pytest.mark.parametrize("tol", [0.0, 1e-3])
def test_pagerank_matches_reference(tol, graphs):
    G, RG, _, _ = graphs
    r = alg.pagerank(G, num_iters=15, tol=tol, track_metrics=True)
    rr = ref_alg.pagerank(RG, num_iters=15, tol=tol, track_metrics=True)
    ids, pr = _visible(r.graph, "pr")
    _, rvals = rr.graph.vertices_to_numpy()
    np.testing.assert_allclose(pr, np.asarray(rvals["pr"]), rtol=1e-5,
                               atol=1e-6)
    assert r.supersteps == rr.supersteps
    for k in ("plan", "apply_plan", "join_arity", "need"):
        assert r.metrics[0][k] == rr.metrics[0][k], k
    if tol == 0.0:
        want = alg.pagerank_reference(GD.src, GD.dst, GD.num_vertices, 15)
        np.testing.assert_allclose(pr, want[ids], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("tol", [0.0, 1e-3])
def test_pagerank_fused_equals_unfused(tol, graphs):
    G, _, _, _ = graphs
    a = alg.pagerank(G, num_iters=12, tol=tol)
    b = alg.pagerank(G, num_iters=12, tol=tol, kernel_mode="unfused")
    assert torch.equal(a.graph.vdata["pr"], b.graph.vdata["pr"])
    assert a.supersteps == b.supersteps


def _ref_pr_send(sv, ev, dv):
    return {"m": sv["pr"] / sv["deg"] * ev["w"]}


def _ref_pr_vprog(vid, v, msg):
    return {**v, "pr": 0.15 + 0.85 * msg["m"]}


def _carry(rg):
    """A reference graph as numpy GraphStructure fields + property trees."""
    host = rg.host
    fields = {f.name: getattr(host, f.name) for f in dataclasses.fields(host)}
    to_np = lambda tree: {k: np.asarray(v) for k, v in tree.items()}  # noqa: E731
    return fields, to_np(rg.vdata), to_np(rg.edata)


def test_pagerank_carried_mid_run_continues_to_same_result(graphs):
    _, RG, _, _ = graphs
    g0 = ref_alg.attach_out_degree(RG).mapV(
        lambda vid, v: {**v, "pr": jnp.float32(1.0)})
    run = lambda g, n: ref_pregel(  # noqa: E731
        g, _ref_pr_vprog, _ref_pr_send, "sum",
        default_msg={"m": jnp.float32(0.0)}, max_supersteps=n,
        skip_stale=None)
    mid = run(g0, 4).graph
    full = run(g0, 10).graph
    fields, vdata, edata = _carry(mid)
    g = Graph.from_arrays(fields, vdata, edata, device="cpu")
    r = pregel(g, alg.pagerank_vprog(0.15), alg.pagerank_send, "sum",
               default_msg={"m": torch.tensor(0.0)}, max_supersteps=6,
               skip_stale=None)
    mask = np.asarray(full.vmask)
    np.testing.assert_allclose(r.graph.vdata["pr"].numpy()[mask],
                               np.asarray(full.vdata["pr"])[mask],
                               rtol=1e-5, atol=1e-6)


def test_connected_components_carried_mid_run_is_exact(graphs):
    _, _, _, RSG = graphs
    g0 = RSG.mapV(lambda vid, v: {"cc": vid})
    run = lambda g, n: ref_pregel(  # noqa: E731
        g, lambda vid, v, m: {"cc": jnp.minimum(v["cc"], m["m"])},
        lambda sv, ev, dv: {"m": sv["cc"]}, "min",
        default_msg={"m": jnp.int32(2**31 - 1)}, max_supersteps=n)
    mid = run(g0, 2)
    full = run(g0, 50)
    fields, vdata, edata = _carry(mid.graph)
    g = Graph.from_arrays(fields, vdata, edata, device="cpu")
    # the carried graph starts cold: every vertex counts as changed once
    r = pregel(g, alg.cc_vprog, alg.cc_send, "min",
               default_msg={"m": torch.tensor(2**31 - 1, dtype=torch.int32)},
               max_supersteps=50)
    mask = np.asarray(full.graph.vmask)
    np.testing.assert_array_equal(r.graph.vdata["cc"].numpy()[mask],
                                  np.asarray(full.graph.vdata["cc"])[mask])


# --------------------------------------------- plan parity of the fused scope
def _pair_with(gd, values):
    """Port and reference graphs of `gd` carrying the same f32 vertex
    values (numpy, keyed by vertex id)."""
    vids = np.arange(gd.num_vertices, dtype=np.int64)
    kw = dict(vertex_keys=vids, vertex_values=values,
              default_vertex={k: np.float32(0) for k in values},
              num_partitions=4)
    return (Graph.from_edges(gd.src, gd.dst, device="cpu", **kw),
            RefGraph.from_edges(gd.src, gd.dst, **kw))


def _vec_init(vid, v):
    return {"deg": v["deg"], "v": torch.stack(
        [torch.ones_like(v["deg"]), v["deg"], (vid % 7).to(torch.float32)])}


def _vec_init_j(vid, v):
    return {"deg": v["deg"], "v": jnp.stack(
        [jnp.ones_like(v["deg"]), v["deg"], (vid % 7).astype(jnp.float32)])}


def _vec_send(sv, ev, dv):
    return {"m": sv["v"] / sv["deg"] * ev["w"]}


def _vec_vprog(vid, v, msg):
    return {"deg": v["deg"], "v": 0.15 + 0.85 * msg["m"]}


def test_rank1_leaves_fuse_as_in_reference(graphs):
    """A vector-valued PageRank (3 columns per vertex): rank-1 state and
    messages plan fused in both, values agree, fused == unfused."""
    G, RG, _, _ = graphs
    g = alg.attach_out_degree(G).mapV(_vec_init)
    rg = ref_alg.attach_out_degree(RG).mapV(_vec_init_j)
    kw = dict(max_supersteps=6, skip_stale=None, track_metrics=True)
    r = pregel(g, _vec_vprog, _vec_send, "sum",
               default_msg={"m": torch.tensor(0.0)}, **kw)
    rr = ref_pregel(rg, _vec_vprog, _vec_send, "sum",
                    default_msg={"m": jnp.float32(0.0)}, **kw)
    assert (r.metrics[0]["plan"], r.metrics[0]["apply_plan"]) == \
        (rr.metrics[0]["plan"], rr.metrics[0]["apply_plan"]) == \
        ("fused", "fused_apply")
    ids, got = _visible(r.graph, "v")
    _, rvals = rr.graph.vertices_to_numpy()
    assert got.shape == (len(ids), 3)
    np.testing.assert_allclose(got, np.asarray(rvals["v"]), rtol=1e-5,
                               atol=1e-6)
    u = pregel(g, _vec_vprog, _vec_send, "sum",
               default_msg={"m": torch.tensor(0.0)}, kernel_mode="unfused",
               **kw)
    assert torch.equal(r.graph.vdata["v"], u.graph.vdata["v"])


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_narrow_float_leaves_fuse_as_in_reference(dtype):
    """bf16/f16 vertex leaves stage through f32: the triplet plans fused in
    both packages with the same values, and a narrow vertex STATE keeps the
    apply unfused in both.  The messages are exact in the narrow dtype: the
    reference's fused plan evaluates a narrow UDF in f32, where torch (and
    the port, fused or not) rounds every op to the dtype."""
    x = np.random.default_rng(4).normal(size=GD.num_vertices)
    G, RG = _pair_with(GD, {"x": x.astype(np.float32)})
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    g = G.mapV(lambda vid, v: {"h": v["x"].to(tdt), "x": v["x"]})
    rg = RG.mapV(lambda vid, v: {"h": v["x"].astype(jdt), "x": v["x"]})
    cases = [
        (lambda sv, ev, dv: {"m": sv["h"] * 2.0},
         lambda sv, ev, dv: {"m": sv["h"] * 2.0}, "sum"),
        (lambda sv, ev, dv: {"m": torch.minimum(sv["h"], dv["h"]) * 2.0},
         lambda sv, ev, dv: {"m": jnp.minimum(sv["h"], dv["h"]) * 2.0}, "min"),
    ]
    for fn, fn_j, reduce in cases:
        vals, exists, _, m = g.mrTriplets(fn, reduce)
        uvals, uexists, _, _ = g.mrTriplets(fn, reduce, kernel_mode="unfused")
        rvals, rexists, _, rm = rg.mrTriplets(fn_j, reduce)
        assert m["plan"] == rm["plan"] == "fused"
        assert torch.equal(vals["m"], uvals["m"])
        assert torch.equal(exists, uexists)
        vm = G.vmask.numpy()
        np.testing.assert_array_equal(exists.numpy(), np.asarray(rexists))
        got = vals["m"].float().numpy()[vm]
        want = np.asarray(rvals["m"], np.float32)[vm]
        if reduce == "min":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    send = lambda sv, ev, dv: {"m": sv["h"] * ev["w"]}  # noqa: E731
    assert mt.apply_plan_of(g, lambda vid, v, m: {**v, "x": m["m"]}, send,
                            default_msg={"m": torch.tensor(0.0)}) == "unfused"
    assert ref_mt.apply_plan_of(rg, lambda vid, v, m: {**v, "x": m["m"]},
                                send, default_msg={"m": jnp.float32(0.0)}) \
        == "unfused"



@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_narrow_float_udf_rounds_per_op_unlike_reference_fused(dtype):
    """Pins the value difference that stays (ROADMAP Queue 3): for a UDF
    that is not exact in the narrow dtype, h_s * h_d + h_s, the port rounds
    every op to the dtype, fused and unfused alike, as the reference's
    unfused plan does; the reference's fused tile_fn evaluates it in f32
    and rounds once.  The min reduce adds no rounding of its own."""
    x = np.random.default_rng(6).normal(size=GD.num_vertices)
    G, RG = _pair_with(GD, {"x": x.astype(np.float32)})
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    g = G.mapV(lambda vid, v: {"h": v["x"].to(tdt)})
    rg = RG.mapV(lambda vid, v: {"h": v["x"].astype(jdt)})
    fn = lambda sv, ev, dv: {"m": sv["h"] * dv["h"] + sv["h"]}  # noqa: E731
    vals, exists, _, m = g.mrTriplets(fn, "min")
    uvals, _, _, _ = g.mrTriplets(fn, "min", kernel_mode="unfused")
    rvals, rexists, _, rm = rg.mrTriplets(fn, "min")
    ruvals, _, _, _ = rg.mrTriplets(fn, "min", kernel_mode="unfused")
    assert m["plan"] == rm["plan"] == "fused"
    assert torch.equal(vals["m"], uvals["m"])
    vm = G.vmask.numpy() & exists.numpy()
    np.testing.assert_array_equal(exists.numpy(), np.asarray(rexists))
    got = vals["m"].float().numpy()[vm]
    np.testing.assert_array_equal(
        got, np.asarray(ruvals["m"], np.float32)[vm])
    assert not np.array_equal(got, np.asarray(rvals["m"], np.float32)[vm])

def _ab_send(sv, ev, dv):
    return {"m": sv["a"] * ev["w"]}


def _ba_vprog(vid, v, msg):            # keys in another order than the state
    return {"b": v["b"] + 1.0, "a": 0.5 * v["a"] + msg["m"]}


def test_vprog_key_order_plans_as_reference():
    vals = np.random.default_rng(5).random((2, GD.num_vertices))
    G, RG = _pair_with(GD, {"a": vals[0].astype(np.float32),
                            "b": vals[1].astype(np.float32)})
    kw = dict(max_supersteps=4, skip_stale=None, track_metrics=True)
    r = pregel(G, _ba_vprog, _ab_send, "sum",
               default_msg={"m": torch.tensor(0.0)}, **kw)
    rr = ref_pregel(RG, _ba_vprog, _ab_send, "sum",
                    default_msg={"m": jnp.float32(0.0)}, **kw)
    assert r.metrics[0]["apply_plan"] == rr.metrics[0]["apply_plan"] == \
        "fused_apply"
    u = pregel(G, _ba_vprog, _ab_send, "sum",
               default_msg={"m": torch.tensor(0.0)}, kernel_mode="unfused",
               **kw)
    _, rv = rr.graph.vertices_to_numpy()
    for k in ("a", "b"):
        assert torch.equal(r.graph.vdata[k], u.graph.vdata[k]), k
        np.testing.assert_allclose(_visible(r.graph, k)[1], np.asarray(rv[k]),
                                   rtol=1e-5, atol=1e-6)
    assert list(r.graph.vdata) == ["a", "b"]

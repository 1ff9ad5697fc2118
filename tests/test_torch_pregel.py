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
from repro.core.pregel import pregel as ref_pregel  # noqa: E402
from repro.data import rmat, symmetrize  # noqa: E402
from repro_torch.core import Graph  # noqa: E402
from repro_torch.core import algorithms as alg  # noqa: E402
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

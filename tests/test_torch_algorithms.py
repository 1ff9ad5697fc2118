"""SSSP, label propagation, triangle count and coarsen of the PyTorch port
against the JAX reference and their oracles.

Every comparison is bit-exact: SSSP's f32 sums run along one path each and
its minima are exact; label votes are integer-valued f32 sums below 2^24;
triangle bitsets are integer words and their counts integer-valued f32
sums below 2^24; coarsen merges in the reference's order and dtype.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.core import Graph as RefGraph  # noqa: E402
from repro.core import algorithms as ref_alg  # noqa: E402
from repro.core import mrtriplets as ref_mt  # noqa: E402
from repro.core.pregel import pregel as ref_pregel  # noqa: E402
from repro.data import rmat, star, symmetrize  # noqa: E402
from repro_torch.core import Graph  # noqa: E402
from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.core import mrtriplets as mt  # noqa: E402
from repro_torch.core.pregel import pregel  # noqa: E402


def _pair(src, dst, **kw):
    kw.setdefault("num_partitions", 4)
    return (Graph.from_edges(src, dst, device="cpu", **kw),
            RefGraph.from_edges(src, dst, **kw))


def _visible(g, leaf):
    ids, vals = g.vertices_to_numpy()
    return np.asarray(ids), np.asarray(vals[leaf])


def _probe_graphs():
    """The re-anchor probe's input: rmat(9,8,seed=5), P=4, w uniform(0.5,
    3) from default_rng(1)."""
    gd = rmat(9, 8, seed=5)
    w = np.random.default_rng(1).uniform(0.5, 3, gd.num_edges).astype(
        np.float32)
    return gd, _pair(gd.src, gd.dst, edge_values={"w": w})


@pytest.fixture(scope="module")
def probe():
    return _probe_graphs()


@pytest.mark.parametrize("kernel_mode", ["auto", "unfused"])
def test_sssp_matches_reference_bit_for_bit(probe, kernel_mode):
    gd, (g, rg) = probe
    r = alg.sssp(g, 0, kernel_mode=kernel_mode)
    rr = ref_alg.sssp(rg, 0)
    ids, dist = _visible(r.graph, "dist")
    rids, rdist = _visible(rr.graph, "dist")
    np.testing.assert_array_equal(ids, rids)
    np.testing.assert_array_equal(dist, rdist)
    assert r.supersteps == rr.supersteps
    assert dist.dtype == np.float32 and (dist == alg.INF32).any()
    assert (dist < alg.INF32).sum() > 1
    if kernel_mode == "auto":
        rg0 = rg.mapV(lambda vid, v: {"dist": jnp.float32(0.0)})
        g0 = g.mapV(lambda vid, v: {"dist": torch.tensor(0.0)})
        assert mt.plan_of(g0, alg.sssp_send, "min") == ref_mt.plan_of(
            rg0, alg.sssp_send, "min") == "fused"
        assert mt.apply_plan_of(
            g0, alg.sssp_vprog, alg.sssp_send, "min",
            default_msg={"m": torch.tensor(alg.INF32)}) == "fused_apply"


def _inf_send(sv, ev, dv):       # torch and jax values alike
    return {"m": sv["dist"] + ev["w"]}


def _inf_vprog(vid, v, msg):
    return {"dist": torch.minimum(v["dist"], msg["m"])}


def _ref_inf_vprog(vid, v, msg):
    return {"dist": jnp.minimum(v["dist"], msg["m"])}


def test_sssp_plus_inf_state_matches_reference_unfused_apply(probe):
    """The re-anchor probe, pinned: SSSP as a user pregel over a +inf
    state.  The reference's fused apply halts after 4 supersteps with 77
    vertices reached; its unfused apply (fuse_apply=False) runs 5 and
    reaches 137.  The port, fused and unfused, equals the latter bit for
    bit (a reference-side divergence; with INF32 all agree)."""
    _, (g, rg) = probe
    init = lambda vid, v: {"dist": torch.where(  # noqa: E731
        vid == 0, torch.tensor(0.0), torch.tensor(float("inf")))}
    rinit = lambda vid, v: {"dist": jnp.where(  # noqa: E731
        vid == 0, jnp.float32(0.0), jnp.float32(jnp.inf))}
    kw = dict(max_supersteps=100, skip_stale="in")
    ref_u = ref_pregel(rg.mapV(rinit), _ref_inf_vprog, _inf_send, "min",
                       default_msg={"m": jnp.float32(jnp.inf)},
                       fuse_apply=False, **kw)
    ref_f = ref_pregel(rg.mapV(rinit), _ref_inf_vprog, _inf_send, "min",
                       default_msg={"m": jnp.float32(jnp.inf)}, **kw)
    rids, rdist = _visible(ref_u.graph, "dist")
    assert (ref_u.supersteps, int((rdist < 1e30).sum())) == (5, 137)
    _, fdist = _visible(ref_f.graph, "dist")
    assert (ref_f.supersteps, int((fdist < 1e30).sum())) == (4, 77)
    for mode in ("auto", "unfused"):
        r = pregel(g.mapV(init), _inf_vprog, _inf_send, "min",
                   default_msg={"m": torch.tensor(float("inf"))},
                   kernel_mode=mode, track_metrics=True, **kw)
        ids, dist = _visible(r.graph, "dist")
        np.testing.assert_array_equal(ids, rids)
        np.testing.assert_array_equal(dist, rdist)
        assert r.supersteps == ref_u.supersteps
        if mode == "auto":
            assert (r.metrics[0]["plan"], r.metrics[0]["apply_plan"]) == (
                "fused", "fused_apply")


def _two_cliques():
    edges = []
    for a in range(5):
        for b in range(5):
            if a != b:
                edges.append((a, b))
                edges.append((a + 5, b + 5))
    edges.append((0, 5))
    e = np.array(edges, np.int64)
    return e[:, 0], e[:, 1], 10, 2, 5      # labels vid // 5


def _rmat_labels():
    gd = rmat(10, 8, seed=3)
    return gd.src, gd.dst, gd.num_vertices, 16, 1   # labels vid % 16


@pytest.mark.parametrize("case", [_two_cliques, _rmat_labels])
def test_label_propagation_matches_reference(case):
    src, dst, n, k, div = case()
    g, rg = _pair(src, dst)
    g = g.mapV(lambda vid, v: {"label": (vid // div % k).to(torch.int32)})
    rg = rg.mapV(lambda vid, v: {"label": (vid // div % k).astype(jnp.int32)})
    rr = ref_alg.label_propagation(rg, num_labels=k, num_iters=5)
    rids, rlab = _visible(rr.graph, "label")
    want = alg.label_propagation_reference(src, dst, np.arange(n) // div % k,
                                           k, 5)
    np.testing.assert_array_equal(rlab, want[rids])
    send, vprog = alg.label_propagation_fns(k)
    ref_send = lambda sv, ev, dv: {"votes": jax_one_hot(sv["label"] % k, k)}  # noqa: E731
    # the send plans as the reference's does (fused, a k-column message),
    # and so does the apply (amax and a first-argmax chain in the IR)
    assert mt.plan_of(g, send, "sum") == ref_mt.plan_of(rg, ref_send, "sum") \
        == "fused"
    assert mt.apply_plan_of(g, vprog, send, "sum",
                            default_msg={"votes": torch.zeros(k)}) \
        == "fused_apply"
    for mode in ("auto", "unfused"):
        r = alg.label_propagation(g, num_labels=k, num_iters=5,
                                  kernel_mode=mode)
        ids, lab = _visible(r.graph, "label")
        np.testing.assert_array_equal(ids, rids)
        np.testing.assert_array_equal(lab, rlab)
        assert r.supersteps == rr.supersteps
    if case is _two_cliques:
        assert dict(zip(ids.tolist(), lab.tolist())) == {
            v: v // 5 for v in range(10)}


def jax_one_hot(x, k):
    import jax
    return jax.nn.one_hot(x, k, dtype=jnp.float32)


def _k4():
    e = np.array([(a, b) for a in range(4) for b in range(4) if a != b])
    return e[:, 0], e[:, 1], 4


def _star():
    sd = symmetrize(star(16))
    return sd.src, sd.dst, 16


def _rmat5():
    gd = symmetrize(rmat(5, 3, seed=11))
    return gd.src, gd.dst, gd.num_vertices


def _duplicated():
    """K4 on {0, 1, 2, 31} (ids in [0, 32)) with the edge 31 -> 0 and its
    reverse twice: bit 31 of vertex 0's word is summed twice and wraps
    mod 2^32 (vertex 0 loses neighbour 31), as the reference's uint32
    sums wrap; the count then differs from the oracle's 4."""
    ids = [0, 1, 2, 31]
    e = [(a, b) for a in ids for b in ids if a != b] + [(31, 0), (0, 31)]
    e = np.array(e, np.int64)
    return e[:, 0], e[:, 1], 32


@pytest.mark.parametrize("case", [_k4, _star, _rmat5, _duplicated])
def test_triangle_count_matches_reference(case):
    src, dst, n = case()
    g, rg = _pair(src, dst)
    per, total, m = alg.triangle_count(g, n_ids=n)
    rper, rtotal, rm = ref_alg.triangle_count(rg, n_ids=n)
    np.testing.assert_array_equal(per.numpy(), np.asarray(rper))
    assert float(total) == float(rtotal)
    assert m["phase1"]["plan"] == rm["phase1"]["plan"] == "unfused"
    assert m["phase2"]["plan"] == rm["phase2"]["plan"] == "unfused"
    pu, tu, _ = alg.triangle_count(g, n_ids=n, kernel_mode="unfused")
    assert torch.equal(per, pu) and torch.equal(total, tu)
    if case is not _duplicated:
        want = alg.triangle_count_reference(src, dst, n)
        assert want == ref_alg.triangle_count_reference(src, dst, n)
        assert int(round(float(total))) == want
    else:   # the wrapped words miscount as the reference's do
        assert alg.triangle_count_reference(src, dst, n) == 4
        assert int(round(float(total))) != 4


def test_popcount32_counts_bits():
    x = torch.tensor([0, 1, 3, 0x80000000, 0xFFFFFFFF, 0x12345678,
                      0xDEADBEEF], dtype=torch.int64)
    want = [bin(int(v)).count("1") for v in x]
    assert alg.popcount32(x).tolist() == want


def test_coarsen_matches_reference():
    """Listing 7 on symmetrize(rmat(5,3)): domains vid // 4, merge sum and
    min: super-vertex keys and values bit-equal, edge multiset equal."""
    gd = symmetrize(rmat(5, 3, seed=9))
    vids = np.arange(gd.num_vertices, dtype=np.int64)
    rng = np.random.default_rng(0)
    kw = dict(vertex_keys=vids,
              vertex_values={"x": rng.uniform(0, 1, gd.num_vertices).astype(
                  np.float32), "dom": (vids // 4).astype(np.int32)},
              default_vertex={"x": np.float32(0), "dom": np.int32(-1)},
              edge_values={"w": rng.uniform(0.5, 3, gd.num_edges).astype(
                  np.float32)})
    g, rg = _pair(gd.src, gd.dst, **kw)
    for merge in ("sum", "min"):
        c = alg.coarsen(g, lambda sv, ev, dv: sv["dom"] == dv["dom"], merge)
        rc = ref_alg.coarsen(rg, lambda sv, ev, dv: sv["dom"] == dv["dom"],
                             merge)
        ids, vals = c.vertices_to_numpy()
        rids, rvals = rc.vertices_to_numpy()
        np.testing.assert_array_equal(ids, np.asarray(rids))
        for leaf in ("x", "dom"):
            a, b = vals[leaf], np.asarray(rvals[leaf])
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), leaf
        es, ed, ev = c.edges_to_numpy()
        res, red, rev = rc.edges_to_numpy()
        key = lambda s, d, w: sorted(zip(s.tolist(), d.tolist(),  # noqa: E731
                                         np.asarray(w).tolist()))
        assert key(es, ed, ev["w"]) == key(res, red, rev["w"])
        assert c.s.num_vertices < gd.num_vertices
    with pytest.raises(ValueError, match="merge"):
        alg.coarsen(g, lambda sv, ev, dv: sv["dom"] == dv["dom"], "last")

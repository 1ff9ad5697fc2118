"""mrTriplets of the PyTorch port against the JAX reference.

Values, `exists`, join arity, need set, shipped leaves, bytes shipped and
the plan must equal the reference's for quickstart's `more_senior`, the
degree UDF and a min UDF; inside the port, the fused plan equals the
unfused plan bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.core import Graph as RefGraph  # noqa: E402
from repro.core.graph import _degree_msg as ref_degree_msg  # noqa: E402
from repro.data import rmat  # noqa: E402
from repro_torch.core import Graph  # noqa: E402
from repro_torch.core import mrtriplets as mt  # noqa: E402
from repro_torch.core.graph import _degree_msg  # noqa: E402


def _quickstart_graphs():
    gd = rmat(10, 8, seed=42)
    vids = np.arange(gd.num_vertices, dtype=np.int64)
    kw = dict(vertex_keys=vids,
              vertex_values={"age": (20 + vids % 50).astype(np.float32),
                             "rank": (vids * 7 % 101).astype(np.int32)},
              default_vertex={"age": np.float32(0), "rank": np.int32(0)},
              num_partitions=4)
    return (Graph.from_edges(gd.src, gd.dst, device="cpu", **kw),
            RefGraph.from_edges(gd.src, gd.dst, **kw))


@pytest.fixture(scope="module")
def graphs():
    return _quickstart_graphs()


def more_senior(sv, ev, dv):
    return {"n": torch.where(sv["age"] > dv["age"], 1.0, 0.0)}


def more_senior_j(sv, ev, dv):
    return {"n": jnp.where(sv["age"] > dv["age"], 1.0, 0.0)}


def min_rank(sv, ev, dv):
    return {"r": torch.minimum(sv["rank"], dv["rank"])}


def min_rank_j(sv, ev, dv):
    return {"r": jnp.minimum(sv["rank"], dv["rank"])}


def weighted_age(sv, ev, dv):
    return {"a": sv["age"] * ev["w"]}


def weighted_age_j(sv, ev, dv):
    return {"a": sv["age"] * ev["w"]}


CASES = {
    "more_senior": (more_senior, more_senior_j, "sum"),
    "degree": (_degree_msg, ref_degree_msg, "sum"),
    "min_rank": (min_rank, min_rank_j, "min"),
    "weighted_age_max": (weighted_age, weighted_age_j, "max"),
}
METRIC_KEYS = ("join_arity", "need", "shipped_leaves", "plan", "ships",
               "ships_fwd")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("to", ["dst", "src"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_mr_triplets_matches_reference(case, to, graphs):
    G, RG = graphs
    fn, fn_j, reduce = CASES[case]
    vals, exists, g2, m = G.mrTriplets(fn, reduce, to=to)
    rvals, rexists, rg2, rm = RG.mrTriplets(fn_j, reduce, to=to,
                                            kernel_mode="ref")
    for k in METRIC_KEYS:
        assert m[k] == rm[k], k
    assert float(m["bytes_shipped"]) == float(rm["bytes_shipped"])
    assert float(m["bytes_on_wire"]) == float(rm["bytes_on_wire"])
    assert int(m["back"].n_shipped) == int(rm["back"].n_shipped)
    np.testing.assert_array_equal(_np(exists), _np(rexists))
    vm = _np(G.vmask)
    for k in vals:
        got, want = _np(vals[k]), _np(rvals[k])
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got[vm], want[vm])
    # a warm view ships nothing forward the second time, in both
    _, _, _, m2 = g2.mrTriplets(fn, reduce, to=to)
    _, _, _, rm2 = rg2.mrTriplets(fn_j, reduce, to=to, kernel_mode="ref")
    assert m2["ships_fwd"] == rm2["ships_fwd"]
    assert float(m2["bytes_shipped"]) == float(rm2["bytes_shipped"])


@pytest.mark.parametrize("skip_stale", [None, "out", "in", "both"])
@pytest.mark.parametrize("to", ["dst", "src"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_equals_unfused_bit_for_bit(case, to, skip_stale, graphs):
    G, _ = graphs
    fn, _, reduce = CASES[case]
    g = G
    if skip_stale is not None:     # a warm view with half the rows dirty
        _, _, g, _ = G.mrTriplets(fn, reduce, to=to)
        rows = torch.from_numpy(np.random.default_rng(3).random(
            tuple(G.vmask.shape)) < 0.5)
        new = {**g.vdata, "age": torch.where(rows, g.vdata["age"] + 1.0,
                                             g.vdata["age"])}
        from repro_torch.core import view as view_mod
        g = g.replace(vdata=new, view=view_mod.view_after_rewrite(
            g.view, g.vdata, new, None, rows))
    a = mt.mr_triplets(g, fn, reduce, to=to, skip_stale=skip_stale)
    b = mt.mr_triplets(g, fn, reduce, to=to, skip_stale=skip_stale,
                       kernel_mode="unfused")
    assert a[3]["plan"] == "fused" and b[3]["plan"] == "unfused"
    assert torch.equal(a[1], b[1])
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k


def test_reference_fused_and_port_fused_plans_agree(graphs):
    G, RG = graphs
    for fn, fn_j, reduce in CASES.values():
        assert mt.plan_of(G, fn, reduce) == "fused"
    # a float math op: both plan fused, and the port's fused plan equals
    # its unfused plan bit for bit
    def exp_age(sv, ev, dv):
        return {"e": torch.exp(sv["age"] * 0.01)}
    assert mt.plan_of(G, exp_age, "sum") == "fused"
    vals, _, _, m = G.mrTriplets(exp_age, "sum")
    uvals, _, _, um = G.mrTriplets(exp_age, "sum", kernel_mode="unfused")
    rvals, _, _, rm = RG.mrTriplets(
        lambda sv, ev, dv: {"e": jnp.exp(sv["age"] * 0.01)}, "sum")
    assert m["plan"] == "fused" and rm["plan"] == "fused"
    assert um["plan"] == "unfused"
    assert torch.equal(vals["e"], uvals["e"])
    vm = _np(G.vmask)
    np.testing.assert_allclose(_np(vals["e"])[vm], _np(rvals["e"])[vm],
                               rtol=1e-5)


def test_degrees_match_reference(graphs):
    G, RG = graphs
    for direction in ("in", "out"):
        deg, _ = G.degrees(direction)
        rdeg, _ = RG.degrees(direction, kernel_mode="ref")
        np.testing.assert_array_equal(_np(deg), _np(rdeg))


def test_view_dirty_rows_after_rewrite_match_reference(graphs):
    G, RG = graphs
    from repro.core import view as ref_view
    from repro_torch.core import view as view_mod
    _, _, g, _ = G.mrTriplets(min_rank, "min")
    _, _, rg, _ = RG.mrTriplets(min_rank_j, "min", kernel_mode="ref")
    g = g.mapV(lambda vid, v: {**v, "rank": torch.where(
        vid % 3 == 0, v["rank"] + 1, v["rank"])}, changed="diff")
    rg = rg.mapV(lambda vid, v: {**v, "rank": jnp.where(
        vid % 3 == 0, v["rank"] + 1, v["rank"])}, changed="diff")
    assert g.view.dirs == rg.view.dirs and g.view.stale == rg.view.stale
    np.testing.assert_array_equal(_np(view_mod.dirty_rows(g.view)),
                                  _np(ref_view.dirty_rows(rg.view)))
    # the delta ship that follows moves the same bytes
    _, _, _, m = g.mrTriplets(min_rank, "min")
    _, _, _, rm = rg.mrTriplets(min_rank_j, "min", kernel_mode="ref")
    assert float(m["bytes_shipped"]) == float(rm["bytes_shipped"])


def test_local_exchange_contract_matches_reference():
    from repro.core.exchange import LocalExchange as RefLocalExchange
    from repro_torch.core.exchange import LocalExchange
    x = np.random.default_rng(0).normal(size=(4, 4, 5, 2)).astype(np.float32)
    ex, rex = LocalExchange(4), RefLocalExchange(4)
    np.testing.assert_array_equal(_np(ex.transpose(torch.from_numpy(x))),
                                  _np(rex.transpose(jnp.asarray(x))))
    np.testing.assert_array_equal(_np(ex.home_rows(4)), _np(rex.home_rows(4)))
    assert float(ex.psum(torch.tensor(3.0))) == float(rex.psum(jnp.float32(3.0)))
    with pytest.raises(ValueError):
        ex.transpose(torch.zeros(3, 4))


def _vector_graphs():
    """Port and reference graphs with a float vector leaf `v`, an int32
    vector leaf `r` and a float scalar `a` (numpy seed 0)."""
    gd = rmat(8, 8, seed=42)
    n = gd.num_vertices
    rng = np.random.default_rng(0)
    kw = dict(vertex_keys=np.arange(n, dtype=np.int64),
              vertex_values={
                  "v": rng.normal(size=(n, 3)).astype(np.float32),
                  "r": rng.integers(-50, 50, (n, 3)).astype(np.int32),
                  "a": rng.normal(size=n).astype(np.float32)},
              default_vertex={"v": np.zeros(3, np.float32),
                              "r": np.zeros(3, np.int32), "a": np.float32(0)},
              num_partitions=4)
    return (Graph.from_edges(gd.src, gd.dst, device="cpu", **kw),
            RefGraph.from_edges(gd.src, gd.dst, **kw))


@pytest.fixture(scope="module")
def vector_graphs():
    return _vector_graphs()


# UDFs the IR lowers bit-exactly: (port UDF, reference UDF, reduce).  A
# torch integer sum is int64 (jax's is int32), and int64 messages stage
# unfused, so the port's UDF casts its sum back to int32.
EXACT_UDFS = {
    "atan": (lambda s, e, d: {"m": torch.atan(s["a"])},
             lambda s, e, d: {"m": jnp.arctan(s["a"])}, "sum"),
    "atan2": (lambda s, e, d: {"m": torch.atan2(s["a"], d["a"])},
              lambda s, e, d: {"m": jnp.arctan2(s["a"], d["a"])}, "max"),
    "amax": (lambda s, e, d: {"m": s["v"].amax()},
             lambda s, e, d: {"m": jnp.max(s["v"])}, "max"),
    "amin_times_dst": (lambda s, e, d: {"m": torch.amin(s["v"] * d["a"])},
                       lambda s, e, d: {"m": jnp.min(s["v"] * d["a"])},
                       "sum"),
    "max_values": (lambda s, e, d: {"m": s["v"].max()},
                   lambda s, e, d: {"m": jnp.max(s["v"])}, "min"),
    "int_sum": (lambda s, e, d: {"m": s["r"].sum().to(torch.int32)},
                lambda s, e, d: {"m": jnp.sum(s["r"])}, "min"),
}


@pytest.mark.parametrize("to", ["dst", "src"])
@pytest.mark.parametrize("case", sorted(EXACT_UDFS))
def test_exact_reductions_and_atan_plan_fused_as_reference(case, to,
                                                          vector_graphs):
    """atan/atan2 (libm calls), amax/amin/max over a rank-1 leaf and an
    integer sum plan fused in both packages; the port's fused plan equals
    its unfused plan bit for bit and the reference's values (min/max and
    int exactly, the float math within 1e-6 relative).  One exception on
    the CPU: torch's own CPU atan2 rounds differently in its vectorised and
    its scalar loop, so a value depends on where it sits in the array, and
    the two plans (which lay the edges out differently) agree to one ulp
    under max; on the card both are atan2f and agree bit for bit
    (tests/test_torch_cuda.py::test_fused_equals_unfused_on_card)."""
    G, RG = vector_graphs
    fn, fn_j, reduce = EXACT_UDFS[case]
    vals, exists, _, m = G.mrTriplets(fn, reduce, to=to)
    uvals, uexists, _, um = G.mrTriplets(fn, reduce, to=to,
                                         kernel_mode="unfused")
    rvals, rexists, _, rm = RG.mrTriplets(fn_j, reduce, to=to)
    assert m["plan"] == rm["plan"] == "fused" and um["plan"] == "unfused"
    assert torch.equal(exists, uexists)
    if case == "atan2":
        np.testing.assert_array_max_ulp(_np(vals["m"]), _np(uvals["m"]), 1)
    else:
        assert torch.equal(vals["m"], uvals["m"])
    np.testing.assert_array_equal(_np(exists), _np(rexists))
    vm = _np(G.vmask)
    got, want = _np(vals["m"])[vm], _np(rvals["m"])[vm]
    if case.startswith("atan"):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["sum", "dot", "matmul"])
def test_float_vector_sums_plan_unfused_on_purpose(case, vector_graphs):
    """A float sum, dot or matmul inside a UDF stays unfused in the port
    (torch does not pin the unfused plan's order of those terms, so fused ==
    unfused could not hold bit for bit); the reference fuses it.  The
    values agree within f32 rounding."""
    G, RG = vector_graphs
    fn, fn_j = {
        "sum": (lambda s, e, d: {"m": s["v"].sum()},
                lambda s, e, d: {"m": jnp.sum(s["v"])}),
        "dot": (lambda s, e, d: {"m": torch.dot(s["v"], d["v"])},
                lambda s, e, d: {"m": jnp.dot(s["v"], d["v"])}),
        "matmul": (lambda s, e, d: {"m": s["v"] @ d["v"]},
                   lambda s, e, d: {"m": s["v"] @ d["v"]}),
    }[case]
    assert mt.plan_of(G, fn, "sum") == "unfused"
    vals, _, _, m = G.mrTriplets(fn, "sum")
    rvals, _, _, rm = RG.mrTriplets(fn_j, "sum")
    assert (m["plan"], rm["plan"]) == ("unfused", "fused")
    vm = _np(G.vmask)
    np.testing.assert_allclose(_np(vals["m"])[vm], _np(rvals["m"])[vm],
                               rtol=1e-5, atol=1e-5)

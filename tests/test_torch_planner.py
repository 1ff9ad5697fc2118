"""The chain planner of the PyTorch port against the JAX reference.

The mirrors of tests/test_planner.py: every case runs the port's
`plan_chain` / `run_chain` and the reference's on the same graph.  The
plans (keep_dirs, fused) equal the reference's, the chain outputs equal
the reference's bit for bit (f32), optimize on equals optimize off bit for
bit, and the bytes each chain ships equal the reference's.  The
reference's own assertions hold on the port too.  The reference's jit
case has no jit to mirror: its counterpart shows that plan_chain reads
element specs only (the same plan for two graphs whose values differ).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from repro.core import Graph as RefGraph  # noqa: E402
from repro.core import planner as RP  # noqa: E402
from repro.data import rmat  # noqa: E402
from repro_torch.core import Graph  # noqa: E402
from repro_torch.core import planner as TP  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402

# one UDF object per role, traced by both engines (the arithmetic reads
# the same in torch and jnp)
SEND_X = lambda sv, ev, dv: {"m": sv["x"] * ev["w"]}            # noqa: E731
SEND_XY = lambda sv, ev, dv: {"m": sv["x"] * ev["w"] + dv["y"]}  # noqa: E731
BUMP = lambda vid, v: {"x": v["x"] + 1.0, "y": v["y"]}          # noqa: E731
DIRTY_ALL = lambda vid, v: {"x": v["x"] + 1.0, "y": v["y"] * 2.0}  # noqa: E731
RETYPE = lambda vid, v: {"z": v["x"] + v["y"]}                  # noqa: E731
SEND_Z = lambda sv, ev, dv: {"m": sv["z"]}                      # noqa: E731
W_POS = lambda sv, ev, dv: ev["w"] > 0.0                        # noqa: E731
Y_LT3 = lambda sv, ev, dv: sv["y"] < 3.0                        # noqa: E731
X_GT4 = lambda vid, v: v["x"] > 4.0                             # noqa: E731
MASK_W = lambda sv, ev, dv: {"w": ev["w"] * (sv["x"] > 0.0)}    # noqa: E731


def opaque(sv, ev, dv):
    if sv["x"] > 0:              # a concrete branch: the trace fails
        return {"m": sv["x"]}
    return {"m": dv["y"]}


def _steps(mod, spec):
    """A chain of `mod`'s step classes from (class name, args, kwargs)."""
    return [getattr(mod, name)(*args, **kw) for name, args, kw in spec]


def MV(f):
    return ("MapV", (f,), {})


def MT(f, **kw):
    return ("MrTriplets", (f, "sum"), kw)


def SG(**kw):
    return ("Subgraph", (), kw)


def ME(f):
    return ("MapE", (f,), {})


def _build(scale=6, xmul=1.0):
    gd = rmat(scale, 4, seed=0)
    vids = np.arange(gd.num_vertices, dtype=np.int64)
    kw = dict(vertex_keys=vids,
              vertex_values={"x": ((vids % 17 + 1) * xmul).astype(np.float32),
                             "y": (vids % 5).astype(np.float32)},
              default_vertex={"x": np.float32(0), "y": np.float32(0)},
              num_partitions=4)
    return (Graph.from_edges(gd.src, gd.dst, device="cpu", **kw),
            RefGraph.from_edges(gd.src, gd.dst, **kw))


@pytest.fixture(scope="module")
def graphs():
    return _build()


@pytest.fixture(scope="module")
def warm(graphs):
    """Both engines' views filled over both directions for both leaves."""
    g, rg = graphs
    return g.mrTriplets(SEND_XY, "sum")[2], rg.mrTriplets(SEND_XY, "sum")[2]


def _plans(pair, spec, **kw):
    g, rg = pair
    got = TP.plan_chain(g, _steps(TP, spec), **kw)
    want = RP.plan_chain(rg, _steps(RP, spec), **kw)
    assert got == TP.ChainPlan(keep_dirs=want.keep_dirs, fused=want.fused)
    return got


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _outputs_equal(a, b):
    assert len(a.outputs) == len(b.outputs)
    for (va, ea, _), (vb, eb, _) in zip(a.outputs, b.outputs):
        la, lb = tree_leaves((va, ea)), jax.tree.leaves((vb, eb))
        assert len(la) == len(lb)
        for x, y in zip(la, lb):
            np.testing.assert_array_equal(_np(x), _np(y))


def _chain_bytes(g0, res):
    return float(res.graph.bytes_shipped) - float(g0.bytes_shipped)


def _run(pair, spec, **kw):
    """(port on, port off, reference on, reference off), the port's
    outputs == the reference's and on == off, bytes per chain ==."""
    g, rg = pair
    res = [TP.run_chain(g, _steps(TP, spec), optimize=o, **kw)
           for o in (True, False)]
    rres = [RP.run_chain(rg, _steps(RP, spec), optimize=o, **kw)
            for o in (True, False)]
    _outputs_equal(res[0], res[1])
    for a, b in zip(res, rres):
        _outputs_equal(a, b)
        assert _chain_bytes(g, a) == _chain_bytes(rg, b)
        assert [r.get("pruned_dirs") for r in a.step_metrics] == \
            [r.get("pruned_dirs") for r in b.step_metrics]
    return res[0], res[1]


# --------------------------------------------------------- static planning
def test_plan_backward_read_set_composition(graphs):
    plan = _plans(graphs, [MV(BUMP), MT(SEND_X), MT(SEND_X)])
    assert plan.keep_dirs == (("s", ""), ("s", ""), ("s", ""))
    plan2 = _plans(graphs, [MT(SEND_XY), MT(SEND_X)])
    assert plan2.keep_dirs == (("sd", "sd"), ("s", ""))


def test_plan_skip_stale_is_a_barrier(graphs):
    plan = _plans(graphs, [MV(BUMP), MT(SEND_X, skip_stale="out"),
                           MT(SEND_X)])
    assert plan.keep_dirs[0] is None and plan.keep_dirs[1] is None
    assert plan.keep_dirs[2] == ("s", "")
    p2 = _plans(graphs, [SG(epred=W_POS), MT(SEND_X, skip_stale="out")])
    assert p2.fused == (False, False)


def test_plan_structure_changing_mapv_is_a_barrier(graphs):
    plan = _plans(graphs, [MT(SEND_X), MV(RETYPE), MT(SEND_Z)])
    assert plan.keep_dirs[0] is None and plan.keep_dirs[1] is None
    assert plan.keep_dirs[2] == ("s",)


def test_plan_unanalyzable_udf_disables_pruning_behind_it(graphs):
    plan = _plans(graphs, [MT(SEND_X), MT(opaque)])
    assert plan.keep_dirs == (None, None)


def test_plan_optimize_false_plans_nothing(graphs):
    plan = _plans(graphs, [SG(epred=W_POS), MT(SEND_X)], optimize=False)
    assert plan.fused == (False, False)
    assert all(k is None for k in plan.keep_dirs)


# ------------------------------------------- join elimination differential
@pytest.mark.parametrize("km", ["ref", "unfused", "auto"])
def test_chain_pruning_matches_lazy_refresh_bit_exact(warm, km):
    on, off = _run(warm, [MV(BUMP), MT(SEND_X, kernel_mode=km),
                          MT(SEND_X, kernel_mode=km)])
    g = warm[0]
    b_on, b_off = _chain_bytes(g, on), _chain_bytes(g, off)
    assert 0 < b_on == b_off, (b_on, b_off)
    assert sum(r.get("pruned_dirs", 0) for r in on.step_metrics) > 0


def test_chain_drops_leaf_no_consumer_reads(warm):
    on, off = _run(warm, [MV(DIRTY_ALL), MT(SEND_X), MT(SEND_X)])
    b_on, b_off = _chain_bytes(warm[0], on), _chain_bytes(warm[0], off)
    assert 0 < b_on == b_off, (b_on, b_off)


def test_cold_chain_identical_plans(graphs):
    on, off = _run(graphs, [MT(SEND_X), MT(SEND_X)])
    assert _chain_bytes(graphs[0], on) == _chain_bytes(graphs[0], off)


def test_skip_stale_chain_bit_exact(warm):
    on, off = _run(warm, [MV(BUMP), MT(SEND_X, skip_stale="out"),
                          MT(SEND_XY, skip_stale="in")])
    assert _chain_bytes(warm[0], on) == _chain_bytes(warm[0], off)


# -------------------------------------------------- predicate pushdown
def test_epred_pushdown_bit_exact_and_restricts_scan(graphs):
    spec = [SG(epred=Y_LT3), MT(SEND_X)]
    on, off = _run(graphs, spec)
    assert _plans(graphs, spec).fused == (True, False)
    g0 = graphs[0]
    assert torch.equal(on.graph.emask, off.graph.emask)
    np.testing.assert_array_equal(_np(on.graph.emask),
                                  _np(RP.run_chain(graphs[1], _steps(
                                      RP, spec)).graph.emask))
    live = float(on.outputs[0][2]["live_edges"])
    assert 0 < live < int(g0.emask.sum())
    assert _chain_bytes(g0, on) <= _chain_bytes(g0, off)
    assert on.step_metrics[0].get("pushdown") is True


def test_vpred_pushdown_defers_visibility_ship(graphs):
    on, off = _run(graphs, [SG(vpred=X_GT4), MT(SEND_XY)])
    g0 = graphs[0]
    assert torch.equal(on.graph.vmask, off.graph.vmask)
    assert torch.equal(on.graph.emask, off.graph.emask)
    assert _chain_bytes(g0, on) <= _chain_bytes(g0, off)
    assert float(on.outputs[0][2]["live_edges"]) < int(g0.emask.sum())


def test_pushdown_then_more_chain(warm):
    on, off = _run(warm, [MV(BUMP), SG(epred=W_POS), MT(SEND_X),
                          MT(SEND_X)])
    b_on, b_off = _chain_bytes(warm[0], on), _chain_bytes(warm[0], off)
    assert 0 < b_on <= b_off, (b_on, b_off)
    assert sum(r.get("pruned_dirs", 0) for r in on.step_metrics) > 0


# ----------------------------------------------- transport + spec-only plans
def test_auto_transport_adapts_per_step(warm):
    spec = [MV(BUMP), MT(SEND_X), MT(SEND_X)]
    on, _ = _run(warm, spec, transport="auto")
    recs = [r for r in on.step_metrics if "transport_next" in r]
    assert recs, "host re-planning never ran between steps"
    assert all(r["transport_next"] in ("dense", "ragged") for r in recs)
    want = RP.run_chain(warm[1], _steps(RP, spec), transport="auto")
    assert [(r["transport"], r.get("transport_next"))
            for r in on.step_metrics] == \
        [(r["transport"], r.get("transport_next"))
         for r in want.step_metrics]


def test_plan_reads_only_element_specs(graphs):
    """The reference traces its chain under jit; the port's counterpart:
    two graphs with equal specs and other values plan alike, and the
    chain on each equals the reference's."""
    other = _build(xmul=3.0)
    spec = [MV(BUMP), MT(SEND_X), MT(SEND_X)]
    assert TP.plan_chain(graphs[0], _steps(TP, spec)) == \
        TP.plan_chain(other[0], _steps(TP, spec))
    for pair in (graphs, other):
        got = TP.run_chain(pair[0], _steps(TP, spec))
        want = RP.run_chain(pair[1], _steps(RP, spec))
        _outputs_equal(got, want)
        assert float(got.graph.bytes_shipped) == \
            float(want.graph.bytes_shipped)


def test_mape_in_chain(warm):
    on, off = _run(warm, [MV(BUMP), ME(MASK_W), MT(SEND_X)])
    assert _chain_bytes(warm[0], on) <= _chain_bytes(warm[0], off)

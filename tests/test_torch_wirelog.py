"""The graph's wire log (`core/view.py:WireLog`) against the reference's.

`Graph.ships`, `bytes_shipped` and `bytes_accounted` must equal the
reference's after each operator of a chain that refreshes the view
(mapE, subgraph, mrTriplets) and after a Pregel run, and the per-superstep
`pipeline_ships` / `pipeline_bytes_shipped` metrics must equal the
reference's for PageRank and CC, under the f32 wire and a delta int8 wire
(whose accounted bytes are a device tensor).  Counts and byte totals are
integers below 2^24, so the f32 accumulators agree exactly.  The records
hold the reference's keys (the transport's decision, capacity, fallbacks
and recompiles among them, equal to its values), each ship's record the
reference's ShipMetrics fields.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.core import Graph as RefGraph  # noqa: E402
from repro.core import algorithms as ref_alg  # noqa: E402
from repro.core import with_wire as ref_with_wire  # noqa: E402
from repro.data import rmat, symmetrize  # noqa: E402
from repro_torch.core import Graph, with_wire  # noqa: E402
from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.core.view import WireLog  # noqa: E402

# static mrTriplets entries the port keeps in its records (its own tests
# and chip_smoke.py read them) and the reference strips, since its jitted
# superstep cannot return Python ints; the port's live count; the whole
# concrete transport policy of the superstep; and its captures of the
# superstep with their host ms (the reference counts its compiles as
# `recompiles`, which both records hold)
PORT_ONLY = {"ships", "ships_fwd", "shipped_leaves", "mirror_hbm_bytes",
             "live", "transport_plan", "captures", "capture_ms"}
# the fields of each ship's record (ShipMetrics), the reference's
SHIP_FIELDS = {"wire_bytes", "effective_bytes", "n_shipped",
               "bytes_accounted", "bytes_shipped", "route_width",
               "bytes_link_modeled", "ragged", "route_active_max",
               "overflow", "wire_faults", "degraded", "route_active_frac"}


def _pair(wire=None):
    gd = symmetrize(rmat(7, 6, seed=5))
    w = np.random.default_rng(3).uniform(0.5, 3, gd.num_edges).astype(
        np.float32)
    g = Graph.from_edges(gd.src, gd.dst, edge_values={"w": w},
                         num_partitions=4, device="cpu")
    rg = RefGraph.from_edges(gd.src, gd.dst, edge_values={"w": w},
                             num_partitions=4)
    if wire is not None:
        g = g.replace(ex=with_wire(g.ex, wire, delta=True))
        rg = rg.replace(ex=ref_with_wire(rg.ex, wire, delta=True))
    return g, rg


def _log(g):
    return (float(g.ships), float(g.bytes_shipped), float(g.bytes_accounted))


def test_wirelog_add_bumps_row_zero():
    log = WireLog.zeros(3).add(2, 100, torch.tensor(7, dtype=torch.int64))
    assert log.ships.tolist() == [2.0, 0.0, 0.0]
    assert log.bytes_shipped.tolist() == [100.0, 0.0, 0.0]
    assert log.bytes_accounted.tolist() == [7.0, 0.0, 0.0]
    assert log.ships.dtype == torch.float32


@pytest.mark.parametrize("wire", [None, "int8"])
def test_chain_wire_log_matches_reference(wire):
    g, rg = _pair(wire)
    assert _log(g) == _log(rg) == (0.0, 0.0, 0.0)
    g = g.mapV(lambda vid, v: {"x": vid.to(torch.float32)})
    rg = rg.mapV(lambda vid, v: {"x": vid.astype(jnp.float32)})
    steps = [
        ("mapE", lambda x: x.mapE(
            lambda sv, ev, dv: {"w": ev["w"] + sv["x"]})),
        ("mapE, no vertex read", lambda x: x.mapE(
            lambda sv, ev, dv: {"w": ev["w"] * 2.0})),
        ("subgraph", lambda x: x.subgraph(
            vpred=lambda vid, v: v["x"] % 3 != 0,
            epred=lambda sv, ev, dv: ev["w"] > 2.0)),
        ("mrTriplets", lambda x: x.mrTriplets(
            lambda sv, ev, dv: {"m": sv["x"] * ev["w"]}, "sum")[2]),
        ("mrTriplets again, clean view", lambda x: x.mrTriplets(
            lambda sv, ev, dv: {"m": sv["x"] + dv["x"]}, "max")[2]),
    ]
    for label, op in steps:
        g, rg = op(g), op(rg)
        assert _log(g) == _log(rg), label
    assert _log(g)[0] > 0
    # a Pregel run on the chain's graph: its supersteps add to the log
    r = alg.connected_components(g.mapV(alg._cc_init), max_supersteps=20)
    rr = ref_alg.connected_components(rg.mapV(lambda vid, v: {"cc": vid}),
                                      max_supersteps=20)
    assert r.supersteps == rr.supersteps
    assert _log(r.graph) == _log(rr.graph)
    assert _log(r.graph)[0] > _log(g)[0]


@pytest.mark.parametrize("wire", [None, "int8"])
@pytest.mark.parametrize("name", ["pagerank", "cc"])
def test_pipeline_metrics_per_superstep_match_reference(name, wire):
    g, rg = _pair(wire)
    if name == "pagerank":
        r = alg.pagerank(g, num_iters=6, track_metrics=True)
        rr = ref_alg.pagerank(rg, num_iters=6, track_metrics=True)
    else:
        r = alg.connected_components(g.mapV(alg._cc_init),
                                     track_metrics=True)
        rr = ref_alg.connected_components(
            rg.mapV(lambda vid, v: {"cc": vid}), track_metrics=True)
    assert len(r.metrics) == len(rr.metrics) == r.supersteps
    for m, rm in zip(r.metrics, rr.metrics):
        assert m["pipeline_ships"] == rm["pipeline_ships"]
        assert m["pipeline_bytes_shipped"] == rm["pipeline_bytes_shipped"]
        assert set(m) == set(rm) | PORT_ONLY
        for side in ("fwd", "back"):
            assert set(m[side]) == SHIP_FIELDS == {
                f.name for f in dataclasses.fields(rm[side])}
        for k in ("transport", "transport_cap", "transport_frac", "ragged",
                  "recompiles", "overflow_fallbacks", "wire_faults",
                  "degraded_routes", "transport_state"):
            want = rm[k] if isinstance(rm[k], str) else float(rm[k])
            assert m[k] == want, k
    assert _log(r.graph) == _log(rr.graph)
    assert r.metrics[-1]["pipeline_ships"] == float(r.graph.ships)

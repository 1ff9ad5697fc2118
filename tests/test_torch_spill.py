"""The port's out-of-core residency (`repro_torch.core.spill`,
`pregel(working_set_frac=)`) against the JAX reference's.

`plan_spill` and `choose_cold` equal the reference's (hypothesis over
shapes, fractions and active masks, ties included).  PageRank and CC at
working_set_frac 0.5 and 0.25 equal the fully resident run bit for bit
and the reference (PageRank within 1e-5 relative, CC bit for bit), with
each superstep's `stream_bytes`, `spill_resident_bytes` and
`spill_host_bytes` equal to the reference's; every rotation's resident
bytes stay under the footprint cap of tests/spmd_check.py; the ring
writes the tensors it was given in place (the replays read them) and
never the caller's; a checkpoint taken while cells are spilled (`peek`)
resumes bit-equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.core import Graph as RefGraph  # noqa: E402
from repro.core import algorithms as ref_alg  # noqa: E402
from repro.core import spill as RS  # noqa: E402
from repro.core.pregel import pregel as ref_pregel  # noqa: E402
from repro_torch.core import Graph  # noqa: E402
from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.core import spill as S  # noqa: E402
from repro_torch.core.pregel import pregel  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:          # dev-only dependency (requirements-dev.txt)
    HAVE_HYPOTHESIS = False

P = 4
PR_RTOL = 1e-5
IMAX = 2 ** 31 - 1
STEPS = 6
BYTE_FIELDS = ("stream_bytes", "spill_resident_bytes", "spill_host_bytes")


def _edges(sym=False):
    rng = np.random.RandomState(3)
    # 2500 vertices: 640 home slots a partition, whole 128-row cells
    src, dst = rng.randint(0, 2500, 10000), rng.randint(0, 2500, 10000)
    if sym:
        src, dst = np.r_[src, dst], np.r_[dst, src]
    return src, dst


def _port(name, frac=None, n=STEPS, **kw):
    if name == "pr":
        src, dst = _edges()
        g = Graph.from_edges(src, dst, num_partitions=P, device="cpu")
        g = alg.attach_out_degree(g).mapV(
            lambda vid, v: {**v, "pr": torch.tensor(1.0)})
        return g, pregel(g, alg.pagerank_vprog(0.15), alg.pagerank_send,
                         "sum", default_msg={"m": torch.tensor(0.0)},
                         skip_stale=None, max_supersteps=n,
                         track_metrics=True, working_set_frac=frac, **kw)
    src, dst = _edges(sym=True)
    g = Graph.from_edges(src, dst, num_partitions=P, device="cpu").mapV(
        alg._cc_init)
    return g, pregel(g, alg.cc_vprog, alg.cc_send, "min",
                     default_msg={"m": torch.tensor(IMAX, dtype=torch.int32)},
                     max_supersteps=n, track_metrics=True,
                     working_set_frac=frac, **kw)


_REF: dict = {}


def _ref(name, frac):
    if (name, frac) in _REF:
        return _REF[name, frac]
    if name == "pr":
        src, dst = _edges()
        g = RefGraph.from_edges(src, dst, num_partitions=P)
        g = ref_alg.attach_out_degree(g).mapV(
            lambda vid, v: {**v, "pr": jnp.float32(1.0)})
        r = ref_pregel(
            g, lambda vid, v, m: {**v, "pr": 0.15 + 0.85 * m["m"]},
            lambda sv, ev, dv: {"m": sv["pr"] / sv["deg"] * ev["w"]}, "sum",
            default_msg={"m": jnp.float32(0.0)}, skip_stale=None,
            max_supersteps=STEPS, track_metrics=True,
            working_set_frac=frac)
    else:
        src, dst = _edges(sym=True)
        g = RefGraph.from_edges(src, dst, num_partitions=P).mapV(
            lambda vid, v: {"cc": vid})
        r = ref_pregel(
            g, lambda vid, v, m: {"cc": jnp.minimum(v["cc"], m["m"])},
            lambda sv, ev, dv: {"m": sv["cc"]}, "min",
            default_msg={"m": jnp.int32(IMAX)}, max_supersteps=STEPS,
            track_metrics=True, working_set_frac=frac)
    _REF[name, frac] = ({k: np.asarray(v) for k, v in r.graph.vdata.items()},
                        [[m[f] for f in BYTE_FIELDS] for m in r.metrics])
    return _REF[name, frac]


@pytest.fixture(scope="module")
def resident():
    return {name: _port(name)[1] for name in ("pr", "cc")}


# ---------------------------------------------------------------------------
# The plan and the cold cells
# ---------------------------------------------------------------------------
class _Active:
    def __init__(self, active):
        self.active = active


def _plans_equal(nl, v_blk, frac, active):
    g = _Active(active)
    got, want = S.plan_spill(g, frac), RS.plan_spill(g, frac)
    assert (got.nl, got.v_blk, got.block, got.n_cells, got.n_cold) == (
        want.nl, want.v_blk, want.block, want.n_cells, want.n_cold)
    assert got.n_total == want.n_total
    assert S.choose_cold(got, active) == RS.choose_cold(want, active)


@pytest.mark.parametrize("nl,v_blk,frac", [
    (4, 1000, 0.5), (3, 37, 0.25), (2, 4096, 0.5), (4, 130, 0.7),
    (1, 64, 1.0), (4, 2049, 0.1)])
def test_plan_and_cold_cells_equal_reference(nl, v_blk, frac):
    rng = np.random.default_rng(v_blk)
    active = rng.random((nl, v_blk)) < 0.3
    active[:, : v_blk // 3] = True       # ties among the full cells
    _plans_equal(nl, v_blk, frac, active)
    with pytest.raises(ValueError):
        S.plan_spill(_Active(active), 0.0)


if HAVE_HYPOTHESIS:
    @settings(max_examples=40, deadline=None)
    @given(nl=st.integers(1, 5), v_blk=st.integers(1, 3000),
           frac=st.floats(0.01, 1.0), dens=st.floats(0.0, 1.0),
           seed=st.integers(0, 2 ** 31 - 1))
    def test_plan_and_cold_cells_hypothesis(nl, v_blk, frac, dens, seed):
        rng = np.random.default_rng(seed)
        _plans_equal(nl, v_blk, frac, rng.random((nl, v_blk)) < dens)


# ---------------------------------------------------------------------------
# Pregel out of core
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("frac", [0.5, 0.25])
@pytest.mark.parametrize("name", ["pr", "cc"])
def test_out_of_core_equals_resident_and_reference(resident, name, frac):
    g, r = _port(name, frac)
    full = resident[name]
    assert r.supersteps == full.supersteps
    for k, v in full.graph.vdata.items():
        assert torch.equal(r.graph.vdata[k], v), k
    want, want_bytes = _ref(name, frac)
    for k, v in want.items():
        if name == "pr":
            np.testing.assert_allclose(r.graph.vdata[k].numpy(), v,
                                       rtol=PR_RTOL)
        else:
            np.testing.assert_array_equal(r.graph.vdata[k].numpy(), v)
    assert [[m[f] for f in BYTE_FIELDS] for m in r.metrics] == want_bytes
    # the footprint cap: the hottest ceil(f * total) cells plus one cell of
    # slack for clipped tail cells
    plan = S.plan_spill(g, frac)
    full_b = S.vdata_nbytes(g.vdata)
    cap = full_b * (plan.n_total - plan.n_cold + 1) / plan.n_total
    resid = [m["spill_resident_bytes"] for m in r.metrics]
    assert plan.n_cold > 0 and max(resid) <= cap and min(resid) < full_b
    for m in r.metrics:
        assert m["stream_bytes"] > 0
        assert m["stream_time_overlap"] < m["stream_time_serial"]
        assert m["compute_time_modeled"] > 0
    # the caller's graph is untouched
    assert torch.equal(g.vdata[next(iter(g.vdata))],
                       _port(name, n=0)[0].vdata[next(iter(g.vdata))])


def test_ring_round_trips_in_place():
    """spill zeroes the cold rows of the very tensors it was given, restore
    writes the same bits back into them; peek leaves them spilled."""
    src, dst = _edges()
    g = Graph.from_edges(src, dst, num_partitions=P, device="cpu")
    g = g.mapV(lambda vid, v: {"a": vid.float() * 1.5, "b": vid % 7})
    ring = S.SpillRing(plan=S.plan_spill(g, 0.5))
    g = ring.own(g)
    before = {k: v.clone() for k, v in g.vdata.items()}
    ptrs = {k: v.data_ptr() for k, v in g.vdata.items()}
    g2 = ring.spill(g)
    assert {k: v.data_ptr() for k, v in g2.vdata.items()} == ptrs
    assert ring.host_bytes() > 0 and ring.bytes_out == ring.host_bytes()
    assert not torch.equal(g2.vdata["a"], before["a"])
    peeked = ring.peek(g2)
    for k in before:
        assert torch.equal(peeked.vdata[k], before[k])
    assert not torch.equal(g2.vdata["a"], before["a"])
    g3 = ring.restore(g2)
    for k in before:
        assert torch.equal(g3.vdata[k], before[k])
        assert g3.vdata[k].data_ptr() == ptrs[k]
    assert ring.host_bytes() == 0 and ring.bytes_in == ring.bytes_out
    assert ring.resident_bytes(g3) == S.vdata_nbytes(g3.vdata)


def test_peek_under_a_checkpoint(tmp_path, resident):
    """A snapshot taken while half the cells are on the host holds the
    full state: the run resumed from it equals the resident run."""
    d = str(tmp_path / "ckpt")
    _, r1 = _port("pr", 0.5, n=3, checkpoint=d, checkpoint_every=3)
    assert r1.supersteps == 3
    _, r2 = _port("pr", 0.5, n=STEPS, checkpoint=d)
    assert r2.supersteps == STEPS - 3
    for k, v in resident["pr"].graph.vdata.items():
        assert torch.equal(r2.graph.vdata[k], v), k

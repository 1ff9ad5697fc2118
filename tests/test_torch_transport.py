"""The transport layer of the PyTorch port (`repro_torch.core.transport`)
against the JAX reference's (`repro.core.transport`).

The pure policy functions (capacities, tiers, adapt_policy with its
per-route hysteresis) equal the reference's on hypothesis-drawn inputs.
Routed ships under the dense, ragged, tiered and pipelined transports give
the reference's receive buffers and flags byte for byte, under the f32,
int8, fp8 and delta codecs, with the reference's branch, overflow and
bytes; the overflow fallback switches both ways and the prefer_ragged gate
holds the dense branch.  End to end, delta PageRank under the auto policy
and CC under the ragged one equal the dense runs and the reference bit for
bit, and the per-superstep transport records equal the reference's.  The
ring transpose equals the transpose, the pipelined Pregel matrix and a
warm view's re-entry equal the serialized ones, and an oscillating
frontier pins its tier.

Where the reference's own hypothesis test expects a ragged ship that
`capacity_for` clamps to dense (a capacity past the break-even fraction),
the port is held to the reference's actual answer.
"""
import dataclasses
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.core import Graph as RefGraph  # noqa: E402
from repro.core import LocalExchange as RefLocalExchange  # noqa: E402
from repro.core import algorithms as ref_alg  # noqa: E402
from repro.core import transport as RT  # noqa: E402
from repro.core import wire as RW  # noqa: E402
from repro.core import with_wire as ref_with_wire  # noqa: E402
from repro.core.mrtriplets import mr_triplets as ref_mr_triplets  # noqa: E402
from repro.data import rmat, symmetrize  # noqa: E402
from repro_torch.core import Graph, with_wire  # noqa: E402
from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.core import transport as T  # noqa: E402
from repro_torch.core import wire as W  # noqa: E402
from repro_torch.core.exchange import LocalExchange  # noqa: E402
from repro_torch.core.mrtriplets import mr_triplets  # noqa: E402

pm = sys.modules["repro_torch.core.pregel"]

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:          # dev-only dependency (requirements-dev.txt)
    HAVE_HYPOTHESIS = False

CODECS = [None, "int8", "fp8_e4m3", "f32_delta"]
# fig4's policy (benchmarks/fig4_incremental.py)
FIG4 = dict(cap_rounding=32, enter_frac=0.95, exit_frac=0.97)


def _ref_policy(pol: T.TransportPolicy) -> RT.TransportPolicy:
    """The reference's policy with the same fields, built by position."""
    return RT.TransportPolicy(*[getattr(pol, f.name)
                                for f in dataclasses.fields(pol)])


def _exchanges(codec, p=4):
    ex, rex = LocalExchange(p), RefLocalExchange(p)
    if codec == "f32_delta":
        return with_wire(ex, "f32", delta=True), ref_with_wire(rex, "f32",
                                                               delta=True)
    if codec is not None:
        return (with_wire(ex, codec, delta=True),
                ref_with_wire(rex, codec, delta=True))
    return ex, rex


def _bits(x) -> np.ndarray:
    """A received leaf as comparable bits (bf16 / f32 / ints)."""
    a = x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x).astype(np.float32)
    return a.view(np.uint32)


def _route_tree(rng, nl=4, p=4, k=24):
    return {"a": rng.normal(size=(nl, p, k)).astype(np.float32),
            "b": rng.normal(size=(nl, p, k, 3)).astype(np.float32)}


def _ship_both(tree, flags, policy, codec=None, prefer=None, p=4):
    """(port (recv, rf, info), reference (recv, rf, info)) of one ship."""
    ex, rex = _exchanges(codec, p)
    got = T.ship_transport(
        ex, {k: torch.from_numpy(v) for k, v in tree.items()},
        torch.from_numpy(flags), policy=policy,
        prefer_ragged=None if prefer is None else torch.tensor(prefer))
    want = RT.ship_transport(
        rex, {k: jnp.asarray(v) for k, v in tree.items()},
        jnp.asarray(flags), policy=_ref_policy(policy),
        prefer_ragged=None if prefer is None else jnp.bool_(prefer))
    return got, want


def _assert_ship_equal(got, want, flags):
    recv, rf, info = got
    rrecv, rrf, rinfo = want
    np.testing.assert_array_equal(rf.numpy(), np.asarray(rrf))
    for k in rrecv:
        np.testing.assert_array_equal(_bits(recv[k]), _bits(rrecv[k]), k)
    for f in ("bytes_shipped", "ragged", "overflow", "route_active_max"):
        assert float(getattr(info, f)) == float(getattr(rinfo, f)), f
    # the occupancy as the reference's compiled superstep computes it: XLA
    # turns counts / K into counts * f32(1 / K) (its eager op divides)
    counts = flags.sum(-1).max(0).astype(np.float32)
    np.testing.assert_array_equal(info.route_active_frac.numpy(),
                                  counts * np.float32(1.0 / flags.shape[-1]))
    np.testing.assert_allclose(info.route_active_frac.numpy(),
                               np.asarray(rinfo.route_active_frac),
                               rtol=2e-7)


# ---------------------------------------------------------------------------
# Policy resolution and capacity arithmetic
# ---------------------------------------------------------------------------
def test_resolve_and_capacity():
    assert T.resolve_transport(None).kind == "dense"
    for name in T.TRANSPORT_NAMES:
        assert T.resolve_transport(name).kind == name
    pol = T.TransportPolicy("ragged", cap_rounding=8)
    assert T.resolve_transport(pol) is pol
    with pytest.raises(ValueError):
        T.resolve_transport("sparse")
    assert [f.name for f in dataclasses.fields(T.TransportPolicy)] == [
        f.name for f in dataclasses.fields(RT.TransportPolicy)]
    assert T.TransportPolicy() == T.DENSE and T.TRANSPORT_NAMES == \
        RT.TRANSPORT_NAMES
    assert T.capacity_for(pol.replace(capacity_frac=0.5), 64) == 32
    assert T.capacity_for(pol.replace(capacity_frac=0.26), 64) == 24
    assert T.capacity_for(pol.replace(cap=5), 64) == 8
    assert T.capacity_for(pol.replace(capacity_frac=1.0), 64) is None
    assert T.capacity_for(pol.replace(cap=3), 8) is None
    assert T.capacity_for(T.DENSE, 64) is None
    assert T.index_dtype(64) == RT.index_dtype(64) == np.int8
    assert T.index_dtype(4000) == RT.index_dtype(4000) == np.int16


def test_integrity_is_refused_and_names_the_roadmap():
    """The integrity ladder is ported (the name is the old refusal's): an
    integrity policy resolves, and a checked ship with no fault equals the
    reference's checked ship and the unchecked one, with the word bytes on
    top; the broadcast lane's checked ship equals its unchecked one."""
    chk = T.TransportPolicy("ragged", cap_rounding=4, integrity=True)
    assert T.resolve_transport(chk) is chk
    rng = np.random.default_rng(5)
    tree = _route_tree(rng)
    flags = rng.random((4, 4, 24)) < 0.3
    for pol in (chk, T.TransportPolicy("dense", integrity=True)):
        got, want = _ship_both(tree, flags, pol)
        _assert_ship_equal(got, want, flags)
        assert float(got[2].wire_faults) == float(got[2].degraded) == 0.0
        plain, _ = _ship_both(tree, flags, pol.replace(integrity=False))
        for k in tree:
            assert torch.equal(got[0][k], plain[0][k])
        # two attempts' words ride besides the payload only on a retry
        assert float(got[2].bytes_shipped) == float(plain[2].bytes_shipped) \
            + 4 * 4 * 4
    ex = LocalExchange(2)
    x = {"x": torch.arange(8.0).reshape(2, 4)}
    fl = torch.tensor([[True, False, True, True], [False, True, True, True]])
    r0, f0, i0 = T.allgather_ship(ex, x, fl)
    r1, f1, i1 = T.allgather_ship(ex, x, fl, integrity=True)
    assert torch.equal(r0["x"], r1["x"]) and torch.equal(f0, f1)
    assert float(i1.wire_faults) == 0.0
    assert float(i1.bytes_shipped) == float(i0.bytes_shipped) + 2 * 4


def test_adapt_policy_hysteresis_and_tiers():
    pol = T.TransportPolicy("auto", cap_rounding=32, enter_frac=0.3,
                            exit_frac=0.5)
    assert T.adapt_policy(pol, was_ragged=False, active_frac=0.4,
                          fwd_frac=0.1).kind == "dense"
    nxt = T.adapt_policy(pol, was_ragged=False, active_frac=0.2,
                         fwd_frac=0.21, back_frac=0.8)
    assert nxt.kind == "ragged" and nxt.cap is None
    assert nxt.capacity_frac == 0.25 and nxt.capacity_frac_back == 0.875
    assert T.capacity_for(nxt.replace(capacity_frac=nxt.capacity_frac_back),
                          256) is None
    assert T.capacity_for(nxt, 256) == 64
    assert T.adapt_policy(pol, was_ragged=True, active_frac=0.4,
                          fwd_frac=0.2).kind == "ragged"
    assert T.adapt_policy(pol, was_ragged=True, active_frac=0.6,
                          fwd_frac=0.2).kind == "dense"
    assert T.adapt_policy(T.RAGGED, was_ragged=False, active_frac=0.9,
                          fwd_frac=1.0) is T.RAGGED
    assert T.frac_tier(0.13) == 0.25 and T.frac_tier(0.0) == 0.0
    assert T.capacity_for(pol.replace(kind="ragged", capacity_frac=0.0),
                          256) == 32


def test_adapt_policy_oscillating_frontier_pins_tier():
    """An occupancy oscillating around a 1/8 tier boundary pins to the
    upper tier with `prev=` threaded (one capture, not two); growth still
    applies at once."""
    pol = T.TransportPolicy("auto", cap_rounding=8, enter_frac=0.95,
                            exit_frac=0.97)
    fracs = [0.26, 0.24] * 6
    naive = {T.adapt_policy(pol, was_ragged=True, active_frac=0.05,
                            fwd_frac=f).capacity_frac for f in fracs}
    assert naive == {0.25, 0.375}
    cur = T.adapt_policy(pol, was_ragged=False, active_frac=0.05,
                         fwd_frac=0.26)
    assert cur.kind == "ragged" and cur.capacity_frac == 0.375
    seen = {(cur.kind, cur.capacity_frac)}
    rcur = _ref_policy(cur)
    for f in fracs:
        cur = T.adapt_policy(pol, was_ragged=cur.kind == "ragged",
                             active_frac=0.05, fwd_frac=f, prev=cur)
        rcur = RT.adapt_policy(_ref_policy(pol),
                               was_ragged=rcur.kind == "ragged",
                               active_frac=0.05, fwd_frac=f, prev=rcur)
        assert _ref_policy(cur) == rcur
        seen.add((cur.kind, cur.capacity_frac))
    assert seen == {("ragged", 0.375)}, seen
    cur = T.adapt_policy(pol, was_ragged=True, active_frac=0.05,
                         fwd_frac=0.6, prev=cur)
    assert cur.capacity_frac == T.frac_tier(0.6)


if HAVE_HYPOTHESIS:
    _fracs = st.floats(0.0, 1.0, allow_nan=False)

    @settings(max_examples=60, deadline=None)
    @given(k=st.integers(0, 3000), p=st.integers(1, 8),
           cap=st.one_of(st.none(), st.integers(1, 3000)), frac=_fracs,
           rounding=st.sampled_from([1, 4, 8, 32]),
           tiers=st.one_of(st.none(), st.lists(_fracs, min_size=1,
                                                max_size=8)),
           count=st.integers(0, 5000))
    def test_hypothesis_capacity_functions_match_reference(
            k, p, cap, frac, rounding, tiers, count):
        pol = T.TransportPolicy("ragged", cap=cap, capacity_frac=frac,
                                cap_rounding=rounding,
                                capacity_fracs=(None if tiers is None
                                                else tuple(tiers)))
        rpol = _ref_policy(pol)
        c = T.capacity_for(pol, k)
        assert c == RT.capacity_for(rpol, k)
        cv, rcv = T.capacity_vec_for(pol, k, p, c), RT.capacity_vec_for(
            rpol, k, p, c)
        assert (cv is None) == (rcv is None)
        if cv is not None:
            np.testing.assert_array_equal(cv, rcv)
        assert T.round_capacity(pol, count) == RT.round_capacity(rpol, count)
        assert T.frac_tier(frac) == RT.frac_tier(frac)

    @settings(max_examples=80, deadline=None)
    @given(was=st.booleans(), active=_fracs,
           fwd=st.one_of(_fracs, st.lists(_fracs, min_size=4, max_size=4)),
           back=st.one_of(st.none(), _fracs,
                          st.lists(_fracs, min_size=4, max_size=4)),
           prev_fwd=st.one_of(st.none(), _fracs,
                              st.lists(_fracs, min_size=4, max_size=4)),
           headroom=st.sampled_from([1.0, 1.25, 2.0]))
    def test_hypothesis_adapt_policy_matches_reference(
            was, active, fwd, back, prev_fwd, headroom):
        """adapt_policy, its per-route hysteresis included: the same
        concrete policy from the same observations and previous plan."""
        pol = T.TransportPolicy("auto", cap_rounding=8, enter_frac=0.4,
                                exit_frac=0.6, tier_headroom=headroom)
        prev = None
        if prev_fwd is not None:
            vec = isinstance(prev_fwd, list)
            prev = pol.replace(
                kind="ragged",
                capacity_frac=max(prev_fwd) if vec else prev_fwd,
                capacity_fracs=tuple(prev_fwd) if vec else None)
        got = T.adapt_policy(pol, was_ragged=was, active_frac=active,
                             fwd_frac=fwd, back_frac=back, prev=prev)
        want = RT.adapt_policy(
            _ref_policy(pol), was_ragged=was, active_frac=active,
            fwd_frac=fwd, back_frac=back,
            prev=None if prev is None else _ref_policy(prev))
        assert _ref_policy(got) == want


    @settings(max_examples=25, deadline=None)
    @given(seed=st.integers(0, 2**31 - 1), density=st.floats(0.0, 1.0),
           cap=st.sampled_from([4, 8, 12, 16]))
    def test_hypothesis_roundtrip_matches_reference(seed, density, cap):
        """The reference's hypothesis round trip, held to the reference's
        answer: for any mask and capacity the port's receive buffers,
        flags and branch equal the reference's.  (A capacity past the
        break-even fraction of K ships dense in both, where the
        reference's own test expects ragged.)"""
        rng = np.random.default_rng(seed)
        tree = _route_tree(rng, nl=2, p=2, k=16)
        flags = rng.random((2, 2, 16)) < density
        pol = T.TransportPolicy("ragged", cap=cap, cap_rounding=4)
        got, want = _ship_both(tree, flags, pol, p=2)
        _assert_ship_equal(got, want, flags)
        fits = flags.sum(-1).max() <= cap
        clamped = T.capacity_for(pol, 16) is None
        assert float(got[2].ragged) == float(fits and not clamped)


# ---------------------------------------------------------------------------
# compact -> ship -> scatter round trips, byte for byte against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("density", [0.0, 0.1, 0.45, 1.0])
def test_roundtrip_matches_reference(density, codec):
    """Dense, ragged (cap 12 of K = 24: sparse masks ship ragged, full ones
    overflow to dense), tiered and pipelined ships: receive buffers, flags,
    branch, overflow, bytes and occupancy equal the reference's."""
    rng = np.random.default_rng(int(density * 100) + 7)
    tree = _route_tree(rng)
    flags = rng.random((4, 4, 24)) < density
    rag = T.TransportPolicy("ragged", capacity_frac=0.5, cap_rounding=4)
    pols = [T.DENSE, rag, rag.replace(pipeline=True),
            T.DENSE.replace(pipeline=True),
            rag.replace(capacity_fracs=(0.1, 0.3, 0.5, 0.2))]
    for pol in pols:
        got, want = _ship_both(tree, flags, pol, codec)
        _assert_ship_equal(got, want, flags)
    counts = flags.sum(-1)
    got, _ = _ship_both(tree, flags, rag, codec)
    assert float(got[2].ragged) == float(counts.max() <= 12)
    assert int(got[2].route_active_max) == counts.max()


def test_compact_is_the_stable_argsort_order():
    """_compact places each destination's active entries in ascending slot
    order, as the reference's stable argsort of ~flags does."""
    rng = np.random.default_rng(11)
    flags = rng.random((3, 4, 40)) < 0.3
    x = rng.normal(size=(3, 4, 40)).astype(np.float32)
    comp, sel, valid, counts = T._compact({"x": torch.from_numpy(x)},
                                          torch.from_numpy(flags), 16)
    rcomp, rsel, rvalid, rcounts = RT._compact({"x": jnp.asarray(x)},
                                               jnp.asarray(flags), 16)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(rvalid))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(rcounts))
    v = np.asarray(rvalid)
    np.testing.assert_array_equal(sel.numpy()[v], np.asarray(rsel)[v])
    np.testing.assert_array_equal(comp["x"].numpy(), np.asarray(rcomp["x"]))


def test_all_stale_and_all_active_edges():
    rng = np.random.default_rng(7)
    tree = _route_tree(rng)
    pol = T.TransportPolicy("ragged", cap=8, cap_rounding=4)
    flags = np.zeros((4, 4, 24), bool)
    got, want = _ship_both(tree, flags, pol)
    _assert_ship_equal(got, want, flags)
    assert float(got[2].ragged) == 1.0 and int(got[2].route_active_max) == 0
    flags = np.ones((4, 4, 24), bool)
    got, want = _ship_both(tree, flags, pol)
    _assert_ship_equal(got, want, flags)
    assert float(got[2].ragged) == 0.0 and float(got[2].overflow) == 1.0


def test_overflow_fallback_switches_both_directions():
    """One policy flips ragged -> dense -> ragged on the mask alone."""
    rng = np.random.default_rng(3)
    tree = _route_tree(rng)
    pol = T.TransportPolicy("ragged", cap=8, cap_rounding=4)
    sparse = np.zeros((4, 4, 24), bool)
    sparse[:, :, :5] = True
    full = np.ones((4, 4, 24), bool)
    for flags, expect in ((sparse, 1.0), (full, 0.0), (sparse, 1.0)):
        got, want = _ship_both(tree, flags, pol)
        _assert_ship_equal(got, want, flags)
        assert float(got[2].ragged) == expect
        assert float(got[2].overflow) == 1.0 - expect


def test_prefer_ragged_gate():
    rng = np.random.default_rng(4)
    tree = _route_tree(rng)
    flags = np.zeros((4, 4, 24), bool)
    flags[:, :, :3] = True
    pol = T.TransportPolicy("auto", cap=8, cap_rounding=4)
    for prefer in (False, True):
        got, want = _ship_both(tree, flags, pol, prefer=prefer)
        _assert_ship_equal(got, want, flags)
        assert float(got[2].ragged) == float(prefer)


def test_ragged_composes_with_codec():
    """Packed ints under a bound stay exact through the ragged ship and
    decode back to int32; a scaled codec's compacted blocks equal the
    reference's."""
    rng = np.random.default_rng(5)
    pol = T.TransportPolicy("ragged", cap=12, cap_rounding=4)
    flags = rng.random((4, 4, 24)) < 0.2
    ids = rng.integers(0, 100, (4, 4, 24)).astype(np.int32)
    ex8 = with_wire(LocalExchange(4), "int8")
    recv, _, info = T.ship_transport(ex8, {"i": torch.from_numpy(ids)},
                                     torch.from_numpy(flags), bound=100,
                                     policy=pol)
    assert float(info.ragged) == 1.0 and recv["i"].dtype == torch.int32
    want = np.where(np.swapaxes(flags, 0, 1), np.swapaxes(ids, 0, 1), 0)
    np.testing.assert_array_equal(recv["i"].numpy(), want)


def test_exchange_tree_ship_transport_argument():
    rng = np.random.default_rng(6)
    ex = LocalExchange(4)
    x = rng.normal(size=(4, 4, 24)).astype(np.float32)
    flags = np.zeros((4, 4, 24), bool)
    flags[:, :, ::5] = True
    pol = T.TransportPolicy("ragged", cap=8, cap_rounding=4)
    got = ex.tree_ship({"x": torch.from_numpy(x)},
                       active=torch.from_numpy(flags), transport=pol)["x"]
    want = np.where(np.swapaxes(flags, 0, 1), np.swapaxes(x, 0, 1), 0)
    np.testing.assert_array_equal(got.numpy(), want)
    one = ex.ship(torch.from_numpy(x), active=torch.from_numpy(flags),
                  transport=pol)
    np.testing.assert_array_equal(one.numpy(), want)


def test_ragged_wire_bytes_formula():
    nl = p = 2
    k, cap = 64, 16
    tree = {"x": torch.zeros((nl, p, k))}
    rtree = {"x": jnp.zeros((nl, p, k), jnp.float32)}
    got = T.ragged_wire_bytes(tree, None, None, cap)
    assert got == nl * p * (cap * 4 + cap * 1 + 4)
    assert got == RT.ragged_wire_bytes(rtree, None, None, cap)
    c8, rc8 = W.make_codec("int8"), RW.make_codec("int8")
    got8 = T.ragged_wire_bytes(tree, c8, None, cap)
    assert got8 == nl * p * (cap * 1 + 1 + cap * 1 + 4)
    assert got8 == RT.ragged_wire_bytes(rtree, rc8, None, cap)
    capvec = np.array([8, 16], np.int32)
    assert T.ragged_wire_bytes(tree, c8, None, cap, capvec) == \
        RT.ragged_wire_bytes(rtree, rc8, None, cap, capvec)


def test_shipped_bytes_drop_with_the_active_count():
    nl = p = 4
    k = 256
    rng = np.random.default_rng(8)
    tree = {"x": rng.normal(size=(nl, p, k)).astype(np.float32)}
    shipped = []
    for c in (96, 48, 32, 16):
        flags = np.zeros((nl, p, k), bool)
        flags[:, :, :c] = True
        pol = T.TransportPolicy("ragged",
                                cap=T.round_capacity(T.RAGGED, c))
        got, want = _ship_both(tree, flags, pol, "f32_delta")
        _assert_ship_equal(got, want, flags)
        assert float(got[2].ragged) == 1.0
        shipped.append(float(got[2].bytes_shipped))
    assert shipped == sorted(shipped, reverse=True)


# ---------------------------------------------------------------------------
# The ring transpose
# ---------------------------------------------------------------------------
def test_ring_transpose_matches_transpose_local():
    ex = LocalExchange(p=4)
    rng = np.random.default_rng(0)
    for shape in ((4, 4), (4, 4, 3), (4, 4, 2, 5)):
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        assert torch.equal(ex.ring_transpose(x), ex.transpose(x))
    for dt in (torch.bool, torch.int8, torch.bfloat16):
        x = torch.from_numpy(rng.random((4, 4, 6)) < 0.5).to(dt)
        assert torch.equal(ex.ring_transpose(x), ex.transpose(x))
    x = torch.arange(8, dtype=torch.int32).reshape(4, 2)
    assert torch.equal(ex.ppermute(x, 1), torch.roll(x, 1, 0))
    y = x
    for _ in range(4):
        y = ex.ppermute(y, 1)
    assert torch.equal(y, x)
    assert torch.equal(
        ex.all_gather_rows(x),
        torch.from_numpy(np.array(RefLocalExchange(4).all_gather_rows(
            jnp.asarray(x.numpy())))))


# ---------------------------------------------------------------------------
# End to end, against the dense runs and the reference
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def pr_runs():
    """Delta PageRank rmat(9, 6) over the f32 delta wire, dense and under
    fig4's auto policy, in the port and the reference (run once)."""
    gd = rmat(9, 6, seed=0)
    g = Graph.from_edges(gd.src, gd.dst, num_partitions=4, device="cpu")
    rg = RefGraph.from_edges(gd.src, gd.dst, num_partitions=4)
    g = g.replace(ex=with_wire(g.ex, "f32", delta=True))
    rg = rg.replace(ex=ref_with_wire(rg.ex, "f32", delta=True))
    kw = dict(num_iters=40, tol=1e-3, track_metrics=True)
    return {
        "dense": alg.pagerank(g, **kw),
        "auto": alg.pagerank(g, transport=T.TransportPolicy("auto", **FIG4),
                             **kw),
        "ref": ref_alg.pagerank(
            rg, transport=RT.TransportPolicy("auto", **FIG4), **kw)}


def test_delta_pagerank_auto_is_bit_exact(pr_runs):
    d, a, r = pr_runs["dense"], pr_runs["auto"], pr_runs["ref"]
    assert d.supersteps == a.supersteps == r.supersteps
    assert torch.equal(d.graph.vdata["pr"], a.graph.vdata["pr"])
    np.testing.assert_array_equal(a.graph.vdata["pr"].numpy(),
                                  np.asarray(r.graph.vdata["pr"]))
    for f in ("ships", "bytes_accounted"):
        assert float(getattr(d.graph, f)) == float(getattr(a.graph, f))
    ragged = [m for m in a.metrics if m["transport"] == "ragged"]
    assert ragged, "auto plan never went ragged"
    dense_max = max(m["bytes_shipped"] for m in a.metrics
                    if m["transport"] == "dense")
    assert ragged[-1]["bytes_shipped"] < dense_max


TRANSPORT_RECORD = ("transport", "transport_cap", "transport_frac", "ragged",
                    "bytes_shipped", "bytes_on_wire", "overflow_fallbacks",
                    "recompiles", "transport_state", "wire_faults",
                    "degraded_routes", "live_edges", "pipeline_ships",
                    "pipeline_bytes_shipped", "bytes_link_modeled")


def test_per_superstep_transport_records_match_reference(pr_runs):
    """fig4's policy and workload: each superstep's transport decision,
    capacity, bytes shipped and accounted, fallbacks and recompiles equal
    the reference's, and each ship's route occupancy too."""
    a, r = pr_runs["auto"], pr_runs["ref"]
    assert len(a.metrics) == len(r.metrics)
    for i, (m, rm) in enumerate(zip(a.metrics, r.metrics)):
        for k in TRANSPORT_RECORD:
            want = rm[k] if isinstance(rm[k], str) else float(rm[k])
            assert m[k] == want, (i, k, m[k], want)
        for side in ("fwd", "back"):
            rs = rm[side]
            for f in ("ragged", "overflow", "route_active_max",
                      "bytes_shipped", "bytes_accounted"):
                assert m[side][f] == float(getattr(rs, f)), (i, side, f)
            np.testing.assert_array_equal(
                np.asarray(m[side]["route_active_frac"], np.float32),
                np.asarray(rs.route_active_frac, np.float32))
    assert a.metrics[-1]["recompiles"] > 1


@pytest.fixture(scope="module")
def cc_graphs():
    gd = symmetrize(rmat(8, 4, seed=2))
    g = Graph.from_edges(gd.src, gd.dst, num_partitions=4, device="cpu")
    rg = RefGraph.from_edges(gd.src, gd.dst, num_partitions=4)
    return gd, g, rg


@pytest.mark.parametrize("wire", [None, "int8"])
def test_cc_ragged_transport_bit_exact(cc_graphs, wire):
    """CC through the ragged transport with a capacity its early
    supersteps overflow: labels equal the dense run, the reference's and
    union-find; the fallback shows both ways; records equal the
    reference's."""
    gd, g, rg = cc_graphs
    if wire is not None:
        g = g.replace(ex=with_wire(g.ex, wire, delta=True))
        rg = rg.replace(ex=ref_with_wire(rg.ex, wire, delta=True))
    pol = T.TransportPolicy("ragged", capacity_frac=0.25, cap_rounding=4)
    r0 = alg.connected_components(g)
    r = alg.connected_components(g, transport=pol, track_metrics=True)
    rr = ref_alg.connected_components(rg, transport=_ref_policy(pol),
                                      track_metrics=True)
    assert torch.equal(r0.graph.vdata["cc"], r.graph.vdata["cc"])
    np.testing.assert_array_equal(r.graph.vdata["cc"].numpy(),
                                  np.asarray(rr.graph.vdata["cc"]))
    mask = g.vmask.numpy()
    vids = g.s.home_vid.numpy()[mask]
    want = alg.connected_components_reference(gd.src, gd.dst, vids)
    assert dict(zip(vids.tolist(),
                    r.graph.vdata["cc"].numpy()[mask].tolist())) == want
    over = [m["overflow_fallbacks"] for m in r.metrics]
    rag = [m["ragged"] for m in r.metrics]
    assert any(over) and rag[-1] == 1.0
    first = next(i for i, o in enumerate(over) if o)
    assert any(rag[first + 1:])
    for m, rm in zip(r.metrics, rr.metrics):
        for k in ("ragged", "overflow_fallbacks", "bytes_shipped",
                  "bytes_on_wire", "recompiles"):
            assert m[k] == float(rm[k]), k


def test_mr_triplets_forced_ragged_overflow_falls_back_dense():
    gd = rmat(6, 4, seed=1)
    g = Graph.from_edges(gd.src, gd.dst, num_partitions=4, device="cpu")
    g = g.mapV(lambda vid, v: {"x": torch.tensor(1.0)})
    rg = RefGraph.from_edges(gd.src, gd.dst, num_partitions=4).mapV(
        lambda vid, v: {"x": jnp.float32(1.0)})

    def send(sv, ev, dv):
        return {"m": sv["x"]}
    pol = T.TransportPolicy("ragged", cap=4, cap_rounding=4)
    want, we, _, _ = mr_triplets(g, send, "sum", kernel_mode="unfused")
    got, ge, _, m = mr_triplets(g, send, "sum", kernel_mode="unfused",
                                transport=pol)
    rgot, rge, _, rm = ref_mr_triplets(rg, send, "sum",
                                       kernel_mode="unfused",
                                       transport=_ref_policy(pol))
    assert torch.equal(got["m"], want["m"]) and torch.equal(ge, we)
    np.testing.assert_array_equal(got["m"].numpy(), np.asarray(rgot["m"]))
    assert float(m["ragged"]) == float(rm["ragged"])


def test_legacy_cache_override_matches_reference(cc_graphs):
    """mr_triplets(cache=view) with g.active as the changed rows, the
    reference's legacy loop contract, under the ragged transport."""
    _, g, rg = cc_graphs
    g = g.mapV(lambda vid, v: {"cc": vid})
    rg = rg.mapV(lambda vid, v: {"cc": vid})

    def send(sv, ev, dv):
        return {"m": sv["cc"]}
    pol = T.TransportPolicy("ragged", capacity_frac=0.5, cap_rounding=4)
    _, _, view, _ = mr_triplets(g, send, "min")
    _, _, rview, _ = ref_mr_triplets(rg, send, "min")
    act = (g.s.home_vid % 5 == 0) & g.vmask
    g2 = g.replace(vdata={"cc": torch.where(act, g.vdata["cc"] // 2,
                                            g.vdata["cc"])}, active=act)
    ract = jnp.asarray(act.numpy())
    rg2 = rg.replace(vdata={"cc": jnp.where(ract, rg.vdata["cc"] // 2,
                                            rg.vdata["cc"])}, active=ract)
    v, e, nview, m = mr_triplets(g2, send, "min", cache=view, transport=pol)
    rv, re_, rnview, rm = ref_mr_triplets(rg2, send, "min", cache=rview,
                                          transport=_ref_policy(pol))
    np.testing.assert_array_equal(v["m"].numpy(), np.asarray(rv["m"]))
    np.testing.assert_array_equal(e.numpy(), np.asarray(re_))
    np.testing.assert_array_equal(nview.active.numpy(),
                                  np.asarray(rnview.active))
    assert nview.dirs == rnview.dirs
    for f in ("n_shipped", "bytes_shipped", "ragged"):
        assert float(getattr(m["fwd"], f)) == float(getattr(rm["fwd"], f))


# ---------------------------------------------------------------------------
# The pipelined and adaptive drivers
# ---------------------------------------------------------------------------
def _cc_run(g, **kw):
    return pm.pregel(g.mapV(alg._cc_init), alg.cc_vprog, alg.cc_send, "min",
                     default_msg={"m": torch.tensor(alg.IMAX,
                                                    dtype=torch.int32)},
                     skip_stale="out", track_metrics=True, **kw)


@pytest.mark.parametrize("wire", ["f32", "int8"])
@pytest.mark.parametrize("fuse", ["auto", "unfused"])
@pytest.mark.parametrize("kind", ["dense", "ragged"])
def test_pipelined_pregel_bit_exact_matrix(cc_graphs, wire, fuse, kind):
    """fused / unfused apply x dense / ragged x f32 / int8: pipelined ==
    serialized bit for bit, with the same superstep count and bytes."""
    _, g, _ = cc_graphs
    if wire == "int8":
        g = g.replace(ex=with_wire(g.ex, "int8", delta=True))
    tp0 = (T.DENSE if kind == "dense" else
           T.TransportPolicy("ragged", capacity_frac=0.5, cap_rounding=8))
    r_ser = _cc_run(g, fuse_apply=fuse, transport=tp0)
    r_pipe = _cc_run(g, fuse_apply=fuse, transport=tp0.replace(pipeline=True))
    assert torch.equal(r_pipe.graph.vdata["cc"], r_ser.graph.vdata["cc"])
    assert r_pipe.supersteps == r_ser.supersteps
    assert [m["bytes_shipped"] for m in r_pipe.metrics] == \
        [m["bytes_shipped"] for m in r_ser.metrics]


def test_warm_view_reentry_pipelined(cc_graphs):
    """Leave a loop with the view riding the graph and continue under the
    pipelined schedule: the delta ships equal the serialized ones."""
    _, g, _ = cc_graphs
    g = g.mapV(alg._cc_init)
    res = {}
    for pipe in (False, True):
        step = pm._step_fn(
            g, alg.cc_vprog, alg.cc_send, "min",
            default_msg={"m": torch.tensor(alg.IMAX, dtype=torch.int32)},
            skip_stale="out", changed_fn=None, kernel_mode="auto",
            incremental=True, payload_bound=None, fuse_apply="auto",
            transport=T.DENSE.replace(pipeline=pipe))
        out = g
        for i in range(8):
            out, _, _ = step(out)
            if i == 2:
                assert out.view is not None      # exits warm
        res[pipe] = out.vdata["cc"]
    assert torch.equal(res[True], res[False])


def test_pregel_recompiles_metric(cc_graphs):
    """`recompiles` counts distinct policies; a dense run is one."""
    _, g, _ = cc_graphs
    auto = T.TransportPolicy("auto", cap_rounding=8, enter_frac=0.9,
                             exit_frac=0.95)
    r_d = _cc_run(g, transport=T.DENSE)
    assert r_d.metrics[-1]["recompiles"] == 1
    r_a = _cc_run(g, transport=auto)
    kinds = {m["transport"] for m in r_a.metrics}
    assert "ragged" in kinds, kinds
    assert 2 <= r_a.metrics[-1]["recompiles"] <= len(r_a.metrics)
    assert r_a.metrics[-1]["captures"] == 0        # nothing captures here
    assert torch.equal(r_a.graph.vdata["cc"], r_d.graph.vdata["cc"])


@pytest.mark.parametrize("policy", ["auto", "ragged", "pipeline"])
def test_pregel_fused_transport_equals_pregel(cc_graphs, policy):
    """pregel_fused under a transport: the auto decision rides the carry;
    state, superstep count and wire log equal the host loop's dense run
    and the reference's pregel_fused."""
    from repro.core.pregel import pregel_fused as ref_pregel_fused
    _, g, rg = cc_graphs
    tp = {"auto": T.TransportPolicy("auto", cap_rounding=8, enter_frac=0.9,
                                    exit_frac=0.95),
          "ragged": T.TransportPolicy("ragged", capacity_frac=0.25,
                                      cap_rounding=4),
          "pipeline": T.DENSE.replace(pipeline=True)}[policy]
    dmsg = {"m": torch.tensor(alg.IMAX, dtype=torch.int32)}
    gf, steps = pm.pregel_fused(g.mapV(alg._cc_init), alg.cc_vprog,
                                alg.cc_send, "min", default_msg=dmsg,
                                transport=tp)
    want = pm.pregel(g.mapV(alg._cc_init), alg.cc_vprog, alg.cc_send, "min",
                     default_msg=dmsg)
    assert int(steps) == want.supersteps
    assert torch.equal(gf.vdata["cc"], want.graph.vdata["cc"])
    rgf, rsteps = ref_pregel_fused(
        rg.mapV(lambda vid, v: {"cc": vid}), ref_alg.cc_vprog
        if hasattr(ref_alg, "cc_vprog") else (
            lambda vid, v, m: {"cc": jnp.minimum(v["cc"], m["m"])}),
        lambda sv, ev, dv: {"m": sv["cc"]}, "min",
        default_msg={"m": jnp.int32(alg.IMAX)}, transport=_ref_policy(tp))
    assert int(steps) == int(rsteps)
    np.testing.assert_array_equal(gf.vdata["cc"].numpy(),
                                  np.asarray(rgf.vdata["cc"]))
    assert float(gf.bytes_shipped) == float(rgf.bytes_shipped)

"""The port's integrity ladder and fault injector (`repro_torch.core.fault`,
`wire.integrity_word`, `transport.ship_transport(integrity=...)`) against
the JAX reference's.

The integrity word equals the reference's bit for bit on random buffers of
every wire dtype (hypothesis); a fold without its position coefficients
and a word without its destination salt each miss a fault the real word
catches.  Every fault mode on the dense and ragged transports, transient
and persistent, and plans that pick calls (`calls=(0, 2)`) or cap the
events (`max_events=1`): the port's PageRank equals its fault-free run bit
for bit and the reference's within 1e-5 relative (f32 sums in another
order), each superstep's `wire_faults` / `degraded_routes`, both routes'
`bytes_shipped` and the injector's counters equal the reference's for the
same plan (the port
brackets each superstep with the program the reference would trace).  The
negative control (no integrity, always corrupt) differs from the clean
run and equals the reference's.  The broadcast lane's checked ships run
CC on a hybrid build, equal to the unchecked run and the reference.
Reference runs are cached per module.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.core import Graph as RefGraph  # noqa: E402
from repro.core import TransportPolicy as RefPolicy  # noqa: E402
from repro.core import algorithms as ref_alg  # noqa: E402
from repro.core import wire as RW  # noqa: E402
from repro.core.exchange import LocalExchange as RefLocalExchange  # noqa: E402
from repro.core.fault import FaultPlan as RefPlan  # noqa: E402
from repro.core.fault import FaultyExchange as RefFaulty  # noqa: E402
from repro.core.pregel import pregel as ref_pregel  # noqa: E402
from repro.data import rmat, symmetrize  # noqa: E402
from repro_torch.core import Graph  # noqa: E402
from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.core import wire as W  # noqa: E402
from repro_torch.core.exchange import LocalExchange  # noqa: E402
from repro_torch.core.fault import MODES, FaultPlan, FaultyExchange  # noqa: E402
from repro_torch.core.pregel import pregel  # noqa: E402
from repro_torch.core.transport import TransportPolicy  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:          # dev-only dependency (requirements-dev.txt)
    HAVE_HYPOTHESIS = False

P = 4
STEPS = 3
PR_RTOL = 1e-5
DENSE_CHK = dict(kind="dense", integrity=True)
RAGGED_CHK = dict(kind="ragged", capacity_frac=0.5, cap_rounding=4,
                  integrity=True)
POLICIES = {"dense": DENSE_CHK, "ragged": RAGGED_CHK}


def _edges(n=48, m=240, seed=3):
    rng = np.random.RandomState(seed)
    return rng.randint(0, n, m), rng.randint(0, n, m)


# --- PageRank on both sides, over an injector or none ----------------------
def _port_pr(plan=None, policy=None, n=STEPS):
    src, dst = _edges()
    g = Graph.from_edges(src, dst, num_partitions=P, device="cpu")
    g = alg.attach_out_degree(g).mapV(
        lambda vid, v: {**v, "pr": torch.tensor(1.0)})
    fx = None
    if plan is not None:
        # the injector joins after the graph is built, its counters at 0
        fx = FaultyExchange(LocalExchange(p=P), FaultPlan(**plan))
        g = g.replace(ex=fx)
    tp = None if policy is None else TransportPolicy(**policy)
    r = pregel(g, alg.pagerank_vprog(0.15), alg.pagerank_send, "sum",
               default_msg={"m": torch.tensor(0.0)}, skip_stale=None,
               max_supersteps=n, transport=tp, track_metrics=True)
    return r, fx


def _ref_pr(plan=None, policy=None, n=STEPS):
    src, dst = _edges()
    g = RefGraph.from_edges(src, dst, num_partitions=P)
    g = ref_alg.attach_out_degree(g).mapV(
        lambda vid, v: {**v, "pr": jnp.float32(1.0)})
    fx = None
    if plan is not None:
        fx = RefFaulty(RefLocalExchange(p=P), RefPlan(**plan))
        g = dataclasses.replace(g, ex=fx)
    tp = None if policy is None else RefPolicy(**policy)
    r = ref_pregel(
        g, lambda vid, v, m: {**v, "pr": 0.15 + 0.85 * m["m"]},
        lambda sv, ev, dv: {"m": sv["pr"] / sv["deg"] * ev["w"]}, "sum",
        default_msg={"m": jnp.float32(0.0)}, skip_stale=None,
        max_supersteps=n, transport=tp, track_metrics=True)
    return r, fx


_REF: dict = {}


def _ref_cached(plan, policy):
    key = (repr(plan), repr(policy))
    if key not in _REF:
        r, fx = _ref_pr(plan, policy)
        _REF[key] = (np.asarray(r.graph.vdata["pr"]),
                     [(m["wire_faults"], m["degraded_routes"],
                       float(m["fwd"].bytes_shipped),
                       float(m["back"].bytes_shipped)) for m in r.metrics],
                     None if fx is None else (fx.events, fx._calls))
    return _REF[key]


def _counters(r):
    """Each superstep's faults, degraded routes and both routes' bytes
    (the retries' and the raw degrade's included)."""
    return [(m["wire_faults"], m["degraded_routes"],
             float(m["fwd"]["bytes_shipped"]),
             float(m["back"]["bytes_shipped"])) for m in r.metrics]


def _check_against_reference(plan, policy):
    """The port's run under `plan` against the reference's: values,
    per-superstep counters, the injector's events and calls."""
    r, fx = _port_pr(plan, policy)
    want, counters, fx_counts = _ref_cached(plan, policy)
    got = r.graph.vdata["pr"].numpy()
    np.testing.assert_allclose(got, want, rtol=PR_RTOL)
    assert _counters(r) == counters
    assert (fx.events, fx._calls) == fx_counts
    return r


@pytest.fixture(scope="module")
def clean():
    """The port's fault-free run under each checked policy."""
    return {name: _port_pr(None, pol)[0].graph.vdata["pr"]
            for name, pol in POLICIES.items()}


# ---------------------------------------------------------------------------
# Integrity words
# ---------------------------------------------------------------------------
_DTYPES = ["float32", "bfloat16", "float8_e4m3fn", "int8", "int16",
           "int64", "bool"]


def _leaf_pair(rng, dtype: str, shape):
    """(torch leaf, jnp leaf) with the same bits."""
    if dtype == "bool":
        a = rng.random(shape) < 0.5
        return torch.from_numpy(a), jnp.asarray(a)
    if dtype in ("int8", "int16", "int64"):
        info = np.iinfo(dtype)
        a = rng.integers(info.min, info.max, size=shape, dtype=dtype,
                         endpoint=True)
        return torch.from_numpy(a), jnp.asarray(a)
    ibits = {"float32": np.int32, "bfloat16": np.int16,
             "float8_e4m3fn": np.int8}[dtype]
    info = np.iinfo(ibits)
    bits = rng.integers(info.min, info.max, size=shape, dtype=ibits,
                        endpoint=True)
    t = torch.from_numpy(bits).view(getattr(torch, dtype))
    j = jax.lax.bitcast_convert_type(jnp.asarray(bits), getattr(jnp, dtype))
    return t, j


def _words_equal(seed: int, dtype: str, k: int, tail: int):
    rng = np.random.default_rng(seed)
    shape = (P, P, k) + ((tail,) if tail > 1 else ())
    with jax.enable_x64(dtype == "int64"):
        t, j = _leaf_pair(rng, dtype, shape)
        t2, j2 = _leaf_pair(rng, "float32", (P, P, k))
        flags = rng.random((P, P, k)) < 0.6
        dest = rng.integers(0, P, (P, P), dtype=np.int32)
        src = rng.integers(0, P, (P, P), dtype=np.int32)
        got = W.integrity_word({"x": t, "y": t2}, torch.from_numpy(flags),
                               torch.from_numpy(dest), torch.from_numpy(src))
        want = RW.integrity_word({"x": j, "y": j2}, jnp.asarray(flags),
                                 jnp.asarray(dest), jnp.asarray(src))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32


@pytest.mark.parametrize("dtype", _DTYPES)
def test_integrity_word_equals_reference(dtype):
    _words_equal(0, dtype, 40, 3 if dtype == "float32" else 1)


if HAVE_HYPOTHESIS:
    @settings(max_examples=15, deadline=None)
    @given(seed=st.integers(0, 2 ** 31 - 1), dtype=st.sampled_from(_DTYPES),
           k=st.integers(1, 70), tail=st.integers(1, 3))
    def test_integrity_word_hypothesis(seed, dtype, k, tail):
        _words_equal(seed, dtype, k, tail)


def test_word_constants_and_verifiable_match_reference():
    assert W._GOLD == int(RW._GOLD) and W._GOLD2 == int(RW._GOLD2)
    for name in (None, "f32", "bf16", "int8", "fp8_e4m3"):
        codec = None if name is None else W.make_codec(name)
        rcodec = None if name is None else RW.make_codec(name)
        assert W.verifiable(codec) == RW.verifiable(rcodec)


def test_fold_mutants_miss_what_the_word_catches(monkeypatch):
    """Two faults the word must catch: two entries of a route swapped
    (caught by the position coefficients) and a block delivered to the
    wrong destination with its own flags and payload (caught by the
    destination salt).  A mutant without either misses its fault."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(P, P, 16)).astype(np.float32))
    flags = torch.ones((P, P, 16), dtype=torch.bool)
    cols = torch.arange(P, dtype=torch.int32).expand(P, P)
    rows = torch.arange(P, dtype=torch.int32)[:, None].expand(P, P)
    swapped = x.clone()
    swapped[0, 1, [3, 7]] = x[0, 1, [7, 3]]
    wrong = cols.clone()
    wrong[0, 1] = 2          # block (0, 1) claims destination 2

    def caught(word):
        return (not torch.equal(word({"x": x}, flags, cols, rows),
                                word({"x": swapped}, flags, cols, rows)),
                not torch.equal(word({"x": x}, flags, cols, rows),
                                word({"x": x}, flags, wrong, rows)))

    assert caught(W.integrity_word) == (True, True)
    with monkeypatch.context() as m:
        m.setattr(W, "_weighted_fold", lambda w: W._wrap32(
            w.to(torch.int64).sum(-1)))
        assert caught(W.integrity_word) == (False, True)
    with monkeypatch.context() as m:
        m.setattr(W, "_GOLD", 0)
        assert caught(W.integrity_word) == (True, False)


# ---------------------------------------------------------------------------
# The chaos matrix
# ---------------------------------------------------------------------------
_ROUTES = {"corrupt": None, "zero": (2, 1), "drop": (1, 0), "misroute": None}


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("attempts", [(0,), (0, 1)],
                         ids=["transient", "persistent"])
def test_chaos_matrix_matches_reference(clean, policy, mode, attempts):
    plan = dict(mode=mode, route=_ROUTES[mode], attempts=attempts)
    r = _check_against_reference(plan, POLICIES[policy])
    assert torch.equal(r.graph.vdata["pr"], clean[policy])
    faults = sum(m["wire_faults"] for m in r.metrics)
    degraded = sum(m["degraded_routes"] for m in r.metrics)
    assert faults > 0
    assert (degraded > 0) == (attempts == (0, 1))
    assert faults >= degraded


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("plan", [
    dict(mode="corrupt", attempts=(0,), calls=(0, 2)),
    dict(mode="corrupt", attempts=(0, 1), max_events=1)],
    ids=["calls-0-2", "max-events-1"])
def test_call_counting_matches_reference(clean, policy, plan):
    """Plans that pick collectives by index or cap the events hit the same
    collectives as the reference's trace-time counter (superstep 1 is one
    program, the later ones replay the second): the same counters a
    superstep, whether or not a hit lands on a rung the device keeps."""
    r, fx = _port_pr(plan, POLICIES[policy])
    assert fx.events > 0
    _check_against_reference(plan, POLICIES[policy])
    assert torch.equal(r.graph.vdata["pr"], clean[policy])


def test_negative_control_differs():
    """No integrity word, every collective corrupt: the values differ from
    the clean run (the matrix above sees real faults) and equal the
    reference's under the same plan."""
    plan = dict(mode="corrupt", attempts=None)
    base, _ = _port_pr(None, None)
    r, fx = _port_pr(plan, None)
    assert fx.events > 0
    assert not torch.equal(r.graph.vdata["pr"], base.graph.vdata["pr"])
    want, counters, fx_counts = _ref_cached(plan, None)
    np.testing.assert_allclose(r.graph.vdata["pr"].numpy(), want,
                               rtol=PR_RTOL)
    assert _counters(r) == counters
    assert (fx.events, fx._calls) == fx_counts


def test_injector_passes_through_what_it_does_not_target():
    fx = FaultyExchange(LocalExchange(p=P), FaultPlan(attempts=()))
    x = torch.arange(P * P * 3, dtype=torch.float32).reshape(P, P, 3)
    assert torch.equal(fx.transpose(x), x.transpose(0, 1))
    assert torch.equal(fx.ring_transpose(x), x.transpose(0, 1))
    assert torch.equal(fx.psum(x), x)
    assert fx.events == 0 and fx._calls == 2
    with pytest.raises(NotImplementedError):
        fx.all_gather_rows(x[:, 0])
    with pytest.raises(ValueError, match="unknown fault mode"):
        FaultyExchange(LocalExchange(p=P), FaultPlan(mode="melt"))
    fx.reset()
    assert fx._calls == 0 and fx.events == 0


def test_pregel_fused_chaos_matches_pregel():
    """pregel_fused under a checked ragged policy and a transient fault
    equals the port's clean pregel_fused bit for bit."""
    from repro_torch.core import pregel_fused
    src, dst = _edges(seed=11)
    src, dst = np.r_[src, dst], np.r_[dst, src]

    def run(plan):
        g = Graph.from_edges(src, dst, num_partitions=P, device="cpu")
        g = g.mapV(alg._cc_init)
        if plan is not None:
            g = g.replace(ex=FaultyExchange(LocalExchange(p=P), plan))
        return pregel_fused(
            g, alg.cc_vprog, alg.cc_send, "min",
            default_msg={"m": torch.tensor(alg.IMAX, dtype=torch.int32)},
            transport=TransportPolicy(**RAGGED_CHK)), g.ex

    (want, n), _ = run(None)
    (got, m), fx = run(FaultPlan(mode="corrupt", attempts=(0,)))
    assert fx.events > 0 and int(m) == int(n)
    assert torch.equal(got.vdata["cc"], want.vdata["cc"])


# ---------------------------------------------------------------------------
# The broadcast lane's checked ship
# ---------------------------------------------------------------------------
def test_broadcast_lane_with_integrity_matches_reference():
    gd = symmetrize(rmat(8, 8, seed=2))
    g = Graph.from_edges(gd.src, gd.dst, num_partitions=P,
                         partitioner="hybrid", bcast_min_repl=3,
                         device="cpu")
    rg = RefGraph.from_edges(gd.src, gd.dst, num_partitions=P,
                             partitioner="hybrid", bcast_min_repl=3)
    assert g.s.has_bcast
    chk = TransportPolicy(**DENSE_CHK)
    r = alg.connected_components(g, transport=chk, track_metrics=True)
    r0 = alg.connected_components(g, track_metrics=True)
    rr = ref_alg.connected_components(rg, transport=RefPolicy(**DENSE_CHK),
                                      track_metrics=True)
    assert torch.equal(r.graph.vdata["cc"], r0.graph.vdata["cc"])
    np.testing.assert_array_equal(r.graph.vdata["cc"].numpy(),
                                  np.asarray(rr.graph.vdata["cc"]))
    assert r.supersteps == rr.supersteps
    for i, (m, m0, rm) in enumerate(zip(r.metrics, r0.metrics, rr.metrics)):
        assert m["wire_faults"] == m["degraded_routes"] == 0.0
        assert m["fwd"]["bytes_shipped"] == float(rm["fwd"].bytes_shipped)
        if i:
            # superstep 1's cold full ship plans dense, unchecked; later
            # the words ride along: P x P routed, P broadcast (4 B each)
            assert m["fwd"]["bytes_shipped"] == \
                m0["fwd"]["bytes_shipped"] + 4 * (P * P + P)

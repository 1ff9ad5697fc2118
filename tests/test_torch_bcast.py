"""The broadcast lane of the PyTorch port against the JAX reference.

`allgather_ship` gives the reference's receive buffers, flags and bytes
under the f32, int8, fp8 and delta codecs, through one packed uint8
buffer.  On a hybrid build with a broadcast set (`bcast_min_repl`), CC and
PageRank under the dense, ragged and tiered transports equal the same
structure with the broadcast tables cleared (placement changes bytes,
never values) and the reference's runs, per-superstep bytes included.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.core import Graph as RefGraph  # noqa: E402
from repro.core import LocalExchange as RefLocalExchange  # noqa: E402
from repro.core import algorithms as ref_alg  # noqa: E402
from repro.core import transport as RT  # noqa: E402
from repro.core import with_wire as ref_with_wire  # noqa: E402
from repro.data import rmat, symmetrize  # noqa: E402
from repro_torch.core import Graph, with_wire  # noqa: E402
from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.core import transport as T  # noqa: E402
from repro_torch.core.exchange import LocalExchange  # noqa: E402

P = 4
TIERED = T.TransportPolicy(kind="ragged", capacity_frac=1.0,
                           capacity_frac_back=1.0,
                           capacity_fracs=(0.5,) * P,
                           capacity_fracs_back=(0.5,) * P)
POLICIES = {"dense": T.DENSE,
            "ragged": T.TransportPolicy("ragged", capacity_frac=0.25,
                                        cap_rounding=4),
            "tiered": TIERED,
            "auto": T.TransportPolicy("auto", cap_rounding=8, enter_frac=0.9,
                                      exit_frac=0.95)}


def _ref_policy(pol):
    return RT.TransportPolicy(*[getattr(pol, f.name)
                                for f in dataclasses.fields(pol)])


def _exchanges(codec):
    ex, rex = LocalExchange(P), RefLocalExchange(P)
    if codec is None:
        return ex, rex
    name, delta = (("f32", True) if codec == "f32_delta" else (codec, True))
    return (with_wire(ex, name, delta=delta),
            ref_with_wire(rex, name, delta=delta))


@pytest.mark.parametrize("structural", [False, True])
@pytest.mark.parametrize("codec", [None, "int8", "fp8_e4m3", "bf16",
                                   "f32_delta"])
def test_allgather_ship_matches_reference(codec, structural):
    rng = np.random.default_rng(0)
    b = 40
    tree = {"a": rng.normal(size=(P, b)).astype(np.float32),
            "b": rng.normal(size=(P, b, 3)).astype(np.float32),
            "i": rng.integers(-90, 90, (P, b)).astype(np.int32),
            "v": rng.random((P, b)) < 0.5}
    flags = rng.random((P, b)) < 0.6
    ex, rex = _exchanges(codec)
    rflags = flags[None].repeat(P, 0) if structural else None
    recv, rf, info = T.allgather_ship(
        ex, {k: torch.from_numpy(v) for k, v in tree.items()},
        torch.from_numpy(flags), bound=100,
        recvflags=None if rflags is None else torch.from_numpy(rflags))
    rrecv, rrf, rinfo = RT.allgather_ship(
        rex, {k: jnp.asarray(v) for k, v in tree.items()},
        jnp.asarray(flags), bound=100,
        recvflags=None if rflags is None else jnp.asarray(rflags))
    np.testing.assert_array_equal(rf.numpy(), np.asarray(rrf))
    for k in tree:
        got = recv[k]
        want = np.asarray(rrecv[k])
        assert got.shape == want.shape, k
        if got.dtype == torch.bfloat16:
            got = got.float()
            want = want.astype(np.float32)
        np.testing.assert_array_equal(got.numpy(), want, k)
    assert float(info.bytes_shipped) == float(rinfo.bytes_shipped)
    assert int(info.route_active_max) == int(rinfo.route_active_max)
    staged = {k: torch.from_numpy(v)[:, None] for k, v in tree.items()}
    assert info.bytes_shipped == T.allgather_wire_bytes(
        staged, ex.codec, 100, P, flags_shipped=not structural)


def _hybrid(gd, bmr=3):
    g = Graph.from_edges(gd.src, gd.dst, num_partitions=P,
                         partitioner="hybrid", bcast_min_repl=bmr,
                         device="cpu")
    rg = RefGraph.from_edges(gd.src, gd.dst, num_partitions=P,
                             partitioner="hybrid", bcast_min_repl=bmr)
    assert g.s.has_bcast and g.host.stats.n_broadcast > 0
    return g, rg


def _cleared(g):
    """The same structure with the broadcast lane's tables cleared."""
    s = dataclasses.replace(g.s, brecv=None, p2p_routes=None)
    assert not s.has_bcast
    return g.replace(s=s)


@pytest.fixture(scope="module")
def cc_graphs():
    gd = symmetrize(rmat(9, 8, seed=2))
    return (gd,) + _hybrid(gd)


@pytest.fixture(scope="module")
def pr_graphs():
    gd = rmat(9, 10, seed=2)
    return _hybrid(gd)


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_hybrid_bcast_cc_matches_reference(cc_graphs, policy):
    gd, g, rg = cc_graphs
    tp = POLICIES[policy]
    r = alg.connected_components(g, transport=tp, track_metrics=True)
    r0 = alg.connected_components(_cleared(g), transport=tp)
    rr = ref_alg.connected_components(rg, transport=_ref_policy(tp),
                                      track_metrics=True)
    assert r.supersteps == r0.supersteps == rr.supersteps
    assert torch.equal(r.graph.vdata["cc"], r0.graph.vdata["cc"])
    np.testing.assert_array_equal(r.graph.vdata["cc"].numpy(),
                                  np.asarray(rr.graph.vdata["cc"]))
    mask = g.vmask.numpy()
    vids = g.s.home_vid.numpy()[mask]
    want = alg.connected_components_reference(gd.src, gd.dst, vids)
    assert dict(zip(vids.tolist(),
                    r.graph.vdata["cc"].numpy()[mask].tolist())) == want
    for m, rm in zip(r.metrics, rr.metrics):
        for k in ("bytes_shipped", "bytes_on_wire", "ragged", "transport",
                  "overflow_fallbacks", "bytes_link_modeled"):
            want_k = rm[k] if isinstance(rm[k], str) else float(rm[k])
            assert m[k] == want_k, k
        for f in ("wire_bytes", "n_shipped", "effective_bytes"):
            assert m["fwd"][f] == float(getattr(rm["fwd"], f)), f
    assert float(r.graph.bytes_shipped) == float(rr.graph.bytes_shipped)
    # the broadcast lane is one of the forward ships' collectives
    assert r.metrics[0]["fwd"]["wire_bytes"] != \
        alg.connected_components(_cleared(g), track_metrics=True,
                                 max_supersteps=1).metrics[0]["fwd"][
            "wire_bytes"]


@pytest.mark.parametrize("policy", ["dense", "tiered", "auto"])
def test_hybrid_bcast_pagerank_matches_reference(pr_graphs, policy):
    """Static PageRank, 5 supersteps: bit-equal with the broadcast tables
    cleared (a float sum in the same placement), equal to the reference's
    to 1e-5 (its f32 sums run in XLA's order), bytes equal."""
    g, rg = pr_graphs
    tp = POLICIES[policy]
    r = alg.pagerank(g, num_iters=5, transport=tp, track_metrics=True)
    r0 = alg.pagerank(_cleared(g), num_iters=5, transport=tp)
    rr = ref_alg.pagerank(rg, num_iters=5, transport=_ref_policy(tp),
                          track_metrics=True)
    assert torch.equal(r.graph.vdata["pr"], r0.graph.vdata["pr"])
    np.testing.assert_allclose(r.graph.vdata["pr"].numpy(),
                               np.asarray(rr.graph.vdata["pr"]), rtol=1e-5)
    for m, rm in zip(r.metrics, rr.metrics):
        assert m["bytes_shipped"] == float(rm["bytes_shipped"])
        assert m["bytes_on_wire"] == float(rm["bytes_on_wire"])
        assert m["ragged"] == float(rm["ragged"])


def test_bcast_lane_with_delta_pagerank_and_wire(pr_graphs):
    """Delta PageRank over the f32 delta wire under fig4's auto policy on
    the hybrid build: equal to the cleared structure bit for bit.  (Under
    a scaled codec the lanes quantise in other blocks, so only a lossless
    wire keeps values independent of placement.)"""
    g, _ = pr_graphs
    g = g.replace(ex=with_wire(g.ex, "f32", delta=True))
    tp = T.TransportPolicy("auto", cap_rounding=32, enter_frac=0.95,
                           exit_frac=0.97)
    r = alg.pagerank(g, num_iters=30, tol=1e-3, transport=tp)
    r0 = alg.pagerank(_cleared(g), num_iters=30, tol=1e-3, transport=tp)
    assert r.supersteps == r0.supersteps
    assert torch.equal(r.graph.vdata["pr"], r0.graph.vdata["pr"])

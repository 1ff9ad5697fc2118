"""The port's Pregel drivers on the CPU: `pregel_fused` against the
reference's `pregel_fused` and against the port's own `pregel`, and the
replayable step (`core/capture.py`) they run through.

On the CPU both drivers run their supersteps eagerly through the same
static buffers a CUDA graph replays on the card, and `pregel_fused` runs
the same masked blocks of `FUSED_BLOCK` supersteps.  CC, SSSP and label
propagation equal the reference bit for bit; PageRank within 1e-5
relative (f32 sums in another order than XLA's).  Port `pregel_fused` ==
port `pregel` bit for bit: values, superstep counts, the view's tensors
and static half, and the wire log.
"""
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.core import Graph as RefGraph  # noqa: E402
from repro.core import algorithms as ref_alg  # noqa: E402
import repro.core as ref_core  # noqa: E402
from repro.core.pregel import pregel_fused as ref_pregel_fused  # noqa: E402
from repro.data import rmat, symmetrize  # noqa: E402
from repro_torch.core import Graph, pregel, pregel_fused, with_wire  # noqa: E402
from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.core import capture  # noqa: E402
from repro_torch.core import mrtriplets as mt  # noqa: E402
from repro_torch.core.tree import tree_map  # noqa: E402

pm = sys.modules["repro_torch.core.pregel"]
K = pm.FUSED_BLOCK
RESET, TOL = 0.15, 1e-3
LP_K = 4


def _gd():
    gd = symmetrize(rmat(7, 6, seed=3))
    w = np.random.default_rng(1).uniform(0.5, 3, gd.num_edges).astype(
        np.float32)
    return gd, w


@pytest.fixture(scope="module")
def graphs():
    gd, w = _gd()
    g = Graph.from_edges(gd.src, gd.dst, edge_values={"w": w},
                         num_partitions=4, device="cpu")
    rg = RefGraph.from_edges(gd.src, gd.dst, edge_values={"w": w},
                             num_partitions=4)
    return g, rg


# --- the runs: (port graph, UDFs, kwargs) and the reference's -------------
def _ref_pr_send(sv, ev, dv):
    return {"m": sv["pr"] / sv["deg"] * ev["w"]}


def _ref_pr_vprog(vid, v, msg):
    return {**v, "pr": RESET + (1.0 - RESET) * msg["m"]}


def _ref_delta_send(sv, ev, dv):
    return {"m": sv["delta"] / sv["deg"] * ev["w"]}


def _ref_delta_vprog(vid, v, msg):
    new_pr = v["pr"] + (1.0 - RESET) * msg["m"]
    return {**v, "pr": new_pr, "delta": new_pr - v["pr"]}


def _ref_lp_send(sv, ev, dv):
    return {"votes": (jnp.arange(LP_K) == sv["label"] % LP_K).astype(
        jnp.float32)}


def _ref_lp_vprog(vid, v, msg):
    has_votes = msg["votes"].sum() > 0
    new = jnp.argmax(msg["votes"]).astype(jnp.int32)
    return {"label": jnp.where(has_votes, new, v["label"])}


def _port_run(name, g):
    """(graph, vprog, send, gather, kwargs) of one algorithm on g."""
    if name == "pagerank":
        g = alg.attach_out_degree(g).mapV(alg._pr_init)
        return (g, alg.pagerank_vprog(RESET), alg.pagerank_send, "sum",
                dict(default_msg={"m": torch.tensor(0.0)}, max_supersteps=10,
                     skip_stale=None))
    if name == "delta_pagerank":
        g = alg.attach_out_degree(g).mapV(
            lambda vid, v: {**v, "pr": torch.tensor(RESET),
                            "delta": torch.tensor(RESET)})
        vprog, changed = alg.delta_pagerank_fns(RESET, TOL)
        return (g, vprog, alg.delta_pagerank_send, "sum",
                dict(default_msg={"m": torch.tensor(0.0)}, max_supersteps=50,
                     skip_stale="out", changed_fn=changed))
    if name == "cc":
        return (g.mapV(alg._cc_init), alg.cc_vprog, alg.cc_send, "min",
                dict(default_msg={"m": torch.tensor(alg.IMAX,
                                                    dtype=torch.int32)}))
    if name == "sssp":
        g = g.mapV(lambda vid, v: {"dist": torch.where(
            vid == 0, torch.tensor(0.0), torch.tensor(alg.INF32))})
        return (g, alg.sssp_vprog, alg.sssp_send, "min",
                dict(default_msg={"m": torch.tensor(alg.INF32)}))
    assert name == "label_propagation"
    send, vprog = alg.label_propagation_fns(LP_K)
    g = g.mapV(lambda vid, v: {"label": (vid // 3 % LP_K).to(torch.int32)})
    return (g, vprog, send, "sum",
            dict(default_msg={"votes": torch.zeros(LP_K)}, max_supersteps=10,
                 skip_stale=None))


def _ref_run(name, rg):
    if name == "pagerank":
        rg = ref_alg.attach_out_degree(rg).mapV(
            lambda vid, v: {**v, "pr": jnp.float32(1.0)})
        return (rg, _ref_pr_vprog, _ref_pr_send, "sum",
                dict(default_msg={"m": jnp.float32(0.0)}, max_supersteps=10,
                     skip_stale=None))
    if name == "delta_pagerank":
        rg = ref_alg.attach_out_degree(rg).mapV(
            lambda vid, v: {**v, "pr": jnp.float32(RESET),
                            "delta": jnp.float32(RESET)})
        return (rg, _ref_delta_vprog, _ref_delta_send, "sum",
                dict(default_msg={"m": jnp.float32(0.0)}, max_supersteps=50,
                     skip_stale="out",
                     changed_fn=lambda o, n: jnp.abs(n["pr"] - o["pr"]) > TOL))
    if name == "cc":
        return (rg.mapV(lambda vid, v: {"cc": vid}),
                lambda vid, v, m: {"cc": jnp.minimum(v["cc"], m["m"])},
                lambda sv, ev, dv: {"m": sv["cc"]}, "min",
                dict(default_msg={"m": jnp.int32(alg.IMAX)}))
    if name == "sssp":
        rg = rg.mapV(lambda vid, v: {"dist": jnp.where(
            vid == 0, jnp.float32(0.0), jnp.float32(alg.INF32))})
        return (rg, lambda vid, v, m: {"dist": jnp.minimum(v["dist"],
                                                           m["m"])},
                lambda sv, ev, dv: {"m": sv["dist"] + ev["w"]}, "min",
                dict(default_msg={"m": jnp.float32(alg.INF32)}))
    assert name == "label_propagation"
    rg = rg.mapV(lambda vid, v: {"label": (vid // 3 % LP_K).astype(
        jnp.int32)})
    return (rg, _ref_lp_vprog, _ref_lp_send, "sum",
            dict(default_msg={"votes": jnp.zeros((LP_K,), jnp.float32)},
                 max_supersteps=10, skip_stale=None))


ALGS = ("cc", "sssp", "label_propagation", "pagerank", "delta_pagerank")
_REF_CACHE: dict = {}


@pytest.fixture(scope="module")
def ref_fused(graphs):
    """The reference's pregel_fused results, computed once per algorithm:
    name -> (visible ids, values of the first vdata leaf, steps)."""
    def get(name, leaf):
        if name not in _REF_CACHE:
            rg, vprog, send, gather, kw = _ref_run(name, graphs[1])
            gr, steps = ref_pregel_fused(rg, vprog, send, gather, **kw)
            ids, vals = gr.vertices_to_numpy()
            _REF_CACHE[name] = (np.asarray(ids), np.asarray(vals[leaf]),
                                int(steps), float(gr.ships),
                                float(gr.bytes_shipped))
        return _REF_CACHE[name]
    return get


LEAF = {"cc": "cc", "sssp": "dist", "label_propagation": "label",
        "pagerank": "pr", "delta_pagerank": "pr"}


@pytest.mark.parametrize("name", ALGS)
def test_pregel_fused_matches_reference(graphs, ref_fused, name):
    g, vprog, send, gather, kw = _port_run(name, graphs[0])
    gr, steps = pregel_fused(g, vprog, send, gather, **kw)
    assert steps.dtype == torch.int32 and steps.dim() == 0
    assert steps.device == g.device
    ids, vals = gr.vertices_to_numpy()
    rids, rvals, rsteps, rships, rbytes = ref_fused(name, LEAF[name])
    np.testing.assert_array_equal(ids, rids)
    if name in ("pagerank", "delta_pagerank"):
        np.testing.assert_allclose(vals[LEAF[name]], rvals, rtol=1e-5)
    else:
        np.testing.assert_array_equal(vals[LEAF[name]], rvals)
    assert int(steps) == rsteps
    assert float(gr.ships) == rships
    assert float(gr.bytes_shipped) == rbytes
    if name == "pagerank":          # masked supersteps ran in the last block
        assert (kw["max_supersteps"] - 1) % K != 0
    if name == "sssp":              # it halts inside a block
        assert (rsteps - 1) % K != 0 and rsteps < 50


def test_pregel_fused_equals_host_loop_as_in_reference():
    """tests/test_algorithms.py::test_pregel_fused_equals_host_loop, on
    the port, and the port's fused run against the reference's."""
    gd = rmat(6, 4, seed=7)
    g = alg.attach_out_degree(Graph.from_edges(
        gd.src, gd.dst, num_partitions=4, device="cpu")).mapV(alg._pr_init)
    vprog = alg.pagerank_vprog(RESET)
    host = pregel(g, vprog, alg.pagerank_send, "sum",
                  default_msg={"m": torch.tensor(0.0)}, max_supersteps=5,
                  skip_stale=None)
    fused_g, steps = pregel_fused(
        g, vprog, alg.pagerank_send, "sum",
        default_msg={"m": torch.tensor(0.0)}, max_supersteps=5,
        skip_stale=None,
        changed_fn=lambda o, n: torch.abs(o["pr"] - n["pr"]) > 0)
    np.testing.assert_allclose(host.graph.vdata["pr"].numpy(),
                               fused_g.vdata["pr"].numpy(), rtol=1e-5)
    rg = ref_alg.attach_out_degree(RefGraph.from_edges(
        gd.src, gd.dst, num_partitions=4)).mapV(
        lambda vid, v: {**v, "pr": jnp.float32(1.0)})
    rfused, rsteps = ref_pregel_fused(
        rg, _ref_pr_vprog, _ref_pr_send, "sum",
        default_msg={"m": jnp.float32(0.0)}, max_supersteps=5,
        skip_stale=None,
        changed_fn=lambda o, n: jnp.abs(o["pr"] - n["pr"]) > 0)
    np.testing.assert_allclose(fused_g.vdata["pr"].numpy(),
                               np.asarray(rfused.vdata["pr"]), rtol=1e-5)
    assert int(steps) == int(rsteps) == 5


# --- port pregel_fused == port pregel, bit for bit ---------------------------
def _assert_same_graph(a, b):
    ta, sa = capture.flatten(pm._carry(a))
    tb, sb = capture.flatten(pm._carry(b))
    assert sa == sb         # treedef, dtypes, shapes, the view's plan
    for x, y in zip(ta, tb):
        assert torch.equal(x, y)


def _both(g, vprog, send, gather, kw):
    r = pregel(g, vprog, send, gather, **kw)
    gf, steps = pregel_fused(g, vprog, send, gather, **kw)
    _assert_same_graph(r.graph, gf)
    assert int(steps) == max(r.supersteps, 1)
    return r, int(steps)


_SMALL = symmetrize(rmat(6, 5, seed=11))
_W = np.random.default_rng(2).uniform(0.5, 3, _SMALL.num_edges).astype(
    np.float32)

# (algorithm, max_supersteps, incremental, kernel_mode, partitioner, P)
CASES = ([("pagerank", m, inc, mode, "2d", 4)
          for m in sorted({1, K - 1, K, K + 1}) for inc in (True, False)
          for mode in ("auto", "unfused")]
         + [(a, 50, inc, mode, "2d", 4)
            for a in ("cc", "sssp", "delta_pagerank")
            for inc in (True, False)
            for mode in ("auto", "unfused")]
         + [(a, 50, True, "auto", part, p)
            for a in ("cc", "sssp")
            for part in ("2d", "1d", "random", "hybrid") for p in (1, 3, 8)])


@pytest.mark.parametrize("name,max_steps,incremental,mode,part,p", CASES)
def test_pregel_fused_equals_pregel(name, max_steps, incremental, mode, part,
                                    p):
    g = Graph.from_edges(_SMALL.src, _SMALL.dst, edge_values={"w": _W},
                         num_partitions=p, partitioner=part, device="cpu")
    g, vprog, send, gather, kw = _port_run(name, g)
    kw.update(max_supersteps=max_steps, incremental=incremental,
              kernel_mode=mode)
    r, steps = _both(g, vprog, send, gather, kw)
    if name == "sssp" and part == "2d" and p == 4:   # halts inside a block
        assert r.supersteps < max_steps and (steps - 1) % K != 0


@pytest.mark.parametrize("codec", ["int8", "fp8_e4m3"])
def test_pregel_fused_equals_pregel_over_resident_mirrors(codec):
    """Encoded mirror leaves (`wire.ResidentLeaf`) ride the carry and the
    masked commit like tensors."""
    g = Graph.from_edges(_SMALL.src, _SMALL.dst, edge_values={"w": _W},
                         num_partitions=4, device="cpu")
    g = g.replace(ex=with_wire(g.ex, codec, resident=True))
    g, vprog, send, gather, kw = _port_run("pagerank", g)
    r, _ = _both(g, vprog, send, gather, kw)
    assert any(type(leaf).__name__ == "ResidentLeaf"
               for leaf in r.graph.view.mirror.values())


# --- the replayable step on the CPU -----------------------------------------
def _eager_loop(g, vprog, send, gather, *, default_msg, max_supersteps=50,
                skip_stale="out", changed_fn=None):
    """The loop the drivers replace: `_superstep` called superstep by
    superstep on freshly allocated tensors."""
    aplan = mt._plan_apply(g, vprog, send, gather, changed_fn, default_msg,
                           None)
    dmsg = tree_map(lambda d: torch.as_tensor(d), default_msg)
    steps = 0
    for _ in range(max_supersteps):
        g, live, _ = pm._superstep(
            g, vprog=vprog, send_msg=send, gather=gather, default_msg=dmsg,
            skip_stale=skip_stale, changed_fn=changed_fn,
            kernel_mode="auto", use_cache=True, payload_bound=None,
            aplan=aplan)
        steps += 1
        if int(live) == 0:
            break
    return g, steps


@pytest.mark.parametrize("name", ["pagerank", "delta_pagerank", "cc"])
def test_static_buffers_equal_fresh_allocations(graphs, name):
    g, vprog, send, gather, kw = _port_run(name, graphs[0])
    want, n = _eager_loop(g, vprog, send, gather, **kw)
    r = pregel(g, vprog, send, gather, **kw)
    assert r.supersteps == n
    _assert_same_graph(r.graph, want)


def test_replay_raises_when_a_step_changes_the_view_plan(graphs):
    g, vprog, send, gather, kw = _port_run("cc", graphs[0])
    step = pm._step_fn(g, vprog, send, gather, default_msg=kw["default_msg"],
                       skip_stale="out", changed_fn=None, kernel_mode="auto",
                       incremental=True, payload_bound=None,
                       fuse_apply="auto")
    g1, _, _ = step(g)

    def bad(carry):
        g2, live, _ = step(g1.replace(**carry))
        c = pm._carry(g2)
        c["view"] = c["view"].replace(dirs=("sd",) * len(c["view"].dirs))
        return c, live

    rep = capture.Replay(bad, pm._carry(g1), capture=False)
    with pytest.raises(capture.StaticHalfChanged):
        rep.run()

    def good(carry):
        g2, live, _ = step(g1.replace(**carry))
        return pm._carry(g2), live

    inputs = [t.clone() for t in capture.flatten(pm._carry(g1))[0]]
    with capture.Replay(good, pm._carry(g1), capture=False) as rep:
        rep.run()
        after = capture.flatten(rep.carry)[0]
    # the step advanced the buffers; the graph it started from is untouched
    assert not all(torch.equal(a, b) for a, b in zip(inputs, after))
    for a, b in zip(inputs, capture.flatten(pm._carry(g1))[0]):
        assert torch.equal(a, b)


def test_ref_mode_runs_eagerly_on_the_card():
    """kernel_mode="ref" reads tables back to the host (the plain
    versions), so the drivers do not capture its supersteps; every other
    mode on a CUDA device does, and nothing on the CPU."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert not pm._captures(cuda, "ref")
    assert pm._captures(cuda, "auto") and pm._captures(cuda, "unfused")
    assert not pm._captures(cpu, "auto")


def test_refused_transports_name_the_roadmap(graphs):
    """Every transport runs, the integrity ladder too (the name is the old
    refusal's): pregel_fused under a checked ragged policy equals the
    dense run bit for bit."""
    from repro_torch.core.transport import TransportPolicy
    g, vprog, send, gather, kw = _port_run("cc", graphs[0])
    want, n = pregel_fused(g, vprog, send, gather, transport="dense",
                           default_msg=kw["default_msg"])
    for tp in ("ragged", "auto", TransportPolicy("ragged", pipeline=True)):
        got, m = pregel_fused(g, vprog, send, gather, transport=tp,
                              default_msg=kw["default_msg"])
        assert int(m) == int(n) and torch.equal(got.vdata["cc"],
                                                want.vdata["cc"])
    got, m = pregel_fused(g, vprog, send, gather,
                          default_msg=kw["default_msg"],
                          transport=TransportPolicy("ragged", integrity=True))
    assert int(m) == int(n) and torch.equal(got.vdata["cc"], want.vdata["cc"])


def test_drivers_are_exported_as_in_reference():
    import repro_torch.core as core
    for name in ("pregel", "pregel_fused", "PregelResult"):
        assert getattr(core, name).__name__ == getattr(ref_core,
                                                        name).__name__


# --- the mutants chip_smoke.py holds its driver checks against ---------------
def _mutant(old: str, new: str) -> types.ModuleType:
    """core/pregel.py with one line edited, loaded as a module of the
    port's package."""
    src = Path(pm.__file__).read_text()
    assert src.count(old) == 1, old
    mod = types.ModuleType("repro_torch.core._pregel_mutant")
    mod.__package__ = "repro_torch.core"
    sys.modules[mod.__name__] = mod     # dataclasses look their module up
    try:
        exec(compile(src.replace(old, new), pm.__file__, "exec"),
             mod.__dict__)
    finally:
        del sys.modules[mod.__name__]
    return mod


def test_fused_driver_mutants_fail(graphs):
    g, vprog, send, gather, kw = _port_run("pagerank", graphs[0])
    want, steps = pregel_fused(g, vprog, send, gather, **kw)
    no_cap = _mutant("run = (live > 0) & (i < max_supersteps)",
                     "run = live > 0")
    got, _ = no_cap.pregel_fused(g, vprog, send, gather, **kw)
    assert not torch.equal(got.vdata["pr"], want.vdata["pr"])
    loose = _mutant("i = i + run.to(i.dtype)", "i = i + 1")
    got, got_steps = loose.pregel_fused(g, vprog, send, gather, **kw)
    assert torch.equal(got.vdata["pr"], want.vdata["pr"])
    assert int(got_steps) != int(steps)

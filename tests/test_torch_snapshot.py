"""The port's snapshots (`repro_torch.core.snapshot`, `train.checkpoint`)
and Pregel's fault-tolerance keywords against the JAX reference's.

The port of the reference's kill / checkpoint / restore tests
(tests/test_fault.py): a run killed at a checkpoint and resumed equals the
uninterrupted run bit for bit (state, view, wire log), also when a tripped
preemption guard stops it; a warm restore's first superstep ships fewer
bytes than a cold restart's; an elastic restore of CC onto 2 partitions
gives the uninterrupted run's labels; torn tmp directories are invisible
and cleaned, `clean_tmp` spares the write in flight, the Checkpointer
cleans a torn tmp.  Snapshots cross both ways: the reference's snapshot
continued by the port equals the reference's uninterrupted run (PageRank
within 1e-5 relative, CC bit for bit) and the other way round; shard
names, shapes and dtypes are the reference's, and so are the Graph's and
the view's fields (the port holds none the reference lacks).  Training
xlstm-350m SMOKE with `checkpoint_dir`, resumed after step 2, gives step
3's loss and parameters bit-equal to an uninterrupted run.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.core import Graph as RefGraph  # noqa: E402
from repro.core import algorithms as ref_alg  # noqa: E402
from repro.core import snapshot as ref_snap  # noqa: E402
from repro.core.graph import Graph as RefGraphCls  # noqa: E402
from repro.core.pregel import pregel as ref_pregel  # noqa: E402
from repro.core.view import GraphView as RefView  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch.core import Graph  # noqa: E402
from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.core import snapshot as snap  # noqa: E402
from repro_torch.core.pregel import pregel  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.core.view import GraphView  # noqa: E402
from repro_torch.data.tokens import SyntheticLM  # noqa: E402
from repro_torch.train import train_loop as tl  # noqa: E402
from repro_torch.train.checkpoint import Checkpointer  # noqa: E402

P = 4
PR_RTOL = 1e-5
IMAX = 2 ** 31 - 1


def _edges(n=48, m=240, seed=3, sym=False):
    rng = np.random.RandomState(seed)
    src, dst = rng.randint(0, n, m), rng.randint(0, n, m)
    if sym:
        src, dst = np.r_[src, dst], np.r_[dst, src]
    return src, dst


# --- PageRank and CC on both sides ------------------------------------------
def _pr_graph():
    src, dst = _edges()
    g = Graph.from_edges(src, dst, num_partitions=P, device="cpu")
    return alg.attach_out_degree(g).mapV(
        lambda vid, v: {**v, "pr": torch.tensor(1.0)})


def _run_pr(g, n, **kw):
    return pregel(g, alg.pagerank_vprog(0.15), alg.pagerank_send, "sum",
                  default_msg={"m": torch.tensor(0.0)}, skip_stale=None,
                  max_supersteps=n, **kw)


def _ref_pr_graph():
    src, dst = _edges()
    g = RefGraph.from_edges(src, dst, num_partitions=P)
    return ref_alg.attach_out_degree(g).mapV(
        lambda vid, v: {**v, "pr": jnp.float32(1.0)})


def _ref_run_pr(g, n, **kw):
    return ref_pregel(
        g, lambda vid, v, m: {**v, "pr": 0.15 + 0.85 * m["m"]},
        lambda sv, ev, dv: {"m": sv["pr"] / sv["deg"] * ev["w"]}, "sum",
        default_msg={"m": jnp.float32(0.0)}, skip_stale=None,
        max_supersteps=n, **kw)


def _cc_graph(p=P, ref=False):
    src, dst = _edges(n=40, m=120, seed=11, sym=True)
    w = {"w": np.ones(len(src), np.float32)}
    if ref:
        return RefGraph.from_edges(src, dst, edge_values=w,
                                   num_partitions=p).mapV(
            lambda vid, v: {"cc": vid})
    return Graph.from_edges(src, dst, edge_values=w, num_partitions=p,
                            device="cpu").mapV(alg._cc_init)


def _run_cc(g, n, **kw):
    return pregel(g, alg.cc_vprog, alg.cc_send, "min",
                  default_msg={"m": torch.tensor(IMAX, dtype=torch.int32)},
                  max_supersteps=n, skip_stale="out", **kw)


def _ref_run_cc(g, n, **kw):
    return ref_pregel(g, lambda vid, v, m: {"cc": jnp.minimum(v["cc"],
                                                               m["m"])},
                      lambda sv, ev, dv: {"m": sv["cc"]}, "min",
                      default_msg={"m": jnp.int32(IMAX)}, max_supersteps=n,
                      skip_stale="out", **kw)


def _labels(g) -> dict:
    vids, vals = g.vertices_to_numpy()
    return dict(zip(np.asarray(vids).tolist(),
                    np.asarray(vals["cc"]).tolist()))


def _same_graph(a, b):
    """State, view (tensors and static half) and wire log bit for bit."""
    for x, y in zip(tree_leaves(a.vdata), tree_leaves(b.vdata)):
        assert torch.equal(x, y)
    assert torch.equal(a.active, b.active)
    va, vb = a.view, b.view
    assert (va is None) == (vb is None)
    if va is not None:
        for f in dataclasses.fields(GraphView):
            x, y = getattr(va, f.name), getattr(vb, f.name)
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y), f.name
            elif f.name in ("mirror", "dirty"):
                for p, q in zip(tree_leaves(x), tree_leaves(y)):
                    assert torch.equal(p, q), f.name
            else:
                assert x == y, f.name
    for f in ("ships", "bytes_shipped", "bytes_accounted"):
        assert torch.equal(getattr(a.wire_log, f), getattr(b.wire_log, f))


@pytest.fixture(scope="module")
def pr_base():
    return _run_pr(_pr_graph(), 8)


@pytest.fixture(scope="module")
def ref_runs(tmp_path_factory):
    """The reference's uninterrupted runs and its snapshots after superstep
    3 (PageRank) and 2 (CC)."""
    d_pr = str(tmp_path_factory.mktemp("ref_pr"))
    d_cc = str(tmp_path_factory.mktemp("ref_cc"))
    _ref_run_pr(_ref_pr_graph(), 3, checkpoint=d_pr, checkpoint_every=3)
    _ref_run_cc(_cc_graph(ref=True), 2, checkpoint=d_cc, checkpoint_every=2)
    pr = _ref_run_pr(_ref_pr_graph(), 8)
    cc = _ref_run_cc(_cc_graph(ref=True), 100)
    return {"pr_dir": d_pr, "cc_dir": d_cc,
            "pr": np.asarray(pr.graph.vdata["pr"]),
            "cc": np.asarray(cc.graph.vdata["cc"]),
            "cc_steps": cc.supersteps}


# ---------------------------------------------------------------------------
# Kill / checkpoint / restore
# ---------------------------------------------------------------------------
def test_checkpoint_resume_bit_exact(tmp_path, pr_base):
    d = str(tmp_path / "ckpt")
    r1 = _run_pr(_pr_graph(), 3, checkpoint=d, checkpoint_every=3)
    assert r1.supersteps == 3
    assert snap.SnapshotStore(d).all_steps() == [3]
    r2 = _run_pr(_pr_graph(), 8, checkpoint=d, checkpoint_every=3)
    assert r2.supersteps == 5          # resumed at 3, ran 3..7
    _same_graph(r2.graph, pr_base.graph)


def test_preemption_guard_checkpoints_and_resumes(tmp_path, pr_base):
    class TrippedGuard:
        def __init__(self, after):
            self.seen, self.after = 0, after

        @property
        def requested(self):
            self.seen += 1
            return self.seen > self.after

    d = str(tmp_path / "ckpt")
    guard = TrippedGuard(3)
    r1 = _run_pr(_pr_graph(), 8, checkpoint=d, guard=guard)
    # read once a boundary: tripped at the fourth, saved, left
    assert r1.supersteps == 4 and guard.seen == 4
    r2 = _run_pr(_pr_graph(), 8, checkpoint=d)
    assert r1.supersteps + r2.supersteps == 8
    _same_graph(r2.graph, pr_base.graph)


def test_warm_restore_ships_fewer_bytes_than_cold(tmp_path):
    base = _run_pr(_pr_graph(), 5)
    d = str(tmp_path / "ckpt")
    _run_pr(_pr_graph(), 3, checkpoint=d, checkpoint_every=3)
    warm = _run_pr(_pr_graph(), 5, checkpoint=d, track_metrics=True)
    assert warm.supersteps == 2
    assert torch.equal(base.graph.vdata["pr"], warm.graph.vdata["pr"])
    g_cold, start, _pol, _live = snap.restore_pregel(
        snap.SnapshotStore(d), _pr_graph())
    assert start == 3
    cold = _run_pr(g_cold.replace(view=None), 2, track_metrics=True)
    assert torch.equal(base.graph.vdata["pr"], cold.graph.vdata["pr"])

    def first_step_bytes(res):
        m = res.metrics[0]
        return m["fwd"]["bytes_shipped"] + m["back"]["bytes_shipped"]

    assert first_step_bytes(warm) < first_step_bytes(cold)


def test_elastic_restore_different_partition_count(tmp_path):
    base = _run_cc(_cc_graph(P), 100)
    d = str(tmp_path / "ckpt")
    _run_cc(_cc_graph(P), 2, checkpoint=d, checkpoint_every=2)
    g2, start, _pol, _live = snap.restore_pregel_elastic(
        snap.SnapshotStore(d), num_partitions=2, device="cpu")
    assert g2.s.p == 2 and start == 2 and g2.view is None
    done = _run_cc(g2, 100)
    assert _labels(done.graph) == _labels(base.graph)


def test_torn_tmp_is_invisible_and_cleaned(tmp_path):
    store = snap.SnapshotStore(str(tmp_path))
    store.write(1, {"a": np.arange(3)}, {"tag": "ok"})
    torn = tmp_path / "tmp.2"
    torn.mkdir()
    (torn / "shards.npz").write_bytes(b"\x00garbage")
    assert store.all_steps() == [1] and store.latest_step() == 1
    arrays, manifest = store.read(1)
    np.testing.assert_array_equal(arrays["a"], np.arange(3))
    assert manifest["tag"] == "ok"
    assert not torn.exists()


def test_clean_tmp_spares_inflight_write(tmp_path):
    store = snap.SnapshotStore(str(tmp_path))
    live, dead = tmp_path / "tmp.5", tmp_path / "tmp.4"
    live.mkdir()
    dead.mkdir()
    store._inflight = 5
    assert store.clean_tmp() == ["tmp.4"]
    assert live.exists() and not dead.exists()


def test_checkpointer_restore_cleans_torn_tmp(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "h": torch.ones(4, dtype=torch.bfloat16), "n": 7}
    ck.save(7, tree, blocking=True)
    torn = tmp_path / "tmp.8"
    torn.mkdir()
    (torn / "manifest.json").write_text("{not json")
    assert ck.all_steps() == [7]
    out = ck.restore(7, tree)
    assert torch.equal(out["w"], tree["w"]) and torch.equal(out["h"],
                                                            tree["h"])
    assert out["n"] == 7 and not torn.exists()
    for s in (8, 9, 10):
        ck.save(s, tree, blocking=True)
    assert ck.all_steps() == [9, 10]           # keep=2


# ---------------------------------------------------------------------------
# The format and cross-restores
# ---------------------------------------------------------------------------
def test_narrow_float_shards_read_from_a_reference_snapshot(tmp_path):
    """The reference stores bf16 through numpy as two-byte voids with
    "bfloat16" in the manifest; the port reads them back as bf16 bits."""
    bits = np.array([0x3FC0, 0x4000, -0x0001], np.int16)
    ref_snap.SnapshotStore(str(tmp_path)).write(
        1, {"h": jax.lax.bitcast_convert_type(jnp.asarray(bits),
                                              jnp.bfloat16)})
    arrays, manifest = snap.SnapshotStore(str(tmp_path)).read(1)
    got = snap.to_tensor(arrays["h"], manifest["leaves"]["h"]["dtype"],
                         "cpu")
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), torch.from_numpy(bits))


def test_graph_and_view_fields_are_the_reference_s():
    names = lambda c: [f.name for f in dataclasses.fields(c)]  # noqa: E731
    assert names(Graph) == names(RefGraphCls)
    assert names(GraphView) == names(RefView)


def test_shards_equal_reference(tmp_path, ref_runs):
    d = str(tmp_path / "ckpt")
    _run_pr(_pr_graph(), 3, checkpoint=d, checkpoint_every=3)
    got, gm = snap.SnapshotStore(d).read(3)
    want, wm = ref_snap.SnapshotStore(ref_runs["pr_dir"]).read(3)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == \
            want[k].dtype, k
    assert gm["leaves"] == wm["leaves"]
    for k in ("kind", "p", "vmask_full", "view", "wire_log", "elastic",
              "superstep", "live", "policy"):
        assert gm[k] == wm[k], k
    # the structure's facts are the same bits (the parity contract)
    for k in ("home_vid", "home_mask", "vmask", "emask", "edata['w']",
              "elastic/src", "elastic/dst"):
        np.testing.assert_array_equal(got[k], want[k])
    assert snap.flatten_with_paths({"vdata": {"pr": 0, "x": [1]}, "t": (2,)})\
        == ref_snap.flatten_with_paths({"vdata": {"pr": 0, "x": [1]},
                                        "t": (2,)})


def test_reference_snapshot_continues_in_the_port(ref_runs):
    r = _run_pr(_pr_graph(), 8, checkpoint=ref_runs["pr_dir"], resume=True)
    assert r.supersteps == 5
    np.testing.assert_allclose(r.graph.vdata["pr"].numpy(), ref_runs["pr"],
                               rtol=PR_RTOL)
    c = _run_cc(_cc_graph(), 100, checkpoint=ref_runs["cc_dir"])
    assert c.supersteps == ref_runs["cc_steps"] - 2
    np.testing.assert_array_equal(c.graph.vdata["cc"].numpy(),
                                  ref_runs["cc"])


def test_port_snapshot_continues_in_the_reference(tmp_path, ref_runs):
    d_pr, d_cc = str(tmp_path / "pr"), str(tmp_path / "cc")
    _run_pr(_pr_graph(), 3, checkpoint=d_pr, checkpoint_every=3)
    _run_cc(_cc_graph(), 2, checkpoint=d_cc, checkpoint_every=2)
    r = _ref_run_pr(_ref_pr_graph(), 8, checkpoint=d_pr)
    assert r.supersteps == 5
    np.testing.assert_allclose(np.asarray(r.graph.vdata["pr"]),
                               ref_runs["pr"], rtol=PR_RTOL)
    c = _ref_run_cc(_cc_graph(ref=True), 100, checkpoint=d_cc)
    np.testing.assert_array_equal(np.asarray(c.graph.vdata["cc"]),
                                  ref_runs["cc"])


# ---------------------------------------------------------------------------
# train_loop with checkpoint_dir
# ---------------------------------------------------------------------------
def test_train_resume_bit_equal(tmp_path):
    """xlstm-350m SMOKE: 3 steps uninterrupted; 2 steps saved through the
    Checkpointer, then a run restored from that snapshot for step 3 (its
    batch): the same loss and parameters bit for bit."""
    cfg = C.get("xlstm-350m", smoke=True)
    data = SyntheticLM(cfg.vocab, 64, 2, seed=0)
    full = tl.train(cfg, iter(data), tl.TrainConfig(steps=3,
                                                    kernel_mode="ref"),
                    device="cpu")
    d = str(tmp_path / "ck")
    first = tl.train(cfg, iter(data), tl.TrainConfig(
        steps=2, checkpoint_every=2, checkpoint_dir=d, kernel_mode="ref"),
        device="cpu")
    assert first["losses"] == full["losses"][:2]
    assert Checkpointer(d).all_steps() == [2]
    resumed = tl.train(cfg, (data.batch(s) for s in range(2, 4)),
                       tl.TrainConfig(steps=3, checkpoint_every=2,
                                      checkpoint_dir=d, kernel_mode="ref"),
                       device="cpu")
    assert resumed["steps"] == 1
    assert resumed["losses"] == full["losses"][2:]
    assert resumed["opt_state"].step == full["opt_state"].step == 3
    for a, b in zip(tree_leaves(resumed["params"]),
                    tree_leaves(full["params"])):
        assert torch.equal(a, b)
    assert Checkpointer(d).all_steps() == [2, 3]

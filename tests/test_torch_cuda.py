"""The port's CUDA kernels on the card, against their plain versions.

Every test takes the `cuda` fixture, which skips when there is no CUDA
card; the decision is made there, never while the module is imported.  On
a machine with one card and nvcc:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q

The graphs are small (rmat(10, 8), P=4): this checks that every kernel
variant the slice generates builds, launches and computes what its plain
version computes, including UDFs that `chip_smoke.py` does not run (delta
PageRank's changed_fn, quickstart's `more_senior`, every IR op).  Min/max,
counts and the apply kernel must match exactly.  The triplet sums are held
within rtol 1e-5 of the plain version, whose `index_add_` adds with atomics
on the card; segment_sum must equal its plain version run on the CPU, which
adds in the kernel's order, bit for bit.  End to end, the card's fused
plan equals its unfused plan bit for bit, CC equals the CPU run exactly and
PageRank equals it within rtol 1e-5, atol 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import Graph, analysis  # noqa: E402
from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.core import mrtriplets as mt  # noqa: E402
from repro_torch.core.tree import ElemSpec  # noqa: E402
from repro_torch.data import rmat, symmetrize  # noqa: E402
from repro_torch.kernels import ops, ref, udf  # noqa: E402
from repro_torch.kernels import segment_sum as seg_mod  # noqa: E402
from repro_torch.kernels import superstep as app_mod  # noqa: E402
from repro_torch.kernels import triplet as tri_mod  # noqa: E402

P = 4
GD = rmat(10, 8, seed=42)
SGD = symmetrize(GD)
F32, I32 = ElemSpec((), torch.float32), ElemSpec((), torch.int32)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


def _graph(gd, device, vdata=None):
    g = Graph.from_edges(gd.src, gd.dst, num_partitions=P, device=device)
    if vdata is not None:
        g = g.replace(vdata={k: torch.from_numpy(v).to(device)
                             for k, v in vdata(g).items()})
    return g


def _vdata_f(g):
    rng = np.random.default_rng(0)
    shape = tuple(g.s.home_vid.shape)
    return {"a": rng.normal(size=shape).astype(np.float32),
            "b": rng.normal(size=shape).astype(np.float32)}


def _vdata_i(g):
    rng = np.random.default_rng(1)
    return {"c": rng.integers(0, 5000, tuple(g.s.home_vid.shape))
            .astype(np.int32)}


def _send_f(sv, ev, dv):
    return {"m": torch.maximum(sv["a"], dv["b"]) * ev["w"]}


def _send_i(sv, ev, dv):
    return {"m": sv["c"]}


def _more_senior(sv, ev, dv):
    return {"n": torch.where(sv["a"] > dv["a"], 1.0, 0.0)}


def _kitchen(sv, ev, dv):
    a, b, c = sv["a"], dv["a"], sv["i"]
    x = torch.where((a > b) & ~(b >= 0.25), a - b, -b) / (torch.abs(a) + 1.5)
    y = torch.minimum(a, b) + torch.maximum(a * 3.0, ev["w"])
    z = (c + 7) * 2 - dv["i"]
    k = ((c > 3) | (a <= b)) ^ (c == 2)
    return {"x": x, "y": y, "z": z, "k": k.to(torch.float32),
            "zf": c.to(torch.float32) * 0.5, "n": torch.neg(c),
            "cmp": (a != 0.5) & torch.logical_not(c < 0)}


def _triplet_inputs(g, dx, seed):
    s, dev = g.s, g.device
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(P * s.v_mir, dx))
                         .astype(np.float32)).to(dev)
    ev = torch.from_numpy(rng.normal(size=(P * s.e_blk, 1))
                          .astype(np.float32)).to(dev)
    live = (s.edge_mask.cpu() & torch.from_numpy(
        rng.random((P, s.e_blk)) < 0.7)).to(dev)
    return x, ev, live


def _check_triplet(g, spec, x, ev, live, to, reduce):
    s = g.s
    args = (x, ev, s.src_slot, s.dst_slot, live, s.agg_ptr[to],
            s.src_perm if to == "src" else None, spec)
    before = tri_mod.fused_triplet.launches
    out, cnt = tri_mod.fused_triplet(*args, to=to, reduce=reduce)
    want, wcnt = ref.fused_triplet(*args, to=to, reduce=reduce)
    torch.cuda.synchronize()
    assert tri_mod.fused_triplet.launches == before + 1
    assert out.is_cuda and torch.equal(cnt, wcnt)
    if reduce == "sum":
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    else:
        assert torch.equal(out, want)


@pytest.mark.parametrize("to", ["dst", "src"])
@pytest.mark.parametrize("reduce,payload", [
    ("sum", "f"), ("min", "f"), ("max", "f"), ("min", "i")])
def test_triplet_kernel_matches_plain(reduce, payload, to, cuda):
    vdata, send = (_vdata_f, _send_f) if payload == "f" else (_vdata_i, _send_i)
    g = _graph(GD, cuda, vdata)
    spec = mt.fused_plan(g, send, reduce).kernel
    x, ev, live = _triplet_inputs(g, 2 if payload == "f" else 1, seed=5)
    if payload == "i":
        x = x.abs().mul(1000).round()
    _check_triplet(g, spec, x, ev, live, to, reduce)


@pytest.mark.parametrize("reduce", ["sum", "max"])
def test_triplet_kernel_runs_every_ir_op(reduce, cuda):
    """A UDF using every op of the IR, run by the kernel and by the IR's
    torch evaluation on the same card."""
    vex = {"a": F32, "i": I32}
    tr = analysis.trace_udf(_kitchen, vex, {"w": F32}, vex)
    ir = udf.lower(tr, [("xs", 0), ("xs", 1), ("ev", 0), ("xd", 0),
                        ("xd", 1)])
    assert ir is not None
    spec = tri_mod.TripletUdf(ir, len(ir.outputs))
    g = _graph(GD, cuda)
    x, ev, live = _triplet_inputs(g, 2, seed=7)
    x[:, 1] = (x[:, 1] * 4).round()          # the int column, staged in f32
    _check_triplet(g, spec, x, ev, live, "dst", reduce)


def _pr_vprog(vid, v, msg):
    return {"a": 0.15 + 0.85 * msg["m"], "b": v["b"]}


def _chg(old, new):
    return torch.abs(new["a"] - old["a"]) > 0.05


def _mx_send(sv, ev, dv):
    return {"m": sv["a"]}


def _mx_vprog(vid, v, msg):
    return {"a": torch.maximum(v["a"], msg["m"]), "b": v["b"]}


def _cc_vprog(vid, v, msg):
    return {"c": torch.minimum(v["c"], msg["m"])}


APPLY_CASES = {
    # name: (vdata, send, vprog, reduce, changed_fn, default)
    "sum": (_vdata_f, _send_f, _pr_vprog, "sum", None, 0.0),
    "sum_changed_fn": (_vdata_f, _send_f, _pr_vprog, "sum", _chg, 0.0),
    "max": (_vdata_f, _mx_send, _mx_vprog, "max", None, -1.0),
    "min_int": (_vdata_i, _send_i, _cc_vprog, "min", None, 2**31 - 1),
}


@pytest.mark.parametrize("case", sorted(APPLY_CASES))
def test_apply_kernel_matches_plain(case, cuda):
    """Both combine in ascending source partition and run the same IR, so
    they agree exactly, sums included."""
    vdata, send, vprog, reduce, chg, dflt = APPLY_CASES[case]
    g = _graph(GD, cuda, vdata)
    is_int = case == "min_int"
    dtype = torch.int32 if is_int else torch.float32
    plan = mt._plan_apply(g, vprog, send, reduce, chg,
                          {"m": torch.tensor(dflt, dtype=dtype)}, None)
    assert plan is not None
    send_idx = g.s.routes["dst"][0]
    rng = np.random.default_rng(11)
    shape = tuple(send_idx.shape)
    recv = (rng.integers(0, 5000, shape).astype(np.int32) if is_int
            else rng.normal(size=shape).astype(np.float32))
    recv = {"m": torch.from_numpy(recv).to(cuda)}
    rflags = (send_idx >= 0) & torch.from_numpy(rng.random(shape) < 0.8).to(cuda)
    before = app_mod.fused_apply.launches
    new, changed = mt.fused_apply_home(g, recv, rflags, "dst", reduce, plan,
                                       "auto")
    want, wchanged = mt.fused_apply_home(g, recv, rflags, "dst", reduce, plan,
                                         "ref")
    torch.cuda.synchronize()
    assert app_mod.fused_apply.launches == before + 1
    assert torch.equal(changed, wchanged)
    for k in want:
        assert new[k].dtype == want[k].dtype
        assert torch.equal(new[k], want[k]), k


@pytest.mark.parametrize("to", ["dst", "src"])
@pytest.mark.parametrize("d", [1, 3])
def test_segment_sum_kernel_matches_plain(d, to, cuda):
    """Both add each segment's live entries in ascending order: on the
    plain version's CPU run that order is exact, so the kernel must equal
    it bit for bit."""
    s = _graph(GD, cuda).s
    rng = np.random.default_rng(d)
    msgs = torch.from_numpy(rng.normal(size=(P, s.e_blk, d))
                            .astype(np.float32)).to(cuda)
    live = (s.edge_mask.cpu() & torch.from_numpy(
        rng.random((P, s.e_blk)) < 0.7)).to(cuda)
    before = seg_mod.segment_sum.launches
    got = seg_mod.segment_sum(msgs, live, s.agg_ptr[to])
    want = ref.segment_sum(msgs.cpu(), live.cpu(), s.agg_ptr[to].cpu())
    torch.cuda.synchronize()
    assert seg_mod.segment_sum.launches == before + 1
    assert got.shape == (P, s.v_mir, d)
    assert torch.equal(got.cpu(), want)


def test_wrappers_on_cuda_raise_instead_of_falling_back(cuda):
    g = _graph(GD, cuda, _vdata_f)
    s = g.s
    spec = mt.fused_plan(g, _send_f, "sum").kernel
    x, ev, live = _triplet_inputs(g, 2, seed=5)
    with pytest.raises(ValueError):
        tri_mod.fused_triplet(x, ev, s.src_slot.long(), s.dst_slot, live,
                              s.agg_ptr["dst"], None, spec)
    with pytest.raises(ValueError):
        seg_mod.segment_sum(torch.ones(P, s.e_blk, 1, device=cuda), live,
                            s.agg_ptr["dst"].long())


def _end_to_end(run, gd, leaf, device):
    r = run(_graph(gd, device))
    return r, r.graph.vdata[leaf].cpu()


@pytest.mark.parametrize("tol", [0.0, 1e-3])
def test_pagerank_on_card(tol, cuda):
    run = lambda g, **kw: alg.pagerank(g, num_iters=12, tol=tol,  # noqa: E731
                                       track_metrics=True, **kw)
    ops.reset_launch_counts()
    r, pr = _end_to_end(run, GD, "pr", cuda)
    counts = ops.launch_counts()
    assert counts["triplet"] >= r.supersteps + 1          # + the degree pass
    assert counts["apply"] == r.supersteps
    assert (r.metrics[0]["plan"], r.metrics[0]["apply_plan"]) == \
        ("fused", "fused_apply")
    u, pr_u = _end_to_end(lambda g: run(g, kernel_mode="unfused"), GD, "pr",
                          cuda)
    assert ops.launch_counts()["segment_sum"] > 0
    assert torch.equal(pr, pr_u) and r.supersteps == u.supersteps
    c, pr_c = _end_to_end(run, GD, "pr", "cpu")
    assert r.supersteps == c.supersteps
    torch.testing.assert_close(pr, pr_c, rtol=1e-5, atol=1e-6)


def test_connected_components_on_card(cuda):
    run = lambda g, **kw: alg.connected_components(g, **kw)  # noqa: E731
    r, cc = _end_to_end(run, SGD, "cc", cuda)
    u, cc_u = _end_to_end(lambda g: run(g, kernel_mode="unfused"), SGD, "cc",
                          cuda)
    c, cc_c = _end_to_end(run, SGD, "cc", "cpu")
    assert torch.equal(cc, cc_u) and torch.equal(cc, cc_c)
    assert r.supersteps == u.supersteps == c.supersteps


def test_more_senior_on_card(cuda):
    rng = np.random.default_rng(2)
    age = lambda g: {"a": rng.integers(18, 70, tuple(g.s.home_vid.shape))  # noqa: E731
                     .astype(np.float32)}
    g = _graph(GD, cuda, age)
    vals, exists, _, m = g.mrTriplets(_more_senior, "sum")
    uvals, uexists, _, _ = g.mrTriplets(_more_senior, "sum",
                                        kernel_mode="unfused")
    gc = _graph(GD, "cpu").replace(vdata={"a": g.vdata["a"].cpu()})
    cvals, cexists, _, _ = gc.mrTriplets(_more_senior, "sum")
    assert m["plan"] == "fused"
    assert torch.equal(exists, uexists) and torch.equal(vals["n"], uvals["n"])
    assert torch.equal(exists.cpu(), cexists)
    assert torch.equal(vals["n"].cpu(), cvals["n"])

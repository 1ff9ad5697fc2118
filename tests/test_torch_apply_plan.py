"""The fused apply's route-range table and CTA plan, on the CPU.

`apply_rng` (`kernels/applyroute.py`) gives, per home partition q and
source partition pe, where each granule of APPLY_GRAN home slots begins in
the live prefix of the route.  Its property, swept with hypothesis over
small R-MAT and random graphs, every partitioner and P in {1, 2, 3, 4, 8}:
every live route entry lies in exactly one granule range of its (q, pe),
and that range is its home slot's granule.  A route out of order is
refused.  `kernels/superstep.plan` keeps the CTA's shared memory within
the H100's 227 KB with whole granules; APPLY_GRAN is the header's.  The
apply returns a leaf the vprog passes through as the same tensor and keeps
every written leaf's dtype; the plain version, like the kernel, drops an
entry whose granule range a corrupt table cuts off.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")

from hypothesis import given, settings, strategies as st  # noqa: E402
from repro_torch.core import Graph, partition  # noqa: E402
from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.core import mrtriplets as mt  # noqa: E402
from repro_torch.data import rmat  # noqa: E402
from repro_torch.kernels import applyroute, build, ref  # noqa: E402
from repro_torch.kernels import superstep as app_mod  # noqa: E402

GRAN = applyroute.APPLY_GRAN


def _check_ranges(send, rng):
    """Every live entry of every route row in exactly one granule range,
    its home slot's."""
    p, p2, _ = send.shape
    for q in range(p):
        for pe in range(p2):
            row, r = send[q, pe], rng[q, pe]
            n = int((row >= 0).sum())
            assert r[0] == 0 and r[-1] == n and np.all(np.diff(r) >= 0)
            j = np.arange(n)
            inside = (r[:-1, None] <= j[None]) & (j[None] < r[1:, None])
            assert np.array_equal(inside.sum(axis=0), np.ones(n))
            assert np.array_equal(inside.argmax(axis=0), row[:n] // GRAN)


@settings(max_examples=30, deadline=None)
@given(kind=st.sampled_from(["rmat", "random"]),
       partitioner=st.sampled_from(["2d", "1d", "random", "hybrid"]),
       p=st.sampled_from([1, 2, 3, 4, 8]),
       scale=st.integers(4, 10), seed=st.integers(0, 2**16))
def test_apply_rng_covers_the_route(kind, partitioner, p, scale, seed):
    if kind == "rmat":
        gd = rmat(scale, 4, seed=seed)
        src, dst = gd.src, gd.dst
    else:
        r = np.random.default_rng(seed)
        n = 2 ** scale
        src, dst = r.integers(0, n, (2, 3 * n))
    s = partition.build_structure(src, dst, p, partitioner=partitioner)
    for side in ("dst", "src"):
        send, rng = s.routes[side][0], s.apply_rng[side]
        assert rng.shape == (p, p, -(-s.v_blk // GRAN) + 1)
        assert rng.dtype == np.int32
        _check_ranges(send, rng)


def test_route_ranges_refuse_a_route_out_of_order():
    gd = rmat(9, 4, seed=1)
    s = partition.build_structure(gd.src, gd.dst, 4)
    send = s.routes["dst"][0].copy()
    q, pe = np.argwhere((send >= 0).sum(axis=2) >= 2)[0]
    applyroute.route_ranges(send, s.v_blk)
    swapped = send.copy()
    swapped[q, pe, :2] = swapped[q, pe, 1::-1]
    with pytest.raises(ValueError, match="increasing"):
        applyroute.route_ranges(swapped, s.v_blk)
    gap = send.copy()
    gap[q, pe, 0] = -1
    with pytest.raises(ValueError, match="prefix"):
        applyroute.route_ranges(gap, s.v_blk)
    routes = {**s.routes, "dst": (swapped,) + s.routes["dst"][1:]}
    with pytest.raises(ValueError):
        partition.gpu_tables(s.src_slot, s.dst_slot, s.src_perm, s.edge_mask,
                             routes, s.v_mir, s.v_blk)


def test_apply_gran_matches_the_header():
    text = (build.CSRC / "applyroute.cuh").read_text()
    (value,) = re.findall(r"^#define APPLY_GRAN (\d+)$", text, re.M)
    assert int(value) == GRAN
    assert '#include "applyroute.cuh"' not in build.template("apply")
    assert "#define APPLY_GRAN" in build.template("apply")


@pytest.mark.parametrize("dv", [1, 3, 4, 60, 64, 120, 903])
def test_plan_fits_one_cta(dv):
    """At every message width the kernel takes: the CTA's slots fit 227 KB
    in whole granules, and each thread applies VB / THREADS of them (the
    kernel's per-thread loop covers no more)."""
    assert app_mod.THREADS % GRAN == 0
    for dm in range(1, app_mod.MAX_DM + 1):
        pl = app_mod.plan(dm, dv)
        assert pl.vb % GRAN == 0 and GRAN <= pl.vb <= app_mod.VB_MAX, dm
        assert pl.stride >= dm and pl.stride % 2 == 1
        assert pl.vb * (4 * pl.stride + 1) <= pl.smem
        assert pl.smem + 8 * app_mod.MAX_P <= app_mod.SMEM_LIMIT == 227 * 1024
        assert pl.lanes & (pl.lanes - 1) == 0 and pl.lanes <= 32
        assert pl.threads == min(pl.vb, app_mod.THREADS)
        assert pl.threads % 32 == 0
        assert pl.vb % pl.threads == 0 and pl.threads % pl.lanes == 0, dm
        assert pl.grid(4, 1_000_001) == (-(-1_000_001 // pl.vb), 4)


@pytest.mark.parametrize("dm, dv, vb", [(1, 3, 1024), (60, 1, 768),
                                        (60, 4, 768), (120, 120, 256),
                                        (179, 1, 256), (903, 1, 64)])
def test_plan_rounds_to_whole_threads(dm, dv, vb):
    """Where the shared memory allows a VB between multiples of THREADS
    (896 at dm 60, 448 at dm 120), the plan rounds it down."""
    assert app_mod.plan(dm, dv).vb == vb


def test_plan_refuses_what_no_cta_holds():
    assert app_mod.plan(app_mod.MAX_DM, 1).vb == GRAN
    with pytest.raises(ValueError):
        app_mod.plan(app_mod.MAX_DM + 1, 1)


def _label_vprog(vid, v, msg):
    return {"lab": torch.minimum(v["lab"], msg["m"]), "w": v["w"]}


def _label_send(sv, ev, dv):
    return {"m": sv["lab"]}


@pytest.mark.parametrize("case", ["pagerank", "cc", "int16_label"])
def test_passed_through_leaves_are_the_same_tensor(case):
    gd = rmat(8, 4, seed=2)
    g = Graph.from_edges(gd.src, gd.dst, num_partitions=4, device="cpu")
    if case == "pagerank":
        g = alg.attach_out_degree(g).mapV(alg._pr_init)
        vprog, send, reduce = alg.pagerank_vprog(0.15), alg.pagerank_send, "sum"
        dflt, mdt = 0.0, torch.float32
    elif case == "cc":
        g = g.mapV(alg._cc_init)
        vprog, send, reduce = alg.cc_vprog, alg.cc_send, "min"
        dflt, mdt = alg.IMAX, torch.int32
    else:
        g = g.mapV(lambda vid, v: {"lab": (vid % 300).to(torch.int16),
                                   "w": vid.to(torch.float32)})
        vprog, send, reduce = _label_vprog, _label_send, "min"
        dflt, mdt = 2**15 - 1, torch.int16
    plan = mt._plan_apply(g, vprog, send, reduce, None,
                          {"m": torch.tensor(dflt, dtype=mdt)}, None)
    assert plan is not None
    send_idx = g.s.routes["dst"][0]
    r = np.random.default_rng(5)
    recv = torch.from_numpy(r.integers(0, 200, tuple(send_idx.shape))).to(
        plan.msg_specs[0].dtype)
    rflags = send_idx >= 0
    for mode in ("ref", "auto"):
        new, changed = mt.fused_apply_home(g, {"m": recv}, rflags, "dst",
                                           reduce, plan, mode)
        assert changed.dtype == torch.bool
        assert changed.shape == g.vmask.shape
        written = dict(zip(sorted(g.vdata), plan.kernel.written))
        for k in g.vdata:
            assert new[k].dtype == g.vdata[k].dtype
            assert (new[k] is g.vdata[k]) == (not written[k]), k
    want = {"pagerank": {"deg": False, "pr": True, "v": False},
            "cc": {"cc": True}, "int16_label": {"lab": True, "w": False}}
    assert written == want[case]


def test_columns_the_kernel_reads():
    """Packed inequality reads every written column and every float
    column passed through (its NaN test); a changed_fn only what it and
    the vprog read."""
    gd = rmat(8, 4, seed=2)
    g = Graph.from_edges(gd.src, gd.dst, num_partitions=4, device="cpu")
    zero = {"m": torch.tensor(0.0)}
    gp = alg.attach_out_degree(g).mapV(alg._pr_init)
    k = mt._plan_apply(gp, alg.pagerank_vprog(0.15), alg.pagerank_send,
                       "sum", None, zero, None).kernel
    assert sorted(gp.vdata) == ["deg", "pr", "v"]      # all f32
    assert k.reads == frozenset(range(k.dv)) and not k.reads_vid
    gd_ = alg.attach_out_degree(g).mapV(
        lambda vid, v: {**v, "pr": torch.tensor(0.15),
                        "delta": torch.tensor(0.15)})
    vprog, chg = alg.delta_pagerank_fns(0.15, 1e-3)
    k = mt._plan_apply(gd_, vprog, alg.delta_pagerank_send, "sum", chg,
                       zero, None).kernel
    order = sorted(gd_.vdata)
    assert k.reads == frozenset({order.index("pr")})
    assert dict(zip(order, k.written))["deg"] is False
    src = app_mod.source(k, "sum")
    assert "//@" not in src and f"#define VB {app_mod.plan(1, k.dv).vb}" in src


def test_plain_drops_an_entry_a_cut_range_leaves_out():
    """Cutting one granule's range of one source partition short by one
    entry (the entry moves to the next granule's range, which is not its
    slot's) drops that message in the plain version, as in the kernel."""
    gd = rmat(10, 8, seed=3)
    g = Graph.from_edges(gd.src, gd.dst, num_partitions=4, device="cpu")
    g = alg.attach_out_degree(g).mapV(alg._pr_init)
    plan = mt._plan_apply(g, alg.pagerank_vprog(0.15), alg.pagerank_send,
                          "sum", None, {"m": torch.tensor(0.0)}, None)
    s = g.s
    send, rng = s.routes["dst"][0], s.apply_rng["dst"]
    assert rng.shape[2] >= 3
    recv = torch.from_numpy(np.random.default_rng(6).random(
        tuple(send.shape)).astype(np.float32))
    rflags = send >= 0
    args = ({"m": recv}, rflags)
    new, _ = mt.fused_apply_home(g, *args, "dst", "sum", plan, "ref")
    q, pe = 1, 2
    b = int(np.flatnonzero(np.diff(rng[q, pe, :-1].numpy()) > 0)[0]) + 1
    bad = rng.clone()
    bad[q, pe, b] -= 1
    cut = ref.fused_apply([recv], rflags, send, bad, [g.vdata[k] for k in
                                                      sorted(g.vdata)],
                          s.home_vid, g.vmask, plan.kernel, reduce="sum")[0]
    pr = sorted(g.vdata).index("pr")
    diff = (cut[pr] != new["pr"]).reshape(-1).nonzero()[:, 0].tolist()
    j = int(rng[q, pe, b]) - 1
    assert diff == [q * s.v_blk + int(send[q, pe, j])]

"""The port's multi-device executor across gloo ranks, against the reference.

The reference checks its `SpmdExchange` on 4 simulated CPU devices
(`tests/spmd_check.py`, sections (a)-(o)).  Here the port's `SpmdExchange`
runs the same sections on ranks of a `torch.distributed` gloo group, one
process a rank, at world 4 (one partition a rank, the reference's shape)
and world 2 (two a rank), P = 4, at spmd_check's sizes:

  (a) one mrTriplets over the kernel modes; (b) PageRank, 10 supersteps,
  with the view; (c) CC against union-find; (d) shuffle_by_key and
  reduce_by_key; (e)-(f) the int8 and packed-int wires; (g)-(i) fig4's
  auto, the int8 and the forced ragged transports with the overflow
  fallback; (j) the warm and the cold chain; (k) run_chain(optimize=True);
  (l) the ring pipeline; (m) transient and persistent wire faults, kill and
  warm resume, elastic restore onto 2 ranks; (n) the hybrid cut with the
  broadcast lane; (o) working set 0.5.

Each section is one function of an executor context (`LocalCtx`: one
process, `LocalExchange`; `RankCtx`: a rank, `SpmdExchange`), which builds
the graphs on the host, places them, runs the section and returns its
results gathered to the global layout and psummed.  The ranks run in a
subprocess (this file's `__main__`, through `utils.spmd.run_ranks`) that
imports no JAX; the pytest process runs the same sections over
`LocalExchange` and computes the reference's `LocalExchange` results with
JAX (spmd_check already pins the reference's `SpmdExchange` to those).

The gathered states, superstep counts, psummed bytes, ship counts, wire
logs, fault counters and snapshot files equal the port's one-process run
bit for bit.  Against the reference: f32, integer and packed-int states
and every byte count are equal bit for bit at these sizes; int8 runs
within spmd_check's 1e-3 on the normalised ranks of the f32 run (the
reference's CPU exp2, ROADMAP Queue 3).
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import os
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch.distributed as dist  # noqa: E402

from repro_torch.core import Col, Graph, with_wire  # noqa: E402
from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.core import capture  # noqa: E402
from repro_torch.core import snapshot as snap  # noqa: E402
from repro_torch.core import spill as spill_mod  # noqa: E402
from repro_torch.core import transport as tm  # noqa: E402
from repro_torch.core.collections import shuffle_by_key  # noqa: E402
from repro_torch.core.exchange import LocalExchange, SpmdExchange  # noqa: E402
from repro_torch.core.fault import FaultPlan, FaultyExchange  # noqa: E402
from repro_torch.core.mrtriplets import mr_triplets  # noqa: E402
from repro_torch.core.planner import MapV, MrTriplets, run_chain  # noqa: E402
from repro_torch.data import rmat, symmetrize  # noqa: E402
from repro_torch.launch.mesh import in_group, make_restore_mesh  # noqa: E402
from repro_torch.utils.spmd import run_ranks, shard  # noqa: E402

P = 4
WORLDS = (4, 2)
RANK_TIMEOUT = 120          # seconds a subprocess of ranks may take
IMAX = 2**31 - 1
RANK_ERR = 1e-3

AUTO_POL = tm.TransportPolicy("auto", cap_rounding=8, enter_frac=0.95,
                              exit_frac=0.97)
CC_POL = tm.TransportPolicy("ragged", capacity_frac=0.5, cap_rounding=8)
TIERED = tm.TransportPolicy(kind="ragged", capacity_frac=1.0,
                            capacity_frac_back=1.0,
                            capacity_fracs=(0.5,) * P,
                            capacity_fracs_back=(0.5,) * P)


# ---------------------------------------------------------------------------
# UDFs (spmd_check's, module level: the plan caches key on the function)
# ---------------------------------------------------------------------------
def send(sv, ev, dv):
    return {"m": sv["pr"] / sv["deg"] * ev["w"]}


def vprog(vid, v, msg):
    return {**v, "pr": 0.15 + 0.85 * msg["m"]}


def cc_send(sv, ev, dv):
    return {"m": sv["cc"]}


def cc_vprog(vid, v, msg):
    return {"cc": torch.minimum(v["cc"], msg["m"])}


def dsend(sv, ev, dv):
    return {"m": sv["delta"] / sv["deg"] * ev["w"]}


def dvprog(vid, v, msg):
    new_pr = v["pr"] + 0.85 * msg["m"]
    return {"deg": v["deg"], "pr": new_pr, "delta": new_pr - v["pr"]}


def dchg(old, new):
    return torch.abs(new["pr"] - old["pr"]) > 2e-3


def send_both(sv, ev, dv):
    return {"m": sv["pr"] * ev["w"] + dv["deg"]}


def send_src(sv, ev, dv):
    return {"m": sv["pr"] * ev["w"]}


def _pr1(vid, v):
    return {**v, "pr": torch.tensor(1.0)}


def _pr2(vid, v):
    return {**v, "pr": v["pr"] * 2.0}


def _pr_plus(vid, v):
    return {**v, "pr": v["pr"] + 1.0}


def _cc_id(vid, v):
    return {"cc": vid}


def _dp_init(vid, v):
    return {"deg": v["deg"], "pr": torch.tensor(0.15),
            "delta": torch.tensor(0.15)}


def _below4(vid, v):
    return v["pr"] < 4.0


ZERO = {"m": torch.tensor(0.0)}
IMAX_MSG = {"m": torch.tensor(IMAX, dtype=torch.int32)}


# ---------------------------------------------------------------------------
# The graphs (built on the host, the same on every process)
# ---------------------------------------------------------------------------
def _edges(name):
    return {"g": lambda: rmat(6, 4, seed=0),
            "sg": lambda: symmetrize(rmat(5, 3, seed=2)),
            "gdp": lambda: rmat(8, 6, seed=0),
            "ng": lambda: rmat(9, 10, seed=2),
            "nsg": lambda: symmetrize(rmat(9, 10, seed=2))}[name]()


def build(name, **kw):
    gd = _edges(name)
    g = Graph.from_edges(gd.src, gd.dst, num_partitions=P, device="cpu", **kw)
    if name in ("g", "gdp", "ng"):
        g = alg.attach_out_degree(g, kernel_mode="ref")
    if name in ("g", "ng"):
        return g.mapV(_pr1)
    if name == "gdp":
        return g.mapV(_dp_init)
    return g.mapV(_cc_id)


# ---------------------------------------------------------------------------
# Executor contexts
# ---------------------------------------------------------------------------
class LocalCtx:
    """One process holding every partition (`LocalExchange`)."""

    rank, world = 0, 1

    def exchange(self, p):
        return LocalExchange(p)

    def place(self, g):
        return g.replace(ex=self.exchange(g.s.p))

    def place_col(self, col):
        return dataclasses.replace(col, ex=self.exchange(col.keys.shape[0]))

    def gather(self, t):
        return t

    def psum(self, x):
        return torch.as_tensor(x)

    def pmax(self, x):
        return torch.as_tensor(x)

    def uniform(self, x) -> float:
        """A count every rank keeps alike (the collectives it joined, the
        faults its psummed verdicts saw): its value, checked equal on every
        rank."""
        top = _f(self.pmax(torch.as_tensor(x, dtype=torch.float64)))
        total = _f(self.psum(torch.as_tensor(x, dtype=torch.float64)))
        assert total == self.world * top, (total, self.world, top)
        return top


class RankCtx(LocalCtx):
    """One rank of the default gloo group (`SpmdExchange`)."""

    def __init__(self, rank, world):
        self.rank, self.world = rank, world

    def exchange(self, p, group=None):
        return SpmdExchange(p, group)

    def place(self, g):
        return shard(g, self.rank, self.world).replace(
            ex=self.exchange(g.s.p))

    def place_col(self, col):
        return dataclasses.replace(shard(col, self.rank, self.world),
                                   ex=self.exchange(col.keys.shape[0]))

    def gather(self, t):
        ex = SpmdExchange(t.shape[0] * self.world)
        return ex.all_gather_rows(t.contiguous())[0]

    def psum(self, x):
        return SpmdExchange(self.world).psum(torch.as_tensor(x))

    def pmax(self, x):
        return SpmdExchange(self.world).pmax(torch.as_tensor(x))


def _np(t):
    return t.detach().cpu().numpy().copy()


def _f(x) -> float:
    return float(torch.as_tensor(x))


def steps(g, vp, sm, gather, dmsg, n, *, skip_stale=None, changed_fn=None,
          kernel_mode="auto", transport=None):
    """`n` supersteps of pregel's `_superstep` (spmd_check's loops): the
    graph and each superstep's metrics."""
    pm = importlib.import_module("repro_torch.core.pregel")
    step = pm._step_fn(g, vp, sm, gather, default_msg=dmsg,
                       skip_stale=skip_stale, changed_fn=changed_fn,
                       kernel_mode=kernel_mode, incremental=True,
                       payload_bound=None, fuse_apply="auto")
    ms = []
    for _ in range(n):
        g, _live, m = step(g, transport=transport)
        ms.append(m)
    return g, ms


def pr_loop(g, mode="auto", n=10, transport=None):
    return steps(g, vprog, send, "sum", ZERO, n, kernel_mode=mode,
                 transport=transport)


def cc_loop(g, mode="auto", n=10, transport=None):
    return steps(g, cc_vprog, cc_send, "min", IMAX_MSG, n, skip_stale="out",
                 kernel_mode=mode, transport=transport)


def run_delta_pr(ctx, g0, spec, mode="auto", n_steps=30):
    """pregel's host loop open-coded (spmd_check's run_delta_pr): the
    policy re-planned each superstep from the psummed live count and the
    pmaxed route occupancies."""
    pm = importlib.import_module("repro_torch.core.pregel")
    tpol = tm.resolve_transport(spec)
    step = pm._step_fn(g0, dvprog, dsend, "sum", default_msg=ZERO,
                       skip_stale="out", changed_fn=dchg, kernel_mode=mode,
                       incremental=True, payload_bound=None, fuse_apply="auto")
    n_vis = int(ctx.psum(g0.vmask.sum()))
    g, rows = g0, []
    cur = tm.DENSE if tpol.kind == "auto" else tpol
    for _ in range(n_steps):
        g, live, m = step(g, transport=cur)
        fwd, back = m["fwd"], m["back"]
        # one psum and one pmax a superstep
        live, shipped, accounted = ctx.psum(torch.stack([
            torch.as_tensor(x, dtype=torch.float64) for x in (
                live, fwd.bytes_shipped + back.bytes_shipped,
                fwd.bytes_accounted + back.bytes_accounted)])).tolist()
        ffrac, bfrac = ctx.pmax(torch.stack([
            torch.as_tensor(r.route_active_max, dtype=torch.float32)
            / max(r.route_width, 1) for r in (fwd, back)])).tolist()
        live = int(live)
        rows.append({"live": live, "kind": cur.kind,
                     "ragged": _f(fwd.ragged), "shipped": shipped,
                     "accounted": accounted})
        if live == 0:
            break
        if tpol.kind == "auto":
            cur = tm.adapt_policy(tpol, was_ragged=cur.kind == "ragged",
                                  active_frac=live / n_vis, fwd_frac=ffrac,
                                  back_frac=bfrac)
    return g, rows


def _bytes(ctx, ms, field="bytes_shipped"):
    """Per superstep, both routes' bytes summed over the ranks."""
    return [_f(ctx.psum(torch.as_tensor(
        getattr(m["fwd"], field) + getattr(m["back"], field),
        dtype=torch.float64))) for m in ms]


def _log(ctx, g):
    """The graph's wire log: its ship count (rank 0's, the largest: it also
    holds the global log's count from before the shard) and its bytes
    summed over the ranks."""
    log = g.wire_log
    return [_f(ctx.pmax(log.ships.sum()))] + [
        _f(ctx.psum(getattr(log, f).sum().double()))
        for f in ("bytes_shipped", "bytes_accounted")]


# ---------------------------------------------------------------------------
# The sections
# ---------------------------------------------------------------------------
def sec_a(ctx):
    g = ctx.place(build("g"))
    out = {}
    for mode in ("unfused", "ref", "auto"):
        vals, exists, _, m = mr_triplets(g, send, "sum", kernel_mode=mode)
        out[mode] = (_np(ctx.gather(vals["m"])), _np(ctx.gather(exists)),
                     m["plan"], _f(ctx.psum(m["bytes_shipped"])))
    return out


def sec_b(ctx):
    g, ms = pr_loop(ctx.place(build("g")))
    return {"pr": _np(ctx.gather(g.vdata["pr"])), "bytes": _bytes(ctx, ms),
            "log": _log(ctx, g)}


def sec_c(ctx):
    g, ms = cc_loop(ctx.place(build("sg")))
    return {"cc": _np(ctx.gather(g.vdata["cc"])), "bytes": _bytes(ctx, ms)}


def sec_d(ctx):
    keys = np.arange(64, dtype=np.int32) % 13
    vals = np.arange(64, dtype=np.float32)
    col = ctx.place_col(Col.from_numpy(keys, {"v": vals}, p=P, device="cpu"))
    kk, vv, mm, ovf = shuffle_by_key(col.keys, col.values, col.mask, col.ex,
                                     capacity=128)
    red, ovf_r = col.reduce_by_key("sum")
    return {"shuffle": (_np(ctx.gather(kk)), _np(ctx.gather(vv["v"])),
                        _np(ctx.gather(mm)), int(ovf)),
            "reduce": (_np(ctx.gather(red.keys)),
                       _np(ctx.gather(red.values["v"])),
                       _np(ctx.gather(red.mask)), int(ovf_r))}


def sec_e(ctx):
    g = ctx.place(build("g"))
    g8 = g.replace(ex=with_wire(g.ex, "int8"))
    out = {}
    for mode in ("auto", "unfused"):
        gg, ms = pr_loop(g8, mode)
        out[mode] = _np(ctx.gather(gg.vdata["pr"]))
    for key, gg in (("bow_f32", g), ("bow_int8", g8)):
        _, _, _, m = mr_triplets(gg, send, "sum", kernel_mode="auto")
        out[key] = _f(ctx.psum(torch.as_tensor(m["bytes_on_wire"],
                                               dtype=torch.float64)))
    return out


def sec_f(ctx):
    sg = ctx.place(build("sg"))
    g, ms = cc_loop(sg.replace(ex=with_wire(sg.ex, "int8", delta=True)))
    return {"cc": _np(ctx.gather(g.vdata["cc"])), "bytes": _bytes(ctx, ms)}


def sec_g(ctx):
    gdp = ctx.place(build("gdp"))
    out = {}
    for key, spec, mode in (("dense", None, "auto"),
                            ("auto", AUTO_POL, "auto"),
                            ("auto_unfused", AUTO_POL, "unfused")):
        g, rows = run_delta_pr(ctx, gdp, spec, mode)
        out[key] = (_np(ctx.gather(g.vdata["pr"])), rows)
    # the user's entry point: pregel re-plans from the group's read
    r = importlib.import_module("repro_torch.core.pregel").pregel(
        gdp, dvprog, dsend, "sum", default_msg=ZERO, max_supersteps=30,
        changed_fn=dchg, transport=AUTO_POL, track_metrics=True)
    out["pregel"] = (_np(ctx.gather(r.graph.vdata["pr"])), r.supersteps,
                     [m["transport"] for m in r.metrics], _log(ctx, r.graph))
    return out


def sec_h(ctx):
    gdp = ctx.place(build("gdp"))
    g8 = gdp.replace(ex=with_wire(gdp.ex, "int8"))
    g, rows = run_delta_pr(ctx, g8, AUTO_POL)
    return {"pr": _np(ctx.gather(g.vdata["pr"])), "rows": rows}


def sec_i(ctx):
    sg = ctx.place(build("sg"))
    sg8 = sg.replace(ex=with_wire(sg.ex, "int8", delta=True))
    g, ms = cc_loop(sg8, transport=CC_POL)
    return {"cc": _np(ctx.gather(g.vdata["cc"])), "bytes": _bytes(ctx, ms),
            "ragged": [_f(m["fwd"].ragged) for m in ms],
            "overflow": [_f(m["fwd"].overflow) for m in ms]}


def _chain(g, cold, mode):
    strip = (lambda x: x.replace(view=None)) if cold else (lambda x: x)
    _, _, g, m1 = g.mrTriplets(send, "sum", kernel_mode=mode)
    g = strip(g).mapV(_pr2)
    _, _, g, m2 = g.mrTriplets(send, "sum", kernel_mode=mode)
    g = strip(strip(g).subgraph(vpred=_below4))
    v3, e3, g, m3 = g.mrTriplets(send, "sum", kernel_mode=mode)
    return v3["m"], e3, (m1["fwd"].bytes_shipped + m2["fwd"].bytes_shipped
                         + m3["fwd"].bytes_shipped)


def sec_j(ctx):
    g = ctx.place(build("g"))
    out = {}
    for mode in ("auto", "unfused"):
        for cold in (True, False):
            v, e, b = _chain(g, cold, mode)
            out[mode, cold] = (_np(ctx.gather(v)), _np(ctx.gather(e)),
                               _f(ctx.psum(torch.as_tensor(
                                   b, dtype=torch.float64))))
    return out


CHAIN = (MapV(_pr_plus), MrTriplets(send_src, "sum"),
         MrTriplets(send_src, "sum"))


def sec_k(ctx):
    out = {}
    for opt in (True, False):
        g = ctx.place(build("g"))
        _, _, g, _ = g.mrTriplets(send_both, "sum")      # both-dir warm fill
        base = g.bytes_shipped
        res = run_chain(g, CHAIN, optimize=opt)
        vals, exists, _ = res.outputs[-1]
        out[opt] = (_np(ctx.gather(vals["m"])), _np(ctx.gather(exists)),
                    _f(ctx.psum((res.graph.bytes_shipped - base).double())),
                    [r["bytes_shipped_total"] for r in res.step_metrics])
    return out


def sec_l(ctx):
    sg = ctx.place(build("sg"))
    sg8 = sg.replace(ex=with_wire(sg.ex, "int8", delta=True))
    out = {}
    for gkey, graph in (("f32", sg), ("int8", sg8)):
        for mode in ("auto", "unfused"):
            for tkey, tp0 in (("dense", tm.DENSE), ("ragged", CC_POL)):
                g, ms = cc_loop(graph, mode, transport=tp0.replace(
                    pipeline=True))
                out[gkey, mode, tkey] = (_np(ctx.gather(g.vdata["cc"])),
                                         _bytes(ctx, ms))
    # warm re-entry: leave one loop with the view riding the graph, enter
    # another under the pipelined schedule
    for pipe in (False, True):
        tp = tm.DENSE.replace(pipeline=pipe)
        g_mid, _ = cc_loop(sg, n=4, transport=tp)
        assert g_mid.view is not None
        g_end, _ = cc_loop(g_mid, n=6, transport=tp)
        out["warm", pipe] = _np(ctx.gather(g_end.vdata["cc"]))
    gdp = ctx.place(build("gdp"))
    for key, spec in (("dense", tm.DENSE.replace(pipeline=True)),
                      ("auto", AUTO_POL.replace(pipeline=True))):
        g, rows = run_delta_pr(ctx, gdp, spec)
        out["delta", key] = (_np(ctx.gather(g.vdata["pr"])), rows)
    return out


DENSE_CHK = tm.DENSE.replace(integrity=True)
RAGGED_CHK = CC_POL.replace(integrity=True)


def _pr_chk(ctx, g, transport):
    g, ms = pr_loop(g, n=6, transport=transport)
    faults = sum(_f(m["fwd"].wire_faults) + _f(m["back"].wire_faults)
                 for m in ms)
    degraded = sum(_f(m["fwd"].degraded) + _f(m["back"].degraded)
                   for m in ms)
    return (_np(ctx.gather(g.vdata["pr"])), ctx.uniform(faults),
            ctx.uniform(degraded), _bytes(ctx, ms))


class _Guard:
    """A preemption guard, tripped from the start or never."""

    def __init__(self, requested):
        self.requested = requested


def sec_m(ctx, ckdir):
    out = {}
    g = ctx.place(build("g"))
    out["clean"] = _pr_chk(ctx, g, DENSE_CHK)

    def faulty(graph, plan):
        return graph.replace(ex=FaultyExchange(ctx.exchange(P), plan))

    out["transient"] = _pr_chk(ctx, faulty(g, FaultPlan(
        mode="corrupt", attempts=(0,))), DENSE_CHK)
    out["persistent"] = _pr_chk(ctx, faulty(g, FaultPlan(
        mode="corrupt", attempts=(0, 1))), DENSE_CHK)
    sg = ctx.place(build("sg"))
    gz, ms = cc_loop(faulty(sg, FaultPlan(mode="zero", route=(2, 1),
                                          attempts=(0,))),
                     transport=RAGGED_CHK)
    out["route_loss"] = (_np(ctx.gather(gz.vdata["cc"])),
                         ctx.uniform(sum(_f(m["fwd"].wire_faults)
                                         + _f(m["back"].wire_faults)
                                         for m in ms)))

    # kill after 4 supersteps, snapshot, warm restore into a fresh graph
    g_mid, _ = cc_loop(sg, n=4)
    store = snap.SnapshotStore(os.path.join(ckdir, "cc"))
    snap.save_pregel(store, 4, g_mid, tm.DENSE, live=1)
    arrays, manifest = store.read(4)
    out["files"] = (arrays, {k: v for k, v in manifest.items()
                             if k != "wall_time"})
    g_res, start, pol, _ = snap.restore_pregel(store, ctx.place(build("sg")))
    g_end, _ = cc_loop(g_res, n=6)
    out["resumed"] = (start, pol.kind, _np(ctx.gather(g_end.vdata["cc"])))

    # pregel's own snapshots: a guard tripped on rank 0 alone stops every
    # rank at the first boundary, and the rerun resumes to the labels
    pm = importlib.import_module("repro_torch.core.pregel")
    ck = os.path.join(ckdir, "pregel")
    kw = dict(default_msg=IMAX_MSG, max_supersteps=10, checkpoint=ck)
    r1 = pm.pregel(ctx.place(build("sg")), cc_vprog, cc_send, "min",
                   guard=_Guard(ctx.rank == 0), **kw)
    r2 = pm.pregel(ctx.place(build("sg")), cc_vprog, cc_send, "min", **kw)
    out["pregel_resume"] = (ctx.uniform(r1.supersteps),
                            _np(ctx.gather(r2.graph.vdata["cc"])))

    # warm restore ships fewer psummed bytes than a cold one (delta PR:
    # its deg leaf is clean)
    gdp = ctx.place(build("gdp"))
    store_pr = snap.SnapshotStore(os.path.join(ckdir, "pr"))
    g3, _ = steps(gdp, dvprog, dsend, "sum", ZERO, 3, skip_stale="out",
                  changed_fn=dchg)
    snap.save_pregel(store_pr, 3, g3, tm.DENSE, live=1)
    g_pr, _, _, _ = snap.restore_pregel(store_pr, gdp)
    warm, cold = (_bytes(ctx, steps(gg, dvprog, dsend, "sum", ZERO, 1,
                                    skip_stale="out", changed_fn=dchg)[1])[0]
                  for gg in (g_pr, g_pr.replace(view=None)))
    out["warm_cold"] = (warm, cold)

    # elastic: the 4-partition snapshot onto 2 ranks (2 partitions)
    group = make_restore_mesh(2) if ctx.world > 1 else None
    if ctx.world == 1 or in_group(group):
        ex2 = (LocalExchange(2) if ctx.world == 1
               else SpmdExchange(2, group))
        g2, start2, _, _ = snap.restore_pregel_elastic(
            store, num_partitions=2, ex=ex2, device="cpu")
        g2e, _ = cc_loop(g2, n=8)
        gather2 = (lambda t: t) if ctx.world == 1 else (
            lambda t: SpmdExchange(2, group).all_gather_rows(t)[0])
        # a rank holds its own rows alone: no tensor views a larger
        # storage (the global rebuild stays on the host and goes)
        own = ctx.world == 1 or all(
            t.untyped_storage().nbytes() == t.numel() * t.element_size()
            for t in capture.flatten(g2.replace(ex=None))[0])
        out["elastic"] = (start2, g2.s.p, _np(gather2(g2e.vdata["cc"])),
                          _np(gather2(g2e.s.home_vid)),
                          _np(gather2(g2e.vmask)), own)
    return out


def sec_n(ctx):
    out = {}
    for key, kw, tp in (("2d", {}, tm.DENSE),
                        ("hyb", {"partitioner": "hybrid",
                                 "bcast_min_repl": 3}, TIERED)):
        g0 = build("ng", **kw)
        assert key == "2d" or (g0.host.stats.threshold == 0
                               and g0.host.stats.n_broadcast > 0)
        g, ms = pr_loop(ctx.place(g0), n=5, transport=tp)
        sgd = _edges("nsg")
        c0 = Graph.from_edges(sgd.src, sgd.dst, num_partitions=P,
                              device="cpu", **kw).mapV(_cc_id)
        c, cms = cc_loop(ctx.place(c0), n=8, transport=tp)
        out[key] = {"pr": _np(ctx.gather(g.vdata["pr"])),
                    "pr_bytes": sum(_bytes(ctx, ms)),
                    "cc": _np(ctx.gather(c.vdata["cc"])),
                    "cc_bytes": sum(_bytes(ctx, cms)),
                    "ragged": ctx.uniform(sum(_f(m["fwd"].ragged)
                                              for m in cms)),
                    "home_vid": _np(g0.s.home_vid),
                    "home_mask": _np(g0.s.home_mask),
                    "cc_home_vid": _np(c0.s.home_vid),
                    "cc_home_mask": _np(c0.s.home_mask)}
    return out


def _oc_loop(ctx, g0, frac, *, vp, sm, gather, dmsg, chg, n_steps):
    """pregel's spill ring open-coded around the supersteps (spmd_check's
    oc_loop): each rank's ring over its rows."""
    pm = importlib.import_module("repro_torch.core.pregel")
    step = pm._step_fn(g0, vp, sm, gather, default_msg=dmsg,
                       skip_stale="out", changed_fn=chg, kernel_mode="auto",
                       incremental=True, payload_bound=None,
                       fuse_apply="auto")
    ring = None
    g = g0
    if frac < 1.0:
        ring = spill_mod.SpillRing(plan=spill_mod.plan_spill(g0, frac))
        g = ring.own(g0)
    resid, stream = [], []
    for _ in range(n_steps):
        if ring is not None:
            g = ring.restore(g)
        g, _, _ = step(g)
        if ring is not None:
            g = ring.spill(g)
            resid.append(_f(ctx.psum(ring.resident_bytes(g))))
            stream.append(_f(ctx.psum(ring.stream_times(g)["stream_bytes"])))
    host = 0.0
    if ring is not None:
        host = _f(ctx.psum(ring.host_bytes()))
        g = ring.materialize(g)
    return g, resid, stream, host


def sec_o(ctx):
    out = {}
    gdp = ctx.place(build("gdp"))
    pr_kw = dict(vp=dvprog, sm=dsend, gather="sum", dmsg=ZERO, chg=dchg,
                 n_steps=6)
    for frac in (1.0, 0.5):
        g, resid, stream, host = _oc_loop(ctx, gdp, frac, **pr_kw)
        out["pr", frac] = (_np(ctx.gather(g.vdata["pr"])),
                           _np(ctx.gather(g.vdata["delta"])), resid, stream,
                           host)
    plan = spill_mod.plan_spill(gdp, 0.5)
    out["plan"] = (plan.nl, plan.n_cells, plan.n_cold, plan.n_total)
    out["full_b"] = _f(ctx.psum(spill_mod.vdata_nbytes(gdp.vdata)))
    sg = ctx.place(build("sg"))
    cc_kw = dict(vp=cc_vprog, sm=cc_send, gather="min", dmsg=IMAX_MSG,
                 chg=None, n_steps=10)
    for frac in (1.0, 0.5):
        g, resid, stream, host = _oc_loop(ctx, sg, frac, **cc_kw)
        out["cc", frac] = (_np(ctx.gather(g.vdata["cc"])), resid, stream,
                           host)
    out["cc_full_b"] = _f(ctx.psum(spill_mod.vdata_nbytes(sg.vdata)))
    return out


SECTIONS = {"a": sec_a, "b": sec_b, "c": sec_c, "d": sec_d, "e": sec_e,
            "f": sec_f, "g": sec_g, "h": sec_h, "i": sec_i, "j": sec_j,
            "k": sec_k, "l": sec_l, "m": sec_m, "n": sec_n, "o": sec_o}


def run_sections(ctx, ckdir) -> dict:
    out = {}
    for name, fn in SECTIONS.items():
        out[name] = fn(ctx, ckdir) if name == "m" else fn(ctx)
    return out


# ---------------------------------------------------------------------------
# The reference's LocalExchange runs of the same sections (JAX, pytest only)
# ---------------------------------------------------------------------------
class Reference:
    """Each section's reference results, computed once on first use.  The
    supersteps run jitted, one program per configuration."""

    def __init__(self):
        import jax
        import jax.numpy as jnp
        from repro import data as rdata
        from repro.core import Graph as RG
        from repro.core import algorithms as ralg
        self.jax, self.jnp, self.RG, self.ralg = jax, jnp, RG, ralg
        self.rmat, self.symmetrize = rdata.rmat, rdata.symmetrize
        self._jits, self._done = {}, {}
        self.send = lambda sv, ev, dv: {"m": sv["pr"] / sv["deg"] * ev["w"]}
        self.vprog = lambda vid, v, m: {**v, "pr": 0.15 + 0.85 * m["m"]}
        self.cc_send = lambda sv, ev, dv: {"m": sv["cc"]}
        self.cc_vprog = lambda vid, v, m: {"cc": jnp.minimum(v["cc"],
                                                             m["m"])}
        self.dsend = lambda sv, ev, dv: {
            "m": sv["delta"] / sv["deg"] * ev["w"]}

        def dvprog(vid, v, msg):
            new_pr = v["pr"] + 0.85 * msg["m"]
            return {"deg": v["deg"], "pr": new_pr, "delta": new_pr - v["pr"]}
        self.dvprog = dvprog
        self.dchg = lambda old, new: jnp.abs(new["pr"] - old["pr"]) > 2e-3
        self.zero = {"m": jnp.float32(0.0)}
        self.imax = {"m": jnp.int32(IMAX)}

    # the reference's programs are small and run once: compile them fast
    FAST = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}

    def jit(self, fn):
        return self.jax.jit(fn, compiler_options=self.FAST)

    def __call__(self, name):
        if name not in self._done:
            self._done[name] = getattr(self, "sec_" + name)()
        return self._done[name]

    # ---- graphs, policies and loops ---------------------------------------
    def edges(self, name):
        return {"g": lambda: self.rmat(6, 4, seed=0),
                "sg": lambda: self.symmetrize(self.rmat(5, 3, seed=2)),
                "gdp": lambda: self.rmat(8, 6, seed=0),
                "ng": lambda: self.rmat(9, 10, seed=2),
                "nsg": lambda: self.symmetrize(self.rmat(9, 10, seed=2))
                }[name]()

    def graph(self, name, **kw):
        jnp, gd = self.jnp, self.edges(name)
        g = self.RG.from_edges(gd.src, gd.dst, num_partitions=P, **kw)
        if name in ("g", "gdp", "ng"):
            g = self.ralg.attach_out_degree(g, kernel_mode="ref")
        if name in ("g", "ng"):
            return g.mapV(lambda vid, v: {**v, "pr": jnp.float32(1.0)})
        if name == "gdp":
            return g.mapV(lambda vid, v: {"deg": v["deg"],
                                          "pr": jnp.float32(0.15),
                                          "delta": jnp.float32(0.15)})
        return g.mapV(lambda vid, v: {"cc": vid})

    @staticmethod
    def policy(tp):
        from repro.core.transport import TransportPolicy
        return None if tp is None else TransportPolicy(
            **dataclasses.asdict(tp))

    def wire(self, g, codec, **kw):
        from repro.core import with_wire as rww
        return dataclasses.replace(g, ex=rww(g.ex, codec, **kw))

    def step_fn(self, kind, transport=None, mode="auto"):
        """A jitted superstep of one configuration ("pr", "cc", "delta")."""
        from repro.core.pregel import _superstep
        key = (kind, repr(transport), mode)
        if key not in self._jits:
            kw = {"pr": dict(vprog=self.vprog, send_msg=self.send,
                             gather="sum", default_msg=self.zero,
                             skip_stale=None, changed_fn=None),
                  "cc": dict(vprog=self.cc_vprog, send_msg=self.cc_send,
                             gather="min", default_msg=self.imax,
                             skip_stale="out", changed_fn=None),
                  "delta": dict(vprog=self.dvprog, send_msg=self.dsend,
                                gather="sum", default_msg=self.zero,
                                skip_stale="out", changed_fn=self.dchg)}[kind]
            kw.update(kernel_mode=mode, use_cache=True,
                      transport=self.policy(transport))
            self._jits[key] = self.jit(
                lambda gg, _kw=kw: _superstep(gg, None, **_kw))
        return self._jits[key]

    def steps(self, g, kind, n, transport=None, mode="auto"):
        fn = self.step_fn(kind, transport, mode)
        ms = []
        for _ in range(n):
            g, _live, m = fn(g)
            ms.append(m)
        return g, ms

    @staticmethod
    def bytes(ms, field="bytes_shipped"):
        return [float(np.float64(getattr(m["fwd"], field))
                      + np.float64(getattr(m["back"], field))) for m in ms]

    def delta_loop(self, g, spec, n_steps=30):
        from repro.core import transport as rtm
        tpol = self.policy(tm.resolve_transport(spec))
        n_vis = int(np.asarray(g.vmask).sum())
        rows = []
        cur = rtm.DENSE if tpol.kind == "auto" else tpol
        for _ in range(n_steps):
            g, live, m = self.step_fn("delta", cur)(g)
            fwd, back = m["fwd"], m["back"]
            live = int(live)
            rows.append({
                "live": live, "kind": cur.kind, "ragged": float(fwd.ragged),
                "shipped": float(np.float64(fwd.bytes_shipped)
                                 + np.float64(back.bytes_shipped)),
                "accounted": float(np.float64(fwd.bytes_accounted)
                                   + np.float64(back.bytes_accounted))})
            if live == 0:
                break
            if tpol.kind == "auto":
                ff = float(np.float32(fwd.route_active_max)
                           / np.float32(max(fwd.route_width, 1)))
                bf = float(np.float32(back.route_active_max)
                           / np.float32(max(back.route_width, 1)))
                cur = rtm.adapt_policy(tpol, was_ragged=cur.kind == "ragged",
                                       active_frac=live / n_vis,
                                       fwd_frac=ff, back_frac=bf)
        return np.asarray(g.vdata["pr"]), rows

    # ---- the sections -------------------------------------------------------
    def sec_a(self):
        from repro.core.mrtriplets import mr_triplets as rmrt
        vals, exists, byt = self.jit(lambda gg: (lambda r: (
            r[0]["m"], r[1], r[3]["bytes_shipped"]))(rmrt(
                gg, self.send, "sum", kernel_mode="unfused")))(
                    self.graph("g"))
        return np.asarray(vals), np.asarray(exists), float(byt)

    def sec_b(self):
        g, ms = self.steps(self.graph("g"), "pr", 10)
        log = g.wire_log
        return {"pr": np.asarray(g.vdata["pr"]), "bytes": self.bytes(ms),
                "log": [float(np.asarray(getattr(log, f)).sum()) for f in
                        ("ships", "bytes_shipped", "bytes_accounted")]}

    def _uf(self, name):
        gd = self.edges(name)
        g = self.graph(name)
        vids = np.asarray(g.s.home_vid)[np.asarray(g.vmask)]
        return self.ralg.connected_components_reference(gd.src, gd.dst, vids)

    def sec_c(self):
        g, ms = self.steps(self.graph("sg"), "cc", 10)
        return {"cc": np.asarray(g.vdata["cc"]), "bytes": self.bytes(ms),
                "uf": self._uf("sg")}

    def sec_d(self):
        from repro.core import Col as RCol
        from repro.core.collections import shuffle_by_key as rshuffle
        keys = np.arange(64, dtype=np.int32) % 13
        vals = np.arange(64, dtype=np.float32)
        col = RCol.from_numpy(keys, {"v": vals}, p=P)

        def both(k, v, m):
            c = dataclasses.replace(col, keys=k, values=v, mask=m)
            red, ovf_r = c.reduce_by_key("sum")
            return (rshuffle(k, v, m, col.ex, 128),
                    (red.keys, red.values, red.mask, ovf_r))
        (kk, vv, mm, ovf), (rk, rv, rm, ovf_r) = self.jit(both)(
            col.keys, col.values, col.mask)
        return {"shuffle": (np.asarray(kk), np.asarray(vv["v"]),
                            np.asarray(mm), int(ovf)),
                "reduce": (np.asarray(rk), np.asarray(rv["v"]),
                           np.asarray(rm), int(ovf_r))}

    def sec_e(self):
        from repro.core.mrtriplets import mr_triplets as rmrt
        g = self.graph("g")
        out = {}
        for key, gg in (("bow_f32", g), ("bow_int8", self.wire(g, "int8"))):
            out[key] = float(self.jit(lambda x: rmrt(
                x, self.send, "sum", kernel_mode="auto")[3]["bytes_on_wire"])(
                    gg))
        return out

    def sec_f(self):
        g, ms = self.steps(self.wire(self.graph("sg"), "int8", delta=True),
                           "cc", 10)
        return {"cc": np.asarray(g.vdata["cc"]), "bytes": self.bytes(ms)}

    def sec_g(self):
        return {"dense": self.delta_loop(self.graph("gdp"), None),
                "auto": self.delta_loop(self.graph("gdp"), AUTO_POL)}

    def sec_i(self):
        g, ms = self.steps(self.wire(self.graph("sg"), "int8", delta=True),
                           "cc", 10, transport=CC_POL)
        return {"cc": np.asarray(g.vdata["cc"]), "bytes": self.bytes(ms),
                "ragged": [float(m["fwd"].ragged) for m in ms],
                "overflow": [float(m["fwd"].overflow) for m in ms]}

    def sec_j(self):
        jnp = self.jnp

        def chain(gg, cold):
            strip = ((lambda x: dataclasses.replace(x, view=None)) if cold
                     else (lambda x: x))
            _, _, gg, m1 = gg.mrTriplets(self.send, "sum")
            gg = strip(gg).mapV(lambda vid, v: {**v, "pr": v["pr"] * 2.0})
            _, _, gg, m2 = gg.mrTriplets(self.send, "sum")
            gg = strip(strip(gg).subgraph(vpred=lambda vid, v: v["pr"] < 4.0))
            v3, e3, gg, m3 = gg.mrTriplets(self.send, "sum")
            return v3["m"], e3, (m1["fwd"].bytes_shipped
                                 + m2["fwd"].bytes_shipped
                                 + m3["fwd"].bytes_shipped)
        out = {}
        for cold in (True, False):
            v, e, b = self.jit(lambda gg, _c=cold: chain(gg, _c))(
                self.graph("g"))
            out[cold] = (np.asarray(v), np.asarray(e), float(jnp.float32(b)))
        return out

    def sec_k(self):
        from repro.core.planner import MapV as RMapV
        from repro.core.planner import MrTriplets as RMrT
        from repro.core.planner import run_chain as rrun
        jnp = self.jnp
        send_both = lambda sv, ev, dv: {"m": sv["pr"] * ev["w"] + dv["deg"]}  # noqa: E731
        send_src = lambda sv, ev, dv: {"m": sv["pr"] * ev["w"]}  # noqa: E731
        chain = (RMapV(lambda vid, v: {**v, "pr": v["pr"] + 1.0}),
                 RMrT(send_src, "sum"), RMrT(send_src, "sum"))
        out = {}
        for opt in (True, False):
            def planned(gg, _o=opt):
                _, _, gg, _ = gg.mrTriplets(send_both, "sum")
                base = gg.bytes_shipped
                res = rrun(gg, chain, optimize=_o)
                vals, exists, _ = res.outputs[-1]
                return vals["m"], exists, res.graph.bytes_shipped - base
            vals, exists, byt = self.jit(planned)(self.graph("g"))
            out[opt] = (np.asarray(vals), np.asarray(exists),
                        float(jnp.asarray(byt)))
        return out

    def sec_m(self):
        import tempfile as tf
        from repro.core import snapshot as rsnap
        from repro.core import transport as rtm
        from repro.core.exchange import LocalExchange as RLocal
        from repro.core.fault import FaultPlan as RPlan
        from repro.core.fault import FaultyExchange as RFaulty
        out = {}
        g = self.graph("g")
        for key, plan in (("clean", None),
                          ("transient", dict(mode="corrupt", attempts=(0,))),
                          ("persistent", dict(mode="corrupt",
                                              attempts=(0, 1)))):
            gg = g if plan is None else dataclasses.replace(
                g, ex=RFaulty(RLocal(p=P), RPlan(**plan)))
            # one jitted program a plan: its trace decides the faults
            fn = self.jit(lambda x: self._six(x, DENSE_CHK))
            pr, faults, degraded, byt = fn(gg)
            out[key] = (np.asarray(pr), float(faults), float(degraded),
                        [float(b) for b in byt])
        sg = self.graph("sg")
        g4, _ = self.steps(sg, "cc", 4)
        with tf.TemporaryDirectory() as d:
            store = rsnap.SnapshotStore(d)
            rsnap.save_pregel(store, 4, g4, rtm.DENSE, live=1)
            arrays, manifest = store.read(4)
        out["files"] = (arrays, {k: v for k, v in manifest.items()
                                 if k != "wall_time"})
        out["uf"] = self._uf("sg")
        return out

    def _six(self, g, transport):
        """Six checked PageRank supersteps in one traced program."""
        from repro.core.pregel import _superstep
        jnp = self.jnp
        faults, degraded, byt = jnp.float32(0), jnp.float32(0), []
        for _ in range(6):
            g, _, m = _superstep(
                g, None, vprog=self.vprog, send_msg=self.send, gather="sum",
                default_msg=self.zero, skip_stale=None, changed_fn=None,
                kernel_mode="auto", use_cache=True,
                transport=self.policy(transport))
            faults += m["fwd"].wire_faults + m["back"].wire_faults
            degraded += m["fwd"].degraded + m["back"].degraded
            byt.append(m["fwd"].bytes_shipped + m["back"].bytes_shipped)
        return g.vdata["pr"], faults, degraded, byt

    def sec_n(self):
        out = {}
        for key, kw, tp in (("2d", {}, tm.DENSE),
                            ("hyb", {"partitioner": "hybrid",
                                     "bcast_min_repl": 3}, TIERED)):
            g, ms = self.steps(self.graph("ng", **kw), "pr", 5, transport=tp)
            gd = self.edges("nsg")
            c0 = self.RG.from_edges(gd.src, gd.dst, num_partitions=P,
                                    **kw).mapV(lambda vid, v: {"cc": vid})
            c, cms = self.steps(c0, "cc", 8, transport=tp)
            out[key] = {"pr": np.asarray(g.vdata["pr"]),
                        "pr_bytes": sum(self.bytes(ms)),
                        "cc": np.asarray(c.vdata["cc"]),
                        "cc_bytes": sum(self.bytes(cms)),
                        "ragged": float(sum(float(m["fwd"].ragged)
                                            for m in cms))}
        gd = self.edges("nsg")
        vids = sorted(np.unique(np.concatenate([gd.src, gd.dst])).tolist())
        out["uf"] = self.ralg.connected_components_reference(gd.src, gd.dst,
                                                             vids)
        return out

    def sec_o(self):
        from repro.core import spill as rspill
        out = {}
        for name, kind, n in (("gdp", "delta", 6), ("sg", "cc", 10)):
            g0 = self.graph(name)
            fn = self.step_fn(kind)
            ring = rspill.SpillRing(plan=rspill.plan_spill(g0, 0.5))
            g, resid, stream = g0, [], []
            for _ in range(n):
                g = ring.restore(g)
                g, _, _ = fn(g)
                g = ring.spill(g)
                resid.append(float(ring.resident_bytes(g)))
                stream.append(float(ring.stream_times(g)["stream_bytes"]))
            host = float(ring.host_bytes())
            g = ring.materialize(g)
            out[kind] = ({k: np.asarray(v) for k, v in g.vdata.items()},
                         resid, stream, host)
        return out


# ---------------------------------------------------------------------------
# pytest: launch the ranks, run the one-process sections, compare
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Both worlds' subprocesses, started before anything else runs (each in
    its own session: a timeout kills its ranks with it)."""
    import signal
    import time
    d = tmp_path_factory.mktemp("spmd_ranks")
    procs = {}
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    for w in WORLDS:
        out = d / f"world{w}.pkl"
        procs[w] = (subprocess.Popen(
            [sys.executable, __file__, "--world", str(w), "--out", str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True, env=env), out, time.monotonic())
    yield procs
    for proc, _, _ in procs.values():
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()


@pytest.fixture(scope="module")
def ranks(launched):
    """world -> the rank run's sections (waits for its subprocess)."""
    import signal
    import time
    cache = {}

    def get(world):
        if world not in cache:
            proc, out, t0 = launched[world]
            left = max(RANK_TIMEOUT - (time.monotonic() - t0), 1.0)
            try:
                text, _ = proc.communicate(timeout=left)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                text, _ = proc.communicate()
                pytest.fail(f"world {world}: the ranks ran past "
                            f"{RANK_TIMEOUT} s\n{text[-4000:]}")
            assert proc.returncode == 0, f"world {world}:\n{text[-6000:]}"
            cache[world] = pickle.loads(out.read_bytes())
        return cache[world]
    return get


@pytest.fixture(scope="module")
def local(launched, tmp_path_factory):
    return run_sections(LocalCtx(), str(tmp_path_factory.mktemp("ck")))


@pytest.fixture(scope="module")
def ref(launched):
    return Reference()


def same(got, want, path=()):
    """Equal bit for bit: arrays by their bytes, containers leaf by leaf."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            same(got[k], want[k], path + (k,))
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (path, len(got), len(want))
        for i, (a, b) in enumerate(zip(got, want)):
            same(a, b, path + (i,))
    elif isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.shape == want.shape, (path, got.shape, want.shape)
        assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
        assert got.tobytes() == want.tobytes(), (path, got, want)
    else:
        assert got == want, (path, got, want)


def same_as_ref(got, want):
    """f32 states: bit-equal to the reference at these sizes."""
    same(np.asarray(got), np.asarray(want))


def labels(vid, cc, mask):
    return dict(zip(np.asarray(vid)[mask].tolist(),
                    np.asarray(cc)[mask].tolist()))


def norm_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a / a.sum() - b / b.sum()).max())


def _section(name, world, ranks, local):
    """The rank run's section, after holding it bit for bit to the one-
    process run's."""
    got = ranks(world)[name]
    same(got, local[name])
    return got


@pytest.fixture(scope="module")
def sg_host():
    g = build("sg")
    return _np(g.s.home_vid), _np(g.vmask)


@pytest.mark.parametrize("world", WORLDS)
def test_a_kernel_modes(world, ranks, local, ref):
    got = _section("a", world, ranks, local)
    vals, exists, byt = ref("a")
    for mode, want_plan in (("unfused", "unfused"), ("ref", "fused"),
                            ("auto", "fused")):
        v, e, plan, b = got[mode]
        assert plan == want_plan
        same_as_ref(v, vals)
        same(e, exists)
        assert b == byt
    same(got["ref"][0], got["unfused"][0])       # fused == unfused


@pytest.mark.parametrize("world", WORLDS)
def test_b_pagerank_with_view(world, ranks, local, ref):
    got = _section("b", world, ranks, local)
    want = ref("b")
    same_as_ref(got["pr"], want["pr"])
    assert got["bytes"] == want["bytes"]
    assert got["log"] == want["log"]


@pytest.mark.parametrize("world", WORLDS)
def test_c_connected_components(world, ranks, local, ref, sg_host):
    got = _section("c", world, ranks, local)
    want = ref("c")
    same(got["cc"], want["cc"])
    assert got["bytes"] == want["bytes"]
    assert labels(*sg_host[:1], got["cc"], sg_host[1]) == want["uf"]


@pytest.mark.parametrize("world", WORLDS)
def test_d_collections(world, ranks, local, ref):
    got = _section("d", world, ranks, local)
    want = ref("d")
    same(got, want)
    keys, vals = np.arange(64) % 13, np.arange(64, dtype=np.float32)
    k, v, m, ovf = got["reduce"]
    assert ovf == 0
    assert dict(zip(k[m].tolist(), v[m].tolist())) == {
        int(x): float(vals[keys == x].sum()) for x in set(keys.tolist())}


@pytest.mark.parametrize("world", WORLDS)
def test_e_int8_wire(world, ranks, local, ref):
    got = _section("e", world, ranks, local)
    want = ref("e")
    same(got["auto"], got["unfused"])
    assert norm_err(got["auto"], ref("b")["pr"]) <= RANK_ERR
    assert got["bow_f32"] == want["bow_f32"]
    assert got["bow_int8"] == want["bow_int8"]
    assert 0 < got["bow_int8"] <= got["bow_f32"] / 3


@pytest.mark.parametrize("world", WORLDS)
def test_f_packed_int_delta_cc(world, ranks, local, ref, sg_host):
    got = _section("f", world, ranks, local)
    want = ref("f")
    same(got["cc"], want["cc"])
    same(got["cc"], ref("c")["cc"])
    assert got["bytes"] == want["bytes"]


def _check_rows(rows, want_rows):
    assert [r["live"] for r in rows] == [r["live"] for r in want_rows]
    assert rows == want_rows


@pytest.mark.parametrize("world", WORLDS)
def test_g_auto_transport(world, ranks, local, ref):
    got = _section("g", world, ranks, local)
    want = ref("g")
    pr_dense, rows_dense = got["dense"]
    same_as_ref(pr_dense, want["dense"][0])
    _check_rows(rows_dense, want["dense"][1])
    for key in ("auto", "auto_unfused"):
        pr, rows = got[key]
        same(pr, pr_dense)                  # transports change bytes only
        _check_rows(rows, want["auto"][1])
        ragged = [r for r in rows if r["ragged"] == 1.0]
        dense = [r for r in rows if r["ragged"] == 0.0]
        assert ragged and dense
        shipped = [r["shipped"] for r in ragged]
        assert shipped == sorted(shipped, reverse=True)
        assert max(shipped) < min(r["shipped"] for r in dense)
        assert rows[0]["ragged"] == 0.0 and rows[-1]["ragged"] == 1.0
    # pregel itself on the ranks: the same values and halting superstep
    pr, n, kinds, _log = got["pregel"]
    same(pr, pr_dense)
    assert n == len(rows_dense) and "ragged" in kinds


@pytest.mark.parametrize("world", WORLDS)
def test_h_int8_auto_transport(world, ranks, local, ref):
    got = _section("h", world, ranks, local)
    assert any(r["ragged"] == 1.0 for r in got["rows"])
    assert norm_err(got["pr"], ref("g")["dense"][0]) <= RANK_ERR


@pytest.mark.parametrize("world", WORLDS)
def test_i_forced_ragged_fallback(world, ranks, local, ref, sg_host):
    got = _section("i", world, ranks, local)
    want = ref("i")
    same(got["cc"], ref("c")["cc"])
    same(got["cc"], want["cc"])
    assert got["bytes"] == want["bytes"]
    assert got["ragged"] == want["ragged"]
    assert got["overflow"] == want["overflow"]


@pytest.mark.parametrize("world", WORLDS)
def test_j_warm_vs_cold_chain(world, ranks, local, ref):
    got = _section("j", world, ranks, local)
    want = ref("j")
    for mode in ("auto", "unfused"):
        warm, cold = got[mode, False], got[mode, True]
        same(warm[:2], cold[:2])
        assert 0 < warm[2] < cold[2]
        for c in (True, False):
            same_as_ref(got[mode, c][0], want[c][0])
            same(got[mode, c][1], want[c][1])
            assert got[mode, c][2] == want[c][2]


@pytest.mark.parametrize("world", WORLDS)
def test_k_chain_planner(world, ranks, local, ref):
    got = _section("k", world, ranks, local)
    want = ref("k")
    same(got[True][:2], got[False][:2])
    assert 0 < got[True][2] <= got[False][2]
    for opt in (True, False):
        same_as_ref(got[opt][0], want[opt][0])
        same(got[opt][1], want[opt][1])
        assert got[opt][2] == want[opt][2]


@pytest.mark.parametrize("world", WORLDS)
def test_l_ring_pipeline(world, ranks, local, ref):
    got = _section("l", world, ranks, local)
    cc_want = ref("c")["cc"]
    for (gkey, mode, tkey), (cc, byt) in (
            (k, v) for k, v in got.items() if len(k) == 3):
        same(cc, cc_want)
    same(got["warm", True], cc_want)
    same(got["warm", False], cc_want)
    pr_ref = got["delta", "dense"][0]
    same(got["delta", "auto"][0], pr_ref)
    same_as_ref(pr_ref, ref("g")["dense"][0])
    assert any(r["ragged"] == 1.0 for r in got["delta", "auto"][1])


@pytest.mark.parametrize("world", WORLDS)
def test_m_faults_snapshots_elastic(world, ranks, local, ref, sg_host):
    got = _section("m", world, ranks, local)
    want = ref("m")
    pr_clean, f0, d0, _ = got["clean"]
    assert (f0, d0) == (0.0, 0.0)
    for key in ("clean", "transient", "persistent"):
        pr, f, d, byt = got[key]
        same(pr, pr_clean)
        same_as_ref(pr, want[key][0])
        assert (f, d, byt) == want[key][1:], key
    assert got["transient"][1] > 0 and got["transient"][2] == 0.0
    assert got["persistent"][2] > 0
    assert got["route_loss"][1] > 0
    same(got["route_loss"][0], ref("c")["cc"])
    # the snapshot files a sharded run writes == the reference's
    arrays, manifest = got["files"]
    rarrays, rmanifest = want["files"]
    assert set(arrays) == set(rarrays)
    for k in rarrays:
        same(np.asarray(arrays[k]), np.asarray(rarrays[k]), (k,))
    assert manifest == rmanifest
    start, kind, cc = got["resumed"]
    assert (start, kind) == (4, "dense")
    same(cc, ref("c")["cc"])
    stopped_after, cc = got["pregel_resume"]
    assert stopped_after == 1
    same(cc, ref("c")["cc"])
    warm, cold = got["warm_cold"]
    assert 0 < warm < cold
    start2, p2, cc2, vid2, vmask2, own = got["elastic"]
    assert (start2, p2, own) == (4, 2, True)
    assert labels(vid2, cc2, vmask2) == want["uf"]


@pytest.mark.parametrize("world", WORLDS)
def test_n_hybrid_broadcast_lane(world, ranks, local, ref):
    got = _section("n", world, ranks, local)
    want = ref("n")
    for key in ("2d", "hyb"):
        g, w = got[key], want[key]
        same_as_ref(g["pr"], w["pr"])
        same(g["cc"], w["cc"])
        assert (g["pr_bytes"], g["cc_bytes"], g["ragged"]) == (
            w["pr_bytes"], w["cc_bytes"], w["ragged"])
        assert labels(g["cc_home_vid"], g["cc"], g["cc_home_mask"]) == \
            want["uf"]

    def by_vid(r):
        return {int(v): x for v, x, m in zip(
            r["home_vid"].ravel(), r["pr"].ravel(), r["home_mask"].ravel())
            if m}
    assert by_vid(got["hyb"]) == by_vid(got["2d"])
    assert got["hyb"]["pr_bytes"] < got["2d"]["pr_bytes"]
    assert got["hyb"]["cc_bytes"] < got["2d"]["cc_bytes"]
    assert got["hyb"]["ragged"] > 0


@pytest.mark.parametrize("world", WORLDS)
def test_o_working_set_half(world, ranks, local, ref, sg_host):
    got = _section("o", world, ranks, local)
    want = ref("o")
    same(got["pr", 0.5][:2], got["pr", 1.0][:2])
    same(got["cc", 0.5][0], got["cc", 1.0][0])
    same(got["cc", 0.5][0], ref("c")["cc"])
    for (kind, key) in (("delta", "pr"), ("cc", "cc")):
        resid, stream, host = got[key, 0.5][-3:]
        assert (resid, stream, host) == want[kind][1:], kind
    for k in ("pr", "delta"):
        same_as_ref(got["pr", 0.5][("pr", "delta").index(k)],
                     want["delta"][0][k])
    _nl, _cells, n_cold, n_total = got["plan"]
    full_b = got["full_b"]
    assert n_cold > 0
    cap = full_b * (n_total - n_cold + 1) / n_total
    resid = got["pr", 0.5][2]
    assert max(resid) <= cap and min(resid) < full_b
    assert min(got["cc", 0.5][1]) < got["cc_full_b"]


def _rank_body(rank, world, device, ckdir):
    torch.set_num_threads(1)
    out = run_sections(RankCtx(rank, world), ckdir)
    return out if rank == 0 else None


def _main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as ckdir:
        res = run_ranks(_rank_body, args.world, args=(ckdir,),
                        backend="gloo", device="cpu",
                        timeout=RANK_TIMEOUT - 20)
    with open(args.out, "wb") as f:
        pickle.dump(res[0], f)
    return 0


if __name__ == "__main__":
    sys.exit(_main())

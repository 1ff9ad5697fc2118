"""Enhanced Pregel on the GAS decomposition (paper §3.3, Listing 5).

Per superstep:
    msgs   = g.mrTriplets(send_msg, gather, skipStale)   # scatter + gather
    vdata' = vprog(vid, vdata, msg_or_default)           # apply
    active = changed(vdata, vdata')                      # vote to halt
until no vertex changed or max_supersteps.

As in the reference host loop: the incremental view rides the graph, the
changed mask feeds it back per leaf (passthrough leaves never re-ship),
`fuse_apply="auto"` runs the combine + vprog + changed half as one kernel
(kernels/superstep.py) whenever the shapes allow — bit-exact with the
unfused apply, since both combine sums in ascending source partition — and
every superstep adds its ships to the graph's wire log.

Two drivers, as in the reference:
  * `pregel` — the host loop.  The reference jits its superstep; here
    superstep 1 runs eagerly (the cold ship, which settles the view's plan
    and builds the kernels) and, on the card, every later superstep
    replays one superstep captured as a CUDA graph (`core/capture.py`).
    The host reads the live count once a superstep.  Under an "auto"
    transport the host re-plans the next superstep's policy from that
    same read (`transport.adapt_policy`); each distinct policy is one
    capture, where the reference compiles once per policy.
  * `pregel_fused` — the reference's one `lax.while_loop`.  After the
    eager superstep 1, blocks of `FUSED_BLOCK` supersteps are captured
    back to back; each superstep of a block is masked on the device by
    `live > 0 and i < max_supersteps`, so the loop halts on the card and
    the host reads one flag a block.  An "auto" transport keeps its
    static capacity and switches dense / ragged on the device; its last
    decision rides the block's carry.
On the CPU both run the same steps eagerly, through the same buffers.

`pregel` also takes the reference's fault-tolerance keywords: superstep
snapshots (`checkpoint`, `checkpoint_every`, `guard`, `resume`,
`core/snapshot.py`) and out-of-core residency (`working_set_frac`,
`core/spill.py`, whose ring writes the tensors the replays read).  Both
drivers bracket each superstep with the key of the program the
reference's jit would run, for a fault injector (`core/fault.py`) that
counts collectives as the reference traces them.

A graph sharded over an `SpmdExchange` (`core/shard.py`: one process a
rank) runs through `pregel` on every rank: its supersteps run eagerly (a
collective through the host is no CUDA graph), and the host's read of a
superstep is taken over the group, the live counts summed and the
occupancies maximised, so every rank halts and re-plans alike.
`pregel_fused` halts on each rank's device and refuses such a graph.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
from typing import Any, Callable

import torch

from . import analysis
from . import capture as capture_mod
from . import snapshot as snapshot_mod
from . import spill as spill_mod
from . import transport as transport_mod
from . import view as view_mod
from .exchange import spmd_of
from .graph import Graph
from .mrtriplets import (_derive_need, _plan_apply, apply_plan_of,
                         fused_apply_home, mr_triplets, plan_of)
from .tree import (ElemSpec, elem_spec, tree_changed, tree_map,
                   tree_unflatten, tree_where, vmap2)

# Supersteps a replayed block of `pregel_fused` runs before the host reads
# its halt flag.  A larger block saves host syncs and costs up to K - 1
# masked supersteps after the halt, each a full superstep of device work.
# On PageRank rmat(22,16), P=4 (scripts/pregel_block_sweep.py, NVIDIA H100
# 80GB HBM3 at 700 W, median of 5 runs less their capture) the saved syncs
# are worth less than the masked supersteps: ms a superstep at K 1 / 2 / 4
# / 8 were 3.68 / 4.30 / 4.69 / 5.83 (10 supersteps), 3.33 / 3.41 / 3.53 /
# 3.96 (20) and 5.59 / 5.67 / 5.96 / 6.51 (delta, 34).  K = 2 is the
# smallest block in which the loop still halts on the card.
FUSED_BLOCK = 2

# the graph fields a superstep rewrites: the carry a replayed step threads
_CARRIED = ("vdata", "active", "view", "wire_log")

_log = logging.getLogger(__name__)


@dataclasses.dataclass
class PregelResult:
    graph: Graph
    supersteps: int
    metrics: list[dict]     # per-superstep engine metrics (track_metrics)


def _superstep(g: Graph, *, vprog, send_msg, gather, default_msg, skip_stale,
               changed_fn, kernel_mode, use_cache, payload_bound, aplan,
               transport=None, tstate=None):
    """One BSP superstep; `aplan` is the fused apply plan or None and
    `default_msg` a pytree of tensors on the graph's device; `transport`
    the superstep's policy and `tstate` the previous "auto" decision.
    Makes no host sync and no host-to-device copy on a CUDA graph in the
    "auto" and "unfused" modes, so it can be captured."""
    gin = g if use_cache else g.replace(view=None)
    msgs, exists, view, metrics = mr_triplets(
        gin, send_msg, gather, to="dst", skip_stale=skip_stale,
        kernel_mode=kernel_mode, payload_bound=payload_bound,
        transport=transport, transport_state=tstate,
        return_routed=aplan is not None)
    if aplan is not None:
        # `msgs` is the raw routed aggregate buffer: the kernel combines it
        # (the span lets a trace count the home half's launches)
        with torch.profiler.record_function("apply_home"):
            new_vdata, changed = fused_apply_home(g, msgs, exists, "dst",
                                                  gather, aplan, kernel_mode)
        msg_elem = tree_unflatten(list(aplan.msg_specs), aplan.msg_treedef)
    else:
        msgs_or_default = tree_where(exists, msgs, tree_map(
            lambda d, m: d.to(m.dtype).expand_as(m), default_msg, msgs))
        new_vdata = vmap2(vprog)(g.s.home_vid, g.vdata, msgs_or_default)
        new_vdata = tree_where(g.vmask, new_vdata, g.vdata)
        if changed_fn is None:
            changed = tree_changed(new_vdata, g.vdata)
        else:
            changed = vmap2(changed_fn)(g.vdata, new_vdata)
        changed = changed & g.vmask
        msg_elem = elem_spec(msgs_or_default)
    live = changed.sum()
    if use_cache:
        rewrites = analysis.analyze_rewrites(
            vprog, (ElemSpec((), g.s.home_vid.dtype), elem_spec(g.vdata),
                    msg_elem), 1)
        view = view_mod.view_after_rewrite(view, g.vdata, new_vdata, rewrites,
                                           changed)
    log = g.wire_log
    if log is not None:
        m = metrics["fwd"].merge(metrics["back"])
        log = log.add(metrics["ships"], m.bytes_shipped, m.bytes_accounted)
    g2 = g.replace(vdata=new_vdata, active=changed,
                   view=view if use_cache else None, wire_log=log)
    return g2, live, metrics


def _step_fn(g: Graph, vprog, send_msg, gather, *, default_msg, skip_stale,
             changed_fn, kernel_mode, incremental, payload_bound,
             fuse_apply, transport=None) -> Callable:
    """The superstep of one run: step(g) -> (g', live, metrics), its plans
    made and its default messages moved to the device once."""
    fuse = kernel_mode != "unfused" and fuse_apply not in (False, "unfused")
    aplan = (_plan_apply(g, vprog, send_msg, gather, changed_fn, default_msg,
                         payload_bound) if fuse else None)
    dmsg = tree_map(lambda d: torch.as_tensor(d).to(g.device), default_msg)
    return functools.partial(
        _superstep, vprog=vprog, send_msg=send_msg, gather=gather,
        default_msg=dmsg, skip_stale=skip_stale, changed_fn=changed_fn,
        kernel_mode=kernel_mode, use_cache=incremental,
        payload_bound=payload_bound, aplan=aplan, transport=transport)


def _captures(device: torch.device, kernel_mode: str) -> bool:
    """Do the drivers capture their supersteps?  On the card, unless the
    caller asked for the plain versions ("ref"), which read tables back to
    the host and so cannot be captured: those supersteps run eagerly."""
    return device.type == "cuda" and kernel_mode != "ref"


def _carry(g: Graph) -> dict:
    return {k: getattr(g, k) for k in _CARRIED}


def _to_host(metrics: dict) -> dict:
    out = {}
    for k, v in metrics.items():
        if hasattr(v, "to_host"):
            v = v.to_host()
        elif isinstance(v, torch.Tensor):
            v = v.item() if v.dim() == 0 else v.tolist()
        out[k] = v
    return out


def _progress(live: torch.Tensor, metrics: dict, watch: bool):
    """What the host reads after a superstep, as one tensor, so one
    device-to-host copy: the live count; when `watch` (a transport other
    than dense) also the overflow fallbacks and each route's occupancy,
    the largest per-destination count and, when it is a vector, the [P]
    fractions adapt_policy tiers on (`_occupancy` unpacks them)."""
    if not watch:
        return live
    fwd, back = metrics["fwd"], metrics["back"]
    parts = [live, fwd.overflow + back.overflow, fwd.route_active_max,
             back.route_active_max]
    out = [x.double().reshape(1) if isinstance(x, torch.Tensor)
           else live.new_full((1,), float(x), dtype=torch.float64)
           for x in parts]
    out += [m.route_active_frac.double() for m in (fwd, back)
            if _is_vec(m.route_active_frac)]
    return torch.cat(out)


def _is_vec(v) -> bool:
    return isinstance(v, torch.Tensor) and v.dim() == 1 and v.numel() > 1


def _occupancy(vals: list, metrics: dict):
    """(fwd, back) occupancy for adapt_policy from `_progress`'s values:
    the per-destination vector, or the largest count over the route width
    (the reference's rule: a vector only when P > 1)."""
    i = 4
    occ = []
    for m, maxc in ((metrics["fwd"], vals[2]), (metrics["back"], vals[3])):
        if _is_vec(m.route_active_frac):
            n = m.route_active_frac.numel()
            occ.append(tuple(vals[i:i + n]))
            i += n
        else:
            occ.append(int(maxc) / max(m.route_width, 1))
    return occ


def _over_group(ex, prog: torch.Tensor, watch: bool) -> torch.Tensor:
    """`_progress`'s read over every rank of a multi-process executor: the
    live counts add; the overflow flags (uniform already) and the
    occupancies take the maximum."""
    if not watch:
        return ex.psum(prog)
    return torch.cat([ex.psum(prog[:1]), ex.pmax(prog[1:])])


def _bracket(ex, key):
    """A fault injector's program bracket (`core.fault`); a real executor
    has none."""
    program = getattr(ex, "program", None)
    return program(key) if program is not None else contextlib.nullcontext()


def _program_key(carry, policy) -> tuple:
    """The program the reference's jit would run a superstep as: the
    carry's static half (treedef, dtypes, shapes, view plan) and the
    concrete transport policy."""
    return capture_mod.flatten(carry)[1], policy


def pregel(g: Graph, vprog: Callable, send_msg: Callable,
           gather: str = "sum", *, default_msg: Any,
           max_supersteps: int = 50, skip_stale: str | None = "out",
           incremental: bool = True, changed_fn: Callable | None = None,
           kernel_mode: str = "auto", track_metrics: bool = False,
           payload_bound: int | None = None, transport: Any = None,
           fuse_apply: Any = "auto", checkpoint: Any = None,
           checkpoint_every: int | None = None, guard: Any = None,
           resume: bool = True,
           working_set_frac: float | None = None) -> PregelResult:
    """The host-driven BSP loop.  fuse_apply: "auto" fuses the apply half
    when eligible; False / "unfused" pins the unfused apply.

    Superstep 1 runs eagerly; on the card the later ones replay it
    captured as a CUDA graph (bit-equal to running them eagerly), except
    under kernel_mode="ref", whose plain versions sync with the host and
    so run eagerly.  The loop reads the live count back once a superstep
    to decide whether to halt; track_metrics also reads that superstep's
    metrics and the wire log's totals (`pipeline_ships`,
    `pipeline_bytes_shipped`: the graph's lineage, this loop included).

    transport: None / "dense" | "ragged" | "auto" | TransportPolicy.
    "auto" re-plans on the host: superstep 1 ships dense (a full ship),
    then `transport.adapt_policy` picks the next superstep's concrete
    policy from the active fraction and the route occupancy the last one
    observed, read in the same copy as the live count.  Each distinct
    policy is captured once and kept until the run ends (a policy other
    than superstep 1's at its second superstep: its first runs eagerly, so
    the kernels it adds are loaded before a capture); the run switches
    between them by loading the carry.  The records hold the decision
    ("transport", "transport_cap", "transport_frac", "ragged",
    "overflow_fallbacks"; the whole concrete policy as "transport_plan"),
    `recompiles` (distinct policies so far, as the reference counts its
    compiles), `captures` / `capture_ms`, and the integrity ladder's
    `wire_faults` / `degraded_routes`.

    checkpoint: a directory or `core.snapshot.SnapshotStore`.  Every
    `checkpoint_every` supersteps, and at the first boundary after
    `guard` (a `train.fault.PreemptionGuard`) reports a preemption, after
    which the loop exits, the carry is snapshotted: the warm graph with
    its view, the live count and the concrete policy the next superstep
    would run (saved after adapt_policy).  With resume=True a snapshot in
    the store is restored before anything is derived from the graph, so
    re-running the call after a kill continues bit-equal to the
    uninterrupted run.

    working_set_frac: out-of-core residency (`core/spill.py`).  The
    hottest fraction in (0, 1] of the home-vertex cells stays on the
    device between supersteps; the coldest spill to pinned host memory
    after each superstep and stream back before the next, in place in the
    tensors the replays read.  Values are bit-equal to the fully resident
    run; the records gain `stream_bytes`, `compute_time_modeled`,
    `stream_time_serial`, `stream_time_overlap`, `spill_resident_bytes`
    and `spill_host_bytes`.  None (default) keeps everything resident."""
    tp = transport_mod.resolve_transport(transport)
    auto = tp.kind == "auto"
    # superstep 1 is a full ship, dense by construction
    cur_tp = transport_mod.DENSE if auto else tp

    # resume swaps in the snapshotted carry before anything is derived
    # from the graph
    store = None
    start = 0
    if checkpoint is not None:
        store = (checkpoint
                 if isinstance(checkpoint, snapshot_mod.SnapshotStore)
                 else snapshot_mod.SnapshotStore(checkpoint))
        if resume and store.latest_step() is not None:
            g, start, saved_tp, _live = snapshot_mod.restore_pregel(store, g)
            if saved_tp is not None:
                # the post-adapt policy: the plan the killed run chose
                cur_tp = saved_tp

    step = _step_fn(g, vprog, send_msg, gather, default_msg=default_msg,
                    skip_stale=skip_stale, changed_fn=changed_fn,
                    kernel_mode=kernel_mode, incremental=incremental,
                    payload_bound=payload_bound, fuse_apply=fuse_apply)
    deps = analysis.analyze_message_fn(
        send_msg, elem_spec(g.vdata), elem_spec(g.edata), elem_spec(g.vdata))
    fuse = kernel_mode != "unfused" and fuse_apply not in (False, "unfused")
    static_info = {
        "join_arity": deps.n_way,
        "need": _derive_need(deps, None) or "none",
        "wire": g.ex.codec.name if g.ex.codec is not None else "f32",
        "transport_policy": tp.kind,
        "plan": plan_of(g, send_msg, gather, kernel_mode=kernel_mode,
                        payload_bound=payload_bound),
        "apply_plan": (apply_plan_of(
            g, vprog, send_msg, gather, changed_fn=changed_fn,
            default_msg=default_msg, kernel_mode=kernel_mode,
            payload_bound=payload_bound) if fuse else "unfused")}

    ring = None
    if working_set_frac is not None and working_set_frac < 1.0:
        ring = spill_mod.SpillRing(plan=spill_mod.plan_spill(
            g, working_set_frac))
        g = ring.own(g)
    ex = g.ex
    spmd = spmd_of(ex)
    if hasattr(ex, "new_scope"):
        ex.new_scope()           # a new driver call: a new jit
    watch = tp.kind != "dense"
    plans_seen = {cur_tp}
    n_visible = max(int(ex.psum(g.vmask.sum())), 1) if auto else 1
    caps0 = dict(capture_mod.stats)
    all_metrics: list[dict] = []

    def record(gs: Graph, prog, metrics) -> tuple[int, list]:
        """Read `prog` once; the live count, the values; the metrics too if
        tracked (a rank's own under a multi-process executor)."""
        if spmd is not None:
            prog = _over_group(ex, prog, watch)
        vals = prog.tolist() if watch else [int(prog)]
        n_live = int(vals[0])
        over = vals[1] if watch else 0.0
        if over:
            _log.warning("pregel: the ragged transport overflowed its "
                         "capacity %d time(s) and shipped dense (values "
                         "exact, bytes worse)", int(over))
        if track_metrics:
            host = _to_host(metrics)
            host.update(static_info)
            fwd, back = metrics["fwd"], metrics["back"]
            host.update(
                live=n_live, transport=cur_tp.kind,
                transport_cap=cur_tp.cap or 0,
                transport_frac=(cur_tp.capacity_frac
                                if cur_tp.kind == "ragged" else 0.0),
                transport_plan=dataclasses.asdict(cur_tp),
                recompiles=len(plans_seen), overflow_fallbacks=float(over),
                wire_faults=float(fwd.wire_faults + back.wire_faults),
                degraded_routes=float(fwd.degraded + back.degraded),
                captures=capture_mod.stats["captures"] - caps0["captures"],
                capture_ms=1e3 * (capture_mod.stats["capture_s"]
                                  - caps0["capture_s"]),
                pipeline_ships=float(gs.ships),
                pipeline_bytes_shipped=float(gs.bytes_shipped))
            if ring is not None:
                # the rotation just run: this superstep's spill and the
                # restore before it
                host.update(ring.stream_times(gs))
                host["spill_resident_bytes"] = float(ring.resident_bytes(gs))
                host["spill_host_bytes"] = float(ring.host_bytes())
                if ring.timed:
                    host["spill_copy_ms"] = 1e3 * ring.spill_s
                    host["restore_copy_ms"] = 1e3 * ring.restore_s
            all_metrics.append(host)
        return n_live, vals

    def boundary(it: int, gs: Graph, n_live: int, vals, metrics) -> bool:
        """After superstep `it` (not halted): re-plan, then snapshot when
        due or preempted; True leaves the loop."""
        nonlocal cur_tp
        if auto:
            fwd_occ, back_occ = _occupancy(vals, metrics)
            cur_tp = transport_mod.adapt_policy(
                tp, was_ragged=cur_tp.kind == "ragged",
                active_frac=n_live / n_visible, fwd_frac=fwd_occ,
                back_frac=back_occ, prev=cur_tp)
            plans_seen.add(cur_tp)
        if store is None:
            return False
        preempt = guard is not None and getattr(guard, "requested", False)
        if spmd is not None:
            # one rank's preemption snapshots and stops every rank
            preempt = bool(ex.psum(torch.tensor(int(preempt),
                                                device=gs.device)))
        due = (checkpoint_every is not None
               and (it + 1 - start) % checkpoint_every == 0)
        if due or preempt:
            # the full graph: peek merges the host cells without draining
            snapshot_mod.save_pregel(
                store, it + 1, ring.peek(gs) if ring is not None else gs,
                cur_tp, live=n_live)
        return preempt

    def finish(gs: Graph, steps: int) -> PregelResult:
        if ring is not None:
            gs = ring.materialize(gs)    # exit fully resident
        return PregelResult(graph=gs, supersteps=steps, metrics=all_metrics)

    it = start
    if it >= max_supersteps:
        return finish(g, 0)
    first_tp = cur_tp
    if ring is not None:
        g = ring.restore(g)
    with _bracket(ex, _program_key(_carry(g), cur_tp)):
        g, live, metrics = step(g, transport=cur_tp)
    steps = 1
    if ring is not None:
        g = ring.spill(g)
    n_live, vals = record(g, _progress(live, metrics, watch), metrics)
    if (n_live == 0 or boundary(it, g, n_live, vals, metrics)
            or it + 1 >= max_supersteps):
        return finish(g, steps)

    g1 = g
    capture = _captures(g.device, kernel_mode) and spmd is None
    replays: dict = {}
    rep = None

    def replayed(policy):
        def run(carry):
            with _bracket(ex, _program_key(carry, policy)):
                g2, live, metrics = step(g1.replace(**carry),
                                         transport=policy)
            return _carry(g2), (_progress(live, metrics, watch), metrics)
        return run

    try:
        while it + 1 < max_supersteps:
            it += 1
            if ring is not None:
                g = ring.restore(g)      # in place: the tensors replays read
            nxt = replays.get(cur_tp)
            if nxt is None:
                # a policy superstep 1 did not run captures at its second
                # superstep: its first runs the new code eagerly
                nxt = replays[cur_tp] = capture_mod.Replay(
                    replayed(cur_tp), _carry(g), capture=capture,
                    defer=cur_tp != first_tp)
            elif nxt is not rep:
                nxt.load(_carry(g))
            rep = nxt
            prog, metrics = rep.run()
            steps += 1
            g = g1.replace(**rep.carry)
            if ring is not None:
                g = ring.spill(g)
            n_live, vals = record(g, prog, metrics)
            if n_live == 0 or boundary(it, g, n_live, vals, metrics):
                break
    finally:
        # the graph's outputs: their pools go, together
        prog = metrics = None
        capture_mod.close_all(replays.values())
    return finish(g, steps)


def _select(run: torch.Tensor, new: Any, old: Any) -> Any:
    """where(run, new, old) over two carries of one static half (a tensor
    passed through stays itself)."""
    n_t, n_spec = capture_mod.flatten(new)
    o_t, o_spec = capture_mod.flatten(old)
    if n_spec != o_spec:
        raise capture_mod.StaticHalfChanged(
            "a superstep of pregel_fused changed its carry's static half")

    return capture_mod.unflatten(n_spec, [
        n if n is o else torch.where(run, n, o) for n, o in zip(n_t, o_t)])


def pregel_fused(g: Graph, vprog: Callable, send_msg: Callable,
                 gather: str = "sum", *, default_msg: Any,
                 max_supersteps: int = 50, skip_stale: str | None = "out",
                 incremental: bool = True, changed_fn: Callable | None = None,
                 kernel_mode: str = "auto", payload_bound: int | None = None,
                 transport: Any = None, fuse_apply: Any = "auto"):
    """The whole run as one loop that halts on the device (the reference's
    `lax.while_loop`).  Returns (graph, steps), steps a 0-d int32 tensor on
    the graph's device.

    Superstep 1 runs eagerly (it materialises the view, so the carry has
    its static half); then supersteps run while live > 0 and steps <
    max_supersteps.  On the card they run in replayed blocks of
    `FUSED_BLOCK`: each superstep of a block computes the step and commits
    it only where `run = live > 0 and i < max_supersteps` holds on the
    device (i counts the committed ones), and the host reads one pinned
    halt flag a block.  kernel_mode="ref" runs the same blocks eagerly, as
    the CPU does.

    transport: one policy for the whole run (no host re-plan): an "auto"
    policy keeps its static capacity and switches dense / ragged each
    superstep on the device, its previous decision riding the carry."""
    if spmd_of(g.ex) is not None:
        raise ValueError("pregel_fused halts on each rank's device; run a "
                         "graph over an SpmdExchange through pregel")
    tp = transport_mod.resolve_transport(transport)
    auto = tp.kind == "auto"
    step = _step_fn(g, vprog, send_msg, gather, default_msg=default_msg,
                    skip_stale=skip_stale, changed_fn=changed_fn,
                    kernel_mode=kernel_mode, incremental=incremental,
                    payload_bound=payload_bound, fuse_apply=fuse_apply,
                    transport=tp)
    ex = g.ex
    if hasattr(ex, "new_scope"):
        ex.new_scope()
    # the reference runs superstep 1 as one program and traces the loop's
    # body once
    with _bracket(ex, "pregel_fused superstep 1"):
        g0, live0, m0 = step(g)
    i0 = torch.ones((), dtype=torch.int32, device=g.device)
    if not bool((live0 > 0) & (i0 < max_supersteps)):
        return g0, i0
    capture = _captures(g.device, kernel_mode)
    flag = torch.zeros((), dtype=torch.bool, pin_memory=capture)

    def block(carry):
        state, live, i = carry["state"], carry["live"], carry["i"]
        ts = carry.get("ts")
        for _ in range(FUSED_BLOCK):
            run = (live > 0) & (i < max_supersteps)
            with _bracket(ex, "pregel_fused body"):
                g2, live2, m = step(g0.replace(**state), tstate=ts)
            state = _select(run, _carry(g2), state)
            live = torch.where(run, live2, live)
            i = i + run.to(i.dtype)
            if auto:
                ts = torch.where(run, m["transport_state"], ts)
        flag.copy_((live > 0) & (i < max_supersteps), non_blocking=True)
        out = {"state": state, "live": live, "i": i}
        if auto:
            out["ts"] = ts
        return out, None

    carry0 = {"state": _carry(g0), "live": live0, "i": i0}
    if auto:
        carry0["ts"] = m0["transport_state"]
    # under "auto" superstep 1 ships dense (a cold view), so the ragged
    # branch first runs in the first block: that block runs eagerly and the
    # second one captures
    with capture_mod.Replay(block, carry0, capture=capture,
                            defer=auto) as rep:
        while True:
            rep.run()
            if capture:
                torch.cuda.current_stream().synchronize()
            if not bool(flag):
                break
        carry = rep.carry
    return g0.replace(**carry["state"]), carry["i"]

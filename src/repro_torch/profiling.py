"""Reading torch.profiler traces of the port: the launches and the device
time under a `record_function` span, such as "apply_home", the Pregel
loop's fused home half (`core/pregel.py`), and the device's busy time."""
from __future__ import annotations

import time

import torch

# host calls that put work on the card's stream (a CUDA graph's replay is
# one cudaGraphLaunch)
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
            "cudaGraphLaunch")


def traced(fn):
    """Run fn under the profiler (CPU and CUDA activities): (result, wall
    seconds, profile)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, wall, prof


def busy(prof, skip: tuple = ("apply_home",)) -> tuple[float, int]:
    """(device milliseconds, device events) of a profile: the summed time
    of its device-side events, replayed graphs' kernels included (the port
    launches on one stream, so none overlap); `skip` names spans whose
    device time repeats their kernels'."""
    from torch.autograd import DeviceType
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0
            and e.key not in skip]
    return (sum(e.device_time_total for e in rows) / 1e3,
            sum(e.count for e in rows))


def span_stats(prof, name: str = "apply_home") -> dict:
    """The work of the spans named `name` in a profile.

    Eagerly run spans: the launches the host made inside them (LAUNCHES on
    the span's thread and in its time) that ran on the card, and their
    device events, matched by correlation id.  A replayed CUDA graph opens
    no span (its capture did, but captured launches do not run there), so
    its share is found by kernel name: the device events of the kernels
    the eager spans launched that no eager launch made, i.e. the ones the
    graphs' replays ran.  `launches` counts both."""
    from torch.autograd import DeviceType
    evs = prof.events()
    spans = [e for e in evs if e.name == name
             and e.device_type == DeviceType.CPU]
    calls = [e for e in evs if e.name in LAUNCHES
             and e.device_type == DeviceType.CPU]
    ids = set()
    for sp in spans:
        lo, hi = sp.time_range.start, sp.time_range.end
        ids |= {e.id for e in calls if e.thread == sp.thread
                and lo <= e.time_range.start and e.time_range.end <= hi}
    dev = [e for e in evs if e.device_type == DeviceType.CUDA
           and e.name != name]
    eager = [e for e in dev if e.id in ids]
    names = {e.name for e in eager}
    direct = {e.id for e in calls if e.name != "cudaGraphLaunch"}
    replayed = [e for e in dev if e.name in names and e.id not in direct]
    mine = eager + replayed
    return {"spans": len(spans),
            "launches": len({e.id for e in eager}) + len(replayed),
            "replayed": len(replayed), "device_events": len(mine),
            "device_ms": sum(e.time_range.elapsed_us() for e in mine) / 1e3}


def home_line(stats: dict, supersteps: int | None = None) -> str:
    """One log line of `span_stats` over the apply_home spans, per
    superstep (`supersteps`, or one a span for an eager run)."""
    n = max(supersteps or stats["spans"], 1)
    return (f"home half (apply_home) per superstep: "
            f"{stats['launches'] / n:.2f} launches, "
            f"{stats['device_ms'] / n:.4f} device ms "
            f"({n} supersteps, {stats['device_events']} device events, "
            f"{stats['replayed']} of them in replayed graphs, matched by "
            f"kernel name)")

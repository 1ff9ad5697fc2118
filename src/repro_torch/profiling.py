"""Reading torch.profiler traces of the port: the launches and the device
time under a `record_function` span, such as "apply_home", the Pregel
loop's fused home half (`core/pregel.py`)."""
from __future__ import annotations

import time

import torch

# host calls that put work on the card's stream
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")


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


def span_stats(prof, name: str = "apply_home") -> dict:
    """Spans named `name` in a profile: their count, the launches the host
    made inside them (LAUNCHES on the span's thread and in its time), and
    the device time of the work those launches put on the card (matched by
    correlation id)."""
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
           and e.id in ids and e.name != name]
    return {"spans": len(spans), "launches": len(ids),
            "device_events": len(dev),
            "device_ms": sum(e.time_range.elapsed_us() for e in dev) / 1e3}


def home_line(stats: dict) -> str:
    """One log line of `span_stats` over the apply_home spans."""
    n = max(stats["spans"], 1)
    return (f"home half (apply_home) per superstep: "
            f"{stats['launches'] / n:.2f} launches, "
            f"{stats['device_ms'] / n:.4f} device ms "
            f"({stats['spans']} supersteps, {stats['device_events']} device "
            f"events)")

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. the card's name and power limit (nvidia-smi), and the parallel nvcc
     build of every kernel the main path runs;
  2. each kernel against its plain PyTorch version at the shapes of the
     PageRank graph: triplet (sum to dst, sum to src, min), apply (sum),
     segment_sum — with kernel, plain and library-call times and the
     least time the card's memory rate allows; the triplet kernel (every
     variant), segment_sum and spmv also bit for bit against
     `ref.ordered_segment_reduce`, the model of the summation order they
     share (`csrc/segorder.cuh`), with the piece tables' sizes logged; the
     apply kernel (min, CC's vprog) also on CC's graph, built here for
     phase 4: bit-equal, leaves passed through not copied, VB, CTAs and
     shared memory from `superstep.plan`, the median of 5 x 20 calls and
     the device time beside the 5-call time, the bound over the
     function's own bytes beside the earlier inverse-table formula, and a mutant
     (`apply_rng` with one granule's range of one source partition cut
     short by one entry at a CTA boundary) that must fail the check;
  3. PageRank (tol 0, 10 supersteps) on rmat(22, 16, seed=0), P=4: fused
     plans, bit-equal to the unfused plan, within 1e-4 of a float64 oracle;
     then 3 supersteps traced: the home half's launches and device ms a
     superstep (pregel's apply_home span, `repro_torch.profiling`);
  3b. on the same graph, PageRank over the int8 wire, and with
     narrow-resident int8, fp8_e4m3 and fp8_e5m2 mirrors (the triplet
     kernel reading the encoded rows through their scale plane): fused
     plans, bit-equal to the unfused plan under each resident codec,
     normalised ranks within 1e-3 of the f32 run, int8 resident within
     10/254 relative L2 of the int8 wire-only run, mirror bytes <= 0.35x
     and int8 wire bytes <= 1/3 of the f32 run's; then the PageRank send as
     one mrTriplets over bf16 vertex properties (the bf16 row variant),
     bit-equal to its unfused plan;
  4. connected components on symmetrize(rmat(21, 16, seed=1)), P=4: labels
     bit-equal to scipy's min-id labels and to the unfused plan; then a
     traced run's home half, as in phase 3;
  4b. the rest of the main path, each main-path run counted alone (the
     launch counts set to 0 just before it and read just after; the
     kernels its plans run must each launch, and the triangle count
     launches segment_sum and neither triplet nor apply; the unfused
     comparison runs are not counted):
     on CC's graph (edge weights w ~ U(0.5, 3) from default_rng(1)),
     SSSP from vertex 0 (fused send and apply, fused == unfused, INF32
     exactly where scipy's dijkstra gives inf, the rest within 1e-5
     relative), label propagation (k 16, labels vid % 16, 10 iterations:
     the 16-column send and apply fused; fused == unfused ==
     a host vote), subgraph(vid % 3 != 0) (the structure shared, the edge
     mask == both endpoints visible, CC on it == scipy on the induced
     subgraph), coarsen (Listing 7, domains vid // 16: pages preserved,
     edges == a host oracle, PageRank on the result fused == unfused);
     the transpose of phase 3's graph (in-degrees == out-degrees bit for
     bit through the permuted "dst" walk; PageRank fused == unfused,
     within 1e-4 of the oracle on (dst, src)); the triangle count on
     symmetrize(rmat(15, 16, seed=1)) (per-vertex counts == scipy's
     exactly, peak device memory logged); and
     examples/torch_quickstart.py, whose lines must equal the JAX
     quickstart's;
  5. the flash attention kernel against its plain version at the serve
     step's shape (GQA 4, Lk 1664, non-causal; K/V read in place through
     the strides the cross-attention's einsum leaves, with no copy, and
     bit-equal to the kernel on contiguous copies), a causal 4096-token
     prefill and a 512-token chunk over a 4096-token cache (kv_offset
     3584), with the body, CTAs and splits `plan` chose, kernel, plain and
     scaled_dot_product_attention times (masked, and is_causal at
     kv_offset 0; 5 calls as every kernel row, beside them the median of
     5 runs of 20 calls and the device's own time) and the bound;
  6. serving llama-3.2-vision-11b at its full config (40 layers, random
     weights from a seed): batch 4, prompt 32, 16 generated tokens, every
     cross-attention through the flash kernel (8 layers x 47 steps = 376
     launches, no input copied), then the last step again: with the plain
     attention, whose logits must agree in the mean, and with every flash
     call held in place against its plain version on the same inputs
     (dropping any one of `plan`'s key splits must fail that check in
     every layer);
  7. the mLSTM forward and backward kernels against their plain versions
     at xlstm-350m's shape [8, 4, 1024, 256] chunk 64, SMOKE's heads and
     chunk 128, with the body, grids and shared memory `plan` chose (the
     tensor-core pair at Dh 256, asserted): the forward per element within
     a limit derived from f32 accumulation, the gradients per input within
     a relative-norm limit, and the forward against the token-by-token
     recurrence at L 256 (scripts/mlstm_mutants.py dry-runs these checks
     on the CPU with a dropped inter-chunk term and a cut dC carry, which
     must fail them; scripts/mlstm_kernel_sweep.py holds a one-TF32-term
     mutant to the forward limit on the card); times on the 5-call clock
     with the median of 5 x 20 calls and the device time beside it, and
     the bound at the three-term TF32 rate (495 / 3 TFLOP/s) beside the
     f32 one;
  8. training xlstm-350m at its full config (24 layers, 179 M f32
     parameters, random weights from a seed) through
     `python -m repro_torch.launch.train`'s entry point: batch 8, seq 1024,
     3 AdamW steps, 18 mLSTM forward and 18 backward launches per step,
     finite losses; then step 1 again from the same weights and batch:
     through the kernels with every mLSTM forward and backward call held in
     place against its plain version on the same inputs and cotangent, and
     through the plain versions, whose loss must agree.
Phase 2 also runs spmv (the PageRank send as one SpMV through the triplet
kernel) against its plain version and a CSR `torch.sparse.mm`, and the
triplet kernel on the PageRank send's rows encoded by `wire.encode_resident`
(int8, fp8 e4m3 and e5m2 with their scale planes) and in bf16: bit-equal to
the kernel on the decoded f32 rows and to the ordered model, with a mutant
(the scale plane zeroed) that must fail that check.
It then prints the kernel table as one JSON line and, last, the device line
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_FLOPS = 67e12              # H100 SXM f32 rate outside the tensor cores
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core rate
TF32_FLOPS = 495e12            # H100 SXM dense TF32 tensor-core rate
TF32_TERMS = 3                 # mLSTM products: hi*hi + hi*lo + lo*hi
F32_U = 2.0 ** -24             # f32 unit roundoff
P = 4
PR_SCALE, CC_SCALE, PR_ITERS = 22, 21, 10
SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = "llama-3.2-vision-11b", 4, 32, 16
BF16_STEP = 2.0 ** -8          # bf16 unit roundoff: half its 2^-7 spacing
# mean |kernel - plain| over a serve step's logits: between the largest
# sound reading (0.00427) and the smallest with one of the flash plan's
# nine key splits dropped (0.00776) over weight seeds 0-3,
# scripts/serve_logit_margin.py on an NVIDIA H100 80GB HBM3 at 700 W
SERVE_LOGIT_MEAN_LIMIT = 0.006
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "xlstm-350m", 8, 1024, 3
# phase 7 shapes (name, B, H, L, Dh, chunk): the slice's, SMOKE's heads, and
# chunk 128 at the slice's width
MLSTM_SHAPES = [("slice: xlstm-350m, batch 8, seq 1024", 8, 4, 1024, 256, 64),
                ("SMOKE heads (Dh 32)", 2, 2, 256, 32, 64),
                ("chunk 128", 8, 4, 1024, 256, 128)]
# phase 8: step 1's loss through the kernels vs through the plain versions,
# from the same weights and batch (scripts/train_grad_spread.py on an NVIDIA
# H100 80GB HBM3, 700 W): 11.2670908 vs 11.2640438, 2.7e-4 relative, so the
# limit is 1e-3 (3.7x).  It checks that the whole model runs the same
# function through the kernels; it is not meant to separate a fault inside
# one mLSTM call, which moves a loss over 8 x 1024 tokens too little.  The
# check that does is every mLSTM forward and backward call of the step held
# in place against the plain version on the same inputs.  Whole-model
# gradients are not compared: at this size the plain version's own gradient
# moved by 0.12 to 1.82 relative norm per leaf when the weights moved by a
# relative 1e-6 (the normaliser's max(|den|, exp(-m)) switches branch under
# rounding), so no limit that a sound run meets would fail a wrong one.
TRAIN_LOSS_LIMIT = 1e-3
# phase 3b: the narrow-resident codecs, and the contracts of the reference's
# tests (test_wire.py:test_pagerank_int8_wire_error_and_bytes_regression,
# test_view.py:test_narrow_resident_f32_pagerank_norm_err)
RESIDENT_CODECS = ("int8", "fp8_e4m3", "fp8_e5m2")
RANK_LIMIT = 1e-3              # max |normalised rank - f32 run's|
DRIFT_PER_STEP = 1 / 254       # relative L2, resident vs wire-only, a step
MIRROR_RATIO_LIMIT = 0.35      # resident mirror bytes / f32 mirror bytes
WIRE_RATIO_LIMIT = 1 / 3       # int8 bytes_on_wire / f32 bytes_on_wire


def log(*a):
    print(*a, flush=True)


def _to_bf16(vid, v):
    """PageRank's vertex properties in bf16: its send then reads bf16 rows."""
    import torch
    return {**v, "deg": v["deg"].to(torch.bfloat16),
            "pr": v["pr"].to(torch.bfloat16)}


def cuda_ms(fn, n: int = 5) -> float:
    """Mean milliseconds of `fn` on the card over n runs after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def median_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Median over `reps` runs of `cuda_ms(fn, n)`: a call whose host side
    outlasts its kernels is timed by the host, which the machine shares,
    and a single run of it swings (kept beside `cuda_ms`, not in its
    place)."""
    import statistics
    return statistics.median(cuda_ms(fn, n) for _ in range(reps))


def queued_ms(fn, n: int = 20) -> float | None:
    """Device milliseconds a call of `fn` over n calls back to back, timed
    by CUDA events with the stream held by a sleep kernel until the host
    has queued all n, so no host time enters (no profiler); None if the
    sleep ended first."""
    import torch
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(1_000_000_000)        # ~0.5 s at the H100's clock
    a.record()
    for _ in range(n):
        fn()
    b.record()
    ahead = not a.query()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n if ahead else None


def device_ms(fn, n: int = 20) -> tuple[float | None, str]:
    """Mean device milliseconds of `fn`'s kernels over n runs after a
    warm-up (torch.profiler's summed kernel time): the card's share of a
    call whose host side may set `cuda_ms`; and how it was read.  Each
    call launches the same kernels, so each kernel's record count is a
    multiple of n; where it is not, or the profiler returned no kernel
    record, records were lost (seen with torch 2.11) and the time is
    `queued_ms` instead, as the second value says (None: not measured)."""
    import collections
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    recs = collections.Counter()
    total = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            recs[e.key] += e.count
            total += e.device_time_total
    if recs and all(c % n == 0 for c in recs.values()):
        return total / n / 1e3, "profiler"
    got = ", ".join(f"{k[:40]} {c}" for k, c in recs.items()) or "none"
    ms = queued_ms(fn, n)
    return ms, (f"{'queued events' if ms is not None else 'not measured'} "
                f"(the profiler returned kernel records {got} for {n} calls)")


def cold_device_ms(fn, kernel: str, n: int = 20) -> float | None:
    """Mean device milliseconds of the one kernel a call of fn launches
    whose name holds `kernel`, over n runs of fn after a warm-up, with a
    128 MB write before each run: fn's inputs out of the card's 50 MB L2,
    as the rest of a superstep leaves them.  The mean is over the records
    the profiler returned (it may lose some); None if it returned none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    junk = torch.empty(32 * 2**20, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            junk.zero_()
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and kernel in e.key]
    count = sum(e.count for e in evs)
    if count != n:
        log(f"    cold_device_ms: {count} records of {kernel} for {n} "
            "calls; the mean is over those")
    return sum(e.device_time_total for e in evs) / count / 1e3 if count \
        else None


def ms_str(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def bound(nbytes: float, flops: float,
          peak: float = F32_FLOPS) -> tuple[float, str]:
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def flash_limit(want):
    """Per-element limit on |kernel - plain| for a bf16 flash output: both
    sum the same f32 terms in different orders (a few f32 roundings apart)
    and round once to bf16, so they may part by one bf16 spacing of the
    value, at most 2 * BF16_STEP * |value|, plus 1e-6 for values near 0.
    Dropping one key split moves an output by a share of its own size."""
    return 2 * BF16_STEP * want.float().abs() + 1e-6


def visible_pairs(lq: int, lk: int, causal: bool, kv_offset: int) -> int:
    """(query, key) pairs the attention computes: row i sees keys
    j <= i + kv_offset when causal."""
    if not causal:
        return lq * lk
    import numpy as np
    return int(np.clip(np.arange(lq) + kv_offset + 1, 0, lk).sum())


def ir_flops(ir) -> int:
    return sum(op.kind in ("add", "sub", "mul", "div", "min", "max", "cmp",
                           "where", "neg", "abs") for op in ir.ops)


# mLSTM backward vs autograd of the plain version, relative norm per input.
# Both differentiate the same f32 function with sums in other orders, and
# the gradient is ill-conditioned: against the same scan in float64 the
# plain version itself errs by up to 7.5e-5 and the tensor-core kernel by
# up to 7.7e-5 (chunk 128 below), and rows where the normaliser's branch
# max(|den|, exp(-m)) is ambiguous flip between two valid gradients.  On an
# NVIDIA H100 80GB HBM3 at 700 W (scripts/mlstm_kernel_sweep.py) the
# kernel read up to 1.42e-4 against the plain version (eleven shapes and
# the three below), and the one-TF32-term mutant 6.6e-3 to 0.26 at the
# three shapes below; 1e-3 sits 7x above the one and 6.6x below the other.
# A dC carry cut at one chunk boundary moves the gradients by more
# (scripts/mlstm_mutants.py, on the CPU).
MLSTM_GRAD_REL_LIMIT = 1e-3


def mlstm_bounds(q, k, v, logi, logf, chunk: int, want):
    """(limit, ambiguous) for two f32 evaluations of the chunkwise mLSTM.

    limit: per element, on |out - want|.  out = num / g with num and den
    sums over at most n = 2 Dh + L + W + 16 chained terms (q.k over Dh,
    att.v over W, q.C over Dh, C over L tokens, and the roundings of exp and
    the division), so each evaluation is within gamma_n * (sum|terms of num|
    + |out| * sum|terms of den|) / g of the exact value (Higham 3.1); the
    sums of |terms| are the plain version run on |q|, |k|, |v| (its weights
    are positive).  Two evaluations differ by at most twice that.

    ambiguous: rows [B, H, L] where the two may take different branches of
    g = max(|den|, exp(-m)), ||den| - exp(-m)| within den's bound 2 gamma_n
    sum|den terms|; the gradient jumps between the branches there, and both
    are valid."""
    import torch
    from repro_torch.kernels import ref
    _, den, m = ref.mlstm_parts(q, k, v, logi, logf, chunk=chunk)
    num_a, den_a, _ = ref.mlstm_parts(q.abs(), k.abs(), v.abs(), logi, logf,
                                      chunk=chunk)
    g = torch.maximum(den.abs(), torch.exp(-m))
    n = 2 * q.shape[3] + q.shape[2] + min(chunk, q.shape[2]) + 16
    gamma = n * F32_U / (1 - n * F32_U)
    limit = 2 * gamma * (num_a.double() + want.double().abs()
                         * den_a.double()[..., None]) / g.double()[..., None]
    return limit, (den.abs() - torch.exp(-m)).abs() <= 2 * gamma * den_a


def mlstm_check(kernel, q, k, v, logi, logf, chunk: int, dout) -> dict:
    """Hold kernel(q, k, v, logi, logf, chunk) (differentiable) against the
    plain version: the forward per element within `mlstm_bounds`' limit,
    the gradients of <out, dout> per input within MLSTM_GRAD_REL_LIMIT
    relative norm.  Raises AssertionError; returns the readings."""
    import torch
    from repro_torch.kernels import ref
    ins = [t.detach().clone().requires_grad_() for t in (q, k, v, logi, logf)]
    pins = [t.detach().clone().requires_grad_() for t in (q, k, v, logi, logf)]
    out = kernel(*ins, chunk)
    want = ref.mlstm_chunked(*pins, chunk=chunk)
    grads = torch.autograd.grad(out, ins, dout)
    pgrads = torch.autograd.grad(want, pins, dout)
    with torch.no_grad():
        limit = mlstm_bounds(q, k, v, logi, logf, chunk, want)[0]
        diff = (out.double() - want.double()).abs()
        ratio = float((diff / limit).max())
        if ratio > 1:
            raise AssertionError(f"mlstm forward: {int((diff > limit).sum())}"
                                 f" outputs beyond their limit (max |err| "
                                 f"{float(diff.max()):.3g}, worst err/limit "
                                 f"{ratio:.3g})")
        rel = {n: float((g - pg).norm() / pg.norm()) for n, g, pg in zip(
            ("q", "k", "v", "logi", "logf"), grads, pgrads)}
        bad = {n: r for n, r in rel.items() if not r <= MLSTM_GRAD_REL_LIMIT}
        if bad:
            raise AssertionError(f"mlstm backward: relative error {bad} > "
                                 f"{MLSTM_GRAD_REL_LIMIT}")
        grad_err = max(float((g - pg).abs().max())
                       for g, pg in zip(grads, pgrads))
    return {"max_abs_err": float(diff.max()), "worst_err_over_limit": ratio,
            "max_limit": float(limit.max()), "grad_rel_err": rel,
            "grad_max_abs_err": grad_err}


def mlstm_recurrence_check(out, q, k, v, logi, logf, chunk: int) -> dict:
    """Hold a chunkwise forward `out` against the token-by-token recurrence
    of `mlstm_step`'s math (`models.recurrent.mlstm_cell`, its own running
    stabiliser), per element within `mlstm_bounds`' limit: another
    algorithm, the same function, f32 sums over the same terms."""
    import torch
    from repro_torch.models import recurrent as R
    with torch.no_grad():
        b, h, l, dh = q.shape
        st = R.mlstm_init_state(b, h, dh, device=q.device)
        steps = []
        for t in range(l):
            y, st = R.mlstm_cell(q[:, :, t], k[:, :, t], v[:, :, t],
                                 logi[:, :, t], logf[:, :, t], st)
            steps.append(y)
        rec = torch.stack(steps, 2)
        limit = mlstm_bounds(q, k, v, logi, logf, chunk, rec)[0]
        diff = (out.double() - rec.double()).abs()
        ratio = float((diff / limit).max())
    if ratio > 1:
        raise AssertionError(f"mlstm forward vs recurrence: "
                             f"{int((diff > limit).sum())} outputs beyond "
                             f"their limit (worst err/limit {ratio:.3g})")
    return {"max_abs_err": float(diff.max()), "worst_err_over_limit": ratio}


def mlstm_inputs(b, h, l, dh, gen, device):
    """Inputs drawn as tests/test_kernels.py:556-560 draws them."""
    import torch
    q = torch.randn((b, h, l, dh), generator=gen) * 0.5
    k = torch.randn((b, h, l, dh), generator=gen) * 0.5
    v = torch.randn((b, h, l, dh), generator=gen)
    logi = torch.randn((b, h, l), generator=gen).clamp(-8, 4)
    logf = -torch.randn((b, h, l), generator=gen).abs() * 0.2
    return [t.to(device) for t in (q, k, v, logi, logf)]


LP_LABELS, LP_ITERS = 16, 10          # phase 4b label propagation
TRI_SCALE = 15                         # phase 4b triangle count graph
# what examples/quickstart.py prints (the JAX reference, on the CPU)
QUICKSTART_LINES = [
    "graph: 1024 vertices, 6716 edges",
    "vertices over 40: 583",
    "mrTriplets join arity after elimination: 3 (UDF reads both endpoints "
    "-> 3-way)",
    "subgraph shares structure with parent: True",
    "top-5 by PageRank: [0, 1, 256, 128, 2]",
    "connected components: 1 (in 4 supersteps)",
    "triangles: 24411"]


def load_example(name: str):
    """examples/<name>.py as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lp_init(vid, v):
    return {"label": vid % LP_LABELS}


def _third_visible(vid, v):
    return vid % 3 != 0


def _coarse_init(vid, v):
    import torch
    return {"pages": torch.tensor(1.0), "dom": vid // 16}


def _same_domain(sv, ev, dv):
    return sv["dom"] == dv["dom"]


def min_id_labels(n, src, dst, ids):
    """Each vertex id of `ids` -> the least id of its component in the
    undirected graph (src, dst) over n ids (scipy)."""
    import numpy as np
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components as sp_cc
    adj = csr_matrix((np.ones(len(src), np.int8), (src, dst)), shape=(n, n))
    _, lab = sp_cc(adj, directed=False)
    minid = np.full(lab.max() + 1, n, np.int64)
    np.minimum.at(minid, lab[ids], ids)
    return minid[lab[ids]]


def main_path_run(tally, label, fn, launched=(), idle=()):
    """One main-path call of phase 4b, counted alone: the launch counts set
    to 0 just before `fn` and read just after.  Each kernel of `launched`
    must have launched in it and none of `idle`; its counts go into
    tally[label] (the unfused comparison runs and the checks stay
    outside)."""
    import torch
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    for k in launched:
        if counts.get(k, 0) <= 0:
            raise AssertionError(f"{label}: kernel {k} never launched")
    for k in idle:
        if counts.get(k, 0):
            raise AssertionError(f"{label}: kernel {k} launched {counts[k]} "
                                 "times; its plans run no such kernel")
    tally[label] = {k: n for k, n in counts.items() if n}
    return out


def check_plans(label, r, want=("fused", "fused_apply")):
    m0 = r.metrics[0]
    if (m0["plan"], m0["apply_plan"]) != want:
        raise AssertionError(f"{label} plans {m0['plan']}, "
                             f"{m0['apply_plan']}; want {want}")


def phase_4b_graphs(g, gd, sg, sgd, w_cc, tally):
    """SSSP, label propagation, subgraph + CC and coarsen on CC's graph,
    and the transpose of PageRank's graph (phase 4b; see the docstring).
    The launches of each main-path run go into `tally`."""
    import numpy as np
    import torch
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra
    from repro_torch.core import algorithms as alg
    from repro_torch.core import mrtriplets as mt

    n = sgd.num_vertices
    ids_np = sg.vertices_to_numpy()[0]

    # --- weighted SSSP from vertex 0
    g_dist = sg.mapV(lambda vid, v: {"dist": torch.tensor(0.0)})
    if mt.plan_of(g_dist, alg.sssp_send, "min") != "fused" or \
            mt.apply_plan_of(g_dist, alg.sssp_vprog, alg.sssp_send, "min",
                             default_msg={"m": torch.tensor(alg.INF32)}) \
            != "fused_apply":
        raise AssertionError("sssp plans: want fused, fused_apply")
    del g_dist
    t0 = time.perf_counter()
    s_f = main_path_run(tally, "sssp", lambda: alg.sssp(sg, 0),
                        ("triplet", "apply"))
    t_f = time.perf_counter() - t0
    s_u = alg.sssp(sg, 0, kernel_mode="unfused")
    if not torch.equal(s_f.graph.vdata["dist"], s_u.graph.vdata["dist"]) \
            or s_f.supersteps != s_u.supersteps:
        raise AssertionError("sssp: fused != unfused")
    _, vals = s_f.graph.vertices_to_numpy()
    dist = vals["dist"]
    adj_w = csr_matrix((w_cc.astype(np.float64), (sgd.src, sgd.dst)),
                       shape=(n, n))
    want = dijkstra(adj_w, directed=True, indices=0)[ids_np]
    unreached = np.isinf(want)
    if not np.array_equal(dist == alg.INF32, unreached):
        raise AssertionError("sssp: unreached vertices differ from scipy's")
    rel = np.abs(dist[~unreached] - want[~unreached]) / np.maximum(
        want[~unreached], 1e-30)
    if not rel.max() <= 1e-5:
        raise AssertionError(f"sssp vs scipy dijkstra: {rel.max()}")
    log(f"  sssp from 0: {s_f.supersteps} supersteps, fused {t_f:.3f} s; "
        f"plans fused, fused_apply; fused == unfused bit for bit; "
        f"{int((~unreached).sum())} reached, {int(unreached.sum())} at "
        f"INF32 where dijkstra gives inf; max rel err {rel.max():.3g} vs "
        f"scipy dijkstra (f64)")
    del s_f, s_u, adj_w, want, dist

    # --- label propagation, k = 16, labels vid % 16
    sgl = sg.mapV(_lp_init)
    send, vprog = alg.label_propagation_fns(LP_LABELS)
    if mt.plan_of(sgl, send, "sum") != "fused" or mt.apply_plan_of(
            sgl, vprog, send, "sum",
            default_msg={"votes": torch.zeros(LP_LABELS)}) != "fused_apply":
        raise AssertionError("label propagation plans: want fused, "
                             "fused_apply")
    t0 = time.perf_counter()
    l_f = main_path_run(tally, "label propagation", lambda: (
        alg.label_propagation(sgl, LP_LABELS, num_iters=LP_ITERS)),
        ("triplet", "apply"))
    t_f = time.perf_counter() - t0
    l_u = alg.label_propagation(sgl, LP_LABELS, num_iters=LP_ITERS,
                                kernel_mode="unfused")
    if not torch.equal(l_f.graph.vdata["label"], l_u.graph.vdata["label"]) \
            or l_f.supersteps != l_u.supersteps:
        raise AssertionError("label propagation: fused != unfused")
    lids, lvals = l_f.graph.vertices_to_numpy()
    want = alg.label_propagation_reference(
        sgd.src, sgd.dst, np.arange(n) % LP_LABELS, LP_LABELS, LP_ITERS)
    if not np.array_equal(lvals["label"], want[lids]):
        raise AssertionError("label propagation differs from the host vote")
    log(f"  label propagation k={LP_LABELS}: {l_f.supersteps} supersteps, "
        f"fused send and apply (dm {LP_LABELS}) {t_f:.3f} s; fused == "
        f"unfused, labels == the host vote")
    del sgl, l_f, l_u, want

    # --- subgraph: every third id hidden; CC on it
    sub = sg.subgraph(vpred=_third_visible)
    if sub.s is not sg.s:
        raise AssertionError("subgraph rebuilt the structure")
    svid, dvid, _, emask = sg.edges()
    es, ed = svid.cpu().numpy(), dvid.cpu().numpy()
    host = emask.cpu().numpy() & (es % 3 != 0) & (ed % 3 != 0)
    if not np.array_equal(sub.emask.cpu().numpy(), host):
        raise AssertionError("subgraph emask != both endpoints visible")
    c_f = main_path_run(tally, "cc on the subgraph", lambda: (
        alg.connected_components(sub, track_metrics=True)),
        ("triplet", "apply"))
    check_plans("cc on the subgraph", c_f)
    c_u = alg.connected_components(sub, kernel_mode="unfused")
    if not torch.equal(c_f.graph.vdata["cc"], c_u.graph.vdata["cc"]) \
            or c_f.supersteps != c_u.supersteps:
        raise AssertionError("cc on the subgraph: fused != unfused")
    cids, cvals = c_f.graph.vertices_to_numpy()
    keep = host[emask.cpu().numpy()]
    es_l, ed_l = es[emask.cpu().numpy()], ed[emask.cpu().numpy()]
    if not np.array_equal(cvals["cc"], min_id_labels(
            n, es_l[keep], ed_l[keep], cids)):
        raise AssertionError("cc on the subgraph != scipy on the induced "
                             "subgraph")
    log(f"  subgraph(vid % 3 != 0): shares the structure, {int(host.sum())} "
        f"of {int(emask.sum())} edges kept == host mask; cc on it "
        f"{c_f.supersteps} supersteps, fused == unfused, labels == scipy")
    del sub, c_f, c_u, svid, dvid, es, ed, host, keep, es_l, ed_l

    # --- reverse PageRank's graph: the "dst" side walks the old src order
    gr = g.reverse()
    din, _ = main_path_run(tally, "reverse: in-degrees",
                           lambda: gr.degrees("in"), ("triplet",))
    dout, _ = g.degrees("out")
    if not torch.equal(din, dout):
        raise AssertionError("reverse().degrees('in') != degrees('out')")
    t0 = time.perf_counter()
    p_f = main_path_run(tally, "pagerank on the transpose", lambda: (
        alg.pagerank(gr, num_iters=PR_ITERS, track_metrics=True)),
        ("triplet", "apply"))
    t_f = time.perf_counter() - t0
    check_plans("pagerank on the transpose", p_f)
    p_u = alg.pagerank(gr, num_iters=PR_ITERS, kernel_mode="unfused")
    if not torch.equal(p_f.graph.vdata["pr"], p_u.graph.vdata["pr"]):
        raise AssertionError("pagerank on the transpose: fused != unfused")
    pids, pvals = p_f.graph.vertices_to_numpy()
    want = alg.pagerank_reference(gd.dst, gd.src, gd.num_vertices,
                                  PR_ITERS)[pids]
    rel = float(np.max(np.abs(pvals["pr"] - want)) / np.max(np.abs(want)))
    if not rel <= 1e-4:
        raise AssertionError(f"pagerank on the transpose vs oracle: {rel}")
    log(f"  reverse of rmat({PR_SCALE},16): in-degrees == the original's "
        f"out-degrees bit for bit; pagerank {PR_ITERS} supersteps fused "
        f"{t_f:.3f} s, fused == unfused, max|pr-ref|/max|ref| = {rel:.3g}")
    del gr, din, dout, p_f, p_u, want

    # --- coarsen (Listing 7) on CC's graph: domains vid // 16, pages summed
    cgd, cg = sgd, sg
    t0 = time.perf_counter()
    coarse = main_path_run(tally, "coarsen", lambda: alg.coarsen(
        cg.mapV(_coarse_init), _same_domain, "sum"), ("triplet", "apply"))
    t_c = time.perf_counter() - t0
    vids_c = cg.vertices_to_numpy()[0]
    intra = cgd.src // 16 == cgd.dst // 16
    comp = np.zeros(cgd.num_vertices, np.int64)
    comp[vids_c] = min_id_labels(cgd.num_vertices, cgd.src[intra],
                                 cgd.dst[intra], vids_c)
    kids, kvals = coarse.vertices_to_numpy()
    sizes = np.bincount(comp[vids_c], minlength=cgd.num_vertices)
    if not (np.array_equal(np.sort(kids), np.unique(comp[vids_c]))
            and np.array_equal(kvals["pages"], sizes[kids].astype(np.float32))
            and float(kvals["pages"].sum()) == len(vids_c)):
        raise AssertionError("coarsen: super-vertices or pages differ")
    pair = lambda a, b: (a.astype(np.int64) << 32) | b  # noqa: E731
    ces, ced, _ = coarse.edges_to_numpy()
    cs, cd = comp[cgd.src[~intra]], comp[cgd.dst[~intra]]
    want = np.sort(pair(cs[cs != cd], cd[cs != cd]))
    if not np.array_equal(np.sort(pair(ces, ced)), want):
        raise AssertionError("coarsen: edge set differs from the host oracle")
    k_f = main_path_run(tally, "pagerank on the coarse graph", lambda: (
        alg.pagerank(coarse, num_iters=10, track_metrics=True)),
        ("triplet", "apply"))
    check_plans("pagerank on the coarse graph", k_f)
    k_u = alg.pagerank(coarse, num_iters=10, kernel_mode="unfused")
    if not torch.equal(k_f.graph.vdata["pr"], k_u.graph.vdata["pr"]):
        raise AssertionError("pagerank on the coarse graph: fused != unfused")
    log(f"  coarsen of {cg.s.num_vertices} pages, {cg.s.num_edges} links: "
        f"{coarse.s.num_vertices} super-vertices, {coarse.s.num_edges} "
        f"links in {t_c:.1f} s (host rebuild included); pages preserved, "
        f"edges == host oracle; pagerank 10 supersteps fused == unfused")


def phase_4b_triangles(dev, tally):
    """Triangle count on symmetrize(rmat(TRI_SCALE, 16, seed=1)): per-vertex
    counts == scipy's exactly, their f64 sum / 3 == scipy's total."""
    import numpy as np
    import torch
    from scipy.sparse import csr_matrix
    from repro_torch.core import algorithms as alg
    from repro_torch.core.graph import Graph
    from repro_torch.data import rmat, symmetrize

    tgd = symmetrize(rmat(TRI_SCALE, 16, seed=1))
    n = tgd.num_vertices
    tg = Graph.from_edges(tgd.src, tgd.dst, num_partitions=P, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    # both phases plan unfused: phase 2's f32 sums go through segment_sum
    per, total, m = main_path_run(
        tally, "triangle count", lambda: alg.triangle_count(tg, n_ids=n),
        ("segment_sum",), ("triplet", "apply"))
    t_t = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if (m["phase1"]["plan"], m["phase2"]["plan"]) != ("unfused", "unfused"):
        raise AssertionError(f"triangle count plans {m['phase1']['plan']}, "
                             f"{m['phase2']['plan']}")
    ids = tg.vertices_to_numpy()[0]
    got = per[tg.vmask].cpu().numpy()
    adj = csr_matrix((np.ones(tgd.num_edges, np.int64), (tgd.src, tgd.dst)),
                     shape=(n, n))
    t_v = np.asarray(adj.dot(adj).multiply(adj).sum(axis=1)).ravel() // 2
    if not np.array_equal(got.astype(np.int64), t_v[ids]) or \
            not np.array_equal(got, t_v[ids].astype(np.float32)):
        raise AssertionError("triangle count: per-vertex counts != scipy's")
    exact = float(got.astype(np.float64).sum()) / 3
    if exact != t_v.sum() / 3:
        raise AssertionError(f"triangle count total {exact} != scipy's "
                             f"{t_v.sum() / 3}")
    log(f"  triangles on symmetrize(rmat({TRI_SCALE},16)): {n} ids, "
        f"{tgd.num_edges} edges, {int(exact)} triangles (f64 sum of the "
        f"per-vertex counts / 3 == scipy), per-vertex counts == scipy; f32 "
        f"total {float(total):.1f} (the per-vertex sum "
        f"{float(got.sum(dtype=np.float32)):.1f} against 2^24 = {2**24}); "
        f"{t_t:.2f} s, peak device memory "
        f"{peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} GiB above the "
        f"graph)")


def phase_4b_quickstart(qs_mod, dev, tally):
    """examples/torch_quickstart.py on the card prints the JAX quickstart's
    lines."""
    import contextlib
    import io
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        main_path_run(tally, "torch quickstart", lambda: qs_mod.main(
            device=dev), ("triplet", "apply", "segment_sum"))
    got = buf.getvalue().splitlines()
    if got != QUICKSTART_LINES:
        raise AssertionError(f"torch quickstart printed {got}")
    log(f"  torch quickstart on the card: {time.perf_counter() - t0:.1f} s, "
        f"its 7 lines == the JAX quickstart's")


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import algorithms as alg
    from repro_torch.core import mrtriplets as mt
    from repro_torch.core import wire
    from repro_torch.core import with_wire
    from repro_torch.core.graph import Graph, _degree_msg
    from repro_torch.data import rmat, symmetrize
    from repro_torch.kernels import build, ops, ref, segorder
    from repro_torch.kernels import segment_sum as seg_mod
    from repro_torch.kernels.applyroute import APPLY_GRAN
    from repro_torch.kernels import superstep as app_mod
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import mlstm as mlstm_mod
    from repro_torch.kernels import spmv as spmv_mod
    from repro_torch.kernels import triplet as tri_mod
    from repro_torch import configs as C
    from repro_torch.data.tokens import SyntheticLM
    from repro_torch.launch import serve
    from repro_torch.launch import train as train_launch
    from repro_torch.models import transformer as T
    from repro_torch.train import train_loop as tl
    from repro_torch import profiling as prof_mod

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)

    # ---------------------------------------------------------- phase 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    tiny = rmat(6, 4, seed=0)
    gt = Graph.from_edges(tiny.src, tiny.dst, num_partitions=P, device=dev)
    # the main path's vertex data layouts, built through the plain versions
    g_pr_t = alg.attach_out_degree(gt, kernel_mode="ref").mapV(alg._pr_init)
    g_cc_t = gt.mapV(alg._cc_init)
    pr_vprog = alg.pagerank_vprog(0.15)
    zero_msg = {"m": torch.tensor(0.0)}
    imax_msg = {"m": torch.tensor(alg.IMAX, dtype=torch.int32)}
    k_pr = mt.fused_plan(g_pr_t, alg.pagerank_send, "sum").kernel
    k_deg = mt.fused_plan(gt, _degree_msg, "sum").kernel
    k_cc = mt.fused_plan(g_cc_t, alg.cc_send, "min").kernel
    a_pr = mt._plan_apply(g_pr_t, pr_vprog, alg.pagerank_send, "sum", None,
                          zero_msg, None).kernel
    a_cc = mt._plan_apply(g_cc_t, alg.cc_vprog, alg.cc_send, "min", None,
                          imax_msg, None).kernel
    sources = [("triplet", tri_mod.source(k_pr, "sum", "dst")),
               ("triplet", tri_mod.source(k_deg, "sum", "src")),
               ("triplet", tri_mod.source(k_cc, "min", "dst")),
               ("apply", app_mod.source(a_pr, "sum")),
               ("apply", app_mod.source(a_cc, "min")),
               ("segment_sum", seg_mod.source()),
               ("flash_attention", flash_mod.source(128)),
               ("triplet", tri_mod.source(spmv_mod.linear_message(1), "sum",
                                          "dst", True))]
    resident_x = [wire.make_codec(c).fdtype for c in RESIDENT_CODECS]
    # the PageRank send reading encoded rows: resident payloads with their
    # scale planes, and bf16 rows (the bf16 send's own UDF on the main path)
    sources += [("triplet", tri_mod.source(k_pr, "sum", "dst", False, dt,
                                           True, 2)) for dt in resident_x]
    sources += [("triplet", tri_mod.source(k_pr, "sum", "dst", False,
                                           torch.bfloat16, False, 2))]
    g_bf_t = g_pr_t.mapV(_to_bf16)
    k_bf = mt.fused_plan(g_bf_t, alg.pagerank_send, "sum").kernel
    sources += [("triplet", tri_mod.source(k_bf, "sum", "dst", False,
                                           torch.bfloat16, False, 2))]
    sources += [("mlstm", mlstm_mod.plan(min(c, l), dh).source())
                for _, _, _, l, dh, c in MLSTM_SHAPES]
    # phase 4b's UDFs: SSSP's send and apply, label propagation's dm-16
    # send and apply, the quickstart's 3-way more_senior, the transpose's walks (its
    # "dst" side through the old src order, its "src" side in stored
    # order), and the apply layouts of PageRank on the quickstart's and the
    # coarse graph's vertex properties
    qs_mod = load_example("torch_quickstart")
    g_sp_t = gt.mapV(lambda vid, v: {"dist": torch.tensor(0.0)})
    inf_msg = {"m": torch.tensor(alg.INF32)}
    k_sp = mt.fused_plan(g_sp_t, alg.sssp_send, "min").kernel
    a_sp = mt._plan_apply(g_sp_t, alg.sssp_vprog, alg.sssp_send, "min", None,
                          inf_msg, None).kernel
    lp_send, lp_vprog = alg.label_propagation_fns(LP_LABELS)
    k_lp = mt.fused_plan(gt.mapV(_lp_init), lp_send, "sum").kernel
    a_lp = mt._plan_apply(gt.mapV(_lp_init), lp_vprog, lp_send, "sum", None,
                          {"votes": torch.zeros(LP_LABELS)}, None).kernel
    k_sen = mt.fused_plan(gt.mapV(lambda vid, v: {"age": vid.float()}),
                          qs_mod.more_senior, "sum").kernel
    sources += [("triplet", tri_mod.source(k_sp, "min", "dst")),
                ("apply", app_mod.source(a_sp, "min")),
                ("triplet", tri_mod.source(k_lp, "sum", "dst")),
                ("apply", app_mod.source(a_lp, "sum")),
                ("triplet", tri_mod.source(k_sen, "sum", "dst")),
                ("triplet", tri_mod.source(k_deg, "sum", "dst", True)),
                ("triplet", tri_mod.source(k_deg, "sum", "src", False)),
                ("triplet", tri_mod.source(k_pr, "sum", "dst", True))]
    for extra in (lambda vid, v: {"age": vid.float()},
                  lambda vid, v: {"pages": vid.float(), "dom": vid}):
        g_x = alg.attach_out_degree(gt.mapV(extra), kernel_mode="ref")
        sources.append(("apply", app_mod.source(mt._plan_apply(
            g_x.mapV(alg._pr_init), pr_vprog, alg.pagerank_send, "sum", None,
            zero_msg, None).kernel, "sum")))
    t0 = time.perf_counter()
    build.prebuild(sources)
    log(f"kernel build: {len(sources)} sources in "
        f"{time.perf_counter() - t0:.1f} s (parallel nvcc)")

    # ---------------------------------------------------------- phase 2
    t0 = time.perf_counter()
    gd = rmat(PR_SCALE, 16, seed=0)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    g = Graph.from_edges(gd.src, gd.dst, num_partitions=P, device=dev)
    torch.cuda.synchronize()
    log(f"pagerank graph rmat({PR_SCALE},16): {g.s.num_vertices} "
        f"vertices, {g.s.num_edges} edges; generate {t_gen:.1f} s, "
        f"build {time.perf_counter() - t0:.1f} s")
    s = g.s
    nl, e_blk, v_mir, v_blk = s.p, s.e_blk, s.v_mir, s.v_blk
    S = nl * v_mir
    live = g.emask.contiguous()
    n_live = int(live.sum())
    ev_w = g.edata["w"].reshape(-1, 1).contiguous()
    x_pr = torch.cat([torch.rand((S, 1), generator=gen) * 50 + 1,
                      torch.rand((S, 1), generator=gen)], 1).to(dev)
    x_cc = torch.randint(0, s.max_vid + 1, (S, 1), generator=gen,
                         dtype=torch.int32).float().to(dev)
    live_half = live & (torch.rand(live.shape, generator=gen) < 0.5).to(dev)
    x0 = torch.zeros((S, 0), device=dev)
    ev0 = torch.zeros((nl * e_blk, 0), device=dev)
    i32 = 4

    results = {}

    def compare(name, got, want, limit=None):
        """max |got - want|, and the tolerance it was held to: exact unless
        `limit` gives a per-slot bound (rows of `got`)."""
        diff = (got.double() - want.double()).abs()
        err = float(diff.max()) if diff.numel() else 0.0
        if limit is None:
            if not torch.equal(got, want):
                raise AssertionError(f"{name} differs from its plain version "
                                     f"(max |err| {err})")
            return err, "0 (exact)"
        limit = limit.reshape(diff.shape)
        over = diff > limit
        if bool(over.any()):
            raise AssertionError(f"{name}: {int(over.sum())} slots beyond "
                                 f"their limit (max |err| {err})")
        worst = float(torch.where(limit > 0, diff / limit, 0.0).max())
        return err, f"per slot 2*gamma(n-1)*sum|m|; worst err/limit {worst:.3g}"

    def record(kernel, variant, err, tol, ms, plain_ms, nbytes, flops,
               library_ms=None, peak=F32_FLOPS):
        b_ms, b_by = bound(nbytes, flops, peak)
        row = {"variant": variant, "max_abs_err": err, "tol": tol, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": library_ms}
        log(f"  {kernel}[{variant}]: err {err:.3g} (tol {tol}) "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} "
            f"ms ({b_by}), library "
            f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'}")
        results.setdefault(kernel, []).append(row)

    def check_triplet(variant, spec, x, ev, lv, to, reduce, exact, library):
        """exact: every message is an integer-valued f32 and every sum stays
        below 2^24, so a sum in any order is exact.  library: (one PyTorch
        call computing the same function, what it leaves out)."""
        perm = s.src_perm if to == "src" else None
        ptr, pieces = s.agg_ptr[to], s.agg_pieces[to]
        call = lambda fn, **kw: fn(x, ev, s.src_slot, s.dst_slot, lv, ptr,  # noqa: E731
                                   perm, spec, to=to, reduce=reduce, **kw)
        kernel = lambda: call(tri_mod.fused_triplet, pieces=pieces)  # noqa: E731
        out_k, cnt_k = kernel()
        out_p, cnt_p = call(ref.fused_triplet)
        out_o, cnt_o = ref.ordered_triplet(x, ev, s.src_slot, s.dst_slot, lv,
                                           ptr, perm, spec, pieces,
                                           reduce=reduce)
        torch.cuda.synchronize()
        compare(f"triplet[{variant}] counts", cnt_k, cnt_p)
        compare(f"triplet[{variant}] vs ordered model", out_k, out_o)
        compare(f"triplet[{variant}] counts vs ordered model", cnt_k, cnt_o)
        del out_o, cnt_o
        limit = None
        if reduce == "sum" and not exact:
            agg, msgs = ref.triplet_messages(x, ev, s.src_slot, s.dst_slot, lv,
                                             ptr, perm, spec, to=to)
            limit = ref.sum_tol(agg, msgs, S)
            del agg, msgs
        err, tol = compare(f"triplet[{variant}]", out_k, out_p, limit)
        nlv = int(lv.sum())
        used = spec.uses("xs") + spec.uses("xd")
        nbytes = (ptr.numel() * i32 + lv.numel()
                  + nlv * i32 * (used + ev.shape[1] + (to == "src"))
                  + x.numel() * 4 + out_k.numel() * 4 + cnt_k.numel() * 4)
        lib_fn, lib_note = library
        record("triplet", f"{variant}; library: {lib_note}", err,
               f"{tol}; bit-equal to the ordered model", cuda_ms(kernel),
               cuda_ms(lambda: call(ref.fused_triplet)), nbytes,
               nlv * (ir_flops(spec.ir) + 1), library_ms=cuda_ms(lib_fn))
        return out_k

    t_phase = time.perf_counter()
    log("phase 2: kernels vs plain versions")
    for side in ("dst", "src"):
        pc = s.agg_pieces[side]
        log(f"  pieces[{side}]: longest segment "
            f"{int(torch.diff(s.agg_ptr[side], dim=1).max())} edges, "
            f"{int(pc.ptr[:, -1].sum())} pieces of at most "
            f"{segorder.SEG_PIECE}, {pc.multi.shape[0]} segments of several "
            f"pieces")
    # the PageRank send (pr / deg * w into dst) as one SpMV over every
    # partition's mirror slots: spmv's tables, and the CSR matrix of
    # torch.sparse.mm, the library call for the send and for spmv
    t0 = time.perf_counter()
    off = (torch.arange(nl, dtype=torch.int32, device=dev) * v_mir)[:, None]
    sp_src = (s.src_slot + off).reshape(-1).contiguous()
    sp_dst = (s.dst_slot + off).reshape(-1).contiguous()
    sp_live = live.reshape(-1)
    sp_tiles = {k: torch.from_numpy(a).to(dev) for k, a in spmv_mod.build_tiles(
        sp_src.cpu().numpy(), sp_dst.cpu().numpy(), sp_live.cpu().numpy(),
        S).items()}
    t_tiles = time.perf_counter() - t0
    log(f"  pieces[spmv]: {int(sp_tiles['piece_ptr'][0, -1])} pieces, "
        f"{sp_tiles['piece_multi'].shape[0]} segments of several pieces")
    sp_x = (x_pr[:, 1:2] / x_pr[:, :1]).contiguous()
    sp_w = torch.where(sp_live, ev_w.reshape(-1), 0.0)
    perm = sp_tiles["perm"][:n_live].long()
    with warnings.catch_warnings():     # "sparse CSR support is in beta"
        warnings.simplefilter("ignore")
        csr = torch.sparse_csr_tensor(sp_tiles["ptr"], sp_src[perm],
                                      sp_w[perm], size=(S, S),
                                      check_invariants=False)
    deg_ids = sp_src[sp_live].long()
    cc_dst = sp_dst[live_half.reshape(-1)].long()
    cc_rows = x_cc[sp_src[live_half.reshape(-1)].long(), 0]
    cc_out = torch.full((S,), ref.REDUCE_IDENTITY["min"], device=dev)
    pr_send = check_triplet(
        "sum,to=dst (pagerank send)", k_pr, x_pr, ev_w, live, "dst", "sum",
        False, (lambda: torch.sparse.mm(csr, sp_x),
                "torch.sparse.mm on the CSR of the live edges with pr / deg "
                "prepared; leaves out the division, the live mask and the "
                "counts"))
    check_triplet("sum,to=src (degree)", k_deg, x0, ev0, live, "src", "sum",
                  True, (lambda: torch.bincount(deg_ids, minlength=S),
                         "torch.bincount over the live edges' source slots "
                         "prepared; leaves out the live mask and the float "
                         "cast"))
    check_triplet("min,to=dst (cc send)", k_cc, x_cc, ev0, live_half,
                  "dst", "min", True,
                  (lambda: cc_out.scatter_reduce_(0, cc_dst, cc_rows, "amin"),
                   "scatter_reduce_ amin of the live edges' source rows "
                   "gathered beforehand; leaves out the gather, the live "
                   "mask and the counts"))
    del deg_ids, cc_dst, cc_rows, cc_out

    def check_encoded(name, xe, xscale, dec):
        """The PageRank send on encoded rows xe (+ scale plane): bit-equal
        to the kernel on the decoded f32 rows dec and to the ordered model,
        within sum_tol of the plain version on (xe, xscale); the kernel with
        the scale plane zeroed must fail the ordered-model check."""
        ptr, pieces = s.agg_ptr["dst"], s.agg_pieces["dst"]
        args = (ev_w, s.src_slot, s.dst_slot, live, ptr, None, k_pr)
        kernel = lambda x, sc: tri_mod.fused_triplet(  # noqa: E731
            x, *args, pieces=pieces, xscale=sc)
        plain = lambda: ref.fused_triplet(xe, *args, xscale=xscale)  # noqa: E731
        out_e, cnt_e = kernel(xe, xscale)
        out_d, cnt_d = kernel(dec, None)
        out_o, _ = ref.ordered_triplet(dec, *args, pieces)
        out_p, _ = plain()
        torch.cuda.synchronize()
        compare(f"triplet_{name} vs the kernel on decoded rows", out_e, out_d)
        compare(f"triplet_{name} counts", cnt_e, cnt_d)
        compare(f"triplet_{name} vs ordered model", out_e, out_o)
        agg, msgs = ref.triplet_messages(dec, *args)
        err, tol = compare(f"triplet_{name}", out_e, out_p,
                           ref.sum_tol(agg, msgs, S))
        del agg, msgs, out_d, out_p
        mutant = "no scale plane"
        if xscale is not None:
            bad, _ = kernel(xe, torch.zeros_like(xscale))
            try:
                compare(f"triplet_{name} mutant (scale plane zeroed)", bad,
                        out_o)
            except AssertionError as e:
                mutant = f"fails as it must: {e}"
            else:
                raise AssertionError(f"triplet_{name}: the zeroed scale "
                                     f"plane passed the check")
            del bad
        log(f"  triplet_{name} mutant: {mutant}")
        nlv = int(live.sum())
        nbytes = (ptr.numel() * i32 + live.numel() + nlv * i32 * 2
                  + xe.numel() * xe.element_size()
                  + (xscale.numel() if xscale is not None else 0)
                  + out_e.numel() * 4 + cnt_e.numel() * 4)
        f32_ms = cuda_ms(lambda: kernel(dec, None))
        record(f"triplet_{name}", f"pagerank send on {xe.dtype} rows"
               f"{' with an int8 scale plane' if xscale is not None else ''}"
               f"; the kernel on the decoded f32 rows took {f32_ms:.4f} ms "
               f"in this run; library: none (no single PyTorch call "
               f"dequantizes and reduces)", err,
               f"{tol}; bit-equal to the kernel on the decoded rows and to "
               f"the ordered model", cuda_ms(lambda: kernel(xe, xscale)),
               cuda_ms(plain), nbytes, nlv * (ir_flops(k_pr.ir) + 1 + 2 * (
                   xscale is not None)))
        results[f"triplet_{name}"][-1]["f32_ms"] = f32_ms
        del out_e, cnt_e, out_o

    x_pr3 = x_pr.reshape(nl, v_mir, 2)
    for cname in RESIDENT_CODECS:
        leaf = wire.encode_resident(x_pr3, wire.make_codec(cname,
                                                           resident=True),
                                    "scaled")
        check_encoded(tri_mod.variant(leaf.payload.dtype, True),
                      leaf.payload.reshape(S, 2),
                      leaf.scale.reshape(-1, 2).contiguous(),
                      leaf.decode().reshape(S, 2))
        del leaf
    x_bf = x_pr.to(torch.bfloat16)
    check_encoded("bf16", x_bf, None, x_bf.float())
    del x_pr3, x_bf

    def check_apply(variant, gg, spec, msgs, xs, reduce):
        """Kernel and plain version combine in the same ascending source
        partition order and run the same vprog ops: exact, sums included;
        a passed-through leaf comes back as the same tensor.  A copy of
        apply_rng with one granule's range of one source partition cut
        short by one entry, at a CTA boundary (the kernel reads the table
        there), must fail the check."""
        st_ = gg.s
        nl_, v_blk_ = st_.p, st_.v_blk
        S_ = nl_ * v_blk_
        send, rng = st_.routes["dst"][0], st_.apply_rng["dst"]
        flags = (send >= 0) & (torch.rand(tuple(send.shape), generator=gen)
                               < 0.9).to(dev)
        vid_, vm_ = st_.home_vid, gg.vmask

        def call(fn, r=rng):
            return fn(msgs, flags, send, r, xs, vid_, vm_, spec, reduce=reduce)

        def held(name, got):
            """compare() of the written leaves and the changed bits."""
            errs = [compare(f"{name} leaf {l}", a, b) for l, (a, b, w) in
                    enumerate(zip(got[0], new_p, spec.written)) if w]
            compare(f"{name} changed bits", got[1], chg_p)
            return max(errs)

        new_p, chg_p = call(ref.fused_apply)
        got = call(app_mod.fused_apply)
        torch.cuda.synchronize()
        err, tol = held(f"apply[{variant}]", got)
        for l, (a, b, x, w) in enumerate(zip(got[0], new_p, xs,
                                              spec.written)):
            if not w and not (a is x and b is x):
                raise AssertionError(f"apply[{variant}]: leaf {l}, passed "
                                     f"through, was copied")
        pl = app_mod.plan(spec.dm, spec.dv)
        ctas = pl.grid(nl_, v_blk_)
        # the mutant: the first CTA boundary b (a multiple of VB / GRAN)
        # where dropping entry rng[q, pe, b] - 1 changes the plain result
        per, nb = pl.vb // APPLY_GRAN, rng.shape[2] - 1
        rng_h, flags_h = rng.cpu(), flags.cpu()
        mutant = None
        for b in range(per, nb, per):
            for q, pe in np.ndindex(nl_, nl_):
                j = int(rng_h[q, pe, b]) - 1
                if j < int(rng_h[q, pe, b - 1]) or not flags_h[q, pe, j]:
                    continue
                bad = rng.clone()
                bad[q, pe, b] -= 1
                cut = call(ref.fused_apply, bad)
                if all(torch.equal(a, c) for a, c in zip(new_p, cut[0])):
                    continue
                try:
                    held(f"apply[{variant}] mutant", call(app_mod.fused_apply,
                                                          bad))
                except AssertionError as e:
                    mutant = (f"range of granule {b - 1}, partition {q}, "
                              f"source {pe} cut by one entry: fails as it "
                              f"must ({e})")
                    break
                raise AssertionError(f"apply[{variant}]: the cut range "
                                     f"({q}, {pe}, {b}) passed the check")
            if mutant is not None:
                break
        if mutant is None:
            raise AssertionError(f"apply[{variant}]: no mutant found")
        del bad, cut
        # the function's own bytes: each live route entry (4 B) and its
        # flag, the live rows, the apply_rng words the CTAs read, the state
        # columns the vprog or the changed test reads (and vid only if
        # read), the mask, the columns written (invisible rows copy the
        # old bits of columns nothing else reads) and a changed byte a slot
        n_live = int(rng[:, :, -1].sum())
        n_rows = int((flags & (send >= 0)).sum())
        row_b = sum(m[0, 0, 0].numel() * m.element_size() for m in msgs)
        cols = [(x.element_size(), w) for x, w, (_, sh) in
                zip(xs, spec.written, spec.state)
                for _ in range(int(np.prod(sh, dtype=np.int64)))]
        col_b = [b for b, _ in cols]
        wcols = [c for c, (_, w) in enumerate(cols) if w]
        hidden = int((~vm_).sum())
        nbytes = (n_live * (i32 + 1) + n_rows * row_b
                  + nl_ * nl_ * (ctas[0] + 1) * i32
                  + S_ * sum(col_b[c] for c in spec.reads)
                  + spec.reads_vid * S_ * i32 + S_
                  + S_ * sum(col_b[c] for c in wcols)
                  + hidden * sum(col_b[c] for c in wcols
                                 if c not in spec.reads) + S_)
        # the earlier formula: every route slot's inverse-table word and live
        # byte, the packed f32 state in and out, and an f32 changed flag
        n_route = send.numel()
        old_bytes = (min(n_route, nl_ * v_blk_ * nl_) * i32 + n_route
                     + n_rows * spec.dm * 4 + S_ * spec.dv * 4
                     + spec.reads_vid * S_ * i32 + S_ + S_ * spec.dv * 4
                     + S_ * 4)
        flops = n_rows * spec.dm + S_ * (ir_flops(spec.vprog) + spec.dv)
        kernel = lambda: call(app_mod.fused_apply)  # noqa: E731
        record("apply", variant, err, tol, cuda_ms(kernel),
               cuda_ms(lambda: call(ref.fused_apply)), nbytes, flops)
        row = results["apply"][-1]
        # device_ms: calls back to back, the inputs L2-resident after the
        # first; l2_cleared_ms: each call after a 128 MB write, as a
        # superstep sees it (the roofline share is read from this one)
        dms, dms_by = device_ms(kernel)
        row.update(median_ms=median_ms(kernel), device_ms=dms,
                   device_ms_by=dms_by,
                   l2_cleared_ms=cold_device_ms(kernel, "apply_kernel"),
                   old_bound_ms=bound(old_bytes, flops)[0], vb=pl.vb,
                   ctas=ctas[0] * ctas[1], smem=pl.smem, mutant=mutant)
        log(f"    VB {pl.vb}, CTAs {ctas[0]} x {ctas[1]}, threads "
            f"{pl.threads}, smem {pl.smem} B; median of 5 x 20 "
            f"{row['median_ms']:.4f} ms, device {ms_str(dms)} "
            f"(L2-resident; {dms_by}), with L2 cleared "
            f"{ms_str(row['l2_cleared_ms'])}"
            + (f" = {row['bound_ms'] / row['l2_cleared_ms']:.0%} of the bound"
               if row["l2_cleared_ms"] else "") + "; "
            f"bound {row['bound_ms']:.4f} ms ({nbytes / 1e6:.2f} MB), old "
            f"formula {row['old_bound_ms']:.4f} ms ({old_bytes / 1e6:.2f} "
            f"MB); {n_live} live route entries, {n_rows} live rows; mutant "
            f"{mutant}")

    k = s.routes["dst"][0].shape[2]
    xs_pr = [(torch.rand((nl, v_blk), generator=gen) * 50 + 1).to(dev)
             for _ in a_pr.state]
    msgs_pr = [(torch.rand((nl, nl, k), generator=gen) * 3).to(dev)]
    check_apply("sum (pagerank vprog)", g, a_pr, msgs_pr, xs_pr, "sum")
    del xs_pr, msgs_pr
    # CC's own structure, built here for the apply check and kept for
    # phase 4
    t0 = time.perf_counter()
    sgd = symmetrize(rmat(CC_SCALE, 16, seed=1))
    # SSSP's edge weights (phase 4b); CC reads no edge property
    w_cc = np.random.default_rng(1).uniform(0.5, 3, sgd.num_edges).astype(
        np.float32)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    sg = Graph.from_edges(sgd.src, sgd.dst, edge_values={"w": w_cc},
                          num_partitions=P, device=dev)
    torch.cuda.synchronize()
    log(f"  cc graph symmetrize(rmat({CC_SCALE},16)): {sg.s.num_vertices} "
        f"vertices, {sg.s.num_edges} edges; generate {t_gen:.1f} s, build "
        f"{time.perf_counter() - t0:.1f} s")
    kc = sg.s.routes["dst"][0].shape[2]
    msgs_cc = [torch.randint(0, sg.s.max_vid + 1, (P, P, kc), generator=gen,
                             dtype=torch.int32).to(dev)]
    # the home ids, INT_PAD on the padding rows: invisible rows keep them
    xs_cc = [sg.s.home_vid.clone()]
    check_apply("min (cc vprog)", sg, a_cc, msgs_cc, xs_cc, "min")
    del xs_cc, msgs_cc

    # the unfused PageRank aggregate: messages in dst CSR order
    msgs = torch.rand((nl, e_blk, 1), generator=gen).to(dev)
    ptr, pieces = s.agg_ptr["dst"], s.agg_pieces["dst"]
    out_k = seg_mod.segment_sum(msgs, live, ptr, pieces).reshape(S, 1)
    out_p = ref.segment_sum(msgs, live, ptr).reshape(S, 1)
    out_o, _ = ref.ordered_segment_reduce(msgs, live, ptr, pieces)
    torch.cuda.synchronize()
    compare("segment_sum vs ordered model", out_k, out_o)
    seg_ids = ref.csr_segments(live, ptr).reshape(-1)
    keep = seg_ids < S
    err, tol = compare("segment_sum", out_k, out_p, ref.sum_tol(
        seg_ids[keep], msgs.reshape(-1, 1)[keep], S))
    flat = msgs.reshape(-1, 1)
    lib_out = torch.zeros((S + 1, 1), device=dev)
    record("segment_sum", "sum (unfused pagerank aggregate); library: "
           "index_add_ with the segment ids prepared", err,
           f"{tol}; bit-equal to the ordered model",
           cuda_ms(lambda: seg_mod.segment_sum(msgs, live, ptr, pieces)),
           cuda_ms(lambda: ref.segment_sum(msgs, live, ptr)),
           ptr.numel() * i32 + live.numel() + n_live * 4 + out_k.numel() * 4,
           n_live,
           library_ms=cuda_ms(lambda: lib_out.index_add_(0, seg_ids, flat)))
    del msgs, flat, out_k, out_p, out_o, seg_ids, keep

    # spmv: the same send through spmv's wrapper and tables
    sp_args = (sp_x, sp_w, sp_src, sp_dst, sp_tiles, None, S)
    out_k = spmv_mod.spmv(*sp_args)
    out_p = spmv_mod.plain(*sp_args)
    out_o, _ = ref.ordered_triplet(
        sp_x, sp_w.reshape(-1, 1), sp_src.reshape(1, -1),
        sp_dst.reshape(1, -1), sp_live.reshape(1, -1),
        sp_tiles["ptr"].reshape(1, -1), sp_tiles["perm"].reshape(1, -1),
        spmv_mod.linear_message(1), segorder.Pieces(
            sp_tiles["piece_ptr"], sp_tiles["piece_seg"],
            sp_tiles["piece_multi"]))
    torch.cuda.synchronize()
    compare("spmv vs ordered model", out_k, out_o)
    # the same messages (pr / deg * w) in the same pieces: the fused send
    compare("spmv vs the triplet kernel's pagerank send", out_k, pr_send)
    keep = sp_live.nonzero()[:, 0]
    err, tol = compare("spmv", out_k, out_p, ref.sum_tol(
        sp_dst[keep].long(), sp_x[sp_src[keep].long()] * sp_w[keep, None], S))
    record("spmv", f"pagerank send as one SpMV over the {nl} partitions' "
           f"slots (tables built in {t_tiles:.1f} s on the host); library: "
           f"torch.sparse.mm on the same CSR", err,
           f"{tol}; bit-equal to the ordered model and to the triplet "
           f"kernel's pagerank send",
           cuda_ms(lambda: spmv_mod.spmv(*sp_args)),
           cuda_ms(lambda: spmv_mod.plain(*sp_args)),
           (S + 1) * i32 + n_live * (3 * i32 + 1) + 2 * S * 4, 2 * n_live,
           library_ms=cuda_ms(lambda: torch.sparse.mm(csr, sp_x)))
    del (x_pr, x_cc, out_k, out_p, out_o, pr_send, sp_src,
         sp_dst, sp_tiles, sp_x, sp_w, sp_args, keep, perm, csr)
    log(f"  phase 2: {time.perf_counter() - t_phase:.1f} s")

    # ---------------------------------------------------------- phase 3
    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    log(f"phase 3: pagerank, {PR_ITERS} supersteps")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r_f = alg.pagerank(g, num_iters=PR_ITERS, track_metrics=True)
    torch.cuda.synchronize()
    t_f = time.perf_counter() - t0
    after_fused = ops.launch_counts()
    m0 = r_f.metrics[0]
    if (m0["plan"], m0["apply_plan"]) != ("fused", "fused_apply"):
        raise AssertionError(f"pagerank plans {m0['plan']}, {m0['apply_plan']}")
    if after_fused["triplet"] < PR_ITERS or after_fused["apply"] < PR_ITERS:
        raise AssertionError(f"fused pagerank launches {after_fused}")
    t0 = time.perf_counter()
    r_u = alg.pagerank(g, num_iters=PR_ITERS, kernel_mode="unfused")
    torch.cuda.synchronize()
    t_u = time.perf_counter() - t0
    if not torch.equal(r_f.graph.vdata["pr"], r_u.graph.vdata["pr"]):
        raise AssertionError("pagerank: fused != unfused")
    ids_np, vals = r_f.graph.vertices_to_numpy()
    want = alg.pagerank_reference(gd.src, gd.dst, gd.num_vertices,
                                  PR_ITERS)[ids_np]
    rel = float(np.max(np.abs(vals["pr"] - want)) / np.max(np.abs(want)))
    if not rel <= 1e-4:
        raise AssertionError(f"pagerank vs float64 oracle: {rel}")
    log(f"  pagerank fused {t_f:.3f} s ({t_f / r_f.supersteps * 1e3:.2f} ms "
        f"per superstep incl. degree), unfused {t_u:.3f} s "
        f"({t_u / r_u.supersteps * 1e3:.2f} ms per superstep); "
        f"fused == unfused bit for bit; max|pr-ref|/max|ref| = {rel:.3g}; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    counts_3 = ops.launch_counts()
    _, _, trace = prof_mod.traced(lambda: alg.pagerank(g, num_iters=3))
    log(f"  pagerank traced, 3 supersteps: "
        f"{prof_mod.home_line(prof_mod.span_stats(trace))}")
    del trace
    del r_u
    log(f"  phase 3: {time.perf_counter() - t_phase:.1f} s")

    # ---------------------------------------------------------- phase 3b
    t_phase = time.perf_counter()
    log(f"phase 3b: pagerank over the int8 wire and narrow-resident mirrors, "
        f"{PR_ITERS} supersteps, same graph")

    def norm(r):
        pr = r.graph.vdata["pr"][r.graph.vmask].double()
        return pr / pr.sum()

    def run(codec, resident, mode="auto"):
        """PageRank over `codec`, the launch counts set to 0 just before it
        and read just after: (result, seconds, counts)."""
        gw = g.replace(ex=with_wire(g.ex, codec, resident=resident))
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = alg.pagerank(gw, num_iters=PR_ITERS, track_metrics=True,
                         kernel_mode=mode)
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        counts = ops.launch_counts()
        if mode == "auto" and (r.metrics[0]["plan"], r.metrics[0][
                "apply_plan"]) != ("fused", "fused_apply"):
            raise AssertionError(f"pagerank over {codec}: plans "
                                 f"{r.metrics[0]['plan']}, "
                                 f"{r.metrics[0]['apply_plan']}")
        return r, t, counts

    want_n = norm(r_f)
    f32_hbm = r_f.metrics[-1]["mirror_hbm_bytes"]
    f32_wire = sum(m["bytes_on_wire"] for m in r_f.metrics)
    per_step = {"f32 wire": t_f / r_f.supersteps * 1e3}
    resident_launches = {}

    def check_ranks(label, r):
        err = float((norm(r) - want_n).abs().max())
        if not err <= RANK_LIMIT:
            raise AssertionError(f"pagerank {label}: normalised ranks "
                                 f"{err} from the f32 run's")
        return err

    r8w, t, _ = run("int8", False)
    per_step["int8 wire"] = t / r8w.supersteps * 1e3
    err = check_ranks("int8 wire", r8w)
    wire8 = sum(m["bytes_on_wire"] for m in r8w.metrics)
    if not wire8 <= WIRE_RATIO_LIMIT * f32_wire:
        raise AssertionError(f"int8 bytes_on_wire {wire8} vs f32 {f32_wire}")
    log(f"  int8 wire: {per_step['int8 wire']:.2f} ms per superstep, ranks "
        f"{err:.3g} from f32, bytes_on_wire {wire8:.0f} = "
        f"{wire8 / f32_wire:.4f} of f32's {f32_wire:.0f}")
    for cname in RESIDENT_CODECS:
        r, t, counts = run(cname, True)
        key = "triplet_" + tri_mod.variant(wire.make_codec(cname).fdtype, True)
        resident_launches[key] = counts.get(key, 0)
        if resident_launches[key] < PR_ITERS:
            raise AssertionError(f"{cname} resident: {key} launched "
                                 f"{resident_launches[key]} times")
        per_step[f"{cname} resident"] = t / r.supersteps * 1e3
        ru, t_u, _ = run(cname, True, "unfused")
        if not torch.equal(r.graph.vdata["pr"], ru.graph.vdata["pr"]):
            raise AssertionError(f"pagerank {cname} resident: fused != "
                                 f"unfused")
        err = check_ranks(f"{cname} resident", r)
        hbm = r.metrics[-1]["mirror_hbm_bytes"]
        if not hbm <= MIRROR_RATIO_LIMIT * f32_hbm:
            raise AssertionError(f"{cname} mirror bytes {hbm} vs f32 "
                                 f"{f32_hbm}")
        drift = ""
        if cname == "int8":
            a = r.graph.vdata["pr"].double()
            b = r8w.graph.vdata["pr"].double()
            rel_l2 = float((a - b).norm() / b.norm())
            if not rel_l2 <= PR_ITERS * DRIFT_PER_STEP:
                raise AssertionError(f"int8 resident drift {rel_l2}")
            drift = (f", relative L2 {rel_l2:.3g} from the int8 wire-only "
                     f"run (limit {PR_ITERS * DRIFT_PER_STEP:.4f})")
        log(f"  {cname} resident: {per_step[f'{cname} resident']:.2f} ms per "
            f"superstep (unfused {t_u / ru.supersteps * 1e3:.2f}), {key} "
            f"launched {resident_launches[key]} times, fused == unfused bit "
            f"for bit, ranks {err:.3g} from f32, mirror bytes {hbm} = "
            f"{hbm / f32_hbm:.4f} of f32's{drift}")
        del r, ru
    # bf16 vertex properties: the send reads bf16 mirror rows
    gb = r_f.graph.mapV(_to_bf16)
    ops.reset_launch_counts()
    vb, eb, _, mb = gb.mrTriplets(alg.pagerank_send, "sum")
    torch.cuda.synchronize()
    resident_launches["triplet_bf16"] = ops.launch_counts().get(
        "triplet_bf16", 0)
    vu, eu, _, _ = gb.mrTriplets(alg.pagerank_send, "sum",
                                 kernel_mode="unfused")
    if mb["plan"] != "fused" or resident_launches["triplet_bf16"] < 1:
        raise AssertionError(f"bf16 send: plan {mb['plan']}, launches "
                             f"{resident_launches['triplet_bf16']}")
    if not (torch.equal(vb["m"], vu["m"]) and torch.equal(eb, eu)):
        raise AssertionError("bf16 send: fused != unfused")
    log(f"  bf16 send as one mrTriplets: fused == unfused bit for bit")
    del gb, vb, eb, vu, eu, r8w, r_f      # g and gd stay for phase 4b
    log(f"  ms per superstep (incl. the degree pass): " + ", ".join(
        f"{k} {v:.2f}" for k, v in per_step.items()))
    log(f"  phase 3b: {time.perf_counter() - t_phase:.1f} s")

    # ---------------------------------------------------------- phase 4
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components as sp_cc
    ops.reset_launch_counts()
    t_phase = time.perf_counter()
    log("phase 4: connected components (the graph built in phase 2)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c_f = alg.connected_components(sg, track_metrics=True)
    torch.cuda.synchronize()
    t_f = time.perf_counter() - t0
    m0 = c_f.metrics[0]
    if (m0["plan"], m0["apply_plan"]) != ("fused", "fused_apply"):
        raise AssertionError(f"cc plans {m0['plan']}, {m0['apply_plan']}")
    c_u = alg.connected_components(sg, kernel_mode="unfused")
    if not torch.equal(c_f.graph.vdata["cc"], c_u.graph.vdata["cc"]) \
            or c_f.supersteps != c_u.supersteps:
        raise AssertionError("cc: fused != unfused")
    ids_np, vals = c_f.graph.vertices_to_numpy()
    n = sgd.num_vertices
    adj = csr_matrix((np.ones(sgd.num_edges, np.int8), (sgd.src, sgd.dst)),
                     shape=(n, n))
    _, lab = sp_cc(adj, directed=False)
    minid = np.full(lab.max() + 1, n, np.int64)
    np.minimum.at(minid, lab[ids_np], ids_np)
    if not np.array_equal(vals["cc"], minid[lab[ids_np]]):
        raise AssertionError("cc labels differ from scipy's components")
    log(f"  cc on symmetrize(rmat({CC_SCALE},16)): {sg.s.num_vertices} "
        f"vertices, {sg.s.num_edges} edges, {c_f.supersteps} supersteps, "
        f"{len(np.unique(vals['cc']))} components, fused {t_f:.3f} s; labels "
        f"== scipy, fused == unfused")
    log(f"  phase 4: {time.perf_counter() - t_phase:.1f} s")

    counts_4 = ops.launch_counts()
    _, _, trace = prof_mod.traced(lambda: alg.connected_components(sg))
    log(f"  cc traced: {prof_mod.home_line(prof_mod.span_stats(trace))}")
    del trace
    launches = {k: counts_3.get(k, 0) + counts_4.get(k, 0)
                for k in set(counts_3) | set(counts_4)}
    launches.update(resident_launches)
    for name in ("triplet", "apply", "segment_sum", *resident_launches):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the main path")
    del c_f, c_u, adj, lab, minid, ids_np, vals

    # ---------------------------------------------------------- phase 4b
    t_phase = time.perf_counter()
    log("phase 4b: the rest of the main path (sssp, label propagation, "
        "subgraph, reverse, coarsen, triangle count, the torch quickstart)")
    tally_4b = {}        # main-path run -> its launches, each counted alone
    phase_4b_graphs(g, gd, sg, sgd, w_cc, tally_4b)
    del g, gd, sg, sgd, w_cc
    gc.collect()
    torch.cuda.empty_cache()
    phase_4b_triangles(dev, tally_4b)
    phase_4b_quickstart(qs_mod, dev, tally_4b)
    log("  phase 4b launches, each main-path run counted alone (the unfused "
        "comparison runs and the checks not counted):")
    for label, counts in tally_4b.items():
        log(f"    {label}: " + ", ".join(
            f"{k} {counts.get(k, 0)}"
            for k in ("triplet", "apply", "segment_sum")))
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
    log(f"  phase 4b: {time.perf_counter() - t_phase:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- phase 5
    import torch.nn.functional as F
    t_phase5 = time.perf_counter()
    log("phase 5: flash attention vs plain")
    ctx = torch.randn((SERVE_BATCH, 1664, 4096), generator=gen).to(
        dev, torch.bfloat16)
    w_kv = (torch.randn((4096, 8, 128), generator=gen) * 4096 ** -0.5).to(
        dev, torch.bfloat16)
    k_nc = torch.einsum("bld,dhk->bhlk", ctx, w_kv)   # as _cross_attention
    v_nc = torch.einsum("bld,dhk->bhlk", ctx, w_kv * 0.5)
    copy_ms = cuda_ms(lambda: (k_nc.contiguous(), v_nc.contiguous()))
    log(f"  serve-shape einsum K/V contiguous: {k_nc.is_contiguous()}; "
        f"copy to contiguous {copy_ms:.4f} ms for both")
    flash_shapes = [
        # name, B, Hq, Hkv, Lq, Lk, causal, kv_offset
        ("serve step: GQA 4, Lk 1664, non-causal", SERVE_BATCH, 32, 8, 1,
         1664, False, 0),
        ("causal prefill L 4096", 1, 32, 8, 4096, 4096, True, 0),
        ("chunked prefill Lq 512, Lk 4096, kv_offset 3584", 1, 32, 8, 512,
         4096, True, 3584)]
    flash = flash_mod.flash_attention
    for name, b, hq, hkv, lq, lk, causal, off in flash_shapes:
        q = torch.randn((b, hq, lq, 128), generator=gen).to(dev, torch.bfloat16)
        if lq == 1:
            k, v = k_nc, v_nc       # as the cross-attention passes them
        else:
            k, v = (torch.randn((b, hkv, lk, 128), generator=gen)
                    .to(dev, torch.bfloat16) for _ in range(2))
        kw = dict(causal=causal, kv_offset=off)
        plan = flash_mod.plan(q.shape, k.shape, q.dtype, **kw,
                              strides=(q.stride(), k.stride(), v.stride()))
        copies, ran = flash.copies, flash.bodies[plan.body]
        got = flash(q, k, v, **kw)
        if flash.copies != copies or flash.bodies[plan.body] != ran + 1:
            raise AssertionError(f"flash[{name}]: {flash.copies - copies} "
                                 f"inputs copied; body {plan.body} not run")
        want = ref.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        over = diff > flash_limit(want)
        if bool(over.any()):
            raise AssertionError(f"flash[{name}]: {int(over.sum())} outputs "
                                 f"beyond their limit (max |err| "
                                 f"{float(diff.max())})")
        err = float(diff.max())
        extra = {}
        if lq == 1:
            kc, vc = k.contiguous(), v.contiguous()
            if not torch.equal(flash(q, kc, vc, **kw), got):
                raise AssertionError(f"flash[{name}]: strided K/V and their "
                                     "contiguous copies differ")
            extra["contiguous_ms"] = cuda_ms(lambda: flash(q, kc, vc, **kw))
            extra["contiguous_copy_ms"] = copy_ms
            del kc, vc
        if causal:
            mask = (torch.arange(lq, device=dev)[:, None] + off
                    >= torch.arange(lk, device=dev)[None, :])
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=mask, enable_gqa=True)
        else:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, enable_gqa=True)
        lib_err = float((lib().float() - want.float()).abs().max())
        if causal and off == 0:     # the fastest library call here
            extra["library_mask_ms"] = cuda_ms(lib)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=True, enable_gqa=True)
        lib_ms = cuda_ms(lib)
        kern = lambda: flash(q, k, v, **kw)  # noqa: E731
        # besides `ms` (5 calls, as every kernel row): the median of 5 runs
        # of 20 calls, and the device's own time (kernels only)
        extra["median_ms"] = median_ms(kern)
        extra["library_median_ms"] = median_ms(lib)
        extra["device_ms"], extra["device_ms_by"] = device_ms(kern)
        extra["library_device_ms"], extra["library_device_ms_by"] = \
            device_ms(lib)
        nbytes = (q.numel() + k.numel() + v.numel() + got.numel()) * 2
        flops = 4 * b * hq * 128 * visible_pairs(lq, lk, causal, off)
        variant = (f"{name} (bf16; body {plan.body}, {plan.ctas} CTAs, "
                   f"{len(plan.splits)} key splits; bound peak "
                   f"{BF16_FLOPS / 1e12:.0f} TFLOP/s bf16, "
                   f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
        row = {"variant": variant, "max_abs_err": err,
               "tol": "per output 2^-7*|plain| + 1e-6 (one bf16 spacing)",
               "ms": cuda_ms(kern),
               "plain_ms": cuda_ms(lambda: ref.flash_attention(q, k, v, **kw)),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
               "library_max_abs_err": lib_err, "body": plan.body,
               "ctas": plan.ctas, "splits": len(plan.splits),
               "copies": flash.copies - copies, **extra}
        log(f"  flash[{name}]: body {plan.body}, {plan.ctas} CTAs, "
            f"{len(plan.splits)} splits, {row['copies']} inputs copied; err "
            f"{err:.3g}, kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, sdpa {lib_ms:.4f} ms; median of 5 "
            f"x 20 calls kernel {extra['median_ms']:.4f} ms, sdpa "
            f"{extra['library_median_ms']:.4f} ms; on the device kernel "
            f"{ms_str(extra['device_ms'])} ({extra['device_ms_by']}), sdpa "
            f"{ms_str(extra['library_device_ms'])} "
            f"({extra['library_device_ms_by']})"
            + (f" (is_causal; masked {extra['library_mask_ms']:.4f} ms)"
               if "library_mask_ms" in extra else "")
            + f" (|sdpa - plain| {lib_err:.3g}), bound {b_ms:.4f} ms ({b_by})"
            + (f"; on contiguous copies {extra['contiguous_ms']:.4f} ms, "
               "bit-equal" if lq == 1 else ""))
        results.setdefault("flash_attention", []).append(row)
        del q, k, v, got, want, diff, over
    del ctx, w_kv, k_nc, v_nc
    gc.collect()
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- phase 6
    log(f"phase 6: serve {SERVE_ARCH}, batch {SERVE_BATCH}, prompt "
        f"{SERVE_PROMPT}, gen {SERVE_GEN}")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    copies = flash.copies
    t0 = time.perf_counter()
    run = serve.run(SERVE_ARCH, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                    gen=SERVE_GEN, kernel_mode="auto", device="cuda")
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    launches["flash_attention"] = ops.launch_counts()["flash_attention"]
    cfg = run.cfg
    n_cross = cfg.n_layers // cfg.cross_attn_every
    want_launches = n_cross * (SERVE_PROMPT + SERVE_GEN - 1)
    if launches["flash_attention"] != want_launches:
        raise AssertionError(f"flash launches {launches['flash_attention']}, "
                             f"expected {want_launches}")
    if flash.copies != copies:
        raise AssertionError(f"serve copied {flash.copies - copies} flash "
                             "inputs")
    gen_toks = run.generated
    if gen_toks.shape != (SERVE_BATCH, SERVE_GEN) or gen_toks.min() < 0 \
            or gen_toks.max() >= cfg.vocab:
        raise AssertionError(f"generated tokens {gen_toks.shape}")
    if not bool(torch.isfinite(run.last_logits).all()):
        raise AssertionError("serve logits are not finite")
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_params = T.param_count(run.params)
    # The last step again.  (a) Through the plain attention: its logits
    # are held to the kernel step's.  They are bf16 products that 32 more
    # layers of bf16 casts stir, so their mean |diff| is a coarse check
    # (scripts/serve_logit_margin.py).  (b) Through the kernel with every
    # flash call held in place against the plain version on the same
    # inputs, per output within one bf16 spacing; the plain version with
    # any one of the flash plan's key splits dropped must break that limit
    # in every layer.
    def last_step(mode):
        return T.decode_step(run.params, run.last_state, run.last_tokens,
                             run.last_pos, cfg, cross_ctx=run.ctx,
                             mode=mode)[0]

    logits_ref = last_step("ref")
    d_log = (run.last_logits - logits_ref).abs()
    if float(d_log.mean()) > SERVE_LOGIT_MEAN_LIMIT:
        raise AssertionError(f"kernel step vs plain step logits: mean |diff| "
                             f"{float(d_log.mean())} > {SERVE_LOGIT_MEAN_LIMIT}")
    n_ctx = cfg.n_context_tokens
    tiles = flash_mod.plan(
        (SERVE_BATCH, cfg.n_heads, 1, cfg.head_dim),
        (SERVE_BATCH, cfg.n_kv_heads, n_ctx, cfg.head_dim), torch.bfloat16,
        causal=False).splits
    in_place = []
    kernel_attention = ops.flash_attention

    def held_in_place(q, k, v, **kw):
        got = kernel_attention(q, k, v, **kw)
        plain_kw = {**kw, "mode": "ref"}
        want = kernel_attention(q, k, v, **plain_kw)
        lim = flash_limit(want)
        diff = (got.float() - want.float()).abs()
        if bool((diff > lim).any()):
            raise AssertionError(f"flash in place, layer {len(in_place)}: "
                                 f"max |err| {float(diff.max())}")
        for a, b in tiles:
            drop = kernel_attention(
                q, torch.cat([k[:, :, :a], k[:, :, b:]], 2),
                torch.cat([v[:, :, :a], v[:, :, b:]], 2), **plain_kw)
            if not bool(((drop.float() - want.float()).abs() > lim).any()):
                raise AssertionError(f"flash in place, layer {len(in_place)}:"
                                     f" dropping keys {a}:{b} passes the limit")
        in_place.append(float(diff.max()))
        return got

    ops.flash_attention = held_in_place
    try:
        last_step("auto")
    finally:
        ops.flash_attention = kernel_attention
    if len(in_place) != n_cross:
        raise AssertionError(f"{len(in_place)} flash calls held in place, "
                             f"expected {n_cross}")
    log(f"  {cfg.name}: {n_params / 1e9:.3f} B params, {cfg.n_layers} layers, "
        f"{n_cross} cross-attention layers; prefill {run.prefill_s:.3f} s "
        f"({run.prefill_s / SERVE_PROMPT * 1e3:.2f} ms per step), decode "
        f"{run.decode_s:.3f} s ({run.decode_s / (SERVE_GEN - 1) * 1e3:.2f} ms "
        f"per step, {run.tokens_per_s:.1f} tok/s); whole run incl. init "
        f"{t_serve:.1f} s; peak device memory {peak:.2f} GiB; flash launches "
        f"{launches['flash_attention']}, inputs copied 0; sample {gen_toks[0, :8].tolist()}")
    log(f"  last step, kernel vs plain: logits max |diff| "
        f"{float(d_log.max()):.6g}, mean {float(d_log.mean()):.6g} (limit "
        f"{SERVE_LOGIT_MEAN_LIMIT}); flash in place in all {n_cross} layers: "
        f"max |err| {max(in_place):.6g} (limit one bf16 spacing), and "
        f"dropping any of plan's {len(tiles)} key splits "
        f"({tiles[0][1] - tiles[0][0]} keys) breaks it in every layer")
    del run, logits_ref
    log(f"  phases 5-6: {time.perf_counter() - t_phase5:.1f} s")

    gc.collect()
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- phase 7
    t_phase = time.perf_counter()
    tc_peak = TF32_FLOPS / TF32_TERMS
    log("phase 7: mLSTM kernels vs plain versions (bound: the tensor-core "
        f"body's products at {tc_peak / 1e12:.0f} TFLOP/s (TF32 "
        f"{TF32_FLOPS / 1e12:.0f} / {TF32_TERMS} terms), the CUDA-core "
        f"body's at f32 {F32_FLOPS / 1e12:.0f} TFLOP/s; "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s)")

    def kernel(q, k, v, logi, logf, chunk):
        return mlstm_mod.mlstm_chunked(q, k, v, logi, logf, chunk=chunk)

    for name, b, h, l, dh, chunk in MLSTM_SHAPES:
        q, k, v, logi, logf = mlstm_inputs(b, h, l, dh, gen, dev)
        dout = torch.randn((b, h, l, dh), generator=gen).to(dev)
        pl = mlstm_mod.plan(min(chunk, l), dh)
        if dh == 256 and pl.body != "tensor_core":
            raise AssertionError(f"mlstm[{name}]: plan picks {pl.body}")
        bodies = (dict(mlstm_mod.forward.bodies),
                  dict(mlstm_mod.backward.bodies))
        r = mlstm_check(kernel, q, k, v, logi, logf, chunk, dout)
        ran = (mlstm_mod.forward.bodies[pl.body] - bodies[0].get(pl.body, 0),
               mlstm_mod.backward.bodies[pl.body]
               - bodies[1].get(pl.body, 0))
        if ran != (1, 1):
            raise AssertionError(f"mlstm[{name}]: body {pl.body} ran {ran}")
        # two runs bit-equal, forward and gradients (no float atomics)
        a = [t.clone().requires_grad_() for t in (q, k, v, logi, logf)]
        runs = []
        for _ in range(2):
            o = kernel(*a, chunk)
            runs.append((o.detach(), *torch.autograd.grad(o, a, dout)))
            del o
        if not all(map(torch.equal, *runs)):
            raise AssertionError(f"mlstm[{name}]: two runs differ")
        del a, runs
        if pl.body == "tensor_core":
            # what the launchers ran, from the library; its shared memory
            # must be what `plan` decided on
            lay = mlstm_mod.layout(pl, b * h, l)
            if lay["smem"] != pl.smem:
                raise AssertionError(f"mlstm[{name}]: the build lays out "
                                     f"{lay['smem']}, plan {pl.smem}")
            shape_msg = (f", scan tile {pl.tk} x {pl.tv}, {pl.stages} ring "
                         "stages; grids (library) scans "
                         f"{'x'.join(map(str, lay['grids']['scan']))} of "
                         f"{lay['threads']['scan']} threads, chunk kernels "
                         f"{'x'.join(map(str, lay['grids']['chunk']))} of "
                         f"{lay['threads']['chunk']}; smem "
                         + ", ".join(f"{k} {n}"
                                     for k, n in lay["smem"].items()))
        else:
            shape_msg = f", value tile {pl.tv}; smem {pl.smem}"
        log(f"  mlstm[{name}]: body {pl.body}{shape_msg}; two runs bit-equal")
        log(f"  mlstm[{name}] [{b}, {h}, {l}, {dh}] chunk {chunk}: forward "
            f"max |err| {r['max_abs_err']:.3g} (per element <= 2 gamma_n "
            f"(sum|num terms| + |out| sum|den terms|) / g; worst err/limit "
            f"{r['worst_err_over_limit']:.3g}, largest limit "
            f"{r['max_limit']:.3g}); backward relative error "
            + ", ".join(f"{n} {e:.3g}" for n, e in r["grad_rel_err"].items())
            + f" (limit {MLSTM_GRAD_REL_LIMIT})")
        # operations a chunk of W rows needs, per (batch, head), over the
        # causal pairs and the [Dh, Dh] state.  Forward: q k^T and att v
        # (4 pairs Dh), q C and the update k^T v (4 W Dh^2), q . n and the
        # n update (4 W Dh).  Backward: q k^T again (att is no input of the
        # backward), dnum v^T, att^T dnum, dS k and dS^T q (10 pairs Dh);
        # dnum C^T for dq, dC v^T for dk, k dC for dv and (dec q)^T dnum
        # for the dC carry (8 W Dh^2; dlogf's q . (C dnum^T) reuses the dq
        # product, so the kernel's own recompute of q C is not counted);
        # dden's sum of dout out, q . n for den, the n terms of dq and dk,
        # the dn carry and dlogf's q . (C dnum^T) (12 W Dh); and the
        # e^total scaling of dC (2 Dh^2).
        w = min(chunk, l)
        rows, pairs = b * h * (l // w), w * (w + 1) // 2
        bhl, states = b * h * l, b * h * (l // w) * (dh * dh + dh)
        out, saved = mlstm_mod.forward(q, k, v, logi, logf, chunk=chunk,
                                       states=True)
        pins = [t.clone().requires_grad_() for t in (q, k, v, logi, logf)]
        want = ref.mlstm_chunked(*pins, chunk=chunk)
        peak = tc_peak if pl.body == "tensor_core" else F32_FLOPS
        fwd = lambda: mlstm_mod.forward(q, k, v, logi, logf,  # noqa: E731
                                        chunk=chunk, states=True)
        bwd = lambda: mlstm_mod.backward(  # noqa: E731
            q, k, v, logi, logf, out, dout, saved, chunk=chunk)
        for kname, call, plain_ms, flops, nbytes, err in (
                ("mlstm_fwd", fwd,
                 cuda_ms(lambda: ref.mlstm_chunked(q, k, v, logi, logf,
                                                   chunk=chunk), 3),
                 rows * (4 * pairs * dh + 4 * w * dh * dh + 4 * w * dh),
                 4 * (4 * bhl * dh + 2 * bhl + states), r["max_abs_err"]),
                ("mlstm_bwd", bwd,
                 cuda_ms(lambda: torch.autograd.grad(want, pins, dout,
                                                     retain_graph=True), 3),
                 rows * (10 * pairs * dh + 8 * w * dh * dh + 12 * w * dh
                         + 2 * dh * dh),
                 4 * (8 * bhl * dh + 4 * bhl + states),
                 r["grad_max_abs_err"])):
            # besides `ms` (5 calls, as every kernel row): the median of 5
            # runs of 20 calls and the device's own time, and the bound at
            # the CUDA cores' f32 rate (the CUDA-core body's bound)
            b_ms, b_by = bound(nbytes, flops, peak)
            f32_ms = bound(nbytes, flops)[0]
            ms, med = cuda_ms(call), median_ms(call)
            dms, dms_by = device_ms(call)
            record(kname, f"{name}: [{b}, {h}, {l}, {dh}] chunk {chunk} "
                   f"(body {pl.body}; bound peak {peak / 1e12:.0f} TFLOP/s)",
                   err, "forward: per element, derived (see log); backward: "
                   f"relative norm per input <= {MLSTM_GRAD_REL_LIMIT}",
                   ms, plain_ms, nbytes, flops, peak=peak)
            results[kname][-1].update(
                body=pl.body, median_ms=med, device_ms=dms,
                device_ms_by=dms_by,
                f32_bound_ms=f32_ms, gflop=flops / 1e9, mbytes=nbytes / 1e6)
            log(f"    {kname}: median of 5 x 20 calls {med:.4f} ms, device "
                f"{ms_str(dms)} ({dms_by}); {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.0f} "
                f"MB -> bound {b_ms:.4f} ms ({b_by}; at f32 {f32_ms:.4f} ms)"
                f", {100 * b_ms / ms:.1f}% of it")
        del q, k, v, logi, logf, dout, out, saved, pins, want, fwd, bwd
        gc.collect()
        torch.cuda.empty_cache()
    b, h, l, dh, chunk = 8, 4, 256, 256, 64
    q, k, v, logi, logf = mlstm_inputs(b, h, l, dh, gen, dev)
    with torch.no_grad():
        out = mlstm_mod.mlstm_chunked(q, k, v, logi, logf, chunk=chunk)
    r = mlstm_recurrence_check(out, q, k, v, logi, logf, chunk)
    log(f"  mlstm forward vs the token recurrence, [{b}, {h}, {l}, {dh}] "
        f"chunk {chunk}: max |err| {r['max_abs_err']:.3g}, worst err/limit "
        f"{r['worst_err_over_limit']:.3g}")
    del q, k, v, logi, logf, out
    log(f"  phase 7: {time.perf_counter() - t_phase:.1f} s")

    # ---------------------------------------------------------- phase 8
    t_phase = time.perf_counter()
    log(f"phase 8: train {TRAIN_ARCH}, batch {TRAIN_BATCH}, seq {TRAIN_SEQ},"
        f" {TRAIN_STEPS} steps")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    tr = train_launch.main(["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS),
                            "--batch", str(TRAIN_BATCH), "--seq",
                            str(TRAIN_SEQ)])
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    cfg = C.get(TRAIN_ARCH)
    n_mlstm = sum(cfg.layer_pattern[i % len(cfg.layer_pattern)] == "mlstm"
                  for i in range(cfg.n_layers))
    for kname in ("mlstm_fwd", "mlstm_bwd"):
        launches[kname] = counts[kname]
        if counts[kname] != n_mlstm * TRAIN_STEPS:
            raise AssertionError(f"{kname} launches {counts[kname]}, expected "
                                 f"{n_mlstm * TRAIN_STEPS}")
    losses = tr["losses"]
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"training losses {losses}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_params = T.param_count(tr["params"])
    steps_s = tr["step_seconds"]
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    # step 1 again from the same initial weights and batch: forward and
    # backward through the kernels, each mLSTM call held in place against
    # the plain version on its own inputs (forward) and cotangent
    # (backward; zero on the rows where the normaliser's branch is
    # ambiguous, which are counted), then the loss through the plain
    # versions
    params = tl.init_params(cfg, 0, dev)
    batch = {k: torch.from_numpy(a).to(dev) for k, a in SyntheticLM(
        cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0).batch(0).items()}
    in_place = []
    kernel_mlstm = ops.mlstm_chunked

    def held_in_place(q, k, v, logi, logf, *, chunk, mode="auto"):
        out = kernel_mlstm(q, k, v, logi, logf, chunk=chunk, mode=mode)
        ins = [t.detach() for t in (q, k, v, logi, logf)]
        rec = {}
        in_place.append(rec)
        with torch.no_grad():
            want = ref.mlstm_chunked(*ins, chunk=chunk)
            limit, ambiguous = mlstm_bounds(*ins, chunk, want)
            ratio = float(((out.detach().double() - want.double()).abs()
                           / limit).max())
        rec["fwd"], rec["ambiguous"] = ratio, int(ambiguous.sum())
        if ratio > 1:
            raise AssertionError(f"mlstm forward in place, layer "
                                 f"{len(in_place) - 1}: err/limit {ratio}")

        def backward_held(dout):
            dout = dout.masked_fill(ambiguous[..., None], 0.0)
            kin = [t.clone().requires_grad_() for t in ins]
            pin = [t.clone().requires_grad_() for t in ins]
            with torch.enable_grad():       # hooks run with grad mode off
                kg = torch.autograd.grad(mlstm_mod.mlstm_chunked(
                    *kin, chunk=chunk), kin, dout)
                pg = torch.autograd.grad(ref.mlstm_chunked(
                    *pin, chunk=chunk), pin, dout)
            rec["bwd"] = max(float((a - b).norm() / b.norm())
                             for a, b in zip(kg, pg))
            if rec["bwd"] > MLSTM_GRAD_REL_LIMIT:
                raise AssertionError(f"mlstm backward in place: relative "
                                     f"error {rec['bwd']}")

        out.register_hook(backward_held)
        return out

    ops.mlstm_chunked = held_in_place
    try:
        loss = T.loss_fn(params, batch, cfg, mode="auto")
        loss.backward()
    finally:
        ops.mlstm_chunked = kernel_mlstm
    loss_k = float(loss.detach())
    del loss
    if len(in_place) != n_mlstm or any("bwd" not in r for r in in_place):
        raise AssertionError(f"{len(in_place)} mlstm calls held in place")
    with torch.no_grad():
        loss_r = float(T.loss_fn(params, batch, cfg, mode="ref"))
    if not abs(loss_k - loss_r) <= TRAIN_LOSS_LIMIT * abs(loss_r):
        raise AssertionError(f"step 1 loss, kernels {loss_k} vs plain "
                             f"{loss_r}")
    log(f"  {cfg.name}: {n_params / 1e6:.1f} M params, {cfg.n_layers} layers "
        f"({n_mlstm} mLSTM); losses {[round(x, 4) for x in losses]}; step "
        f"seconds {[round(x, 3) for x in steps_s]} (synchronised), "
        f"{TRAIN_BATCH * TRAIN_SEQ / steps_s[-1]:.0f} tokens/s at the last "
        f"step; peak device memory {peak:.2f} GiB; mlstm launches "
        f"{launches['mlstm_fwd']} forward, {launches['mlstm_bwd']} backward")
    log(f"  step 1, kernels vs plain: loss {loss_k:.6f} vs {loss_r:.6f} "
        f"(|diff| {abs(loss_k - loss_r):.3g}, limit {TRAIN_LOSS_LIMIT} "
        f"relative; the training run's step 1 read {losses[0]:.6f}); in "
        f"place, all {len(in_place)} mLSTM calls:"
        f" forward worst err/limit {max(r['fwd'] for r in in_place):.3g}, "
        f"backward relative error max "
        f"{max(r['bwd'] for r in in_place):.3g} (limit "
        f"{MLSTM_GRAD_REL_LIMIT}; cotangent zeroed on "
        f"{sum(r['ambiguous'] for r in in_place)} of "
        f"{n_mlstm * TRAIN_BATCH * cfg.n_heads * TRAIN_SEQ} rows whose "
        f"normaliser branch is within rounding)")
    del params, batch
    log(f"  phase 8: {time.perf_counter() - t_phase:.1f} s")

    replaces = {"triplet": "src/repro/kernels/triplet.py:447",
                "apply": "src/repro/kernels/superstep.py:179",
                "segment_sum": "src/repro/kernels/segment_sum.py:101",
                "flash_attention": "src/repro/kernels/flash_attention.py:121",
                "mlstm_fwd": "src/repro/kernels/mlstm.py:102",
                "mlstm_bwd": "src/repro/kernels/mlstm.py:102",
                "spmv": "src/repro/kernels/spmv.py:59"}
    csrc = {"mlstm_fwd": "mlstm_tc", "mlstm_bwd": "mlstm_tc",
            "spmv": "triplet"}
    # the triplet kernel's encoded-row variants: the reference's have_scale
    # body of the same pallas_call (_make_kernel :246, _spread_scale_tile
    # :233), and its bf16 tiles
    for name in resident_launches:
        replaces[name] = "src/repro/kernels/triplet.py:447"
        csrc[name] = "triplet"
    launches.setdefault("spmv", 0)      # on no main path
    table = []
    for name in replaces:
        head = results[name][0]
        table.append({"name": name, "route": "cuda",
                      "source": f"src/repro_torch/csrc/{csrc.get(name, name)}.cu",
                      "replaces": replaces[name], "launches": launches[name],
                      "max_abs_err": max(r["max_abs_err"] for r in results[name]),
                      "ms": head["ms"], "plain_ms": head["plain_ms"],
                      "bound_ms": head["bound_ms"],
                      "bound_by": head["bound_by"],
                      "library_ms": head["library_ms"],
                      "variants": results[name]})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

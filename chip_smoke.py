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
     superstep (pregel's apply_home span in the eager superstep 1, the same
     kernels by name in the replayed graphs, `repro_torch.profiling`);
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
  4a. the Pregel drivers on the same graphs: static PageRank (tol 0, 10
     supersteps) and delta PageRank (tol 1e-3, which halts) on phase 3's
     graph, CC and SSSP from vertex 0 (w ~ U(0.5, 3)) on phase 4's, each
     through the eager loop (`core.pregel._superstep` called superstep by
     superstep, written out here), the captured `pregel` (supersteps 2..
     replay one CUDA graph) and `pregel_fused` (blocks of FUSED_BLOCK
     masked supersteps replayed, one halt flag a block; 10 supersteps
     leave masked ones in the last block): bit-equal state, view and wire
     log, equal superstep counts, one capture each, CC's labels == scipy's;
     two mutants of pregel_fused that must fail (the max_supersteps mask
     dropped: other ranks; the counter deaf to the mask: another count);
     for each driver (the faster of two runs) ms a superstep, capture and
     release ms, peak device memory (graph pools included), launches a
     superstep (replays add what their capture recorded), the ms of the
     supersteps after the second, traced 3-superstep PageRank's device busy
     ms and idle share, and the same for 3 supersteps after the first,
     eager and replayed (the steady state);
  4c. the transports on the same graphs: delta PageRank (tol 1e-3) over
     the f32 delta wire under the dense, ragged, fig4's auto and pipelined
     auto transports through `pregel` (state, view and the wire log's
     ship counts bit-equal to dense, equal superstep counts, each
     superstep's bytes equal to the host formula of the branch it took,
     ragged supersteps, the last ragged one under the largest dense one;
     ms a superstep, recompiles, captures, capture and release ms, peak
     memory, 3 replayed supersteps' idle share with one host read each)
     and `pregel_fused` under auto; one ship's compaction, scatter back,
     dense, ragged and both-branch device ms; CC through a 1/8 capacity
     (labels == dense == scipy, the fallback both ways); the int8 wire
     with the ragged transport (normalised ranks within 1e-3 of f32, a
     forward ship on the card == the CPU's bit for bit); the broadcast
     lane on a hybrid build of CC's edges (bcast_min_repl 3): CC and delta
     PageRank under dense and auto == the structure without the lane, the
     all-gather's bytes == the formula; two mutants of core/transport.py
     that must fail (a compaction dropping each route's last entry, an
     overflow check that never falls back); each run counted alone;
  4d. the data-parallel half on phase 3's graph, each main-path run
     counted alone: the dataflow PageRank (the paper's Fig. 7 baseline,
     `Col` operators only: left_join -> map -> reduce_by_key -> left_join
     -> compact, 10 iterations at capacities 2 ceil(E/P^2) and 2 ceil(V/P);
     no overflow or drop, within 1e-4 of phase 3's engine ranks and the
     float64 oracle, none of the six kernels launched; ms an iteration
     beside the engine's ms a superstep, peak memory); leftJoin (values ==
     a host oracle, the wire log unchanged), innerJoin (vid % 3: visible
     set and triplet visibility == a host oracle), the top-k innerJoin
     (vid % 11, changed="diff": the next mrTriplets ships fewer rows than
     are visible, == a cold view bit for bit) and Listing 5 (mrTriplets ->
     a `Col` of the messages keyed by home vid -> leftJoin -> mapV ==
     pregel's first superstep bit for bit: the device hash lands on the
     host build's homes); the chain planner: Fig. 5's chain on a warm view
     (mapV -> mrTriplets -> mrTriplets, optimize on == off == the "auto"
     transport bit for bit, bytes on <= off, > 0) and Fig. 6's pushdown
     (subgraph(dst vid < V/2) -> mrTriplets: the pushed-down edge mask ==
     subgraph(epred)'s, == the unfused chain bit for bit, the triplet
     kernel launched); bytes and ms a step; two mutants that must fail
     (prune_view demoting clean leaves; the hash without its second
     multiply);
  4e. fault tolerance and out-of-core residency on the same graphs, each
     main-path run counted alone: PageRank (tol 0, 10 supersteps) through
     the captured `pregel` under the dense and the ragged policy with
     integrity words, with no fault (== the unchecked run, no faults), a
     transient `corrupt` fault over `FaultyExchange(LocalExchange(4))`
     (==, wire_faults > 0, nothing degraded) and a persistent one (==,
     degraded > 0), the negative control (no integrity, always corrupt:
     must differ), `pregel_fused` under checked ragged with a transient
     fault (==), one checked dense ship's 5-call ms and its device ms as
     one replayed CUDA graph beside an unchecked one's on the forward
     route's shape, and a mutant of
     core/transport.py without the degrade rung that must fail the
     persistent case; kill and resume (PageRank checkpointed every 5
     supersteps, a preemption guard tripped at the fifth boundary, the
     rerun resumes: state, view and wire log bit-equal to the
     uninterrupted run; the snapshot's bytes, copy, write and read
     seconds), CC killed after 2 supersteps on symmetrize(rmat(16, 16))
     and restored elastically onto P=2 (labels == scipy's; a small graph,
     since the re-shard is a host build); out of core: PageRank and CC at
     working_set_frac 0.5 (== the resident run, CC's labels == scipy's,
     every rotation's resident bytes under the footprint cap of
     tests/spmd_check.py, per rotation the measured device-to-host and
     host-to-device ms beside the modelled serial and overlapped times,
     peak device memory resident and out of core); the snapshot
     directories are removed at the end;
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
     subgraph), coarsen on symmetrize(rmat(19, 16, seed=1)) (Listing 7,
     domains vid // 16: pages preserved, edges == a host oracle, PageRank
     on the result fused == unfused);
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
  8. training xlstm-350m at its full config (24 layers, random weights
     from a seed) through
     `python -m repro_torch.launch.train`'s entry point: batch 8, seq 1024,
     3 AdamW steps, 36 mLSTM forward launches (18, and 18 again in the
     backward's per-super-layer recompute, which leaves the sLSTM blocks
     out) and 18 backward per step,
     finite losses; then step 1 again from the same weights and batch:
     through the kernels with every mLSTM forward and backward call held in
     place against its plain version on the same inputs and cotangent, and
     through the plain versions, whose loss must agree; the training run
     checkpoints after step 2 (`--ckpt-dir`, `Checkpointer`), and a run
     resumed from that snapshot for step 3 must give its loss and every
     parameter bit for bit (the snapshot's bytes, copy and write seconds
     logged);
  9. (a) the flash attention backward kernel against
     `ref.flash_attention_backward` on the same inputs and cotangent at
     recurrentgemma-2b's windowed call ([2, 10, 2048, 256] against
     [2, 1, 4096, 256], kv_offset 2048), its chunk-0 call on the strided
     views (read in place, no copy), stablelm-1.6b's causal
     [1, 32, 4096, 64] and a non-causal GQA-4 cross shape ([1, 32, 4096,
     128] against [1, 8, 1664, 128]), reading the log-sum-exp the forward
     wrote: the grids and shared memory `bwd_plan` chose (== what the build
     lays out), each gradient within a relative-norm limit, two runs
     bit-equal, kernel, plain and scaled_dot_product_attention-backward
     times (5 calls, the median of 5 x 20 calls and the device time) and
     the bound; a mutant that drops one head of each GQA group from dK/dV
     must fail; at each shape the forward kernel's output (at Dh 256 its
     wide tensor-core body) per element against `ref.flash_attention`
     within one bf16 spacing, which the plain version without any one of
     `plan`'s key splits, or without one key tile, must break, and its
     log-sum-exp per row against `ref.flash_lse`; the forward's times
     beside SDPA's forward on the same inputs, the bound, and at Dh 256 the
     CUDA-core body's on the same inputs (the body it replaced); (b)
     training recurrentgemma-2b at its full config (26 layers, random
     weights from a seed) through `python -m repro_torch.launch.train`'s
     entry point: batch 1, seq 4096, 3 AdamW steps, 32 flash forward
     launches (8 local attention layers x 2 calls, twice under the
     per-super-layer recompute), every one on the wide body, and 16
     backward launches a step, finite losses, the peak device memory;
     then step 1 again from the same weights and batch: through the
     kernels with every flash call held in place, its output per element
     against the plain forward (the recompute's calls too) and its
     gradients against the plain backward on the same inputs and
     cotangent, and
     through the plain versions, whose loss must agree; then 8 decode
     steps from those weights (RG-LRU states and ring caches on the card,
     finite logits);
 10. MoE and encoder-decoder models, and training with context tokens,
     at full width with random weights from a seed, each path's launches
     counted alone and each model freed before the next: (a) serving
     moonshot-v1-16b-a3b cut to 24 of 48 layers (f32 weights: 56.1 GB of
     110) through `launch.serve`'s functions, batch 4, prompt 32, gen 16:
     no kernel on this path (the decode step's self-attention is plain, as
     in the reference), so the last step through the plain versions must
     give its logits bit for bit; finite logits, each MoE layer's drop
     count and capacity, peak memory, and layer 0's MoE block at the
     decode step's shape (5 calls and the device time) beside the f32 ->
     bf16 casts of its expert weights alone; (b) serving
     seamless-m4t-medium whole (12 + 12 layers; as in the reference the
     context goes straight in as the cross-attention context, no encoder
     runs) with cross-attention over 1024 context tokens in all 12 layers
     (564 flash launches), the last step's 12 flash calls held in place as
     phase 6 holds them; (c) training three AdamW steps at batch 1 x seq
     4096 through `launch.train.run`: moonshot at 4 layers, seamless whole
     (1024 encoder frames; the encoder is not recomputed) and
     llama-3.2-vision-11b at 10 layers (1664 context tokens): the flash
     launches a step counted, finite losses, peak memory under 80 GB; then
     step 1 again twice from the same weights and batch, the second time
     with every flash forward and backward call held in place as phase 9
     (b) holds them: bit-equal gradients; and through the plain versions,
     whose loss must agree within `P10_LOSS_LIMIT`;
 11. the multi-device executor (run between phases 4e and 4b, on their
     graphs), each main-path run counted alone: (a) `SpmdExchange` at
     world 1 over NCCL (a one-rank group in this process, P = 4 on it):
     PageRank (10 supersteps) and CC on the graphs of phases 2 and 4,
     delta PageRank under fig4's auto policy and PageRank over the int8
     wire, each through `pregel` bit-equal to the `LocalExchange` run in
     state, view, wire log, superstep count and psummed bytes, with ms a
     superstep for both; the transpose without its local permute (a mutant
     of core/exchange.py) must break PageRank; (b) 4 ranks on the card over
     gloo (`utils.spmd.run_ranks`, spawned, each with its own CUDA context
     and its rows of rmat(P11_SCALE, 16), one partition a rank): PageRank
     and CC through `pregel`, gathered bit-equal to the `LocalExchange` run
     on the same graph (CC also to scipy's labels), the per-superstep bytes
     summed over the ranks equal, triplet and apply launched on every rank;
     the checked PageRank clean (no wire fault) and with `home_rows`
     returning arange(nl) (must fail: wire faults); (c) CC on
     symmetrize(rmat(16, 16)) snapshotted after 2 supersteps on the 4
     ranks and restored elastically onto 2 of them (`make_restore_mesh`),
     reaching scipy's min-id labels.
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

import functools
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
# phase 9 (a): the flash backward against the f32 plain backward, relative
# norm per gradient.  P and dS enter the tensor cores as one bf16 term each
# (relative rounding up to 2^-9, of either sign) and both sides round each
# gradient to bf16 once, so a sound kernel sits a few 2^-9 / sqrt(3) away;
# 1e-2 is about 5 x 2^-9.  Dropping one head of a GQA group moves dK and
# dV by about 1 / sqrt(group) of their size.
FLASH_GRAD_REL_LIMIT = 1e-2
FLASH_BWD_SHAPES = [
    # name, B, Hq, Hkv, Lq, Lk, Dh, causal, kv_offset
    ("recurrentgemma-2b windowed call", 2, 10, 1, 2048, 4096, 256, True,
     2048),
    ("recurrentgemma-2b chunk-0 call, strided views", 1, 10, 1, 2048, 2048,
     256, True, 0),
    ("stablelm-1.6b causal", 1, 32, 32, 4096, 4096, 64, True, 0),
    ("GQA 4 cross, non-causal", 1, 32, 8, 4096, 1664, 128, False, 0)]
# the dK/dV walk with one head of each group dropped (phase 9's mutant)
BWD_HEADS = ("  const int n_heads = group;  // the group's query heads, each "
             "summed in order", "  const int n_heads = group - 1;")
# phase 9 (a): the forward's log-sum-exp against the plain one per row:
# f32 sums of the same terms in other orders (the tensor cores' truncated
# sums of exact bf16 products in the mma bodies); the lse is O(10)
FLASH_LSE_REL, FLASH_LSE_ABS = 1e-5, 1e-4
# phase 9 (b): recurrentgemma-2b's training step
RG_ARCH, RG_BATCH, RG_SEQ, RG_STEPS, RG_DECODE = ("recurrentgemma-2b", 1,
                                                  4096, 3, 8)
# step 1's loss through the kernels vs through the plain versions, relative
# (scripts/lm_loss_spread.py on an NVIDIA H100 80GB HBM3, 700 W): kernels
# 12.8882122 vs plain 12.8879404, 2.1e-5; the plain loss itself moves by
# 7.0e-5 and 1.1e-5 when the weights move by a relative 1e-6 and 1e-5 N(0,
# 1).  So the limit is 3e-4, ~4x the largest rounding spread.  As phase
# 8's, it checks that the model runs the same function through the
# kernels; every flash backward call held in place checks the kernel.
RG_TRAIN_LOSS_LIMIT = 3e-4
# phase 10: MoE and encoder-decoder models, and training with context
# tokens, at full width.  Depth is cut where the f32 weights (to serve) or
# the weights, gradients and two AdamW moments (to train: 16 B a
# parameter) would not fit the card's 80 GB with room for activations:
# (arch, layers or None for the whole config, why)
P10_SERVE = [
    ("moonshot-v1-16b-a3b", 24,
     "a layer is 570.5 M parameters (553.6 M of them experts) beside a "
     "335.5 M embedding: 48 layers are 110 GB in f32, 24 are 56.1 GB"),
    ("seamless-m4t-medium", None, "716 M parameters, 2.9 GB in f32")]
P10_TRAIN = [
    ("moonshot-v1-16b-a3b", 4,
     "4 layers are 2.62 B parameters, 41.9 GB trained, beside [1, 4096, "
     "163840] f32 logits and their gradient"),
    ("seamless-m4t-medium", None, "716 M parameters, 11.5 GB trained"),
    ("llama-3.2-vision-11b", 10,
     "two periods of 5 (two cross-attention layers, two recomputed "
     "super-layers): 2.81 B parameters, 44.9 GB trained")]
P10_BATCH, P10_SEQ, P10_STEPS = 1, 4096, 3
P10_PEAK_LIMIT = 80e9          # bytes: the card's memory
# step 1's loss through the kernels vs through the plain versions, relative
# (scripts/lm_loss_spread.py --arch A --layers N on an NVIDIA H100 80GB
# HBM3, 700 W): kernels vs plain 8.1e-6 / 1.0e-4 / 1.0e-5, the plain loss
# moved by up to 4.2e-5 / 7.8e-5 / 7.9e-5 under weight noise of 1e-6 and
# 1e-5 N(0, 1).  Each limit is ~4x the largest of those readings, as phase
# 9's; seamless's encoder and cross-attention take the rounding further.
P10_LOSS_LIMIT = {"moonshot-v1-16b-a3b": 2e-4, "seamless-m4t-medium": 4e-4,
                  "llama-3.2-vision-11b": 4e-4}
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


def graph_ms(fn, n: int = 20) -> float:
    """Device milliseconds a call of `fn` (a sequence of small kernels),
    timed by CUDA events over n replays of `fn` captured as one CUDA graph:
    no host dispatch between its kernels and no profiler."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(n):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    ms = a.elapsed_time(b) / n
    del graph
    return ms


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
# phase 4a: delta PageRank's tolerance and a max_supersteps it halts well
# before; the supersteps of the traced runs
DELTA_TOL, DELTA_MAX, TRACE_STEPS = 1e-3, 100, 3
TRI_SCALE = 15                         # phase 4b triangle count graph
COARSEN_SCALE = 19                     # phase 4b coarsen graph
# phase 4c: fig4's auto policy (benchmarks/fig4_incremental.py), CC's ragged
# capacity (a fraction of the route its early supersteps overflow), and the
# broadcast set's replication threshold
FIG4_AUTO = dict(cap_rounding=32, enter_frac=0.95, exit_frac=0.97)
CC_RAGGED_FRAC = 0.125
BCAST_MIN_REPL = 3
# the hybrid cut's source-degree threshold: what its sweep
# (`partition.choose_hybrid_threshold`) picks on symmetrize(rmat(s, 16,
# seed=1)) at s = 17, 18, 19; the sweep alone took two thirds of a 248.7 s
# build at s = 21 (NVIDIA H100 80GB HBM3, 700 W host), so it is fixed
HYBRID_THRESHOLD = 8
# phase 4d: the dataflow PageRank's iterations and reset probability (as
# phase 3's engine PageRank)
DF_ITERS, DF_RESET = PR_ITERS, 0.15
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


def edited_module(name: str, old: str, new: str):
    """The port's module `name` with one line edited, loaded as a module of
    the port's package (the mutants of phases 4a, 4c and 4d)."""
    import importlib
    import types
    orig = importlib.import_module(name)
    src = Path(orig.__file__).read_text()
    if src.count(old) != 1:
        raise AssertionError(f"mutant: {old!r} is not in {name} exactly once")
    mod = types.ModuleType(name + "_mutant")
    mod.__package__ = orig.__package__
    sys.modules[mod.__name__] = mod     # dataclasses look their module up
    try:
        exec(compile(src.replace(old, new), orig.__file__, "exec"),
             mod.__dict__)
    finally:
        del sys.modules[mod.__name__]
    return mod


def pregel_mutant(old: str, new: str):
    """core/pregel.py with one line edited (phase 4a's mutants of
    pregel_fused)."""
    return edited_module("repro_torch.core.pregel", old, new)


def eager_pregel(g, vprog, send, gather, *, default_msg, max_supersteps,
                 skip_stale, changed_fn=None):
    """The loop the drivers replace, written out here: core.pregel's
    `_superstep` called superstep by superstep, eagerly, reading the live
    count after each.  Returns (graph, supersteps)."""
    import importlib
    import torch
    from repro_torch.core import mrtriplets as mt
    from repro_torch.core.tree import tree_map
    pm = importlib.import_module("repro_torch.core.pregel")
    aplan = mt._plan_apply(g, vprog, send, gather, changed_fn, default_msg,
                           None)
    dmsg = tree_map(lambda d: torch.as_tensor(d).to(g.device), default_msg)
    steps = 0
    for _ in range(max_supersteps):
        g, live, _ = pm._superstep(
            g, vprog=vprog, send_msg=send, gather=gather, default_msg=dmsg,
            skip_stale=skip_stale, changed_fn=changed_fn, kernel_mode="auto",
            use_cache=True, payload_bound=None, aplan=aplan)
        steps += 1
        if int(live) == 0:
            break
    return g, steps


def phase_4a_drivers(g, sg, cc_ids, cc_want):
    """The three Pregel drivers on the main path's graphs (phase 4a; see
    the docstring): the eager loop, the captured `pregel` and
    `pregel_fused`, bit-equal with equal superstep counts; two mutants of
    `pregel_fused`; times, captures, memory, launches and traces."""
    import importlib
    import numpy as np
    import torch
    from repro_torch import profiling as prof_mod
    from repro_torch.core import algorithms as alg
    from repro_torch.core import capture, pregel, pregel_fused
    from repro_torch.kernels import ops
    pm = importlib.import_module("repro_torch.core.pregel")
    k = pm.FUSED_BLOCK
    if (PR_ITERS - 1) % k == 0:
        raise AssertionError(f"{PR_ITERS} supersteps fill blocks of {k}: "
                             "no masked superstep would run")
    zero = {"m": torch.tensor(0.0)}
    g_deg = alg.attach_out_degree(g)
    dvp, dch = alg.delta_pagerank_fns(0.15, DELTA_TOL)
    pr_args = (g_deg.mapV(alg._pr_init), alg.pagerank_vprog(0.15),
               alg.pagerank_send, "sum")
    pr_kw = dict(default_msg=zero, max_supersteps=PR_ITERS, skip_stale=None)
    runs = [
        (f"pagerank tol 0, {PR_ITERS} supersteps", pr_args, pr_kw),
        (f"delta pagerank tol {DELTA_TOL}",
         (g_deg.mapV(lambda vid, v: {**v, "pr": torch.tensor(0.15),
                                     "delta": torch.tensor(0.15)}),
          dvp, alg.delta_pagerank_send, "sum"),
         dict(default_msg=zero, max_supersteps=DELTA_MAX, skip_stale="out",
              changed_fn=dch)),
        (f"cc on symmetrize(rmat({CC_SCALE},16))",
         (sg.mapV(alg._cc_init), alg.cc_vprog, alg.cc_send, "min"),
         dict(default_msg={"m": torch.tensor(alg.IMAX, dtype=torch.int32)},
              max_supersteps=100, skip_stale="out")),
        ("sssp from 0, w ~ U(0.5, 3)",
         (sg.mapV(lambda vid, v: {"dist": torch.where(
             vid == 0, torch.tensor(0.0), torch.tensor(alg.INF32))}),
          alg.sssp_vprog, alg.sssp_send, "min"),
         dict(default_msg={"m": torch.tensor(alg.INF32)},
              max_supersteps=100, skip_stale="out"))]

    def carry(gr):
        return capture.flatten(pm._carry(gr))

    def check_same(label, got, want):
        (ta, sa), (tb, sb) = carry(got), carry(want)
        if sa != sb or not all(torch.equal(x, y) for x, y in zip(ta, tb)):
            raise AssertionError(f"{label} differs from the eager loop")

    def drive_once(fn):
        ops.reset_launch_counts()
        capture.reset_stats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        gr, n = fn()
        torch.cuda.synchronize()
        st = {"ms": (time.perf_counter() - t0) * 1e3,
              "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
              "captures": capture.stats["captures"],
              "capture_ms": capture.stats["capture_s"] * 1e3,
              "release_ms": capture.stats["release_s"] * 1e3,
              **ops.launch_counts()}
        return gr, n, st

    def drive(fn):
        """(graph, supersteps, stats) of the faster of two runs of one
        driver, its launches and captures counted alone (the host clock
        of a single run swings on the shared host)."""
        first, second = drive_once(fn), drive_once(fn)
        if first[1] != second[1]:
            raise AssertionError("two runs of one driver ran "
                                 f"{first[1]} and {second[1]} supersteps")
        return min(first, second, key=lambda r: r[2]["ms"])

    def drivers(args, kw):
        return {
            "eager loop": lambda: eager_pregel(*args, **kw),
            "pregel (captured)": lambda: (lambda r: (r.graph, r.supersteps))(
                pregel(*args, **kw)),
            f"pregel_fused (K {k})": lambda: (lambda o: (o[0], int(o[1])))(
                pregel_fused(*args, **kw))}

    table = {}
    for label, args, kw in runs:
        out = {}
        for dname, fn in drivers(args, kw).items():
            out[dname] = drive(fn)
        want, n, _ = out["eager loop"]
        for dname, (gr, m, st) in out.items():
            if m != n:
                raise AssertionError(f"{label}: {dname} ran {m} supersteps, "
                                     f"the eager loop {n}")
            check_same(f"{label}: {dname}", gr, want)
            if dname != "eager loop" and n > 1 and st["captures"] != 1:
                raise AssertionError(f"{label}: {dname} made "
                                     f"{st['captures']} captures")
        if label.startswith("delta") and not n < DELTA_MAX:
            raise AssertionError(f"{label}: {n} supersteps did not halt")
        if label.startswith("cc"):
            ids, vals = want.vertices_to_numpy()
            if not (np.array_equal(ids, cc_ids)
                    and np.array_equal(vals["cc"], cc_want)):
                raise AssertionError("cc labels differ from scipy's")
        log(f"  {label}: {n} supersteps, the three drivers bit-equal (state, "
            f"view, wire log)" + (", labels == scipy" if label.startswith("cc")
                                  else ""))
        for dname, (_, _, st) in out.items():
            launched = st["triplet"] + st["apply"] + st["segment_sum"]
            log(f"    {dname}: {st['ms']:.2f} ms, {st['ms'] / n:.3f} ms a "
                f"superstep; capture {st['capture_ms']:.1f} ms, release "
                f"{st['release_ms']:.1f} ms; peak "
                f"{st['peak_gib']:.2f} GiB; launches a superstep "
                f"{launched / n:.2f} (triplet {st['triplet']}, apply "
                f"{st['apply']})")
        table[label] = {d: dict(st, supersteps=n) for d, (_, _, st)
                        in out.items()}
        del out, want

    # the supersteps after the second: a 10-superstep run less a
    # 2-superstep one (each less its own capture and release), over the 8
    # supersteps between
    short = dict(pr_kw, max_supersteps=2)

    def net_ms(fn):
        st = drive_once(fn)[2]
        return st["ms"] - st["capture_ms"] - st["release_ms"]

    per = {}
    for dname, fn in drivers(pr_args, short).items():
        t2 = min(net_ms(fn) for _ in range(3))
        t10 = min(net_ms(drivers(pr_args, pr_kw)[dname]) for _ in range(3))
        per[dname] = (t10 - t2) / (PR_ITERS - 2)
    log("  pagerank ms a superstep after the second (10-superstep run less a "
        "2-superstep one, each less its capture and release, best of 3): "
        + ", ".join(f"{d} {v:.3f}" for d, v in per.items()))

    # mutants: the max_supersteps mask dropped; the counter deaf to `run`
    want, steps = pregel_fused(*pr_args, **pr_kw)
    no_cap = pregel_mutant("run = (live > 0) & (i < max_supersteps)",
                           "run = live > 0")
    got, _ = no_cap.pregel_fused(*pr_args, **pr_kw)
    if torch.equal(got.vdata["pr"], want.vdata["pr"]):
        raise AssertionError("pregel_fused without its max_supersteps mask "
                             "gave the same static pagerank")
    loose = pregel_mutant("i = i + run.to(i.dtype)", "i = i + 1")
    _, got_steps = loose.pregel_fused(*pr_args, **pr_kw)
    if int(got_steps) == int(steps):
        raise AssertionError("pregel_fused counting masked supersteps gave "
                             "the same superstep count")
    log(f"  mutants fail as they must: no max_supersteps mask -> other "
        f"ranks; counter deaf to the mask -> {int(got_steps)} supersteps, "
        f"not {int(steps)}")
    del want, got, no_cap, loose

    # traced TRACE_STEPS-superstep pagerank: device busy and idle share
    tr_kw = dict(pr_kw, max_supersteps=TRACE_STEPS)
    for dname, fn in drivers(pr_args, tr_kw).items():
        fn()
        (_, n), wall, trace = prof_mod.traced(fn)
        busy_ms, kernels = prof_mod.busy(trace)
        home = prof_mod.home_line(prof_mod.span_stats(trace), n)
        log(f"  traced pagerank, {n} supersteps, {dname}: wall "
            f"{wall * 1e3:.2f} ms, device busy {busy_ms:.2f} ms, idle share "
            f"{1 - busy_ms / 1e3 / wall:.1%}, {kernels} device events; "
            f"{home}")
        table.setdefault("traced", {})[dname] = {
            "wall_ms": wall * 1e3, "busy_ms": busy_ms, "kernels": kernels}
        del trace

    # the steady state: TRACE_STEPS supersteps after the first, each run
    # eagerly or replayed from one capture, the live count read after each
    step = pm._step_fn(*pr_args, default_msg=zero, skip_stale=None,
                       changed_fn=None, kernel_mode="auto", incremental=True,
                       payload_bound=None, fuse_apply="auto")
    g1, _, _ = step(pr_args[0])

    def eager_steps():
        gi = g1
        for _ in range(TRACE_STEPS):
            gi, live, _ = step(gi)
            int(live)

    def replayed(c):
        g2, live, _ = step(g1.replace(**c))
        return pm._carry(g2), live

    with capture.Replay(replayed, pm._carry(g1), capture=True) as rep:
        def replay_steps():
            for _ in range(TRACE_STEPS):
                int(rep.run())
        for dname, fn in (("eager", eager_steps), ("replayed", replay_steps)):
            fn()
            _, wall, trace = prof_mod.traced(fn)
            busy_ms, kernels = prof_mod.busy(trace)
            log(f"  traced pagerank, {TRACE_STEPS} supersteps after the "
                f"first, {dname}: wall {wall * 1e3:.2f} ms, device busy "
                f"{busy_ms:.2f} ms, idle share {1 - busy_ms / 1e3 / wall:.1%}"
                f", {kernels} device events")
            table["traced"][f"steady {dname}"] = {
                "wall_ms": wall * 1e3, "busy_ms": busy_ms,
                "kernels": kernels}
            del trace
    return table


def transport_mutant(name: str, old: str, new: str):
    """The function `name` of core/transport.py with one line edited (phase
    4c's mutants)."""
    return getattr(edited_module("repro_torch.core.transport", old, new),
                   name)


def must_fail(label: str, check, swap: tuple,
              module: str = "repro_torch.core.transport"):
    """Run `check` with `module`'s function swap[0] replaced by swap[1];
    the check must raise AssertionError."""
    import importlib
    tm = importlib.import_module(module)
    name, fn = swap
    keep = getattr(tm, name)
    setattr(tm, name, fn)
    try:
        check()
    except AssertionError as e:
        return str(e).splitlines()[0][:120]
    finally:
        setattr(tm, name, keep)
    raise AssertionError(f"mutant {label}: the checks passed")


def same_state(label, got, want):
    """Phase 4c: the carry of two Pregel results bit-equal (values, active
    mask, the view's tensors and plan) and their wire logs' ship counts and
    accounted bytes; the bytes shipped may differ (that is what the
    transports change)."""
    import importlib
    import torch
    from repro_torch.core import capture
    pm = importlib.import_module("repro_torch.core.pregel")
    a, b = dict(pm._carry(got)), dict(pm._carry(want))
    la, lb = a.pop("wire_log"), b.pop("wire_log")
    (ta, sa), (tb, sb) = capture.flatten(a), capture.flatten(b)
    if sa != sb or not all(torch.equal(x, y) for x, y in zip(ta, tb)):
        raise AssertionError(f"{label}: state differs from the dense run")
    if not (torch.equal(la.ships, lb.ships)
            and torch.equal(la.bytes_accounted, lb.bytes_accounted)):
        raise AssertionError(f"{label}: wire log's ships or accounted bytes "
                             "differ from the dense run's")


def ship_bytes_formula(side: dict, plan: dict, back: bool, delta_ship: bool,
                       codec) -> int:
    """The bytes one routed ship moves by the host formulas, for the branch
    its record says it took: the dense wire (payload, plus a flag byte an
    entry on a delta ship) or `transport.ragged_wire_bytes` at the
    capacities of `plan` (the return route's own fractions for `back`).
    The ships of phase 4c carry f32 leaves of width 1."""
    import torch
    from repro_torch.core import transport as T
    from repro_torch.core.tree import ElemSpec
    k = side["route_width"]
    if k == 0:
        return 0
    n_leaves = side["wire_bytes"] // (P * P * k * 4)
    if n_leaves * P * P * k * 4 != side["wire_bytes"]:
        raise AssertionError(f"ship of {side['wire_bytes']} bytes is not "
                             f"f32 leaves over [{P}, {P}, {k}]")
    if not side["ragged"]:
        return side["wire_bytes"] + (P * P * k if delta_ship else 0)
    pol = T.TransportPolicy(**plan)
    if back and pol.capacity_frac_back is not None:
        pol = pol.replace(capacity_frac=pol.capacity_frac_back,
                          capacity_fracs=pol.capacity_fracs_back)
    cap = T.capacity_for(pol, k)
    spec = {f"l{i}": ElemSpec((P, P, k), torch.float32)
            for i in range(n_leaves)}
    return T.ragged_wire_bytes(spec, codec, None, cap,
                               T.capacity_vec_for(pol, k, P, cap))


def check_transport_bytes(label, r, codec):
    """Each superstep's bytes_shipped, both routes and their sum, equal to
    the host formula of the branch it recorded; (ragged supersteps, the
    largest dense superstep's bytes, the last ragged one's)."""
    for i, m in enumerate(r.metrics):
        want = 0
        for side in ("fwd", "back"):
            f = ship_bytes_formula(m[side], m["transport_plan"],
                                   side == "back", side == "back" or i > 0,
                                   codec)
            if m[side]["bytes_shipped"] != f:
                raise AssertionError(
                    f"{label}: superstep {i + 1} {side} shipped "
                    f"{m[side]['bytes_shipped']} bytes, the formula of its "
                    f"branch (ragged {m[side]['ragged']}) {f}")
            want += f
        if m["bytes_shipped"] != want:
            raise AssertionError(f"{label}: superstep {i + 1} shipped "
                                 f"{m['bytes_shipped']}, formula {want}")
    rag = [m for m in r.metrics if m["ragged"] == 1.0]
    dense = [m["bytes_shipped"] for m in r.metrics if m["ragged"] == 0.0]
    return len(rag), max(dense), (rag[-1]["bytes_shipped"] if rag else None)


def same_labels(ids, vals, cc_ids, cc_want) -> bool:
    """Vertex ids and labels equal to (cc_ids, cc_want) as sets of pairs
    (another partitioner lists the vertices in another order)."""
    import numpy as np
    a, b = np.argsort(ids), np.argsort(cc_ids)
    return (np.array_equal(ids[a], cc_ids[b])
            and np.array_equal(vals[a], cc_want[b]))


def host_copies(trace) -> int:
    """The copies the host asked of the card in a profile (a read of a
    device tensor is one cudaMemcpyAsync)."""
    from torch.autograd import DeviceType
    return sum(1 for e in trace.events()
               if e.device_type == DeviceType.CPU and "Memcpy" in e.name)


def phase_4c_transports(g, sg, sgd, cc_ids, cc_want, tally):
    """The transports on the main path's graphs (phase 4c; see the
    docstring).  Returns the table it logs."""
    import dataclasses
    import importlib
    import numpy as np
    import torch
    from repro_torch import profiling as prof_mod
    from repro_torch.core import algorithms as alg
    from repro_torch.core import capture, pregel, pregel_fused, with_wire
    from repro_torch.core import mrtriplets as mt
    from repro_torch.core import transport as T
    from repro_torch.core.graph import Graph
    from repro_torch.kernels import ops
    pm = importlib.import_module("repro_torch.core.pregel")
    dev = g.device
    table = {}
    zero = {"m": torch.tensor(0.0)}
    auto = T.TransportPolicy("auto", **FIG4_AUTO)
    transports = {"dense": None, "ragged": "ragged", "auto (fig4)": auto,
                  "auto (fig4), pipeline": auto.replace(pipeline=True)}

    # (a) delta PageRank over the f32 delta wire
    gw = g.replace(ex=with_wire(g.ex, "f32", delta=True))
    dvp, dch = alg.delta_pagerank_fns(0.15, DELTA_TOL)
    g_dl = alg.attach_out_degree(gw).mapV(
        lambda vid, v: {**v, "pr": torch.tensor(0.15),
                        "delta": torch.tensor(0.15)})
    args = (g_dl, dvp, alg.delta_pagerank_send, "sum")
    kw = dict(default_msg=zero, max_supersteps=DELTA_MAX, skip_stale="out",
              changed_fn=dch)
    codec = gw.ex.codec

    def timed(tp):
        ops.reset_launch_counts()
        capture.reset_stats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        r = pregel(*args, transport=tp, **kw)
        torch.cuda.synchronize()
        return r, {"ms": (time.perf_counter() - t0) * 1e3,
                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                   "captures": capture.stats["captures"],
                   "capture_ms": capture.stats["capture_s"] * 1e3,
                   "release_ms": capture.stats["release_s"] * 1e3}

    def steady(pol, label):
        """3 supersteps after the first, replayed from one capture under
        `pol`, traced: wall, device busy, idle share, and the host's
        device-to-host copies (one read a superstep)."""
        watch = pol is not None and T.resolve_transport(pol).kind != "dense"
        step = pm._step_fn(*args, default_msg=zero, skip_stale="out",
                           changed_fn=dch, kernel_mode="auto",
                           incremental=True, payload_bound=None,
                           fuse_apply="auto", transport=pol)
        g1, _, _ = step(args[0])

        def replayed(c):
            g2, live, m = step(g1.replace(**c))
            return pm._carry(g2), pm._progress(live, m, watch)

        with capture.Replay(replayed, pm._carry(g1),
                            capture=pm._captures(dev, "auto")) as rep:
            def run3():
                for _ in range(TRACE_STEPS):
                    rep.run().tolist()
            run3()
            _, wall, trace = prof_mod.traced(run3)
            busy_ms, kernels = prof_mod.busy(trace)
            copies = host_copies(trace)
            del trace
        if copies != TRACE_STEPS:
            raise AssertionError(f"{label}: {copies} host copies in "
                                 f"{TRACE_STEPS} replayed supersteps")
        return {"wall_ms": wall * 1e3, "busy_ms": busy_ms,
                "idle": 1 - busy_ms / 1e3 / wall, "kernels": kernels,
                "host_reads": copies}

    base, n_base = None, None
    for label, tp in transports.items():
        runs = [timed(tp) for _ in range(2)]
        r, st = min(runs, key=lambda x: x[1]["ms"])
        n = r.supersteps
        rt = main_path_run(tally, f"delta pagerank, transport {label}",
                           lambda: pregel(*args, transport=tp,
                                          track_metrics=True, **kw),
                           launched=("triplet", "apply"))
        if base is None:
            base, n_base = rt, n
        if not (n == rt.supersteps == n_base < DELTA_MAX):
            raise AssertionError(f"delta pagerank, {label}: {n} / "
                                 f"{rt.supersteps} supersteps, dense "
                                 f"{n_base}")
        same_state(f"delta pagerank, {label}", r.graph, base.graph)
        same_state(f"delta pagerank, {label} (tracked)", rt.graph,
                   base.graph)
        n_rag, dense_max, last_rag = check_transport_bytes(
            f"delta pagerank, {label}", rt, codec)
        if tp is not None:
            if not n_rag:
                raise AssertionError(f"delta pagerank, {label}: no ragged "
                                     "superstep")
            if not last_rag < dense_max:
                raise AssertionError(
                    f"delta pagerank, {label}: the last ragged superstep "
                    f"shipped {last_rag} bytes, the largest dense one "
                    f"{dense_max}")
        plan = ([m["transport_plan"] for m in rt.metrics
                 if m["ragged"] == 1.0] or [None])[-1]
        pol = (None if tp is None else
               tp if T.resolve_transport(tp).kind != "auto"
               else T.TransportPolicy(**plan))
        sty = steady(pol, f"delta pagerank, {label}")
        row = dict(st, supersteps=n, ms_a_superstep=st["ms"] / n,
                   recompiles=rt.metrics[-1]["recompiles"],
                   ragged_supersteps=n_rag, dense_max_bytes=dense_max,
                   last_ragged_bytes=last_rag, steady=sty,
                   bytes_shipped=float(rt.graph.bytes_shipped))
        table[f"delta pagerank, {label}"] = row
        log(f"  delta pagerank, {label}: {n} supersteps, state == dense; "
            f"{st['ms'] / n:.3f} ms a superstep; recompiles "
            f"{row['recompiles']}, captures {st['captures']}, capture "
            f"{st['capture_ms']:.1f} ms, release {st['release_ms']:.1f} ms; "
            f"peak {st['peak_gib']:.2f} GiB; {n_rag} ragged supersteps, last "
            f"ragged {last_rag} bytes vs largest dense {dense_max}; 3 "
            f"replayed supersteps: wall {sty['wall_ms']:.2f} ms, busy "
            f"{sty['busy_ms']:.2f} ms, idle {sty['idle']:.1%}, one host read "
            f"a superstep; bytes shipped in all "
            f"{row['bytes_shipped']:.0f}")
        if label == "auto (fig4)":
            auto_run, auto_plan = rt, pol
        del r, rt, runs

    # pregel_fused under fig4's auto policy (no host re-plan)
    got, steps = pregel_fused(*args, transport=auto, **kw)
    if int(steps) != n_base:
        raise AssertionError(f"pregel_fused auto: {int(steps)} supersteps, "
                             f"dense {n_base}")
    same_state("pregel_fused, auto (fig4)", got, base.graph)
    log(f"  pregel_fused, auto (fig4): {int(steps)} supersteps, state == "
        "dense")
    del got

    # the compaction and the scatter back, and each branch alone vs both,
    # at the width and occupancy of a ship of the last ragged superstep
    last = [m for m in auto_run.metrics if m["ragged"] == 1.0][-1]
    side = "fwd" if last["fwd"]["ragged"] == 1.0 else "back"
    side_plan = (auto_plan if side == "fwd" or auto_plan.capacity_frac_back
                 is None else auto_plan.replace(
                     capacity_frac=auto_plan.capacity_frac_back,
                     capacity_fracs=auto_plan.capacity_fracs_back))
    k_f = last[side]["route_width"]
    occ = max(last[side]["route_active_frac"])
    gen = torch.Generator(device=dev).manual_seed(0)
    flags = torch.rand((P, P, k_f), device=dev, generator=gen) < occ
    tree = {"m": torch.randn((P, P, k_f), device=dev, generator=gen)}
    cap = T.capacity_for(side_plan, k_f)
    comp, sel, valid, cnt = T._compact(tree, flags, cap)
    idx = torch.where(valid, sel, k_f)
    ex = gw.ex
    auto_plan = side_plan
    rag_only = auto_plan.replace(fallback=False)
    timing = {
        "compaction": graph_ms(lambda: T._compact(tree, flags, cap)),
        "scatter back": graph_ms(lambda: T._scatter_rows(comp["m"], idx,
                                                         k_f)),
        "dense ship": graph_ms(lambda: T.ship_transport(ex, tree, flags)),
        "ragged ship alone": graph_ms(lambda: T.ship_transport(
            ex, tree, flags, policy=rag_only)),
        "both branches + select": graph_ms(lambda: T.ship_transport(
            ex, tree, flags, policy=auto_plan))}
    log(f"  one {side} ship, K {k_f}, occupancy {occ:.4f}, capacity {cap}"
        f": device ms (CUDA events over 20 replays of a graph of one call) "
        + ", ".join(f"{k} {v:.4f}" for k, v in timing.items()))
    table["ship device ms"] = timing
    del comp, sel, valid, cnt, idx, flags, tree, base, auto_run

    # mutant: a compaction that drops each route's last active entry
    def rerun_ragged():
        r = pregel(*args, transport="ragged", **kw)
        same_state("delta pagerank, ragged", r.graph,
                   pregel(*args, **kw).graph)
    why = must_fail("compaction dropping the last active entry", rerun_ragged,
                    ("_compact", transport_mutant(
                        "_compact",
                        "counts = flags.sum(-1, dtype=torch.int32)  # [nl, P]",
                        "counts = (flags.sum(-1, dtype=torch.int32) - 1)"
                        ".clamp_min(0)  # [nl, P]")))
    log(f"  mutant, compaction dropping each route's last active entry: "
        f"fails ({why})")

    # (b) CC through the ragged transport at a capacity the early
    # supersteps overflow
    cc_tp = T.TransportPolicy("ragged", capacity_frac=CC_RAGGED_FRAC)
    cc_args = (sg.mapV(alg._cc_init), alg.cc_vprog, alg.cc_send, "min")
    cc_kw = dict(default_msg={"m": torch.tensor(alg.IMAX, dtype=torch.int32)},
                 max_supersteps=100, skip_stale="out")
    cc_dense = pregel(*cc_args, **cc_kw)

    def cc_check():
        r = pregel(*cc_args, transport=cc_tp, track_metrics=True, **cc_kw)
        if r.supersteps != cc_dense.supersteps or not torch.equal(
                r.graph.vdata["cc"], cc_dense.graph.vdata["cc"]):
            raise AssertionError("cc, ragged: labels or supersteps differ "
                                 "from the dense run")
        ids, vals = r.graph.vertices_to_numpy()
        if not (np.array_equal(ids, cc_ids)
                and np.array_equal(vals["cc"], cc_want)):
            raise AssertionError("cc, ragged: labels differ from scipy's")
        over = [m["overflow_fallbacks"] for m in r.metrics]
        rag = [m["ragged"] for m in r.metrics]
        first = next((i for i, o in enumerate(over) if o), None)
        if first is None or not any(rag[first + 1:]):
            raise AssertionError(f"cc, ragged: overflow fallbacks {over}, "
                                 f"ragged {rag}: no fallback both ways")
        return r, over, rag
    r, over, rag = main_path_run(tally, "cc, transport ragged 1/8", cc_check,
                                 launched=("triplet", "apply"))
    log(f"  cc, ragged at capacity {CC_RAGGED_FRAC}: {r.supersteps} "
        f"supersteps, labels == dense == scipy; overflow fallbacks a "
        f"superstep {over}, ragged {rag}")
    table["cc ragged"] = {"overflow": over, "ragged": rag}
    why = must_fail("overflow check that never falls back", cc_check,
                    ("_ship_once", transport_mutant(
                        "_ship_once",
                        "over_any = ex.psum(overflow.to(torch.int32)) > 0",
                        "over_any = ex.psum(overflow.to(torch.int32)) < 0")))
    log(f"  mutant, overflow check that never falls back: fails ({why})")
    del r, cc_dense

    # (c) the int8 wire and the ragged transport on PageRank's graph
    g8 = g.replace(ex=with_wire(g.ex, "int8", delta=True))
    g8_dl = alg.attach_out_degree(g8).mapV(
        lambda vid, v: {**v, "pr": torch.tensor(0.15),
                        "delta": torch.tensor(0.15)})
    args8 = (g8_dl,) + args[1:]
    r8 = main_path_run(tally, "delta pagerank, int8 wire, transport ragged",
                       lambda: pregel(*args8, transport="ragged",
                                      track_metrics=True, **kw),
                       launched=("triplet", "apply"))
    f32 = pregel(*args, **kw).graph

    def norm(gr):
        pr = gr.vdata["pr"][gr.vmask].double()
        return pr / pr.sum()
    err = float((norm(r8.graph) - norm(f32)).abs().max())
    if not err <= RANK_LIMIT:
        raise AssertionError(f"delta pagerank int8 + ragged: normalised "
                             f"ranks {err} from the f32 run's")
    # one superstep's forward ship, on the card and on the CPU
    k8 = next(i for i, m in enumerate(r8.metrics)
              if m["fwd"]["ragged"] == 1.0)
    mid = pregel(*args8, transport="ragged",
                 **dict(kw, max_supersteps=k8)).graph
    s = mid.s
    send_idx, _ = s.routes["src"]
    safe = send_idx.clamp(min=0)
    flags = (send_idx >= 0) & mt._take_rows(mid.active, safe)
    sendbuf = {"delta": mt._take_rows(mid.vdata["delta"], safe)}
    sendbuf = {k: v.masked_fill(~flags, 0) for k, v in sendbuf.items()}
    out = {}
    for where in (dev, "cpu"):
        out[str(where)] = T.ship_transport(
            g8.ex, {k: v.to(where) for k, v in sendbuf.items()},
            flags.to(where), policy=T.RAGGED)
    (rc, fc, ic), (rh, fh, ih) = out[str(dev)], out["cpu"]
    if float(ic.ragged) != 1.0:
        raise AssertionError("int8 + ragged: the forward ship of superstep "
                             f"{k8 + 1} did not ship ragged")
    if not (torch.equal(fc.cpu(), fh) and torch.equal(rc["delta"].cpu(),
                                                      rh["delta"])
            and float(ic.bytes_shipped) == float(ih.bytes_shipped)):
        raise AssertionError("int8 + ragged: the card's forward ship differs "
                             "from the CPU's")
    log(f"  int8 wire + ragged: {r8.supersteps} supersteps, normalised ranks "
        f"{err:.3g} from the f32 run (limit {RANK_LIMIT}); superstep "
        f"{k8 + 1}'s forward ship (K {send_idx.shape[2]}, "
        f"{int(flags.sum())} entries, ragged, {float(ic.bytes_shipped):.0f} "
        f"bytes) == the CPU's bit for bit")
    table["int8 ragged"] = {"rank_err": err, "supersteps": r8.supersteps}
    del r8, f32, mid, out, rc, rh, sendbuf, flags, g8, g8_dl, args8

    # (d) the broadcast lane: one hybrid build of CC's edges
    t0 = time.perf_counter()
    gh = Graph.from_edges(sgd.src, sgd.dst, num_partitions=P,
                          partitioner="hybrid",
                          hybrid_threshold=HYBRID_THRESHOLD,
                          bcast_min_repl=BCAST_MIN_REPL, device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    if not gh.s.has_bcast:
        raise AssertionError("hybrid build: no broadcast set")
    gh0 = gh.replace(s=dataclasses.replace(gh.s, brecv=None,
                                           p2p_routes=None))
    b_width = gh.s.bsend.shape[1]
    for name, tp in (("dense", None), ("auto", auto)):
        rb = main_path_run(tally, f"cc, broadcast lane, transport {name}",
                           lambda: alg.connected_components(
                               gh, transport=tp, track_metrics=True),
                           launched=("triplet", "apply"))
        rc0 = alg.connected_components(gh0, transport=tp)
        if rb.supersteps != rc0.supersteps or not torch.equal(
                rb.graph.vdata["cc"], rc0.graph.vdata["cc"]):
            raise AssertionError(f"cc, broadcast lane, {name}: differs from "
                                 "the structure without it")
        ids, vals = rb.graph.vertices_to_numpy()
        if not same_labels(ids, vals["cc"], cc_ids, cc_want):
            raise AssertionError(f"cc, broadcast lane, {name}: labels differ "
                                 "from scipy's")
        gdl = alg.attach_out_degree(
            gh.replace(ex=with_wire(gh.ex, "f32", delta=True))).mapV(
                lambda vid, v: {**v, "pr": torch.tensor(0.15),
                                "delta": torch.tensor(0.15)})
        gdl0 = gdl.replace(s=gh0.s)
        pa = pregel(gdl, *args[1:], transport=tp, **kw)
        pb = pregel(gdl0, *args[1:], transport=tp, **kw)
        if pa.supersteps != pb.supersteps or not all(
                torch.equal(pa.graph.vdata[k], pb.graph.vdata[k])
                for k in pa.graph.vdata):
            raise AssertionError(f"delta pagerank, broadcast lane, {name}: "
                                 "differs from the structure without it")
        log(f"  broadcast lane, {name}: cc {rb.supersteps} supersteps == "
            f"without the lane == scipy; delta pagerank {pa.supersteps} "
            f"supersteps == without the lane; bytes shipped cc "
            f"{float(rb.graph.bytes_shipped):.0f} vs "
            f"{float(rc0.graph.bytes_shipped):.0f}, pagerank "
            f"{float(pa.graph.bytes_shipped):.0f} vs "
            f"{float(pb.graph.bytes_shipped):.0f} without")
        table[f"bcast {name}"] = {
            "cc_bytes": float(rb.graph.bytes_shipped),
            "cc_bytes_without": float(rc0.graph.bytes_shipped),
            "pr_bytes": float(pa.graph.bytes_shipped),
            "pr_bytes_without": float(pb.graph.bytes_shipped)}
        del rb, rc0, pa, pb, gdl, gdl0
    # the all-gather's bytes: one block of CC's labels, by the formula
    bvalid = gh.s.bsend >= 0
    block = {"cc": gh.s.home_vid.gather(1, gh.s.bsend.clamp(min=0).long())}
    _, _, info = T.allgather_ship(gh.ex, block, bvalid)
    want_b = P * b_width * 4 + P * b_width       # int32 ids + a flag byte
    if not (info.bytes_shipped == want_b == T.allgather_wire_bytes(
            {"cc": block["cc"][:, None]}, None, None, P,
            flags_shipped=True)):
        raise AssertionError(f"all-gather bytes {info.bytes_shipped}, "
                             f"formula {want_b}")
    log(f"  hybrid build with bcast_min_repl {BCAST_MIN_REPL}: "
        f"{gh.host.stats.n_broadcast} broadcast vertices, B {b_width}, "
        f"build {t_build:.1f} s; an all-gather of one int32 leaf ships "
        f"{info.bytes_shipped} bytes == the formula")
    table["bcast"] = {"n_broadcast": int(gh.host.stats.n_broadcast),
                      "b_width": b_width, "build_s": t_build}
    return table


def _xy_init(vid, v):
    return {"x": (vid % 17 + 1).float(), "y": (vid % 5).float()}


def _send_xy(sv, ev, dv):
    return {"m": sv["x"] + sv["y"]}


def _join_y(v, o, hit):
    import torch
    return {"x": v["x"], "y": torch.where(hit, o["y"], -1.0)}


def _join_keep(v, o, hit):
    return v


def _join_topk(v, o, hit):
    import torch
    return {"x": torch.where(hit, v["x"] + o["b"], v["x"]), "y": v["y"]}


def _pr_bump(vid, v):
    return {**v, "pr": v["pr"] + 1.0}


def _send_both(sv, ev, dv):
    return {"m": sv["pr"] * ev["w"] + dv["deg"]}


def _vid_f32(vid, v):
    return {**v, "vid": vid.float()}


def _send_deg(sv, ev, dv):
    return {"m": sv["deg"] * ev["w"]}


def _l5_attach(v, o, hit):
    import torch
    return {**v, "msg": torch.where(hit, o["m"], 0.0)}


def _l5_apply(vid, v):
    from repro_torch.core import algorithms as alg
    return alg.pagerank_vprog(DF_RESET)(
        vid, {k: x for k, x in v.items() if k != "msg"}, {"m": v["msg"]})


def _df_contrib(k, v):
    """An edge's (dst, src rank / src out-degree), zero without a rank."""
    import torch
    return v[0]["dst"], torch.where(v[2], v[1]["pr"] / v[1]["deg"], 0.0)


def _df_rank(k, v):
    """A vertex's new rank from its joined sum (none: no in-edges)."""
    import torch
    return k, {"pr": DF_RESET + (1 - DF_RESET) * torch.where(v[2], v[1], 0.0),
               "deg": v[0]["deg"]}


def dataflow_pagerank(gd, dev, iters: int):
    """PageRank written with collection operators only (the paper's Fig. 7
    baseline, benchmarks/common.py:naive_pagerank): each iteration
    left_join (edges to ranks) -> map -> reduce_by_key("sum") -> left_join
    (ranks to sums) -> compact.  Capacities 2 * ceil(E / P^2) for the edge
    join and the reduce, 2 * ceil(V / P) for the rank join: the sums
    arrive partitioned by key, so that join ships each partition to
    itself.  Returns (vids, ranks, the overflow and dropped counts summed
    over every shuffle, ms an iteration, the capacities and rank width)."""
    import numpy as np
    import torch
    from repro_torch.core import Col
    src, dst = gd.src.astype(np.int32), gd.dst.astype(np.int32)
    vids = np.unique(np.concatenate([src, dst]))
    cap_e = 2 * -(-len(src) // P ** 2)
    cap_v = 2 * -(-len(vids) // P)
    edges = Col.from_numpy(src, {"dst": dst}, P, device=dev)
    deg = np.maximum(np.bincount(src, minlength=int(vids.max()) + 1), 1)
    ranks = Col.from_numpy(vids, {"pr": np.ones(len(vids), np.float32),
                                  "deg": deg[vids].astype(np.float32)},
                           P, device=dev)
    width = 2 * ranks.keys.shape[1]
    bad = torch.zeros((), dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        joined, o1 = edges.left_join(ranks, capacity=cap_e)
        contribs = joined.map(_df_contrib)
        del joined
        sums, o2 = contribs.reduce_by_key("sum", capacity=cap_e)
        del contribs
        upd, o3 = ranks.left_join(sums, capacity=cap_v)
        del sums
        new = upd.map(_df_rank)
        del upd
        ranks, dropped = new.compact(width)
        bad = bad + o1 + o2 + o3 + dropped
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    k, v = ranks.to_numpy()
    # one more iteration, synchronised after each operator: where the time
    # goes (its result is dropped)
    split, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        split[name] = (t1 - t0) * 1e3
        t0 = t1
    joined, _ = edges.left_join(ranks, capacity=cap_e)
    lap("left_join edges")
    contribs = joined.map(_df_contrib)
    del joined
    lap("map")
    sums, _ = contribs.reduce_by_key("sum", capacity=cap_e)
    del contribs
    lap("reduce_by_key")
    upd, _ = ranks.left_join(sums, capacity=cap_v)
    del sums
    lap("left_join ranks")
    upd.map(_df_rank).compact(width)
    lap("map + compact")
    return k, v["pr"], int(bad), ms, (cap_e, cap_v, width), split


def phase_4d_dataparallel(g, gd, pr3, tally):
    """The data-parallel half on phase 3's graph (phase 4d; see the
    docstring): the dataflow PageRank, the joins, Listing 5 and the chain
    planner, each main-path run counted alone into `tally`; two mutants
    must fail.  Returns the phase's record."""
    import numpy as np
    import torch
    from repro_torch.core import Col, algorithms as alg, pregel
    from repro_torch.core import planner as TP
    table = {}
    all_kernels = ("triplet", "apply", "segment_sum", "flash_attention",
                   "mlstm_fwd", "mlstm_bwd", "spmv")

    # --- (a) the dataflow PageRank, Fig. 7's baseline, beside a warm run
    # of the engine's (phase 3 built its kernels and plans)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r_eng = alg.pagerank(g, num_iters=DF_ITERS)
    torch.cuda.synchronize()
    eng_ms = (time.perf_counter() - t0) * 1e3 / r_eng.supersteps
    del r_eng
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    k, pr, bad, ms, caps, split = main_path_run(
        tally, "dataflow pagerank", lambda: dataflow_pagerank(
            gd, g.device, DF_ITERS), idle=all_kernels)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    if bad != 0:
        raise AssertionError(f"dataflow pagerank: {bad} entries overflowed "
                             "or dropped")
    ids, pr_eng, want = pr3["ids"], pr3["pr"], pr3["want"]
    full = np.full(int(max(k.max(), ids.max())) + 1, np.nan, np.float64)
    full[k] = pr
    got = full[ids]
    if np.isnan(got).any() or len(k) != len(ids):
        raise AssertionError("dataflow pagerank: vertex sets differ")
    rel_eng = float(np.max(np.abs(got - pr_eng)) / np.max(np.abs(pr_eng)))
    rel_ref = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
    if not (rel_eng <= 1e-4 and rel_ref <= 1e-4):
        raise AssertionError(f"dataflow pagerank vs engine {rel_eng}, vs "
                             f"float64 oracle {rel_ref}")
    table["dataflow"] = {"ms_per_iter": ms, "engine_ms_per_superstep":
                         eng_ms, "peak_gib_above_start": peak,
                         "rel_vs_engine": rel_eng, "rel_vs_oracle": rel_ref,
                         "cap_edge": caps[0], "cap_rank": caps[1],
                         "rank_width": caps[2], "split_ms": split}
    log(f"  dataflow pagerank, {DF_ITERS} iterations: {ms:.1f} ms an "
        f"iteration (the engine's warm run {eng_ms:.2f} ms a superstep "
        f"incl. degree), "
        f"peak {peak:.2f} GiB above the phase's start, capacities edge "
        f"{caps[0]} rank {caps[1]}, 0 overflow, max|d|/max vs engine "
        f"{rel_eng:.3g}, vs oracle {rel_ref:.3g}; no kernel launched; one "
        f"iteration by operator (ms): " + ", ".join(
            f"{name} {t:.1f}" for name, t in split.items()))
    del k, pr, full, got
    gc.collect()
    torch.cuda.empty_cache()

    # --- (b) the joins
    n = gd.num_vertices
    gj = g.mapV(_xy_init)
    ids_all = gj.vertices_to_numpy()[0].astype(np.int64)
    evens = np.arange(0, n, 2, dtype=np.int64)
    col_even = Col.from_numpy(evens.astype(np.int32),
                              {"y": (evens * 10).astype(np.float32)}, P,
                              device=g.device)

    def left_join_check(label="leftJoin"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g2 = main_path_run(tally, label,
                           lambda: gj.leftJoin(col_even, _join_y))
        table.setdefault("leftJoin_ms", (time.perf_counter() - t0) * 1e3)
        vids, vv = g2.vertices_to_numpy()
        want_y = np.where(vids % 2 == 0, (vids * 10).astype(np.float32),
                          np.float32(-1))
        if not np.array_equal(vv["y"], want_y):
            raise AssertionError("leftJoin: values differ from the host "
                                 "oracle")
        if float(g2.ships) != float(gj.ships) or \
                float(g2.bytes_shipped) != float(gj.bytes_shipped):
            raise AssertionError("leftJoin: the graph's wire log grew")
    left_join_check()

    thirds = np.arange(0, n, 3, dtype=np.int64)
    col3 = Col.from_numpy(thirds.astype(np.int32),
                          {"b": np.ones(len(thirds), np.float32)}, P,
                          device=g.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g3 = main_path_run(tally, "innerJoin",
                       lambda: gj.innerJoin(col3, _join_keep))
    table["innerJoin_ms"] = (time.perf_counter() - t0) * 1e3
    vis_ids = np.sort(g3.vertices_to_numpy()[0])
    if not np.array_equal(vis_ids, np.sort(ids_all[ids_all % 3 == 0])):
        raise AssertionError("innerJoin: visible set differs from the host "
                             "oracle")
    svid, dvid, _, _, _, tmask = g3.triplets()
    want_mask = g3.emask & (svid % 3 == 0) & (dvid % 3 == 0)
    n_edges3 = int(((gd.src % 3 == 0) & (gd.dst % 3 == 0)).sum())
    if not torch.equal(tmask, want_mask) or int(tmask.sum()) != n_edges3:
        raise AssertionError("innerJoin: triplet visibility differs from "
                             "the host oracle")
    del svid, dvid, tmask, want_mask, g3

    gw = gj.mrTriplets(_send_xy, "sum")[2]
    elevens = np.arange(0, n, 11, dtype=np.int64)
    col11 = Col.from_numpy(elevens.astype(np.int32),
                           {"b": np.full(len(elevens), 100.0, np.float32)},
                           P, device=g.device)
    g_k = gw.innerJoin(col11, _join_topk, changed="diff")
    got_k, ex_k, _, m_k = main_path_run(
        tally, "top-k join's mrTriplets",
        lambda: g_k.mrTriplets(_send_xy, "sum"), launched=("triplet",))
    cold, ex_c, _, _ = g_k.replace(view=None).mrTriplets(_send_xy, "sum")
    n_vis = int(gj.vmask.sum())
    n_fwd = int(m_k["fwd"].n_shipped)
    if not (n_fwd < n_vis and torch.equal(got_k["m"], cold["m"])
            and torch.equal(ex_k, ex_c)):
        raise AssertionError(f"top-k join: forward n_shipped {n_fwd} of "
                             f"{n_vis} visible, or values != a cold view")
    table["joins"] = {"topk_fwd_n_shipped": n_fwd, "visible": n_vis,
                      "inner_edges": n_edges3}
    log(f"  joins: leftJoin == host oracle, wire log unchanged "
        f"({table['leftJoin_ms']:.1f} ms); innerJoin ({table['innerJoin_ms']:.1f}"
        f" ms, vid % 3) visible set and triplet visibility == host oracle "
        f"({n_edges3} edges); top-k innerJoin(vid % 11, diff): forward "
        f"n_shipped {n_fwd} of {n_vis} visible, == a cold view bit for bit")
    del gw, g_k, got_k, cold, ex_k, ex_c, m_k

    # Listing 5: one PageRank superstep through a join
    g_pr = alg.attach_out_degree(g).mapV(alg._pr_init)

    def listing5():
        vals, exists, _, _ = g_pr.mrTriplets(alg.pagerank_send, "sum")
        msgs = Col(g_pr.s.home_vid, vals, exists & g_pr.vmask, g_pr.ex)
        return g_pr.leftJoin(msgs, _l5_attach).mapV(_l5_apply)
    l5 = main_path_run(tally, "Listing 5 superstep", listing5,
                       launched=("triplet",))
    want_l5 = pregel(g_pr, alg.pagerank_vprog(DF_RESET), alg.pagerank_send,
                     "sum", default_msg={"m": torch.tensor(0.0)},
                     max_supersteps=1, skip_stale=None).graph
    vis = g_pr.vmask
    if not all(torch.equal(l5.vdata[f][vis], want_l5.vdata[f][vis])
               for f in ("pr", "deg")):
        raise AssertionError("Listing 5 superstep != pregel's first "
                             "superstep")
    log("  Listing 5 (mrTriplets -> Col by home vid -> leftJoin -> mapV) "
        "== pregel's first superstep bit for bit")
    del l5, want_l5

    # --- (c) the chain planner
    g_warm = g_pr.mrTriplets(_send_both, "sum")[2]
    fig5 = (TP.MapV(_pr_bump), TP.MrTriplets(alg.pagerank_send),
            TP.MrTriplets(alg.pagerank_send))

    def chain(label, gg, steps, **kw):
        """The chain once to warm its plans and traces, then counted and
        timed: (result, bytes it shipped, ms a step)."""
        TP.run_chain(gg, steps, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = main_path_run(tally, label, lambda: TP.run_chain(gg, steps,
                                                               **kw),
                            launched=("triplet",))
        ms = (time.perf_counter() - t0) * 1e3 / len(steps)
        return res, float(res.graph.bytes_shipped) - float(
            gg.bytes_shipped), ms

    def same_outputs(label, a, b):
        for (va, ea, _), (vb, eb, _) in zip(a.outputs, b.outputs):
            if not (torch.equal(va["m"], vb["m"]) and torch.equal(ea, eb)):
                raise AssertionError(f"{label}: outputs differ")

    def fig5_check(tag=""):
        on, b_on, ms_on = chain("fig5 chain, optimize on" + tag, g_warm,
                                fig5)
        off, b_off, ms_off = chain("fig5 chain, optimize off" + tag, g_warm,
                                   fig5, optimize=False)
        same_outputs("fig5 chain on vs off", on, off)
        if not 0 < b_on <= b_off:
            raise AssertionError(f"fig5 chain bytes on {b_on}, off {b_off}")
        return on, b_on, ms_on, b_off, ms_off
    on, b_on, ms_on, b_off, ms_off = fig5_check()
    auto, b_auto, ms_auto = chain("fig5 chain, auto transport", g_warm,
                                  fig5, transport="auto")
    same_outputs("fig5 chain auto vs dense", auto, on)
    pruned = sum(r.get("pruned_dirs", 0) for r in on.step_metrics)
    log(f"  fig5 chain (mapV -> mrT -> mrT, warm both-direction view): "
        f"on == off == auto bit for bit; bytes on {b_on:.0f}, off "
        f"{b_off:.0f}, auto {b_auto:.0f}; ms a step on {ms_on:.2f}, off "
        f"{ms_off:.2f}, auto {ms_auto:.2f}; {pruned} directions pruned; "
        f"auto plans {[r.get('transport_next') for r in auto.step_metrics]}")
    del on, auto

    gq = alg.attach_out_degree(g).mapV(_vid_f32)
    n_half = float(gq.s.num_vertices) / 2.0

    def dst_low(sv, ev, dv):
        return dv["vid"] < n_half
    fig6 = (TP.Subgraph(epred=dst_low), TP.MrTriplets(_send_deg))
    if TP.plan_chain(gq, fig6).fused != (True, False):
        raise AssertionError("fig6: the Subgraph did not fuse")
    pd, b_pd, ms_pd = chain("fig6 pushdown chain", gq, fig6)
    unf = TP.run_chain(gq, fig6, optimize=False)
    plain = gq.subgraph(epred=dst_low).emask
    same_outputs("fig6 pushdown vs unfused", pd, unf)
    if not (torch.equal(pd.outputs[0][2]["emask_pushed"], plain)
            and torch.equal(pd.graph.emask, plain)):
        raise AssertionError("fig6: pushed-down emask != subgraph(epred)'s")
    live = float(pd.outputs[0][2]["live_edges"])
    b_unf = float(unf.graph.bytes_shipped) - float(gq.bytes_shipped)
    log(f"  fig6 pushdown (subgraph(dst vid < V/2) -> mrT): emask == "
        f"subgraph(epred)'s, values == the unfused chain bit for bit; "
        f"{live:.0f} live edges of {gq.s.num_edges}; bytes {b_pd:.0f} "
        f"(unfused {b_unf:.0f}); {ms_pd:.2f} ms a step")
    table["chains"] = {"fig5_bytes_on": b_on, "fig5_bytes_off": b_off,
                       "fig5_bytes_auto": b_auto, "fig5_ms_step_on": ms_on,
                       "fig5_ms_step_off": ms_off,
                       "fig5_ms_step_auto": ms_auto,
                       "fig6_bytes": b_pd, "fig6_bytes_unfused": b_unf,
                       "fig6_ms_step": ms_pd, "fig6_live_edges": live}
    del pd, unf, plain

    # --- mutants that must fail (their runs are not main-path runs)
    view_mut = edited_module(
        "repro_torch.core.view",
        '        d = "".join(c for c in d0 if c in keep)\n',
        '        d = "".join(c for c in d0 if c in keep and st0)\n')
    hash_mut = edited_module("repro_torch.core.hashing",
                             "    z = (z * 0xC2B2AE35) & _M32\n", "")
    why_view = must_fail("prune_view demoting clean leaves",
                         lambda: fig5_check(" (mutant)"),
                         ("prune_view", view_mut.prune_view),
                         module="repro_torch.core.view")
    why_hash = must_fail("hash without its second multiply",
                         lambda: left_join_check("leftJoin (mutant)"),
                         ("hash_mod_t", hash_mut.hash_mod_t),
                         module="repro_torch.core.collections")
    for label in list(tally):
        if label.endswith("(mutant)"):
            del tally[label]
    log(f"  mutants fail: prune_view demoting clean leaves ({why_view}); "
        f"the hash without its second multiply ({why_hash})")
    return table


def check_plans(label, r, want=("fused", "fused_apply")):
    m0 = r.metrics[0]
    if (m0["plan"], m0["apply_plan"]) != want:
        raise AssertionError(f"{label} plans {m0['plan']}, "
                             f"{m0['apply_plan']}; want {want}")


ELASTIC_SCALE = 16      # phase 4e's elastic restore graph (see the docstring)
SNAP_DIR = ROOT / "build" / "chip_smoke_snapshots"


def same_run(label, got, want):
    """Phase 4e: two Pregel results' carries bit-equal: values, active
    mask, the view's tensors and plan, and every field of the wire log."""
    import importlib
    import torch
    from repro_torch.core import capture
    pm = importlib.import_module("repro_torch.core.pregel")
    (ta, sa), (tb, sb) = (capture.flatten(pm._carry(r.graph))
                          for r in (got, want))
    if sa != sb or not all(torch.equal(x, y) for x, y in zip(ta, tb)):
        raise AssertionError(f"{label}: state, view or wire log differs from "
                             "the uninterrupted run")


def phase_4e_fault_tolerance(g, sg, cc_ids, cc_want, tally):
    """Fault tolerance and out-of-core residency on the main path's graphs
    (phase 4e; see the docstring), each main-path run counted alone into
    `tally`.  Returns the table it logs."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.core import algorithms as alg
    from repro_torch.core import pregel, pregel_fused
    from repro_torch.core import snapshot as snap_mod
    from repro_torch.core import spill as spill_mod
    from repro_torch.core import transport as T
    from repro_torch.core.exchange import LocalExchange
    from repro_torch.core.fault import FaultPlan, FaultyExchange
    from repro_torch.core.graph import Graph
    from repro_torch.data import rmat, symmetrize
    table = {}
    zero = {"m": torch.tensor(0.0)}
    vprog = alg.pagerank_vprog(0.15)
    g_pr = alg.attach_out_degree(g).mapV(alg._pr_init)
    kernels = ("triplet", "apply")

    def pr(gg, **kw):
        return pregel(gg, vprog, alg.pagerank_send, "sum", default_msg=zero,
                      max_supersteps=PR_ITERS, skip_stale=None, **kw)

    def faulty(gg, **plan):
        return gg.replace(ex=FaultyExchange(LocalExchange(p=P),
                                            FaultPlan(**plan)))

    def totals(r):
        return (sum(m["wire_faults"] for m in r.metrics),
                sum(m["degraded_routes"] for m in r.metrics))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # (a) chaos: the integrity ladder over the fault injector
    base, t_base = timed(lambda: main_path_run(
        tally, "pagerank, unchecked", lambda: pr(g_pr), launched=kernels))
    want = base.graph.vdata["pr"]
    chaos = {"unchecked_ms_per_superstep": 1e3 * t_base / base.supersteps}
    for name, tp in (("dense", T.TransportPolicy("dense", integrity=True)),
                     ("ragged", T.TransportPolicy("ragged", integrity=True))):
        row = {}
        for case, plan in (("no fault", None),
                           ("transient", dict(mode="corrupt", attempts=(0,))),
                           ("persistent", dict(mode="corrupt",
                                               attempts=(0, 1)))):
            gg = g_pr if plan is None else faulty(g_pr, **plan)
            r, t = timed(lambda: main_path_run(
                tally, f"pagerank, {name} checked, {case}",
                lambda: pr(gg, transport=tp, track_metrics=True),
                launched=kernels))
            if not torch.equal(r.graph.vdata["pr"], want):
                raise AssertionError(f"chaos {name} {case}: values differ "
                                     "from the unchecked run")
            faults, degraded = totals(r)
            if plan is None and (faults or degraded):
                raise AssertionError(f"chaos {name}: faults without a fault")
            if case == "transient" and not (faults > 0 and degraded == 0):
                raise AssertionError(f"chaos {name} transient: faults "
                                     f"{faults}, degraded {degraded}")
            if case == "persistent" and not degraded > 0:
                raise AssertionError(f"chaos {name} persistent: nothing "
                                     "degraded")
            row[case] = {"wire_faults": faults, "degraded": degraded,
                         "ms_per_superstep": 1e3 * t / r.supersteps,
                         "events": (0 if plan is None
                                    else gg.ex.events)}
        chaos[name] = row
    neg = main_path_run(tally, "pagerank, unchecked, always corrupt",
                        lambda: pr(faulty(g_pr, mode="corrupt",
                                          attempts=None)), launched=kernels)
    if torch.equal(neg.graph.vdata["pr"], want):
        raise AssertionError("negative control: corrupted ships left the "
                             "values unchanged")
    chaos["negative control max |diff|"] = float(
        (neg.graph.vdata["pr"] - want).abs().max())
    del neg
    rag = T.TransportPolicy("ragged", integrity=True)
    f_clean, n_clean = pregel_fused(g_pr, vprog, alg.pagerank_send, "sum",
                                    default_msg=zero,
                                    max_supersteps=PR_ITERS, skip_stale=None,
                                    transport=rag)
    gf = faulty(g_pr, mode="corrupt", attempts=(0,))
    f_hit, n_hit = main_path_run(
        tally, "pagerank_fused, ragged checked, transient",
        lambda: pregel_fused(gf, vprog, alg.pagerank_send, "sum",
                             default_msg=zero, max_supersteps=PR_ITERS,
                             skip_stale=None, transport=rag),
        launched=kernels)
    if not (int(n_hit) == int(n_clean) == base.supersteps
            and torch.equal(f_hit.vdata["pr"], want)
            and torch.equal(f_clean.vdata["pr"], want)) \
            or gf.ex.events == 0:
        raise AssertionError("chaos: pregel_fused under a transient fault "
                             "differs from the unchecked pregel")
    chaos["pregel_fused transient events"] = gf.ex.events
    del f_clean, f_hit

    # one checked ship against an unchecked one: the forward route's shape
    send_idx = g.s.routes["src"][0]
    k = send_idx.shape[2]
    gen = torch.Generator().manual_seed(4)
    tree = {"pr": torch.rand((P, P, k), generator=gen).to(g.device)}
    flags = (send_idx >= 0) & (torch.rand((P, P, k), generator=gen)
                               < 0.5).to(g.device)
    ex = LocalExchange(p=P)
    ship = {}
    for name, tp in (("unchecked", T.DENSE),
                     ("checked", T.TransportPolicy("dense", integrity=True))):
        fn = lambda tp=tp: T.ship_transport(ex, tree, flags, policy=tp)  # noqa: E731
        # 5 calls on the host's clock, and the device's time for a call
        # replayed as one CUDA graph (no host dispatch; the profiler loses
        # this many small kernels' records, PERF.md §7)
        ship[name] = {"ms": cuda_ms(fn), "graph_ms": graph_ms(fn)}
    ship["route"] = f"[{P}, {P}, {k}] f32, half the entries active"
    chaos["ship"] = ship
    del tree, flags

    # the degrade rung removed: the persistent case must fail
    mut = edited_module(
        "repro_torch.core.transport",
        "recv_d = tree_map(lambda x, l: xpose(x).to(l.dtype), tree, recv1)",
        "recv_d = recv1")

    def persistent_check():
        r = pr(faulty(g_pr, mode="corrupt", attempts=(0, 1)),
               transport=T.TransportPolicy("dense", integrity=True))
        if not torch.equal(r.graph.vdata["pr"], want):
            raise AssertionError("persistent fault: values differ")
    chaos["mutant (no degrade rung)"] = must_fail(
        "no degrade rung", persistent_check,
        ("ship_transport", mut.ship_transport))
    table["chaos"] = chaos

    # (b) kill and resume
    shutil.rmtree(SNAP_DIR, ignore_errors=True)
    store = snap_mod.SnapshotStore(str(SNAP_DIR / "pagerank"))

    class Tripped:
        """A preemption guard that trips at its n-th read."""

        def __init__(self, n):
            self.reads, self.n = 0, n

        @property
        def requested(self):
            self.reads += 1
            return self.reads >= self.n

    killed = main_path_run(tally, "pagerank, killed at 5", lambda: pr(
        g_pr, checkpoint=store, checkpoint_every=5, guard=Tripped(5)),
        launched=kernels)
    if killed.supersteps != 5 or store.all_steps() != [5]:
        raise AssertionError(f"kill: ran {killed.supersteps} supersteps, "
                             f"snapshots {store.all_steps()}")
    saved = dict(store.log[-1])
    resumed = main_path_run(tally, "pagerank, resumed at 5", lambda: pr(
        g_pr, checkpoint=store, checkpoint_every=5), launched=kernels)
    if resumed.supersteps != base.supersteps - 5:
        raise AssertionError(f"resume ran {resumed.supersteps} supersteps")
    same_run("kill and resume", resumed, base)
    kill = {"snapshot_bytes": saved["bytes"],
            "copy_s": saved["copy_s"], "write_s": saved["write_s"],
            "read_s": store.last_read_s}
    del killed, resumed
    # CC killed after 2 supersteps, restored elastically onto P=2
    egd = symmetrize(rmat(ELASTIC_SCALE, 16, seed=1))
    eg = Graph.from_edges(egd.src, egd.dst, num_partitions=P,
                          device=g.device)
    estore = snap_mod.SnapshotStore(str(SNAP_DIR / "cc"))
    alg_cc = dict(default_msg={"m": torch.tensor(alg.IMAX,
                                                 dtype=torch.int32)},
                  skip_stale="out")
    pregel(eg.mapV(alg._cc_init), alg.cc_vprog, alg.cc_send, "min",
           max_supersteps=2, checkpoint=estore, checkpoint_every=2, **alg_cc)
    t0 = time.perf_counter()
    e2, start, _pol, _live = snap_mod.restore_pregel_elastic(
        estore, num_partitions=2, device=g.device)
    t_el = time.perf_counter() - t0
    done = main_path_run(tally, "cc, elastic restore onto P=2", lambda:
                         pregel(e2, alg.cc_vprog, alg.cc_send, "min",
                                max_supersteps=100, **alg_cc),
                         launched=kernels)
    ids, vals = done.graph.vertices_to_numpy()
    if e2.s.p != 2 or start != 2 or not np.array_equal(
            vals["cc"], min_id_labels(egd.num_vertices, egd.src, egd.dst,
                                      ids)):
        raise AssertionError("elastic restore: labels differ from scipy's")
    kill["elastic"] = {
        "graph": f"symmetrize(rmat({ELASTIC_SCALE},16)), "
                 f"{egd.num_edges} edges",
        "restore_s": t_el, "supersteps_after": done.supersteps}
    del eg, e2, done
    shutil.rmtree(SNAP_DIR, ignore_errors=True)
    table["kill"] = kill

    # (c) out of core at working_set_frac 0.5
    spill_mod.TIME_COPIES = True
    try:
        ooc = {}
        def cc_run(**kw):
            return pregel(sg.mapV(alg._cc_init), alg.cc_vprog, alg.cc_send,
                          "min", max_supersteps=100, **alg_cc, **kw)

        for name, run, leaves in (
                ("pagerank", lambda **kw: pr(g_pr, **kw), ("pr", "deg")),
                ("cc", cc_run, ("cc",))):
            torch.cuda.reset_peak_memory_stats()
            full = run()
            torch.cuda.synchronize()
            peak_full = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            half, t = timed(lambda: main_path_run(
                tally, f"{name}, working set 0.5",
                lambda: run(working_set_frac=0.5, track_metrics=True),
                launched=kernels))
            peak_half = torch.cuda.max_memory_allocated()
            if half.supersteps != full.supersteps or not all(
                    torch.equal(half.graph.vdata[x], full.graph.vdata[x])
                    for x in leaves):
                raise AssertionError(f"out of core {name}: differs from the "
                                     "resident run")
            if name == "cc":
                got = half.graph.vertices_to_numpy()[1]["cc"]
                if not np.array_equal(got, cc_want):
                    raise AssertionError("out of core cc: labels differ from "
                                         "scipy's")
            gg = g_pr if name == "pagerank" else sg
            plan = spill_mod.plan_spill(gg, 0.5)
            full_b = spill_mod.vdata_nbytes(half.graph.vdata)
            # tests/spmd_check.py's cap: the hottest ceil(f * total) cells
            # plus one cell of slack for a clipped tail cell.  A row whose
            # slots end in a clipped cell may spill it, so with nl clipped
            # cells cold the slack is nl cells (the reference's bytes are
            # the same: tests/test_torch_spill.py pins them)
            stubs = plan.nl if plan.v_blk % plan.block else 1
            cap1 = full_b * (plan.n_total - plan.n_cold + 1) / plan.n_total
            cap = full_b * (plan.n_total - plan.n_cold + stubs) / plan.n_total
            resid = [m["spill_resident_bytes"] for m in half.metrics]
            if not (resid and max(resid) <= cap and min(resid) < full_b):
                raise AssertionError(f"out of core {name}: resident bytes "
                                     f"{max(resid)} over the cap {cap}")
            rot = [{"d2h_ms": m["spill_copy_ms"],
                    "h2d_ms": m["restore_copy_ms"],
                    "stream_bytes": m["stream_bytes"],
                    "serial_model_ms": 1e3 * m["stream_time_serial"],
                    "overlap_model_ms": 1e3 * m["stream_time_overlap"]}
                   for m in half.metrics]
            ooc[name] = {
                "supersteps": half.supersteps,
                "ms_per_superstep": 1e3 * t / half.supersteps,
                "cells": f"{plan.n_cold} of {plan.n_total} cold, "
                         f"{plan.block} rows",
                "resident_bytes_max": max(resid), "cap": cap,
                "spmd_check_cap": cap1,
                "rotations_over_spmd_check_cap": sum(r > cap1 for r in resid),
                "vdata_bytes": full_b,
                "peak_gib_resident": peak_full / 2**30,
                "peak_gib_half": peak_half / 2**30,
                "rotations": rot}
            del full, half
    finally:
        spill_mod.TIME_COPIES = False
    table["out_of_core"] = ooc
    return table


def phase_4b_graphs(g, gd, sg, sgd, w_cc, tally):
    """SSSP, label propagation and subgraph + CC on CC's graph, coarsen on
    symmetrize(rmat(COARSEN_SCALE, 16)), and the transpose of PageRank's
    graph (phase 4b; see the docstring).
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

    # --- coarsen (Listing 7): domains vid // 16, pages summed, on
    # symmetrize(rmat(COARSEN_SCALE, 16)), CC's edge factor at a scale its
    # host stage keeps short (at CC's own scale it took 69-105 s)
    from repro_torch.core.graph import Graph
    from repro_torch.data import rmat, symmetrize
    cgd = symmetrize(rmat(COARSEN_SCALE, 16, seed=1))
    cg = Graph.from_edges(cgd.src, cgd.dst, num_partitions=P,
                          device=sg.device)
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


def bwd_mutant_source(dh: int, source=None) -> str:
    """csrc/flash_attention_bwd.cu (from `source`, the backward's source
    function; `flash_attention.bwd_source` when None) with one head of each
    group dropped from the dK/dV sums (phase 9's mutant)."""
    from repro_torch.kernels import flash_attention as flash_mod
    src = (source or flash_mod.bwd_source)(dh)
    if src.count(BWD_HEADS[0]) != 1:
        raise AssertionError("the dK/dV head loop line is not in the source")
    return src.replace(*BWD_HEADS)


def rel_norm(a, b) -> float:
    return float((a.float() - b.float()).norm()
                 / b.float().norm().clamp_min(1e-30))


def plain_without_keys(q, k, v, lo: int, hi: int, *, causal: bool,
                       kv_offset: int = 0):
    """The plain attention (`ref.flash_attention`'s f32 softmax) with keys
    [lo, hi) masked as well: the mutant of phase 9's forward check.  Rows
    that see no key give 0.  Output in q's dtype."""
    import torch
    b, hq, lq, dh = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    g = hq // hkv
    keys = torch.arange(lk, device=q.device)
    mask = ((keys < lo) | (keys >= hi))[None, :].expand(lq, lk)
    if causal:
        mask = mask & (torch.arange(lq, device=q.device)[:, None] + kv_offset
                       >= keys[None, :])
    s = torch.einsum("bhgqd,bhkd->bhgqk",
                     q.float().reshape(b, hkv, g, lq, dh) * dh ** -0.5,
                     k.float())
    s = torch.where(mask, s, -1e30)
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return (out / torch.where(l == 0.0, 1.0, l)).reshape(q.shape).to(q.dtype)


def flash_forward_check(name, q, k, v, out, kw) -> dict:
    """The forward's output `out` per element against the plain version
    within `flash_limit`; the plain version without any one of the plan's
    key splits, or without one key tile halfway along the visible keys,
    must break that limit (phase 9 (a))."""
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ref
    p = flash_mod.plan(q.shape, k.shape, q.dtype, **kw)
    want = ref.flash_attention(q, k, v, **kw)
    lim = flash_limit(want)
    diff = (out.float() - want.float()).abs()
    if bool((diff > lim).any()):
        raise AssertionError(f"flash[{name}]: {int((diff > lim).sum())} "
                             f"outputs beyond their limit (max |err| "
                             f"{float(diff.max())})")
    mid = p.kv_end // 2 // p.block_k * p.block_k
    drops = [*p.splits, (mid, min(mid + p.block_k, p.kv_end))]
    for lo, hi in drops:
        mut = plain_without_keys(q, k, v, lo, hi, **kw)
        if not bool(((mut.float() - want.float()).abs() > lim).any()):
            raise AssertionError(f"flash[{name}]: the plain version without "
                                 f"keys {lo}:{hi} passes the limit")
        del mut
    return {"body": p.body, "max_abs_err": float(diff.max()),
            "splits": len(p.splits), "drops": drops}


def flash_body_launcher(body, q, k, v, kw):
    """A call of the flash forward through plan body `body` (its
    `_layout`), which the shape must allow: the before/after of a
    redesigned body at the same inputs."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as flash_mod
    strides = (q.stride(), k.stride(), v.stride())
    p = flash_mod._layout(body, q.shape, k.shape, q.dtype, strides=strides,
                          **kw)
    lib = build.load("flash_attention", flash_mod.source(q.shape[3]),
                     flash_mod._ARGTYPES)
    call = flash_mod._make_call(
        p, (q.shape, k.shape, v.shape), strides, q.dtype,
        tuple(t.data_ptr() % 16 == 0 for t in (q, k, v)), scale=None,
        launch=lib.launch, **kw)
    return lambda: flash_mod._run(q, k, v, call, False)[0]


def lse_check(name, q, k, lse, kw) -> float:
    """The forward's log-sum-exp per row against `ref.flash_lse`: within
    FLASH_LSE_REL |plain| + FLASH_LSE_ABS, +inf exactly on the rows that
    see no key; returns the max |err| over the live rows."""
    import torch
    from repro_torch.kernels import ref
    want = ref.flash_lse(q, k, **kw)
    dead = torch.isinf(want)
    if not torch.equal(torch.isinf(lse), dead) or bool((lse[dead] < 0).any()):
        raise AssertionError(f"flash lse[{name}]: +inf rows differ")
    diff = (lse[~dead] - want[~dead]).abs()
    if bool((diff > FLASH_LSE_REL * want[~dead].abs() + FLASH_LSE_ABS).any()):
        raise AssertionError(f"flash lse[{name}]: max |err| "
                             f"{float(diff.max())}")
    return float(diff.max()) if diff.numel() else 0.0


def phase_9a_flash_backward(gen, dev, results) -> None:
    """The flash backward kernel at its four shapes, and the forward there
    (see the docstring)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ref
    bwd = flash_mod.flash_attention_bwd
    for name, b, hq, hkv, lq, lk, dh, causal, off in FLASH_BWD_SHAPES:
        def rnd(*shape):
            return torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
        if "strided" in name:
            # as _windowed_attention's chunk-0 call: rows 0, nc, ... of the
            # chunked queries and the current halves of the key pairs
            nc = 2
            q = rnd(b * nc, hq, lq, dh)[::nc]
            k, v = (rnd(b * nc, hkv, 2 * lk, dh)[::nc, :, lk:]
                    for _ in range(2))
        else:
            q, k, v = rnd(b, hq, lq, dh), rnd(b, hkv, lk, dh), \
                rnd(b, hkv, lk, dh)
        kw = dict(causal=causal, kv_offset=off)
        body_runs = dict(flash_mod.flash_attention.bodies)
        out, lse = flash_mod.flash_attention_lse(q, k, v, **kw)
        if not torch.equal(out, flash_mod.flash_attention(q, k, v, **kw)):
            raise AssertionError(f"flash[{name}]: the output with the lse "
                                 "differs from the one without")
        fwd = flash_forward_check(name, q, k, v, out, kw)
        ran = flash_mod.flash_attention.bodies[fwd["body"]] \
            - body_runs.get(fwd["body"], 0)
        if ran != 2 or (dh > flash_mod.TC_MAX_DH
                        and fwd["body"] != "tensor_core_wide"):
            raise AssertionError(f"flash[{name}]: body {fwd['body']} ran "
                                 f"{ran} times")
        lse_err = lse_check(name, q, k, lse, kw)
        dout = rnd(b, hq, lq, dh)
        ins = (q, k, v, out, dout)
        p = flash_mod.bwd_plan(q.shape, k.shape, **kw,
                               strides=tuple(t.stride() for t in ins))
        lay = flash_mod.bwd_layout(dh)
        if (lay["smem_dq"], lay["smem_dkv"], lay["rows"], lay["split"]) != (
                p.smem_dq, p.smem_dkv, p.rows, int(p.split)):
            raise AssertionError(f"flash_bwd[{name}]: the build lays out "
                                 f"{lay}, bwd_plan {p}")
        copies = bwd.copies
        got = bwd(*ins, lse=lse, **kw)
        again = bwd(*ins, lse=lse, **kw)
        want = ref.flash_attention_backward(*ins, **kw)
        torch.cuda.synchronize()
        if bwd.copies != copies or any(p.copy):
            raise AssertionError(f"flash_bwd[{name}]: {bwd.copies - copies} "
                                 "inputs copied")
        if not all(map(torch.equal, got, again)):
            raise AssertionError(f"flash_bwd[{name}]: two runs differ")
        rels = {n: rel_norm(g, w) for n, g, w in zip(("dq", "dk", "dv"), got,
                                                      want)}
        if not all(bool(torch.isfinite(g.float()).all()) for g in got) or \
                max(rels.values()) > FLASH_GRAD_REL_LIMIT:
            raise AssertionError(f"flash_bwd[{name}]: relative errors {rels}"
                                 f" (limit {FLASH_GRAD_REL_LIMIT})")
        err = max(float((g.float() - w.float()).abs().max())
                  for g, w in zip(got, want))
        mutant = None
        if hq != hkv:
            # one head of each group dropped from dK/dV: must break the limit
            orig = flash_mod.bwd_source
            flash_mod.bwd_source = functools.partial(bwd_mutant_source,
                                                     source=orig)
            try:
                mg = bwd(*ins, lse=lse, **kw)
            finally:
                flash_mod.bwd_source = orig
            mutant = {n: rel_norm(g, w) for n, g, w in
                      zip(("dq", "dk", "dv"), mg, want)}
            if max(mutant["dk"], mutant["dv"]) <= FLASH_GRAD_REL_LIMIT:
                raise AssertionError(f"flash_bwd[{name}]: the dropped-head "
                                     f"mutant passes ({mutant})")
            del mg
        del want
        pairs = visible_pairs(lq, lk, causal, off)
        # the library: SDPA on prepared inputs, its forward and its
        # backward alone
        lq_, lk_, lv_ = (t.detach().requires_grad_() for t in (q, k, v))
        if causal and off == 0 and lq == lk:
            lib_kw = dict(is_causal=True)
        elif causal:
            lib_kw = dict(attn_mask=torch.arange(lq, device=dev)[:, None] + off
                          >= torch.arange(lk, device=dev)[None, :])
        else:
            lib_kw = {}

        def lib_fwd():
            with torch.no_grad():
                return F.scaled_dot_product_attention(q, k, v, **lib_kw,
                                                      enable_gqa=True)

        # the forward kernel at the same shape, the CUDA-core body (the
        # one before the wide body) where the shape allows it, and SDPA's
        kern_fwd = lambda: flash_mod.flash_attention(q, k, v, **kw)  # noqa: E731
        fwd_ms, fwd_med = cuda_ms(kern_fwd), median_ms(kern_fwd)
        fwd_dms, fwd_dms_by = device_ms(kern_fwd)
        core = core_ms = core_dms = None
        if fwd["body"] == "tensor_core_wide":
            core = flash_body_launcher("cuda_core", q, k, v, kw)
            core_err = float((core().float() - out.float()).abs().max())
            core_ms = cuda_ms(core, 2)
            core_dms, _ = device_ms(core, 5)
        fwd_lib_ms, fwd_lib_med = cuda_ms(lib_fwd), median_ms(lib_fwd)
        fwd_lib_dms, fwd_lib_dms_by = device_ms(lib_fwd)
        fwd_plain_ms = cuda_ms(lambda: ref.flash_attention(q, k, v, **kw), 3)
        fwd_flops = 4 * b * hq * dh * pairs
        fwd_bytes = 2 * (2 * b * hq * lq * dh + 2 * b * hkv * lk * dh)
        fb_ms, fb_by = bound(fwd_bytes, fwd_flops, BF16_FLOPS)
        kern = lambda: bwd(*ins, lse=lse, **kw)  # noqa: E731
        ms, med = cuda_ms(kern), median_ms(kern)
        dms, dms_by = device_ms(kern)
        plain_ms = cuda_ms(lambda: ref.flash_attention_backward(*ins, **kw),
                           3)
        lib_out = F.scaled_dot_product_attention(lq_, lk_, lv_, **lib_kw,
                                                 enable_gqa=True)
        lib = lambda: torch.autograd.grad(  # noqa: E731
            lib_out, (lq_, lk_, lv_), dout, retain_graph=True)
        lib_ms, lib_med = cuda_ms(lib), median_ms(lib)
        lib_dms, lib_dms_by = device_ms(lib)
        flops = 10 * b * hq * dh * pairs
        nbytes = 2 * (4 * b * hq * lq * dh + 4 * b * hkv * lk * dh)
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
        mask = "causal" if causal else "non-causal"
        shape = (f"{name}: q [{b}, {hq}, {lq}, {dh}], k/v [{b}, {hkv}, {lk}, "
                 f"{dh}], {mask}, kv_offset {off} (bf16; bound peak "
                 f"{BF16_FLOPS / 1e12:.0f} TFLOP/s bf16, "
                 f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
        row = {"variant": shape, "max_abs_err": err,
               "tol": f"relative norm per gradient <= {FLASH_GRAD_REL_LIMIT}",
               "grad_rel_err": rels, "mutant_rel_err": mutant,
               "ms": ms, "median_ms": med, "device_ms": dms,
               "device_ms_by": dms_by, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
               "library_median_ms": lib_med, "library_device_ms": lib_dms,
               "library_device_ms_by": lib_dms_by,
               "grid_dq": p.grid_dq, "grid_dkv": p.grid_dkv,
               "smem": [p.smem_dq, p.smem_dkv], "split": p.split,
               "copies": 0, "forward_body": fwd["body"], "forward_ms": fwd_ms,
               "forward_device_ms": fwd_dms,
               "forward_max_abs_err": fwd["max_abs_err"],
               "forward_tol": "per output 2^-7*|plain| + 1e-6 (one bf16 "
                              "spacing)",
               "lse_max_abs_err": lse_err,
               "gflop": flops / 1e9, "mbytes": nbytes / 1e6}
        log(f"  flash_bwd[{name}]: plan dQ grid {p.grid_dq}, dK/dV grid "
            f"{p.grid_dkv} ({'column halves' if p.split else '2 x 64 rows'}"
            f" a CTA), smem {p.smem_dq} / {p.smem_dkv} B (== the build's), "
            f"0 inputs copied; relative error " + ", ".join(
                f"{n} {e:.3g}" for n, e in rels.items())
            + f" (limit {FLASH_GRAD_REL_LIMIT}), two runs bit-equal"
            + ("" if mutant is None else "; dropped-head mutant "
               + ", ".join(f"{n} {e:.3g}" for n, e in mutant.items())
               + " (fails)"))
        log(f"    backward {ms:.4f} ms (median of 5 x 20 calls {med:.4f}, "
            f"device {ms_str(dms)} ({dms_by})), plain {plain_ms:.4f} ms, "
            f"sdpa backward {lib_ms:.4f} ms (median {lib_med:.4f}, device "
            f"{ms_str(lib_dms)} ({lib_dms_by}); it reads the log-sum-exp its "
            f"forward saved, as this kernel does, and its forward is not "
            f"timed{'; boolean mask' if 'attn_mask' in lib_kw else ''}); "
            f"{flops / 1e9:.1f} GFLOP (5 products over {pairs} visible "
            f"pairs a head), {nbytes / 1e6:.0f} MB -> bound {b_ms:.4f} ms "
            f"({b_by}), {100 * b_ms / ms:.1f}% of it")
        log(f"    forward ({fwd['body']} body, {fwd['splits']} key split(s)) "
            f"{fwd_ms:.4f} ms (median {fwd_med:.4f}, device {ms_str(fwd_dms)} "
            f"({fwd_dms_by}))"
            + ("" if core is None else
               f"; the CUDA-core body at the same inputs {core_ms:.4f} ms "
               f"(device {ms_str(core_dms)}; max |diff| to the wide body's "
               f"output {core_err:.3g})")
            + f"; sdpa forward {fwd_lib_ms:.4f} ms (median {fwd_lib_med:.4f},"
            f" device {ms_str(fwd_lib_dms)} ({fwd_lib_dms_by})); plain "
            f"{fwd_plain_ms:.4f} ms; {fwd_flops / 1e9:.1f} GFLOP -> bound "
            f"{fb_ms:.4f} ms ({fb_by}), {100 * fb_ms / fwd_ms:.1f}% of it")
        log(f"    forward vs plain per output: max |err| "
            f"{fwd['max_abs_err']:.3g} (limit one bf16 spacing); the plain "
            f"version without keys "
            + ", ".join(f"{a}:{b_}" for a, b_ in fwd["drops"])
            + f" breaks it (each); lse vs plain per row max |err| "
            f"{lse_err:.3g} (limit {FLASH_LSE_REL} |lse| + {FLASH_LSE_ABS}, "
            f"+inf rows equal)")
        results.setdefault("flash_attention_bwd", []).append(row)
        if fwd["body"] == "tensor_core_wide":
            results.setdefault("flash_attention_wide", []).append({
                "variant": shape, "max_abs_err": fwd["max_abs_err"],
                "tol": "per output 2^-7*|plain| + 1e-6 (one bf16 spacing)",
                "lse_max_abs_err": lse_err, "ms": fwd_ms,
                "median_ms": fwd_med, "device_ms": fwd_dms,
                "device_ms_by": fwd_dms_by, "plain_ms": fwd_plain_ms,
                "bound_ms": fb_ms, "bound_by": fb_by,
                "library_ms": fwd_lib_ms, "library_median_ms": fwd_lib_med,
                "library_device_ms": fwd_lib_dms,
                "cuda_core_ms": core_ms, "cuda_core_device_ms": core_dms,
                "gflop": fwd_flops / 1e9})
        del q, k, v, out, lse, dout, ins, got, again, lq_, lk_, lv_, lib_out
        del core
        torch.cuda.empty_cache()


def serve_step_in_place(cfg, last_step, n_cross: int):
    """The last decode step again (`last_step("auto")`) with every flash
    call held in place (phases 6 and 10): per output within one bf16
    spacing of the plain version on the same inputs, which the plain
    version with any one of the flash plan's key splits of the step's
    cross-attention dropped must break.  Returns (each call's max |err|,
    the splits)."""
    import torch
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ops
    tiles = flash_mod.plan(
        (SERVE_BATCH, cfg.n_heads, 1, cfg.head_dim),
        (SERVE_BATCH, cfg.n_kv_heads, cfg.n_context_tokens, cfg.head_dim),
        torch.bfloat16, causal=False).splits
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
    return in_place, tiles


def train_flash_in_place(kernel_attention, in_place: list):
    """`ops.flash_attention` with every call of a training step held in
    place (phases 9 (b) and 10 (c)): its forward per output against the
    plain version on the same inputs (the recompute's calls too, as phase
    6), and, for a call that is differentiated, its gradients against the
    plain backward on the same inputs and cotangent; one record a call
    appended to `in_place` ({"fwd": max |err|, "rel": the backward's
    relative error})."""
    import torch
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ref

    def held_in_place(q, k, v, *, causal=True, scale=None, kv_offset=0,
                      mode="auto"):
        out = kernel_attention(q, k, v, causal=causal, scale=scale,
                               kv_offset=kv_offset, mode=mode)
        kw = dict(causal=causal, scale=scale, kv_offset=kv_offset)
        # the forward, per output against the plain version on the same
        # inputs (the recompute's calls too), as phase 6
        with torch.no_grad():
            want = kernel_attention(q, k, v, **kw, mode="ref")
            diff = (out.float() - want.float()).abs()
            if bool((diff > flash_limit(want)).any()):
                raise AssertionError(f"flash forward in place, call "
                                     f"{len(in_place)}: max |err| "
                                     f"{float(diff.max())}")
        rec = {"fwd": float(diff.max())}
        in_place.append(rec)
        del want, diff
        if not out.requires_grad:
            return out
        ins = [t.detach() for t in (q, k, v, out)]

        def check(dout):
            _, lse = flash_mod.flash_attention_lse(*ins[:3], **kw)
            kg = flash_mod.flash_attention_bwd(*ins, dout, lse=lse, **kw)
            pg = ref.flash_attention_backward(*ins, dout, **kw)
            rec["rel"] = max(rel_norm(a, b) for a, b in zip(kg, pg))
            if rec["rel"] > FLASH_GRAD_REL_LIMIT:
                raise AssertionError(f"flash backward in place, call "
                                     f"{len(in_place) - 1}: relative error "
                                     f"{rec['rel']}")

        out.register_hook(check)
        return out

    return held_in_place


def phase_9b_train(dev, launches) -> None:
    """recurrentgemma-2b's training through the launch entry point, step 1
    again held in place, and decode (see the docstring)."""
    import numpy as np
    import torch
    from repro_torch import configs as C
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.tokens import SyntheticLM
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_launch
    from repro_torch.models import transformer as T
    from repro_torch.train import train_loop as tl
    cfg = C.get(RG_ARCH)
    n_local = sum(cfg.layer_pattern[i % len(cfg.layer_pattern)]
                  == "local_attn" for i in range(cfg.n_layers))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    bodies = dict(flash_mod.flash_attention.bodies)
    tr = train_launch.main(["--arch", RG_ARCH, "--steps", str(RG_STEPS),
                            "--batch", str(RG_BATCH), "--seq", str(RG_SEQ)])
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    ran = {k: n - bodies.get(k, 0)
           for k, n in flash_mod.flash_attention.bodies.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    # a step: 2 calls a local-attention layer (the windowed call and
    # chunk 0's), run again in the backward's recompute; one backward each
    want = {"flash_attention": 4 * n_local * RG_STEPS,
            "flash_attention_bwd": 2 * n_local * RG_STEPS}
    for kname, n in want.items():
        if counts[kname] != n:
            raise AssertionError(f"{kname} launches {counts[kname]}, "
                                 f"expected {n}")
    # every forward call at Dh 256 (Rg = 10 x 2048) runs the wide body
    if ran.get("tensor_core_wide", 0) != want["flash_attention"] or \
            sum(ran.values()) != want["flash_attention"]:
        raise AssertionError(f"flash forward bodies {ran}")
    launches["flash_attention_wide"] = ran["tensor_core_wide"]
    launches["flash_attention"] += counts["flash_attention"]
    launches["flash_attention_bwd"] = counts["flash_attention_bwd"]
    losses = tr["losses"]
    if len(losses) != RG_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"training losses {losses}")
    n_params = T.param_count(tr["params"])
    steps_s = tr["step_seconds"]
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  {cfg.name}: {n_params / 1e9:.3f} B params, {cfg.n_layers} layers "
        f"({n_local} local attention, window {cfg.window}); batch {RG_BATCH}"
        f" x seq {RG_SEQ}; losses {[round(x, 4) for x in losses]}; step "
        f"seconds {[round(x, 3) for x in steps_s]} (synchronised), "
        f"{RG_BATCH * RG_SEQ / steps_s[-1]:.0f} tokens/s at the last step; "
        f"peak device memory {peak:.2f} GiB; flash launches "
        f"{counts['flash_attention']} forward, "
        f"{counts['flash_attention_bwd']} backward "
        f"({want['flash_attention'] // RG_STEPS} + "
        f"{want['flash_attention_bwd'] // RG_STEPS} a step)")

    # step 1 again from the same weights and batch, every flash call's
    # backward held in place against the plain backward on its inputs and
    # cotangent (the calls of the recompute are not differentiated: their
    # graph only refills what the first forward let go)
    params = tl.init_params(cfg, 0, dev)
    batch = {k: torch.from_numpy(a).to(dev) for k, a in SyntheticLM(
        cfg.vocab, RG_SEQ, RG_BATCH, seed=0).batch(0).items()}
    in_place = []
    kernel_attention = ops.flash_attention
    ops.flash_attention = train_flash_in_place(kernel_attention, in_place)
    try:
        loss = T.loss_fn(params, batch, cfg, mode="auto")
        loss.backward()
    finally:
        ops.flash_attention = kernel_attention
    loss_k = float(loss.detach())
    del loss
    checked = [r["rel"] for r in in_place if "rel" in r]
    if len(in_place) != 4 * n_local or len(checked) != 2 * n_local:
        raise AssertionError(f"{len(in_place)} flash calls, {len(checked)} "
                             "backward calls held in place")
    for t in tree_leaves(params):
        t.grad = None
    with torch.no_grad():
        loss_r = float(T.loss_fn(params, batch, cfg, mode="ref"))
    if not abs(loss_k - loss_r) <= RG_TRAIN_LOSS_LIMIT * abs(loss_r):
        raise AssertionError(f"step 1 loss, kernels {loss_k} vs plain "
                             f"{loss_r}")
    log(f"  step 1, kernels vs plain: loss {loss_k:.6f} vs {loss_r:.6f} "
        f"(relative {abs(loss_k - loss_r) / abs(loss_r):.3g}, limit "
        f"{RG_TRAIN_LOSS_LIMIT}; the training run's step 1 read "
        f"{losses[0]:.6f}); in place, all {len(in_place)} flash forward "
        f"calls: max |err| {max(r['fwd'] for r in in_place):.3g} (limit one "
        f"bf16 spacing per output); all {len(checked)} flash backward "
        f"calls: relative error max {max(checked):.3g} (limit "
        f"{FLASH_GRAD_REL_LIMIT})")

    # decode from those weights: RG-LRU states and ring caches on the card
    with torch.no_grad():
        toks = batch["tokens"][:, :RG_DECODE]
        state = T.init_decode_state(cfg, RG_BATCH, RG_SEQ, device=dev)
        logits = []
        t0 = time.perf_counter()
        for pos in range(RG_DECODE):
            lg, state = T.decode_step(params, state, toks[:, pos:pos + 1],
                                      pos, cfg)
            logits.append(lg)
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        dec = torch.cat(logits, 1)
        full = T.forward(params, {"tokens": toks}, cfg)
    on_card = all(t.is_cuda for st in state.values() for slot in st.values()
                  for t in slot.values())
    if dec.shape != (RG_BATCH, RG_DECODE, cfg.vocab) or not on_card or \
            not bool(torch.isfinite(dec).all()):
        raise AssertionError(f"decode logits {tuple(dec.shape)}, state on "
                             f"the card {on_card}")
    d = (dec - full).abs()
    log(f"  decode {RG_DECODE} steps from those weights: {t_dec:.3f} s "
        f"({t_dec / RG_DECODE * 1e3:.1f} ms a step), logits finite, states "
        f"and ring caches (length {cfg.window}) on the card; vs the "
        f"forward on the same {RG_DECODE} tokens max |diff| "
        f"{float(d.max()):.4g}, mean {float(d.mean()):.4g}")
    del params, batch, state, dec, full


def p10_config(arch: str, layers):
    """arch's config at full width, cut to `layers` layers (None: whole)."""
    import dataclasses
    from repro_torch import configs as C
    cfg = C.get(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def p10_depth(cfg, layers, why) -> str:
    from repro_torch import configs as C
    full = C.get(cfg.name).n_layers
    cut = f"{cfg.n_layers} of {full} layers" if layers else \
        f"all {cfg.n_layers} layers"
    enc = f" + {cfg.enc_layers} encoder layers" if cfg.is_encdec else ""
    return f"{cut}{enc} ({why})"


def phase_10_serve(dev, arch, layers, why, launches) -> dict:
    """Serve one MoE or encoder-decoder config through `launch.serve`'s
    functions (see the docstring): flash launches counted alone, the last
    step's flash calls held in place, finite logits, each MoE layer's drop
    count and capacity, peak memory, the MoE block's time."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    cfg = p10_config(arch, layers)
    log(f"  {cfg.name}: {p10_depth(cfg, layers, why)}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    moe_calls = []                  # (dropped, capacity) of each MoE call
    moe_block = M.moe_block

    def counted_moe(*a, **kw):
        out, st = moe_block(*a, **kw)
        moe_calls.append((st["dropped"], st["capacity"]))
        return out, st

    M.moe_block = counted_moe
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        run = serve.run_config(cfg, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                               gen=SERVE_GEN, device=str(dev))
        torch.cuda.synchronize()
    finally:
        M.moe_block = moe_block
    t_serve = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = SERVE_PROMPT + SERVE_GEN - 1
    n_cross = sum(T._layer_has_cross(cfg, i) for i in range(cfg.n_layers))
    want = {k: 0 for k in counts}
    want["flash_attention"] = n_cross * steps
    if counts != want:
        raise AssertionError(f"serve {cfg.name}: launches {counts}, "
                             f"expected {want}")
    launches["flash_attention"] += counts["flash_attention"]
    gen_toks = run.generated
    if gen_toks.shape != (SERVE_BATCH, SERVE_GEN) or gen_toks.min() < 0 \
            or gen_toks.max() >= cfg.vocab or \
            not bool(torch.isfinite(run.last_logits).all()):
        raise AssertionError(f"serve {cfg.name}: tokens {gen_toks.shape}, "
                             "or logits not finite")
    if peak >= P10_PEAK_LIMIT:
        raise AssertionError(f"serve {cfg.name}: peak {peak / 1e9:.1f} GB")
    out = {"arch": cfg.name, "layers": cfg.n_layers,
           "params_b": T.param_count(run.params) / 1e9,
           "prefill_ms_per_step": run.prefill_s / SERVE_PROMPT * 1e3,
           "decode_ms_per_step": run.decode_s / (SERVE_GEN - 1) * 1e3,
           "tokens_per_s": run.tokens_per_s, "whole_run_s": t_serve,
           "peak_gib": peak / 2**30, "flash_launches": counts[
               "flash_attention"]}
    if moe_calls:
        # per layer, over every step of the run
        if len(moe_calls) != steps * cfg.n_layers:
            raise AssertionError(f"{len(moe_calls)} MoE calls")
        dropped = torch.stack([d for d, _ in moe_calls]).view(
            steps, cfg.n_layers).sum(0).tolist()
        caps = sorted({c for _, c in moe_calls})
        out["moe_dropped_per_layer"] = dropped
        out["moe_capacity"] = caps
    del moe_calls

    def last_step(mode):
        return T.decode_step(run.params, run.last_state, run.last_tokens,
                             run.last_pos, cfg, cross_ctx=run.ctx,
                             mode=mode)[0]

    if n_cross:
        in_place, tiles = serve_step_in_place(cfg, last_step, n_cross)
        out["flash_in_place_max_err"] = max(in_place)
        out["flash_key_splits_dropped"] = len(tiles)
    else:
        # no kernel on this path (the decode step's self-attention is plain
        # torch, as in the reference): the plain path gives its logits
        if not torch.equal(last_step("ref"), run.last_logits):
            raise AssertionError(f"serve {cfg.name}: last step auto != ref")
    if cfg.family == "moe":
        # layer 0's MoE block at the decode step's shape, and the f32 ->
        # bf16 casts of its expert weights alone
        p0 = T._index(run.params["blocks"]["slot0"], 0)["moe"]
        h = torch.randn((SERVE_BATCH, 1, cfg.d_model), device=dev,
                        generator=torch.Generator(dev).manual_seed(0))
        with torch.no_grad():
            block = lambda: M.moe_block(p0, h, cfg)  # noqa: E731
            casts = lambda: [p0[n].to(torch.bfloat16)  # noqa: E731
                             for n in ("wi", "wg", "wo")]
            out["moe_block_ms"] = cuda_ms(block)
            out["moe_block_device_ms"], how = device_ms(block)
            out["moe_casts_ms"] = cuda_ms(casts)
        n_exp = sum(p0[n].numel() for n in ("wi", "wg", "wo"))
        out["moe_bound_ms"] = n_exp * 4 / HBM_BYTES_PER_S * 1e3
        out["moe_device_ms_by"] = how
    del run
    gc.collect()
    torch.cuda.empty_cache()
    log(f"    {json.dumps(out)}")
    return out


def phase_10_train(dev, arch, layers, why, launches) -> dict:
    """Train one config three AdamW steps through `launch.train.run`, then
    step 1 again twice from the same weights and batch (the second time
    with every flash call held in place): bit-equal gradients, and the
    loss through the plain versions (see the docstring)."""
    import numpy as np
    import torch
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_launch
    from repro_torch.models import transformer as T
    from repro_torch.train import train_loop as tl
    cfg = p10_config(arch, layers)
    log(f"  {cfg.name}: {p10_depth(cfg, layers, why)}; batch {P10_BATCH} "
        f"x seq {P10_SEQ}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    tr = train_launch.run(cfg, steps=P10_STEPS, batch=P10_BATCH,
                          seq=P10_SEQ, device=dev)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    # a step: each decoder attention call twice (the per-super-layer
    # recompute), each encoder call once (no recompute); one backward each
    n_cross = sum(T._layer_has_cross(cfg, i) for i in range(cfg.n_layers))
    n_dec = cfg.n_layers + n_cross
    want = {k: 0 for k in counts}
    want["flash_attention"] = (2 * n_dec + cfg.enc_layers) * P10_STEPS
    want["flash_attention_bwd"] = (n_dec + cfg.enc_layers) * P10_STEPS
    if counts != want:
        raise AssertionError(f"train {cfg.name}: launches {counts}, "
                             f"expected {want}")
    for k in ("flash_attention", "flash_attention_bwd"):
        launches[k] += counts[k]
    losses = tr["losses"]
    if len(losses) != P10_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"train {cfg.name}: losses {losses}")
    if peak >= P10_PEAK_LIMIT:
        raise AssertionError(f"train {cfg.name}: peak {peak / 1e9:.1f} GB")
    out = {"arch": cfg.name, "layers": cfg.n_layers,
           "params_b": T.param_count(tr["params"]) / 1e9, "losses": losses,
           "step_s": tr["step_seconds"],
           "tokens_per_s": P10_BATCH * P10_SEQ / tr["step_seconds"][-1],
           "peak_gib": peak / 2**30,
           "flash_launches_per_step": [want["flash_attention"] // P10_STEPS,
                                       want["flash_attention_bwd"]
                                       // P10_STEPS]}
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    # step 1 again, twice, from the same weights and batch
    params = tl.init_params(cfg, 0, dev)
    batch = {k: torch.from_numpy(a).to(dev) for k, a in
             train_launch.data_for(cfg, P10_SEQ, P10_BATCH).batch(0).items()}
    leaves = tree_leaves(params)

    def step1():
        for t in leaves:
            t.grad = None
        loss = T.loss_fn(params, batch, cfg)
        loss.backward()
        return float(loss.detach())

    loss_a = step1()
    grads_a = [t.grad for t in leaves]
    in_place = []
    kernel_attention = ops.flash_attention
    ops.flash_attention = train_flash_in_place(kernel_attention, in_place)
    try:
        loss_b = step1()
    finally:
        ops.flash_attention = kernel_attention
    same = loss_a == loss_b and all(torch.equal(t.grad, g)
                                    for t, g in zip(leaves, grads_a))
    if not same:
        raise AssertionError(f"train {cfg.name}: two runs of step 1 differ")
    checked = [r["rel"] for r in in_place if "rel" in r]
    if len(in_place) != want["flash_attention"] // P10_STEPS or \
            len(checked) != want["flash_attention_bwd"] // P10_STEPS:
        raise AssertionError(f"{len(in_place)} flash calls, {len(checked)} "
                             "backward calls held in place")
    del grads_a
    for t in leaves:
        t.grad = None
    with torch.no_grad():
        loss_r = float(T.loss_fn(params, batch, cfg, mode="ref"))
    limit = P10_LOSS_LIMIT[arch]
    rel = abs(loss_a - loss_r) / abs(loss_r)
    if not rel <= limit:
        raise AssertionError(f"train {cfg.name}: step 1 loss, kernels "
                             f"{loss_a} vs plain {loss_r}")
    out.update({"step1_loss": loss_a, "step1_plain_loss": loss_r,
                "step1_rel": rel, "step1_limit": limit,
                "grads_bit_equal_over_two_runs": True,
                "flash_fwd_in_place": len(in_place),
                "flash_fwd_max_err": max(r["fwd"] for r in in_place),
                "flash_bwd_in_place": len(checked),
                "flash_bwd_max_rel": max(checked)})
    del params, batch, leaves
    gc.collect()
    torch.cuda.empty_cache()
    log(f"    {json.dumps(out)}")
    return out


P11_SCALE = 18           # phase 11(b): the ranks' PageRank and CC graphs
P11_RANKS = 4            # phase 11(b)-(c): gloo ranks on the one card
P11_TIMEOUT = 400        # seconds phase 11's ranks may take, builds included
P11_DIR = ROOT / "build" / "chip_smoke_p11"
P11_REPS = 5             # phase 11's timed runs a side, after a warm-up
# core/exchange.py without its transpose's local permute (phase 11(a)'s
# mutant): at world 1 the exchange becomes the identity
P11_PERMUTE = ("return recv.permute(perm).reshape((nl, self.p) + rest)",
               "return recv.reshape((nl, self.p) + rest)")


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def p11_times(fn, dev, before=None) -> list:
    """Seconds of P11_REPS calls of `fn` (phase 11), each less the host
    seconds its CUDA-graph captures and their release took
    (`core.capture.stats`): a `LocalExchange` pregel captures its
    superstep anew every call, an `SpmdExchange` one runs eagerly.
    `before` runs ahead of each call, untimed (the ranks' barrier)."""
    from repro_torch.core import capture
    out = []
    for _ in range(P11_REPS):
        if before is not None:
            before()
        c0 = capture.stats["capture_s"] + capture.stats["release_s"]
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        t = time.perf_counter() - t0
        out.append(t - (capture.stats["capture_s"]
                        + capture.stats["release_s"] - c0))
    return out


def p11_ms(times: list, supersteps: int) -> dict:
    """The median and the spread of `p11_times`, in ms a superstep."""
    import statistics
    ms = sorted(1e3 * t / supersteps for t in times)
    return {"median": statistics.median(ms), "min": ms[0], "max": ms[-1]}


def p11_pagerank(gg, max_supersteps: int = PR_ITERS, **kw):
    """PageRank, PR_ITERS supersteps, through pregel (phase 11)."""
    import torch
    from repro_torch.core import algorithms as alg
    from repro_torch.core import pregel
    return pregel(gg, alg.pagerank_vprog(0.15), alg.pagerank_send, "sum",
                  default_msg={"m": torch.tensor(0.0)},
                  max_supersteps=max_supersteps, skip_stale=None, **kw)


def p11_cc(gg, max_supersteps: int = 100, **kw):
    """Connected components to convergence through pregel (phase 11)."""
    import torch
    from repro_torch.core import algorithms as alg
    from repro_torch.core import pregel
    return pregel(gg, alg.cc_vprog, alg.cc_send, "min",
                  default_msg={"m": torch.tensor(alg.IMAX,
                                                 dtype=torch.int32)},
                  max_supersteps=max_supersteps, skip_stale="out", **kw)


def phase_11_rank(rank, world, device, path, snap_dir):
    """One rank of phase 11(b)-(c), spawned by `utils.spmd.run_ranks` (a
    gloo group, every rank on the one card): its rows of the graphs saved
    at `path`, PageRank and CC through pregel over `SpmdExchange`, the
    checked PageRank clean and under the home_rows mutant, and CC's
    snapshot after 2 supersteps restored elastically onto ranks 0-1.
    Returns this rank's launches by run and, on rank 0, the gathered
    results."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import snapshot as snap_mod
    from repro_torch.core import transport as T
    from repro_torch.core.exchange import SpmdExchange
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import in_group, make_restore_mesh
    from repro_torch.utils.spmd import shard
    graphs = torch.load(path, weights_only=False)
    ex = SpmdExchange(P)

    def place(gg):
        return shard(gg, rank, world, device=device).replace(ex=ex)

    def gather(t, e=ex):
        return e.all_gather_rows(t.contiguous())[0].cpu().numpy()

    tally, out = {}, {}

    def counted(label, fn):
        ops.reset_launch_counts()
        _sync(device)
        t0 = time.perf_counter()
        r = fn()
        _sync(device)
        tally[label] = {k: n for k, n in ops.launch_counts().items() if n}
        return r, time.perf_counter() - t0

    g_pr, sg = place(graphs["pagerank"]), place(graphs["cc"])
    # warm-up, not counted: the group's first collectives connect its
    # ranks, and each rank loads its kernels (timed once, cold)
    _, out["cold 2 supersteps s"] = counted(
        "warm-up", lambda: p11_pagerank(g_pr, max_supersteps=2))
    del tally["warm-up"]
    for name, gg, run in (("pagerank", g_pr, p11_pagerank),
                          ("cc", sg, p11_cc)):
        r, _ = counted(name, lambda gg=gg, run=run: run(
            gg, track_metrics=True))
        leaf = "pr" if name == "pagerank" else "cc"
        # each superstep's bytes (exact integers) added in float64
        mine = torch.tensor(sum(float(m["bytes_shipped"])
                                for m in r.metrics), dtype=torch.float64)
        out[name] = {"values": gather(r.graph.vdata[leaf]),
                     "supersteps": r.supersteps,
                     "bytes_shipped": float(ex.psum(mine))}
        # the counted run was this run's warm-up; each timed one starts
        # with the ranks together (rank 0's times are kept)
        out[name]["s"] = p11_times(lambda gg=gg, run=run: run(gg), device,
                                   before=dist.barrier)
    # the integrity words salt with home_rows: a clean checked run sees no
    # fault, and with every rank naming its row 0 (the mutant) the other
    # ranks' words cannot verify
    chk = T.TransportPolicy("dense", integrity=True)

    def checked():
        rr = p11_pagerank(g_pr, transport=chk, track_metrics=True)
        return (sum(m["wire_faults"] for m in rr.metrics),
                gather(rr.graph.vdata["pr"]))
    out["checked"] = checked()
    keep = SpmdExchange.home_rows
    SpmdExchange.home_rows = lambda self, nl, device=None: torch.arange(
        nl, dtype=torch.int32, device=device)
    try:
        out["home_rows mutant"] = checked()
    finally:
        SpmdExchange.home_rows = keep
    # (c) CC snapshotted after 2 supersteps on 4 ranks, restored onto 2
    r2, _ = counted("cc, 2 supersteps before the snapshot",
                    lambda: p11_cc(place(graphs["elastic"]),
                                   max_supersteps=2))
    store = snap_mod.SnapshotStore(snap_dir)
    snap_mod.save_pregel(store, 2, r2.graph, T.DENSE)
    group = make_restore_mesh(2)
    if in_group(group):
        ex2 = SpmdExchange(2, group)
        e2, start, _, _ = snap_mod.restore_pregel_elastic(
            store, num_partitions=2, ex=ex2, device=device)
        done, t = counted("cc, elastic restore onto 2 ranks",
                          lambda: p11_cc(e2))
        out["elastic"] = {"start": start, "p": e2.s.p,
                          "supersteps": done.supersteps, "s": t,
                          "cc": gather(done.graph.vdata["cc"], ex2),
                          "vid": gather(e2.s.home_vid, ex2),
                          "vmask": gather(done.graph.vmask, ex2)}
    return {"tally": tally, "out": out if rank == 0 else None}


def phase_11_executor(g, sg, tally):
    """The multi-device executor (phase 11; see the docstring), each
    main-path run counted alone into `tally`.  Returns the table it
    logs."""
    import dataclasses
    import os
    import shutil
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import algorithms as alg
    from repro_torch.core import pregel, with_wire
    from repro_torch.core import transport as T
    from repro_torch.core.exchange import SpmdExchange
    from repro_torch.core.graph import Graph
    from repro_torch.data import rmat, symmetrize
    from repro_torch.utils.spmd import run_ranks, shard
    dev = g.device
    kernels = ("triplet", "apply")
    table = {}

    # (a) world 1 over NCCL: every partition on this process's card
    dvp, dch = alg.delta_pagerank_fns(0.15, DELTA_TOL)
    g_pr = alg.attach_out_degree(g).mapV(alg._pr_init)
    g_dl = alg.attach_out_degree(
        g.replace(ex=with_wire(g.ex, "f32", delta=True))).mapV(
            lambda vid, v: {**v, "pr": torch.tensor(0.15),
                            "delta": torch.tensor(0.15)})
    auto = T.TransportPolicy("auto", **FIG4_AUTO)
    runs = {
        "pagerank": (g_pr, p11_pagerank),
        "cc": (sg.mapV(alg._cc_init), p11_cc),
        "delta pagerank, auto (fig4)": (g_dl, lambda gg: pregel(
            gg, dvp, alg.delta_pagerank_send, "sum",
            default_msg={"m": torch.tensor(0.0)}, max_supersteps=DELTA_MAX,
            skip_stale="out", changed_fn=dch, transport=auto)),
        "pagerank, int8 wire": (g_pr.replace(ex=with_wire(g_pr.ex, "int8")),
                                p11_pagerank)}
    world1 = {}
    backend = "nccl" if dev.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        try:
            ex1 = SpmdExchange(P)
            if (ex1.world, ex1.nl, dist.get_backend()) != (1, P, backend):
                raise AssertionError(f"phase 11(a): world {ex1.world}, nl "
                                     f"{ex1.nl}, {dist.get_backend()}")
            # warm-up, not timed: NCCL makes its communicator at the
            # group's first collectives
            warm = torch.zeros((P, P, 8), device=dev)
            ex1.psum(ex1.transpose(warm).sum())
            _sync(dev)
            for name, (gl, run) in runs.items():
                gs = gl.replace(ex=dataclasses.replace(ex1,
                                                       wire=gl.ex.codec))
                # the checked runs are each side's warm-up
                local = run(gl)
                spmd = main_path_run(
                    tally, f"phase 11(a) {name}, world 1 {backend}",
                    lambda: run(gs), launched=kernels)
                same_run(f"phase 11(a) {name}", spmd, local)
                psummed = float(ex1.psum(spmd.graph.wire_log.bytes_shipped
                                         .sum()))
                want = float(local.graph.wire_log.bytes_shipped.sum())
                if spmd.supersteps != local.supersteps or psummed != want:
                    raise AssertionError(
                        f"phase 11(a) {name}: {spmd.supersteps} supersteps, "
                        f"{psummed} bytes; LocalExchange {local.supersteps}, "
                        f"{want}")
                steps = spmd.supersteps
                world1[name] = {
                    "supersteps": steps, "bytes_shipped": psummed,
                    "ms_per_superstep_spmd": p11_ms(
                        p11_times(lambda: run(gs), dev), steps),
                    "ms_per_superstep_local": p11_ms(
                        p11_times(lambda: run(gl), dev), steps)}
                if name == "pagerank":
                    want_pr = local.graph.vdata["pr"]
                del local, spmd
            # the mutant: the transpose without its local permute
            mut = edited_module("repro_torch.core.exchange", *P11_PERMUTE)
            bad, _ = eager_pregel(
                g_pr.replace(ex=mut.SpmdExchange(P)),
                alg.pagerank_vprog(0.15), alg.pagerank_send, "sum",
                default_msg={"m": torch.tensor(0.0)},
                max_supersteps=PR_ITERS, skip_stale=None)
            if torch.equal(bad.vdata["pr"], want_pr):
                raise AssertionError("phase 11(a): the transpose without its "
                                     "local permute passed the check")
            world1["mutant (no local permute)"] = "fails: ranks differ"
            del bad, want_pr
        finally:
            dist.destroy_process_group()
    world1["note"] = (f"median of {P11_REPS} runs a side after a warm-up "
                      "run; pregel over SpmdExchange runs its supersteps "
                      "eagerly; over LocalExchange it replays a captured "
                      "CUDA graph after superstep 1, and its times leave "
                      "the capture out")
    table["(a) world 1"] = world1

    # (b)-(c) four gloo ranks on the one card
    t0 = time.perf_counter()
    gd = rmat(P11_SCALE, 16, seed=0)
    sgd = symmetrize(rmat(P11_SCALE, 16, seed=1))
    egd = symmetrize(rmat(ELASTIC_SCALE, 16, seed=1))

    def host(d):
        return Graph.from_edges(d.src, d.dst, num_partitions=P, device="cpu")
    cpu = {"pagerank": alg.attach_out_degree(
               host(gd), kernel_mode="ref").mapV(alg._pr_init),
           "cc": host(sgd).mapV(alg._cc_init),
           "elastic": host(egd).mapV(alg._cc_init)}
    shutil.rmtree(P11_DIR, ignore_errors=True)
    P11_DIR.mkdir(parents=True)
    path = P11_DIR / "graphs.pt"
    torch.save({k: v.replace(host=None) for k, v in cpu.items()}, path)
    t_build = time.perf_counter() - t0
    # the same graphs over LocalExchange on this card
    want = {}
    for name, run, leaf in (("pagerank", p11_pagerank, "pr"),
                            ("cc", p11_cc, "cc")):
        gl = shard(cpu[name], 0, 1, device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        r = run(gl, track_metrics=True)          # also the warm-up
        _sync(dev)
        t_first = time.perf_counter() - t0
        want[name] = (r.graph.vdata[leaf].cpu().numpy(), r.supersteps,
                      p11_times(lambda: run(gl), dev),
                      sum(float(m["bytes_shipped"]) for m in r.metrics),
                      t_first)
        del r, gl
    t0 = time.perf_counter()
    res = run_ranks(phase_11_rank, P11_RANKS,
                    args=(str(path), str(P11_DIR / "snap")),
                    backend="gloo", device=dev.type, timeout=P11_TIMEOUT)
    t_ranks = time.perf_counter() - t0
    out = res[0]["out"]
    ranks = {}
    for name in ("pagerank", "cc"):
        vals, steps, t_local, bytes_local, t_first = want[name]
        got = out[name]
        if not (np.array_equal(got["values"], vals)
                and got["values"].dtype == vals.dtype
                and got["supersteps"] == steps
                and got["bytes_shipped"] == bytes_local):
            raise AssertionError(f"phase 11(b) {name}: the {P11_RANKS} "
                                 "ranks' gathered run differs from "
                                 "LocalExchange's")
        for r, rr in enumerate(res):
            if any(rr["tally"][name].get(k, 0) <= 0 for k in kernels):
                raise AssertionError(f"phase 11(b) {name}: rank {r} "
                                     f"launched {rr['tally'][name]}")
        ranks[name] = {"supersteps": steps,
                       "bytes_shipped": got["bytes_shipped"],
                       "ms_per_superstep_ranks": p11_ms(got["s"], steps),
                       "ms_per_superstep_local": p11_ms(t_local, steps),
                       "ms_per_superstep_local_first_run_capture_in":
                           1e3 * t_first / steps}
    cc_ids = cpu["cc"].s.home_vid.numpy()[cpu["cc"].vmask.numpy()]
    cc_got = out["cc"]["values"][cpu["cc"].vmask.numpy()]
    if not np.array_equal(cc_got, min_id_labels(sgd.num_vertices, sgd.src,
                                                sgd.dst, cc_ids)):
        raise AssertionError("phase 11(b) cc: labels differ from scipy's")
    faults, pr_chk = out["checked"]
    if faults or not np.array_equal(pr_chk, want["pagerank"][0]):
        raise AssertionError(f"phase 11(b): a clean checked run saw "
                             f"{faults} faults")
    faults_mut, pr_mut = out["home_rows mutant"]
    if faults_mut <= 0:
        raise AssertionError("phase 11(b): home_rows returning arange(nl) "
                             "passed the integrity check")
    ranks["checked pagerank"] = {
        "wire_faults clean": faults, "home_rows mutant": f"fails: "
        f"{faults_mut} wire faults a rank, values still exact "
        f"{bool(np.array_equal(pr_mut, want['pagerank'][0]))}"}
    el = out["elastic"]
    ids = el["vid"][el["vmask"]]
    if (el["start"], el["p"]) != (2, 2) or not np.array_equal(
            el["cc"][el["vmask"]],
            min_id_labels(egd.num_vertices, egd.src, egd.dst, ids)):
        raise AssertionError("phase 11(c): the elastic restore's labels "
                             "differ from scipy's")
    ranks["(c) elastic cc"] = {
        "graph": f"symmetrize(rmat({ELASTIC_SCALE},16))",
        "snapshot after": 2, "supersteps after": el["supersteps"],
        "s": el["s"]}
    ranks["rank 0's cold warm-up, ms a superstep (2 supersteps)"] = \
        1e3 * out["cold 2 supersteps s"] / 2
    ranks["note"] = (f"median of {P11_REPS} runs a side after a warm-up "
                     "run, rank 0's clock, each run started at a barrier; "
                     "the LocalExchange times leave the capture out")
    ranks["host build s"] = t_build
    ranks["ranks s (spawn, load, runs)"] = t_ranks
    for label in res[0]["tally"]:
        summed = {}
        for rr in res:
            for k, n in rr["tally"].get(label, {}).items():
                summed[k] = summed.get(k, 0) + n
        tally[f"phase 11(b) {label}, {P11_RANKS} gloo ranks"] = summed
    table[f"(b)-(c) {P11_RANKS} gloo ranks on one card"] = ranks
    shutil.rmtree(P11_DIR, ignore_errors=True)
    return table


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
    # phase 9: the forward at the backward shapes' head dims, the backward
    # and its dropped-head mutant
    sources += [("flash_attention", flash_mod.source(dh))
                for dh in (64, 256)]
    sources += [("flash_attention_bwd", flash_mod.bwd_source(dh))
                for dh in (64, 128, 256)]
    sources += [("flash_attention_bwd", bwd_mutant_source(dh))
                for dh in (128, 256)]
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
    # phase 4a's delta PageRank: its send and its apply with changed_fn
    g_dl_t = alg.attach_out_degree(gt, kernel_mode="ref").mapV(
        lambda vid, v: {**v, "pr": torch.tensor(0.15),
                        "delta": torch.tensor(0.15)})
    dvp, dch = alg.delta_pagerank_fns(0.15, DELTA_TOL)
    sources += [
        ("triplet", tri_mod.source(mt.fused_plan(
            g_dl_t, alg.delta_pagerank_send, "sum").kernel, "sum", "dst")),
        ("apply", app_mod.source(mt._plan_apply(
            g_dl_t, dvp, alg.delta_pagerank_send, "sum", dch, zero_msg,
            None).kernel, "sum"))]
    for extra in (lambda vid, v: {"age": vid.float()},
                  lambda vid, v: {"pages": vid.float(), "dom": vid}):
        g_x = alg.attach_out_degree(gt.mapV(extra), kernel_mode="ref")
        sources.append(("apply", app_mod.source(mt._plan_apply(
            g_x.mapV(alg._pr_init), pr_vprog, alg.pagerank_send, "sum", None,
            zero_msg, None).kernel, "sum")))
    # phase 4d's sends: the joins' x + y, fig5's both-sided warm-up, fig6's
    # degree send under the pushed-down predicate
    g_deg_t = alg.attach_out_degree(gt, kernel_mode="ref")
    for g_x, send in ((gt.mapV(_xy_init), _send_xy), (g_pr_t, _send_both),
                      (g_deg_t.mapV(_vid_f32), _send_deg)):
        sources.append(("triplet", tri_mod.source(
            mt.fused_plan(g_x, send, "sum").kernel, "sum", "dst")))
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
    pr3 = {"ids": ids_np, "pr": vals["pr"].astype(np.float64),
           "want": want}                         # phase 4d's references
    log(f"  pagerank fused {t_f:.3f} s ({t_f / r_f.supersteps * 1e3:.2f} ms "
        f"per superstep incl. degree), unfused {t_u:.3f} s "
        f"({t_u / r_u.supersteps * 1e3:.2f} ms per superstep); "
        f"fused == unfused bit for bit; max|pr-ref|/max|ref| = {rel:.3g}; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    counts_3 = ops.launch_counts()
    r3, _, trace = prof_mod.traced(lambda: alg.pagerank(g, num_iters=3))
    log(f"  pagerank traced, 3 supersteps: "
        f"{prof_mod.home_line(prof_mod.span_stats(trace), r3.supersteps)}")
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
    r4, _, trace = prof_mod.traced(lambda: alg.connected_components(sg))
    log(f"  cc traced: "
        f"{prof_mod.home_line(prof_mod.span_stats(trace), r4.supersteps)}")
    del trace
    launches = {k: counts_3.get(k, 0) + counts_4.get(k, 0)
                for k in set(counts_3) | set(counts_4)}
    launches.update(resident_launches)
    for name in ("triplet", "apply", "segment_sum", *resident_launches):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the main path")
    cc_want = minid[lab[ids_np]]
    del c_f, c_u, adj, lab, minid, vals, r4

    # ---------------------------------------------------------- phase 4a
    t_phase = time.perf_counter()
    log("phase 4a: the Pregel drivers (eager loop, captured pregel, "
        "pregel_fused) on the graphs of phases 2 and 4")
    log("  phase 4a drivers: " + json.dumps(
        phase_4a_drivers(g, sg, ids_np, cc_want)))
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 4a: {time.perf_counter() - t_phase:.1f} s")

    # ---------------------------------------------------------- phase 4c
    t_phase = time.perf_counter()
    log("phase 4c: the transports (dense, ragged, fig4's auto, pipelined, "
        "the broadcast lane) on the graphs of phases 2 and 4")
    tally_4c = {}
    log("  phase 4c transports: " + json.dumps(phase_4c_transports(
        g, sg, sgd, ids_np, cc_want, tally_4c)))
    log("  phase 4c launches, each main-path run counted alone:")
    for label, counts in tally_4c.items():
        log(f"    {label}: " + ", ".join(
            f"{k} {counts.get(k, 0)}" for k in ("triplet", "apply")))
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 4c: {time.perf_counter() - t_phase:.1f} s")

    # ---------------------------------------------------------- phase 4d
    t_phase = time.perf_counter()
    log("phase 4d: the data-parallel half (the dataflow PageRank, the "
        "joins, Listing 5, the chain planner) on phase 3's graph")
    tally_4d = {}
    log("  phase 4d: " + json.dumps(phase_4d_dataparallel(g, gd, pr3,
                                                          tally_4d)))
    log("  phase 4d launches, each main-path run counted alone:")
    for label, counts in tally_4d.items():
        log(f"    {label}: " + ", ".join(
            f"{k} {counts.get(k, 0)}" for k in ("triplet", "apply",
                                                "segment_sum")))
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
    del pr3
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 4d: {time.perf_counter() - t_phase:.1f} s")

    # ---------------------------------------------------------- phase 4e
    t_phase = time.perf_counter()
    log("phase 4e: fault tolerance and out-of-core residency (the integrity "
        "ladder under injected faults, kill and resume, elastic restore, "
        "working set 0.5) on the graphs of phases 2 and 4; " + card)
    tally_4e = {}
    log("  phase 4e: " + json.dumps(phase_4e_fault_tolerance(
        g, sg, ids_np, cc_want, tally_4e)))
    log("  phase 4e launches, each main-path run counted alone:")
    for label, counts in tally_4e.items():
        log(f"    {label}: " + ", ".join(
            f"{k} {counts.get(k, 0)}" for k in ("triplet", "apply",
                                                "segment_sum")))
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
    del ids_np, cc_want
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 4e: {time.perf_counter() - t_phase:.1f} s")

    # ---------------------------------------------------------- phase 11
    t_phase = time.perf_counter()
    log("phase 11: the multi-device executor (SpmdExchange at world 1 over "
        f"NCCL on the graphs of phases 2 and 4; {P11_RANKS} gloo ranks on "
        f"the card on rmat({P11_SCALE},16); an elastic restore onto 2 "
        "ranks); " + card)
    tally_11 = {}
    log("  phase 11: " + json.dumps(phase_11_executor(g, sg, tally_11)))
    log("  phase 11 launches, each main-path run counted alone (ranks "
        "summed):")
    for label, counts in tally_11.items():
        log(f"    {label}: " + ", ".join(
            f"{k} {counts.get(k, 0)}" for k in ("triplet", "apply")))
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 11: {time.perf_counter() - t_phase:.1f} s")

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
    in_place, tiles = serve_step_in_place(cfg, last_step, n_cross)
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
    import shutil
    from repro_torch.core.tree import tree_leaves
    train_dir = SNAP_DIR / "train"
    shutil.rmtree(train_dir, ignore_errors=True)
    train_args = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS),
                  "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                  "--ckpt-dir", str(train_dir), "--ckpt-every",
                  str(TRAIN_STEPS - 1)]
    tr = train_launch.main(train_args)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    cfg = C.get(TRAIN_ARCH)
    n_mlstm = sum(cfg.layer_pattern[i % len(cfg.layer_pattern)] == "mlstm"
                  for i in range(cfg.n_layers))
    # the forward runs again for the layers of the super-layers, which the
    # backward recomputes (remat, as the reference's jax.checkpoint)
    period = len(cfg.layer_pattern)
    n_remat = sum(cfg.layer_pattern[i % period] == "mlstm" for i in
                  range(cfg.n_layers // period * period))
    per_step = {"mlstm_fwd": n_mlstm + n_remat, "mlstm_bwd": n_mlstm}
    for kname in ("mlstm_fwd", "mlstm_bwd"):
        launches[kname] = counts[kname]
        if counts[kname] != per_step[kname] * TRAIN_STEPS:
            raise AssertionError(f"{kname} launches {counts[kname]}, expected "
                                 f"{per_step[kname] * TRAIN_STEPS}")
    losses = tr["losses"]
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"training losses {losses}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_params = T.param_count(tr["params"])
    steps_s = tr["step_seconds"]
    # the checkpoint after step 2 (written while step 3 ran): a run resumed
    # from it for one step (step 3's batch) must give step 3's loss and
    # parameters bit for bit
    saves = {c["step"]: c for c in tr["checkpoints"]}
    if sorted(saves) != [TRAIN_STEPS - 1, TRAIN_STEPS]:
        raise AssertionError(f"train checkpoints at {sorted(saves)}")
    shutil.rmtree(train_dir / f"step_{TRAIN_STEPS:08d}")
    full_params = tr["params"]
    del tr
    gc.collect()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    tr2 = train_launch.main(train_args)
    torch.cuda.synchronize()
    t_resume = time.perf_counter() - t0
    counts = ops.launch_counts()
    for kname in ("mlstm_fwd", "mlstm_bwd"):
        launches[kname] += counts[kname]
        if counts[kname] != per_step[kname]:
            raise AssertionError(f"resumed {kname} launches {counts[kname]}")
    if tr2["losses"] != losses[TRAIN_STEPS - 1:] or not all(
            torch.equal(a, b) for a, b in zip(tree_leaves(tr2["params"]),
                                              tree_leaves(full_params))):
        raise AssertionError(f"resumed step {TRAIN_STEPS}: loss "
                             f"{tr2['losses']} vs {losses[-1:]} or the "
                             "parameters differ")
    ck = saves[TRAIN_STEPS - 1]
    log(f"  checkpoint after step {TRAIN_STEPS - 1}: {ck['bytes'] / 2**30:.3f}"
        f" GiB on disk, device-to-host copy {ck['copy_s']:.3f} s, file write "
        f"{ck['write_s']:.3f} s (on a thread, beside step {TRAIN_STEPS}); "
        f"resumed for step {TRAIN_STEPS} in {t_resume:.1f} s (restore, init "
        f"and the step): loss {tr2['losses'][0]:.6f} and every parameter "
        f"bit-equal to the uninterrupted run")
    del tr2, full_params
    shutil.rmtree(SNAP_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    # step 1 again from the same initial weights and batch: forward and
    # backward through the kernels, each mLSTM call (the recompute's too,
    # forward only: its graph is not differentiated) held in place against
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
    bwd_held = [r["bwd"] for r in in_place if "bwd" in r]
    if len(in_place) != n_mlstm + n_remat or len(bwd_held) != n_mlstm:
        raise AssertionError(f"{len(in_place)} mlstm calls held in place, "
                             f"{len(bwd_held)} backward")
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
        f"{launches['mlstm_fwd']} forward ({n_mlstm} + {n_remat} "
        f"recomputed a step), {launches['mlstm_bwd']} backward")
    log(f"  step 1, kernels vs plain: loss {loss_k:.6f} vs {loss_r:.6f} "
        f"(|diff| {abs(loss_k - loss_r):.3g}, limit {TRAIN_LOSS_LIMIT} "
        f"relative; the training run's step 1 read {losses[0]:.6f}); in "
        f"place, all {len(in_place)} mLSTM calls:"
        f" forward worst err/limit {max(r['fwd'] for r in in_place):.3g}, "
        f"backward ({len(bwd_held)} calls) relative error max "
        f"{max(bwd_held):.3g} (limit "
        f"{MLSTM_GRAD_REL_LIMIT}; cotangent zeroed on "
        f"{sum(r['ambiguous'] for r in in_place if 'bwd' in r)} of "
        f"{n_mlstm * TRAIN_BATCH * cfg.n_heads * TRAIN_SEQ} rows whose "
        f"normaliser branch is within rounding)")
    del params, batch
    log(f"  phase 8: {time.perf_counter() - t_phase:.1f} s")

    # ---------------------------------------------------------- phase 9
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log("phase 9: the flash attention backward kernel vs plain, then "
        f"train {RG_ARCH}, batch {RG_BATCH}, seq {RG_SEQ}, {RG_STEPS} steps")
    phase_9a_flash_backward(gen, dev, results)
    phase_9b_train(dev, launches)
    log(f"  phase 9: {time.perf_counter() - t_phase:.1f} s")

    # ---------------------------------------------------------- phase 10
    t_phase = time.perf_counter()
    log("phase 10: MoE and encoder-decoder models, and training with "
        f"context tokens: serve batch {SERVE_BATCH}, prompt {SERVE_PROMPT}, "
        f"gen {SERVE_GEN}; train batch {P10_BATCH} x seq {P10_SEQ}, "
        f"{P10_STEPS} AdamW steps")
    for arch, layers, why in P10_SERVE:
        phase_10_serve(dev, arch, layers, why, launches)
    for arch, layers, why in P10_TRAIN:
        phase_10_train(dev, arch, layers, why, launches)
    log(f"  phase 10: {time.perf_counter() - t_phase:.1f} s")

    replaces = {"triplet": "src/repro/kernels/triplet.py:447",
                "apply": "src/repro/kernels/superstep.py:179",
                "segment_sum": "src/repro/kernels/segment_sum.py:101",
                "flash_attention": "src/repro/kernels/flash_attention.py:121",
                # the same pallas_call at Dh above 128 (recurrentgemma's
                # 256): the wide body of csrc/flash_attention.cu
                "flash_attention_wide":
                    "src/repro/kernels/flash_attention.py:121",
                # no Pallas kernel: the reference differentiates its plain
                # attention
                "flash_attention_bwd": "src/repro/kernels/ref.py:181",
                "mlstm_fwd": "src/repro/kernels/mlstm.py:102",
                "mlstm_bwd": "src/repro/kernels/mlstm.py:102",
                "spmv": "src/repro/kernels/spmv.py:59"}
    csrc = {"mlstm_fwd": "mlstm_tc", "mlstm_bwd": "mlstm_tc",
            "spmv": "triplet", "flash_attention_wide": "flash_attention"}
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

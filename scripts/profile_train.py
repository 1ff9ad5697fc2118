"""Where a training step's time goes on the card.

    python3 scripts/profile_train.py [--arch xlstm-350m] [--batch 8]
        [--seq 1024]
    python3 scripts/profile_train.py --arch recurrentgemma-2b --batch 1 \\
        --seq 4096
    python3 scripts/profile_train.py --arch moonshot-v1-16b-a3b --batch 1 \\
        --seq 4096 --layers 4

Draws the config at full width on the card (`train_loop.init_params`,
seed 0), cut to `--layers` layers where given, and trains on the data
`launch.train` builds for it (`SyntheticLM` seed 0, with its context) with
AdamW through
`train_loop.make_train_step` (the per-super-layer recompute on): one step
to warm up, three timed untraced (host clock around each step, which ends
in `float(loss)`), with their losses and peak device memory
(`torch.cuda.max_memory_allocated`).  Then, still untraced, it times each
recurrent or MoE block kind of the config alone on the same shapes (sLSTM,
mLSTM, RG-LRU, MoE): forward + backward of one block from a random input and
cotangent (synchronised, mean of three), for the kind's share of the
untraced step; for the MoE block also the f32 -> bf16 casts of its expert
weights alone.
Last come the traced runs (`torch.profiler`, CPU + CUDA activities; a
trace slows every launch, so nothing is timed after one): one training
step, for its device busy time (summed kernel time; the port launches on
one stream), its kernel count, the idle share of an untraced step (1 -
busy / untraced wall), the device time of the top kernels by name and the
share of each of the port's kernel families (`mlstm_*`, the flash forward
`flash_simt` / `flash_tc` / `flash_decode`, the flash backward
`flash_bwd_*`), and the MoE blocks' spans on the device's timeline
(`moe_block`, forward and recompute, gaps between their kernels included;
their backward runs outside the span); and one block of each kind, for
its kernel count.  Prints
the card's name and power limit.  Needs one CUDA card.
"""
import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

WARM, TIMED = 1, 3
# kernel families by name: the names their __global__ functions start with
FAMILIES = {"mLSTM": ("mlstm_",), "flash forward": ("flash_simt", "flash_tc",
                                                   "flash_decode"),
            "flash backward": ("flash_bwd_",)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-350m")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config to this many layers (0: all)")
    args = ap.parse_args()
    import dataclasses
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import configs as C
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.train import data_for
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M
    from repro_torch.models import recurrent as R
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_loop as tl

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    cfg = C.get(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    batch_n, seq = args.batch, args.seq
    # a span around each MoE block: the trace sums its kernels' time
    moe_block = M.moe_block

    def spanned(*a, **kw):
        with record_function("moe_block"):
            return moe_block(*a, **kw)

    M.moe_block = spanned
    params = tl.init_params(cfg, 0, dev)
    ostate = opt.init(params)
    step = tl.make_train_step(cfg, opt.AdamWConfig(total_steps=10,
                                                   warmup_steps=5))
    data = data_for(cfg, seq, batch_n)

    def run(i):
        nonlocal params, ostate
        batch = {k: torch.from_numpy(a).to(dev)
                 for k, a in data.batch(i).items()}
        t0 = time.perf_counter()
        params, ostate, m = step(params, ostate, batch)
        loss = float(m["loss"])
        return time.perf_counter() - t0, loss

    for i in range(WARM):
        run(i)
    torch.cuda.reset_peak_memory_stats()
    timed = [run(WARM + i) for i in range(TIMED)]
    peak = torch.cuda.max_memory_allocated() / 2**30
    walls = [t for t, _ in timed]
    wall = sum(walls) / TIMED
    print(f"{cfg.name} ({cfg.n_layers} layers), batch {batch_n}, seq {seq}; "
          f"card {card}")

    # the recurrent block kinds alone, forward + backward of one block
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((batch_n, seq, cfg.d_model), generator=gen, device=dev)
    dy = torch.randn((batch_n, seq, cfg.d_model), generator=gen, device=dev)
    kinds = {"slstm": (R.init_slstm, lambda p, h: R.slstm_block(p, h)),
             "mlstm": (R.init_mlstm, lambda p, h: R.mlstm_block(
                 p, h, chunk=cfg.mlstm_chunk)),
             "rglru": (R.init_rglru, lambda p, h: R.rglru_block(p, h)),
             "moe": (M.init_moe, lambda p, h: M.moe_block(p, h, cfg)[0])}
    n_of = {k: sum(cfg.layer_pattern[i % len(cfg.layer_pattern)] == k
                   for i in range(cfg.n_layers)) for k in kinds}
    n_of["moe"] = cfg.n_layers if cfg.family == "moe" else 0
    fwd_bwd = {}
    for kind, (init, block) in kinds.items():
        if not n_of[kind]:
            continue
        p = {k: t.requires_grad_(True) for k, t in init(
            cfg, generator=gen, device=dev).items()}
        xin = x.clone().requires_grad_(True)

        def one(p=p, xin=xin, block=block):
            y = block(p, L.rms_norm(xin, torch.ones(cfg.d_model, device=dev)))
            torch.autograd.grad(y, [xin] + tree_leaves(p), dy)
            torch.cuda.synchronize()

        fwd_bwd[kind] = one
        one()
        t0 = time.perf_counter()
        for _ in range(3):
            one()
        sec = (time.perf_counter() - t0) / 3
        print(f"{kind}: one block forward + backward {sec * 1e3:.1f} ms; x "
              f"{n_of[kind]} blocks = {sec * n_of[kind]:.3f} s, "
              f"{sec * n_of[kind] / wall:.1%} of the untraced step")
        if kind == "moe":
            casts = [p[n] for n in ("wi", "wg", "wo")]

            def cast():
                for t in casts:
                    t.detach().to(torch.bfloat16)
                torch.cuda.synchronize()

            cast()
            t0 = time.perf_counter()
            for _ in range(3):
                cast()
            sec = (time.perf_counter() - t0) / 3
            n_exp = sum(t.numel() for t in casts)
            print(f"moe: the expert weights' f32 -> bf16 casts alone "
                  f"{sec * 1e3:.2f} ms a call ({n_exp / 1e6:.1f} M "
                  f"parameters); a step casts them in the forward and the "
                  f"recompute")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced, _ = run(WARM + TIMED)
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0
            and e.key != "moe_block"]      # a span, not a kernel
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) / 1e6
    n_kernels = sum(r[2] for r in rows)
    print(f"train step: untraced wall {wall:.3f} s per step "
          f"({', '.join(f'{w:.3f}' for w in walls)}), losses "
          f"{[round(loss, 4) for _, loss in timed]}, traced wall "
          f"{traced:.3f} s; device busy {busy * 1e3:.1f} ms in {n_kernels} "
          f"kernels; idle share of an untraced step {1 - busy / wall:.1%}; "
          f"{batch_n * seq / wall:.0f} tokens/s; peak device memory "
          f"{peak:.2f} GiB")
    for fam, prefixes in FAMILIES.items():
        fr = [r for r in rows if any(pre in r[0] for pre in prefixes)]
        if not fr:
            continue
        ms = sum(r[1] for r in fr) / 1e3
        print(f"  {fam} kernels: {ms:.3f} ms in {sum(r[2] for r in fr)} "
              f"launches, {ms / 1e3 / busy:.1%} of device busy, "
              f"{ms / 1e3 / wall:.2%} of the untraced wall: "
              + ", ".join(f"{n} {us / 1e3:.3f} ms" for n, us, _ in fr))
    spans = [e for e in prof.key_averages() if e.key == "moe_block"]
    if spans:
        # the span's length on the device's timeline: from its first
        # kernel's start to its last one's end, the gaps between them
        # included
        ms = max(e.device_time_total for e in spans) / 1e3
        print(f"  MoE blocks (forward and recompute): {ms:.3f} ms on the "
              f"device's timeline in {spans[0].count} calls, "
              f"{ms / 1e3 / wall:.2%} of the untraced wall")
    for name, us, k in rows[:15]:
        print(f"  {us / 1e3:10.3f} ms  {k:7d}x  {name[:90]}")
    for kind, one in fwd_bwd.items():
        with profile(activities=[ProfilerActivity.CUDA]) as bprof:
            one()
        n = sum(e.count for e in bprof.key_averages()
                if e.device_type == DeviceType.CUDA)
        print(f"{kind}: one block forward + backward launches {n} kernels")
    return 0


if __name__ == "__main__":
    sys.exit(main())

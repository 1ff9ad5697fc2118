"""Where an xlstm-350m training step's time goes on the card.

    python3 scripts/profile_train.py

Draws xlstm-350m in full on the card (`train_loop.init_params`, seed 0;
24 layers, 179 M f32 parameters) and trains on `SyntheticLM` seed 0 at
batch 8, seq 1024 with AdamW: one step to warm up, three timed untraced
(host clock around each step, which ends in `float(loss)`).  Then, still
untraced, it times the two block kinds alone on the same shapes: forward +
backward of one block from a random input and cotangent (synchronised, mean
of three), for the 6 sLSTM blocks' and the 18 mLSTM blocks' share of the
untraced step.  Last come the traced runs (`torch.profiler`, CPU + CUDA
activities; a trace slows every launch, so nothing is timed after one):
one training step, for its device busy time (summed kernel time; the port
launches on one stream), its kernel count, the idle share of an untraced
step (1 - busy / untraced wall), the device time by kernel name and the
mLSTM kernels' (`mlstm_*`) share; and one block of each kind, for its
kernel count.  The peak device memory is that of the timed untraced steps
(`torch.cuda.max_memory_allocated`).  Needs one CUDA card.
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

ARCH, BATCH, SEQ, WARM, TIMED = "xlstm-350m", 8, 1024, 1, 3


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import configs as C
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.tokens import SyntheticLM
    from repro_torch.models import layers as L
    from repro_torch.models import recurrent as R
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_loop as tl

    dev = torch.device("cuda")
    cfg = C.get(ARCH)
    params = tl.init_params(cfg, 0, dev)
    ostate = opt.init(params)
    step = tl.make_train_step(cfg, opt.AdamWConfig(total_steps=10,
                                                   warmup_steps=5))
    data = SyntheticLM(cfg.vocab, SEQ, BATCH, seed=0)

    def run(i):
        nonlocal params, ostate
        batch = {k: torch.from_numpy(a).to(dev)
                 for k, a in data.batch(i).items()}
        t0 = time.perf_counter()
        params, ostate, m = step(params, ostate, batch)
        float(m["loss"])
        return time.perf_counter() - t0

    for i in range(WARM):
        run(i)
    torch.cuda.reset_peak_memory_stats()
    walls = [run(WARM + i) for i in range(TIMED)]
    peak = torch.cuda.max_memory_allocated() / 2**30
    wall = sum(walls) / TIMED

    # the two block kinds alone, forward + backward of one block
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((BATCH, SEQ, cfg.d_model), generator=gen, device=dev)
    dy = torch.randn((BATCH, SEQ, cfg.d_model), generator=gen, device=dev)
    kinds = {"slstm": (R.init_slstm, lambda p, h: R.slstm_block(p, h)),
             "mlstm": (R.init_mlstm, lambda p, h: R.mlstm_block(
                 p, h, chunk=cfg.mlstm_chunk))}
    n_of = {k: sum(cfg.layer_pattern[i % len(cfg.layer_pattern)] == k
                   for i in range(cfg.n_layers)) for k in kinds}
    fwd_bwd = {}
    for kind, (init, block) in kinds.items():
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

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced = run(WARM + TIMED)
    rows = [(e.key, e.device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) / 1e6
    n_kernels = sum(r[2] for r in rows)
    print(f"{cfg.name} train step, batch {BATCH}, seq {SEQ}: untraced wall "
          f"{wall:.3f} s per step ({', '.join(f'{w:.3f}' for w in walls)}),"
          f" traced wall {traced:.3f} s; device busy {busy * 1e3:.1f} ms in "
          f"{n_kernels} kernels; idle share of an untraced step "
          f"{1 - busy / wall:.1%}; {BATCH * SEQ / wall:.0f} tokens/s; peak "
          f"device memory {peak:.2f} GiB")
    ml = [r for r in rows if r[0].startswith("mlstm_")]
    ml_ms = sum(r[1] for r in ml) / 1e3
    print(f"  mLSTM kernels: {ml_ms:.3f} ms in {sum(r[2] for r in ml)} "
          f"launches, {ml_ms / 1e3 / busy:.1%} of device busy, "
          f"{ml_ms / 1e3 / wall:.2%} of the untraced wall: "
          + ", ".join(f"{n} {us / 1e3:.3f} ms" for n, us, _ in ml))
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

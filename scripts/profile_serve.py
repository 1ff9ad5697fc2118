"""Where a serve decode step's time goes on the card.

    python3 scripts/profile_serve.py

Draws llama-3.2-vision-11b in full on the card through `serve.setup`
(random weights, seed 0, batch 4), runs three decode steps to warm up,
times five steps untraced, then traces two more with `torch.profiler`
(CPU + CUDA activities).  Prints, all from this one run: the untraced
wall time per step, the traced device busy time per step (summed kernel
time; the port launches on one stream), the idle share of an untraced
step (1 - busy / untraced wall), the device time by kernel name, the
flash kernel's share of the busy time and of the untraced wall with the
inputs it copied (`flash_attention.copies`), and the bytes a step moves by
the model's own count: every matrix parameter read as f32, its bf16 cast
written and read again (8 B per parameter; an estimate from the parameter
count, not a measured byte count).  Needs one CUDA card.
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

ARCH, BATCH, WARM, TIMED, TRACED = "llama-3.2-vision-11b", 4, 3, 5, 2


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("profile_serve: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import configs as C
    from repro_torch.core.tree import tree_flatten_with_path
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    dev = torch.device("cuda")
    cfg = C.get(ARCH)
    n = WARM + TIMED + TRACED
    params, ctx, _ = serve.setup(cfg, BATCH, n, dev)
    state = T.init_decode_state(cfg, BATCH, n, device=dev)
    tok = torch.zeros((BATCH, 1), dtype=torch.long, device=dev)

    def steps(positions):
        nonlocal state
        for pos in positions:
            _, state = T.decode_step(params, state, tok, pos, cfg,
                                     cross_ctx=ctx)
        torch.cuda.synchronize()

    steps(range(WARM))
    t0 = time.perf_counter()
    steps(range(WARM, WARM + TIMED))
    wall = (time.perf_counter() - t0) / TIMED
    copies = flash_mod.flash_attention.copies
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps(range(WARM + TIMED, n))
        traced_wall = (time.perf_counter() - t0) / TRACED
    rows = [(e.key, e.device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) / 1e6 / TRACED
    # the weights a decode step casts to bf16: all but the norms' gains
    # and the frontend stub (the context comes in as embeddings)
    n_matrix = sum(t.numel() for path, t in tree_flatten_with_path(
        {k: v for k, v in params.items() if k != "frontend"})[0]
        if path[-1].key not in ("ln1", "ln2", "lnx", "final_norm"))
    nbytes = 8 * n_matrix
    print(f"{cfg.name} decode, batch {BATCH}: untraced wall "
          f"{wall * 1e3:.2f} ms per step ({TIMED} steps), traced wall "
          f"{traced_wall * 1e3:.2f} ms, device busy {busy * 1e3:.2f} ms per "
          f"step ({TRACED} traced steps), idle share of an untraced step "
          f"{1 - busy / wall:.1%}")
    print(f"bytes by the parameter count (estimate): {n_matrix / 1e9:.3f} B "
          f"matrix parameters x 8 B = {nbytes / 1e9:.1f} GB per step, "
          f"{nbytes / wall / 1e12:.2f} TB/s over the untraced wall, "
          f"{nbytes / busy / 1e12:.2f} TB/s over the device busy time")
    flash = sum(r[1] for r in rows if "flash" in r[0]) / 1e6 / TRACED
    print(f"flash kernel {flash * 1e3:.3f} ms per step: {flash / busy:.2%} "
          f"of device busy, {flash / wall:.2%} of the untraced wall; flash "
          f"inputs copied in the traced steps: "
          f"{flash_mod.flash_attention.copies - copies}")
    for name, us, k in rows[:15]:
        print(f"  {us / 1e3 / TRACED:9.3f} ms/step  {k // TRACED:5d}x/step"
              f"  {name[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

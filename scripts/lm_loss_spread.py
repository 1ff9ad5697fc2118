"""How far an LM config's step-1 loss moves between evaluations that
differ only by rounding, on the card: the spread that sets chip_smoke.py's
loss limits in phases 9 and 10.

    python3 scripts/lm_loss_spread.py [--arch recurrentgemma-2b]
        [--batch 1] [--seq 4096] [--layers N]

Draws the config at full width (`train_loop.init_params`, seed 0), cut to
`--layers` layers where given, and takes the first batch of the data
`launch.train` builds for it (`SyntheticLM` seed 0, with its context).
Computes the loss (no gradient) five times: through the kernels, the same
again, through the plain versions (`mode="ref"`), and through the plain
versions with every weight multiplied by (1 + eps N(0, 1)) for eps 1e-6
and 1e-5 (generator seed 5).
Prints the losses and each one's relative distance from the plain loss,
with the card's name and power limit.

Then the training run of `launch.train` (AdamW at its defaults over
`--train-steps` steps, the per-super-layer recompute on) twice from the
same weights and batches: through the kernels and through the plain
versions, each step's loss, gradient norm and learning rate side by side;
and, to tell a hard batch from a bad update, the loss of each of those
batches at the initial weights.  Needs one CUDA card.
"""
import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma-2b")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--train-steps", type=int, default=3)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config to this many layers (0: all)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("lm_loss_spread: no CUDA device", file=sys.stderr)
        return 2
    import dataclasses
    from repro_torch import configs as C
    from repro_torch.core.tree import tree_map
    from repro_torch.launch.train import data_for
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_loop as tl

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    cfg = C.get(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    params = tl.init_params(cfg, 0, dev)
    data = data_for(cfg, args.seq, args.batch)
    batch = {k: torch.from_numpy(a).to(dev)
             for k, a in data.batch(0).items()}

    @torch.no_grad()
    def loss(mode, ps):
        t = time.perf_counter()
        out = float(T.loss_fn(ps, batch, cfg, mode=mode))
        return out, time.perf_counter() - t

    runs = {"kernels": loss("auto", params),
            "kernels again": loss("auto", params),
            "plain": loss("ref", params)}
    gen = torch.Generator(device=dev).manual_seed(5)
    for eps in (1e-6, 1e-5):
        with torch.no_grad():
            pert = tree_map(lambda t: t * (1 + eps * torch.randn(
                t.shape, generator=gen, device=dev)), params)
        runs[f"plain, weights x (1 + {eps:g} N)"] = loss("ref", pert)
        del pert
    plain = runs["plain"][0]
    print(f"{cfg.name} ({cfg.n_layers} layers), batch {args.batch}, seq "
          f"{args.seq}; card {card}")
    for name, (value, sec) in runs.items():
        print(f"  {name:34s} {value:.7f}  rel {abs(value - plain) / plain:.3e}"
              f"  ({sec:.2f} s)")

    # the training run through both paths, and its batches at the initial
    # weights
    n = args.train_steps
    batches = [{k: torch.from_numpy(a).to(dev) for k, a in
                data.batch(i).items()} for i in range(n)]
    with torch.no_grad():
        at_init = [float(T.loss_fn(params, b, cfg)) for b in batches]
    print(f"  batches 0-{n - 1} at the initial weights (kernels): "
          + ", ".join(f"{x:.7f}" for x in at_init))
    del params, batch
    ocfg = opt.AdamWConfig(lr=3e-4, total_steps=n,
                           warmup_steps=max(n // 20, 5))
    trace = {}
    for mode in ("auto", "ref"):
        ps = tl.init_params(cfg, 0, dev)
        state = opt.init(ps)
        step = tl.make_train_step(cfg, ocfg, kernel_mode=mode)
        trace[mode] = []
        for b in batches:
            ps, state, m = step(ps, state, b)
            trace[mode].append((float(m["loss"]), float(m["grad_norm"]),
                                float(m["lr"])))
        del ps, state
        torch.cuda.empty_cache()
    print(f"  training, {n} AdamW steps (lr 3e-4, warmup {ocfg.warmup_steps}):"
          f" loss / grad norm / lr, kernels vs plain")
    for i, (k, r) in enumerate(zip(trace["auto"], trace["ref"])):
        print(f"    step {i + 1}: kernels {k[0]:.7f} / {k[1]:.6g} / {k[2]:.3g}"
              f"; plain {r[0]:.7f} / {r[1]:.6g} / {r[2]:.3g}; loss rel "
              f"{abs(k[0] - r[0]) / abs(r[0]):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""End-to-end training driver, as `repro.launch.train`.

  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-350m \\
      --steps 3 --batch 8 --seq 1024
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-350m \\
      --smoke --device cpu --steps 2 --batch 2 --seq 64

`--device` defaults to the card and raises without one; on the card the
mLSTM blocks run the CUDA kernels forward and backward, on the CPU their
plain versions.  Weights are random, drawn on the device from a generator
seeded with 0; the data is `SyntheticLM` seed 0.  AdamW runs at the
reference's defaults (warmup max(steps // 20, 5), cosine decay over
`--steps`).  `--ckpt-dir` raises: checkpointing is not ported yet.
"""
from __future__ import annotations

import argparse
import logging

from .. import configs as C
from ..data.tokens import Prefetcher, SyntheticLM
from ..train import optimizer as opt_mod
from ..train.train_loop import TrainConfig, train
from .serve import resolve_device


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--kernel-mode", default="auto")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    cfg = C.get(args.arch, smoke=args.smoke)
    dev = resolve_device(args.device)
    data = SyntheticLM(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        context_tokens=(args.seq // cfg.frontend_downsample if cfg.is_encdec
                        else cfg.n_context_tokens),
        d_model=cfg.d_model)
    tcfg = TrainConfig(
        steps=args.steps, checkpoint_dir=args.ckpt_dir,
        kernel_mode=args.kernel_mode,
        opt=opt_mod.AdamWConfig(lr=args.lr, total_steps=args.steps,
                                warmup_steps=max(args.steps // 20, 5)))
    pf = Prefetcher(data)
    try:
        out = train(cfg, pf, tcfg, device=dev)
    finally:
        pf.close()
    print(f"arch={cfg.name} steps={out['steps']} "
          f"loss {out['first_loss']:.4f} -> {out['final_loss']:.4f} "
          f"({out['wall_seconds']:.1f}s, stragglers={out['straggler_events']})")
    return out


if __name__ == "__main__":
    main()

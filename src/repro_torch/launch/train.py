"""End-to-end training driver, as `repro.launch.train`.

  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-350m \\
      --steps 3 --batch 8 --seq 1024
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-350m \\
      --smoke --device cpu --steps 2 --batch 2 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch recurrentgemma-2b --steps 3 --batch 1 --seq 4096
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch seamless-m4t-medium --smoke --device cpu --steps 2 --batch 2 \\
      --seq 64          # also moonshot-v1-16b-a3b, llama-3.2-vision-11b

`--arch` defaults to stablelm-1.6b.  `--device` defaults to the card and
raises without one; on the card the mLSTM blocks and attention (flash)
run the CUDA kernels forward and backward, on the CPU their plain
versions; each super-layer is recomputed in the backward, as the
reference's `remat=True` does.  Weights are random, drawn on the device
from a generator seeded with 0; the data is `SyntheticLM` seed 0, with a
context of seq // frontend_downsample frames for an encoder-decoder model
and n_context_tokens for a model with context tokens.  AdamW
runs at the reference's defaults (warmup max(steps // 20, 5), cosine
decay over `--steps`).  `--ckpt-dir` checkpoints every `--ckpt-every` steps (and at
a preemption and the end) and resumes from the latest checkpoint there,
with the data stream from the resumed step's batch.
"""
from __future__ import annotations

import argparse
import itertools
import logging

from .. import configs as C
from ..data.tokens import Prefetcher, SyntheticLM
from ..train import optimizer as opt_mod
from ..train.checkpoint import Checkpointer
from ..train.train_loop import TrainConfig, train
from .serve import resolve_device


def data_for(cfg, seq: int, batch: int, seed: int = 0) -> SyntheticLM:
    """The synthetic corpus for cfg, with a context of seq //
    frontend_downsample frames for an encoder-decoder model and of
    n_context_tokens for a model with context tokens."""
    return SyntheticLM(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=seed,
        context_tokens=(seq // cfg.frontend_downsample if cfg.is_encdec
                        else cfg.n_context_tokens),
        d_model=cfg.d_model)


def run(cfg, *, steps: int, batch: int, seq: int, device, lr: float = 3e-4,
        ckpt_dir: str | None = None, ckpt_every: int = 50,
        kernel_mode: str = "auto") -> dict:
    """Train cfg on `device` for `steps` steps (resuming from the latest
    checkpoint in `ckpt_dir`); `train_loop.train`'s summary."""
    data = data_for(cfg, seq, batch)
    start = 0
    if ckpt_dir:
        start = Checkpointer(ckpt_dir).latest_step() or 0
    tcfg = TrainConfig(
        steps=steps, checkpoint_every=ckpt_every, checkpoint_dir=ckpt_dir,
        kernel_mode=kernel_mode,
        opt=opt_mod.AdamWConfig(lr=lr, total_steps=steps,
                                warmup_steps=max(steps // 20, 5)))
    pf = Prefetcher(data.batch(s) for s in itertools.count(start))
    try:
        return train(cfg, pf, tcfg, device=device)
    finally:
        pf.close()


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
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--kernel-mode", default="auto")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    cfg = C.get(args.arch, smoke=args.smoke)
    out = run(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
              device=resolve_device(args.device), lr=args.lr,
              ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
              kernel_mode=args.kernel_mode)
    print(f"arch={cfg.name} steps={out['steps']} "
          f"loss {out['first_loss']:.4f} -> {out['final_loss']:.4f} "
          f"({out['wall_seconds']:.1f}s, stragglers={out['straggler_events']})")
    return out


if __name__ == "__main__":
    main()

"""End-to-end LM training example on the PyTorch port: train a reduced
(SMOKE) config for a few hundred steps with the port's substrate: AdamW,
the prefetching data pipeline, checkpointing, the preemption guard and
straggler detection.

  PYTHONPATH=src python examples/torch_train_lm.py [--arch stablelm-1.6b]
      [--steps 200] [--ckpt-dir /tmp/ckpt] [--device cpu]

The steps of examples/train_lm.py through `repro_torch`
(`launch.train.run`, at lr 1e-3).  It runs on the card unless `--device
cpu` asks for the CPU, where the kernels' plain versions run.  Kill it
mid-run and run it again with the same --ckpt-dir: it resumes from the
latest checkpoint there, with the data stream from the resumed step's
batch.
"""
import argparse
import logging

import repro_torch.configs as C
from repro_torch.launch import train as train_launch
from repro_torch.launch.serve import resolve_device
from repro_torch.train.checkpoint import Checkpointer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    cfg = C.get(args.arch, smoke=True)   # reduced config: CPU-trainable
    dev = resolve_device(args.device)
    start = Checkpointer(args.ckpt_dir).latest_step() if args.ckpt_dir \
        else None
    if start:
        print(f"resuming from step {start}")
    out = train_launch.run(cfg, steps=args.steps, batch=args.batch,
                           seq=args.seq, device=dev, lr=1e-3,
                           ckpt_dir=args.ckpt_dir)
    print(f"\narch={cfg.name}(smoke) steps={out['steps']} "
          f"loss {out['first_loss']:.4f} -> {out['final_loss']:.4f} "
          f"in {out['wall_seconds']:.1f}s")
    assert out["final_loss"] < out["first_loss"], "training must reduce loss"
    return out


if __name__ == "__main__":
    main()

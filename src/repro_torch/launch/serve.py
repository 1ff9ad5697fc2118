"""Batched serving driver: prefill (a teacher-forced cache build through
decode steps) and greedy token-by-token decode, as `repro.launch.serve`.

  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch llama-3.2-vision-11b --batch 4 --prompt-len 32 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch llama-3.2-vision-11b --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch moonshot-v1-16b-a3b --smoke --device cpu     # MoE
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch seamless-m4t-medium --smoke --device cpu     # encoder-decoder

`--device` defaults to the card and raises without one.  Weights are
random, drawn on the device from a seeded generator; the context (image
patch or audio frame embeddings) and the prompt come from numpy seed 0, as
in the reference.  The context goes straight in as the cross-attention
context, an encoder-decoder model's too: as in the reference, serving runs
no encoder.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from .. import configs as C
from ..models import transformer as T


@dataclasses.dataclass
class ServeRun:
    """What a run leaves behind: the tokens, the times and the last step's
    inputs (for a caller that repeats that step)."""

    cfg: object
    generated: np.ndarray        # [B, gen] token ids
    prefill_s: float
    decode_s: float
    tokens_per_s: float
    params: dict
    ctx: torch.Tensor | None
    last_state: dict             # state before the last decode step
    last_tokens: torch.Tensor    # its input tokens [B, 1]
    last_pos: int
    last_logits: torch.Tensor    # its logits [B, 1, V]


def resolve_device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    return dev


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def setup(cfg, batch: int, prompt_len: int, dev: torch.device,
          seed: int = 0) -> tuple[dict, torch.Tensor | None, torch.Tensor]:
    """A run's inputs: the weights (drawn on `dev` from a generator seeded
    with `seed`), the context [B, n_context_tokens, d_model] (None for a
    model without one) and the prompt [B, prompt_len], both from numpy
    seed `seed`."""
    params = T.init_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(seed))
    ctx = None
    if cfg.n_context_tokens:
        ctx = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (batch, cfg.n_context_tokens, cfg.d_model)).astype(np.float32)
        ).to(dev)
    prompt = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (batch, prompt_len))).to(dev)
    return params, ctx, prompt


def run(arch: str, *, smoke: bool = False, batch: int = 4,
        prompt_len: int = 32, gen: int = 16, kernel_mode: str = "auto",
        device: str = "cuda") -> ServeRun:
    """Serve one batch of random prompts with random weights (seed 0)."""
    return run_config(C.get(arch, smoke=smoke), batch=batch,
                      prompt_len=prompt_len, gen=gen,
                      kernel_mode=kernel_mode, device=device)


def run_config(cfg, *, batch: int = 4, prompt_len: int = 32, gen: int = 16,
               kernel_mode: str = "auto", device: str = "cuda") -> ServeRun:
    """`run` for a config given whole (one cut in depth, say)."""
    dev = resolve_device(device)
    params, ctx, prompt = setup(cfg, batch, prompt_len, dev)
    kv_len = prompt_len + gen

    def step(state, tok, pos):
        return T.decode_step(params, state, tok, pos, cfg, cross_ctx=ctx,
                             mode=kernel_mode)

    state = T.init_decode_state(cfg, batch, kv_len, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    for pos in range(prompt_len):
        tok_in, prev = prompt[:, pos:pos + 1], state
        logits, state = step(state, tok_in, pos)
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    last = (prev, tok_in, prompt_len - 1, logits)
    tok = logits[:, -1].argmax(-1)[:, None]
    out_toks = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        prev = state
        logits, state = step(state, tok, prompt_len + i)
        last = (prev, tok, prompt_len + i, logits)
        tok = logits[:, -1].argmax(-1)[:, None]
        out_toks.append(tok)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    generated = torch.cat(out_toks, dim=1).cpu().numpy()
    return ServeRun(cfg=cfg, generated=generated, prefill_s=prefill_s,
                    decode_s=decode_s,
                    tokens_per_s=batch * (gen - 1) / max(decode_s, 1e-9),
                    params=params, ctx=ctx, last_state=last[0],
                    last_tokens=last[1], last_pos=last[2],
                    last_logits=last[3])


def main(argv: list[str] | None = None) -> ServeRun:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--kernel-mode", default="auto")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    r = run(args.arch, smoke=args.smoke, batch=args.batch,
            prompt_len=args.prompt_len, gen=args.gen,
            kernel_mode=args.kernel_mode, device=args.device)
    print(f"arch={r.cfg.name} batch={args.batch} prefill={r.prefill_s:.2f}s "
          f"decode={r.decode_s:.2f}s ({r.tokens_per_s:.1f} tok/s)")
    print("sample generations (token ids):")
    for row in r.generated[:2]:
        print(" ", row[:12].tolist())
    return r


if __name__ == "__main__":
    main()

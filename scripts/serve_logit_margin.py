"""How far a serve step's logits move when its cross-attention is wrong,
against how far the flash kernel moves them: the margin that sets the
limit of `chip_smoke.py`'s phase-6 check.

    python3 scripts/serve_logit_margin.py

For weight seeds 0-3 it draws llama-3.2-vision-11b in full on the card
through `serve.setup` (batch 4, prompt 32), runs the teacher-forced prefill
through the flash kernel, and repeats the first decode step from the same
state:
  - through the flash kernel and through the plain attention: the sound
    reading is |kernel - plain| over the logits;
  - through the plain attention over the context with one of the kernel's
    key splits (`flash_attention.plan`) left out, for every split: what a
    kernel that drops that split would give (its merge never sees those
    keys).  The mutant reading is |dropped - plain|.
Each reading is given as the max and the mean over the B x vocab logits.
The logits are bf16 products, so the max moves in steps of one bf16
spacing (2^-5 at logits of size 4-8) and the mean separates the two kinds
of reading better.  Prints one line per seed and, last, a JSON line with
every reading.  Needs one CUDA card.
"""
import gc
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

ARCH, BATCH, PROMPT, SEEDS = "llama-3.2-vision-11b", 4, 32, (0, 1, 2, 3)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("serve_logit_margin: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import configs as C
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    dev = torch.device("cuda")
    cfg = C.get(ARCH)
    # the kernel's key splits at the serve shape
    tiles = flash_mod.plan(
        (BATCH, cfg.n_heads, 1, cfg.head_dim),
        (BATCH, cfg.n_kv_heads, cfg.n_context_tokens, cfg.head_dim),
        torch.bfloat16, causal=False).splits
    out = []
    for seed in SEEDS:
        params, ctx, prompt = serve.setup(cfg, BATCH, PROMPT, dev, seed)
        state = T.init_decode_state(cfg, BATCH, PROMPT + 1, device=dev)
        for pos in range(PROMPT):
            logits, state = T.decode_step(params, state,
                                          prompt[:, pos:pos + 1], pos, cfg,
                                          cross_ctx=ctx)
        tok = logits[:, -1].argmax(-1)[:, None]

        def step(c, mode):
            return T.decode_step(params, state, tok, PROMPT, cfg,
                                 cross_ctx=c, mode=mode)[0]

        plain = step(ctx, "ref")

        def reading(logits):
            d = (logits - plain).abs()
            return {"max": float(d.max()), "mean": float(d.mean())}

        sound = reading(step(ctx, "auto"))
        dropped = [reading(step(torch.cat([ctx[:, :a], ctx[:, b:]], 1), "ref"))
                   for a, b in tiles]
        out.append({"seed": seed, "sound": sound, "dropped_tile": dropped,
                    "max_abs_logit": float(plain.abs().max())})
        per_tile = {k: " ".join(f"{d[k]:.6g}" for d in dropped)
                    for k in ("max", "mean")}
        print(f"seed {seed}: |kernel - plain| max {sound['max']:.6g} mean "
              f"{sound['mean']:.6g}; |dropped - plain| per tile max "
              f"[{per_tile['max']}] mean [{per_tile['mean']}]; max|logit| "
              f"{out[-1]['max_abs_logit']:.6g}", flush=True)
        del params, ctx, state, logits, plain
        gc.collect()
        torch.cuda.empty_cache()
    for key in ("max", "mean"):
        print(f"{key} |delta logits|: sound, largest over seeds "
              f"{max(r['sound'][key] for r in out):.6g}; dropped tile, "
              f"smallest over seeds and tiles "
              f"{min(d[key] for r in out for d in r['dropped_tile']):.6g}")
    print(f"tiles {tiles}")
    print(json.dumps({"tiles": tiles, "readings": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

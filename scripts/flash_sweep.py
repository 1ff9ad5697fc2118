"""The flash kernel's design choices, measured against each other on the card.

    python3 scripts/flash_sweep.py

On one CUDA card, with inputs drawn from a seed:
  - the serve step (B 4, Hq 32, Hkv 8, Lk 1664, Dh 128, bf16; K/V with the
    strides the cross-attention's einsum leaves) through each body that
    can run that shape (decode, tensor_core, cuda_core), the decode body
    also with its K/V ring of DEC_STAGES 2 (as built) and 3 tiles, each at
    several split sizes, and scaled_dot_product_attention;
  - causal prefill 4096 and a 512-token chunk over 4096 (kv_offset 3584)
    on the tensor-core body built with P_TERMS 3 (as built), 2 and 1
    (bf16 terms of P in P V: what the precision of P costs).
The variants are this script's own: it edits the #defines of the kernel
source, builds each variant and launches it by a plan laid out here.
Each row gives the device time per call (torch.profiler, summed kernel
time), the span per call of 20 calls replayed from a CUDA graph (no host
work, but the gaps between a call's kernels counted), the host-clock time
per call back to back (CUDA events, as chip_smoke.py's `cuda_ms`), the
library call's kernel names, the worst |kernel - plain| / limit with the
limit of chip_smoke.py's `flash_limit` (one bf16 spacing), and how many
outputs break it.  Prints one line per row, then the card and a JSON line
with every row.  Needs one CUDA card.
"""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

SEED, REPS = 0, 20


def main() -> int:
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("flash_sweep: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as fm

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED)

    def device_us(fn):
        """Summed kernel time per call, and the kernels' names."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
        return (sum(e.device_time_total for e in ev) / REPS,
                sorted(e.key[:60] for e in ev))

    def graph_us(fn):
        """Span per call of REPS calls captured in a CUDA graph, replayed."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):   # warm-up on the capturing stream
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=side):
            for _ in range(REPS):
                fn()
        g.replay()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        g.replay()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / REPS * 1e3

    def host_ms(fn):
        fn()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(REPS):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / REPS

    def accuracy(got, want):
        d = (got.float() - want.float()).abs()
        lim = 2 * 2.0 ** -8 * want.float().abs() + 1e-6
        return float((d / lim).max()), int((d > lim).sum())

    rows = []

    def variant(dh, **defines):
        """The library built with `defines` (name: value) in place of the
        source's own #defines."""
        src = fm.source(dh)
        for name, val in defines.items():
            line = next(ln for ln in src.splitlines()
                        if ln.startswith(f"#define {name} "))
            src = src.replace(line, f"#define {name} {val}", 1)
        return build.load("flash_attention", src, fm._ARGTYPES).launch

    def launcher(q, k, v, p, launch, **kw):
        aligned = tuple(t.data_ptr() % 16 == 0 for t in (q, k, v))
        call = fm._make_call(p, (q.shape, k.shape, v.shape),
                             (q.stride(), k.stride(), v.stride()), q.dtype,
                             aligned, scale=None, launch=launch, **kw)
        return lambda: fm._run(q, k, v, call, False)[0]

    def split(p, keys):
        """Plan p with its keys cut into splits of `keys`."""
        n = -(-p.kv_end // keys)
        return dataclasses.replace(
            p, split_keys=keys, grid=(p.pos_tiles * p.head_tiles * n,
                                      *p.grid[1:]),
            splits=tuple((s * keys, min((s + 1) * keys, p.kv_end))
                         for s in range(n)))

    def row(name, fn, want=None, graph=False):
        dev_us, kernels = device_us(fn)
        r = {"row": name, "device_us": dev_us, "host_ms": host_ms(fn)}
        if graph:
            r["graph_us"] = graph_us(fn)
        if want is None:
            r["kernels"] = kernels
        else:
            r["worst_err_over_limit"], r["outputs_over_limit"] = accuracy(
                fn(), want)
        rows.append(r)
        print(json.dumps(r), flush=True)

    # the serve step, K/V as the cross-attention's einsum leaves them
    ctx = torch.randn((4, 1664, 4096), generator=gen).to(dev, torch.bfloat16)
    w = (torch.randn((4096, 8, 128), generator=gen) * 4096 ** -0.5).to(
        dev, torch.bfloat16)
    k = torch.einsum("bld,dhk->bhlk", ctx, w)
    v = torch.einsum("bld,dhk->bhlk", ctx, w * 0.5)
    q = torch.randn((4, 32, 1, 128), generator=gen).to(dev, torch.bfloat16)
    kw = dict(causal=False, kv_offset=0)
    want = ref.flash_attention(q, k, v, **kw)
    strides = (q.stride(), k.stride(), v.stride())
    built = variant(128)
    for body in ("decode", "tensor_core", "cuda_core"):
        p = fm._layout(body, q.shape, k.shape, q.dtype, strides=strides,
                       **kw)
        row(f"serve step, {body} body, {p.ctas} CTAs, {len(p.splits)} "
            f"splits", launcher(q, k, v, p, built, **kw), want)
    p = fm.plan(q.shape, k.shape, q.dtype, strides=strides, **kw)
    for stages in (2, 3):
        launch = built if stages == fm.DEC_STAGES else variant(
            128, DEC_STAGES=stages)
        # the ring's stages, Q and the mbarriers (as plan counts them)
        ps = dataclasses.replace(p, stages=stages, smem=(
            (stages * 2 * fm.TC_BN + fm.DECODE_ROWS) * 128 * 2 + 8 * stages))
        for keys in (128, 192, 256, 384, 1664):
            pk = split(ps, keys)
            row(f"serve step, decode body, DEC_STAGES {stages}, "
                f"{len(pk.splits)} splits of {keys} keys, {pk.ctas} CTAs",
                launcher(q, k, v, pk, launch, **kw), want, graph=True)
    row("serve step, scaled_dot_product_attention",
        lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True),
        graph=True)

    # prefill on the tensor-core body, build variants
    for name, lq, off in (("causal prefill 4096", 4096, 0),
                          ("512-token chunk over 4096", 512, 3584)):
        q = torch.randn((1, 32, lq, 128), generator=gen).to(dev, torch.bfloat16)
        k, v = (torch.randn((1, 8, 4096, 128), generator=gen)
                .to(dev, torch.bfloat16) for _ in range(2))
        kw = dict(causal=True, kv_offset=off)
        want = ref.flash_attention(q, k, v, **kw)
        p = fm.plan(q.shape, k.shape, q.dtype, **kw)
        for terms in (3, 2, 1):
            launch = built if terms == 3 else variant(128, P_TERMS=terms)
            row(f"{name}, tensor_core body, P_TERMS {terms}"
                + (" (as built)" if terms == 3 else ""),
                launcher(q, k, v, p, launch, **kw), want)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    print(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

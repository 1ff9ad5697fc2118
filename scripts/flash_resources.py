"""Registers, spills and shared memory of the flash attention kernels, and
the CTAs an SM that they allow, as nvcc reports them.

Compiles csrc/flash_attention.cu (at the head dimensions given) and
csrc/flash_attention_bwd.cu with the build's own flags plus
`--resource-usage`, prints ptxas's line for each kernel, and beside it
the plan's dynamic shared memory and the CTAs an H100 SM holds by
registers (65,536 a SM, allocated in warps of 256) and by shared memory
(228 KB a SM, 1 KB reserved a CTA).  Needs nvcc (the machine with the
card); builds into build/flash_resources/.

    python3 scripts/flash_resources.py [--dh 64 128 256]
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SM_REGS, SM_SMEM, CTA_RESERVED = 65536, 228 * 1024, 1024


def compile_report(name: str, source: str) -> list[tuple[str, str]]:
    """(kernel, ptxas line) for each kernel of `source`."""
    from repro_torch.kernels import build
    out_dir = ROOT / "build" / "flash_resources"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f"{name}.cu"
    src.write_text(source)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS,
                           "--resource-usage", "-o",
                           str(out_dir / f"{name}.so"), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    lines = (proc.stdout + proc.stderr).splitlines()
    rows, kernel = [], None
    for line in lines:
        m = re.search(r"Function properties for (\S+)|Compiling entry "
                      r"function '(\S+)'", line)
        if m:
            kernel = m.group(1) or m.group(2)
        if "Used" in line and "registers" in line and kernel:
            rows.append((kernel, line.split("info    :")[-1].strip()))
        if "spill" in line and kernel:
            rows.append((kernel, line.strip()))
    return rows


def ctas_per_sm(regs: int, threads: int, smem: int) -> int:
    warps = -(-threads // 32)
    by_regs = SM_REGS // (-(-regs * 32 // 256) * 256 * warps)
    by_smem = SM_SMEM // (smem + CTA_RESERVED)
    return min(by_regs, by_smem)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dh", type=int, nargs="+", default=[64, 128, 256])
    args = ap.parse_args(argv)
    import torch
    from repro_torch.kernels import flash_attention as fm
    for dh in args.dh:
        fwd = fm.plan((2, 10, 2048, dh), (2, 1, 4096, dh), torch.bfloat16,
                      causal=True, kv_offset=2048)
        bwd = fm.bwd_plan((2, 10, 2048, dh), (2, 1, 4096, dh), causal=True,
                          kv_offset=2048)
        smem = {"flash_tc": (fwd.smem, fwd.threads),
                "flash_bwd_dq": (bwd.smem_dq, fm.BWD_THREADS),
                "flash_bwd_dkv": (bwd.smem_dkv, fm.BWD_THREADS)}
        for name, source in (("flash_attention", fm.source(dh)),
                             ("flash_attention_bwd", fm.bwd_source(dh))):
            for kernel, line in compile_report(f"{name}_{dh}", source):
                # mangled names: the name's length, the name, its arguments
                short = next((k for k in smem
                              if re.search(rf"\d{k}\d", kernel)), None)
                note = ""
                m = re.search(r"Used (\d+) registers", line)
                if short and m:
                    sm, th = smem[short]
                    note = (f"; plan smem {sm} B, {th} threads -> "
                            f"{ctas_per_sm(int(m.group(1)), th, sm)} CTA(s) "
                            f"an SM")
                print(f"Dh {dh} {name}: {kernel}: {line}{note}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

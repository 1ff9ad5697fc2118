"""Build the port's CUDA kernels with nvcc at first use and load them.

Each kernel is one `.cu` source under `src/repro_torch/csrc/` with a plain C
entry point (`launch`), optionally specialised by generated text (the UDF
code from `kernels/udf.py` and a few #defines).  `template` inlines the
headers a source includes from `csrc/` (`segorder.cuh`), so the full source
text, headers and all, keys the build: it lands in `build/repro_torch/<name>-<hash>/` at the repository
root, so a content change rebuilds and an unchanged kernel is reused.
Libraries load with ctypes; nothing here includes PyTorch's headers, so a
build takes seconds.

`prebuild` compiles many sources at once, one nvcc process each, all
started together (the per-call build cost counts against a run's limit).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_loaded: dict[tuple[str, str], ctypes.CDLL] = {}


_INCLUDE = re.compile(r'^#include "(\w+\.cuh)"$', re.M)


def template(name: str) -> str:
    """Text of csrc/<name>.cu with each `#include "<header>.cuh"` of csrc/
    replaced by the header's text (a header edit changes the build key)."""
    return _INCLUDE.sub(lambda m: (CSRC / m.group(1)).read_text(),
                        (CSRC / f"{name}.cu").read_text())


def _nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                           "machine with the CUDA toolkit")
    return exe


def _target(name: str, source: str) -> Path:
    key = hashlib.sha256((source + " ".join(NVCC_FLAGS)).encode()).hexdigest()
    return BUILD_ROOT / f"{name}-{key[:16]}"


def _start(name: str, source: str):
    """Start nvcc for one source unless its library exists; returns
    (Popen, target dir) or None."""
    d = _target(name, source)
    if (d / "lib.so").exists():
        return None
    d.mkdir(parents=True, exist_ok=True)
    (d / "kernel.cu").write_text(source)
    tmp = d / f"lib.{os.getpid()}.so"
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                             str(d / "kernel.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, d, tmp


def _finish(job) -> None:
    proc, d, tmp = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {d.name}:\n{out}")
    os.replace(tmp, d / "lib.so")


def prebuild(sources: list[tuple[str, str]]) -> None:
    """Compile every (name, source) whose library is missing, in parallel
    (each distinct source once)."""
    jobs = [j for j in (_start(n, s) for n, s in dict.fromkeys(sources))
            if j is not None]
    errors = []
    for job in jobs:
        try:
            _finish(job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str, source: str, argtypes: list) -> ctypes.CDLL:
    """Build (if needed) and load the library of `source`; its `launch`
    entry gets `argtypes` and returns the cudaError_t of the launch."""
    return load_entries(name, source, {"launch": argtypes})


def load_entries(name: str, source: str,
                 entries: dict[str, list]) -> ctypes.CDLL:
    """`load` for a library with several entry points: each named C
    function gets its argtypes and returns an int (a cudaError_t)."""
    lib = _loaded.get((name, source))
    if lib is None:
        job = _start(name, source)
        if job is not None:
            _finish(job)
        lib = ctypes.CDLL(str(_target(name, source) / "lib.so"))
        for fn, argtypes in entries.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[(name, source)] = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {name} failed with error {err}")


def check_arg(kernel: str, t, dtype, shape, name: str) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of this dtype and shape."""
    if t.device.type != "cuda" or t.dtype != dtype or not t.is_contiguous() \
            or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} must be a contiguous CUDA {dtype} "
                         f"tensor of shape {tuple(shape)}, got {t.device} "
                         f"{t.dtype} {tuple(t.shape)}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

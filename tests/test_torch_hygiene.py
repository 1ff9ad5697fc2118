"""Import hygiene and device rules of the PyTorch port.

The port, chip_smoke.py and the torch examples import neither jax nor the
reference package, and the engine never quietly runs on the CPU: without a
CUDA device a graph built with no explicit device is an error.
"""
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _modules():
    import repro_torch
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_port_imports_neither_jax_nor_reference():
    mods = _modules()
    for m in ("repro_torch.core.mrtriplets", "repro_torch.core.wire",
              "repro_torch.kernels.mlstm",
              "repro_torch.kernels.spmv", "repro_torch.models.recurrent",
              "repro_torch.train.optimizer", "repro_torch.train.fault",
              "repro_torch.train.train_loop", "repro_torch.data.tokens",
              "repro_torch.launch.train"):
        assert m in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'repro' or m.startswith('repro.')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")] + ["chip_smoke.py"]
    + [str(p.relative_to(ROOT))
       for p in (ROOT / "examples").glob("torch_*.py")]))
def test_sources_do_not_name_jax_or_reference(path):
    text = (ROOT / path).read_text()
    for pat in (r"\bimport jax\b", r"\bfrom jax\b", r"\bfrom repro\.",
                r"\bimport repro\b", r"\bfrom repro import\b"):
        assert not re.search(pat, text), (path, pat)


def test_default_device_without_cuda_raises(monkeypatch):
    from repro_torch.core import Graph
    from repro_torch.data import rmat
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gd = rmat(5, 4, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Graph.from_edges(gd.src, gd.dst, num_partitions=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Graph.from_edges(gd.src, gd.dst, num_partitions=4, device="cuda")
    g = Graph.from_edges(gd.src, gd.dst, num_partitions=4, device="cpu")
    assert g.device.type == "cpu"


def test_train_default_device_without_cuda_raises(monkeypatch):
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "xlstm-350m", "--smoke", "--steps", "1"])


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Run alone, or on a machine without a card, chip_smoke.py fails and
    prints no result line."""
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    for cwd in (tmp_path, ROOT):
        if torch.cuda.is_available() and cwd == ROOT:
            continue
        out = subprocess.run([sys.executable, str(cwd / "chip_smoke.py")],
                             capture_output=True, text=True, timeout=120,
                             cwd=cwd)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout

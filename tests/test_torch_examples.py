"""The PyTorch examples print the JAX examples' lines.

examples/torch_quickstart.py, torch_wikipedia_pipeline.py and
torch_graph_coarsen.py run on the CPU (device "cpu") and must print what
examples/quickstart.py, wikipedia_pipeline.py and graph_coarsen.py print,
line for line; only the seconds the pipeline's stage and end-to-end lines
report are masked.
"""
import importlib.util
import re
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _masked(text):
    return [re.sub(r"\d+\.\d+", "<s>", ln)
            if ln.startswith(("[stage", "end-to-end")) else ln
            for ln in text.splitlines()]


@pytest.mark.parametrize("name", ["quickstart", "wikipedia_pipeline",
                                  "graph_coarsen"])
def test_torch_example_prints_the_jax_examples_lines(name, capsys,
                                                     monkeypatch):
    monkeypatch.setattr(sys, "argv", [f"{name}.py"])
    _load(name).main()
    want = capsys.readouterr().out
    _load(f"torch_{name}").main(device="cpu")
    got = capsys.readouterr().out
    assert len(_masked(want)) > 5
    assert _masked(got) == _masked(want)


def test_torch_quickstart_lines():
    """The lines the quickstart prints on the CPU (the JAX quickstart's)."""
    import subprocess
    root = EXAMPLES.parent
    out = subprocess.run(
        [sys.executable, str(EXAMPLES / "torch_quickstart.py"), "--device",
         "cpu"], capture_output=True, text=True, timeout=300, cwd=root,
        env={"PYTHONPATH": str(root / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == [
        "graph: 1024 vertices, 6716 edges",
        "vertices over 40: 583",
        "mrTriplets join arity after elimination: 3 (UDF reads both "
        "endpoints -> 3-way)",
        "subgraph shares structure with parent: True",
        "top-5 by PageRank: [0, 1, 256, 128, 2]",
        "connected components: 1 (in 4 supersteps)",
        "triangles: 24411"]

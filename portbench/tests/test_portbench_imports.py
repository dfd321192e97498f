"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference takes nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

from portbench import harness

REPO = harness.ROOT.parent


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "vfisr_tpu_torch_lookalike", sys)
    monkeypatch.delitem(sys.modules, "vfisr_tpu", raising=False)
    assert "vfisr_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "vfisr_tpu.core", sys)
    assert "vfisr_tpu" in harness.forbidden_modules()


def test_a_run_loads_no_jax():
    """Everything a run imports, in a fresh process."""
    code = ("import portbench.run, portbench.control\n"
            "from portbench import harness\n"
            "for c in ('flagship.streams4', 'adaptive.hard'):\n"
            "    cell = harness.find_cell(c)\n"
            "    harness.count_steps(cell)\n"
            "import vfisr_tpu_torch.pipeline.flagship, vfisr_tpu_torch.pipeline.streaming\n"
            "import vfisr_tpu_torch.models.novel.adaptive_pipeline, vfisr_tpu_torch.models.sota.vfimamba\n"
            "harness.metric_readers()\n"
            "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_nothing_of_the_program():
    for path in sorted((harness.ROOT / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("vfisr_tpu_torch", "vfisr_tpu", "jax", "flax"), (
                    f"{path.name} imports {n}")

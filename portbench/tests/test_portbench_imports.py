"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names (``mh_tpu_torch`` begins with ``mh_tpu``),
and the reference and the counts load nothing of the program."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "portbench"
JAX = {"jax", "jaxlib", "flax", "mh_tpu"}
YARDSTICK = ["reference", "counts", "judge.py", "trace.py"]


def top_level_imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def harness_files():
    return [p for p in PKG.rglob("*.py") if "tests" not in p.relative_to(PKG).parts]


@pytest.mark.parametrize("path", harness_files(), ids=lambda p: str(p.relative_to(PKG)))
def test_no_harness_file_imports_jax(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize("part", YARDSTICK)
def test_the_yardstick_imports_nothing_of_the_program(part):
    paths = [PKG / part] if part.endswith(".py") else sorted((PKG / part).rglob("*.py"))
    for p in paths:
        assert "mh_tpu_torch" not in top_level_imports(p), p


def loaded_after(code: str) -> set[str]:
    """Top-level names in ``sys.modules`` after ``code`` runs in a fresh
    interpreter at the root of the repository."""
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
                          "sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_whole_run_loads_no_jax():
    loaded = loaded_after(
        "import json, torch\n"
        "from portbench import run\n"
        "from portbench.tests import toys\n"
        "bench = json.load(open('BENCHMARK.json'))\n"
        "for mix in ('batch', 'tempering'):\n"
        "    for trace in (False, True):\n"
        "        c = toys.cell('x', toys.config(8), toys.traffic(mix), bench['end_to_end'],"
        " bench['per_layer'])\n"
        "        assert run.run_cell(c, 5, 0.1, trace, 'cpu')['correct']\n"
        "for m in bench['end_to_end'] + bench['per_layer']:\n"
        "    run.load_reader(m['name'])\n")
    assert "mh_tpu_torch" in loaded and not loaded & JAX


def test_the_reference_loads_nothing_of_the_program():
    loaded = loaded_after("import portbench.reference.engine, portbench.reference.fused, "
                          "portbench.counts.fused_single, portbench.judge, portbench.trace")
    assert "torch" in loaded and not loaded & (JAX | {"mh_tpu_torch"})

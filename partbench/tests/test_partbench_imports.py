"""Nothing the harness or the reference imports is JAX or the JAX package.

Top-level names are compared whole: the port, ``repro_torch``, begins with
the JAX package's name, ``repro``, and is allowed."""
import ast
import json
import pathlib
import subprocess
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_sources_import_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not imported(path) & (FORBIDDEN | {"repro_torch"})


def test_loaded_modules_after_a_run():
    """A whole CPU run in a fresh process (the harness's own imports, the
    port's, the reference's and the metric readers') leaves no JAX module
    loaded, and `forbidden_modules` sees one that is."""
    code = f"""
import json, sys
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
from partbench import harness
cell = harness.load_cell("ok-k8.spinner")
cell.config["graph"].update(n=600, m=5000, n_comm=4)
harness.execute(cell, 3, 0.2, True, device="cpu")
found = harness.forbidden_modules()
import types
sys.modules["repro.core"] = types.ModuleType("repro.core")
print(json.dumps([found, harness.forbidden_modules()]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    found, planted = json.loads(out.stdout.strip().splitlines()[-1])
    assert found == []
    assert planted == ["repro"]


def test_cli_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run([sys.executable, "partbench/run.py", "--workload", "ok-k8.revolver",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""

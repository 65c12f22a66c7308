"""The module check compares whole top-level names; the reference imports
nothing of the program, of JAX or of the JAX package."""

import ast
import json
import subprocess
import sys
import types

from conftest import BENCH
from benchlib import harness

BANNED = {"cra5_tpu_torch", "cra5_tpu", "jax", "jaxlib", "flax", "optax"}


def test_module_check_fails_on_jax_and_passes_the_port(monkeypatch):
    monkeypatch.setitem(sys.modules, "cra5_tpu_torch", types.ModuleType("cra5_tpu_torch"))
    monkeypatch.setitem(sys.modules, "cra5_tpu_torchx.y", types.ModuleType("cra5_tpu_torchx.y"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "cra5_tpu.models", types.ModuleType("cra5_tpu.models"))
    assert harness.forbidden_modules() == ["cra5_tpu", "jax"]


def test_a_run_that_loaded_jax_prints_no_result(monkeypatch, capsys):
    line = {"correct": True, "checks": {}}
    monkeypatch.setattr(harness, "run", lambda *a, **k: line)
    args = types.SimpleNamespace(workload="w", seed=1, seconds=1.0, trace=0)
    assert harness.main(args, 0.0) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == line
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert harness.main(args, 0.0) == 4
    assert capsys.readouterr().out == ""


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                     else [])
            assert not {n.split(".")[0] for n in names} & BANNED, (path.name, names)
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import reference.model, reference.train, reference.crx2, reference.tables, "
            "reference.lowp; print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code, str(BENCH)], capture_output=True,
                         text=True, check=True).stdout
    assert not set(eval(out)) & BANNED

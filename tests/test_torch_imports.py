"""Import hygiene of the port: no module under src/repro_torch/, not
chip_smoke.py and not the port's examples (examples/*_torch.py) imports
JAX or any module of the reference package `repro` (the port keeps its own
copy of whatever it needs from there)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "examples").glob("*_torch.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:                      # relative: inside the port
                continue
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


def test_the_port_has_modules_to_check():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "src/repro_torch/models/model.py" in names
    assert "src/repro_torch/kernels/flash_attention.py" in names
    assert "chip_smoke.py" in names
    assert {"examples/train_100m_torch.py", "examples/quickstart_torch.py",
            "examples/replicated_kv_store_torch.py",
            "examples/fair_exchange_torch.py",
            "examples/replicated_serving_torch.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT)
                         .as_posix())
def test_module_imports_neither_jax_nor_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, mod) for line, mod in _imported_modules(tree)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_check_catches_each_import_form():
    src = ("import jax.numpy as jnp\nfrom repro.models import model\n"
           "import importlib\nimportlib.import_module('repro.core')\n"
           "__import__('jaxlib')\nimport repro_torch\n")
    found = [mod for _, mod in _imported_modules(ast.parse(src))
             if mod.split(".")[0] in FORBIDDEN]
    assert found == ["jax.numpy", "repro.models", "repro.core", "jaxlib"]

"""The port stands alone: no module of ``src/repro_torch/`` and not
``chip_smoke.py`` imports ``jax`` or the reference package ``repro`` (its
numpy-only modules included).  Only the tests import both."""

import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro"}
TEXT = re.compile(r"^\s*(?:from|import)\s+(?:jax|jaxlib|repro)(?:\.|\s|,|$)",
                  re.M)


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_neither_jax_nor_the_reference(path):
    text = path.read_text()
    bad = FORBIDDEN & set(_imported_roots(ast.parse(text)))
    assert not bad, f"{path.name} imports {sorted(bad)}"
    assert not TEXT.search(text), f"{path.name} has a jax/repro import line"


def test_the_scan_covers_the_package():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert "src/repro_torch/kernels/ops.py" in names
    for module in ("kernels/moe_gemm.py", "kernels/block_attn.py",
                   "kernels/ref.py", "models/moe.py",
                   "configs/granite_moe_3b.py", "kernels/autotune.py",
                   "kernels/reorder.py", "core/formats.py"):
        assert f"src/repro_torch/{module}" in names
    assert "chip_smoke.py" in names
    assert len(names) >= 15

"""The port stands alone: no module of ``src/repro_torch/`` and not
``chip_smoke.py`` imports ``jax`` or the reference package ``repro`` (its
numpy-only modules included).  Only the tests import both.  And the port
exports what the reference exports: every name in a reference package's
``__all__`` is in its port counterpart's."""

import ast
import importlib
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro"}
REFERENCE_PACKAGES = sorted(
    ".".join(p.parent.relative_to(ROOT / "src").parts)
    for p in (ROOT / "src" / "repro").rglob("__init__.py"))
# names a reference package exports that only mean something under JAX
# (none today: the JAX-only helpers, the ``*_pallas`` kernels,
# ``tpu_compiler_params`` and ``split_trainable`` / ``merge_trainable``,
# live in modules, not in a package's ``__all__``)
JAX_ONLY: dict = {}
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
    for name in ("__init__", "quickstart", "accelerator_sim", "serve_lm",
                 "train_lm"):
        assert f"src/repro_torch/examples/{name}.py" in names
    assert "chip_smoke.py" in names
    assert len(names) >= 15


@pytest.mark.parametrize("package", REFERENCE_PACKAGES)
def test_the_port_exports_what_the_reference_exports(package):
    reference = importlib.import_module(package)
    port = importlib.import_module(package.replace("repro", "repro_torch",
                                                   1))
    want = set(getattr(reference, "__all__", ())) - JAX_ONLY.get(package,
                                                                 set())
    missing = want - set(port.__all__)
    assert not missing, f"{port.__name__} does not export {sorted(missing)}"
    for name in want:
        assert hasattr(port, name), name

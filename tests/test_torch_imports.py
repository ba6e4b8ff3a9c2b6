"""The port stands alone: no module of ``isoforest_tpu_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package (``isoforest_tpu``), not
even a module of it that does not import JAX. Checked on the source with
``ast``, so a lazy import inside a function counts too."""

from __future__ import annotations

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "isoforest_tpu")
SOURCES = sorted((ROOT / "isoforest_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_roots(path: pathlib.Path) -> set:
    """Top-level package of every absolute import in the file."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_jax_package(path):
    bad = imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_the_check_sees_the_forbidden_imports(tmp_path):
    """The root of ``isoforest_tpu.x`` is ``isoforest_tpu``, and the port's
    own name is not mistaken for it."""
    probe = tmp_path / "probe.py"
    probe.write_text(
        "import jax.numpy as jnp\n"
        "def f():\n    from isoforest_tpu.ops import traversal\n"
        "from isoforest_tpu_torch import load_model\nfrom . import sibling\n"
    )
    assert imported_roots(probe) & set(FORBIDDEN) == {"jax", "isoforest_tpu"}
    assert "isoforest_tpu_torch" in imported_roots(probe)


# modules copied from numpy-only or stdlib-only modules of the JAX package:
# each keeps its own copy, and imports nothing of the JAX package either
STANDALONE_COPIES = ("lifecycle/__init__.py", "lifecycle/window.py", "lifecycle/validation.py",
                     "lifecycle/manager.py", "resilience/retry.py", "sklearn.py")


@pytest.mark.parametrize("name", STANDALONE_COPIES)
def test_the_lifecycle_slices_modules_are_checked(name):
    path = ROOT / "isoforest_tpu_torch" / name
    assert path in SOURCES
    assert not imported_roots(path) & set(FORBIDDEN)


def test_chip_smoke_does_not_need_scikit_learn():
    """The card's machine has not been shown to have scikit-learn: the smoke
    imports neither it nor the adapter."""
    source = (ROOT / "chip_smoke.py").read_text()
    assert "sklearn" not in imported_roots(ROOT / "chip_smoke.py")
    assert "isoforest_tpu_torch.sklearn" not in source and "import sklearn" not in source

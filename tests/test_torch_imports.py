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

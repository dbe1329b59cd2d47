"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program: top-level names compared
whole (``emcid_torch`` begins with the JAX package's name)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "emcid_tpu"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(ROOT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize("path", sorted((ROOT / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_reference_stands_alone(path):
    assert "emcid_torch" not in top_level_imports(path)


def test_prefix_is_not_a_match(tmp_path):
    p = tmp_path / "probe.py"
    p.write_text("import emcid_torch.models\nfrom emcid_torch import x\n")
    assert top_level_imports(p) == {"emcid_torch"}
    assert not top_level_imports(p) & JAX

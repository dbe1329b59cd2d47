"""Import hygiene of the PyTorch port: ``emcid_torch`` and ``chip_smoke.py``
use no JAX and nothing of the JAX package (any ``emcid_tpu`` import runs
``emcid_tpu/__init__.py``, which imports jax)."""

import ast
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "emcid_tpu")

_PROBE = """
import importlib, json, pkgutil, sys
import emcid_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    emcid_torch.__path__, "emcid_torch."))
for name in names:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in {forbidden!r})
print(json.dumps({{"modules": names, "forbidden": loaded}}))
"""


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_modules_import_without_jax():
    """Every module of the package, imported in a fresh interpreter, leaves
    no JAX or JAX-package module in ``sys.modules``."""
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(forbidden=set(FORBIDDEN))],
        cwd=REPO, capture_output=True, text=True, timeout=300, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(result["modules"]) >= 54, result["modules"]
    assert {"emcid_torch.cli", "emcid_torch.cli.run_emcid",
            "emcid_torch.ops.groupnorm", "emcid_torch.ops.layernorm",
            "emcid_torch.engine.fim", "emcid_torch.engine.compute_z_variants",
            "emcid_torch.engine.uce", "emcid_torch.models.vision",
            # the ICEB evaluation path and the rest of M9
            "emcid_torch.cli.workflows", "emcid_torch.evals",
            "emcid_torch.evals.summary", "emcid_torch.evals.scorers",
            "emcid_torch.evals.iceb", "emcid_torch.evals.rectification",
            "emcid_torch.evals.debias_eval", "emcid_torch.evals.debias_shared",
            "emcid_torch.engine.debias", "emcid_torch.engine.clip_edit",
            "emcid_torch.dsets.iceb", "emcid_torch.dsets.debias",
            "emcid_torch.dsets.construction", "emcid_torch.dsets.artists",
            "emcid_torch.dsets.coco", "emcid_torch.dsets.global_concepts",
            "emcid_torch.dsets.timed_road",
            # the UNet edit modes
            "emcid_torch.engine.cross_attn", "emcid_torch.engine.unet_edit",
            "emcid_torch.engine.unet_stats",
            } <= set(result["modules"])
    assert result["forbidden"] == []


@pytest.mark.parametrize("source", sorted(
    str(p.relative_to(REPO))
    for p in [REPO / "chip_smoke.py", *(REPO / "emcid_torch").rglob("*.py")]))
def test_source_imports_no_jax(source):
    """No import statement, at any depth (function-local ones included),
    names JAX or the JAX package."""
    roots = set(_imported_roots(REPO / source))
    assert not roots & set(FORBIDDEN), (source, roots & set(FORBIDDEN))

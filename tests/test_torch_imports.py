"""Import hygiene of the PyTorch port: ``emcid_torch`` and ``chip_smoke.py``
use no JAX and nothing of the JAX package (any ``emcid_tpu`` import runs
``emcid_tpu/__init__.py``, which imports jax), and no module of the port
imports ``transformers``, ``open_clip`` or ``matplotlib`` when it is
imported (the card's machine may have none of them)."""

import ast
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "emcid_tpu")
# imported inside the functions that need them, never at module level
LAZY = ("transformers", "open_clip", "matplotlib")

_PROBE = """
import importlib, json, pkgutil, sys
import emcid_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    emcid_torch.__path__, "emcid_torch."))
for name in names:
    importlib.import_module(name)
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in {forbidden!r})
lazy = sorted(m for m in sys.modules if m.split(".")[0] in {lazy!r})
print(json.dumps({{"modules": names, "forbidden": loaded, "lazy": lazy}}))
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
    no JAX or JAX-package module, and none of ``LAZY``, in
    ``sys.modules``."""
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(forbidden=set(FORBIDDEN),
                                             lazy=set(LAZY))],
        cwd=REPO, capture_output=True, text=True, timeout=300, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(result["modules"]) >= 75, result["modules"]
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
            # the preservation and single-concept benchmarks
            "emcid_torch.stats.extras", "emcid_torch.models.inception",
            "emcid_torch.models.lpips", "emcid_torch.evals.coco_eval",
            "emcid_torch.evals.artists_eval", "emcid_torch.evals.i2p_eval",
            "emcid_torch.evals.refact_benchmark",
            # causal tracing, BLIP, the experiments, the figures and the
            # checkpoint validators
            "emcid_torch.text.wordpiece", "emcid_torch.models.blip",
            "emcid_torch.evals.blip", "emcid_torch.evals.folder_sweep",
            "emcid_torch.evals.mixed_safety", "emcid_torch.evals.plotting",
            "emcid_torch.interp", "emcid_torch.interp.causal_trace",
            "emcid_torch.experiments", "emcid_torch.experiments.finetune",
            "emcid_torch.experiments.sequential",
            "emcid_torch.experiments.ablation",
            "emcid_torch.models.convert_openclip", "emcid_torch.cli.validate",
            } <= set(result["modules"])
    assert result["forbidden"] == []
    assert result["lazy"] == []


@pytest.mark.parametrize("source", sorted(
    str(p.relative_to(REPO))
    for p in [REPO / "chip_smoke.py", *(REPO / "emcid_torch").rglob("*.py")]))
def test_source_imports_no_jax(source):
    """No import statement, at any depth (function-local ones included),
    names JAX or the JAX package."""
    roots = set(_imported_roots(REPO / source))
    assert not roots & set(FORBIDDEN), (source, roots & set(FORBIDDEN))


# the package-level re-exports added with the preservation and
# single-concept benchmarks and the rest of the JAX engine surface:
# package -> {name: "defining module:name"}
REEXPORTS = {
    "emcid_torch.ops": {
        n: f"emcid_torch.ops.solve:{n}"
        for n in ("solve_adj_k", "upd_matrix_match_shape")},
    "emcid_torch.engine": {
        "compute_ks_text_encoder": "emcid_torch.engine.extract:"
                                   "compute_ks_text_encoder",
        "compute_z_text_encoder_batch": "emcid_torch.engine.compute_z:"
                                        "compute_z_text_encoder_batch",
        "apply_emcid_to_text_encoder": "emcid_torch.engine.emcid:"
                                       "apply_emcid_to_text_encoder",
        "resolve_covariances": "emcid_torch.engine.editor:"
                               "resolve_covariances",
        "get_cov_text_encoder": "emcid_torch.engine.layer_stats:"
                                "get_cov_text_encoder"},
    "emcid_torch.stats": {
        n: f"emcid_torch.stats.extras:{n}"
        for n in ("Quantile", "TopK", "Bincount", "History", "IoU")},
    "emcid_torch.models": {
        **{n: f"emcid_torch.models.inception:{n}" for n in (
            "InceptionV3Features", "fid_features", "inception_from_torch",
            "inception_from_jax", "load_inception", "make_fid_extractor")},
        **{n: f"emcid_torch.models.lpips:{n}" for n in (
            "LPIPS", "LPIPSScorer", "lpips_from_torch", "lpips_from_jax")}},
    "emcid_torch.evals": {
        "refact_emcid_test": "emcid_torch.evals.refact_benchmark:emcid_test",
        "refact_eval_all": "emcid_torch.evals.refact_benchmark:eval_all",
        **{n: f"emcid_torch.evals.coco_eval:{n}" for n in (
            "coco_summary_key", "generate_coco", "cal_lpips_coco",
            "cal_clip_score_coco", "write_coco_summary")},
        **{n: f"emcid_torch.evals.artists_eval:{n}" for n in (
            "generate_artist_images", "eval_artists")},
        **{n: f"emcid_torch.evals.i2p_eval:{n}" for n in (
            "generate_i2p_imgs", "detect_nude_classes",
            "i2p_nudity_summary")},
        "emcid_test_sd_imgnet_and_i2p": "emcid_torch.evals.mixed_safety:"
                                        "emcid_test_sd_imgnet_and_i2p",
        **{n: f"emcid_torch.evals.folder_sweep:{n}" for n in (
            "ImageItem", "extract_all_images_cls",
            "extract_all_images_clip")}},
    "emcid_torch.interp": {
        n: f"emcid_torch.interp.causal_trace:{n}" for n in (
            "calculate_hidden_flow_text_encoder", "collect_embedding_std",
            "layername_text_encoder", "trace_important_states",
            "trace_with_patch_text_encoder")},
    "emcid_torch.experiments": {
        "sequential_editing": "emcid_torch.experiments.sequential:"
                              "sequential_editing",
        "finetune_text_encoder": "emcid_torch.experiments.finetune:"
                                 "finetune_text_encoder",
        **{n: f"emcid_torch.experiments.ablation:{n}" for n in (
            "edit_weight_ablation", "layer_combination_ablation",
            "num_edit_tokens_ablation")}},
}


def test_package_reexports():
    """Each package-level name is the object its module defines."""
    import importlib

    for package, names in REEXPORTS.items():
        pkg = importlib.import_module(package)
        for name, target in names.items():
            module, attr = target.split(":")
            assert getattr(pkg, name) is getattr(
                importlib.import_module(module), attr), (package, name)

"""Repo-level configuration constants.

Mirrors the reference's ``globals.yml`` + ``util/globals.py`` (reference
util/globals.py:8-39): a YAML file at the repo root defines result/data/cache
directories and a handful of editing constants.  We keep the same YAML schema
so a reference ``globals.yml`` can be dropped in unchanged.
"""

from __future__ import annotations

import os
from pathlib import Path

import yaml

# Repo root = directory containing globals.yml; overridable for tests.
_ENV_ROOT = os.environ.get("EMCID_TPU_ROOT")
REPO_ROOT = Path(_ENV_ROOT) if _ENV_ROOT else Path(__file__).resolve().parent.parent

_DEFAULTS = {
    "RESULTS_DIR": "results",
    "DATA_DIR": "data",
    "STATS_DIR": "data/stats",
    "XL_STATS_DIR1": "data/stats/sdxl/text1",
    "XL_STATS_DIR2": "data/stats/sdxl/text2",
    "CACHE_DIR": "cache",
    "HPARAMS_DIR": "hparams",
    "EDITING_PROMPTS_CNT": 3,
    "REMOTE_ROOT_URL": "None",
    "RESOLUTION": 512,
}


def _load(path: Path) -> dict:
    data = dict(_DEFAULTS)
    if path.is_file():
        with open(path) as f:
            loaded = yaml.safe_load(f)
        if isinstance(loaded, dict):
            data.update({k: v for k, v in loaded.items() if v is not None})
    return data


_cfg = _load(REPO_ROOT / "globals.yml")

RESULTS_DIR = REPO_ROOT / str(_cfg["RESULTS_DIR"])
DATA_DIR = REPO_ROOT / str(_cfg["DATA_DIR"])
STATS_DIR = REPO_ROOT / str(_cfg["STATS_DIR"])
XL_STATS_DIR1 = REPO_ROOT / str(_cfg["XL_STATS_DIR1"])
XL_STATS_DIR2 = REPO_ROOT / str(_cfg["XL_STATS_DIR2"])
CACHE_DIR = REPO_ROOT / str(_cfg["CACHE_DIR"])
HPARAMS_DIR = REPO_ROOT / str(_cfg["HPARAMS_DIR"])

EDITING_PROMPTS_CNT = int(_cfg["EDITING_PROMPTS_CNT"])
RESOLUTION = int(_cfg["RESOLUTION"])
# SD v1.x operates on RESOLUTION/8 latents (reference util/globals.py LATENT_SIZE).
LATENT_SIZE = RESOLUTION // 8

# UNet edit spreading templates (reference util/globals.py:31-39): the module
# name patterns walked by the UNet editing mode when spreading residuals
# through conv / attention-out sub-blocks.
UNET_EDIT_TEMPLATES = {
    "attn2_to_v": "{}.attn2.to_v",
    "attn2_to_k": "{}.attn2.to_k",
    "attn2_to_out": "{}.attn2.to_out.0",
    "ff_net_2": "{}.ff.net.2",
    "conv": "{}.conv2",
}

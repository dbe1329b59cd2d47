"""Helpers for the parity tests of the PyTorch port against the JAX package:
carry a JAX pipeline's weights, configs and tokenizer over to the port."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from emcid_torch.models import configs as tcfg
from emcid_torch.models.loader import from_jax
from emcid_torch.text.tokenizer import CLIPBPETokenizer

TINY_WORDS = ["cat", "dog", "w1", "w2"]


def port_tokenizer(jax_tok) -> CLIPBPETokenizer:
    merges = sorted(jax_tok.bpe_ranks, key=jax_tok.bpe_ranks.get)
    return CLIPBPETokenizer(jax_tok.encoder, merges,
                            model_max_length=jax_tok.model_max_length)


def port_components(comps, dtype=torch.float32):
    """The JAX ``SDComponents`` ``comps`` as port components on the CPU."""
    npt = lambda tree: jax.tree.map(np.asarray, tree)
    asdict = dataclasses.asdict
    return from_jax(
        tokenizer=port_tokenizer(comps.tokenizer),
        text_config=tcfg.CLIPTextConfig(**asdict(comps.text_encoder.config)),
        unet_config=tcfg.UNetConfig(**asdict(comps.unet.config)),
        vae_config=tcfg.VAEConfig(**asdict(comps.vae.config)),
        text_params=npt(comps.text_params),
        unet_params=npt(comps.unet_params),
        vae_params=npt(comps.vae_params),
        scaling_factor=comps.scaling_factor, vae_scale=comps.vae_scale,
        device="cpu", dtype=dtype)


def rel_diff(a, b, norm: str = "max") -> float:
    """max |a - b| / max |a| (``norm="max"``) or ||a - b|| / ||a||
    (``norm="fro"``); a is the reference."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b.detach().cpu() if torch.is_tensor(b) else b, np.float64)
    if norm == "fro":
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run a test on one intra-op thread.  The tiny models' ops are too
    small to split, and under pytest-xdist every worker would otherwise
    start a thread per core, which makes the tiny ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def port_sdxl_components(comps, dtype=torch.float32):
    """The JAX ``SDXLComponents`` ``comps`` as port components on the CPU."""
    from emcid_torch.models.sdxl import from_jax_sdxl

    npt = lambda tree: jax.tree.map(np.asarray, tree)
    asdict = dataclasses.asdict
    return from_jax_sdxl(
        tokenizer=port_tokenizer(comps.tokenizer),
        text_config=tcfg.CLIPTextConfig(**asdict(comps.text_encoder.config)),
        text_config_2=tcfg.CLIPTextConfig(
            **asdict(comps.text_encoder_2.config)),
        unet_config=tcfg.UNetConfig(**asdict(comps.unet.config)),
        vae_config=tcfg.VAEConfig(**asdict(comps.vae.config)),
        text_params=npt(comps.text_params),
        text_params_2=npt(comps.text_params_2),
        unet_params=npt(comps.unet_params),
        vae_params=npt(comps.vae_params),
        scaling_factor=comps.scaling_factor, vae_scale=comps.vae_scale,
        device="cpu", dtype=dtype)


# the tiny tokenizers' words for the synthetic benchmark files
EVAL_VOCAB = {
    "coco": ["a photo of a cat", "a dog w1", "an image of w2"],
    "artists": [("w3", "erased"), ("w5", "erased"), ("w7", "holdout"),
                ("w8", "holdout")],
    "i2p": [f"w{10 + i}" for i in range(4)],
    "timed": [("cat", "dog"), ("w12", "w13")],
    "road": [("w14", "w15"), ("w16", "w17")],
    "others": [f"w{20 + i}" for i in range(1, 6)],
    "subjects": ("cat", "dog"),
}


def write_eval_tree(data):
    """``chip_smoke.write_benchmark_tree`` in the tiny tokenizers'
    vocabulary: 3 COCO rows, 2 erased artists (w3, w5) with 2 erased and 2
    held-out eval prompts, 4 I2P rows at two guidance scales, and 2 TIMED
    and 2 RoAD rows.  Returns ``data``."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.write_benchmark_tree(Path(data), EVAL_VOCAB, seed=0)

"""Build ``SDComponents``: from a local HF-format checkpoint folder, a
full-width random pipeline, a tiny one, or one carried over from the JAX
package's weights.

Counterpart of ``emcid_tpu/models/loader.py``:

* ``load_pipeline(ckpt_dir)`` — a local HF/diffusers folder
  (``text_encoder/``, ``unet/``, ``vae/`` with torch weights and
  ``config.json``, ``tokenizer/`` with ``vocab.json``/``merges.txt``);
  ``save_pipeline`` writes one;
* ``build_random_pipeline("sd-v1.4")`` — full architecture, seeded random
  weights;
* ``build_tiny_pipeline()`` — the tiny seeded pipeline of smoke runs
  (the JAX package's shapes; its weights are the port's own draw);
* ``from_jax`` — the JAX package's weights, for the parity tests.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from emcid_torch.models import convert
from emcid_torch.models.clip_text import CLIPTextEncoder
from emcid_torch.models.configs import (
    CLIPTextConfig,
    SD_V14_TEXT,
    UNetConfig,
    VAEConfig,
    config_dict,
    sd_v14_unet,
    sd_vae,
    tiny_unet,
    tiny_vae,
    unet_config_from_diffusers,
    vae_config_from_diffusers,
)
from emcid_torch.models.pipeline import SDComponents
from emcid_torch.models.scheduler import Schedule, sd_schedule
from emcid_torch.models.unet import UNet2DCondition
from emcid_torch.models.vae import AutoencoderKL
from emcid_torch.runtime import resolve_device
from emcid_torch.text.tokenizer import CLIPBPETokenizer, make_tiny_tokenizer


def _frozen(module: torch.nn.Module, dtype) -> torch.nn.Module:
    return module.to(dtype).eval().requires_grad_(False)


@torch.no_grad()
def _random_init_(module: torch.nn.Module, gen: torch.Generator) -> None:
    """Seeded weights: normal(0, fan_in^-1/2) matrices and kernels, zero
    biases, unit norm scales."""
    for name, p in module.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        elif p.dim() == 1:
            p.fill_(1.0)
        else:
            fan_in = int(np.prod(p.shape[1:]))
            p.copy_(torch.randn(p.shape, generator=gen, device=p.device)
                    * fan_in ** -0.5)


def build_random_pipeline(name: str = "sd-v1.4", dtype=torch.bfloat16,
                          tokenizer=None, seed: int = 0,
                          device=None) -> SDComponents:
    """Full-architecture pipeline with random weights drawn from ``seed``."""
    if name not in ("sd-v1.4", "sd-v1.5"):
        raise ValueError(f"unknown pipeline {name!r}")
    dev = resolve_device(device)
    if tokenizer is None:
        tokenizer = make_tiny_tokenizer(
            [f"w{i}" for i in range(64)]
            + ["photo", "of", "a", "an", "image", "painting", "by", "style",
               "artwork", "art"],
            model_max_length=77,
        )
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.device(dev):
        text = CLIPTextEncoder(SD_V14_TEXT)
        unet = UNet2DCondition(sd_v14_unet())
        vae = AutoencoderKL(sd_vae())
    for m in (text, unet, vae):
        _random_init_(m, gen)
    return SDComponents(
        tokenizer=tokenizer, text_encoder=_frozen(text, dtype),
        unet=_frozen(unet, dtype), vae=_frozen(vae, dtype),
        schedule=sd_schedule(),
    )


def build_tiny_pipeline(seed: int = 0, words=None,
                        device=None) -> SDComponents:
    """Tiny pipeline with random weights drawn from ``seed``: a 4-layer
    width-32 text encoder, the two-level tiny UNet, the tiny VAE
    (vae_scale 2: 16x16 images, 8x8 latents), f32."""
    dev = resolve_device(device)
    tokenizer = make_tiny_tokenizer(
        list(words or []) + [f"w{i}" for i in range(32)]
        + ["photo", "of", "a", "an", "image", "painting", "by", "style",
           "artwork", "art", "cat", "dog", "realist", "artist", "vincent",
           "van", "gogh", "paint", "the", "in"],
        model_max_length=32,
    )
    text_cfg = CLIPTextConfig(
        vocab_size=tokenizer.vocab_size,
        hidden_size=32, intermediate_size=64, num_hidden_layers=4,
        num_attention_heads=4, max_position_embeddings=32,
        eos_token_id=tokenizer.eos_token_id,
    )
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.device(dev):
        text = CLIPTextEncoder(text_cfg)
        unet = UNet2DCondition(tiny_unet(cross_attention_dim=32))
        vae = AutoencoderKL(tiny_vae())
    for m in (text, unet, vae):
        _random_init_(m, gen)
    return SDComponents(
        tokenizer=tokenizer, text_encoder=_frozen(text, torch.float32),
        unet=_frozen(unet, torch.float32), vae=_frozen(vae, torch.float32),
        schedule=sd_schedule(), vae_scale=2,
    )


def _load_torch_state_dict(folder: Path) -> Dict[str, torch.Tensor]:
    """The torch weights of one model subfolder: its ``.safetensors``
    files when the ``safetensors`` package imports, else its ``.bin`` /
    ``.pt`` files."""
    st = sorted(folder.glob("*.safetensors"))
    if st:
        try:
            from safetensors.torch import load_file

            out = {}
            for f in st:
                out.update(load_file(str(f)))
            return out
        except ImportError:
            pass
    bins = sorted(folder.glob("*.bin")) + sorted(folder.glob("*.pt"))
    if not bins:
        raise FileNotFoundError(f"no weight files in {folder}")
    out = {}
    for f in bins:
        out.update(torch.load(str(f), map_location="cpu", weights_only=True))
    return out


def _read_config(path: Path) -> Optional[dict]:
    if not path.exists():
        return None
    with open(path) as f:
        return json.load(f)


def load_pipeline(ckpt_dir, dtype=torch.bfloat16, device=None
                  ) -> SDComponents:
    """A local HF-format SD checkpoint folder -> ``SDComponents``.  Each
    model's architecture follows its ``config.json`` when present (SD
    v1.5 / finetunes share the schema), else SD-v1.4's."""
    dev = resolve_device(device)
    ckpt = Path(ckpt_dir)
    text_cfg = SD_V14_TEXT
    c = _read_config(ckpt / "text_encoder" / "config.json")
    if c is not None:
        text_cfg = CLIPTextConfig(
            vocab_size=c.get("vocab_size", 49408),
            hidden_size=c.get("hidden_size", 768),
            intermediate_size=c.get("intermediate_size", 3072),
            num_hidden_layers=c.get("num_hidden_layers", 12),
            num_attention_heads=c.get("num_attention_heads", 12),
            max_position_embeddings=c.get("max_position_embeddings", 77),
            hidden_act=c.get("hidden_act", "quick_gelu"),
            eos_token_id=c.get("eos_token_id", 49407),
        )
    # context length follows the encoder (77 for real SD; a longer
    # tokenizer pad would index past the position-embedding table)
    tokenizer = CLIPBPETokenizer.from_pretrained_dir(
        ckpt / "tokenizer",
        model_max_length=text_cfg.max_position_embeddings)
    c = _read_config(ckpt / "unet" / "config.json")
    unet_cfg = sd_v14_unet() if c is None else unet_config_from_diffusers(c)
    c = _read_config(ckpt / "vae" / "config.json")
    vae_cfg = sd_vae() if c is None else vae_config_from_diffusers(c)
    models = {}
    for sub, cls, cfg in (("text_encoder", CLIPTextEncoder, text_cfg),
                          ("unet", UNet2DCondition, unet_cfg),
                          ("vae", AutoencoderKL, vae_cfg)):
        state = _load_torch_state_dict(ckpt / sub)
        # HF CLIP checkpoints may carry the position-ids buffer
        state = {k: v for k, v in state.items()
                 if not k.endswith("position_ids")}
        # built without storage, then given the checkpoint's tensors: no
        # random init of weights that are about to be replaced
        with torch.device("meta"):
            module = cls(cfg)
        module.load_state_dict(state, strict=True, assign=True)
        del state
        models[sub] = module.to(device=dev, dtype=dtype).eval(
        ).requires_grad_(False)
    return SDComponents(
        tokenizer=tokenizer, text_encoder=models["text_encoder"],
        unet=models["unet"], vae=models["vae"], schedule=sd_schedule(),
        scaling_factor=vae_cfg.scaling_factor,
        vae_scale=2 ** (len(vae_cfg.block_out_channels) - 1),
    )


def save_pipeline(components: SDComponents, ckpt_dir) -> Path:
    """Write ``components`` as the HF-format folder ``load_pipeline``
    reads: float32 ``.bin`` state dicts, ``config.json`` files and the
    tokenizer's ``vocab.json``/``merges.txt``."""
    ckpt = Path(ckpt_dir)
    for module, sub, fname in (
            (components.text_encoder, "text_encoder", "pytorch_model.bin"),
            (components.unet, "unet", "diffusion_pytorch_model.bin"),
            (components.vae, "vae", "diffusion_pytorch_model.bin")):
        (ckpt / sub).mkdir(parents=True, exist_ok=True)
        cfg = config_dict(module.config)
        if sub == "vae":
            cfg["scaling_factor"] = components.scaling_factor
        with open(ckpt / sub / "config.json", "w") as f:
            json.dump(cfg, f, indent=1)
        torch.save({k: v.detach().to("cpu", torch.float32)
                    for k, v in module.state_dict().items()},
                   ckpt / sub / fname)
    components.tokenizer.save_pretrained(ckpt / "tokenizer")
    return ckpt


def _load(module: torch.nn.Module, state: Dict[str, np.ndarray]) -> None:
    module.load_state_dict(
        {k: torch.from_numpy(np.array(v, dtype=np.float32))
         for k, v in state.items()}, strict=True)


def from_jax(*, tokenizer, text_config: CLIPTextConfig,
             unet_config: UNetConfig, vae_config: VAEConfig,
             text_params: Dict[str, Any], unet_params: Dict[str, Any],
             vae_params: Dict[str, Any], schedule: Optional[Schedule] = None,
             scaling_factor: float = 0.18215, vae_scale: int = 8,
             device=None, dtype=torch.float32) -> SDComponents:
    """Components holding the JAX package's weights (Flax trees given as
    nested dicts of numpy arrays), converted by ``models.convert``."""
    dev = resolve_device(device)
    text = CLIPTextEncoder(text_config)
    unet = UNet2DCondition(unet_config)
    vae = AutoencoderKL(vae_config)
    _load(text, convert.clip_text_to_torch(text_params))
    _load(unet, convert.unet_to_torch(unet_params))
    _load(vae, convert.vae_to_torch(vae_params))
    return SDComponents(
        tokenizer=tokenizer,
        text_encoder=_frozen(text.to(dev), dtype),
        unet=_frozen(unet.to(dev), dtype),
        vae=_frozen(vae.to(dev), dtype),
        schedule=schedule or sd_schedule(),
        scaling_factor=scaling_factor, vae_scale=vae_scale,
    )

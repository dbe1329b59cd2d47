"""SDXL pipeline: two text encoders and the text_time-conditioned UNet.

Counterpart of ``emcid_tpu/models/sdxl.py``.  SDXL conditioning:

* context = concat(penultimate hidden state of CLIP-L, penultimate hidden
  state of OpenCLIP bigG) -> (B, 77, 2048), with no final LN;
* added conditions: ``text_embeds`` = bigG's projected pooled output
  (B, 1280), ``time_ids`` = the (orig size, crop, target size) sextuple.

Both encoders read the encoder-1 tokenization (the SDXL tokenizers share
the CLIP BPE vocabulary).  The editing engine treats each encoder
separately (``engine/sdxl.py``).  Weights live in the modules, as in
``models.pipeline.SDComponents``; an edit returns new components with new
encoder modules.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from emcid_torch.models import convert
from emcid_torch.models import pipeline as _pipeline
from emcid_torch.models.clip_text import CLIPTextEncoder
from emcid_torch.models.configs import (
    SDXL_TEXT_1,
    SDXL_TEXT_2,
    CLIPTextConfig,
    UNetConfig,
    VAEConfig,
    sdxl_unet,
    sdxl_vae,
    tiny_vae,
    unet_config_from_diffusers,
    vae_config_from_diffusers,
)
from emcid_torch.models.loader import (
    _frozen,
    _load,
    _load_torch_state_dict,
    _random_init_,
    _read_config,
)
from emcid_torch.models.pipeline import SDComponents, decode_latents, tokenize
from emcid_torch.models.scheduler import (
    Schedule,
    ddim_timesteps,
    run_sampler,
    sd_schedule,
)
from emcid_torch.models.unet import UNet2DCondition
from emcid_torch.models.vae import AutoencoderKL
from emcid_torch.runtime import resolve_device
from emcid_torch.text.tokenizer import CLIPBPETokenizer, make_tiny_tokenizer


@dataclass
class SDXLComponents:
    """The models of one SDXL pipeline."""

    tokenizer: Any  # the CLIP BPE of both encoders
    text_encoder: torch.nn.Module  # CLIP ViT-L/14 text tower
    text_encoder_2: torch.nn.Module  # OpenCLIP bigG/14 text tower + proj
    unet: torch.nn.Module  # UNet2DCondition, text_time
    vae: torch.nn.Module  # AutoencoderKL
    schedule: Schedule = field(default_factory=sd_schedule)
    scaling_factor: float = 0.13025
    latent_channels: int = 4
    vae_scale: int = 8

    @property
    def device(self) -> torch.device:
        return next(self.unet.parameters()).device

    @property
    def dtype(self) -> torch.dtype:
        return next(self.unet.parameters()).dtype

    def replace_text_encoders(self, text_encoder=None,
                              text_encoder_2=None) -> "SDXLComponents":
        """A copy with new encoder modules (the JAX package's
        ``replace_text_params``)."""
        kw = {}
        if text_encoder is not None:
            kw["text_encoder"] = text_encoder
        if text_encoder_2 is not None:
            kw["text_encoder_2"] = text_encoder_2
        return dataclasses.replace(self, **kw)

    def encoder(self, which: int) -> torch.nn.Module:
        return self.text_encoder if which == 1 else self.text_encoder_2

    def sd_view(self, which: int = 1) -> SDComponents:
        """The SD components over encoder ``which``, this UNet and VAE: the
        view the SD decode, posterior and covariance code takes."""
        return SDComponents(
            tokenizer=self.tokenizer, text_encoder=self.encoder(which),
            unet=self.unet, vae=self.vae, schedule=self.schedule,
            scaling_factor=self.scaling_factor,
            latent_channels=self.latent_channels, vae_scale=self.vae_scale)


def sdxl_condition(text_encoder, text_encoder_2, ids, ids_2=None, *,
                   inject_1=None, inject_2=None):
    """Token ids -> (context (B, S, H1 + H2), pooled_1 (B, H1), pooled_2
    (B, proj)): the penultimate layer outputs of both encoders, no final
    LN.  ``ids_2`` feeds encoder 2 (default ``ids``); ``inject_k`` =
    (layer, delta (B, S, H)) adds a delta to that encoder layer's output."""
    outs = []
    for text, x, inj in ((text_encoder, ids, inject_1),
                         (text_encoder_2, ids if ids_2 is None else ids_2,
                          inject_2)):
        kw = {} if inj is None else dict(inject_layer=inj[0],
                                         inject_delta=inj[1])
        n = text.config.num_hidden_layers
        out = text(x, capture=("layer_out",), **kw)
        outs.append((out.taps["layer_out"][n - 2], out.pooled_output))
    (h1, pooled_1), (h2, pooled_2) = outs
    return torch.cat([h1, h2], dim=-1), pooled_1, pooled_2


@torch.no_grad()
def encode_prompts_sdxl(components: SDXLComponents, prompts: Sequence[str]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prompts -> (context (B, S, 2048), pooled (B, 1280))."""
    ids = tokenize(components, prompts)
    ctx, _, pooled = sdxl_condition(components.text_encoder,
                                    components.text_encoder_2, ids)
    return ctx, pooled


def sdxl_time_ids(batch: int, height: int, width: int,
                  crop: Tuple[int, int] = (0, 0), device=None
                  ) -> torch.Tensor:
    ids = torch.tensor([height, width, crop[0], crop[1], height, width],
                       dtype=torch.float32, device=device)
    return ids.expand(batch, 6)


@torch.no_grad()
def sample_latents_sdxl(
    components: SDXLComponents,
    prompts: Sequence[str],
    seeds: Sequence[int],
    *,
    negative_prompts: Optional[Sequence[str]] = None,
    num_inference_steps: int = 50,
    guidance_scale: float = 5.0,
    height: int = 1024,
    width: int = 1024,
    sampler: str = "ddim",
    cfg_interval: float = 1.0,
    latents: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """CFG sampling with the SDXL added conditions -> final latents
    (B, h, w, c), f32.  ``sampler``: ddim (default), pndm or dpm++.  The
    guided steps batch the unconditional and conditional halves together;
    ``cfg_interval < 1`` runs the last steps on the conditional half only.
    ``latents`` (channel-last) replaces the seeded initial latents."""
    if not 0.0 < cfg_interval <= 1.0:
        raise ValueError(f"cfg_interval={cfg_interval} must be in (0, 1]")
    if len(prompts) != len(seeds):
        raise ValueError("one seed per prompt")
    dev, dtype = components.device, components.dtype
    unet = components.unet
    ctx_c, pool_c = encode_prompts_sdxl(components, prompts)
    neg = (negative_prompts if negative_prompts is not None
           else [""] * len(prompts))
    ctx_u, pool_u = encode_prompts_sdxl(components, neg)
    if latents is None:
        latents = _pipeline.initial_latents(
            seeds, height, width, components.latent_channels,
            components.vae_scale, device=dev)
    lat = torch.as_tensor(latents, device=dev).float().permute(0, 3, 1, 2)
    B = lat.shape[0]
    tids = sdxl_time_ids(B, height, width, device=dev)
    ctx2 = torch.cat([ctx_u, ctx_c])
    added2 = {"text_embeds": torch.cat([pool_u, pool_c]),
              "time_ids": torch.cat([tids, tids])}
    added_c = {"text_embeds": pool_c, "time_ids": tids}

    def t_of(t):
        return torch.tensor([t], device=dev)

    def eps_cond(x, t):
        return unet(x.to(dtype), t_of(t), ctx_c, added_c).sample.float()

    def eps_cfg(x, t):
        x2 = torch.cat([x, x]).to(dtype)
        eps_u, eps_c = unet(x2, t_of(t), ctx2, added2).sample.float().chunk(2)
        return eps_u + guidance_scale * (eps_c - eps_u)

    ts = ddim_timesteps(components.schedule, num_inference_steps)
    ts_prev = np.concatenate([ts[1:], [-1]]).astype(np.int32)
    n_head = (max(1, int(round(cfg_interval * len(ts))))
              if cfg_interval < 1.0 else None)
    out = run_sampler(sampler, components.schedule, eps_cfg, lat, ts,
                      ts_prev, unet_eps_tail=eps_cond, n_head=n_head)
    return out.permute(0, 2, 3, 1).contiguous()


def generate_sdxl(components: SDXLComponents, prompts, seeds,
                  **kwargs) -> np.ndarray:
    """Text -> uint8 images (B, H, W, 3), decoded through the SD decode at
    the SDXL scaling factor."""
    lat = sample_latents_sdxl(components, list(prompts), list(seeds),
                              **kwargs)
    return decode_latents(components.sd_view(), lat)


def _text_config(c: Optional[dict], default: CLIPTextConfig
                 ) -> CLIPTextConfig:
    """A text encoder's ``config.json`` over ``default`` (the projection
    kept when the default has one or the file names a *WithProjection
    architecture)."""
    if c is None:
        return default
    with_proj = (default.projection_dim is not None
                 or "WithProjection" in str(c.get("architectures")))
    return CLIPTextConfig(
        vocab_size=c.get("vocab_size", default.vocab_size),
        hidden_size=c.get("hidden_size", default.hidden_size),
        intermediate_size=c.get("intermediate_size",
                                default.intermediate_size),
        num_hidden_layers=c.get("num_hidden_layers",
                                default.num_hidden_layers),
        num_attention_heads=c.get("num_attention_heads",
                                  default.num_attention_heads),
        max_position_embeddings=c.get("max_position_embeddings", 77),
        hidden_act=c.get("hidden_act", default.hidden_act),
        eos_token_id=c.get("eos_token_id", default.eos_token_id),
        projection_dim=(c.get("projection_dim", default.projection_dim)
                        if with_proj else None),
    )


def load_sdxl_pipeline(ckpt_dir, dtype=torch.bfloat16, device=None,
                       unet_config: Optional[UNetConfig] = None,
                       vae_config: Optional[VAEConfig] = None
                       ) -> SDXLComponents:
    """A local HF/diffusers-format SDXL folder (``tokenizer/``,
    ``text_encoder/``, ``text_encoder_2/``, ``unet/``, ``vae/``) ->
    ``SDXLComponents``.  Each model's architecture follows its
    ``config.json`` when present, else SDXL-base's; the VAE's
    ``scaling_factor`` and its number of levels set the latent scaling and
    ``vae_scale``."""
    dev = resolve_device(device)
    ckpt = Path(ckpt_dir)
    cfg1 = _text_config(_read_config(ckpt / "text_encoder" / "config.json"),
                        SDXL_TEXT_1)
    cfg2 = _text_config(_read_config(ckpt / "text_encoder_2" / "config.json"),
                        SDXL_TEXT_2)
    # the context length follows encoder 1 (77 for SDXL)
    tokenizer = CLIPBPETokenizer.from_pretrained_dir(
        ckpt / "tokenizer", model_max_length=cfg1.max_position_embeddings)
    if unet_config is None:
        c = _read_config(ckpt / "unet" / "config.json")
        unet_config = sdxl_unet() if c is None else unet_config_from_diffusers(c)
    vae_json = _read_config(ckpt / "vae" / "config.json")
    if vae_config is None:
        vae_config = (sdxl_vae() if vae_json is None
                      else vae_config_from_diffusers(vae_json))
    models = {}
    for sub, cls, cfg in (("text_encoder", CLIPTextEncoder, cfg1),
                          ("text_encoder_2", CLIPTextEncoder, cfg2),
                          ("unet", UNet2DCondition, unet_config),
                          ("vae", AutoencoderKL, vae_config)):
        state = {k: v for k, v in _load_torch_state_dict(ckpt / sub).items()
                 if not k.endswith("position_ids")}
        with torch.device("meta"):
            module = cls(cfg)
        module.load_state_dict(state, strict=True, assign=True)
        del state
        models[sub] = _frozen(module.to(dev), dtype)
    scaling = vae_config.scaling_factor
    if vae_json is not None:
        scaling = vae_json.get("scaling_factor", scaling)
    return SDXLComponents(
        tokenizer=tokenizer, text_encoder=models["text_encoder"],
        text_encoder_2=models["text_encoder_2"], unet=models["unet"],
        vae=models["vae"], scaling_factor=scaling,
        vae_scale=2 ** (len(vae_config.block_out_channels) - 1))


def tiny_sdxl_configs(tokenizer) -> Tuple[CLIPTextConfig, CLIPTextConfig,
                                          UNetConfig, VAEConfig]:
    """The tiny SDXL-style architecture: 3- and 4-layer width-16 encoders
    (the second with gelu and a 16-wide projection: 32-wide context), the
    two-level text_time UNet, the tiny VAE (vae_scale 2)."""
    cfg1 = CLIPTextConfig(
        vocab_size=tokenizer.vocab_size, hidden_size=16,
        intermediate_size=32, num_hidden_layers=3, num_attention_heads=2,
        max_position_embeddings=16, eos_token_id=tokenizer.eos_token_id)
    cfg2 = CLIPTextConfig(
        vocab_size=tokenizer.vocab_size, hidden_size=16,
        intermediate_size=32, num_hidden_layers=4, num_attention_heads=2,
        max_position_embeddings=16, hidden_act="gelu", projection_dim=16,
        eos_token_id=tokenizer.eos_token_id)
    unet_cfg = UNetConfig(
        sample_size=8, block_out_channels=(32, 64), layers_per_block=1,
        down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
        up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"),
        attention_head_dim=(4, 4), transformer_layers_per_block=(1, 1),
        cross_attention_dim=32, norm_num_groups=8,
        addition_embed_type="text_time", addition_time_embed_dim=8,
        projection_class_embeddings_input_dim=16 + 6 * 8)
    return cfg1, cfg2, unet_cfg, tiny_vae()


def _random_sdxl(configs, tokenizer, seed: int, device, dtype,
                 vae_scale: int, scaling_factor: float) -> SDXLComponents:
    """Modules of ``configs`` (text 1, text 2, UNet, VAE) built without
    storage, given storage in ``dtype`` on the device, then drawn from one
    ``torch.Generator`` seeded with ``seed``: each parameter is drawn in
    f32 and cast, so no f32 copy of a whole model is ever held."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    modules = []
    for cls, cfg in zip((CLIPTextEncoder, CLIPTextEncoder, UNet2DCondition,
                         AutoencoderKL), configs):
        with torch.device("meta"):
            m = cls(cfg)
        m = m.to(dtype).to_empty(device=dev)
        _random_init_(m, gen)
        modules.append(m.eval().requires_grad_(False))
    text1, text2, unet, vae = modules
    return SDXLComponents(
        tokenizer=tokenizer, text_encoder=text1, text_encoder_2=text2,
        unet=unet, vae=vae, scaling_factor=scaling_factor,
        vae_scale=vae_scale)


def build_tiny_sdxl_pipeline(seed: int = 0, words=None,
                             device=None) -> SDXLComponents:
    """Tiny SDXL pipeline (the JAX package's architecture, ``
    tiny_sdxl_configs``) with random f32 weights drawn from ``seed``;
    16x16 images, 8x8 latents."""
    tokenizer = make_tiny_tokenizer(
        list(words or []) + [f"w{i}" for i in range(16)]
        + ["photo", "of", "a", "an", "image", "cat", "dog"],
        model_max_length=16)
    return _random_sdxl(tiny_sdxl_configs(tokenizer), tokenizer, seed,
                        device, torch.float32, vae_scale=2,
                        scaling_factor=0.13025)


def build_random_sdxl_pipeline(seed: int = 0, device=None,
                               dtype=torch.bfloat16,
                               tokenizer=None) -> SDXLComponents:
    """Full-width SDXL-base (CLIP-L, OpenCLIP bigG with its projection,
    the 2.6B text_time UNet, the SDXL VAE: 3.47B parameters) with random
    weights drawn from ``seed``."""
    if tokenizer is None:
        tokenizer = make_tiny_tokenizer(
            [f"w{i}" for i in range(64)] + ["photo", "of", "a", "an",
                                            "image"],
            model_max_length=77)
    return _random_sdxl((SDXL_TEXT_1, SDXL_TEXT_2, sdxl_unet(), sdxl_vae()),
                        tokenizer, seed, device, dtype, vae_scale=8,
                        scaling_factor=0.13025)


def from_jax_sdxl(*, tokenizer, text_config: CLIPTextConfig,
                  text_config_2: CLIPTextConfig, unet_config: UNetConfig,
                  vae_config: VAEConfig, text_params: Dict[str, Any],
                  text_params_2: Dict[str, Any], unet_params: Dict[str, Any],
                  vae_params: Dict[str, Any],
                  schedule: Optional[Schedule] = None,
                  scaling_factor: float = 0.13025, vae_scale: int = 8,
                  device=None, dtype=torch.float32) -> SDXLComponents:
    """SDXL components holding the JAX package's weights (Flax trees given
    as nested dicts of numpy arrays: both encoders, bigG's
    ``text_projection`` included, the text_time UNet and the VAE),
    converted by ``models.convert``."""
    dev = resolve_device(device)
    text1 = CLIPTextEncoder(text_config)
    text2 = CLIPTextEncoder(text_config_2)
    unet = UNet2DCondition(unet_config)
    vae = AutoencoderKL(vae_config)
    _load(text1, convert.clip_text_to_torch(text_params))
    _load(text2, convert.clip_text_to_torch(text_params_2))
    _load(unet, convert.unet_to_torch(unet_params))
    _load(vae, convert.vae_to_torch(vae_params))
    return SDXLComponents(
        tokenizer=tokenizer, text_encoder=_frozen(text1.to(dev), dtype),
        text_encoder_2=_frozen(text2.to(dev), dtype),
        unet=_frozen(unet.to(dev), dtype), vae=_frozen(vae.to(dev), dtype),
        schedule=schedule or sd_schedule(), scaling_factor=scaling_factor,
        vae_scale=vae_scale)

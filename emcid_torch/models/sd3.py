"""SD3 pipeline (Stable Diffusion 3 / 3.5): two CLIP encoders and T5-XXL,
the MMDiT denoiser, the 16-channel VAE, flow-matching Euler sampling.

Conditioning, as diffusers' ``StableDiffusion3Pipeline.encode_prompt``
builds it at ``clip_skip`` None:

* context = [CLIP-L penultimate ‖ bigG penultimate] (B, 77, 2048),
  zero-padded to T5's 4096 channels and joined on the token axis with
  T5's last hidden state (B, 256, 4096) -> (B, 333, 4096);
* pooled = [CLIP-L projected pool ‖ bigG projected pool] (B, 2048).

Both CLIP encoders read the encoder-1 ids, as the port's SDXL does
(``models/sdxl``); T5 reads ``tokenizer_3``'s ids without a mask.
Sampling is ``scheduler.run_flow_sampler`` over ``flow_sigmas`` (shift
3.0), CFG batching the unconditional and conditional halves on the guided
steps, the conditional half alone after ``cfg_interval``.  Latents decode
as x / scaling_factor + shift_factor.
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from emcid_torch.models import pipeline as _pipeline
from emcid_torch.models.clip_text import CLIPTextEncoder
from emcid_torch.models.configs import (
    SDXL_TEXT_2,
    CLIPTextConfig,
    MMDiTConfig,
    T5Config,
    VAEConfig,
    config_dict,
    mmdit_config_from_diffusers,
    sd3_vae,
    t5_config_from_transformers,
    vae_config_from_diffusers,
)
from emcid_torch.models.loader import (
    _frozen,
    _load_torch_state_dict,
    _random_init_,
    _read_config,
)
from emcid_torch.models.mmdit import MMDiT, pos_table
from emcid_torch.models.scheduler import flow_sigmas, run_flow_sampler
from emcid_torch.models.sdxl import _text_config, sdxl_condition
from emcid_torch.models.t5_text import T5Encoder
from emcid_torch.models.vae import AutoencoderKL
from emcid_torch.runtime import resolve_device
from emcid_torch.text.t5_words import T5WordTokenizer
from emcid_torch.text.tokenizer import CLIPBPETokenizer, make_tiny_tokenizer

# SD3's CLIP-L: the ViT-L/14 text tower with its 768 projection
SD3_TEXT_1 = CLIPTextConfig(projection_dim=768)
SUBFOLDERS = ("text_encoder", "text_encoder_2", "text_encoder_3",
              "transformer", "vae")


@dataclass
class SD3Components:
    """The models of one SD3 pipeline."""

    tokenizer: Any  # the CLIP BPE of both CLIP encoders
    tokenizer_3: Any  # T5's (``text.t5_words.T5WordTokenizer``)
    text_encoder: torch.nn.Module  # CLIP ViT-L/14 text tower + proj
    text_encoder_2: torch.nn.Module  # OpenCLIP bigG/14 text tower + proj
    text_encoder_3: torch.nn.Module  # T5Encoder
    transformer: torch.nn.Module  # MMDiT
    vae: torch.nn.Module  # AutoencoderKL, 16 channels
    shift: float = 3.0
    scaling_factor: float = 1.5305
    shift_factor: float = 0.0609
    latent_channels: int = 16
    vae_scale: int = 8

    @property
    def device(self) -> torch.device:
        return next(self.transformer.parameters()).device

    @property
    def dtype(self) -> torch.dtype:
        return next(self.transformer.parameters()).dtype

    def encoder(self, which: int) -> torch.nn.Module:
        return self.text_encoder if which == 1 else self.text_encoder_2

    def replace_text_encoders(self, text_encoder=None,
                              text_encoder_2=None) -> "SD3Components":
        kw = {}
        if text_encoder is not None:
            kw["text_encoder"] = text_encoder
        if text_encoder_2 is not None:
            kw["text_encoder_2"] = text_encoder_2
        return dataclasses.replace(self, **kw)


def t5_ids(components: SD3Components, prompts: Sequence[str]) -> torch.Tensor:
    return torch.as_tensor(components.tokenizer_3(list(prompts)),
                           device=components.device)


@torch.no_grad()
def t5_states(components: SD3Components, prompts: Sequence[str]
              ) -> torch.Tensor:
    """Prompts -> T5's last hidden state (B, 256, 4096)."""
    return components.text_encoder_3(t5_ids(components, prompts))


def joint_context(clip_ctx: torch.Tensor, t5: torch.Tensor) -> torch.Tensor:
    """[CLIP context zero-padded to T5's width ; T5 states] on the token
    axis."""
    pad = F.pad(clip_ctx, (0, t5.shape[-1] - clip_ctx.shape[-1]))
    return torch.cat([pad, t5.to(pad.dtype)], dim=-2)


def sd3_condition(text_encoder, text_encoder_2, ids, t5, ids_2=None, *,
                  inject_1=None, inject_2=None):
    """(context (B, 77 + S3, 4096), pooled (B, P1 + P2)): the CLIP part
    from ``models.sdxl.sdxl_condition`` (injects and ``ids_2`` as there),
    T5's states ``t5`` given."""
    ctx, pool_1, pool_2 = sdxl_condition(text_encoder, text_encoder_2, ids,
                                         ids_2, inject_1=inject_1,
                                         inject_2=inject_2)
    return joint_context(ctx, t5), torch.cat([pool_1, pool_2], dim=-1)


@torch.no_grad()
def encode_prompts_sd3(components: SD3Components, prompts: Sequence[str],
                       t5: Optional[torch.Tensor] = None):
    """Prompts -> (context, pooled); ``t5`` replaces T5's states of the
    prompts where they are already computed."""
    ids = _pipeline.tokenize(components, prompts)
    if t5 is None:
        t5 = t5_states(components, prompts)
    return sd3_condition(components.text_encoder, components.text_encoder_2,
                         ids, t5)


def velocity(transformer, x, t, ctx, pooled) -> torch.Tensor:
    """The MMDiT's velocity (f32) at timestep(s) ``t``."""
    dt = next(transformer.parameters()).dtype
    t = torch.as_tensor(t, dtype=torch.float32, device=x.device)
    t = t.expand(x.shape[0]) if t.dim() == 0 else t
    return transformer(x.to(dt), t, ctx, pooled).float()


@torch.no_grad()
def sample_latents_sd3(
    components: SD3Components,
    prompts: Sequence[str],
    seeds: Sequence[int],
    *,
    negative_prompts: Optional[Sequence[str]] = None,
    num_inference_steps: int = 28,
    guidance_scale: float = 4.5,
    height: int = 1024,
    width: int = 1024,
    cfg_interval: float = 1.0,
    latents: Optional[torch.Tensor] = None,
    t5: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Flow-matching Euler with CFG -> final latents (B, h, w, c), f32.
    ``t5`` = (states of the prompts, of the negative prompts) where they
    are already computed; ``latents`` (channel-last) replaces the seeded
    initial latents (one generator per seed)."""
    if not 0.0 < cfg_interval <= 1.0:
        raise ValueError(f"cfg_interval={cfg_interval} must be in (0, 1]")
    if len(prompts) != len(seeds):
        raise ValueError("one seed per prompt")
    dev, tr = components.device, components.transformer
    neg = (negative_prompts if negative_prompts is not None
           else [""] * len(prompts))
    t5_c, t5_u = t5 if t5 is not None else (None, None)
    ctx_c, pool_c = encode_prompts_sd3(components, prompts, t5_c)
    ctx_u, pool_u = encode_prompts_sd3(components, neg, t5_u)
    if latents is None:
        latents = _pipeline.initial_latents(
            seeds, height, width, components.latent_channels,
            components.vae_scale, device=dev)
    lat = torch.as_tensor(latents, device=dev).float().permute(0, 3, 1, 2)
    ctx2, pool2 = torch.cat([ctx_u, ctx_c]), torch.cat([pool_u, pool_c])

    def v_cond(x, t):
        return velocity(tr, x, t, ctx_c, pool_c)

    def v_cfg(x, t):
        v_u, v_c = velocity(tr, torch.cat([x, x]), t, ctx2, pool2).chunk(2)
        return v_u + guidance_scale * (v_c - v_u)

    sig = flow_sigmas(num_inference_steps, components.shift)
    n_head = (max(1, int(round(cfg_interval * num_inference_steps)))
              if cfg_interval < 1.0 else None)
    out = run_flow_sampler(v_cfg, lat, sig, model_v_tail=v_cond,
                           n_head=n_head)
    return out.permute(0, 2, 3, 1).contiguous()


@torch.no_grad()
def decode_sd3(components: SD3Components, latents) -> np.ndarray:
    """Channel-last latents -> uint8 RGB (B, H, W, 3) on the host:
    x / scaling_factor + shift_factor through the VAE decoder."""
    lat = torch.as_tensor(latents, device=components.device).float()
    z = lat.permute(0, 3, 1, 2) / components.scaling_factor
    img = components.vae.decode((z + components.shift_factor).to(
        components.dtype))
    img = torch.clamp(img.float() / 2 + 0.5, 0.0, 1.0)
    return torch.round(img * 255).to(torch.uint8).permute(
        0, 2, 3, 1).cpu().numpy()


@torch.no_grad()
def encode_posterior_sd3(components: SD3Components, images
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Images in [-1, 1] (B, H, W, 3) -> the posterior (mean, logvar) of
    SD3's latents, channel-last: (mean - shift_factor) * scaling_factor,
    logvar + 2 log scaling_factor."""
    sf = components.scaling_factor
    x = torch.as_tensor(np.asarray(images, np.float32)
                        if not torch.is_tensor(images) else images,
                        device=components.device).float()
    dist = components.vae.encode(x.permute(0, 3, 1, 2).to(components.dtype))
    mean = (dist.mean.float() - components.shift_factor) * sf
    logvar = dist.logvar.float() + 2.0 * math.log(sf)
    return (mean.permute(0, 2, 3, 1).contiguous(),
            logvar.permute(0, 2, 3, 1).contiguous())


def generate_sd3(components: SD3Components, prompts, seeds,
                 **kwargs) -> np.ndarray:
    """Text -> uint8 images (B, H, W, 3)."""
    return decode_sd3(components, sample_latents_sd3(
        components, list(prompts), list(seeds), **kwargs))


# -- building and loading -----------------------------------------------------


def _modules(configs):
    return dict(zip(SUBFOLDERS, zip(
        (CLIPTextEncoder, CLIPTextEncoder, T5Encoder, MMDiT, AutoencoderKL),
        configs)))


def _components(models, tokenizer, tokenizer_3, vae_cfg: VAEConfig,
                shift: float = 3.0) -> SD3Components:
    return SD3Components(
        tokenizer=tokenizer, tokenizer_3=tokenizer_3,
        shift=shift, scaling_factor=vae_cfg.scaling_factor,
        shift_factor=vae_cfg.shift_factor,
        latent_channels=vae_cfg.latent_channels,
        vae_scale=2 ** (len(vae_cfg.block_out_channels) - 1), **models)


def _random_sd3(configs, tokenizer, tokenizer_3, seed: int, device,
                dtype) -> SD3Components:
    """Modules of ``configs`` (CLIP-L, bigG, T5, MMDiT, VAE) built without
    storage, given storage in ``dtype``, drawn from one generator seeded
    with ``seed`` (the patch table is computed, not drawn)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    models = {}
    for sub, (cls, cfg) in _modules(configs).items():
        with torch.device("meta"):
            m = cls(cfg)
        m = m.to(dtype).to_empty(device=dev)
        _random_init_(m, gen)
        if sub == "transformer":
            m.pos_embed.pos_embed.copy_(pos_table(cfg))
        models[sub] = m.eval().requires_grad_(False)
    return _components(models, tokenizer, tokenizer_3, configs[-1])


def tiny_sd3_configs(tokenizer, tokenizer_3):
    """Tiny SD3: 3- and 4-layer width-16 CLIPs with 16-wide projections, a
    2-layer width-32 T5, a 3-block width-32 MMDiT-X (block 0 dual, the last
    ``context_pre_only``), the tiny 16-channel VAE (vae_scale 2)."""
    clip = dict(vocab_size=tokenizer.vocab_size, hidden_size=16,
                intermediate_size=32, num_attention_heads=2,
                max_position_embeddings=16, projection_dim=16,
                eos_token_id=tokenizer.eos_token_id)
    t5 = T5Config(vocab_size=tokenizer_3.vocab_size, d_model=32, d_kv=8,
                  d_ff=48, num_layers=2, num_heads=4)
    mmdit = MMDiTConfig(sample_size=8, num_layers=3, attention_head_dim=8,
                        num_attention_heads=4, joint_attention_dim=32,
                        caption_projection_dim=32, pooled_projection_dim=32,
                        pos_embed_max_size=12, dual_attention_layers=(0,))
    vae = dataclasses.replace(sd3_vae(), block_out_channels=(16, 32),
                              layers_per_block=1, norm_num_groups=4,
                              sample_size=16)
    return (CLIPTextConfig(num_hidden_layers=3, **clip),
            CLIPTextConfig(num_hidden_layers=4, hidden_act="gelu", **clip),
            t5, mmdit, vae)


def build_tiny_sd3_pipeline(seed: int = 0, words=None, device=None,
                            dtype=torch.float32) -> SD3Components:
    """Tiny SD3 pipeline (``tiny_sd3_configs``) with random weights drawn
    from ``seed``; 16x16 images, 8x8 latents, 8-token T5 context."""
    vocab = (list(words or []) + [f"w{i}" for i in range(16)]
             + ["photo", "of", "a", "an", "image", "cat", "dog"])
    tokenizer = make_tiny_tokenizer(vocab, model_max_length=16)
    tokenizer_3 = T5WordTokenizer.from_words(vocab, model_max_length=8)
    return _random_sd3(tiny_sd3_configs(tokenizer, tokenizer_3), tokenizer,
                       tokenizer_3, seed, device, dtype)


def load_sd3_pipeline(ckpt_dir, dtype=torch.bfloat16, device=None
                      ) -> SD3Components:
    """A local diffusers-format SD3 folder (``tokenizer/``,
    ``tokenizer_3/`` with ``t5_words.json``, ``text_encoder/``,
    ``text_encoder_2/``, ``text_encoder_3/``, ``transformer/``, ``vae/``,
    ``scheduler/``) -> ``SD3Components``, every model by its HF names and
    its ``config.json``."""
    dev = resolve_device(device)
    ckpt = Path(ckpt_dir)
    cfg = lambda sub: _read_config(ckpt / sub / "config.json")  # noqa: E731
    c1 = _text_config(cfg("text_encoder"), SD3_TEXT_1)
    c2 = _text_config(cfg("text_encoder_2"), SDXL_TEXT_2)
    t5 = cfg("text_encoder_3")
    mm = cfg("transformer")
    vae = cfg("vae")
    configs = (c1, c2, T5Config() if t5 is None
               else t5_config_from_transformers(t5),
               MMDiTConfig() if mm is None else mmdit_config_from_diffusers(mm),
               sd3_vae() if vae is None else vae_config_from_diffusers(vae))
    tokenizer = CLIPBPETokenizer.from_pretrained_dir(
        ckpt / "tokenizer", model_max_length=c1.max_position_embeddings)
    tokenizer_3 = T5WordTokenizer.from_pretrained_dir(ckpt / "tokenizer_3")
    models = {}
    for sub, (cls, c) in _modules(configs).items():
        state = {k: v for k, v in _load_torch_state_dict(ckpt / sub).items()
                 if not k.endswith("position_ids")}
        # T5's checkpoints carry the shared embedding under both names
        if "shared.weight" not in state and "encoder.embed_tokens.weight" in state:
            state["shared.weight"] = state["encoder.embed_tokens.weight"]
        state.pop("encoder.embed_tokens.weight", None)
        with torch.device("meta"):
            module = cls(c)
        module.load_state_dict(state, strict=True, assign=True)
        del state
        models[sub] = _frozen(module.to(dev), dtype)
    sched = _read_config(ckpt / "scheduler" / "scheduler_config.json") or {}
    return _components(models, tokenizer, tokenizer_3, configs[-1],
                       shift=float(sched.get("shift", 3.0)))


def save_sd3_pipeline(components: SD3Components, ckpt_dir) -> Path:
    """Write ``components`` as the folder ``load_sd3_pipeline`` reads
    (safetensors, diffusers' and transformers' names and config keys)."""
    from safetensors.torch import save_file

    ckpt = Path(ckpt_dir)
    components.tokenizer.save_pretrained(ckpt / "tokenizer")
    components.tokenizer_3.save_pretrained(ckpt / "tokenizer_3")
    for sub in SUBFOLDERS:
        m = getattr(components, sub)
        (ckpt / sub).mkdir(parents=True, exist_ok=True)
        c = config_dict(m.config)
        if sub == "text_encoder_3":
            c["feed_forward_proj"] = "gated-gelu"
        elif sub == "vae":
            c = dict(c, scaling_factor=components.scaling_factor,
                     shift_factor=components.shift_factor)
        (ckpt / sub / "config.json").write_text(json.dumps(c, indent=1))
        save_file({k: v.detach().contiguous().cpu()
                   for k, v in m.state_dict().items()},
                  str(ckpt / sub / "model.safetensors"))
    (ckpt / "scheduler").mkdir(parents=True, exist_ok=True)
    (ckpt / "scheduler" / "scheduler_config.json").write_text(json.dumps(
        {"_class_name": "FlowMatchEulerDiscreteScheduler",
         "num_train_timesteps": 1000, "shift": components.shift}, indent=1))
    return ckpt

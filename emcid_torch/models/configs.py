"""Model architecture configs.

The reference pulls all model definitions from HuggingFace hub at runtime
(SD v1.4 CLIP ViT-L/14 text encoder, SD UNet, VAE; SDXL dual encoders —
SURVEY.md §1 "Models involved").  Here architectures are defined natively;
configs below mirror the published architecture hyperparameters, plus tiny
randomly-initialized variants that serve as the test-suite "fake backend"
(SURVEY.md §4 implication).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field, replace
from typing import Optional, Sequence, Tuple


@dataclass(frozen=True)
class CLIPTextConfig:
    """CLIP-style text transformer (HF CLIPTextModel-compatible weights)."""

    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"  # SDXL text_encoder_2 uses "gelu"
    # projection head (used by SDXL text_encoder_2 and CLIP scorers)
    projection_dim: Optional[int] = None
    # EOS token id for pooled-output selection (49407 for CLIP BPE)
    eos_token_id: int = 49407
    # Causal attention (always true for CLIP text towers)
    causal: bool = True


# SD v1.4 text encoder: CLIP ViT-L/14, 12 layers, hidden 768, mlp.fc2 3072→768
SD_V14_TEXT = CLIPTextConfig()

# SDXL text_encoder (same CLIP ViT-L/14 tower, penultimate output used)
SDXL_TEXT_1 = CLIPTextConfig()

# SDXL text_encoder_2: OpenCLIP ViT-bigG/14 text tower
SDXL_TEXT_2 = CLIPTextConfig(
    hidden_size=1280,
    intermediate_size=5120,
    num_hidden_layers=32,
    num_attention_heads=20,
    hidden_act="gelu",
    projection_dim=1280,
)

# Tiny config for tests: 2 layers, hidden 32
TINY_TEXT = CLIPTextConfig(
    vocab_size=1024,
    hidden_size=32,
    intermediate_size=64,
    num_hidden_layers=2,
    num_attention_heads=4,
    max_position_embeddings=16,
    eos_token_id=1023,
)


@dataclass(frozen=True)
class UNetConfig:
    """SD-style UNet2DConditionModel architecture."""

    in_channels: int = 4
    out_channels: int = 4
    sample_size: int = 64
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    # per-level block kinds, bottom of the down path last
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "DownBlock2D",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
    )
    attention_head_dim: Tuple[int, ...] = (8, 8, 8, 8)
    # transformer depth per level (SDXL uses (1, 2, 10))
    transformer_layers_per_block: Tuple[int, ...] = (1, 1, 1, 1)
    cross_attention_dim: int = 768
    norm_num_groups: int = 32
    freq_shift: int = 0
    flip_sin_to_cos: bool = True
    # SDXL additions
    addition_embed_type: Optional[str] = None  # "text_time" for SDXL
    addition_time_embed_dim: Optional[int] = None
    projection_class_embeddings_input_dim: Optional[int] = None


def sd_v14_unet() -> UNetConfig:
    """SD v1.4 UNet (866M params)."""
    return UNetConfig()


def sdxl_unet() -> UNetConfig:
    """SDXL-base UNet (2.6B params): 3 levels, deep transformers, 2048-dim
    context (concat of both encoders), text_time addition embeddings."""
    return UNetConfig(
        sample_size=128,
        block_out_channels=(320, 640, 1280),
        down_block_types=(
            "DownBlock2D",
            "CrossAttnDownBlock2D",
            "CrossAttnDownBlock2D",
        ),
        up_block_types=(
            "CrossAttnUpBlock2D",
            "CrossAttnUpBlock2D",
            "UpBlock2D",
        ),
        attention_head_dim=(5, 10, 20),
        transformer_layers_per_block=(1, 2, 10),
        cross_attention_dim=2048,
        addition_embed_type="text_time",
        addition_time_embed_dim=256,
        projection_class_embeddings_input_dim=2816,
    )


def unet_config_from_diffusers(c: dict) -> UNetConfig:
    """Map a diffusers ``unet/config.json`` dict onto UNetConfig, so
    checkpoint loading isn't hardwired to the SD-v1.4/SDXL presets
    (SD v1.5 / v2 / finetunes carry the same schema)."""
    n_levels = len(c.get("block_out_channels", (320, 640, 1280, 1280)))

    def per_level(v, default):
        if v is None:
            v = default
        if isinstance(v, int):
            return (v,) * n_levels
        return tuple(v)

    return UNetConfig(
        in_channels=c.get("in_channels", 4),
        out_channels=c.get("out_channels", 4),
        sample_size=c.get("sample_size", 64),
        block_out_channels=tuple(c.get("block_out_channels",
                                       (320, 640, 1280, 1280))),
        layers_per_block=c.get("layers_per_block", 2),
        down_block_types=tuple(c.get("down_block_types",
                                     UNetConfig.down_block_types)),
        up_block_types=tuple(c.get("up_block_types",
                                   UNetConfig.up_block_types)),
        attention_head_dim=per_level(c.get("attention_head_dim"), 8),
        transformer_layers_per_block=per_level(
            c.get("transformer_layers_per_block"), 1),
        cross_attention_dim=c.get("cross_attention_dim", 768),
        norm_num_groups=c.get("norm_num_groups", 32),
        freq_shift=c.get("freq_shift", 0),
        flip_sin_to_cos=c.get("flip_sin_to_cos", True),
        addition_embed_type=c.get("addition_embed_type"),
        addition_time_embed_dim=c.get("addition_time_embed_dim"),
        projection_class_embeddings_input_dim=c.get(
            "projection_class_embeddings_input_dim"),
    )


def vae_config_from_diffusers(c: dict) -> VAEConfig:
    """Map a diffusers ``vae/config.json`` dict onto VAEConfig."""
    return VAEConfig(
        in_channels=c.get("in_channels", 3),
        out_channels=c.get("out_channels", 3),
        latent_channels=c.get("latent_channels", 4),
        block_out_channels=tuple(c.get("block_out_channels",
                                       (128, 256, 512, 512))),
        layers_per_block=c.get("layers_per_block", 2),
        norm_num_groups=c.get("norm_num_groups", 32),
        sample_size=c.get("sample_size", 512),
        scaling_factor=c.get("scaling_factor", 0.18215),
        shift_factor=c.get("shift_factor") or 0.0,
        use_quant_conv=c.get("use_quant_conv", True),
        use_post_quant_conv=c.get("use_post_quant_conv", True),
    )


def config_dict(cfg) -> dict:
    """A config as the ``config.json`` dict of its HF/diffusers folder
    (tuples as lists): the keys ``unet_config_from_diffusers``,
    ``vae_config_from_diffusers`` and ``models.loader.load_pipeline`` read
    back."""
    return {k: list(v) if isinstance(v, tuple) else v
            for k, v in asdict(cfg).items()}


def tiny_unet(cross_attention_dim: int = 32) -> UNetConfig:
    """2-level tiny UNet for tests."""
    return UNetConfig(
        sample_size=8,
        block_out_channels=(32, 64),
        layers_per_block=1,
        down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
        up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
        attention_head_dim=(4, 4),
        transformer_layers_per_block=(1, 1),
        cross_attention_dim=cross_attention_dim,
        norm_num_groups=8,
    )


@dataclass(frozen=True)
class VAEConfig:
    """AutoencoderKL architecture (SD v1.x / SDXL share the shape)."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    sample_size: int = 512
    scaling_factor: float = 0.18215  # SDXL: 0.13025
    # SD3: latents are (mean - shift_factor) * scaling_factor, and the
    # 1x1 quant convs are absent
    shift_factor: float = 0.0
    use_quant_conv: bool = True
    use_post_quant_conv: bool = True


def sd_vae() -> VAEConfig:
    return VAEConfig()


def sdxl_vae() -> VAEConfig:
    return VAEConfig(sample_size=1024, scaling_factor=0.13025)


def tiny_vae() -> VAEConfig:
    return VAEConfig(
        block_out_channels=(16, 32),
        layers_per_block=1,
        norm_num_groups=4,
        sample_size=32,
    )


def sd3_vae() -> VAEConfig:
    """SD3's VAE: 16 latent channels, no quant convs, latents
    (mean - 0.0609) * 1.5305."""
    return VAEConfig(latent_channels=16, sample_size=1024,
                     scaling_factor=1.5305, shift_factor=0.0609,
                     use_quant_conv=False, use_post_quant_conv=False)


@dataclass(frozen=True)
class MMDiTConfig:
    """diffusers' ``SD3Transformer2DModel`` (MMDiT, and MMDiT-X with
    ``dual_attention_layers``); defaults are SD3.5 Medium's
    ``transformer/config.json``."""

    sample_size: int = 128
    patch_size: int = 2
    in_channels: int = 16
    out_channels: int = 16
    num_layers: int = 24
    attention_head_dim: int = 64
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096
    caption_projection_dim: int = 1536
    pooled_projection_dim: int = 2048
    pos_embed_max_size: int = 384
    dual_attention_layers: Tuple[int, ...] = tuple(range(13))
    qk_norm: Optional[str] = "rms_norm"

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim


def mmdit_config_from_diffusers(c: dict) -> MMDiTConfig:
    """Map a diffusers ``transformer/config.json`` dict onto MMDiTConfig."""
    keys = {f for f in MMDiTConfig.__dataclass_fields__}
    kw = {k: v for k, v in c.items() if k in keys}
    kw["dual_attention_layers"] = tuple(c.get("dual_attention_layers") or ())
    kw.setdefault("qk_norm", None)
    return MMDiTConfig(**kw)


@dataclass(frozen=True)
class T5Config:
    """transformers' ``T5EncoderModel`` (v1.1: gated ``gelu_new``
    feed-forward, untied head); defaults are T5-v1.1-XXL, SD3's
    ``text_encoder_3``."""

    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6


def t5_config_from_transformers(c: dict) -> T5Config:
    """Map a transformers T5 ``config.json`` dict onto T5Config; only
    v1.1's ``feed_forward_proj`` "gated-gelu" is ported."""
    ff = c.get("feed_forward_proj", "gated-gelu")
    if ff != "gated-gelu":
        raise NotImplementedError(f"feed_forward_proj={ff!r}: only T5 "
                                  "v1.1's gated gelu_new is ported")
    keys = T5Config.__dataclass_fields__
    return T5Config(**{k: v for k, v in c.items() if k in keys})

"""The CLIP vision tower: images -> projected CLIP image embeddings.

Counterpart of the CLIP-vision part of ``emcid_tpu/models/vision.py``; it
serves the txt-img-align term of Stage 1.  Parameter names are HF
``CLIPVisionModelWithProjection``'s (``vision_model.embeddings.*``,
``vision_model.encoder.layers.{i}.*``, ``visual_projection.weight``), so an
HF state dict, the same one the JAX package's ``clip_vision_from_torch``
takes, loads with ``load_state_dict``.  The encoder layer is the text
encoder's (``models/clip_text.CLIPEncoderLayer``) without the causal mask:
its 257-token attention is the einsum/softmax path, as in the JAX package.
Images are channel-last (B, H, W, 3) at the module's boundary, as in the
JAX package.  ``ViTClassifier`` and ``CLIPScorer`` wait (ROADMAP M8).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from emcid_torch.models.clip_text import CLIPEncoderLayer
from emcid_torch.models.configs import CLIPTextConfig

CLIP_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def preprocess_for_model(images, size: int, mean, std,
                         device=None) -> torch.Tensor:
    """uint8 or float RGB (B, H, W, 3) -> resized (bilinear, antialiased
    when shrinking) and normalized (B, size, size, 3) f32."""
    x = torch.as_tensor(images if torch.is_tensor(images)
                        else np.asarray(images), device=device)
    if x.dim() == 3:
        x = x[None]
    x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
    if tuple(x.shape[1:3]) != (size, size):
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size),
                          mode="bilinear", align_corners=False,
                          antialias=True).permute(0, 2, 3, 1)
    mean = torch.as_tensor(np.asarray(mean), device=x.device)
    std = torch.as_tensor(np.asarray(std), device=x.device)
    return (x - mean) / std


@dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    projection_dim: int = 768
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"


CLIP_VIT_L14_VISION = CLIPVisionConfig()
TINY_CLIP_VISION = CLIPVisionConfig(
    image_size=32, patch_size=8, hidden_size=32, num_hidden_layers=2,
    num_attention_heads=4, intermediate_size=64, projection_dim=16)


class _VisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.position_embedding = nn.Embedding(n_pos, cfg.hidden_size)


class _VisionEncoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        layer_cfg = CLIPTextConfig(
            hidden_size=cfg.hidden_size,
            intermediate_size=cfg.intermediate_size,
            num_attention_heads=cfg.num_attention_heads,
            num_hidden_layers=cfg.num_hidden_layers,
            layer_norm_eps=cfg.layer_norm_eps, hidden_act=cfg.hidden_act,
            causal=False)
        self.layers = nn.ModuleList(CLIPEncoderLayer(layer_cfg)
                                    for _ in range(cfg.num_hidden_layers))


class _VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = _VisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size,
                                         eps=cfg.layer_norm_eps)  # HF's name
        self.encoder = _VisionEncoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size,
                                           eps=cfg.layer_norm_eps)


class CLIPVisionEncoder(nn.Module):
    """CLIP vision transformer -> projected, unnormalized image embedding
    (B, projection_dim); input (B, H, W, 3) in CLIP-normalized space."""

    def __init__(self, config: CLIPVisionConfig):
        super().__init__()
        self.config = config
        self.vision_model = _VisionTransformer(config)
        self.visual_projection = nn.Linear(config.hidden_size,
                                           config.projection_dim, bias=False)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        vm = self.vision_model
        emb = vm.embeddings
        dtype = emb.patch_embedding.weight.dtype
        x = emb.patch_embedding(pixel_values.permute(0, 3, 1, 2).to(dtype))
        x = x.flatten(2).transpose(1, 2)  # (B, patches, hidden), row-major
        cls = emb.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + emb.position_embedding.weight
        x = vm.pre_layrnorm(x)
        for layer in vm.encoder.layers:
            x, _, _ = layer(x, 0.0)  # no mask: every token sees every token
        return self.visual_projection(vm.post_layernorm(x[:, 0]))


def build_random_clip_vision(config: CLIPVisionConfig = CLIP_VIT_L14_VISION,
                             seed: int = 0, dtype=torch.float32,
                             device=None) -> CLIPVisionEncoder:
    """A frozen tower with seeded random weights (the pipelines' scheme:
    normal(0, fan_in^-1/2) matrices, zero biases, unit 1-D parameters)."""
    from emcid_torch.models.loader import _frozen, _random_init_
    from emcid_torch.runtime import resolve_device

    dev = resolve_device(device)
    with torch.device(dev):
        model = CLIPVisionEncoder(config)
    _random_init_(model, torch.Generator(device=dev).manual_seed(seed))
    return _frozen(model, dtype)

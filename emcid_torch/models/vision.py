"""Vision towers for scoring and alignment: the ViT classifier, the CLIP
vision tower and the full CLIP scorer.

Counterpart of ``emcid_tpu/models/vision.py``.  Parameter names are HF's:
``ViTForImageClassification`` (``vit.embeddings.*``,
``vit.encoder.layer.{i}.*``, ``classifier``) for ``ViTClassifier`` and
``CLIPVisionModelWithProjection`` (``vision_model.embeddings.*``,
``vision_model.encoder.layers.{i}.*``, ``visual_projection.weight``) for
``CLIPVisionEncoder``, so the HF state dicts that the JAX package's
``vit_from_torch`` and ``clip_vision_from_torch`` take load with
``load_state_dict``.  The CLIP encoder layer is the text encoder's
(``models/clip_text.CLIPEncoderLayer``) without the causal mask.  Every
attention here (197 or 257 tokens) is the einsum/softmax path, as in the
JAX package; the ViT's GELU is exact.  Images are channel-last
(B, H, W, 3) at the modules' boundary, as in the JAX package.  The tower
serves the txt-img-align term of Stage 1; ``ViTClassifier`` and
``CLIPScorer`` serve the evaluation harness (``evals/``), in exact f32
(``runtime.precise_matmuls``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from emcid_torch.models.clip_text import CLIPEncoderLayer
from emcid_torch.models.configs import CLIPTextConfig
from emcid_torch.runtime import precise_matmuls

CLIP_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
VIT_IMAGE_MEAN = np.array([0.5, 0.5, 0.5], np.float32)
VIT_IMAGE_STD = np.array([0.5, 0.5, 0.5], np.float32)


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


# ---------------------------------------------------------------------------
# ViT classifier (HF ViTForImageClassification names)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    num_labels: int = 1000
    layer_norm_eps: float = 1e-12


VIT_BASE_224 = ViTConfig()
VIT_LARGE_224 = ViTConfig(hidden_size=1024, num_hidden_layers=24,
                          num_attention_heads=16, intermediate_size=4096)
TINY_VIT = ViTConfig(image_size=32, patch_size=8, hidden_size=32,
                     num_hidden_layers=2, num_attention_heads=4,
                     intermediate_size=64, num_labels=10)


class _ViTSelfAttention(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)

    def forward(self, x):
        B, N, h = x.shape
        nh = self.num_heads
        hd = h // nh
        split = lambda t: t.reshape(B, N, nh, hd)
        scores = torch.einsum("bqhd,bkhd->bhqk", split(self.query(x)),
                              split(self.key(x))) * hd ** -0.5
        probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs,
                            split(self.value(x))).reshape(B, N, h)


class _ViTDense(nn.Module):
    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.dense = nn.Linear(n_in, n_out)


class _ViTAttention(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.attention = _ViTSelfAttention(cfg)
        self.output = _ViTDense(cfg.hidden_size, cfg.hidden_size)


class _ViTLayer(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.attention = _ViTAttention(cfg)
        self.intermediate = _ViTDense(h, cfg.intermediate_size)
        self.output = _ViTDense(cfg.intermediate_size, h)
        self.layernorm_before = nn.LayerNorm(h, eps=eps)
        self.layernorm_after = nn.LayerNorm(h, eps=eps)

    def forward(self, x):
        attn = self.attention
        h = x + attn.output.dense(attn.attention(self.layernorm_before(x)))
        y = F.gelu(self.intermediate.dense(self.layernorm_after(h)),
                   approximate="none")
        return h + self.output.dense(y)


class _ViTPatches(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.projection = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                    stride=cfg.patch_size)


class _ViTEmbeddings(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.hidden_size))
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, n_pos, cfg.hidden_size))
        self.patch_embeddings = _ViTPatches(cfg)


class _ViTEncoder(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.layer = nn.ModuleList(_ViTLayer(cfg)
                                   for _ in range(cfg.num_hidden_layers))


class _ViTModel(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.embeddings = _ViTEmbeddings(cfg)
        self.encoder = _ViTEncoder(cfg)
        self.layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class ViTClassifier(nn.Module):
    """ViT image classifier -> logits (B, num_labels); input (B, H, W, 3)
    in model-normalized space."""

    def __init__(self, config: ViTConfig):
        super().__init__()
        self.config = config
        self.vit = _ViTModel(config)
        self.classifier = nn.Linear(config.hidden_size, config.num_labels)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        emb = self.vit.embeddings
        dtype = emb.cls_token.dtype
        x = emb.patch_embeddings.projection(
            pixel_values.permute(0, 3, 1, 2).to(dtype))
        x = x.flatten(2).transpose(1, 2)  # (B, patches, hidden), row-major
        cls = emb.cls_token.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + emb.position_embeddings
        for layer in self.vit.encoder.layer:
            x = layer(x)
        return self.classifier(self.vit.layernorm(x)[:, 0])


def build_random_vit(config: ViTConfig = VIT_BASE_224, seed: int = 0,
                     dtype=torch.float32, device=None) -> ViTClassifier:
    """A frozen classifier with seeded random weights (the pipelines'
    scheme)."""
    from emcid_torch.models.loader import _frozen, _random_init_
    from emcid_torch.runtime import resolve_device

    dev = resolve_device(device)
    with torch.device(dev):
        model = ViTClassifier(config)
    _random_init_(model, torch.Generator(device=dev).manual_seed(seed))
    return _frozen(model, dtype)


# ---------------------------------------------------------------------------
# the full CLIP scorer
# ---------------------------------------------------------------------------


@dataclass
class CLIPScorer:
    """Full CLIP: the text tower with its projection, the vision tower and
    the logit scale.  Both towers run in exact f32 (no TF32 in the matmuls
    or the patch convolution)."""

    text_model: Any  # CLIPTextEncoder with projection_dim set
    vision_model: CLIPVisionEncoder
    tokenizer: Any
    logit_scale: float = 100.0  # exp(4.6052), the trained CLIP value

    @torch.no_grad()
    def image_embeds(self, images) -> torch.Tensor:
        dev = next(self.vision_model.parameters()).device
        with precise_matmuls():
            x = preprocess_for_model(images,
                                     self.vision_model.config.image_size,
                                     CLIP_IMAGE_MEAN, CLIP_IMAGE_STD,
                                     device=dev)
            emb = self.vision_model(x).float()
        return emb / emb.norm(dim=-1, keepdim=True)

    @torch.no_grad()
    def text_embeds(self, texts: Sequence[str]) -> torch.Tensor:
        dev = next(self.text_model.parameters()).device
        enc = self.tokenizer(list(texts))
        with precise_matmuls():
            emb = self.text_model(torch.as_tensor(
                enc["input_ids"], device=dev).long()).pooled_output.float()
        return emb / emb.norm(dim=-1, keepdim=True)

    def logits_per_image(self, images, texts) -> torch.Tensor:
        with precise_matmuls():
            return (self.logit_scale * self.image_embeds(images)
                    @ self.text_embeds(texts).T)

    def clip_score(self, images, texts,
                   prefix: str = "A photo depicts ") -> np.ndarray:
        """The reference's 2.5 * cosine per (image, text) pair."""
        cos = self.image_embeds(images) * self.text_embeds(
            [prefix + t for t in texts])
        return (2.5 * cos.sum(-1)).cpu().numpy()

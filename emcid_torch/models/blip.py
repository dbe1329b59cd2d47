"""BLIP image-text matching (ITM) model.

Counterpart of ``emcid_tpu/models/blip.py``: the model the reference scores
causal-trace images with (HF ``BlipForImageTextRetrieval``'s ITM head,
``softmax(itm_score)[:, 1]`` on "A photo depicts {text}").  A pre-LN ViT
vision tower with fused-qkv attention, a post-LN BERT text encoder whose
every layer cross-attends to the whole image sequence, and the 2-way ITM
head on token 0.  Module names are HF's, so ``blip_from_torch`` keeps an
HF state dict's keys as they are.  Images are channel-last (B, H, W, 3) at
the module's boundary, as in the JAX package.  The attention (577 image
tokens at BLIP-base) is the plain einsum/softmax path, as in the JAX
package, which reaches no Pallas kernel there.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from emcid_torch.runtime import precise_matmuls


@dataclass(frozen=True)
class BlipVisionConfig:
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    image_size: int = 384
    patch_size: int = 16
    layer_norm_eps: float = 1e-5


@dataclass(frozen=True)
class BlipTextConfig:
    vocab_size: int = 30524
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    encoder_hidden_size: int = 768
    layer_norm_eps: float = 1e-12


TINY_BLIP_VISION = BlipVisionConfig(hidden_size=24, num_hidden_layers=2,
                                    num_attention_heads=2,
                                    intermediate_size=48, image_size=32,
                                    patch_size=16)
TINY_BLIP_TEXT = BlipTextConfig(vocab_size=100, hidden_size=32,
                                num_hidden_layers=2, num_attention_heads=2,
                                intermediate_size=64, encoder_hidden_size=24)


def _attn(q, k, v, heads: int, mask: Optional[torch.Tensor] = None):
    B, N, H = q.shape
    M = k.shape[1]
    d = H // heads
    dk = k.shape[-1] // heads
    q = q.reshape(B, N, heads, d)
    k = k.reshape(B, M, heads, dk)
    v = v.reshape(B, M, heads, dk)
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) * (d ** -0.5)
    if mask is not None:
        s = s + mask
    # f32 softmax for the half types; float64 stays float64
    p = torch.softmax(s.to(torch.promote_types(s.dtype, torch.float32)),
                      dim=-1).to(v.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", p, v).reshape(B, N, heads * dk)


# ---------------------------------------------------------------------------
# vision tower
# ---------------------------------------------------------------------------


class _VisionAttention(nn.Module):
    def __init__(self, cfg: BlipVisionConfig):
        super().__init__()
        self.heads = cfg.num_attention_heads
        self.qkv = nn.Linear(cfg.hidden_size, 3 * cfg.hidden_size)
        self.projection = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, x):
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        return self.projection(_attn(q, k, v, self.heads))


class _VisionMLP(nn.Module):
    def __init__(self, cfg: BlipVisionConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class BlipVisionLayer(nn.Module):
    def __init__(self, cfg: BlipVisionConfig):
        super().__init__()
        self.self_attn = _VisionAttention(cfg)
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = _VisionMLP(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class _VisionEmbeddings(nn.Module):
    def __init__(self, cfg: BlipVisionConfig):
        super().__init__()
        n = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.class_embedding = nn.Parameter(torch.zeros(1, 1, cfg.hidden_size))
        self.position_embedding = nn.Parameter(
            torch.zeros(1, n, cfg.hidden_size))
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                         stride=cfg.patch_size)


class _VisionEncoder(nn.Module):
    def __init__(self, cfg: BlipVisionConfig):
        super().__init__()
        self.layers = nn.ModuleList(BlipVisionLayer(cfg)
                                    for _ in range(cfg.num_hidden_layers))


class BlipVisionModel(nn.Module):
    """Pre-LN ViT returning the full patch sequence (BLIP cross-attends to
    every position, not just [CLS])."""

    def __init__(self, config: BlipVisionConfig):
        super().__init__()
        self.config = config
        self.embeddings = _VisionEmbeddings(config)
        self.encoder = _VisionEncoder(config)
        self.post_layernorm = nn.LayerNorm(config.hidden_size,
                                           eps=config.layer_norm_eps)

    def forward(self, pixel_values):
        emb = self.embeddings
        x = emb.patch_embedding(pixel_values.permute(0, 3, 1, 2).to(
            emb.patch_embedding.weight.dtype))
        x = x.flatten(2).transpose(1, 2)  # (B, patches, hidden), row-major
        cls = emb.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1)
        x = x + emb.position_embedding[:, : x.shape[1]]
        for layer in self.encoder.layers:
            x = layer(x)
        return self.post_layernorm(x)


# ---------------------------------------------------------------------------
# multimodal text encoder
# ---------------------------------------------------------------------------


class _SelfAttention(nn.Module):
    def __init__(self, cfg: BlipTextConfig, kv_width: int):
        super().__init__()
        self.heads = cfg.num_attention_heads
        self.query = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.key = nn.Linear(kv_width, cfg.hidden_size)
        self.value = nn.Linear(kv_width, cfg.hidden_size)

    def forward(self, x, kv, mask):
        return _attn(self.query(x), self.key(kv), self.value(kv), self.heads,
                     mask)


class _Output(nn.Module):
    def __init__(self, cfg: BlipTextConfig, width: int):
        super().__init__()
        self.dense = nn.Linear(width, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, h, residual):
        return self.LayerNorm(residual + self.dense(h))


class _Attention(nn.Module):
    def __init__(self, cfg: BlipTextConfig, kv_width: int):
        super().__init__()
        self.self = _SelfAttention(cfg, kv_width)
        self.output = _Output(cfg, cfg.hidden_size)

    def forward(self, x, kv, mask):
        return self.output(self.self(x, kv, mask), x)


class _Intermediate(nn.Module):
    def __init__(self, cfg: BlipTextConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, x):
        return F.gelu(self.dense(x))


class BertLayer(nn.Module):
    """Post-LN BERT layer with cross-attention (BLIP's text encoder in
    multimodal mode: every layer attends to the image sequence)."""

    def __init__(self, cfg: BlipTextConfig):
        super().__init__()
        self.attention = _Attention(cfg, cfg.hidden_size)
        self.crossattention = _Attention(cfg, cfg.encoder_hidden_size)
        self.intermediate = _Intermediate(cfg)
        self.output = _Output(cfg, cfg.intermediate_size)

    def forward(self, x, enc, self_mask):
        x = self.attention(x, x, self_mask)
        if enc is not None:
            x = self.crossattention(x, enc, None)
        return self.output(self.intermediate(x), x)


class _TextEmbeddings(nn.Module):
    def __init__(self, cfg: BlipTextConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class _TextEncoder(nn.Module):
    def __init__(self, cfg: BlipTextConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg)
                                   for _ in range(cfg.num_hidden_layers))


class BlipTextModel(nn.Module):
    def __init__(self, config: BlipTextConfig):
        super().__init__()
        self.config = config
        self.embeddings = _TextEmbeddings(config)
        self.encoder = _TextEncoder(config)

    def forward(self, input_ids, attention_mask=None,
                encoder_hidden_states=None):
        emb = self.embeddings
        S = input_ids.shape[1]
        x = emb.word_embeddings(input_ids) + emb.position_embeddings.weight[:S]
        x = emb.LayerNorm(x)
        self_mask = None
        if attention_mask is not None:
            self_mask = (1.0 - attention_mask[:, None, None, :].float()) * -1e9
        for layer in self.encoder.layer:
            x = layer(x, encoder_hidden_states, self_mask)
        return x


class BlipITM(nn.Module):
    """Vision tower + multimodal text encoder + 2-way ITM head."""

    def __init__(self, vision_config: BlipVisionConfig,
                 text_config: BlipTextConfig):
        super().__init__()
        self.vision_config = vision_config
        self.text_config = text_config
        self.vision_model = BlipVisionModel(vision_config)
        self.text_encoder = BlipTextModel(text_config)
        self.itm_head = nn.Linear(text_config.hidden_size, 2)

    def forward(self, pixel_values, input_ids, attention_mask=None):
        image_embeds = self.vision_model(pixel_values)
        q = self.text_encoder(input_ids, attention_mask, image_embeds)
        return self.itm_head(q[:, 0, :])  # (B, 2) logits


# ---------------------------------------------------------------------------
# conversion
# ---------------------------------------------------------------------------

# keys of an HF BlipForImageTextRetrieval state dict that the ITM score
# does not use: the contrastive projections, the text pooler and the
# position-id buffers
_UNUSED_PREFIXES = ("vision_proj.", "text_proj.", "text_encoder.pooler.")


def blip_from_torch(state_dict: Dict[str, Any],
                    model: BlipITM) -> Dict[str, torch.Tensor]:
    """An HF ``BlipForImageTextRetrieval`` state dict -> ``model``'s (the
    same names): the keys the ITM score does not use dropped; any other key
    that ``model`` lacks raises, as does a key of ``model`` that the state
    dict lacks."""
    out = {}
    for key, w in state_dict.items():
        if key.startswith(_UNUSED_PREFIXES) or key.endswith("position_ids"):
            continue
        out[key] = torch.as_tensor(np.asarray(
            w.detach().cpu().float() if torch.is_tensor(w) else w,
            np.float32))
    want = set(model.state_dict())
    unknown, missing = sorted(set(out) - want), sorted(want - set(out))
    if unknown or missing:
        raise ValueError(f"BLIP state dict: unknown keys {unknown[:5]}, "
                         f"missing keys {missing[:5]}")
    return out


def blip_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's Flax tree (numpy leaves) -> ``BlipITM``'s state
    dict: dense kernels transposed, the patch kernel HWIO -> OIHW."""
    t = lambda a: torch.tensor(np.asarray(a, np.float32))
    out: Dict[str, torch.Tensor] = {}

    def dense(name, p):
        out[f"{name}.weight"] = t(np.asarray(p["kernel"]).T)
        out[f"{name}.bias"] = t(p["bias"])

    def ln(name, p):
        out[f"{name}.weight"] = t(p["scale"])
        out[f"{name}.bias"] = t(p["bias"])

    v = params["vision_model"]
    out["vision_model.embeddings.patch_embedding.weight"] = t(
        np.asarray(v["patch_embedding"]["kernel"]).transpose(3, 2, 0, 1))
    out["vision_model.embeddings.patch_embedding.bias"] = t(
        v["patch_embedding"]["bias"])
    out["vision_model.embeddings.class_embedding"] = t(v["class_embedding"])
    out["vision_model.embeddings.position_embedding"] = t(
        v["position_embedding"])
    i = 0
    while f"layers_{i}" in v:
        p, b = v[f"layers_{i}"], f"vision_model.encoder.layers.{i}"
        ln(f"{b}.layer_norm1", p["layer_norm1"])
        ln(f"{b}.layer_norm2", p["layer_norm2"])
        dense(f"{b}.self_attn.qkv", p["qkv"])
        dense(f"{b}.self_attn.projection", p["projection"])
        dense(f"{b}.mlp.fc1", p["fc1"])
        dense(f"{b}.mlp.fc2", p["fc2"])
        i += 1
    ln("vision_model.post_layernorm", v["post_layernorm"])
    te = params["text_encoder"]
    out["text_encoder.embeddings.word_embeddings.weight"] = t(
        te["word_embeddings"]["embedding"])
    out["text_encoder.embeddings.position_embeddings.weight"] = t(
        te["position_embeddings"])
    ln("text_encoder.embeddings.LayerNorm", te["embeddings_ln"])
    i = 0
    while f"layer_{i}" in te:
        p, b = te[f"layer_{i}"], f"text_encoder.encoder.layer.{i}"
        for kind in ("attention", "crossattention"):
            for proj in ("query", "key", "value"):
                dense(f"{b}.{kind}.self.{proj}", p[kind][proj])
            dense(f"{b}.{kind}.output.dense", p[f"{kind}_out"])
            ln(f"{b}.{kind}.output.LayerNorm", p[f"{kind}_ln"])
        dense(f"{b}.intermediate.dense", p["intermediate"])
        dense(f"{b}.output.dense", p["output_out"])
        ln(f"{b}.output.LayerNorm", p["output_ln"])
        i += 1
    dense("itm_head", params["itm_head"])
    return out


def build_random_blip(vision_config: BlipVisionConfig = BlipVisionConfig(),
                      text_config: BlipTextConfig = BlipTextConfig(),
                      seed: int = 0, device=None) -> BlipITM:
    """A frozen f32 ``BlipITM`` with seeded random weights (the loader's
    init: normal(0, fan_in^-1/2) matrices, unit LayerNorm scales, zero
    biases)."""
    from emcid_torch.models.loader import _frozen, _random_init_

    with torch.device(device or "cpu"):
        model = BlipITM(vision_config, text_config)
    _random_init_(model, torch.Generator(device=device or "cpu")
                  .manual_seed(seed))
    return _frozen(model, torch.float32)


# ---------------------------------------------------------------------------
# scoring (reference calculate_single_blip_score, util/evaluate.py:219-248)
# ---------------------------------------------------------------------------


class NativeBlipScorer:
    """ITM match probability P(match) = softmax(itm_logits)[:, 1], in exact
    f32 on the model's device."""

    def __init__(self, model: BlipITM, tokenizer,
                 prefix: str = "A photo depicts "):
        self.model = model
        self.tokenizer = tokenizer
        self.prefix = prefix

    @torch.no_grad()
    def itm_score(self, images, texts: Sequence[str]) -> np.ndarray:
        from emcid_torch.models.vision import (
            CLIP_IMAGE_MEAN, CLIP_IMAGE_STD, preprocess_for_model,
        )

        dev = next(self.model.parameters()).device
        px = preprocess_for_model(images, self.model.vision_config.image_size,
                                  CLIP_IMAGE_MEAN, CLIP_IMAGE_STD, device=dev)
        # truncated like the HF processor: a row longer than the position
        # table would not broadcast against it
        enc = self.tokenizer(
            [self.prefix + t for t in texts], padding=True, truncation=True,
            max_length=self.model.text_config.max_position_embeddings)
        ids = torch.as_tensor(np.asarray(enc["input_ids"]), dtype=torch.long,
                              device=dev)
        mask = torch.as_tensor(np.asarray(enc["attention_mask"]),
                               dtype=torch.float32, device=dev)
        with precise_matmuls():
            logits = self.model(px, ids, mask)
        return torch.softmax(logits.float(), dim=-1)[:, 1].cpu().numpy()

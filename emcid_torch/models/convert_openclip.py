"""open_clip checkpoint conversion (the ViT-bigG-14 scorer of RoAD/TIMED,
reference refact_benchmark_eval.py:361-364, and SDXL's text_encoder_2
original weights).

Counterpart of ``emcid_tpu/models/convert_openclip.py``.  The open_clip
state-dict layout differs from HF CLIP's:
  text:  token_embedding.weight, positional_embedding,
         transformer.resblocks.{i}.{ln_1,ln_2}.{weight,bias},
         .attn.in_proj_weight/in_proj_bias (fused qkv), .attn.out_proj,
         .mlp.c_fc, .mlp.c_proj, ln_final, text_projection (matrix param)
  vision: visual.conv1.weight, visual.class_embedding,
         visual.positional_embedding, visual.ln_pre, visual.ln_post,
         visual.transformer.resblocks..., visual.proj

Both convert onto the HF names of the port's ``CLIPTextEncoder`` and
``CLIPVisionEncoder`` state dicts: the fused qkv split into q/k/v, and
``text_projection`` / ``visual.proj`` (stored (H, proj), applied as
``x @ P``) transposed into ``nn.Linear`` weights.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.detach().cpu().float().clone()
    return torch.tensor(np.asarray(x, np.float32))


def _resblock(sd: Mapping, prefix: str, out: str) -> Dict[str, torch.Tensor]:
    """One open_clip residual block -> the HF ``CLIPEncoderLayer`` names
    under ``out``."""
    in_w = _t(sd[f"{prefix}.attn.in_proj_weight"])  # (3H, H)
    in_b = _t(sd[f"{prefix}.attn.in_proj_bias"])
    H = in_w.shape[1]
    p: Dict[str, torch.Tensor] = {}
    for i, name in enumerate(("q_proj", "k_proj", "v_proj")):
        p[f"{out}.self_attn.{name}.weight"] = in_w[i * H:(i + 1) * H].clone()
        p[f"{out}.self_attn.{name}.bias"] = in_b[i * H:(i + 1) * H].clone()
    for ours, theirs in (("self_attn.out_proj", "attn.out_proj"),
                         ("mlp.fc1", "mlp.c_fc"), ("mlp.fc2", "mlp.c_proj"),
                         ("layer_norm1", "ln_1"), ("layer_norm2", "ln_2")):
        for leaf in ("weight", "bias"):
            p[f"{out}.{ours}.{leaf}"] = _t(sd[f"{prefix}.{theirs}.{leaf}"])
    return p


def openclip_text_from_torch(state_dict: Mapping[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    """open_clip text tower -> ``CLIPTextEncoder`` state dict (with
    ``text_projection`` when the checkpoint has one)."""
    sd = state_dict
    p: Dict[str, torch.Tensor] = {
        "text_model.embeddings.token_embedding.weight":
            _t(sd["token_embedding.weight"]),
        "text_model.embeddings.position_embedding.weight":
            _t(sd["positional_embedding"]),
        "text_model.final_layer_norm.weight": _t(sd["ln_final.weight"]),
        "text_model.final_layer_norm.bias": _t(sd["ln_final.bias"]),
    }
    i = 0
    while f"transformer.resblocks.{i}.attn.in_proj_weight" in sd:
        p.update(_resblock(sd, f"transformer.resblocks.{i}",
                           f"text_model.encoder.layers.{i}"))
        i += 1
    if "text_projection" in sd:
        p["text_projection.weight"] = _t(sd["text_projection"]).T.contiguous()
    return p


def openclip_vision_from_torch(state_dict: Mapping[str, Any]
                               ) -> Dict[str, torch.Tensor]:
    """open_clip visual tower -> ``CLIPVisionEncoder`` state dict."""
    sd = {k[len("visual."):]: v for k, v in state_dict.items()
          if k.startswith("visual.")} or dict(state_dict)
    vm = "vision_model"
    p: Dict[str, torch.Tensor] = {
        f"{vm}.embeddings.class_embedding": _t(sd["class_embedding"]),
        f"{vm}.embeddings.patch_embedding.weight": _t(sd["conv1.weight"]),
        f"{vm}.embeddings.position_embedding.weight":
            _t(sd["positional_embedding"]),
        f"{vm}.pre_layrnorm.weight": _t(sd["ln_pre.weight"]),
        f"{vm}.pre_layrnorm.bias": _t(sd["ln_pre.bias"]),
        f"{vm}.post_layernorm.weight": _t(sd["ln_post.weight"]),
        f"{vm}.post_layernorm.bias": _t(sd["ln_post.bias"]),
    }
    i = 0
    while f"transformer.resblocks.{i}.attn.in_proj_weight" in sd:
        p.update(_resblock(sd, f"transformer.resblocks.{i}",
                           f"{vm}.encoder.layers.{i}"))
        i += 1
    if "proj" in sd:
        p["visual_projection.weight"] = _t(sd["proj"]).T.contiguous()
    return p


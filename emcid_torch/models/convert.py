"""JAX parameter trees -> the port's state dicts.

The JAX package holds weights as Flax trees (nested dicts of arrays); the
port's ``nn.Module``s use the HF/diffusers parameter names, so a converted
tree loads with ``load_state_dict(strict=True)``.  The mapping is the JAX
package's own (``emcid_tpu/models/convert_hf.py``: ``clip_text_to_torch``,
``unet_to_torch``, ``vae_to_torch``), kept here as a copy because the port
imports nothing of the JAX package.  Inputs are nested dicts of numpy
arrays (``jax.tree.map(np.asarray, params)`` on the JAX side); outputs are
dicts of numpy arrays in torch orientation.
"""

from __future__ import annotations

import re as _re
from typing import Any, Dict, Tuple

import numpy as np


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def clip_text_to_torch(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Inverse mapping (for exporting edited weights back to an HF
    checkpoint; the reference never persists edits — SURVEY.md §5 — but we
    support it)."""
    sd: Dict[str, np.ndarray] = {}
    p = params
    sd["text_model.embeddings.token_embedding.weight"] = _np(
        p["token_embedding"]["embedding"]
    )
    sd["text_model.embeddings.position_embedding.weight"] = _np(
        p["position_embedding"]["embedding"]
    )
    for key, sub in p.items():
        if not key.startswith("layers_"):
            continue
        idx = key.split("_", 1)[1]
        base = f"text_model.encoder.layers.{idx}"
        for mod_name, leaf in _iter_modules(sub):
            torch_mod = f"{base}.{mod_name}"
            if "kernel" in leaf:
                sd[f"{torch_mod}.weight"] = _np(leaf["kernel"]).T
                if "bias" in leaf:
                    sd[f"{torch_mod}.bias"] = _np(leaf["bias"])
            elif "scale" in leaf:
                sd[f"{torch_mod}.weight"] = _np(leaf["scale"])
                sd[f"{torch_mod}.bias"] = _np(leaf["bias"])
    if "final_layer_norm" in p:
        sd["text_model.final_layer_norm.weight"] = _np(p["final_layer_norm"]["scale"])
        sd["text_model.final_layer_norm.bias"] = _np(p["final_layer_norm"]["bias"])
    if "text_projection" in p:
        sd["text_projection.weight"] = _np(p["text_projection"]["kernel"]).T
    return sd


def _iter_modules(tree: Dict[str, Any], prefix: str = ""):
    """Yield (dotted_name, leaf_dict) for each module holding array leaves."""
    has_leaf = any(not isinstance(v, dict) for v in tree.values())
    if has_leaf:
        yield prefix.rstrip("."), tree
        return
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _iter_modules(v, prefix + k + ".")


# Ordered structural rewrite rules, applied per path component.  Explicit
# rather than heuristic: underscore-flattened names are ambiguous
# ("mid_block_resnets_0" must become "mid_block.resnets.0", but
# "quant_conv" must stay as-is), so each known shape is listed.
_COMPONENT_RULES = [
    (_re.compile(r"^(down_blocks|up_blocks)_(\d+)_"
                 r"(resnets|attentions|downsamplers|upsamplers)_(\d+)_conv$"),
     r"\1.\2.\3.\4.conv"),
    (_re.compile(r"^(down_blocks|up_blocks)_(\d+)_"
                 r"(resnets|attentions|downsamplers|upsamplers)_(\d+)$"),
     r"\1.\2.\3.\4"),
    (_re.compile(r"^mid_block_(resnets|attentions)_(\d+)$"),
     r"mid_block.\1.\2"),
    (_re.compile(r"^transformer_blocks_(\d+)$"), r"transformer_blocks.\1"),
    (_re.compile(r"^to_out_0$"), "to_out.0"),
    (_re.compile(r"^net_0_proj$"), "net.0.proj"),
    (_re.compile(r"^net_2$"), "net.2"),
    (_re.compile(r"^time_embedding_linear_(\d)$"), r"time_embedding.linear_\1"),
    (_re.compile(r"^add_embedding_linear_(\d)$"), r"add_embedding.linear_\1"),
    (_re.compile(r"^layers_(\d+)$"), r"layers.\1"),
]


def _flax_component_to_hf(name: str) -> str:
    """'down_blocks_0_resnets_0' → 'down_blocks.0.resnets.0' etc.; names
    with no structural match pass through unchanged."""
    for pattern, repl in _COMPONENT_RULES:
        if pattern.match(name):
            return pattern.sub(repl, name)
    return name


def _flax_path_to_hf_name(path: Tuple[str, ...]) -> str:
    return ".".join(_flax_component_to_hf(p) for p in path)


def _leaf_to_torch(leaf_name: str, value: np.ndarray) -> Tuple[str, np.ndarray]:
    v = _np(value)
    if leaf_name == "kernel":
        if v.ndim == 2:  # Dense (in, out) → Linear (out, in)
            return "weight", v.T
        if v.ndim == 4:  # Conv (kh, kw, in, out) → (out, in, kh, kw)
            return "weight", v.transpose(3, 2, 0, 1)
        raise ValueError(f"unexpected kernel ndim {v.ndim}")
    if leaf_name == "scale":
        return "weight", v
    if leaf_name == "embedding":
        return "weight", v
    return leaf_name, v  # bias


def _walk_leaves(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk_leaves(v, prefix + (k,))
        else:
            yield prefix, k, v


def unet_to_torch(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """UNet Flax params → HF UNet2DConditionModel state_dict (numpy)."""
    sd = {}
    for path, leaf, value in _walk_leaves(params):
        hf_mod = _flax_path_to_hf_name(path)
        hf_leaf, v = _leaf_to_torch(leaf, value)
        sd[f"{hf_mod}.{hf_leaf}"] = v
    return sd


def vae_to_torch(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """VAE Flax params → HF AutoencoderKL state_dict."""
    sd = {}
    for path, leaf, value in _walk_leaves(params):
        hf_mod = _flax_path_to_hf_name(path)
        hf_leaf, v = _leaf_to_torch(leaf, value)
        sd[f"{hf_mod}.{hf_leaf}"] = v
    return sd

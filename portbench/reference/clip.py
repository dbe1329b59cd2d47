"""CLIP text transformer (HF ``CLIPTextModel`` names), plain.

``cfg`` is the configuration file's text-encoder group: ``hidden_size``,
``num_hidden_layers``, ``num_attention_heads``, ``hidden_act``,
``layer_norm_eps``, ``eos_token_id`` and, for a tower with a projection,
``projection_dim``.  Pre-LN layers, causal attention, the pooled output at
the first EOS token after the final LayerNorm.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from portbench.reference.ops import Prec, attention, layer_norm, linear


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return F.gelu(x)
    raise ValueError(f"activation {name!r}")


def encode(p: Prec, cfg: Dict, ids: torch.Tensor, *,
           prefix: str = "", inject: Optional[tuple] = None,
           stop_at: Optional[int] = None,
           taps: Optional[Dict[str, List[torch.Tensor]]] = None,
           patch: Optional[Callable] = None):
    """Token ids (B, S) -> (last hidden (B, S, H) after the final LN,
    pooled (B, H or proj)), or with ``stop_at`` the output of that layer
    (no final LN) and None.  ``inject`` = (layer, delta (B, S, H)) adds
    delta to that layer's output; ``taps`` (a dict of lists) collects
    ``fc2_in``, ``fc2_out`` and ``layer_out`` of every layer run;
    ``patch(i, hidden, fc2_in, fc2_out)`` may replace a layer's output."""
    pre = prefix + "text_model."
    B, S = ids.shape
    eps = cfg.get("layer_norm_eps", 1e-5)
    nh = cfg["num_attention_heads"]
    h = (p.b(pre + "embeddings.token_embedding.weight")[ids]
         + p.b(pre + "embeddings.position_embedding.weight")[:S][None])
    mask = torch.full((S, S), float("-inf"), device=ids.device).triu(1)
    last = cfg["num_hidden_layers"] - 1 if stop_at is None else stop_at
    for i in range(last + 1):
        ln = f"{pre}encoder.layers.{i}."
        x = layer_norm(p, ln + "layer_norm1", h, eps)
        q, k, v = (linear(p, ln + f"self_attn.{n}_proj", x).reshape(
            B, S, nh, -1) for n in "qkv")
        a = attention(p, q, k, v, mask).reshape(B, S, -1)
        h = h + linear(p, ln + "self_attn.out_proj", a)
        fc2_in = _act(cfg["hidden_act"], linear(
            p, ln + "mlp.fc1", layer_norm(p, ln + "layer_norm2", h, eps)))
        fc2_out = linear(p, ln + "mlp.fc2", fc2_in)
        h = h + fc2_out
        if inject is not None and inject[0] == i:
            h = h + inject[1]
        if patch is not None:
            h = patch(i, h, fc2_in, fc2_out)
        if taps is not None:
            for name, t in (("fc2_in", fc2_in), ("fc2_out", fc2_out),
                            ("layer_out", h)):
                taps.setdefault(name, []).append(t)
    if stop_at is not None:
        return h, None
    h = layer_norm(p, pre + "final_layer_norm", h, eps)
    eos = (ids == cfg["eos_token_id"]).int().argmax(-1)
    pooled = h[torch.arange(B, device=ids.device), eos]
    if cfg.get("projection_dim"):
        pooled = linear(p, prefix + "text_projection", pooled)
    return h, pooled

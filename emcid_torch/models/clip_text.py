"""CLIP text encoder with activation taps, injection and early stop.

Counterpart of ``emcid_tpu/models/clip_text.py``.  Parameter names are the
HF ``CLIPTextModel`` ones (``text_model.encoder.layers.{i}.mlp.fc2`` ...),
so converted weights load with ``load_state_dict(strict=True)`` and the
hparams' ``rewrite_module_tmp`` names resolve with ``get_submodule``.

* ``capture`` — stacked (L, B, S, D) ``fc2_in`` / ``fc2_out`` /
  ``layer_out`` taps in ``TextOutput.taps``;
* ``inject_layer`` / ``inject_delta`` / ``inject_mask`` — add
  ``mask[..., None] * delta`` to that layer's output hidden state
  (differentiable: Stage 1 optimizes through it);
* ``stop_at_layer`` — run layers [0, stop_at_layer] only, no final LN;
* ``embed_noise`` — (B, S, H) added to the token+position embedding (the
  causal-tracing corruption seam, reference causal_trace.py:240-251);
* ``patch_spec`` — ``{layer: (B, S) mask}``: at each given layer's output
  (after any inject), the masked tokens of rows 1.. take row 0's states
  (the causal-tracing restore seam, reference causal_trace.py:252-259);
* ``embed`` / ``layer_forward`` / ``final`` — the stepping API of the
  one-pass Stage-2 insert.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import torch
from torch import nn

from emcid_torch.models.configs import CLIPTextConfig


class TextOutput(NamedTuple):
    last_hidden_state: torch.Tensor  # (B, S, H) after the final LN
    pooled_output: Optional[torch.Tensor]  # (B, H/proj) at the first EOS
    taps: Dict[str, torch.Tensor]  # name -> (L, B, S, D)


def _activation(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return lambda x: nn.functional.gelu(x)
    raise ValueError(f"unknown activation {name!r}")


def causal_attention_mask(seq_len: int,
                          attention_mask: Optional[torch.Tensor] = None,
                          device=None) -> torch.Tensor:
    """Additive causal mask (1, 1, S, S) in f32, optionally combined with a
    (B, S) padding mask."""
    if attention_mask is not None:
        device = attention_mask.device
    neg = torch.finfo(torch.float32).min
    tril = torch.ones(seq_len, seq_len, dtype=torch.bool, device=device).tril()
    causal = torch.zeros(seq_len, seq_len, device=device).masked_fill(
        ~tril, neg)[None, None]
    if attention_mask is not None:
        pad = torch.zeros(attention_mask.shape, device=device).masked_fill(
            attention_mask <= 0, neg)[:, None, None, :]
        return causal + pad
    return causal


class CLIPAttention(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.q_proj = nn.Linear(h, h)
        self.k_proj = nn.Linear(h, h)
        self.v_proj = nn.Linear(h, h)
        self.out_proj = nn.Linear(h, h)

    def forward(self, hidden, mask):
        B, S, h = hidden.shape
        nh = self.num_heads
        hd = h // nh
        split = lambda x: x.reshape(B, S, nh, hd)
        q = split(self.q_proj(hidden) * hd ** -0.5)
        k = split(self.k_proj(hidden))
        v = split(self.v_proj(hidden))
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) + mask
        probs = torch.softmax(scores.float(), dim=-1).to(hidden.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, S, h)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.act = _activation(config.hidden_act)
        self.fc1 = nn.Linear(config.hidden_size, config.intermediate_size)
        self.fc2 = nn.Linear(config.intermediate_size, config.hidden_size)

    def forward(self, hidden):
        fc2_in = self.act(self.fc1(hidden))
        return self.fc2(fc2_in), fc2_in


class CLIPEncoderLayer(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        eps = config.layer_norm_eps
        self.self_attn = CLIPAttention(config)
        self.layer_norm1 = nn.LayerNorm(config.hidden_size, eps=eps)
        self.mlp = CLIPMLP(config)
        self.layer_norm2 = nn.LayerNorm(config.hidden_size, eps=eps)

    def forward(self, hidden, mask):
        hidden = hidden + self.self_attn(self.layer_norm1(hidden), mask)
        fc2_out, fc2_in = self.mlp(self.layer_norm2(hidden))
        return hidden + fc2_out, fc2_in, fc2_out


class _Embeddings(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(config.vocab_size,
                                            config.hidden_size)
        self.position_embedding = nn.Embedding(
            config.max_position_embeddings, config.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(config)
                                    for _ in range(config.num_hidden_layers))


class _TextTransformer(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(config)
        self.encoder = _Encoder(config)
        self.final_layer_norm = nn.LayerNorm(config.hidden_size,
                                             eps=config.layer_norm_eps)


class CLIPTextEncoder(nn.Module):
    """CLIP text transformer (HF ``CLIPTextModel`` names)."""

    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.config = config
        self.text_model = _TextTransformer(config)
        if config.projection_dim is not None:
            self.text_projection = nn.Linear(config.hidden_size,
                                             config.projection_dim, bias=False)

    # ---- stepping API (engine/emcid.py one-pass insert) -----------------
    def embed(self, input_ids: torch.Tensor,
              embed_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        emb = self.text_model.embeddings
        S = input_ids.shape[1]
        pos = torch.arange(S, device=input_ids.device)[None]
        hidden = emb.token_embedding(input_ids) + emb.position_embedding(pos)
        if embed_noise is not None:
            hidden = hidden + embed_noise.to(hidden.dtype)
        return hidden

    def layer_forward(self, hidden, mask, layer_idx: int):
        """One encoder layer; returns (hidden, fc2_in, fc2_out)."""
        return self.text_model.encoder.layers[layer_idx](hidden, mask)

    def final(self, hidden, input_ids):
        """Final LN + pooling at the first EOS (+ optional projection)."""
        hidden = self.text_model.final_layer_norm(hidden)
        eos_pos = (input_ids == self.config.eos_token_id).int().argmax(-1)
        pooled = hidden[torch.arange(hidden.shape[0], device=hidden.device),
                        eos_pos]
        if self.config.projection_dim is not None:
            pooled = self.text_projection(pooled)
        return hidden, pooled

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        *,
        inject_layer: Optional[int] = None,
        inject_delta: Optional[torch.Tensor] = None,
        inject_mask: Optional[torch.Tensor] = None,
        capture: Sequence[str] = (),
        stop_at_layer: Optional[int] = None,
        embed_noise: Optional[torch.Tensor] = None,
        patch_spec: Optional[Dict[int, torch.Tensor]] = None,
    ) -> TextOutput:
        cfg = self.config
        S = input_ids.shape[1]
        hidden = self.embed(input_ids, embed_noise)
        mask = causal_attention_mask(S, attention_mask,
                                     device=input_ids.device)
        captures: Dict[str, list] = {name: [] for name in capture}
        last = (cfg.num_hidden_layers - 1 if stop_at_layer is None
                else min(stop_at_layer, cfg.num_hidden_layers - 1))
        for i in range(last + 1):
            hidden, fc2_in, fc2_out = self.layer_forward(hidden, mask, i)
            if inject_layer == i and inject_delta is not None:
                delta = inject_delta
                if delta.dim() == 2:
                    delta = delta[:, None, :]
                if inject_mask is not None:
                    delta = inject_mask[..., None] * delta
                hidden = hidden + delta.to(hidden.dtype)
            if patch_spec is not None and i in patch_spec:
                pm = patch_spec[i][..., None].to(hidden.dtype)  # (B, S, 1)
                hidden = (1.0 - pm) * hidden + pm * hidden[0:1]
            if "fc2_in" in captures:
                captures["fc2_in"].append(fc2_in)
            if "fc2_out" in captures:
                captures["fc2_out"].append(fc2_out)
            if "layer_out" in captures:
                captures["layer_out"].append(hidden)
        taps = {k: torch.stack(v) for k, v in captures.items() if v}
        if stop_at_layer is not None:
            return TextOutput(hidden, None, taps)
        hidden, pooled = self.final(hidden, input_ids)
        return TextOutput(hidden, pooled, taps)

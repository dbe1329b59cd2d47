"""Seeded weights of an SD3 configuration at its published shapes, named
as the diffusers and transformers checkpoints name them: both CLIP
encoders, T5, the MMDiT, the VAE without quant convs.

Drawn as ``portbench.weights.make`` draws (one standard-normal call per
module in the served dtype, matrices by fan_in^-1/2, biases by 0.01, norm
scales 1 + 0.01 x), except the MMDiT's patch position table, which the
checkpoint holds as computed: ``reference.sd3_edit.pos_table``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench import weights
from portbench.reference import sd3_edit
from portbench.weights import Spec, _lin

PREFIX = {"text_encoder": "te1.", "text_encoder_2": "te2.",
          "text_encoder_3": "te3.", "transformer": "mmdit.", "vae": "vae."}
POS = "pos_embed.pos_embed"


def _w(name: str, *shape: int) -> Spec:
    return [(name + ".weight", tuple(shape))]


def t5_spec(cfg: Dict) -> Spec:
    d, inner = cfg["d_model"], cfg["num_heads"] * cfg["d_kv"]
    s = _w("shared", cfg["vocab_size"], d)
    for i in range(cfg["num_layers"]):
        a = f"encoder.block.{i}.layer.0."
        s += (_w(a + "SelfAttention.q", inner, d)
              + _w(a + "SelfAttention.k", inner, d)
              + _w(a + "SelfAttention.v", inner, d)
              + _w(a + "SelfAttention.o", d, inner))
        if i == 0:
            s += _w(a + "SelfAttention.relative_attention_bias",
                    cfg["relative_attention_num_buckets"], cfg["num_heads"])
        f = f"encoder.block.{i}.layer.1."
        s += (_w(a + "layer_norm", d) + _w(f + "DenseReluDense.wi_0",
                                           cfg["d_ff"], d)
              + _w(f + "DenseReluDense.wi_1", cfg["d_ff"], d)
              + _w(f + "DenseReluDense.wo", d, cfg["d_ff"])
              + _w(f + "layer_norm", d))
    return s + _w("encoder.final_layer_norm", d)


def _attn(name: str, D: int, hd: int, joint: bool, out_ctx: bool) -> Spec:
    s: Spec = []
    for n in ("to_q", "to_k", "to_v"):
        s += _lin(f"{name}.{n}", D, D)
    s += _w(name + ".norm_q", hd) + _w(name + ".norm_k", hd)
    if joint:
        for n in ("add_q_proj", "add_k_proj", "add_v_proj"):
            s += _lin(f"{name}.{n}", D, D)
        s += _w(name + ".norm_added_q", hd) + _w(name + ".norm_added_k", hd)
    s += _lin(name + ".to_out.0", D, D)
    return s + (_lin(name + ".to_add_out", D, D) if out_ctx else [])


def mmdit_spec(cfg: Dict) -> Spec:
    """Every drawn tensor of the MMDiT (the position table is computed)."""
    D = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    hd, L, p = cfg["attention_head_dim"], cfg["num_layers"], cfg["patch_size"]
    dual = set(cfg.get("dual_attention_layers") or ())
    s = [("pos_embed.proj.weight", (D, cfg["in_channels"], p, p)),
         ("pos_embed.proj.bias", (D,))]
    t = "time_text_embed."
    s += (_lin(t + "timestep_embedder.linear_1", D, 256)
          + _lin(t + "timestep_embedder.linear_2", D, D)
          + _lin(t + "text_embedder.linear_1", D, cfg["pooled_projection_dim"])
          + _lin(t + "text_embedder.linear_2", D, D)
          + _lin("context_embedder", cfg["caption_projection_dim"],
                 cfg["joint_attention_dim"]))
    for i in range(L):
        b, last = f"transformer_blocks.{i}", i == L - 1
        s += (_lin(b + ".norm1.linear", (9 if i in dual else 6) * D, D)
              + _lin(b + ".norm1_context.linear", (2 if last else 6) * D, D)
              + _attn(b + ".attn", D, hd, True, not last))
        if i in dual:
            s += _attn(b + ".attn2", D, hd, False, False)
        for ff in ("ff",) + (() if last else ("ff_context",)):
            s += (_lin(f"{b}.{ff}.net.0.proj", 4 * D, D)
                  + _lin(f"{b}.{ff}.net.2", D, 4 * D))
    return (s + _lin("norm_out.linear", 2 * D, D)
            + _lin("proj_out", p * p * cfg["out_channels"], D))


def vae_spec(cfg: Dict) -> Spec:
    """``weights.vae_spec`` without the quant convs."""
    return [e for e in weights.vae_spec(cfg) if "quant_conv" not in e[0]]


def modules(cfg: Dict) -> List[Tuple[str, Spec]]:
    """(module key, spec) of every model of the configuration, in drawing
    order."""
    return [("text_encoder", weights.clip_spec(cfg["text_encoder"])),
            ("text_encoder_2", weights.clip_spec(cfg["text_encoder_2"])),
            ("text_encoder_3", t5_spec(cfg["text_encoder_3"])),
            ("transformer", mmdit_spec(cfg["transformer"])),
            ("vae", vae_spec(cfg["vae"]))]


def n_params(cfg: Dict) -> int:
    return sum(weights._numel(shape) for _, spec in modules(cfg)
               for _, shape in spec)


@torch.no_grad()
def make(cfg: Dict, seed: int, device, dtype, skip=()
         ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{module key: state dict} drawn from ``seed`` (the modules in
    ``skip`` are drawn and dropped, so the others are the same)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = {}
    for key, spec in modules(cfg):
        sizes = [weights._numel(shape) for _, shape in spec]
        flat = torch.randn(sum(sizes), generator=gen, device=device,
                           dtype=dtype)
        if key in skip:
            del flat
            continue
        state, o = {}, 0
        for (name, shape), n in zip(spec, sizes):
            t = flat[o:o + n].view(shape)
            o += n
            if len(shape) > 1:
                t.mul_((n // shape[0]) ** -0.5)
            elif name.endswith(".weight"):
                t.mul_(0.01).add_(1.0)
            else:
                t.mul_(0.01)
            state[name] = t
        if key == "transformer":
            m = cfg["transformer"]
            state[POS] = sd3_edit.pos_table(
                m["num_attention_heads"] * m["attention_head_dim"],
                m["pos_embed_max_size"], m["sample_size"] // m["patch_size"]
            )[None].to(device, dtype)
        out[key] = state
    return out


def reference_params(state: Dict[str, Dict[str, torch.Tensor]]
                     ) -> Dict[str, torch.Tensor]:
    """One flat dict of every module's tensors under the reference's
    prefixes."""
    return {PREFIX[k] + n: t for k, sd in state.items() for n, t in sd.items()}

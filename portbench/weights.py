"""Seeded weights at a configuration's published shapes, named as the HF
and diffusers checkpoints name them.

``make`` draws every module's weights on the device from one
``torch.Generator``, one standard-normal call per module in the served
dtype, then scales each tensor in place: matrices and kernels by
fan_in^-1/2, biases and norm shifts by 0.01, norm scales to 1 + 0.01 x.
The same seed gives the same tensors, so the reference can draw them again
after the window.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench.reference.unet import per_level

Spec = List[Tuple[str, Tuple[int, ...]]]


def _lin(name: str, n_out: int, n_in: int, bias: bool = True) -> Spec:
    out = [(name + ".weight", (n_out, n_in))]
    return out + [(name + ".bias", (n_out,))] if bias else out


def _conv(name: str, n_out: int, n_in: int, k: int = 3) -> Spec:
    return [(name + ".weight", (n_out, n_in, k, k)), (name + ".bias", (n_out,))]


def _norm(name: str, n: int) -> Spec:
    return [(name + ".weight", (n,)), (name + ".bias", (n,))]


def clip_spec(cfg: Dict) -> Spec:
    H, I = cfg["hidden_size"], cfg["intermediate_size"]
    pre = "text_model."
    s: Spec = [
        (pre + "embeddings.token_embedding.weight", (cfg["vocab_size"], H)),
        (pre + "embeddings.position_embedding.weight",
         (cfg["max_position_embeddings"], H))]
    for i in range(cfg["num_hidden_layers"]):
        ln = f"{pre}encoder.layers.{i}."
        for n in ("q", "k", "v", "out"):
            s += _lin(ln + f"self_attn.{n}_proj", H, H)
        s += _norm(ln + "layer_norm1", H)
        s += _lin(ln + "mlp.fc1", I, H) + _lin(ln + "mlp.fc2", H, I)
        s += _norm(ln + "layer_norm2", H)
    s += _norm(pre + "final_layer_norm", H)
    if cfg.get("projection_dim"):
        s += _lin("text_projection", cfg["projection_dim"], H, bias=False)
    return s


def _resnet(name: str, cin: int, cout: int, temb: int) -> Spec:
    s = (_norm(name + ".norm1", cin) + _conv(name + ".conv1", cout, cin)
         + _lin(name + ".time_emb_proj", cout, temb)
         + _norm(name + ".norm2", cout) + _conv(name + ".conv2", cout, cout))
    return s + (_conv(name + ".conv_shortcut", cout, cin, 1)
                if cin != cout else [])


def _transformer(name: str, c: int, ctx: int, depth: int, lin: bool) -> Spec:
    proj = (lambda n: _lin(n, c, c)) if lin else (lambda n: _conv(n, c, c, 1))
    s = _norm(name + ".norm", c) + proj(name + ".proj_in")
    for d in range(depth):
        b = f"{name}.transformer_blocks.{d}"
        for a, kv in ((".attn1", c), (".attn2", ctx)):
            s += (_lin(b + a + ".to_q", c, c, False)
                  + _lin(b + a + ".to_k", c, kv, False)
                  + _lin(b + a + ".to_v", c, kv, False)
                  + _lin(b + a + ".to_out.0", c, c))
        s += (_norm(b + ".norm1", c) + _norm(b + ".norm2", c)
              + _norm(b + ".norm3", c) + _lin(b + ".ff.net.0.proj", 8 * c, c)
              + _lin(b + ".ff.net.2", c, 4 * c))
    return s + proj(name + ".proj_out")


def unet_spec(cfg: Dict) -> Spec:
    chs = cfg["block_out_channels"]
    n, L = len(chs), cfg["layers_per_block"]
    temb = 4 * chs[0]
    ctx = cfg["cross_attention_dim"]
    depth = per_level(cfg, "transformer_layers_per_block", 1)
    lin = bool(cfg.get("use_linear_projection", False))
    s = _conv("conv_in", chs[0], cfg["in_channels"])
    s += (_lin("time_embedding.linear_1", temb, chs[0])
          + _lin("time_embedding.linear_2", temb, temb))
    if cfg.get("addition_embed_type") == "text_time":
        s += (_lin("add_embedding.linear_1", temb,
                   cfg["projection_class_embeddings_input_dim"])
              + _lin("add_embedding.linear_2", temb, temb))
    cur, skips = chs[0], [chs[0]]
    for lvl, kind in enumerate(cfg["down_block_types"]):
        for j in range(L):
            s += _resnet(f"down_blocks.{lvl}.resnets.{j}", cur, chs[lvl], temb)
            cur = chs[lvl]
            if kind.startswith("CrossAttn"):
                s += _transformer(f"down_blocks.{lvl}.attentions.{j}", cur,
                                  ctx, depth[lvl], lin)
            skips.append(cur)
        if lvl < n - 1:
            s += _conv(f"down_blocks.{lvl}.downsamplers.0.conv", cur, cur)
            skips.append(cur)
    s += (_resnet("mid_block.resnets.0", cur, cur, temb)
          + _transformer("mid_block.attentions.0", cur, ctx, depth[-1], lin)
          + _resnet("mid_block.resnets.1", cur, cur, temb))
    for lvl, kind in enumerate(cfg["up_block_types"]):
        out = chs[n - 1 - lvl]
        for j in range(L + 1):
            s += _resnet(f"up_blocks.{lvl}.resnets.{j}", cur + skips.pop(),
                         out, temb)
            cur = out
            if kind.startswith("CrossAttn"):
                s += _transformer(f"up_blocks.{lvl}.attentions.{j}", cur, ctx,
                                  depth[n - 1 - lvl], lin)
        if lvl < n - 1:
            s += _conv(f"up_blocks.{lvl}.upsamplers.0.conv", cur, cur)
    return (s + _norm("conv_norm_out", cur)
            + _conv("conv_out", cfg["out_channels"], cur))


def _vae_mid(name: str, c: int) -> Spec:
    a = name + ".attentions.0"
    return (_vae_res(name + ".resnets.0", c, c) + _norm(a + ".group_norm", c)
            + _lin(a + ".to_q", c, c) + _lin(a + ".to_k", c, c)
            + _lin(a + ".to_v", c, c) + _lin(a + ".to_out.0", c, c)
            + _vae_res(name + ".resnets.1", c, c))


def _vae_res(name: str, cin: int, cout: int) -> Spec:
    s = (_norm(name + ".norm1", cin) + _conv(name + ".conv1", cout, cin)
         + _norm(name + ".norm2", cout) + _conv(name + ".conv2", cout, cout))
    return s + (_conv(name + ".conv_shortcut", cout, cin, 1)
                if cin != cout else [])


def vae_spec(cfg: Dict) -> Spec:
    chs = cfg["block_out_channels"]
    lat = cfg["latent_channels"]
    s = _conv("encoder.conv_in", chs[0], cfg["in_channels"])
    cur = chs[0]
    for lvl, c in enumerate(chs):
        for j in range(cfg["layers_per_block"]):
            s += _vae_res(f"encoder.down_blocks.{lvl}.resnets.{j}", cur, c)
            cur = c
        if lvl < len(chs) - 1:
            s += _conv(f"encoder.down_blocks.{lvl}.downsamplers.0.conv", c, c)
    s += (_vae_mid("encoder.mid_block", cur)
          + _norm("encoder.conv_norm_out", cur)
          + _conv("encoder.conv_out", 2 * lat, cur)
          + _conv("quant_conv", 2 * lat, 2 * lat, 1)
          + _conv("post_quant_conv", lat, lat, 1))
    rev = chs[::-1]
    s += _conv("decoder.conv_in", rev[0], lat) + _vae_mid("decoder.mid_block",
                                                          rev[0])
    cur = rev[0]
    for lvl, c in enumerate(rev):
        for j in range(cfg["layers_per_block"] + 1):
            s += _vae_res(f"decoder.up_blocks.{lvl}.resnets.{j}", cur, c)
            cur = c
        if lvl < len(rev) - 1:
            s += _conv(f"decoder.up_blocks.{lvl}.upsamplers.0.conv", c, c)
    return (s + _norm("decoder.conv_norm_out", cur)
            + _conv("decoder.conv_out", cfg["out_channels"], cur))


def modules(cfg: Dict) -> List[Tuple[str, str, Spec]]:
    """(module key, reference prefix, spec) of every model of a
    configuration, in drawing order."""
    two = "text_encoder_2" in cfg
    out = [("text_encoder", "te1." if two else "",
            clip_spec(cfg["text_encoder"]))]
    if two:
        out.append(("text_encoder_2", "te2.", clip_spec(cfg["text_encoder_2"])))
    return out + [("unet", "", unet_spec(cfg["unet"])),
                  ("vae", "", vae_spec(cfg["vae"]))]


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def n_params(cfg: Dict) -> int:
    return sum(_numel(shape) for _, _, spec in modules(cfg)
               for _, shape in spec)


@torch.no_grad()
def make(cfg: Dict, seed: int, device, dtype) -> Dict[str, Dict[str,
                                                               torch.Tensor]]:
    """{module key: state dict} drawn from ``seed``.  The tensors of one
    module are views of one buffer."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = {}
    for key, _, spec in modules(cfg):
        sizes = [_numel(shape) for _, shape in spec]
        flat = torch.randn(sum(sizes), generator=gen, device=device,
                           dtype=dtype)
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
        out[key] = state
    return out


def reference_params(state: Dict[str, Dict[str, torch.Tensor]], cfg: Dict
                     ) -> Dict[str, torch.Tensor]:
    """One flat dict of every module's tensors under the reference's
    prefixes."""
    prefix = {key: pre for key, pre, _ in modules(cfg)}
    return {prefix[k] + n: t for k, sd in state.items() for n, t in sd.items()}

"""The EMCID edit of SD3.5's two CLIP encoders, in plain PyTorch: T5-XXL,
the MMDiT-X, the 16-channel VAE without quant convs and the flow-matching
Euler sampler; the training-image posteriors, the joint two-delta Stage 1
against the MMDiT's velocity; both covariances and the float64 Stage 2 are
``sdxl_edit``'s.

Inputs are the benchmark's own: CLIP ids from ``portbench.tokens``, T5
ids from the same words, the weights the benchmark made (read through
``Prec``; CLIP-L under ``te1.``, bigG under ``te2.``, T5 under ``te3.``,
the MMDiT under ``mmdit.``, the VAE under ``vae.``), the requests and
seeds.  Stage 1 draws from one ``torch.Generator`` seeded with the block's
seed in ``sdxl_edit.stage1``'s order, the timestep draw an index into the
shifted training table.

The model (Esser et al., arXiv:2403.03206; SD3.5's MMDiT-X and the
published ``transformer/config.json``):

- T5: RMSNorm (scale only) before attention and the gated tanh-GELU
  feed-forward, attention without the 1/sqrt(d) scale plus the first
  layer's bucketed relative bias in every layer, a final RMSNorm; no mask;
- MMDiT: 2 x 2 patches plus the centre crop of the checkpoint's sin-cos
  table; e = timestep MLP + pooled MLP; per block adaLN-Zero of both
  streams (LN without affine, eps 1e-6), per-head RMSNorm of q and k, one
  softmax attention over [image ; text], in the dual blocks an image-only
  attention from the second modulation, 4x tanh-GELU MLPs; the last block
  keeps no text stream; adaLN-continuous out, unpatchify;
- context = [CLIP-L penult ‖ bigG penult] zero-padded to 4096, then T5's
  states on the token axis; pooled = [pool_1 ‖ pool_2];
- flow matching: table sigma_i = s((N - i)/N) with s(x) = 3x / (1 + 2x),
  x_t = (1 - sigma) x0 + sigma eps, timestep 1000 sigma; inference sigmas
  s(linspace(sigma_0, sigma_{N-1}, n)) then 0, x += (sigma' - sigma) v;
- VAE latents (mean - shift) * scale.

Where it departs from the published description, as ``sdxl_edit`` does:
encoder 2's source-side ids pad with 0 after the first end token, the
dest side and the training images read the encoder-1 ids for both CLIP
encoders; Stage 1's velocity term is taken prompt by prompt and summed;
every MMDiT block keeps no activations for the backward pass and runs
again inside it (``torch.utils.checkpoint``: the same numbers in less
memory, so that the float32 model at 1024 px fits one card).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference import pipelines, sdxl_edit, vae
from portbench.reference.ops import (
    Prec,
    attention,
    conv,
    group_norm,
    linear,
    timestep_features,
)

SHIFT = 3.0
N_TRAIN = 1000


def sub(p: Prec, prefix: str) -> Prec:
    """A ``Prec`` over the tensors under ``prefix``, named without it."""
    return Prec({k[len(prefix):]: v for k, v in p.params.items()
                 if k.startswith(prefix)}, fp8=p.fp8)


def rms_norm(p: Prec, name: str, x: torch.Tensor, eps: float
             ) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * p.b(
        name + ".weight")


def _ln(x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x.float(), (x.shape[-1],), eps=1e-6)


# -- T5 ------------------------------------------------------------------------


def _bucket(rel: torch.Tensor, n_buckets: int, max_dist: int) -> torch.Tensor:
    half = n_buckets // 2
    out = torch.where(rel > 0, half, 0)
    r = rel.abs()
    exact = half // 2
    far = exact + (torch.log(r.float().clamp_min(1) / exact)
                   / math.log(max_dist / exact) * (half - exact)).long()
    return out + torch.where(r < exact, r, far.clamp(max=half - 1))


@torch.no_grad()
def t5(p: Prec, cfg: Dict, ids: torch.Tensor) -> torch.Tensor:
    """T5 encoder ids (B, S) -> last hidden state (B, S, d_model)."""
    B, S = ids.shape
    nh, eps = cfg["num_heads"], cfg["layer_norm_epsilon"]
    h = p.b("shared.weight")[ids]
    pos = torch.arange(S, device=ids.device)
    bucket = _bucket(pos[None] - pos[:, None],
                     cfg["relative_attention_num_buckets"],
                     cfg["relative_attention_max_distance"])
    bias = p.b("encoder.block.0.layer.0.SelfAttention."
               "relative_attention_bias.weight")[bucket].permute(2, 0, 1)
    for i in range(cfg["num_layers"]):
        pre = f"encoder.block.{i}.layer."
        x = rms_norm(p, pre + "0.layer_norm", h, eps)
        q, k, v = (linear(p, f"{pre}0.SelfAttention.{n}", x).reshape(
            B, S, nh, -1) for n in "qkv")
        s = torch.einsum("bnhd,bmhd->bhnm", p.op(q), p.op(k)) + bias
        a = torch.einsum("bhnm,bmhd->bnhd", p.op(torch.softmax(s, -1)),
                         p.op(v)).reshape(B, S, -1)
        h = h + linear(p, pre + "0.SelfAttention.o", a)
        x = rms_norm(p, pre + "1.layer_norm", h, eps)
        g = (F.gelu(linear(p, pre + "1.DenseReluDense.wi_0", x),
                    approximate="tanh")
             * linear(p, pre + "1.DenseReluDense.wi_1", x))
        h = h + linear(p, pre + "1.DenseReluDense.wo", g)
    return rms_norm(p, "encoder.final_layer_norm", h, eps)


# -- MMDiT ---------------------------------------------------------------------


def pos_table(dim: int, grid: int, base: int) -> torch.Tensor:
    """The 2-D sin-cos table (grid^2, dim), float64: per cell (h, w), the
    first dim/2 channels [sin | cos] of w * base / grid times
    10000^(-j / (dim/4)), the second half the same of h."""
    g = torch.arange(grid, dtype=torch.float32) / float(grid / base)
    omega = 1.0 / 10000 ** (torch.arange(dim // 4, dtype=torch.float64)
                            / (dim / 4))

    def one(c):
        out = c.reshape(-1, 1).double() * omega[None]
        return torch.cat([out.sin(), out.cos()], 1)

    hh, ww = torch.meshgrid(g, g, indexing="ij")
    return torch.cat([one(ww), one(hh)], 1)


def _attention(p: Prec, name: str, x: torch.Tensor, heads: int,
               qkv=("to_q", "to_k", "to_v"), norms=("norm_q", "norm_k")):
    B, N, _ = x.shape
    q, k, v = (linear(p, f"{name}.{n}", x).reshape(B, N, heads, -1)
               for n in qkv)
    if p.has(f"{name}.{norms[0]}.weight"):
        q = rms_norm(p, f"{name}.{norms[0]}", q, 1e-6)
        k = rms_norm(p, f"{name}.{norms[1]}", k, 1e-6)
    return q, k, v


def _mods(p: Prec, name: str, temb: torch.Tensor, n: int):
    return linear(p, name + ".linear", F.silu(temb)).chunk(n, dim=1)


def _modulate(x, shift, scale):
    return _ln(x) * (1 + scale[:, None]) + shift[:, None]


def _ff(p: Prec, name: str, x):
    h = F.gelu(linear(p, name + ".net.0.proj", x), approximate="tanh")
    return linear(p, name + ".net.2", h)


def _block(p: Prec, cfg: Dict, i: int, x, c, temb):
    """One joint block -> (x, c); c is None after the last block."""
    pre = f"transformer_blocks.{i}"
    heads = cfg["num_attention_heads"]
    last = i == cfg["num_layers"] - 1
    dual = i in cfg.get("dual_attention_layers", ())
    m = _mods(p, pre + ".norm1", temb, 9 if dual else 6)
    nx = _modulate(x, m[0], m[1])
    if last:
        c_scale, c_shift = _mods(p, pre + ".norm1_context", temb, 2)
        nc = _modulate(c, c_shift, c_scale)
    else:
        cm = _mods(p, pre + ".norm1_context", temb, 6)
        nc = _modulate(c, cm[0], cm[1])
    N = x.shape[1]
    qx, kx, vx = _attention(p, pre + ".attn", nx, heads)
    qc, kc, vc = _attention(p, pre + ".attn", nc, heads,
                            ("add_q_proj", "add_k_proj", "add_v_proj"),
                            ("norm_added_q", "norm_added_k"))
    o = attention(p, torch.cat([qx, qc], 1), torch.cat([kx, kc], 1),
                  torch.cat([vx, vc], 1)).flatten(2)
    x_in = x
    x = x + m[2][:, None] * linear(p, pre + ".attn.to_out.0", o[:, :N])
    if dual:
        q2, k2, v2 = _attention(p, pre + ".attn2",
                                _modulate(x_in, m[6], m[7]), heads)
        o2 = attention(p, q2, k2, v2).flatten(2)
        x = x + m[8][:, None] * linear(p, pre + ".attn2.to_out.0", o2)
    x = x + m[5][:, None] * _ff(p, pre + ".ff", _modulate(x, m[3], m[4]))
    if last:
        return x, None
    c = c + cm[2][:, None] * linear(p, pre + ".attn.to_add_out", o[:, N:])
    c = c + cm[5][:, None] * _ff(p, pre + ".ff_context",
                                 _modulate(c, cm[3], cm[4]))
    return x, c


def mmdit(p: Prec, cfg: Dict, x: torch.Tensor, t: torch.Tensor,
          ctx: torch.Tensor, pooled: torch.Tensor) -> torch.Tensor:
    """Latents (B, c, H, W), timesteps (B,), context (B, S, 4096), pooled
    (B, 2048) -> velocity (B, c, H, W).  ``p`` names the MMDiT's tensors
    without a prefix.  With grad enabled every block is recomputed in the
    backward pass."""
    B, _, H, W = x.shape
    ps, mx = cfg["patch_size"], cfg["pos_embed_max_size"]
    h = conv(p, "pos_embed.proj", x.float(), stride=ps, padding=0)
    h = h.flatten(2).transpose(1, 2)
    gh, gw = H // ps, W // ps
    top, left = (mx - gh) // 2, (mx - gw) // 2
    table = p.b("pos_embed.pos_embed").reshape(mx, mx, -1)
    h = h + table[top:top + gh, left:left + gw].reshape(1, gh * gw, -1)
    te = timestep_features(t.expand(B) if t.dim() == 0 else t, 256, True, 0)
    temb = (linear(p, "time_text_embed.timestep_embedder.linear_2", F.silu(
        linear(p, "time_text_embed.timestep_embedder.linear_1", te)))
        + linear(p, "time_text_embed.text_embedder.linear_2", F.silu(
            linear(p, "time_text_embed.text_embedder.linear_1", pooled))))
    c = linear(p, "context_embedder", ctx)
    for i in range(cfg["num_layers"]):
        if torch.is_grad_enabled():
            h, c = checkpoint(_block, p, cfg, i, h, c, temb,
                              use_reentrant=False)
        else:
            h, c = _block(p, cfg, i, h, c, temb)
    scale, shift = _mods(p, "norm_out", temb, 2)
    h = linear(p, "proj_out", _modulate(h, shift, scale))
    oc = cfg["out_channels"]
    h = h.reshape(B, gh, gw, ps, ps, oc).permute(0, 5, 1, 3, 2, 4)
    return h.reshape(B, oc, H, W)


# -- VAE, no quant convs ---------------------------------------------------------


def vae_encode(p: Prec, cfg: Dict, x: torch.Tensor):
    """RGB (B, 3, H, W) in [-1, 1] -> (mean, logvar) before shift and
    scale."""
    g, chs = cfg["norm_num_groups"], cfg["block_out_channels"]
    h = conv(p, "encoder.conv_in", x.float())
    for lvl in range(len(chs)):
        for j in range(cfg["layers_per_block"]):
            h = vae._resnet(p, f"encoder.down_blocks.{lvl}.resnets.{j}", h, g)
        if lvl < len(chs) - 1:
            h = conv(p, f"encoder.down_blocks.{lvl}.downsamplers.0.conv",
                     F.pad(h, (0, 1, 0, 1)), stride=2, padding=0)
    h = vae._mid(p, "encoder.mid_block", h, g)
    h = conv(p, "encoder.conv_out", F.silu(group_norm(
        p, "encoder.conv_norm_out", h, g, vae.EPS)))
    return h.chunk(2, dim=1)


def vae_decode(p: Prec, cfg: Dict, z: torch.Tensor) -> torch.Tensor:
    g, n = cfg["norm_num_groups"], len(cfg["block_out_channels"])
    h = vae._mid(p, "decoder.mid_block", conv(p, "decoder.conv_in",
                                              z.float()), g)
    for lvl in range(n):
        for j in range(cfg["layers_per_block"] + 1):
            h = vae._resnet(p, f"decoder.up_blocks.{lvl}.resnets.{j}", h, g)
        if lvl < n - 1:
            h = conv(p, f"decoder.up_blocks.{lvl}.upsamplers.0.conv",
                     F.interpolate(h, scale_factor=2.0, mode="nearest"))
    return conv(p, "decoder.conv_out", F.silu(group_norm(
        p, "decoder.conv_norm_out", h, g, vae.EPS)))


# -- flow matching ---------------------------------------------------------------


def _shift(s):
    return SHIFT * s / (1 + (SHIFT - 1) * s)


def train_sigmas() -> torch.Tensor:
    """The training table (float32), sigma_i = s((N - i) / N)."""
    return _shift(torch.arange(N_TRAIN, 0, -1, dtype=torch.float32)
                  / N_TRAIN)


def sample_sigmas(n: int) -> np.ndarray:
    """Inference sigmas (n + 1,): s(linspace(sigma_0, sigma_{N-1}, n)) in
    float64, rounded to float32, then 0."""
    table = train_sigmas()
    lin = np.linspace(float(table[0]), float(table[-1]), n)
    return np.append(_shift(lin).astype(np.float32), np.float32(0))


def timestep(sigma) -> torch.Tensor:
    return torch.as_tensor(sigma, dtype=torch.float32) * 1000.0


# -- the edit ----------------------------------------------------------------------


def condition(p: Prec, cfg: Dict, ids, t5_states, ids_2=None, inject_1=None,
              inject_2=None):
    """(context (B, 77 + S3, 4096), pooled (B, 2048), pool_1, pool_2)."""
    ctx, pool1, pool2 = sdxl_edit.condition(p, cfg, ids, ids_2, inject_1,
                                            inject_2)
    ctx = F.pad(ctx, (0, t5_states.shape[-1] - ctx.shape[-1]))
    return (torch.cat([ctx, t5_states.float()], 1),
            torch.cat([pool1, pool2], -1), pool1, pool2)


@torch.no_grad()
def training_posteriors(p: Prec, cfg: Dict, ids: torch.Tensor,
                        neg_ids: torch.Tensor, t5_c: torch.Tensor,
                        t5_u: torch.Tensor, seeds: Sequence[int],
                        edit: Dict):
    """Scaled posterior (mean, logvar), (n, c, h, w), of the training
    images: flow-matching Euler over ``edit["steps"]`` with CFG at
    ``edit["guidance_scale"]`` over the negative prompts on the first
    ``cfg_interval`` of the steps; decoded to uint8 one image at a time,
    encoded again."""
    mcfg, vcfg = cfg["transformer"], cfg["vae"]
    pm, pv = sub(p, "mmdit."), sub(p, "vae.")
    dev = ids.device
    ctx_c, pool_c, _, _ = condition(p, cfg, ids, t5_c)
    ctx_u, pool_u, _, _ = condition(p, cfg, neg_ids, t5_u)
    ctx, pooled = torch.cat([ctx_u, ctx_c]), torch.cat([pool_u, pool_c])
    g = edit["guidance_scale"]
    steps = edit["steps"]
    n_guided = max(1, int(round(edit["cfg_interval"] * steps)))
    sig = sample_sigmas(steps)
    x = pipelines.initial_latents(seeds, edit["resolution"] // cfg[
        "vae_scale"], mcfg["in_channels"], dev)
    for i in range(steps):
        t = timestep(sig[i]).to(dev)
        if i < n_guided:
            v_u, v_c = mmdit(pm, mcfg, torch.cat([x, x]), t, ctx,
                             pooled).chunk(2)
            v = v_u + g * (v_c - v_u)
        else:
            v = mmdit(pm, mcfg, x, t, ctx_c, pool_c)
        x = x + float(np.float32(sig[i + 1]) - np.float32(sig[i])) * v
    sf, sh = vcfg["scaling_factor"], vcfg["shift_factor"]
    means, logvars = [], []
    for i in range(x.shape[0]):
        img = vae.to_uint8(vae_decode(pv, vcfg, x[i:i + 1] / sf + sh))
        img = img.permute(0, 3, 1, 2).float() / 255.0 * 2.0 - 1.0
        m, lv = vae_encode(pv, vcfg, img)
        means.append((m - sh) * sf)
        logvars.append(lv + 2.0 * math.log(sf))
    return torch.cat(means), torch.cat(logvars)


def stage1(p: Prec, cfg: Dict, blk: Dict, t5_src: torch.Tensor,
           t5_dst: torch.Tensor, mean: torch.Tensor, logvar: torch.Tensor,
           rows: Sequence[int], edit: Dict, rng_seed: int
           ) -> Dict[str, List[torch.Tensor]]:
    """The z and z0 of both CLIP encoders, ``[(len(rows), H1), (len(rows),
    H2)]``, of the concepts ``rows`` of a block; ``blk`` as in
    ``sdxl_edit.stage1``, ``t5_src``/``t5_dst`` (len(rows), P, S3, 4096)
    T5's states of the rows' source and dest prompts, ``mean``/``logvar``
    the rows' training-image posteriors (len(rows), P, c, h, w)."""
    mcfg = cfg["transformer"]
    pm = sub(p, "mmdit.")
    src, dst, pos = blk["src"], blk["dst"], blk["pos"]
    C, P, S = src.shape
    dev = src.device
    R = len(rows)
    r = torch.as_tensor(list(rows), device=dev)
    src_2 = sdxl_edit.encoder2_ids(src, cfg["text_encoder"]["eos_token_id"])
    L = {1: edit["layers"][-1], 2: edit["layers_2"][-1]}
    hw = edit["resolution"] // cfg["vae_scale"]
    ch = mcfg["in_channels"]
    table = train_sigmas().to(dev)
    with torch.no_grad():
        z0 = []
        for which, ids in ((1, src), (2, src_2)):
            h, _ = sdxl_edit.clip.encode(
                p, cfg[sdxl_edit.KEY[which]], ids[r, 0],
                prefix=sdxl_edit.PREFIX[which], stop_at=L[which])
            z0.append(h[torch.arange(R, device=dev), pos[r, 0]])
        ctx_d, pooled_d, pool1_d, pool2_d = condition(
            p, cfg, dst[r].reshape(R * P, S), t5_dst.flatten(0, 1))
        ctx_d, pooled_d, pool1_d, pool2_d = (
            a.reshape((R, P) + a.shape[1:])
            for a in (ctx_d, pooled_d, pool1_d, pool2_d))
    z0n = [z.norm(dim=-1) for z in z0]
    deltas = [torch.zeros_like(z) for z in z0]
    moments = [(torch.zeros_like(z), torch.zeros_like(z)) for z in z0]
    wd, lr = edit["v_weight_decay"], edit["v_lr"]
    ta = edit["text_repr_loss_scale_factor"]
    at = torch.arange(P, device=dev)
    gen = torch.Generator(device=dev).manual_seed(int(rng_seed))
    for step in range(edit["v_num_grad_steps"]):
        draws = []
        for _ in range(C):
            torch.randint(0, 1, (P,), generator=gen, device=dev)  # image
            post = torch.randn((P, hw, hw, ch), generator=gen, device=dev)
            noise = torch.randn((P, hw, hw, ch), generator=gen, device=dev)
            t = torch.randint(0, N_TRAIN, (P,), generator=gen, device=dev)
            draws.append((post.permute(0, 3, 1, 2),
                          noise.permute(0, 3, 1, 2), t))
        grads = [torch.zeros_like(d) for d in deltas]
        for j, c in enumerate(rows):
            post, noise, t = draws[c]
            lat = mean[j] + torch.exp(0.5 * logvar[j]) * post
            s = table[t][:, None, None, None]
            noisy = (1 - s) * lat + s * noise
            tm = table[t] * 1000.0
            d = [x[j].clone().requires_grad_() for x in deltas]
            inj = [torch.zeros((P, S, x.shape[-1]), device=dev).index_put(
                (at, pos[c]), x.expand(P, -1)) for x in d]
            ctx, pooled, pool1, pool2 = condition(
                p, cfg, src[c], t5_src[j], src_2[c], inject_1=(L[1], inj[0]),
                inject_2=(L[2], inj[1]))
            loss = sum(wd * torch.sqrt(x.pow(2).sum() + 1e-12) / n[j] ** 2
                       for x, n in zip(d, z0n))
            loss = loss + ta * ((pool1 - pool1_d[j]).pow(2).mean()
                                + (pool2 - pool2_d[j]).pow(2).mean())
            g = list(torch.autograd.grad(loss, d, retain_graph=True))
            for k in range(P):
                one = slice(k, k + 1)
                with torch.no_grad():
                    v_d = mmdit(pm, mcfg, noisy[one], tm[one], ctx_d[j, one],
                                pooled_d[j, one])
                v = mmdit(pm, mcfg, noisy[one], tm[one], ctx[one],
                          pooled[one])
                gk = torch.autograd.grad((v - v_d).pow(2).mean() / P, d,
                                         retain_graph=k < P - 1)
                g = [a + b for a, b in zip(g, gk)]
            for x, gx in zip(grads, g):
                x[j] = gx
        with torch.no_grad():
            n = step + 1
            b1, b2 = pipelines.ADAM_B1, pipelines.ADAM_B2
            eps = pipelines.ADAM_EPS
            for x, (m1, m2), gx, zn in zip(deltas, moments, grads, z0n):
                m1.mul_(b1).add_(gx, alpha=1 - b1)
                m2.mul_(b2).addcmul_(gx, gx, value=1 - b2)
                x -= lr * (m1 / (1 - b1 ** n)) / (
                    torch.sqrt(m2 / (1 - b2 ** n)) + eps)
                x *= torch.clamp(edit["clamp_norm_factor"] * zn
                                 / x.norm(dim=-1).clamp_min(1e-12),
                                 max=1.0)[:, None]
    return {"z": [z + x for z, x in zip(z0, deltas)], "z0": z0}

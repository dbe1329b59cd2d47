"""SDXL edit traffic: whole edit blocks through the program's
``emcid_torch.engine.sdxl.apply_emcid_sdxl``, closed loop.

Set-up makes the weights and the caption corpus from the seed and warms
up one block at the traffic's shapes with fewer sampler and Stage-1
steps; that block fills both encoders' covariance caches (the product
pre-caches them once per model; every block loads them).  The window runs
blocks of new concepts until it has passed, finishes the block in flight,
and records the program's spans of its blocks (``facts["program"]``).
The check draws one block of the window and one of its concepts from the
seed: the reference (``portbench.reference.sdxl_edit``) computes its
training images and Stage 1 itself, and Stage 2 from the program's z of
the whole block, against the fc2 weights the program wrote in both
encoders.

The edited layers are stated as a count, ``edit_depth``: in each encoder
the layers that end at its context tap, layer n - 2, clipped at 0.
"""

from __future__ import annotations

import shutil
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import tokens, trace, yardstick
from portbench.drivers.edit import block_tokens, drawn, requests
from portbench.drivers.generate import components
from portbench.harness import (
    Context,
    fma_launches,
    free_cuda,
    peak_bytes,
    reference_params,
    wrapped,
)
from portbench.reference import sdxl_edit
from portbench.reference.ops import Prec, exact_f32


def edited_layers(tcfg: Dict, depth: int) -> List[int]:
    n = tcfg["num_hidden_layers"]
    return list(range(max(0, n - 1 - depth), n - 1))


def edit_params(ctx: Context) -> Dict:
    """The traffic's edit settings with both encoders' layers."""
    tr, d = ctx.traffic, ctx.traffic["edit_depth"]
    return dict(tr["hparams"], resolution=tr["resolution"], steps=tr["steps"],
                sampler=tr["sampler"], guidance_scale=tr["guidance_scale"],
                cfg_interval=tr["cfg_interval"],
                layers=edited_layers(ctx.cfg["text_encoder"], d),
                layers_2=edited_layers(ctx.cfg["text_encoder_2"], d))


def hparams(ctx: Context, **change):
    from emcid_torch.hparams import EMCIDXLHyperParams

    e = edit_params(ctx)
    return EMCIDXLHyperParams.from_dict(dict(
        ctx.traffic["hparams"], layers=e["layers"], layers_2=e["layers_2"],
        **change))


def entry_args(ctx: Context, steps: int) -> Dict:
    """``apply_emcid_sdxl``'s arguments that the traffic fixes."""
    tr = ctx.traffic
    st = ctx.tmp / "stats"
    return dict(stats_dir_1=st / "text1", stats_dir_2=st / "text2",
                height=tr["resolution"], width=tr["resolution"],
                num_inference_steps=steps, cfg_interval=tr["cfg_interval"],
                verbose=False)


def setup(ctx: Context) -> Dict:
    from emcid_torch.engine.sdxl import apply_emcid_sdxl

    tr = ctx.traffic
    comps = components(ctx)
    shutil.rmtree(ctx.tmp / "stats", ignore_errors=True)
    caps = tokens.captions(ctx.rng(1), tr["stats_captions"],
                           *tr["caption_words"])
    warm = tr["warmup"]
    apply_emcid_sdxl(comps, requests(ctx, ctx.rng(2), tr["batch"]),
                     hparams(ctx, v_num_grad_steps=warm["grad_steps"]),
                     captions=caps, rng_seed=0,
                     **entry_args(ctx, warm["steps"]))
    ctx.sync()
    return {"comps": comps, "captions": caps, "hp": hparams(ctx)}


def run(ctx: Context) -> Dict:
    """The window (and with ``ctx.trace`` one block more under the
    profiler), then the check."""
    from emcid_torch import profiling
    from emcid_torch.engine import sdxl
    from emcid_torch.ops import _build

    st = setup(ctx)
    tr = ctx.traffic
    comps, hp = st["comps"], st["hp"]
    C = tr["batch"]
    fc2 = [(k, hp.rewrite_module_tmp.format(i))
           for k, layers in ((1, hp.layers), (2, hp.layers_2))
           for i in layers]
    zs_out: List = []
    rng = ctx.rng(3)
    blocks = []

    def block(timings=None):
        reqs = requests(ctx, rng, C)
        seed = int(rng.integers(0, 2 ** 31))
        edited = sdxl.apply_emcid_sdxl(
            comps, reqs, hp, rng_seed=seed, timings=timings,
            **entry_args(ctx, tr["steps"]))[2]
        ctx.sync()
        blocks.append({"requests": reqs, "rng_seed": seed, "z": zs_out[-1],
                       "fc2": [edited.encoder(k).get_submodule(n).weight
                               .detach().cpu() for k, n in fc2]})

    def keep_z(orig):
        def f(*a, **k):
            out = orig(*a, **k)
            zs_out.append(tuple(np.asarray(z) for z in out))
            return out
        return f

    setup_s = time.time() - ctx.t_start
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    _build.reset_launches()
    with wrapped(sdxl, "compute_z_sdxl_text_encoders", keep_z):
        timings: Dict[str, float] = {}
        with profiling.recording(ctx.device) as rec:
            t0 = time.perf_counter()
            n = 0
            while True:
                block(timings if ctx.trace else None)
                n += 1
                if ctx.trace or time.perf_counter() - t0 >= ctx.seconds:
                    break
            wall = time.perf_counter() - t0
        ctx.facts["program"] = rec.summary()
        peak = peak_bytes(ctx)
        fma = fma_launches()
        if ctx.trace:
            ctx.facts["trace"] = trace.traced(ctx, block)
    lat = tr["resolution"] // ctx.cfg["vae_scale"]
    ucfg = ctx.cfg["unet"]
    P = len(tr["prompts"])
    # per concept and step: the edited forward, its backward into the
    # input (one forward's worth) and the dest forward, at a batch of P
    s1_flops = (3 * tr["hparams"]["v_num_grad_steps"]
                * yardstick.unet_fwd_flops(ucfg, C * P, lat))
    img_flops = yardstick.guided_flops(
        ucfg, C * P, lat, tr["sampler"], tr["steps"],
        max(1, round(tr["cfg_interval"] * tr["steps"])))
    ctx.facts.update({
        "kind": "edit", "blocks": n, "block_s": wall / n, "phases": timings,
        "flops": {"stage1": s1_flops, "edit": s1_flops + img_flops},
        "peak_mem_bytes": peak})
    metrics = {"concepts_per_s": n * C / wall, "setup_s": setup_s}
    del comps, st["comps"]
    free_cuda(ctx)
    checks = dict(check(ctx, blocks, st["captions"]), fma_launches=fma)
    return {"attempted": n * C, "metrics": metrics, "checks": checks,
            "peak": peak, "window": {"blocks": blocks,
                                     "captions": st["captions"]}}


def reference_block(ctx: Context, p: Prec, blk: Dict, rows: List[int],
                    captions: List[str], zs=None) -> Dict:
    """Under ``p``: both encoders' z (and z0) of the concepts ``rows`` of
    a block, from their own training images, and, given every concept's z
    of both encoders ``zs`` ([(C, H1), (C, H2)]), or with every row its
    own z, the float64 fc2 updates of the edited layers (encoder 1's,
    then encoder 2's)."""
    cfg, edit = ctx.cfg, edit_params(ctx)
    tk = block_tokens(ctx, blk["requests"])
    P = tk["src"].shape[1]
    r = torch.as_tensor(rows, device=ctx.device)
    seeds = [blk["requests"][c]["seed_train"] * 10007 + k
             for c in rows for k in range(P)]
    with exact_f32():
        mean, logvar = sdxl_edit.training_posteriors(
            p, cfg, tk["src"][r].flatten(0, 1), tk["neg"][:len(seeds)],
            seeds, edit)
        shape = (len(rows), P) + tuple(mean.shape[1:])
        s1 = sdxl_edit.stage1(p, cfg, tk, mean.reshape(shape),
                              logvar.reshape(shape), rows, edit,
                              blk["rng_seed"])
        out = {"z_rows": s1["z"], "z0_rows": s1["z0"]}
        if zs is None:
            if len(rows) != len(blk["requests"]):
                return out
            zs = s1["z"]
        _, _, wid = tokens.vocabulary()
        cap_ids, cap_mask = (torch.as_tensor(a, device=ctx.device)
                             for a in tokens.ids(captions, wid))
        covs = sdxl_edit.covariances(p, cfg, cap_ids, cap_mask, edit)
        out["updates"] = sdxl_edit.stage2(
            p, cfg, tk["src"].flatten(0, 1), tk["pos"].flatten(), zs, covs,
            edit)
    return out


def check(ctx: Context, blocks: List[Dict], captions: List[str]) -> Dict:
    """The compared numbers of the drawn block."""
    blk, rows = drawn(ctx, blocks)
    C = len(blk["requests"])
    params = reference_params(ctx)
    z_port = [torch.as_tensor(z, device=ctx.device).reshape(C, -1)
              for z in blk["z"]]
    ref = reference_block(ctx, Prec(params), blk, rows, captions, zs=z_port)
    return compare(ctx, params, rows, ref, z_port, blk["fc2"])


def originals(ctx: Context, params: Dict) -> List[torch.Tensor]:
    """The fc2 weights of the edited layers before the edit, encoder 1's
    then encoder 2's."""
    e = edit_params(ctx)
    name = ctx.traffic["hparams"]["rewrite_module_tmp"] + ".weight"
    return [params[sdxl_edit.PREFIX[k] + name.format(i)]
            for k, layers in ((1, e["layers"]), (2, e["layers_2"]))
            for i in layers]


def compare(ctx: Context, params: Dict, rows: List[int], ref: Dict,
            z_sys: List[torch.Tensor], fc2_sys: List[torch.Tensor]
            ) -> Dict[str, float]:
    """``z_gap``: the worst of the rows' and encoders' |z - z_ref| over
    the reference's own step |z_ref - z0_ref|; ``fc2_gap``: the worst
    edited layer's |W_written - s(W + upd_ref)| over |upd_ref| (float64),
    ``s`` the rounding to the written weight's dtype, so that storage
    rounds both sides alike."""
    z_gap = 0.0
    for zs, zr, z0 in zip(z_sys, ref["z_rows"], ref["z0_rows"]):
        zr, z0 = zr.double(), z0.double()
        zp = zs[torch.as_tensor(rows, device=zs.device)].double().to(
            zr.device)
        z_gap = max(z_gap, float(((zp - zr).norm(dim=-1) / (zr - z0).norm(
            dim=-1).clamp_min(1e-300)).max()))
    gaps = []
    for w0, w_new, upd in zip(originals(ctx, params), fc2_sys,
                              ref["updates"]):
        w_ref = (w0.to(upd.device).double() + upd).to(w_new.dtype).double()
        d = w_new.to(upd.device).double() - w_ref
        gaps.append(float(d.norm() / upd.norm().clamp_min(1e-300)))
    return {"z_gap": z_gap, "fc2_gap": max(gaps)}


def control(ctx: Context, window: Dict) -> Dict:
    """The check's numbers with the reference in float8 in the program's
    place: its z of every concept of the checked block and the fc2
    weights it writes from them in the served dtype, against the float32
    reference."""
    blk, rows = drawn(ctx, window["blocks"])
    captions = window["captions"]
    C = len(blk["requests"])
    params = reference_params(ctx)
    sys_out = reference_block(ctx, Prec(params, fp8=True), blk,
                              list(range(C)), captions)
    fc2 = [(w0.double() + u.to(w0.device)).to(ctx.dtype).cpu()
           for w0, u in zip(originals(ctx, params), sys_out["updates"])]
    ref = reference_block(ctx, Prec(params), blk, rows, captions,
                          zs=sys_out["z_rows"])
    return compare(ctx, params, rows, ref, sys_out["z_rows"], fc2)

"""Edit traffic: whole EMCID edit blocks through the program's
``emcid_torch.engine.editor.apply_emcid``, closed loop.

Set-up makes the weights and the caption corpus from the seed, fills the
covariance cache of the edited layers (the product pre-caches it once per
model; every call loads it), and warms up one block at the traffic's
shapes with fewer sampler and Stage-1 steps.  The window runs blocks of
new concepts until it has passed and finishes the block in flight.  The
check draws one block of the window and some of its concepts from the
seed: the reference computes their training images and Stage 1 itself,
and Stage 2 from the program's z of the whole block (the stage that joins
the concepts), against the fc2 weights the program wrote.
"""

from __future__ import annotations

import dataclasses
import shutil
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import tokens, trace, yardstick
from portbench.harness import (
    Context,
    fma_launches,
    free_cuda,
    host_spans,
    peak_bytes,
    port_modules,
    reference_params,
    wrapped,
)
from portbench.reference import pipelines
from portbench.reference.ops import Prec, exact_f32


def requests(ctx: Context, rng: np.random.Generator, n: int) -> List[Dict]:
    tr = ctx.traffic
    w = tokens.concept_words(rng, 2 * n)
    return [{"prompts": list(tr["prompts"]), "source": w[2 * i],
             "dest": w[2 * i + 1],
             "seed_train": int(rng.integers(0, 2 ** 20))} for i in range(n)]


def hparams(ctx: Context, **change):
    from emcid_torch.hparams import EMCIDHyperParams

    return dataclasses.replace(
        EMCIDHyperParams.from_dict(dict(ctx.traffic["hparams"])), **change)


def product_args(ctx: Context, train_steps: int) -> Dict:
    """``apply_emcid``'s arguments that the traffic fixes (the product's
    defaults at SD-v1.4's native 512 px, stated so that the cell does not
    move with them)."""
    e = ctx.traffic["edit"]
    return dict(train_sampler=e["train_sampler"], train_steps=train_steps,
                train_res=e["train_res"], cfg_interval=e["cfg_interval"],
                eps_dest_pool=e["eps_pool"], z_sched="cosine")


def setup(ctx: Context) -> Dict:
    from emcid_torch.engine.editor import apply_emcid, resolve_covariances_for
    from emcid_torch.models.pipeline import SDComponents
    from emcid_torch.models.scheduler import sd_schedule

    tr = ctx.traffic
    mods = port_modules(ctx)
    comps = SDComponents(
        tokenizer=tokens.port_tokenizer(), text_encoder=mods["text_encoder"],
        unet=mods["unet"], vae=mods["vae"], schedule=sd_schedule(),
        scaling_factor=ctx.cfg["vae"]["scaling_factor"],
        vae_scale=ctx.cfg["vae_scale"])
    stats = ctx.tmp / "stats"
    shutil.rmtree(stats, ignore_errors=True)
    caps = tokens.captions(ctx.rng(1), tr["stats_captions"],
                           *tr["caption_words"])
    hp = hparams(ctx)
    resolve_covariances_for(comps.text_encoder, comps.tokenizer, hp,
                            stats_dir=stats, captions=caps, verbose=False)
    warm = tr["warmup"]
    apply_emcid(comps, requests(ctx, ctx.rng(2), tr["concepts_per_block"]),
                hparams(ctx, v_num_grad_steps=warm["grad_steps"]),
                stats_dir=stats, rng_seed=0, verbose=False,
                **product_args(ctx, warm["train_steps"]))
    ctx.sync()
    return {"comps": comps, "stats": stats, "captions": caps, "hp": hp}


def run(ctx: Context) -> Dict:
    """The window (and with ``ctx.trace`` one block more under the
    profiler), then the check."""
    from emcid_torch.engine import compute_z, editor
    from emcid_torch.ops import _build

    st = setup(ctx)
    tr = ctx.traffic
    comps, hp = st["comps"], st["hp"]
    C = tr["concepts_per_block"]
    fc2 = [hp.rewrite_module_tmp.format(i) for i in hp.layers]
    zs_out: List[np.ndarray] = []
    rng = ctx.rng(3)
    blocks = []

    def block(timings=None):
        reqs = requests(ctx, rng, C)
        seed = int(rng.integers(0, 2 ** 31))
        edited, _ = editor.apply_emcid(
            comps, reqs, hp, stats_dir=st["stats"], cache_name=None,
            rng_seed=seed, timings=timings, verbose=False,
            **product_args(ctx, tr["edit"]["train_steps"]))
        ctx.sync()
        enc = edited.text_encoder
        blocks.append({"requests": reqs, "rng_seed": seed, "z": zs_out[-1],
                       "fc2": [enc.get_submodule(n).weight.detach().cpu()
                               for n in fc2]})

    def keep_z(orig):
        def f(*a, **k):
            out = orig(*a, **k)
            zs_out.append(np.asarray(out))
            return out
        return f

    setup_s = time.time() - ctx.t_start
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    _build.reset_launches()
    with wrapped(editor, "compute_zs_for_requests", keep_z):
        timings: Dict[str, float] = {}
        t0 = time.perf_counter()
        n = 0
        while True:
            block(timings if ctx.trace else None)
            n += 1
            if ctx.trace or time.perf_counter() - t0 >= ctx.seconds:
                break
        wall = time.perf_counter() - t0
        peak = peak_bytes(ctx)
        fma = fma_launches()
        if ctx.trace:
            spans: Dict[str, float] = {}
            sites = [(editor, "resolve_covariances_for"),
                     (editor, "training_latents_for_requests"),
                     (compute_z.ZOptimizer, "run"),
                     (editor, "execute_emcid_text_encoder")]
            with host_spans(ctx, sites, spans, annotate=True):
                ctx.facts["trace"] = trace.traced(ctx, block)
    lat = tr["edit"]["train_res"] // ctx.cfg["vae_scale"]
    P = len(tr["prompts"])
    ucfg = ctx.cfg["unet"]
    steps = len(pipelines.lr_values(edit_params(ctx)))
    pool = tr["edit"]["eps_pool"]
    s1_flops = (2 * steps + pool) * yardstick.unet_fwd_flops(ucfg, C * P, lat)
    img_flops = yardstick.guided_flops(
        ucfg, C * P, lat, tr["edit"]["train_sampler"],
        tr["edit"]["train_steps"],
        max(1, round(tr["edit"]["cfg_interval"] * tr["edit"]["train_steps"])))
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


def block_tokens(ctx: Context, reqs: List[Dict]) -> Dict[str, torch.Tensor]:
    """The reference's token ids of a block: source and dest prompts
    (C, P, S), the edit-token positions (C, P), and the training prompts'
    negative (empty) prompt."""
    _, _, wid = tokens.vocabulary()
    P = len(reqs[0]["prompts"])
    src = [t.format(r["source"]) for r in reqs for t in r["prompts"]]
    dst = [t.format(r["dest"]) for r in reqs for t in r["prompts"]]
    dev = ctx.device
    s_ids = torch.as_tensor(tokens.ids(src, wid)[0], device=dev)
    d_ids = torch.as_tensor(tokens.ids(dst, wid)[0], device=dev)
    pos = torch.as_tensor([[tokens.word_position(t) for t in r["prompts"]]
                           for r in reqs], device=dev)
    neg = torch.as_tensor(tokens.ids([""] * len(src), wid)[0], device=dev)
    C = len(reqs)
    return {"src": s_ids.reshape(C, P, -1), "dst": d_ids.reshape(C, P, -1),
            "pos": pos, "neg": neg}


def edit_params(ctx: Context) -> Dict:
    tr = ctx.traffic
    return dict(tr["edit"], layers=list(tr["hparams"]["layers"]),
                **{k: tr["hparams"][k] for k in (
                    "v_num_grad_steps", "v_lr", "v_weight_decay",
                    "clamp_norm_factor", "text_repr_loss_scale_factor",
                    "mom2_update_weight")})


def reference_block(ctx: Context, p: Prec, blk: Dict, rows: List[int],
                    captions: List[str], zs=None) -> Dict:
    """Under ``p``: the z (and z0) of the concepts ``rows`` of a block,
    from their own training images, and, given the z of every concept
    ``zs`` (C, H), or with every row its own z, the float64 fc2 update of
    each edited layer."""
    cfg, edit = ctx.cfg, edit_params(ctx)
    tk = block_tokens(ctx, blk["requests"])
    P = tk["src"].shape[1]
    r = torch.as_tensor(rows, device=ctx.device)
    seeds = [blk["requests"][c]["seed_train"] * 10007 + k
             for c in rows for k in range(P)]
    with exact_f32():
        mean, logvar = pipelines.training_posteriors(
            p, cfg, tk["src"][r].flatten(0, 1), tk["neg"][:len(seeds)],
            seeds, edit)
        shape = (len(rows), P) + tuple(mean.shape[1:])
        s1 = pipelines.stage1(p, cfg, tk, mean.reshape(shape),
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
        covs = [pipelines.covariance(p, cfg["text_encoder"], cap_ids,
                                     cap_mask, i) for i in edit["layers"]]
        ups = pipelines.stage2(p, cfg["text_encoder"], tk["src"].flatten(0, 1),
                               tk["pos"].flatten(), zs, covs, edit)
    out["updates"] = ups
    return out


def drawn(ctx: Context, blocks: List[Dict]):
    """The checked block and its checked concepts, drawn from the seed."""
    rng = ctx.rng(4)
    blk = blocks[int(rng.integers(0, len(blocks)))]
    C = len(blk["requests"])
    n = min(ctx.traffic["check_concepts"], C)
    return blk, sorted(int(i) for i in rng.choice(C, size=n, replace=False))


def check(ctx: Context, blocks: List[Dict], captions: List[str]) -> Dict:
    """The compared numbers of the drawn block."""
    blk, rows = drawn(ctx, blocks)
    params = reference_params(ctx)
    p = Prec(params)
    C = len(blk["requests"])
    z_port = torch.as_tensor(blk["z"], device=ctx.device).reshape(C, -1)
    ref = reference_block(ctx, p, blk, rows, captions, zs=z_port)
    return compare(ctx, params, blk, rows, ref, z_port, blk["fc2"])


def compare(ctx: Context, params: Dict, blk: Dict, rows: List[int],
            ref: Dict, z_sys: torch.Tensor, fc2_sys: List[torch.Tensor]
            ) -> Dict[str, float]:
    """``z_gap``: the worst of the rows' |z - z_ref| over the reference's
    own step |z_ref - z0_ref|; ``fc2_gap``: the worst layer's
    |W_written - W - upd_ref| over |upd_ref| (float64)."""
    zr, z0 = ref["z_rows"].double(), ref["z0_rows"].double()
    zp = z_sys[torch.as_tensor(rows, device=z_sys.device)].double().to(
        zr.device)
    z_gap = float(((zp - zr).norm(dim=-1)
                   / (zr - z0).norm(dim=-1).clamp_min(1e-300)).max())
    hp = ctx.traffic["hparams"]
    gaps = []
    for i, w_new, upd in zip(hp["layers"], fc2_sys, ref["updates"]):
        w0 = params[f"text_model.encoder.layers.{i}.mlp.fc2.weight"]
        d = w_new.to(upd.device).double() - w0.double()
        gaps.append(float((d - upd).norm() / upd.norm().clamp_min(1e-300)))
    return {"z_gap": z_gap, "fc2_gap": max(gaps)}


def control(ctx: Context, window: Dict) -> Dict:
    """The check's numbers with the reference in float8 in the program's
    place: its z of every concept of the checked block and the bf16 fc2
    weights it writes from them, against the float32 reference."""
    blk, rows = drawn(ctx, window["blocks"])
    captions = window["captions"]
    C = len(blk["requests"])
    params = reference_params(ctx)
    sys_out = reference_block(ctx, Prec(params, fp8=True), blk,
                              list(range(C)), captions)
    fc2 = [(params[f"text_model.encoder.layers.{i}.mlp.fc2.weight"].double()
            + u).to(ctx.dtype).cpu()
           for i, u in zip(ctx.traffic["hparams"]["layers"],
                           sys_out["updates"])]
    ref = reference_block(ctx, Prec(params), blk, rows, captions,
                          zs=sys_out["z_rows"])
    return compare(ctx, params, blk, rows, ref, sys_out["z_rows"], fc2)

"""Generation traffic: batches of prompts through the program's
``emcid_torch.models.pipeline.generate`` (SD) or
``emcid_torch.models.sdxl.generate_sdxl`` (SDXL), closed loop, as an
evaluation harness renders its prompt sets.

Set-up makes the weights from the seed and warms up one batch at the
traffic's shapes with two sampler steps.  The window renders batches of
new prompts, each image with its own seed, until it has passed and
finishes the batch in flight.  The check draws images of the window from
the seed and renders them again with the reference.
"""

from __future__ import annotations

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
)
from portbench.reference import pipelines
from portbench.reference.ops import Prec, exact_f32


def _sdxl(ctx: Context) -> bool:
    return "text_encoder_2" in ctx.cfg


def components(ctx: Context):
    from emcid_torch.models.scheduler import sd_schedule

    mods = port_modules(ctx)
    kw = dict(tokenizer=tokens.port_tokenizer(), schedule=sd_schedule(),
              scaling_factor=ctx.cfg["vae"]["scaling_factor"],
              vae_scale=ctx.cfg["vae_scale"], **mods)
    if _sdxl(ctx):
        from emcid_torch.models.sdxl import SDXLComponents

        return SDXLComponents(**kw)
    from emcid_torch.models.pipeline import SDComponents

    return SDComponents(**kw)


def prompts(ctx: Context, rng: np.random.Generator, n: int) -> List[str]:
    spec = ctx.traffic["prompts"]
    if spec["kind"] == "template":
        ts = spec["templates"]
        return [ts[int(rng.integers(0, len(ts)))].format(w)
                for w in tokens.concept_words(rng, n)]
    return tokens.captions(rng, n, *spec["words"])


def entry(ctx: Context):
    """(module, attribute) of the program's entry for this cell, and the
    sampler and decode attributes it calls."""
    if _sdxl(ctx):
        from emcid_torch.models import sdxl

        return sdxl, "generate_sdxl", [(sdxl, "sample_latents_sdxl"),
                                       (sdxl, "decode_latents")]
    from emcid_torch.models import pipeline

    return pipeline, "generate", [(pipeline, "sample_latents"),
                                  (pipeline, "decode_latents")]


def run(ctx: Context) -> Dict:
    tr = ctx.traffic
    comps = components(ctx)
    mod, name, sites = entry(ctx)
    B = tr["batch"]
    kw = dict(guidance_scale=tr["guidance_scale"], height=tr["resolution"],
              width=tr["resolution"], sampler=tr["sampler"])

    def batch(rng, steps):
        ps = prompts(ctx, rng, B)
        seeds = [int(s) for s in rng.integers(0, 2 ** 31, size=B)]
        imgs = getattr(mod, name)(comps, ps, seeds,
                                  num_inference_steps=steps, **kw)
        ctx.sync()
        return {"prompts": ps, "seeds": seeds, "images": np.asarray(imgs)}

    from emcid_torch.ops import _build

    batch(ctx.rng(2), tr["warmup_steps"])
    _build.reset_launches()
    rng = ctx.rng(3)
    out = []
    setup_s = time.time() - ctx.t_start
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)
    t0 = time.perf_counter()
    if ctx.trace:
        spans: Dict[str, float] = {}
        with host_spans(ctx, sites, spans):
            out.append(batch(rng, tr["steps"]))
        wall = time.perf_counter() - t0
        peak = peak_bytes(ctx)
        with host_spans(ctx, sites, {}, annotate=True):
            ctx.facts["trace"] = trace.traced(
                ctx, lambda: out.append(batch(rng, tr["steps"])))
        ctx.facts["spans"] = {k.split("_")[0]: v for k, v in spans.items()}
    else:
        while True:
            out.append(batch(rng, tr["steps"]))
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        wall = time.perf_counter() - t0
        peak = peak_bytes(ctx)
    fma = fma_launches()
    n = 1 if ctx.trace else len(out)
    lat = tr["resolution"] // ctx.cfg["vae_scale"]
    ctx.facts.update({
        "kind": "gen", "batches": n, "images": n * B, "batch_s": wall / n,
        "flops": {"generate": yardstick.guided_flops(
            ctx.cfg["unet"], B, lat, tr["sampler"], tr["steps"])},
        "peak_mem_bytes": peak})
    metrics = {"images_per_s": n * B / wall, "setup_s": setup_s}
    del comps
    free_cuda(ctx)
    return {"attempted": len(out) * B, "metrics": metrics,
            "checks": dict(check(ctx, out), fma_launches=fma), "peak": peak,
            "window": out}


def render(ctx: Context, p: Prec, prompts_: List[str], seeds: List[int]
           ) -> torch.Tensor:
    """The reference's uint8 images of ``prompts_`` under ``p``."""
    _, _, wid = tokens.vocabulary()
    ids = torch.as_tensor(tokens.ids(prompts_, wid)[0], device=ctx.device)
    neg = torch.as_tensor(tokens.ids([""] * len(prompts_), wid)[0],
                          device=ctx.device)
    fn = pipelines.generate_sdxl if _sdxl(ctx) else pipelines.generate_sd
    with exact_f32(), torch.no_grad():
        return fn(p, ctx.cfg, ids, neg, seeds, ctx.traffic)


def picks(ctx: Context, out: List[Dict]) -> List[tuple]:
    """(batch, image) pairs drawn from the seed among the window's images."""
    B = ctx.traffic["batch"]
    n = min(ctx.traffic["check_images"], len(out) * B)
    flat = ctx.rng(4).choice(len(out) * B, size=n, replace=False)
    return [(int(i) // B, int(i) % B) for i in sorted(flat)]


def check(ctx: Context, out: List[Dict]) -> Dict[str, float]:
    """``image_mae``: the worst drawn image's mean absolute difference from
    the reference's, in uint8 levels."""
    p = Prec(reference_params(ctx))
    worst = 0.0
    for b, i in picks(ctx, out):
        ref = render(ctx, p, [out[b]["prompts"][i]], [out[b]["seeds"][i]])
        got = torch.as_tensor(out[b]["images"][i], device=ref.device)
        worst = max(worst, float((got.float() - ref[0].float()).abs().mean()))
    return {"image_mae": worst}


def control(ctx: Context, out: List[Dict]) -> Dict[str, float]:
    """``image_mae`` with the reference in float8 in the program's place."""
    params = reference_params(ctx)
    p, p8 = Prec(params), Prec(params, fp8=True)
    worst = 0.0
    for b, i in picks(ctx, out):
        args = ([out[b]["prompts"][i]], [out[b]["seeds"][i]])
        ref, sys_ = render(ctx, p, *args), render(ctx, p8, *args)
        worst = max(worst, float((sys_.float() - ref.float()).abs().mean()))
    return {"image_mae": worst}

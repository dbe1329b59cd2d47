"""SD3 edit traffic: whole edit blocks through the program's
``emcid_torch.engine.sd3.apply_emcid_sd3``, closed loop.

As ``edit_sdxl``: set-up makes the weights (``portbench.sd3_weights``) and
the caption corpus from the seed and warms up one block at the traffic's
shapes with fewer sampler and Stage-1 steps, which fills both CLIP
encoders' covariance caches; the window runs blocks of new concepts until
it has passed and finishes the block in flight; the check draws one block
and one of its concepts from the seed, and the reference
(``portbench.reference.sd3_edit``) computes T5's states, the training
images and Stage 1 itself, and Stage 2 from the program's z of the whole
block, against the fc2 weights the program wrote in both encoders.

T5's ids: each word of the synthetic vocabulary (``tokens.words``) is one
id, 3 + its index, then the end token 1 and padding 0 to the
configuration's ``t5_max_length`` (SD3's 256), as the
program's ``T5WordTokenizer`` over the same table lays them out.
"""

from __future__ import annotations

import shutil
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import harness, mmdit_flops, sd3_weights, tokens, trace
from portbench.drivers.edit import block_tokens, drawn, requests
from portbench.drivers.edit_sdxl import (
    compare,
    edit_params,
    entry_args,
    hparams,
    originals,
)
from portbench.harness import Context, fma_launches, free_cuda, peak_bytes
from portbench.reference import sd3_edit
from portbench.reference.ops import Prec, exact_f32


def t5_len(cfg: Dict) -> int:
    return cfg.get("t5_max_length", 256)


def t5_vocabulary() -> Dict[str, int]:
    return {w: 3 + i for i, w in enumerate(tokens.words())}


def t5_ids(texts: List[str], n: int) -> np.ndarray:
    """(N, n) int64: one id per word, the end token 1, padding 0."""
    vocab = t5_vocabulary()
    out = np.zeros((len(texts), n), np.int64)
    for i, t in enumerate(texts):
        ids = [vocab[w] for w in t.split()][:n - 1] + [1]
        out[i, :len(ids)] = ids
    return out


def components(ctx: Context):
    """The program's SD3 components over the benchmark's weights."""
    from emcid_torch.models.clip_text import CLIPTextEncoder
    from emcid_torch.models.configs import (
        mmdit_config_from_diffusers,
        t5_config_from_transformers,
        vae_config_from_diffusers,
    )
    from emcid_torch.models.mmdit import MMDiT
    from emcid_torch.models.sd3 import SD3Components
    from emcid_torch.models.t5_text import T5Encoder
    from emcid_torch.models.vae import AutoencoderKL
    from emcid_torch.text.t5_words import T5WordTokenizer

    cfg = ctx.cfg
    builders = {
        "text_encoder": lambda c: CLIPTextEncoder(harness.text_config(c)),
        "text_encoder_2": lambda c: CLIPTextEncoder(harness.text_config(c)),
        "text_encoder_3": lambda c: T5Encoder(t5_config_from_transformers(c)),
        "transformer": lambda c: MMDiT(mmdit_config_from_diffusers(c)),
        "vae": lambda c: AutoencoderKL(vae_config_from_diffusers(c)),
    }
    mods = {}
    for key, sd in sd3_weights.make(cfg, ctx.seed, ctx.device,
                                    ctx.dtype).items():
        with torch.device("meta"):
            m = builders[key](cfg[key])
        m.load_state_dict({k: v.clone() for k, v in sd.items()}, strict=True,
                          assign=True)
        mods[key] = m.eval().requires_grad_(False)
        del sd
    v = cfg["vae"]
    return SD3Components(
        tokenizer=tokens.port_tokenizer(),
        tokenizer_3=T5WordTokenizer(t5_vocabulary(),
                                    model_max_length=t5_len(cfg)),
        shift=cfg["scheduler"]["shift"], scaling_factor=v["scaling_factor"],
        shift_factor=v["shift_factor"], latent_channels=v["latent_channels"],
        vae_scale=cfg["vae_scale"], **mods)


def setup(ctx: Context) -> Dict:
    from emcid_torch.engine.sd3 import apply_emcid_sd3

    tr = ctx.traffic
    comps = components(ctx)
    shutil.rmtree(ctx.tmp / "stats", ignore_errors=True)
    caps = tokens.captions(ctx.rng(1), tr["stats_captions"],
                           *tr["caption_words"])
    warm = tr["warmup"]
    apply_emcid_sd3(comps, requests(ctx, ctx.rng(2), tr["batch"]),
                    hparams(ctx, v_num_grad_steps=warm["grad_steps"]),
                    captions=caps, rng_seed=0,
                    **entry_args(ctx, warm["steps"]))
    ctx.sync()
    return {"comps": comps, "captions": caps, "hp": hparams(ctx)}


def run(ctx: Context) -> Dict:
    """The window (and with ``ctx.trace`` one block more under the
    profiler), then the check."""
    from emcid_torch import profiling
    from emcid_torch.engine import sd3
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
        edited = sd3.apply_emcid_sd3(
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
    with harness.wrapped(sd3, "compute_z_sd3_text_encoders", keep_z):
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
    mcfg = ctx.cfg["transformer"]
    P = len(tr["prompts"])
    ctx_len = tokens.MAX_LEN + t5_len(ctx.cfg)
    # per concept and step: the edited forward, its backward into the
    # context (one forward's worth) and the dest forward, at a batch of P
    fwd = mmdit_flops.mmdit_fwd_flops(mcfg, C * P, lat, ctx_len)
    s1_flops = 3 * tr["hparams"]["v_num_grad_steps"] * fwd
    guided = max(1, round(tr["cfg_interval"] * tr["steps"]))
    img_flops = fwd * (2 * guided + tr["steps"] - guided)
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


def reference_params(ctx: Context, skip=()) -> Dict[str, torch.Tensor]:
    return sd3_weights.reference_params(sd3_weights.make(
        ctx.cfg, ctx.seed, ctx.device, ctx.dtype, skip=skip))


@torch.no_grad()
def reference_t5(ctx: Context, fp8: bool, reqs: List[Dict], rows: List[int]
                 ) -> Dict[str, torch.Tensor]:
    """T5's states (float32) of the rows' source and dest prompts (R, P,
    S3, D) and of the empty prompt (1, S3, D), under the precision of the
    check; T5's weights are made for this alone and freed."""
    texts = ([t.format(reqs[c]["source"]) for c in rows
              for t in reqs[c]["prompts"]]
             + [t.format(reqs[c]["dest"]) for c in rows
                for t in reqs[c]["prompts"]] + [""])
    state = sd3_weights.make(ctx.cfg, ctx.seed, ctx.device, ctx.dtype,
                             skip=("transformer", "vae"))["text_encoder_3"]
    ids = torch.as_tensor(t5_ids(texts, t5_len(ctx.cfg)), device=ctx.device)
    with exact_f32():
        h = sd3_edit.t5(Prec(state, fp8=fp8), ctx.cfg["text_encoder_3"], ids)
    del state
    free_cuda(ctx)
    R, P = len(rows), len(reqs[0]["prompts"])
    shape = (R, P) + h.shape[1:]
    return {"src": h[:R * P].reshape(shape),
            "dst": h[R * P:2 * R * P].reshape(shape), "empty": h[-1:]}


def reference_block(ctx: Context, fp8: bool, blk: Dict, rows: List[int],
                    captions: List[str], zs=None) -> Dict:
    """Under float32 (or with ``fp8`` float8): both encoders' z (and z0) of
    the concepts ``rows`` of a block, from T5's states and their own
    training images, and, given every concept's z of both encoders ``zs``
    ([(C, H1), (C, H2)]), or with every row its own z, the float64 fc2
    updates of the edited layers (encoder 1's, then encoder 2's)."""
    from portbench.reference import sdxl_edit

    cfg, edit = ctx.cfg, edit_params(ctx)
    t5 = reference_t5(ctx, fp8, blk["requests"], rows)
    p = Prec(reference_params(ctx, skip=("text_encoder_3",)), fp8=fp8)
    tk = block_tokens(ctx, blk["requests"])
    P = tk["src"].shape[1]
    r = torch.as_tensor(rows, device=ctx.device)
    seeds = [blk["requests"][c]["seed_train"] * 10007 + k
             for c in rows for k in range(P)]
    with exact_f32():
        mean, logvar = sd3_edit.training_posteriors(
            p, cfg, tk["src"][r].flatten(0, 1), tk["neg"][:len(seeds)],
            t5["src"].flatten(0, 1),
            t5["empty"].expand((len(seeds),) + t5["empty"].shape[1:]),
            seeds, edit)
        shape = (len(rows), P) + tuple(mean.shape[1:])
        s1 = sd3_edit.stage1(p, cfg, tk, t5["src"], t5["dst"],
                             mean.reshape(shape), logvar.reshape(shape),
                             rows, edit, blk["rng_seed"])
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
    z_port = [torch.as_tensor(z, device=ctx.device).reshape(C, -1)
              for z in blk["z"]]
    ref = reference_block(ctx, False, blk, rows, captions, zs=z_port)
    params = reference_params(ctx, skip=("text_encoder_3", "transformer",
                                         "vae"))
    return compare(ctx, params, rows, ref, z_port, blk["fc2"])


def control(ctx: Context, window: Dict) -> Dict:
    """The check's numbers with the reference in float8 in the program's
    place: its z of every concept of the checked block and the fc2
    weights it writes from them in the served dtype, against the float32
    reference."""
    blk, rows = drawn(ctx, window["blocks"])
    captions = window["captions"]
    C = len(blk["requests"])
    sys_out = reference_block(ctx, True, blk, list(range(C)), captions)
    params = reference_params(ctx, skip=("text_encoder_3", "transformer",
                                         "vae"))
    fc2 = [(w0.double() + u.to(w0.device)).to(ctx.dtype).cpu()
           for w0, u in zip(originals(ctx, params), sys_out["updates"])]
    ref = reference_block(ctx, False, blk, rows, captions,
                          zs=sys_out["z_rows"])
    return compare(ctx, params, rows, ref, sys_out["z_rows"], fc2)

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``emcid_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels-only   # phases 1-2, no device line

(``--dcn-worker SPEC`` is one rank of phase 7f, which the script starts
itself under ``python -m torch.distributed.run``.)

Phases, each printing one JSON line:

1. device: the card, its power limit, the kernel build time;
2. one phase per hand-written kernel (K1-K6) at the shapes the main paths
   give it (the SD-v1.4 shapes first, then K1-K4 at SDXL's): the kernel against its plain PyTorch version on the same
   inputs (bf16 at the product shapes, f32 and bf16 at small ragged
   shapes; the norm kernels also through their autograd.Function against
   autograd of the plain math), and the kernel's, the plain version's and
   one library call's time beside the least time the card could take
   (``bound_ms``).  Each row names the route it took; the norm backwards
   (K5b ``resident``/``stream``, K6b ``rows``/``generic``) run at the
   generation batch and at the Stage-1 backward's own shapes, must take
   the route their shape calls for, and must give the same bits (dx,
   dgamma, dbeta) in two calls on the same inputs; each timed one is
   also timed on its other route and beside ``torch.add(x, g)``, which
   moves the same bytes;
3. the main path: ``apply_emcid`` on the full-width SD-v1.4 pipeline
   (random weights from a seed) in bf16, 4 concepts in one block, with the
   launch count of every kernel (and of each route of K1-K4) during
   that run, the phase times, and checks of what comes out (finite z and
   deltas, only the fc2 weights of the edited layers changed, the on-card
   Stage-2 solve against the host float64 one, the tensor-core routes of
   K1-K4 taken and no float-FMA route);
4. the variant paths on that pipeline, each with the launch count of every
   kernel and route during its run, its seconds and checks of what comes
   out: (a) EWC with the UCE hybrid (the Fisher diagonal computed over 4
   generated pairs, cached and read back; the UCE solve against a host
   float64 solve of the same normal matrix), (b) the esd objective,
   (c) an SLD-supervised request, (d) txt-img-align with a full-width
   random CLIP ViT-L/14 vision tower; 2 concepts (one SLD request), 10
   Stage-1 steps, the main path's cached covariances;
4b. the UNet edit modes on that pipeline: a seam check (a zero inject at
   each of the five seam kinds, and the taps of all nine leaves, leave
   eps bitwise the same), then ``unet_edit_path``: (a) the cross-attention
   K/V edit (``apply_emcid_to_cross_attn``, 2 concepts, esd, 10 Stage-1
   steps, the covariance of 2000 synthetic captions' text states) and
   the same call again from its z and covariance caches, (b) one SLD
   ``strong`` request, (c) the region edit (``compute_delta_unet`` +
   ``execute_emcid_unet``) at up_blocks.3's three attn-out layers with
   both norm knobs at 1 and covariances from ``layer_stats_unet``, (d)
   the same at its three res-last-conv layers with
   ``use_sampled_noise``; per run the launches of every kernel and route,
   phase seconds, Stage-1 seconds per step, peak memory and checks
   (finite z and deltas, only the expected weights changed, text encoder
   and VAE bitwise unchanged, each Stage-2 solve against a host float64
   solve of the same system, the z error on the written bf16 weights
   below its value before the edit, the tensor-core routes and no
   ``fma``, K5b and K6b ``rows`` with the knobs);
5. model checks: that pipeline's bf16 UNet at the Stage-1 shape and its
   bf16 VAE (decode and re-encode of a 48x48 latent) with attention
   through the kernels against the plain attention path; the UNet in f32
   with its attention through the kernels (and, with
   ``EMCID_TPU_FUSED_GN`` at 1 or geo and ``EMCID_TPU_FUSED_LN=1``, its
   norms too) against the same UNet with the knobs off and every attention
   on the plain path, for eps and for the gradient into the text context
   (with the knobs at 1, both routes of K5b and of K6b run);
6. the CLI path: ``emcid_torch.cli.run_emcid`` with both norm knobs on, on
   a local HF-format checkpoint folder of the full-width pipeline (random
   f32 weights from seed 0): pre-edit generation, ``apply_emcid``,
   post-edit generation, with the launch count of every kernel (and
   route), phase times and checks of what comes out (finite z and deltas,
   only fc2 of the edited layers changed, 512x512 uint8 images written,
   K5b's ``resident`` and K6b's ``rows`` route taken);
7. the evaluation path on the same folder (``eval_path``), with random
   full-width scorers (a ViT-B/16 classifier, a CLIP ViT-L/14) and a
   synthetic ICEB request tree: (a) ``emcid_torch.cli.workflows aice``
   and the same call again, (b) ``workflows mend`` with both norm knobs
   at 1, (c) ``workflows debias --method emcid``, (d) ``workflows debias
   --method uce``, (e) ``apply_emcid_to_clip`` on the CLIP text tower;
   per run the launches of every kernel and route, phase seconds, images
   per second at 512 px and checks: summary records finite and stored
   under their key, the second aice call served from the summary without
   generating, the pre-edit PNG cache under the reference names, only the
   edited weights changed (fc2 of the edit layers; the cross-attention
   K/V projections for UCE), the ViT in f32 on the card against float64
   on the host, the debias UCE and the clip_edit Stage-2 solves against
   float64, the debias factors a distribution, the tensor-core routes of
   K1-K4 (and, with the knobs, K5b ``resident`` and K6b ``rows``);
7b. the preservation and single-concept benchmarks on the same folder
   (``preservation_path``), with the eval path's CLIP ViT-L/14, a random
   InceptionV3 and LPIPS and synthetic benchmark files: (a) ``workflows
   layer_stats --layers 0-11 --sample_size 2000`` (seconds per layer; C
   finite and symmetric; layers 7-10 against the main path's cached
   covariances over the same captions, 1e-6), (b) ``workflows coco`` with
   FID (FID(pre, pre) = 0 within 1e-4) and both norm knobs at 1, an edit
   of 2 concepts, the post-edit render, LPIPS, the CLIP score and the
   summary under ``coco_summary_key``'s key, InceptionV3 and LPIPS in f32
   against float64 on the card (1e-4), (c) ``workflows artists`` and
   ``eval_artists``, (d) ``workflows timed`` and ``road --method
   contrast`` with ``eval_all`` (F1 finite, the images under the JAX
   paths, the base text encoder bitwise unchanged after each loop), (e)
   ``workflows i2p`` with ``scripts/fake_nudenet.py`` as the detector;
   per run the launches of every kernel and route, seconds, images per
   second at 512 px and peak memory;
7c. the layer-localisation study and the experiments on the same folder
   (``trace_path``), with the eval path's ViT-B/16, CLIP ViT-L/14 and
   ICEB tree, the preservation path's I2P rows and a random full-width
   BLIP-base ITM folder: (a) causal tracing (``collect_embedding_std``,
   ``trace_important_states`` over all 12 layers and every real token of
   one prompt, DDIM-10 with CFG at 512 px, scored by the ViT;
   ``save_trace_images`` read back through the folder sweep's codec and
   scored by CLIP and BLIP ITM; BLIP in f32 against float64; a row
   restored at every token of the last layer equal to the clean row),
   (b) ``finetune_text_encoder`` (2 concepts x 3 prompts, 10 steps, 384
   px latents, both norm knobs at 1: K2/K3 on ``mma`` only, K5b and K6b;
   only the edit layers' fc2 changed, UNet and VAE bitwise unchanged),
   (c) ``workflows sequential`` (3 rounds, 2 samples), (d) the mixed ICEB
   + I2P edit (EMCID then UCE; its UCE solves against float64) and the
   same call again from its summary, (e) ``workflows validate --f32``
   against self-goldens and a perturbed UNet that must fail; per run the
   launches of every kernel and route, seconds, images per second at 512
   px and peak memory;
7d. the certification path on the same folder (``cert_path``): (a0)
   ``workflows validate --f32`` with both norm knobs at 1 against the
   folder's f32 goldens made with the stock norms, and the bf16 load's
   outputs against them read per output, (a) ``workflows certify_levers``
   (2 concepts, 50 Stage-1 steps, both norm knobs at 1: the noise floor
   and the exact sides at 512 px, the train_res lever at 384 px; the
   JSON's rows, every RESTORE's recipe printed, the compound row's rule,
   ``guard_bands`` pointer and provisional KEEP; K2/K3 on ``mma`` only,
   K1, K4, K5b and K6b launched; seconds per Stage-1 run at 384 and at
   512 px), (b) the deviation-guard harness at its own regime on the tiny
   pipeline on the card (a null band from ``NULL_RNGS[:2]``; the
   cfg_interval lever inside it; z*1 through the control's seam giving
   the base rows and z*0.5 moving a metric past the absolute floor;
   whether the ``z_scaled_half`` control falls outside the band is
   reported), (c) the visual examples, all five modes at 512 px (2
   samples, 10 steps; the grids' sizes, post differing from pre, the base
   components bitwise unchanged after each mode, the UCE solves against
   float64);
7e. the single-process device mesh (``mesh_path``) on the same folder:
   every card when there are two or more, else four entries on ``cuda:0``
   (a check of the sharded code, no speed figure); sharded against
   unsharded (a) 6 prompts at 512 px padded to 8: ``sample_latents`` in
   exact f32 (images in [0, 1] within 1e-3) and ``generate`` in bf16
   (the gap; the tensor-core routes), (b) Stage 1 of 3 concepts (padded
   to 4) at 384 px in exact f32 (z within 1e-4), (c) the covariance of 2000 captions in f32 (1e-6) and a Stage-2
   solve on it against float64; per run its seconds and launches beside
   its unsharded twin's;
7f. the multi-process ``dcn`` mesh (``dcn_path``) on the same folder:
   ranks started with ``python -m torch.distributed.run``, one per card
   over NCCL with two or more cards, else two sharing ``cuda:0`` over gloo
   (the setup row names the layout and backend, and which gloo
   collectives take CUDA tensors; on one card the collective helper also
   runs once under NCCL in a group of one); against one-process twins
   (a) ``apply_emcid`` with the main path's 4 concepts x 3 prompts, 5
   Stage-1 steps, at 384 px in exact f32 (z 1e-4, the layer-10 covariance
   1e-6, each rank's Stage-2 solves 1e-3 of float64, z, covariance and
   edited fc2 weights bit for bit the same in every rank), (b) 6 prompts
   at 512 px, PNDM-10 (f32 images 1e-3; bf16 gap reported), (c)
   ``run_emcid`` in bf16 with both knobs at 1 under the group (only rank 0
   writes; z within 5e-2 of the CLI path's); per run every
   rank's seconds, peak memory and launches per kernel and route;
8. SDXL at full width (CLIP-L, OpenCLIP bigG, the 2.6B text_time UNet and
   the SDXL VAE, 3.47B parameters, random bf16 weights from seed 0) at
   1024 px: the UNet with attention through the kernels against the plain
   path, in bf16 (eps and the gradients into the context and
   ``text_embeds``) and in f32 with both norm knobs at 1 (K5b's ``stream``
   route on 163,840-element spans); then ``sdxl_path``: the CLI's SDXL leg
   (``--random-init``, 2 concepts x 3 prompts, 10 Stage-1 steps, CLIP-L
   layers 7-10 and bigG layers 27-30, DDIM-10 training images, 1 val
   prompt before and after), with the launches of every kernel and route,
   the phase seconds, Stage-1 seconds per step and TFLOP/s
   (``emcid_torch.profiling``), peak memory and checks (finite z and
   deltas, only each encoder's edit-layer fc2 weights changed, the UNet and
   VAE unchanged, both encoders' Stage-2 solves against float64, 1024x1024
   uint8 images, K1 ``mma`` and ``d512`` and K2-K4 ``mma`` taken, no
   ``fma``); one Stage-1 step under ``torch.profiler`` (busy, idle share,
   the hand-written kernels' share, the top device ops); and the same CLI
   call again, which must read the two-file z cache, generate no training
   image and launch no K2 or K3.

Then the kernel table line (launches from the CLI path, from the
evaluation path's mend run, from the SDXL path, from the UNet edit
path's runs (a) and (c), from the preservation path's COCO run
(``preservation_launches``) and TIMED run (``refact_launches``), and from
the trace path's sweep (``trace_launches``) and finetuning run
(``finetune_launches``), from the certification path's ``certify_levers``
run (``cert_launches``) and its visual examples (``visual_launches``),
from the mesh path's sharded runs (``mesh_launches``) and from the dcn
path's runs summed over its ranks (``dcn_launches``)), the card's name
and power limit, and, last, the device line the harness reads.
Exits non-zero, and prints no result, when there is no CUDA device, when
the port cannot be imported, or when any phase fails.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# NVIDIA H100 SXM data-sheet peaks (dense): the bound of a kernel is the
# largest of its bytes over the memory rate, its flops over the rate of its
# input type and, for the attention kernels, its exponentials over the
# SFU's rate (16 per clock per SM, at the card's SM count and maximum SM
# clock, read in this run).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
EXP_PER_CLOCK_PER_SM = 16

SOURCES = {
    "K1 flash_v2_fwd": ("emcid_torch/csrc/flash_v2.cu",
                        "emcid_tpu/ops/flash_v2.py:104"),
    "K2 flash_v2_dq": ("emcid_torch/csrc/flash_v2.cu",
                       "emcid_tpu/ops/flash_v2.py:200"),
    "K3 flash_v2_dkv": ("emcid_torch/csrc/flash_v2.cu",
                        "emcid_tpu/ops/flash_v2.py:232"),
    "K4 short_kv_fwd": ("emcid_torch/csrc/short_kv.cu",
                        "emcid_tpu/ops/attention.py:82"),
    "K5f groupnorm_fwd": ("emcid_torch/csrc/groupnorm.cu",
                          "emcid_tpu/ops/groupnorm.py:119"),
    "K5b groupnorm_bwd": ("emcid_torch/csrc/groupnorm.cu",
                          "emcid_tpu/ops/groupnorm.py:203"),
    "K6f layernorm_fwd": ("emcid_torch/csrc/layernorm.cu",
                          "emcid_tpu/ops/layernorm.py:67"),
    "K6b layernorm_bwd": ("emcid_torch/csrc/layernorm.cu",
                          "emcid_tpu/ops/layernorm.py:78"),
}
ATTENTION = ("K1 flash_v2_fwd", "K2 flash_v2_dq", "K3 flash_v2_dkv",
             "K4 short_kv_fwd")
NORMS = ("K5f groupnorm_fwd", "K5b groupnorm_bwd", "K6f layernorm_fwd",
         "K6b layernorm_bwd")
KNOBS = ("EMCID_TPU_FUSED_GN", "EMCID_TPU_FUSED_LN")
# the routes a bf16 run of the SD-v1.4 paths must take: K1 on the tensor
# cores at the UNet's heads (mma) and the VAE's (d512), K2, K3 and K4 on the
# tensor cores, and no float-FMA route of any of them
BF16_ROUTES = {"K1 flash_v2_fwd": ("mma", "d512"), "K2 flash_v2_dq": ("mma",),
               "K3 flash_v2_dkv": ("mma",), "K4 short_kv_fwd": ("mma",)}
# the norm backwards' routes; with both knobs on, a bf16 run at 384/512 px
# must take K5b's shared-memory-resident route and K6b's register rows
NORM_ROUTES = {"K5b groupnorm_bwd": ("resident", "stream"),
               "K6b layernorm_bwd": ("rows", "generic")}


def routes_ok(routes, expect=BF16_ROUTES) -> bool:
    return all(routes[k][r] > 0 for k, rs in expect.items() for r in rs) \
        and all(routes[k]["fma"] == 0 for k in BF16_ROUTES)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


@contextlib.contextmanager
def environ(**values):
    """Set (a string) or unset (None) environment variables inside the
    scope; restore them after."""
    prev = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def exp_rate() -> float:
    """Exponentials per second of the card: SMs x 16 x the maximum SM
    clock (``nvidia-smi --query-gpu=clocks.max.sm``)."""
    import torch

    if not hasattr(exp_rate, "value"):
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            timeout=60)
        mhz = float(out.stdout.strip().splitlines()[0])
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        exp_rate.value = sms * EXP_PER_CLOCK_PER_SM * mhz * 1e6
        exp_rate.parts = dict(sms=sms, max_sm_clock_mhz=mhz)
    return exp_rate.value


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` runs (CUDA events).  A
    sleep kernel (~50 ms) holds the card while the host enqueues the runs,
    so the host's per-call cost, which for a Python wrapper can exceed a
    small kernel's own time, does not count as gaps between them."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float, dtype, exps: float = 0.0) -> tuple:
    """(least ms, what bounds it): "operations", "bytes" or
    "exponentials"."""
    t = {"operations": flops / PEAK_FLOPS[str(dtype)],
         "bytes": nbytes / PEAK_BYTES_PER_S}
    if exps:
        t["exponentials"] = exps / exp_rate()
    by = max(t, key=t.get)
    return t[by] * 1e3, by


def rel_err(got, ref) -> tuple:
    """max |got - ref| and that over max |ref|, in float64 (tensors or
    arrays)."""
    import torch

    got = torch.as_tensor(got).double()
    ref = torch.as_tensor(ref, device=got.device).double()
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    return err, err / max(scale, 1e-30)


def qkv(B, N, M, H, D, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda L: torch.randn(B, L, H, D, generator=g, device="cuda",
                               dtype=torch.float32).to(dtype)
    return mk(N), mk(M), mk(M)


# tolerances, relative to the largest reference magnitude: bf16 outputs are
# rounded to 8 mantissa bits (2^-9 relative) after f32 accumulation in both
# versions, which sum in different orders; f32 differs only by order
TOL = {"torch.bfloat16": 1e-2, "torch.float32": 1e-4}


def product_shape(N, dtype) -> bool:
    """Timed rows: bf16 at the main path's sequence lengths (the small
    shapes check the ragged edges only)."""
    import torch

    return dtype == torch.bfloat16 and N >= 1024


def norm_timed(dtype) -> bool:
    """Timed norm rows: every bf16 shape (the generation batch and the
    Stage-1 backward's shapes); the f32 shapes check edges only."""
    import torch

    return dtype == torch.bfloat16


@contextlib.contextmanager
def forced_route(module, picker: str, route: str):
    """Make a norm backward's wrapper take ``route`` inside the scope (to
    time the route its picker did not choose on the same inputs)."""
    real = getattr(module, picker)
    setattr(module, picker, lambda *args: route)
    try:
        yield
    finally:
        setattr(module, picker, real)


def route_yardsticks(torch, row, module, picker, other, fn, x, gy):
    """Beside a timed norm backward: the time of its other route on the same
    inputs (``other``, the general route, which takes every shape; None
    where the general route was taken), and of ``torch.add(x, g)``, which
    moves the same bytes (x and g read once, one tensor of x's size
    written) and so shows what this card reaches on that traffic."""
    if other is not None:
        with forced_route(module, picker, other):
            row["other_route"], row["other_route_ms"] = other, cuda_ms(fn, 20)
    out = torch.empty_like(x)
    row["same_bytes_add_ms"] = cuda_ms(lambda: torch.add(x, gy, out=out), 20)


def same_bits(torch, name, first, again, shape, failures) -> bool:
    """Two calls on the same inputs must give the same bits."""
    ok = all(torch.equal(a, b) for a, b in zip(first, again))
    if not ok:
        failures.append(f"{name} at {shape}: two calls differ")
    return ok


def check(name, got, ref, dtype, shape, failures):
    err, rel = rel_err(got, ref)
    ok = rel <= TOL[str(dtype)]
    if not ok:
        failures.append(f"{name} at {shape} {dtype}: rel err {rel:.3g}")
    return err, rel, ok


def phase_flash_fwd(torch, shapes, failures):
    from emcid_torch.ops import flash_v2 as fv2
    import torch.nn.functional as F

    rows = []
    for (B, N, H, D), dtype in shapes:
        q, k, v = qkv(B, N, N, H, D, dtype, seed=1)
        s = D ** -0.5
        o, lse = fv2.flash_fwd(q, k, v, s)
        route = fv2.fwd_route(q, k, v, o)
        o_ref, lse_ref = fv2.flash_fwd_plain(q, k, v, s)
        err, rel, ok = check("K1", o, o_ref, dtype, (B, N, H, D), failures)
        lse_err, lse_rel, lse_ok = check("K1 lse", lse, lse_ref,
                                         torch.float32 if dtype == torch.float32
                                         else dtype, (B, N, H, D), failures)
        row = dict(phase="kernel", kernel="K1 flash_v2_fwd", route=route,
                   shape=[B, N, H, D], dtype=str(dtype), max_abs_err=err,
                   rel_err=rel, lse_rel_err=lse_rel,
                   tolerance=TOL[str(dtype)], ok=ok and lse_ok)
        if product_shape(N, dtype):
            elem = q.element_size()
            flops = 4.0 * B * H * N * N * D
            nbytes = 4.0 * B * N * H * D * elem + B * H * N * 4
            row["bound_ms"], row["bound_by"] = bound(
                flops, nbytes, dtype, exps=float(B) * H * N * N)
            row["kernel_ms"] = cuda_ms(lambda: fv2.flash_fwd(q, k, v, s), 5)
            row["plain_ms"] = cuda_ms(lambda: fv2.flash_fwd_plain(q, k, v, s), 2, 1)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            row["library_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=s), 5)
        emit(row)
        rows.append(row)
        del q, k, v, o, o_ref, lse, lse_ref
        torch.cuda.empty_cache()
    return rows


def phase_flash_bwd(torch, shapes, failures):
    """K2/K3 at (B, N, H, D) with N = M.  Every shape here is bf16 at a
    head dim of the ``mma`` route or f32, so each must take ``mma`` (bf16)
    or ``fma`` (f32)."""
    from emcid_torch.ops import flash_v2 as fv2
    import torch.nn.functional as F

    rows = []
    for (B, N, H, D), dtype in shapes:
        q, k, v = qkv(B, N, N, H, D, dtype, seed=2)
        g = torch.Generator(device="cuda").manual_seed(3)
        dout = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
        s = D ** -0.5
        o, lse = fv2.flash_fwd(q, k, v, s)
        delta = fv2.row_delta(o, dout)
        dq = fv2.flash_dq(q, k, v, dout, lse, delta, s)
        dk, dv = fv2.flash_dkv(q, k, v, dout, lse, delta, s)
        routes = (fv2.bwd_route(q, k, v, dout, dq),
                  fv2.bwd_route(q, k, v, dout, dk, dv))
        expect = "mma" if dtype == torch.bfloat16 else "fma"
        if routes != (expect, expect):
            failures.append(f"K2/K3 at {(B, N, H, D)} {dtype}: routes "
                            f"{routes}, expected {expect}")
        dq_ref = fv2.flash_dq_plain(q, k, v, dout, lse, delta, s)
        dk_ref, dv_ref = fv2.flash_dkv_plain(q, k, v, dout, lse, delta, s)
        # through the autograd.Function against plain autograd of the
        # einsum/softmax attention, in f32 from the same inputs
        qa, ka, va = (t.detach().clone().requires_grad_() for t in (q, k, v))
        fv2.flash_attention_v2(qa, ka, va, s).backward(dout)
        qr, kr, vr = (t.detach().float().requires_grad_() for t in (q, k, v))
        p = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", qr, kr) * s, -1)
        torch.einsum("bhnm,bmhd->bnhd", p, vr).backward(dout.float())
        del p
        shape = (B, N, H, D)
        res = {}
        for label, got, ref in (("dq", dq, dq_ref), ("dk", dk, dk_ref),
                                ("dv", dv, dv_ref),
                                ("autograd_dq", qa.grad, qr.grad),
                                ("autograd_dk", ka.grad, kr.grad),
                                ("autograd_dv", va.grad, vr.grad)):
            res[label] = check(label, got, ref, dtype, shape, failures)
        common = dict(phase="kernel", shape=[B, N, H, D], dtype=str(dtype),
                      tolerance=TOL[str(dtype)])
        k2 = dict(common, kernel="K2 flash_v2_dq", route=routes[0],
                  max_abs_err=res["dq"][0],
                  rel_err=res["dq"][1], autograd_rel_err=res["autograd_dq"][1],
                  ok=res["dq"][2] and res["autograd_dq"][2])
        k3 = dict(common, kernel="K3 flash_v2_dkv", route=routes[1],
                  max_abs_err=max(res["dk"][0], res["dv"][0]),
                  rel_err=max(res["dk"][1], res["dv"][1]),
                  autograd_rel_err=max(res["autograd_dk"][1],
                                       res["autograd_dv"][1]),
                  ok=all(res[x][2] for x in ("dk", "dv", "autograd_dk",
                                             "autograd_dv")))
        if product_shape(N, dtype):
            elem = q.element_size()
            nm = float(B) * H * N * N * D
            row_b = 2.0 * B * H * N * 4  # lse, delta
            # both recompute P: one exponential per score
            k2["bound_ms"], k2["bound_by"] = bound(
                6 * nm, 5.0 * B * N * H * D * elem + row_b, dtype,
                exps=nm / D)
            k3["bound_ms"], k3["bound_by"] = bound(
                8 * nm, 6.0 * B * N * H * D * elem + row_b, dtype,
                exps=nm / D)
            k2["kernel_ms"] = cuda_ms(
                lambda: fv2.flash_dq(q, k, v, dout, lse, delta, s), 5)
            k3["kernel_ms"] = cuda_ms(
                lambda: fv2.flash_dkv(q, k, v, dout, lse, delta, s), 5)
            k2["plain_ms"] = cuda_ms(
                lambda: fv2.flash_dq_plain(q, k, v, dout, lse, delta, s), 2, 1)
            k3["plain_ms"] = cuda_ms(
                lambda: fv2.flash_dkv_plain(q, k, v, dout, lse, delta, s), 2, 1)
            # library yardstick: one backward of SDPA (dq, dk and dv together)
            qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                          for t in (q, k, v))
            ot = F.scaled_dot_product_attention(qt, kt, vt, scale=s)
            gt = dout.transpose(1, 2).contiguous()
            lib = cuda_ms(lambda: torch.autograd.grad(
                ot, (qt, kt, vt), gt, retain_graph=True), 5)
            k2["library_ms"] = k3["library_ms"] = lib
            k2["library_note"] = k3["library_note"] = "SDPA backward (dq, dk, dv)"
            k3["k2_plus_k3_over_library"] = (
                k2["kernel_ms"] + k3["kernel_ms"]) / lib
        emit(k2)
        emit(k3)
        rows += [k2, k3]
        torch.cuda.empty_cache()
    return rows


def phase_short_kv(torch, shapes, failures):
    from emcid_torch.ops import attention as att
    import torch.nn.functional as F

    rows = []
    for (B, N, M, H, D), dtype in shapes:
        q, k, v = qkv(B, N, M, H, D, dtype, seed=4)
        s = D ** -0.5
        o = att.short_kv_fwd(q, k, v, s)
        route = att.short_kv_route(q, k, v, o)
        ref = att.short_kv_fwd_plain(q, k, v, s)
        err, rel, ok = check("K4", o, ref, dtype, (B, N, M, H, D), failures)
        row = dict(phase="kernel", kernel="K4 short_kv_fwd", route=route,
                   shape=[B, N, M, H, D], dtype=str(dtype), max_abs_err=err,
                   rel_err=rel, tolerance=TOL[str(dtype)], ok=ok)
        if product_shape(N, dtype):
            elem = q.element_size()
            row["bound_ms"], row["bound_by"] = bound(
                4.0 * B * H * N * M * D,
                (2.0 * B * N + 2.0 * B * M) * H * D * elem, dtype,
                exps=float(B) * H * N * M)
            row["kernel_ms"] = cuda_ms(lambda: att.short_kv_fwd(q, k, v, s), 10)
            row["plain_ms"] = cuda_ms(
                lambda: att.short_kv_fwd_plain(q, k, v, s), 5)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            row["library_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=s), 10)
        emit(row)
        rows.append(row)
    return rows


def norm_inputs(torch, shape, C, dtype, seed):
    """x and its cotangent (shape), and scale/bias (C,), all in ``dtype``
    (the UNet's parameters share its activations' type)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda")
    return ((rnd(*shape) * 2.0 + 0.5).to(dtype), rnd(*shape).to(dtype),
            (1.0 + 0.3 * rnd(C)).to(dtype), (0.2 * rnd(C)).to(dtype))


def norm_checks(torch, name, pairs, dtype, shape, failures):
    """Check (label, got, ref, tolerance dtype) pairs; returns the worst
    absolute and relative error and whether every pair held."""
    errs = [check(f"{name} {label}", got, ref, tol_dtype, shape, failures)
            for label, got, ref, tol_dtype in pairs]
    return (max(e[0] for e in errs), max(e[1] for e in errs),
            all(e[2] for e in errs))


def autograd_pairs(torch, fused, plain, x, gy, sc, bi):
    """(label, got, ref) of the fused autograd.Function against autograd of
    the plain math in f32, from the same inputs: y, dx, dscale, dbias."""
    xa, sa, ba = (t.detach().clone().requires_grad_() for t in (x, sc, bi))
    ya = fused(xa, sa, ba)
    ya.backward(gy)
    xr, sr, br = (t.detach().float().requires_grad_() for t in (x, sc, bi))
    yr = plain(xr, sr, br)
    yr.backward(gy.float())
    return [("autograd_y", ya, yr), ("autograd_dx", xa.grad, xr.grad),
            ("autograd_dscale", sa.grad, sr.grad),
            ("autograd_dbias", ba.grad, br.grad)]


def phase_groupnorm(torch, shapes, failures):
    """K5f/K5b on (B, C, S) activations, G groups."""
    from emcid_torch.ops import groupnorm as gn
    import torch.nn.functional as F

    f32 = torch.float32
    rows = []
    for (B, S, C, G, eps), dtype, expect in shapes:
        for act in ("silu", "none"):
            x, gy, sc, bi = norm_inputs(torch, (B, C, S), C, dtype, seed=7)
            y, st = gn.gn_fwd(x, sc, bi, G, eps, act)
            y_ref, st_ref = gn.gn_fwd_plain(x, sc, bi, G, eps, act)
            dx, dsc, dbi = gn.gn_bwd(x, gy, sc, bi, st, G, act)
            route = gn.gn_bwd_route(x, G, gy)
            if route != expect:
                failures.append(f"K5b at {[B, S, C]} {dtype}: route {route}, "
                                f"expected {expect}")
            same = same_bits(torch, "K5b", (dx, dsc, dbi),
                             gn.gn_bwd(x, gy, sc, bi, st, G, act), [B, S, C],
                             failures)
            dx_ref, dsc_ref, dbi_ref = gn.gn_bwd_plain(x, gy, sc, bi, st_ref,
                                                       G, act)
            auto = autograd_pairs(
                torch, lambda x, s, b: gn.gn_act(x, s, b, G, eps, act),
                lambda x, s, b: gn.gn_act_plain(x, s, b, num_groups=G,
                                                eps=eps, act=act),
                x, gy, sc, bi)
            shape = [B, S, C]
            common = dict(phase="kernel", shape=shape, groups=G, eps=eps,
                          act=act, dtype=str(dtype),
                          tolerance=TOL[str(dtype)])
            fe, frel, fok = norm_checks(
                torch, "K5f", [("y", y, y_ref, dtype),
                               ("stats", st, st_ref, f32)]
                + [(l, a, r, dtype) for l, a, r in auto[:1]],
                dtype, shape, failures)
            # dscale/dbias come out in the parameters' type (bf16 here
            # for bf16 activations), so they are held at its tolerance
            be, brel, bok = norm_checks(
                torch, "K5b", [("dx", dx, dx_ref, dtype),
                               ("dscale", dsc, dsc_ref, sc.dtype),
                               ("dbias", dbi, dbi_ref, bi.dtype)]
                + [(l, a, r, dtype) for l, a, r in auto[1:]],
                dtype, shape, failures)
            k5f = dict(common, kernel="K5f groupnorm_fwd", max_abs_err=fe,
                       rel_err=frel, ok=fok)
            k5b = dict(common, kernel="K5b groupnorm_bwd", route=route,
                       max_abs_err=be, rel_err=brel, same_bits=same,
                       ok=bok and same and route == expect)
            if act == "none" and dtype == f32:
                # ROADMAP F2: each group's dx sums to 0 in exact arithmetic
                d = dx.double().reshape(B, G, -1)
                f2 = (d.sum(-1).abs() / d.abs().sum(-1)).max().item()
                k5b.update(f2_group_sum_rel=f2, f2_tolerance=1e-4)
                if f2 >= 1e-4:
                    k5b["ok"] = False
                    failures.append(f"K5b F2 group sum {f2:.3g} at {shape}")
            if norm_timed(dtype):
                elem, n = x.element_size(), x.numel()
                params = 2 * C * sc.element_size() + B * 2 * G * 4
                flops = (9.0 if act == "silu" else 5.0) * n
                k5f["bound_ms"], k5f["bound_by"] = bound(
                    flops, 2.0 * n * elem + params, f32)
                k5b["bound_ms"], k5b["bound_by"] = bound(
                    2 * flops, 3.0 * n * elem + 2 * params, f32)
                k5f["kernel_ms"] = cuda_ms(
                    lambda: gn.gn_fwd(x, sc, bi, G, eps, act), 20)
                k5b["kernel_ms"] = cuda_ms(
                    lambda: gn.gn_bwd(x, gy, sc, bi, st, G, act), 20)
                route_yardsticks(
                    torch, k5b, gn, "gn_bwd_route",
                    "stream" if route == "resident" else None,
                    lambda: gn.gn_bwd(x, gy, sc, bi, st, G, act), x, gy)
                k5f["plain_ms"] = cuda_ms(
                    lambda: gn.gn_fwd_plain(x, sc, bi, G, eps, act), 5)
                k5b["plain_ms"] = cuda_ms(
                    lambda: gn.gn_bwd_plain(x, gy, sc, bi, st, G, act), 5)

                def lib_fwd(x, s, b):
                    h = F.group_norm(x, G, s, b, eps)
                    return F.silu(h) if act == "silu" else h

                k5f["library_ms"] = cuda_ms(lambda: lib_fwd(x, sc, bi), 20)
                xl, sl, bl = (t.detach().clone().requires_grad_()
                              for t in (x, sc, bi))
                yl = lib_fwd(xl, sl, bl)
                k5b["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
                    yl, (xl, sl, bl), gy, retain_graph=True), 20)
                k5f["library_note"] = ("F.group_norm" + (" then F.silu (two "
                                       "calls)" if act == "silu" else ""))
                k5b["library_note"] = "autograd backward of the same calls"
            emit(k5f)
            emit(k5b)
            rows += [k5f, k5b]
    torch.cuda.empty_cache()
    return rows


def phase_layernorm(torch, shapes, failures):
    """K6f/K6b on (B, N, C) token rows."""
    from emcid_torch.ops import layernorm as ln
    import torch.nn.functional as F

    f32 = torch.float32
    rows = []
    eps = 1e-5
    for (B, N, C), dtype, expect in shapes:
        for act in ("none", "silu"):
            x, gy, sc, bi = norm_inputs(torch, (B, N, C), C, dtype, seed=8)
            y = ln.ln_fwd(x, sc, bi, eps, act)
            y_ref = ln.ln_act_plain(x, sc, bi, eps=eps, act=act)
            dx, dsc, dbi = ln.ln_bwd(x, gy, sc, bi, eps, act)
            route = ln.ln_bwd_route(x, gy)
            if route != expect:
                failures.append(f"K6b at {[B, N, C]} {dtype}: route {route}, "
                                f"expected {expect}")
            same = same_bits(torch, "K6b", (dx, dsc, dbi),
                             ln.ln_bwd(x, gy, sc, bi, eps, act), [B, N, C],
                             failures)
            dx_ref, dsc_ref, dbi_ref = ln.ln_bwd_plain(x, gy, sc, bi, eps, act)
            auto = autograd_pairs(
                torch, lambda x, s, b: ln.layer_norm_act(x, s, b, eps=eps,
                                                         act=act),
                lambda x, s, b: ln.ln_act_plain(x, s, b, eps=eps, act=act),
                x, gy, sc, bi)
            shape = [B, N, C]
            common = dict(phase="kernel", shape=shape, eps=eps, act=act,
                          dtype=str(dtype), tolerance=TOL[str(dtype)])
            fe, frel, fok = norm_checks(
                torch, "K6f", [("y", y, y_ref, dtype)]
                + [(l, a, r, dtype) for l, a, r in auto[:1]],
                dtype, shape, failures)
            be, brel, bok = norm_checks(
                torch, "K6b", [("dx", dx, dx_ref, dtype),
                               ("dscale", dsc, dsc_ref, sc.dtype),
                               ("dbias", dbi, dbi_ref, bi.dtype)]
                + [(l, a, r, dtype) for l, a, r in auto[1:]],
                dtype, shape, failures)
            k6f = dict(common, kernel="K6f layernorm_fwd", max_abs_err=fe,
                       rel_err=frel, ok=fok)
            k6b = dict(common, kernel="K6b layernorm_bwd", route=route,
                       max_abs_err=be, rel_err=brel, same_bits=same,
                       ok=bok and same and route == expect)
            if norm_timed(dtype):
                elem, n = x.element_size(), x.numel()
                params = 2 * C * sc.element_size()
                flops = (9.0 if act == "silu" else 5.0) * n
                k6f["bound_ms"], k6f["bound_by"] = bound(
                    flops, 2.0 * n * elem + params, f32)
                k6b["bound_ms"], k6b["bound_by"] = bound(
                    2 * flops, 3.0 * n * elem + 2 * params, f32)
                k6f["kernel_ms"] = cuda_ms(
                    lambda: ln.ln_fwd(x, sc, bi, eps, act), 20)
                k6b["kernel_ms"] = cuda_ms(
                    lambda: ln.ln_bwd(x, gy, sc, bi, eps, act), 20)
                route_yardsticks(
                    torch, k6b, ln, "ln_bwd_route",
                    "generic" if route == "rows" else None,
                    lambda: ln.ln_bwd(x, gy, sc, bi, eps, act), x, gy)
                k6f["plain_ms"] = cuda_ms(
                    lambda: ln.ln_act_plain(x, sc, bi, eps=eps, act=act), 5)
                k6b["plain_ms"] = cuda_ms(
                    lambda: ln.ln_bwd_plain(x, gy, sc, bi, eps, act), 5)

                def lib_fwd(x, s, b):
                    h = F.layer_norm(x, (C,), s, b, eps)
                    return F.silu(h) if act == "silu" else h

                k6f["library_ms"] = cuda_ms(lambda: lib_fwd(x, sc, bi), 20)
                xl, sl, bl = (t.detach().clone().requires_grad_()
                              for t in (x, sc, bi))
                yl = lib_fwd(xl, sl, bl)
                k6b["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
                    yl, (xl, sl, bl), gy, retain_graph=True), 20)
                k6f["library_note"] = ("F.layer_norm" + (" then F.silu (two "
                                       "calls)" if act == "silu" else ""))
                k6b["library_note"] = "autograd backward of the same calls"
            emit(k6f)
            emit(k6b)
            rows += [k6f, k6b]
    torch.cuda.empty_cache()
    return rows


def kernel_phases(torch, failures):
    bf, f32 = torch.bfloat16, torch.float32
    rows = []
    # K1: ragged f32 (fma route) and bf16 (mma, d512) shapes; the level-0
    # Stage-1/training shape; the VAE mid-block at the main path's batch
    # (4 concepts x 3 prompts) and at 512 px (the CLI's renders); 512-px
    # levels 0 and 1
    rows += phase_flash_fwd(torch, [
        ((2, 300, 2, 40), f32), ((2, 300, 2, 80), f32),
        ((1, 300, 1, 512), f32), ((2, 300, 2, 40), bf), ((2, 300, 2, 80), bf),
        ((1, 300, 1, 512), bf),
        ((24, 2304, 8, 40), bf), ((12, 2304, 1, 512), bf),
        ((4, 2304, 1, 512), bf), ((2, 4096, 1, 512), bf),
        ((24, 4096, 8, 40), bf), ((4, 1024, 8, 80), bf),
        # SDXL at 1024 px: the UNet's self-attention at levels 1 and 2 (head
        # dim 64) in CFG training-image generation (6 images), the VAE
        # mid-block over 128x128 tokens (decode and re-encode of 6 images)
        ((12, 4096, 10, 64), bf), ((12, 1024, 20, 64), bf),
        ((6, 16384, 1, 512), bf)], failures)
    # K2/K3: ragged f32 (fma route) and bf16 (mma; N = M = 300 is not a
    # multiple of 64) shapes; the level-0 Stage-1 shape; the 512-px Stage-1
    # levels 0 and 1 (EMCID_TPU_TRAIN_RES=0)
    rows += phase_flash_bwd(torch, [((2, 300, 2, 40), f32),
                                    ((2, 300, 2, 80), f32),
                                    ((2, 300, 2, 40), bf), ((2, 300, 2, 80), bf),
                                    ((12, 2304, 8, 40), bf),
                                    ((12, 4096, 8, 40), bf),
                                    ((12, 1024, 8, 80), bf),
                                    # SDXL Stage 1: one concept's 3 prompts
                                    # at levels 1 and 2 (head dim 64)
                                    ((3, 4096, 10, 64), bf),
                                    ((3, 1024, 20, 64), bf)], failures)
    # K4: ragged f32 (fma) and bf16 (mma; M = 200 takes three key chunks
    # and the online rescale); the level-0 cross-attention; 512 px levels 0
    # and 1
    rows += phase_short_kv(torch, [
        ((2, 300, 77, 2, 40), f32), ((2, 300, 77, 2, 40), bf),
        ((2, 300, 200, 2, 40), bf), ((24, 2304, 77, 8, 40), bf),
        ((4, 4096, 77, 8, 40), bf), ((4, 1024, 77, 8, 80), bf),
        # SDXL: levels 1 and 2 over the 77-token context (CFG generation)
        ((12, 4096, 77, 10, 64), bf), ((12, 1024, 77, 20, 64), bf)],
        failures)
    # (B, S, C, G, eps), dtype, K5b's route: the level-0 resnet norm of
    # training-image generation (CFG batch 24); the Stage-1 backward's
    # level-0 norms over 320 and 640 channels and the up-path concat over
    # 960 (batch 12, 384 px); the 512-px level-0 norm of the CLI's renders;
    # the mid-block Transformer2D norm; then f32: ragged shapes and the
    # model check's 320- and 640-channel spans (F2 on both routes)
    rows += phase_groupnorm(torch, [
        ((24, 2304, 320, 32, 1e-5), bf, "resident"),
        ((12, 2304, 320, 32, 1e-5), bf, "resident"),
        ((12, 2304, 640, 32, 1e-5), bf, "resident"),
        ((12, 2304, 960, 32, 1e-5), bf, "stream"),
        ((4, 4096, 320, 32, 1e-5), bf, "resident"),
        ((12, 36, 2560, 32, 1e-6), bf, "resident"),
        ((2, 300, 64, 32, 1e-5), f32, "resident"),
        ((2, 7, 96, 32, 1e-6), f32, "stream"),
        ((2, 2304, 320, 32, 1e-5), f32, "resident"),
        ((2, 2304, 640, 32, 1e-5), f32, "stream")], failures)
    # (B, N, C), dtype, K6b's route: the level-0 transformer of generation;
    # the Stage-1 backward's levels 0 and 1; level 2; then f32 edges (C =
    # 1280 in f32 takes the generic route)
    rows += phase_layernorm(torch, [
        ((24, 2304, 320), bf, "rows"), ((12, 2304, 320), bf, "rows"),
        ((12, 576, 640), bf, "rows"), ((12, 144, 1280), bf, "rows"),
        ((2, 77, 64), f32, "rows"), ((2, 77, 1280), f32, "generic"),
        ((3, 5, 3000), f32, "generic")], failures)
    return rows


def bench_hparams(grad_steps: int):
    """The product hparams the JAX package's bench times (bench.py)."""
    from emcid_torch.hparams import EMCIDHyperParams

    return EMCIDHyperParams.from_dict({
        "layers": [7, 8, 9, 10], "clamp_norm_factor": 1.5,
        "layer_selection": "all", "fact_token": "subject_last",
        "v_num_grad_steps": grad_steps, "v_lr": 0.2,
        "v_weight_decay": 5e-4, "mom2_adjustment": True,
        "mom2_update_weight": 4000,
        "rewrite_module_tmp": "text_model.encoder.layers.{}.mlp.fc2",
        "layer_module_tmp": "text_model.encoder.layers.{}",
        "mlp_module_tmp": "text_model.encoder.layers.{}.mlp",
        "attn_module_tmp": "text_model.encoder.layers.{}.self_attn",
        "ln_f_module": "text_model.final_layer_norm",
        "mom2_dataset": "ccs_filtered", "mom2_n_samples": 100000,
        "mom2_dtype": "float32", "objective": "ablate-dest",
        "esd_mu": "None", "cal_text_repr_loss": True,
        "text_repr_loss_scale_factor": 0.01,
    })


REQUESTS = [{"prompts": ["a photo of a {}", "an image of a {}", "{}"],
             "source": f"w{i}", "dest": f"w{i + 1}", "seed_train": i}
            for i in range(4)]


def main_path(torch, stats_dir, failures):
    """apply_emcid on the full-width SD-v1.4 pipeline with the norm knobs
    off (stock norms): 4 concepts in one block, 50 Stage-1 steps (cosine
    schedule: 30 run; the K=25 eps_dest pool engages), DPM++ training
    images at 10 steps (CFG interval 0.6) at 384 px, covariances over the
    2000-caption synthetic corpus, cached in ``stats_dir``."""
    import numpy as np

    from emcid_torch.engine.editor import apply_emcid
    from emcid_torch.engine.emcid import execute_emcid_text_encoder, load_z_list
    from emcid_torch.models.loader import build_random_pipeline
    from emcid_torch.ops import _build

    t0 = time.time()
    comps = build_random_pipeline("sd-v1.4", dtype=torch.bfloat16, seed=0,
                                  device="cuda")
    torch.cuda.synchronize()
    build_s = time.time() - t0
    hp = bench_hparams(50)
    requests = REQUESTS
    with environ(**dict.fromkeys(KNOBS)), \
            tempfile.TemporaryDirectory() as tmp:
        cache_name = os.path.join(tmp, "z", "")
        timings = {}
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.time()
        edited, deltas = apply_emcid(
            comps, requests, hp, stats_dir=stats_dir, cache_name=cache_name,
            num_inference_steps=10, timings=timings, verbose=False)
        torch.cuda.synchronize()
        total_s = time.time() - t0
        launches = dict(_build.LAUNCHES)
        routes = copy.deepcopy(_build.ROUTES)
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        z_list, missing = load_z_list(requests, cache_name, hp)
    zs = np.stack(z_list)
    # reference on the same inputs: Stage 2 on the card (f32 Cholesky +
    # refinement) against the host float64 solve, with well-conditioned
    # seeded covariances (as the JAX package's bench uses); the first edited
    # layer sees identical keys in both modes, so its update differs only by
    # the solve
    g = torch.Generator(device="cuda").manual_seed(5)
    inter = comps.text_encoder.config.intermediate_size
    covs = []
    for _ in hp.layers:
        a = torch.randn(2 * inter, inter, generator=g, device="cuda")
        covs.append(a.T @ a / a.shape[0])
    stage2 = {}
    for method in ("f32_ir", "f64"):
        d, _ = execute_emcid_text_encoder(
            comps.text_encoder, comps.tokenizer, requests, hp, zs=zs,
            covs=covs, solve_method=method, verbose=False)
        stage2[method] = {k: a @ r.T for k, (a, r) in d.items()}
    rel = {k: float(np.linalg.norm(stage2["f32_ir"][k] - v)
                    / np.linalg.norm(v)) for k, v in stage2["f64"].items()}
    first = f"{hp.rewrite_module_tmp.format(hp.layers[0])}.weight"
    before = dict(comps.text_encoder.named_parameters())
    changed = sorted(k for k, v in edited.text_encoder.named_parameters()
                     if not torch.equal(v, before[k]))
    expect = sorted(f"text_model.encoder.layers.{i}.mlp.fc2.weight"
                    for i in hp.layers)
    row = dict(
        phase="main_path", model="sd-v1.4 (full width, random weights, bf16)",
        concepts=len(requests), prompts=3, grad_steps=hp.v_num_grad_steps,
        gen_steps=10, train_res=384, build_pipeline_s=build_s,
        total_s=total_s, **{f"{k}_s": v for k, v in timings.items()},
        peak_mem_gb=peak_gb, launches=launches, routes=routes,
        bf16_routes_ok=routes_ok(routes), z_shape=list(zs.shape),
        z_finite=bool(np.isfinite(zs).all() and not missing),
        deltas_finite=all(np.isfinite(a).all() and np.isfinite(r).all()
                          for a, r in deltas.values()),
        changed_params=changed, only_fc2_of_edit_layers=changed == expect,
        stage2_f32_ir_vs_f64_rel=rel, stage2_rel_tolerance=1e-3)
    row["ok"] = (row["z_finite"] and row["deltas_finite"]
                 and row["only_fc2_of_edit_layers"] and rel[first] < 1e-3
                 and all(launches[k] > 0 for k in ATTENTION)
                 and row["bf16_routes_ok"])
    emit(row)
    if not row["ok"]:
        failures.append(f"main path: {row}")
    return launches, comps


VARIANT_REQUESTS = REQUESTS[:2]
SLD_REQUEST = {"source_prompts": ["a photo of a w0 w1", "w1 artwork by w2"],
               "seeds": [1, 2], "safe_words": ["w3"] * 2, "source": "w1",
               "dest": " ", "source_cat": "w1"}
# the UCE solve (f32 Cholesky) against the host float64 solve (ROADMAP F1)
UCE_REL_TOL = 1e-3


def uce_f64_check(torch, comps, edited, requests):
    """The UCE normal equations of the run, rebuilt on the text-edited
    components: the f32 solve against numpy's float64 solve of the same
    matrices.  Returns the worst relative Frobenius difference."""
    import numpy as np

    from emcid_torch.engine.uce import _uce_solve_all, uce_normal_equations

    names, mat1, mat2 = uce_normal_equations(
        comps.replace_text_encoder(edited.text_encoder),
        [r["source"] for r in requests],
        [r.get("dest") or " " for r in requests])
    a64 = mat2.double().cpu().numpy()
    worst = 0.0
    for dim in sorted({mat1[n].shape[0] for n in names}):
        stack = torch.stack([mat1[n] for n in names
                             if mat1[n].shape[0] == dim])
        got = _uce_solve_all(mat2, stack).double().cpu().numpy()
        ref = np.linalg.solve(a64, stack.double().cpu().numpy()
                              .transpose(0, 2, 1))
        worst = max(worst, float(np.linalg.norm(got - ref)
                                 / np.linalg.norm(ref)))
    return worst


def variants_path(torch, comps, stats_dir, failures):
    """``apply_emcid``'s variant paths on the main path's bf16 pipeline,
    knobs off, with its covariance cache (``stats_dir``): (a) EWC at
    lambda 1e7 with the UCE hybrid (FIM over 4 generated pairs, written to
    the temp directory by ``resolve_fim`` and read back), (b) the esd
    objective, (c) one SLD-supervised request, (d) txt-img-align at scale 5
    with a random full-width CLIP ViT-L/14 vision tower (bf16, seed 0) and
    a random text projection, the first concept flagged.  2 concepts (one
    SLD request), 10 Stage-1 steps at the const schedule (no pool), DPM++
    training images at 10 steps and 384 px (SLD: its 20 DDIM steps at
    512 px).  Each run's kernel launches are counted alone."""
    import dataclasses

    import numpy as np

    from emcid_torch.engine.editor import apply_emcid, resolve_covariances_for
    from emcid_torch.engine.emcid import load_z_list
    from emcid_torch.engine.fim import fim_candidates, load_fim, resolve_fim
    from emcid_torch.engine.uce import cross_attn_kv_layer_names
    from emcid_torch.models.vision import (
        CLIP_VIT_L14_VISION,
        build_random_clip_vision,
    )
    from emcid_torch.ops import _build

    base = bench_hparams(10)
    fc2 = {f"text_encoder.text_model.encoder.layers.{i}.mlp.fc2.weight"
           for i in base.layers}
    kv = {f"unet.{n}.weight" for n in cross_attn_kv_layer_names(comps.unet)}
    t0 = time.time()
    tower = build_random_clip_vision(CLIP_VIT_L14_VISION, seed=0,
                                     dtype=torch.bfloat16, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(7)
    hidden = comps.text_encoder.config.hidden_size
    proj = torch.randn(hidden, CLIP_VIT_L14_VISION.projection_dim,
                       generator=g, device="cuda") * hidden ** -0.5
    torch.cuda.synchronize()
    tower_s = time.time() - t0
    tia_reqs = [dict(VARIANT_REQUESTS[0], txt_img_align=True),
                VARIANT_REQUESTS[1]]
    runs = (
        ("a_ewc_uce", dict(use_ewc=True, ewc_lambda=1e7, add_uce_edit=True),
         VARIANT_REQUESTS, {}, fc2 | kv),
        ("b_esd", dict(objective="esd", esd_mu=1.0), VARIANT_REQUESTS, {},
         fc2),
        ("c_sld", dict(sld_supervision=True, sld_type="max"), [SLD_REQUEST],
         {}, fc2),
        ("d_tia", dict(txt_img_align_scale_factor=5.0), tia_reqs,
         {"clip_align": (tower, proj)}, fc2),
    )
    rows = []
    for name, change, requests, extra, expect in runs:
        hp = dataclasses.replace(base, **change)
        checks = {}
        with environ(EMCID_TPU_FIM_PAIRS="4", **dict.fromkeys(KNOBS)), \
                tempfile.TemporaryDirectory() as tmp:
            cache_name = os.path.join(tmp, "z", "")
            fim_dir = os.path.join(tmp, "fim")
            timings = {}
            _build.reset_launches()
            t0 = time.time()
            if hp.use_ewc:
                last = dataclasses.replace(hp, layers=[hp.layers[-1]])
                cov = resolve_covariances_for(
                    comps.text_encoder, comps.tokenizer, last,
                    stats_dir=stats_dir, verbose=False)[-1]
                fim = resolve_fim(comps, hp, cov=cov, fim_dir=fim_dir,
                                  verbose=False)
                timings["fim_compute"] = time.time() - t0
            edited, deltas = apply_emcid(
                comps, requests, hp, stats_dir=stats_dir,
                cache_name=cache_name, fim_dir=fim_dir,
                num_inference_steps=10, z_sched="const", timings=timings,
                verbose=False, **extra)
            torch.cuda.synchronize()
            seconds = time.time() - t0
            launches = dict(_build.LAUNCHES)
            routes = copy.deepcopy(_build.ROUTES)
            z_list, missing = load_z_list(requests, cache_name, hp)
            if hp.use_ewc:
                path = fim_candidates(hp, fim_dir)[2]
                checks.update(
                    fim_shape=list(fim.shape),
                    fim_finite=bool(np.isfinite(fim).all()),
                    fim_npz_reloads_equal=bool(
                        path.exists()
                        and np.array_equal(load_fim(path), fim)))
        if hp.add_uce_edit:
            checks["uce_f32_vs_f64_rel"] = uce_f64_check(torch, comps, edited,
                                                         requests)
            checks["uce_ok"] = checks["uce_f32_vs_f64_rel"] <= UCE_REL_TOL
        changed = set()
        for part in ("text_encoder", "unet"):
            before = dict(getattr(comps, part).named_parameters())
            changed |= {f"{part}.{k}" for k, v in
                        getattr(edited, part).named_parameters()
                        if not torch.equal(v, before[k])}
        row = dict(
            phase="variants_path", run=name, hparams=change,
            concepts=len(requests), grad_steps=hp.v_num_grad_steps,
            seconds=seconds, **{f"{k}_s": v for k, v in timings.items()},
            launches=launches, routes=routes,
            bf16_routes_ok=routes_ok(routes),
            z_finite=bool(not missing and all(np.isfinite(z).all()
                                              for z in z_list)),
            deltas_finite=all(np.isfinite(a).all() and np.isfinite(r).all()
                              for a, r in deltas.values()),
            changed_params=len(changed), changed_exact=changed == expect,
            unexpected_changes=sorted(changed - expect),
            missing_changes=sorted(expect - changed), **checks)
        if name == "d_tia":
            row["vision_tower_build_s"] = tower_s
        row["ok"] = (row["z_finite"] and row["deltas_finite"]
                     and row["changed_exact"] and row["bf16_routes_ok"]
                     and all(launches[k] > 0 for k in ATTENTION)
                     and all(v for k, v in checks.items()
                             if k.endswith(("_finite", "_equal", "_ok"))))
        emit(row)
        rows.append(row)
        if not row["ok"]:
            failures.append(f"variants path {name}: {row}")
        del edited
        torch.cuda.empty_cache()
    del tower
    torch.cuda.empty_cache()
    return rows


# the UNet edit modes (unet_edit_path): the K/V edit's two concepts are the
# variant paths', the SLD request carries its safe words as one prompt; the
# region edits read the first concept's training images with its dest
# prompts (the default, dest-prompt objective) or the noise; the
# mom2_update_weight of both modes is the JAX package's tests' (100)
XKV_SLD_REQUEST = {"prompts": ["a photo of a {}", "an image of a {}", "{}"],
                   "source": "w5", "dest": " ", "seed_train": 5,
                   "safe_words": "a photo of a w6"}
UNET_EDIT_LAM = 100
REGION = (slice(12, 36), slice(12, 36))  # 24x24 of the 48x48 latents
UNET_STATS_PAIRS = 8
UNET_STATS_STEPS = 10


def region_hparams(final_layer, **change):
    from emcid_torch.hparams import UNetEMCIDHyperParams

    d = {
        "final_layer": final_layer, "spread_sub_block_cnt": 4,
        "skip_res_conv": False, "v_reduce_inside_img": True,
        "v_reduce_for_concept": True, "gloabl_sample": True,
        "num_t_blocks": 4, "even_sample": True, "v_num_grad_steps": 10,
        "v_lr": 0.05, "v_weight_decay": 5e-4, "clamp_norm_factor": 1.5,
        "objective": "ablate-source", "esd_mu": None,
        "mom2_update_weight": UNET_EDIT_LAM,
        "rewrite_module_tmp": {
            "mlp": "{}.{}.attentions.{}.transformer_blocks.0.ff.net.2",
            "conv-res": "{}.{}.resnets.{}.conv2",
            "conv-sample": "{}.{}.{}.0.conv"},
        "mom2_dataset": "synthetic_pairs",
        "mom2_n_samples_prompts": UNET_STATS_PAIRS,
        "mom2_n_steps_per_prompt": UNET_STATS_STEPS, "mom2_dtype": "float32"}
    d.update(change)
    return UNetEMCIDHyperParams.from_dict(d)


def solves_vs_f64(calls) -> float:
    """The worst relative (Frobenius) difference of the recorded
    ``solve_adj_k(C, K, lam)`` results from numpy's float64 solve of the
    same system on the host."""
    import numpy as np

    def host(x):
        return np.asarray(x.detach().cpu().double() if hasattr(x, "detach")
                          else x, np.float64)

    worst = 0.0
    for args, _, out in (c["call"] for c in calls):
        C, K, lam = host(args[0]), host(args[1]), float(args[2])
        ref = np.linalg.solve(lam * C + K @ K.T, K)
        worst = max(worst, float(np.linalg.norm(host(out) - ref)
                                 / np.linalg.norm(ref)))
    return worst


def write_survival(torch, before, after, deltas):
    """Per edited weight, the norm of what the bf16 write kept over the
    norm of the float update ``resid @ adj_k^T``: (min, mean) over the
    weights, and the worst relative error of the written update."""
    from emcid_torch.engine.unet_edit import matrix_as_conv_weight

    kept, errs = [], []
    for key, (adj_k, resid) in deltas.items():
        name = key[:-len(".weight")]
        w0 = before.get_submodule(name).weight.float()
        w1 = after.get_submodule(name).weight.float()
        upd = (torch.as_tensor(resid, device="cuda").double()
               @ torch.as_tensor(adj_k, device="cuda").double().T).float()
        if w0.dim() == 4:
            upd = matrix_as_conv_weight(upd, w0.shape[2], w0.shape[3])
        elif upd.shape != w0.shape:
            upd = upd.T
        n = float(upd.norm())
        kept.append(float((w1 - w0).norm()) / n)
        errs.append(float((w1 - w0 - upd).norm()) / n)
    return dict(upd_kept_min=min(kept), upd_kept_mean=sum(kept) / len(kept),
                written_upd_rel_err_max=max(errs))


def edit_changes(torch, comps, edited):
    """Changed parameter names of the UNet, and whether the text encoder
    and the VAE are bitwise the unedited ones."""
    return (sorted(changed_params(torch, comps.unet, edited.unet)),
            not changed_params(torch, comps.text_encoder,
                               edited.text_encoder)
            and not changed_params(torch, comps.vae, edited.vae))


def xkv_z_error(comps, unet, requests, hp, zs):
    """The K/V edit's z error on ``unet``'s weights as they are (as JAX
    prints it: the mean over the targets of |z - K W^T|), averaged over
    the projections."""
    from emcid_torch.engine.cross_attn import get_cross_attn_keys
    from emcid_torch.runtime import precise_matmuls

    import torch

    keys = get_cross_attn_keys(comps, requests, hp.num_edit_tokens)[0]
    keys = keys.reshape(-1, keys.shape[-1])
    errs = []
    with precise_matmuls():
        for name, z in zs.items():
            w = unet.get_submodule(name).weight.float()
            z = torch.as_tensor(z, device="cuda").reshape(-1, w.shape[0])
            errs.append(float((z - keys @ w.T).norm(dim=1).mean()))
    return sum(errs) / len(errs)


def seam_check(torch, comps, failures):
    """The main path's bf16 UNet at the Stage-1 shape (B=2, 48x48, 77
    tokens): a zero inject at each of the five seam kinds (a resnet conv2,
    to_k, to_v, the attn2 output, ff.net.2, all of up_blocks.3) and the
    taps of every leaf leave eps bitwise the same."""
    from emcid_torch.models.unet import unet_inject, unet_taps

    unet = comps.unet
    g = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randn(2, 4, 48, 48, generator=g, device="cuda").bfloat16()
    t = torch.tensor([500, 20], device="cuda")
    ctx = torch.randn(2, 77, unet.config.cross_attention_dim, generator=g,
                      device="cuda").bfloat16()
    res = "up_blocks.3.resnets.2"
    blk = "up_blocks.3.attentions.2.transformer_blocks.0"
    z = lambda *s: torch.zeros(s, device="cuda")
    seams = {f"{res}.conv2": z(2, 320, 48, 48), f"{blk}.attn2.to_k":
             z(2, 77, 320), f"{blk}.attn2.to_v": z(2, 77, 320),
             f"{blk}.attn2": z(2, 2304, 320), f"{blk}.ff.net.2":
             z(2, 2304, 320)}
    spec = {res: ["conv2_in", "conv2_out"],
            f"{blk}.attn2": ["kv_in", "k_out", "v_out", "attn_out_in",
                             "attn_out_out"],
            f"{blk}.ff": ["ff2_in", "ff2_out"]}
    with torch.no_grad(), environ(**dict.fromkeys(KNOBS)):
        ref = unet(x, t, ctx).sample
        row = dict(phase="model_check", what="sd-v1.4 UNet bf16, B=2, "
                   "48x48: zero injects and taps leave eps bitwise",
                   rerun_bitwise=torch.equal(unet(x, t, ctx).sample, ref))
        for path, zero in seams.items():
            with unet_inject(unet, {path: zero}):
                row[f"zero_inject_bitwise[{path}]"] = torch.equal(
                    unet(x, t, ctx).sample, ref)
        with unet_taps(unet, spec) as taps:
            row["taps_bitwise"] = torch.equal(unet(x, t, ctx).sample, ref)
        row["tap_shapes"] = {leaf: list(v.shape) for got in taps.values()
                             for leaf, v in got.items()}
    row["ok"] = (all(v for k, v in row.items()
                     if k.endswith(("bitwise", "]")))
                 and len(row["tap_shapes"]) == 9)
    emit(row)
    if not row["ok"]:
        failures.append(f"seam check: {row}")


def unet_edit_path(torch, comps, stats_dir, failures):
    """The UNet edit modes through their library entry points on the main
    path's bf16 pipeline, one JSON row per run, each with its own launch
    counts, seconds, peak memory and checks:

    (a) ``x_kv_esd``: ``apply_emcid_to_cross_attn``, the variant paths' 2
        concepts x 3 prompts (DPM++ training images at 10 steps, 384 px),
        esd (mu 1), 10 Stage-1 steps, the covariance from
        ``layer_stats_cross_attn_kv`` over the 2000 synthetic captions;
        then the same call again, which must read the covariance and z
        caches, launch no K2/K3 and give the same weights;
    (b) ``x_kv_sld``: one request with safe words under SLD ``strong``;
    (c) ``region_attn_out``: ``compute_delta_unet`` + ``execute_emcid_
        unet`` with both norm knobs at 1, up_blocks.3's three attn-out
        layers, 4 time blocks, 10 steps, the dest-prompt objective, a
        24x24 region of the 48x48 latents, per-layer covariances from
        ``layer_stats_unet`` over 8 (training image, caption) pairs, 10
        timesteps each;
    (d) ``region_conv``: the same at up_blocks.3's three res-last-conv
        layers, with ``use_sampled_noise``.

    Returns the rows of (a) and (c)."""
    import dataclasses

    import numpy as np

    from emcid_torch.dsets.stat_dataset import make_synthetic_captions
    from emcid_torch.engine import cross_attn, unet_edit
    from emcid_torch.engine.training_images import (
        training_latents_for_requests)
    from emcid_torch.engine.uce import cross_attn_kv_layer_names
    from emcid_torch.engine.unet_stats import layer_stats_unet
    from emcid_torch.ops import _build

    kv = sorted(f"{n}.weight" for n in cross_attn_kv_layer_names(comps.unet))
    caps = make_synthetic_captions(2000)
    gen_kw = dict(height=384, width=384, num_inference_steps=10,
                  sampler="dpm++", return_images=True)
    sync = torch.cuda.synchronize
    rows, images = {}, []

    def begin():
        sync()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        return time.time()

    def finish(row, t0, expect_routes, norm_bwd=False):
        sync()
        row.update(seconds=time.time() - t0,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
                   launches=dict(_build.LAUNCHES),
                   routes=copy.deepcopy(_build.ROUTES))
        row["routes_ok"] = routes_ok(row["routes"], expect_routes)
        if norm_bwd:  # K5b on either route, K6b on its register rows
            row["norm_bwd_ok"] = (
                row["launches"]["K5b groupnorm_bwd"] > 0
                and row["routes"]["K6b layernorm_bwd"]["rows"] > 0)
        row["ok"] = bool(row["routes_ok"] and all(
            v for k, v in row.items() if k.endswith(("_finite", "_ok",
                                                     "_unchanged"))))
        emit(row)
        rows[row["run"]] = row
        if not row["ok"]:
            failures.append(f"unet edit path {row['run']}: {row}")

    def xkv_run(name, requests, hp, tmp, again=False, lat=None):
        cache = os.path.join(tmp, "z", "")
        calls = {k: [] for k in ("z", "solve", "stats", "exec")}
        cov_file = cross_attn.stats_filename(
            stats_dir, "unet", "ccs_filtered",
            cross_attn_kv_layer_names(comps.unet)[0], "float32", ("mom2",),
            3 * 1024, len(caps))
        cov_mtime = cov_file.stat().st_mtime if cov_file.exists() else None
        t0 = begin()
        if lat is None:
            mean, logvar, imgs = training_latents_for_requests(
                comps, requests, hp, **gen_kw)
            images.extend(imgs)
            lat = (mean, logvar)
        sync()
        t_img = time.time()
        with spy(cross_attn, "compute_z_unet_x_kv", calls["z"]), \
                spy(cross_attn, "solve_adj_k", calls["solve"]), \
                spy(cross_attn, "layer_stats_cross_attn_kv", calls["stats"]), \
                spy(cross_attn, "execute_emcid_cross_attn", calls["exec"]):
            deltas, edited = cross_attn.apply_emcid_to_cross_attn(
                comps, requests, hp, latents_mean=lat[0],
                latents_logvar=lat[1], captions=caps, cache_name=cache,
                stats_dir=stats_dir, verbose=False)
        stage1_s = sum(c["seconds"] for c in calls["z"])
        zs = {}
        for r in requests:
            data = np.load(f"{cache}source_{r['source']}.npz")
            for n in data.files:
                zs.setdefault(n, []).append(data[n])
        zs = {n: np.stack(v) for n, v in zs.items()}
        changed, others_unchanged = edit_changes(torch, comps, edited)
        row = dict(
            phase="unet_edit_path", run=name,
            entry="emcid_torch.engine.apply_emcid_to_cross_attn",
            concepts=len(requests), prompts=3,
            grad_steps=hp.v_num_grad_steps, objective=(
                f"sld {hp.sld_type}" if hp.sld_supervision
                else f"esd mu {hp.esd_mu}"),
            mom2_update_weight=hp.mom2_update_weight,
            training_images_s=(t_img - t0) if not again else 0.0,
            covariance_s=sum(c["seconds"] for c in calls["stats"]),
            stage1_s=stage1_s,
            stage1_s_per_step=(stage1_s / (len(calls["z"])
                                           * hp.v_num_grad_steps)
                               if calls["z"] else None),
            stage2_s=sum(c["seconds"] for c in calls["exec"]),
            stage1_calls=len(calls["z"]),
            z_finite=bool(zs) and all(np.isfinite(z).all()
                                      for z in zs.values()),
            deltas_finite=all(np.isfinite(a).all() and np.isfinite(r).all()
                              for a, r in deltas.values()),
            changed_params=len(changed), changed_exact_ok=changed == kv,
            text_encoder_vae_unchanged=others_unchanged,
            stage2_f32_ir_vs_f64_rel=solves_vs_f64(calls["solve"]),
            solve_rel_tolerance=SOLVE_REL_TOL,
            z_error_before=xkv_z_error(comps, comps.unet, requests, hp, zs),
            z_error_written=xkv_z_error(comps, edited.unet, requests, hp,
                                        zs),
            **write_survival(torch, comps.unet, edited.unet, deltas))
        row["stage2_solve_ok"] = (
            bool(calls["solve"])
            and row["stage2_f32_ir_vs_f64_rel"] <= SOLVE_REL_TOL)
        row["z_error_falls_ok"] = row["z_error_written"] < row[
            "z_error_before"]
        if again:
            row.update(
                z_cache_read_ok=not calls["z"],
                cov_cache_read_ok=(cov_mtime is not None
                                   and cov_file.stat().st_mtime == cov_mtime),
                no_backward_ok=(_build.LAUNCHES["K2 flash_v2_dq"] == 0
                                and _build.LAUNCHES["K3 flash_v2_dkv"] == 0))
            expect = {}
        else:
            expect = BF16_ROUTES
        return row, t0, expect, edited, lat

    with tempfile.TemporaryDirectory() as tmp:
        hp = dataclasses.replace(bench_hparams(10), objective="esd",
                                 esd_mu=1.0,
                                 mom2_update_weight=UNET_EDIT_LAM)
        row, t0, expect, first, lat = xkv_run("a_x_kv_esd",
                                              VARIANT_REQUESTS, hp, tmp)
        finish(row, t0, expect)
        row, t0, expect, again, _ = xkv_run("a_x_kv_esd_cached",
                                            VARIANT_REQUESTS, hp, tmp,
                                            again=True, lat=lat)
        row["same_weights_ok"] = all(
            torch.allclose(again.unet.get_submodule(n[:-7]).weight.float(),
                           first.unet.get_submodule(n[:-7]).weight.float(),
                           rtol=1e-5, atol=1e-8) for n in kv)
        finish(row, t0, expect)
        del first, again
    with tempfile.TemporaryDirectory() as tmp:
        hp = dataclasses.replace(hp, objective="ablate-dest", esd_mu="None",
                                 sld_supervision=True, sld_type="strong")
        row, t0, expect, edited, _ = xkv_run("b_x_kv_sld",
                                             [XKV_SLD_REQUEST], hp, tmp)
        finish(row, t0, expect)
        del edited
    torch.cuda.empty_cache()

    # the region edits: the first concept's training images (Simg 1, P 3)
    lm, lv = lat[0][0], lat[1][0]
    region = np.zeros((3, 48, 48), np.float32)
    region[(slice(None),) + REGION] = 1.0
    pairs = list(zip(images[:UNET_STATS_PAIRS],
                     make_synthetic_captions(UNET_STATS_PAIRS, seed=1)))
    request = REQUESTS[0]
    for name, final, change in (
            ("c_region_attn_out", ["up_blocks", 3, "attn-out"], {}),
            ("d_region_conv", ["up_blocks", 3, "res-last-conv"],
             dict(use_sampled_noise=True))):
        hp = region_hparams(final, **change)
        layers = unet_edit.retrieve_spreading_layers(hp)
        kind = layers[0][1][2]
        solves = []
        with environ(EMCID_TPU_FUSED_GN="1", EMCID_TPU_FUSED_LN="1"):
            t0 = begin()
            covs = {n: layer_stats_unet(
                comps, n, kind, pairs, stats_dir=stats_dir,
                ds_name="synthetic_pairs",
                t_steps_per_pair=UNET_STATS_STEPS).mom2.moment()
                for n, _ in layers}
            sync()
            t1 = time.time()
            delta = unet_edit.compute_delta_unet(comps, request, hp, lm, lv,
                                                 region, verbose=False)
            t2 = time.time()
            with spy(unet_edit, "solve_adj_k", solves):
                deltas, edited = unet_edit.execute_emcid_unet(
                    comps, [request], hp, [delta], [region], [(lm, lv)],
                    covs, verbose=False)
            sync()
            t3 = time.time()

            # the z error at the final layer, as JAX prints it: the mean
            # over the region points of |desired - current pre-fold
            # output|, the desired from the unedited model, the current
            # from each model with the same draws
            def region_io(c, d=None):
                return unet_edit._region_io(
                    c, request, hp, layers[0][0], kind, lm, lv, region,
                    gen=unet_edit.region_generator("cuda", 0, 0), delta=d)

            _, cur0, desired = region_io(comps, delta)
            _, cur1, _ = region_io(edited)
            before = float((desired - cur0).norm(dim=1).mean())
            written = float((desired - cur1).norm(dim=1).mean())
            changed, others_unchanged = edit_changes(torch, comps, edited)
            expect_changed = sorted(f"{n}.weight" for n, _ in layers)
            row = dict(
                phase="unet_edit_path", run=name,
                entry="emcid_torch.engine.compute_delta_unet + "
                "execute_emcid_unet", final_layer=final,
                spreading_layers=[n for n, _ in layers],
                num_t_blocks=hp.num_t_blocks, grad_steps=hp.v_num_grad_steps,
                objective=("use_sampled_noise" if hp.use_sampled_noise
                           else "dest prompts"),
                region=[24, 24], latents=[48, 48],
                knobs=dict(EMCID_TPU_FUSED_GN="1", EMCID_TPU_FUSED_LN="1"),
                covariance_s=t1 - t0, stage1_s=t2 - t1,
                stage1_s_per_step=(t2 - t1) / hp.v_num_grad_steps,
                stage2_s=t3 - t2,
                region_keys=[int(a.shape[1]) for a, _ in deltas.values()],
                delta_finite=bool(np.isfinite(delta).all()),
                delta_norm=float(np.linalg.norm(delta)),
                deltas_finite=all(np.isfinite(a).all()
                                  and np.isfinite(r).all()
                                  for a, r in deltas.values()),
                changed_params=changed,
                changed_exact_ok=changed == expect_changed,
                text_encoder_vae_unchanged=others_unchanged,
                stage2_f64_vs_host_f64_rel=solves_vs_f64(solves),
                solve_rel_tolerance=SOLVE_REL_TOL,
                z_error_before=before, z_error_written=written,
                **write_survival(torch, comps.unet, edited.unet, deltas))
            row["stage2_solve_ok"] = (
                len(solves) == len(layers)
                and row["stage2_f64_vs_host_f64_rel"] <= SOLVE_REL_TOL)
            row["z_error_falls_ok"] = written < before
            # the attn-out inject's gradient passes no self-attention (the
            # block's attn1 runs before it): K2/K3 only in the conv run
            expect = {k: v for k, v in BF16_ROUTES.items()
                      if kind != "attn-out" or k not in (
                          "K2 flash_v2_dq", "K3 flash_v2_dkv")}
            finish(row, t0, expect, norm_bwd=True)
            del edited
        torch.cuda.empty_cache()
    return rows["a_x_kv_esd"], rows["c_region_attn_out"]


# f32 on both sides under precise_matmuls (no TF32); the two differ only in
# the order of their sums, through some thirty attention and conv layers
MODEL_TOL = 1e-3


def model_check(torch, unet, failures, gn="0", ln="0"):
    """The main path's UNet (``unet``, f32) at the Stage-1 shape (48x48
    latents, 77-token context): attention through the kernels (K1-K4) and,
    with ``EMCID_TPU_FUSED_GN=gn`` / ``EMCID_TPU_FUSED_LN=ln``, the norms
    through K5/K6, against the same UNet with both knobs at 0 and every
    attention on the plain einsum/softmax path (``EMCID_TPU_NO_FLASH=1``),
    for eps and for the gradient of a loss with respect to the text context (Stage 1's
    gradient path: K2/K3, K4's chunked backward, K5b and K6b)."""
    from emcid_torch.ops import _build
    from emcid_torch.runtime import precise_matmuls

    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(2, 4, 48, 48, generator=g, device="cuda")
    t = torch.tensor([500, 20], device="cuda")
    ctx0 = torch.randn(2, 77, unet.config.cross_attention_dim, generator=g,
                       device="cuda")
    w = torch.randn(2, 4, 48, 48, generator=g, device="cuda")

    def eps_and_grad():
        ctx = ctx0.clone().requires_grad_()
        eps = unet(x, t, ctx).sample
        grad, = torch.autograd.grad((eps * w).sum(), ctx)
        return eps.detach(), grad

    with precise_matmuls():
        with environ(EMCID_TPU_FUSED_GN=gn, EMCID_TPU_FUSED_LN=ln):
            _build.reset_launches()
            eps_k, grad_k = eps_and_grad()
            launches = dict(_build.LAUNCHES)
            routes = {k: dict(_build.ROUTES[k]) for k in NORM_ROUTES}
        # every attention on the plain path, the stock norms
        with environ(EMCID_TPU_NO_FLASH="1", **dict.fromkeys(KNOBS)):
            eps_p, grad_p = eps_and_grad()
    _, eps_rel = rel_err(eps_k, eps_p)
    _, grad_rel = rel_err(grad_k, grad_p)
    expect = ATTENTION + (NORMS if gn != "0" else ())
    row = dict(phase="model_check", what="sd-v1.4 UNet f32, B=2, 48x48, "
               "kernels vs plain attention and stock norms",
               EMCID_TPU_FUSED_GN=gn, EMCID_TPU_FUSED_LN=ln,
               eps_rel_err=eps_rel, ctx_grad_rel_err=grad_rel,
               tolerance=MODEL_TOL, launches=launches, norm_routes=routes)
    # with the knobs at 1 the f32 spans of 320 channels take K5b's resident
    # route and those of 640 its stream route; K6b takes rows at 320 and
    # 640 channels and generic at 1280
    both = gn != "1" or all(n > 0 for r in routes.values() for n in r.values())
    row["ok"] = (eps_rel <= MODEL_TOL and grad_rel <= MODEL_TOL
                 and all(launches[k] > 0 for k in expect) and both
                 and bool(torch.isfinite(eps_k).all()))
    emit(row)
    if not row["ok"]:
        failures.append(f"model check: {row}")
    torch.cuda.empty_cache()
    return launches


# bf16 on both sides, but the kernels and the plain path round at other
# points (the kernels round P to bf16 once, in f32 softmax order; the
# plain path rounds the scores, q * scale and P), and the differences
# pass through some thirty attention, conv and norm layers: 5e-2 of the
# largest value
BF16_MODEL_TOL = 5e-2


def model_check_bf16(torch, comps, failures):
    """The main path's bf16 UNet at the Stage-1 shape (eps and the gradient
    into the text context) and its bf16 VAE (decode of a (2, 4, 48, 48)
    latent, re-encode of the decoded image), attention through the kernels
    (K1 mma and d512, K4 mma; K2/K3 and K4's chunked backward) against the
    same modules with every attention on the plain einsum/softmax path
    (``EMCID_TPU_NO_FLASH=1``); the norm knobs off.  The UNet's
    run must take the tensor-core routes of K1 (mma), K2, K3 and K4, the
    VAE's K1's d512 route."""
    from emcid_torch.ops import _build

    bf = torch.bfloat16
    unet, vae = comps.unet, comps.vae
    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(2, 4, 48, 48, generator=g, device="cuda").to(bf)
    t = torch.tensor([500, 20], device="cuda")
    ctx0 = torch.randn(2, 77, unet.config.cross_attention_dim, generator=g,
                       device="cuda").to(bf)
    w = torch.randn(2, 4, 48, 48, generator=g, device="cuda").to(bf)
    lat = torch.randn(2, 4, 48, 48, generator=g, device="cuda").to(bf)

    def unet_eps_and_grad():
        ctx = ctx0.clone().requires_grad_()
        eps = unet(x, t, ctx).sample
        grad, = torch.autograd.grad((eps.float() * w.float()).sum(), ctx)
        return eps.detach(), grad

    @torch.no_grad()
    def vae_decode_encode(img=None):
        dec = vae.decode(lat)
        return dec, vae.encode(dec if img is None else img).mean

    with environ(**dict.fromkeys(KNOBS)):
        _build.reset_launches()
        eps_k, grad_k = unet_eps_and_grad()
        unet_routes = copy.deepcopy(_build.ROUTES)
        _build.reset_launches()
        with environ(EMCID_TPU_NO_FLASH="1"):
            eps_p, grad_p = unet_eps_and_grad()
            img_p, z_p = vae_decode_encode()
        dec_k, z_k = vae_decode_encode(img_p)  # both encode the same image
        vae_routes = copy.deepcopy(_build.ROUTES)
    errs = dict(eps_rel_err=rel_err(eps_k, eps_p)[1],
                ctx_grad_rel_err=rel_err(grad_k, grad_p)[1],
                vae_decode_rel_err=rel_err(dec_k, img_p)[1],
                vae_encode_rel_err=rel_err(z_k, z_p)[1])
    row = dict(phase="model_check", what="sd-v1.4 UNet and VAE bf16, B=2, "
               "48x48 latents, kernels vs plain attention", **errs,
               tolerance=BF16_MODEL_TOL, unet_routes=unet_routes,
               vae_routes=vae_routes)
    finite = all(bool(torch.isfinite(a).all())
                 for a in (eps_k, grad_k, dec_k, z_k))
    row["ok"] = (all(e <= BF16_MODEL_TOL for e in errs.values()) and finite
                 and routes_ok(unet_routes, {"K1 flash_v2_fwd": ("mma",),
                                             "K2 flash_v2_dq": ("mma",),
                                             "K3 flash_v2_dkv": ("mma",),
                                             "K4 short_kv_fwd": ("mma",)})
                 and vae_routes["K1 flash_v2_fwd"]["d512"] > 0)
    emit(row)
    if not row["ok"]:
        failures.append(f"bf16 model check: {row}")
    torch.cuda.empty_cache()


VAL_PROMPTS = ["a photo of a w0", "an image of a w2"]


def write_checkpoint(torch, tmp: Path):
    """The full-width SD-v1.4 pipeline (random f32 weights, seed 0) as a
    local HF-format folder ``tmp/ckpt`` (``.bin`` state dicts, 4.3 GB):
    the one folder the CLI path and the evaluation path load.  Returns
    (folder, its tokenizer, the text encoder's state in bf16, seconds to
    write, GiB written)."""
    from emcid_torch.models.loader import build_random_pipeline, save_pipeline

    t0 = time.time()
    comps = build_random_pipeline("sd-v1.4", dtype=torch.float32, seed=0,
                                  device="cuda")
    save_pipeline(comps, tmp / "ckpt")
    before = {k: v.to(torch.bfloat16)
              for k, v in comps.text_encoder.state_dict().items()}
    tokenizer = comps.tokenizer
    del comps
    torch.cuda.empty_cache()
    write_s = time.time() - t0
    ckpt_gb = sum(f.stat().st_size for f in (tmp / "ckpt").rglob("*")
                  if f.is_file()) / 2 ** 30
    return tmp / "ckpt", tokenizer, before, write_s, ckpt_gb


def cli_inputs(tmp: Path, ckpt_dir, hp):
    """The CLI path's instruction (the 4 concepts, 2 val prompts x 1
    sample) and command line under ``tmp``: (argv, hparams name, out
    dir)."""
    (tmp / "hparams").mkdir(parents=True)
    name = hp.to_json(tmp / "hparams").stem
    out_dir = tmp / "out"
    (tmp / "run.json").write_text(json.dumps(dict(
        requests=REQUESTS, hparams=name, model_ckpt="sd-v1.4",
        val_prompts=VAL_PROMPTS, out_dir=str(out_dir), sample_num=1)))
    argv = ["--instruction_path", str(tmp / "run.json"),
            "--checkpoint_dir", str(ckpt_dir),
            "--hparams_dir", str(tmp / "hparams"),
            "--stats_dir", str(tmp / "stats"),
            "--cache_dir", str(tmp / "z"),
            "--sampler", "dpm++", "--steps", "10", "--seed", "0"]
    return argv, name, out_dir


def fc2_updates(torch, text_encoder, before, layers) -> dict:
    """The edit layers' fc2 weights minus ``before``'s, f32 on the host."""
    state = text_encoder.state_dict()
    return {k: (state[k].float() - before[k].float()).cpu()
            for k in (f"text_model.encoder.layers.{i}.mlp.fc2.weight"
                      for i in layers)}


def cli_path(torch, tmp: Path, ckpt, failures):
    """``python -m emcid_torch.cli.run_emcid`` in-process with
    EMCID_TPU_FUSED_GN=1 and EMCID_TPU_FUSED_LN=1, on the local HF-format
    folder of ``write_checkpoint`` (loaded in bf16): the 4 concepts of the
    main path, the bench hparams, 2 val prompts x 1 sample at 512 px, DPM++
    at 10 steps.  Returns the launch count of every kernel (and route)
    during the CLI run, and its edit's fc2 updates and images (the dcn
    path's one-process twin)."""
    import numpy as np
    from PIL import Image

    from emcid_torch.cli import run_emcid
    from emcid_torch.engine.emcid import load_z_list
    from emcid_torch.ops import _build

    ckpt_dir, _, before, write_s, ckpt_gb = ckpt
    tmp = tmp / "cli"
    hp = bench_hparams(50)
    argv, name, out_dir = cli_inputs(tmp, ckpt_dir, hp)
    timings = {}
    with environ(EMCID_TPU_FUSED_GN="1", EMCID_TPU_FUSED_LN="1"):
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.time()
        edited, deltas = run_emcid.main(argv, timings=timings)
        torch.cuda.synchronize()
        total_s = time.time() - t0
        launches = dict(_build.LAUNCHES)
        routes = copy.deepcopy(_build.ROUTES)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    z_list, missing = load_z_list(REQUESTS, f"{tmp / 'z'}/{name}/", hp)
    images = {phase: [np.asarray(Image.open(f)) for f in
                      sorted((out_dir / phase).glob("*.png"))]
              for phase in ("pre_edit", "post_edit")}
    changed = sorted(k for k, v in edited.text_encoder.state_dict().items()
                     if not torch.equal(v, before[k]))
    expect = sorted(f"text_model.encoder.layers.{i}.mlp.fc2.weight"
                    for i in hp.layers)
    images_ok = all(
        len(imgs) == len(VAL_PROMPTS)
        and all(a.dtype == np.uint8 and a.shape == (512, 512, 3)
                for a in imgs) for imgs in images.values())
    row = dict(
        phase="cli_path", entry="emcid_torch.cli.run_emcid",
        model="sd-v1.4 (full width, random f32 weights from seed 0, loaded "
        "in bf16 from a .bin checkpoint folder)",
        EMCID_TPU_FUSED_GN="1", EMCID_TPU_FUSED_LN="1",
        concepts=len(REQUESTS), val_prompts=len(VAL_PROMPTS), sample_num=1,
        sampler="dpm++", steps=10, gen_res=512,
        checkpoint_gb=ckpt_gb, write_checkpoint_s=write_s, total_s=total_s,
        **{f"{k}_s": v for k, v in timings.items()}, peak_mem_gb=peak_gb,
        launches=launches, routes=routes, bf16_routes_ok=routes_ok(routes),
        z_finite=bool(not missing and all(np.isfinite(z).all()
                                          for z in z_list)),
        deltas_finite=all(np.isfinite(a).all() and np.isfinite(r).all()
                          for a, r in deltas.values()),
        changed_params=changed, only_fc2_of_edit_layers=changed == expect,
        images={k: [list(a.shape) for a in v] for k, v in images.items()},
        images_uint8_512=images_ok)
    row["norm_routes_ok"] = (routes["K5b groupnorm_bwd"]["resident"] > 0
                             and routes["K6b layernorm_bwd"]["rows"] > 0)
    row["ok"] = (row["z_finite"] and row["deltas_finite"]
                 and row["only_fc2_of_edit_layers"] and images_ok
                 and all(launches[k] > 0 for k in SOURCES)
                 and row["bf16_routes_ok"] and row["norm_routes_ok"])
    emit(row)
    if not row["ok"]:
        failures.append(f"CLI path: {row}")
    # the dcn path's twin: this one-process run's edit and images
    twin = dict(seconds=total_s, updates=fc2_updates(
        torch, edited.text_encoder, before, hp.layers), images=images,
        z=np.stack(z_list), peak_mem_gb=peak_gb)
    del edited
    torch.cuda.empty_cache()
    return launches, routes, twin


# ---------------------------------------------------------------------------
# the evaluation path: emcid_torch.cli.workflows aice / mend / debias and
# apply_emcid_to_clip
# ---------------------------------------------------------------------------

# edit classes (source -> dest), held-out classes, one alias, the mend
# classes (a name that scores well, one that scores badly) and the debias
# professions: words of the checkpoint's tokenizer
ICEB_EDIT = [("w10", 0, "w11", 1), ("w12", 2, "w13", 3)]
ICEB_TEST = [("w20", 5), ("w21", 6)]
ICEB_ALIAS = {"0": "w10, w30", "2": "w12"}
MEND = {"7": ("w40", "w41"), "8": ("w42", "w43")}
PROFESSIONS = ["w50", "w53"]
CLIP_REQUESTS = [
    {"prompts": ["a photo of a {}", "{}"], "source": f"w{i}",
     "dest": f"w{i + 1}", "negative_prompts": [f"a w{i + 2}", "a w63"]}
    for i in (56, 59)]
# the ViT in f32 on the card against the same ViT in float64 on the host
VIT_F64_TOL = 1e-4
# the debias UCE and clip_edit Stage-2 solves against float64 (ROADMAP F1)
SOLVE_REL_TOL = 1e-3


def write_iceb_tree(data: Path) -> None:
    """Synthetic request files in the parsers' formats: the ICEB edit and
    test JSONs (5 prompts per edit class, 3 per held-out class), the ViT
    label map, the mend class summary and prompt pool, and a 2-row TIMED
    gender CSV."""
    import csv

    iceb = data / "iceb_data"
    iceb.mkdir(parents=True)
    rows, idx = [], 0
    for cls, cid, dest, did in ICEB_EDIT:
        for _ in range(5):
            rows.append({"class name": cls,
                         "text prompt": f"an image of a {{}} w{idx % 8}",
                         "random seed": 100 + idx, "idx": idx,
                         "class id": cid, "checked": True, "dest": dest,
                         "dest id": did})
            idx += 1
    (iceb / "imgnet_aug_edit.json").write_text(json.dumps(rows))
    test = [{"class name": cls, "text prompt": f"a photo of a {cls} w{i}",
             "random seed": 50 + 3 * k + i, "idx": 3 * k + i, "class id": cid}
            for k, (cls, cid) in enumerate(ICEB_TEST) for i in range(3)]
    (iceb / "imgnet_aug_test.json").write_text(json.dumps(test))
    (iceb / "vit_classifier_config.json").write_text(
        json.dumps({"id2label": ICEB_ALIAS}))
    summary = {cid: {good: {"mean": 0.8, "std": 0.1, "number": 8},
                     bad: {"mean": 0.05, "std": 0.01, "number": 8}}
               for cid, (good, bad) in MEND.items()}
    (iceb / "imgnet_prompts_cls.json").write_text(json.dumps(summary))
    pool = [{"class name": good, "text prompt": f"an image of {good} w{i}",
             "random seed": 200 + 3 * k + i, "idx": 3 * k + i,
             "class id": int(cid)}
            for k, (cid, (good, _)) in enumerate(MEND.items())
            for i in range(3)]
    (iceb / "imgnet_aug_full.json").write_text(json.dumps(pool))
    (data / "debias").mkdir()
    with open(data / "debias" / "TIMED_gender_test_set_processed.csv",
              "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["female", "male", "old", "new",
                                          "validation", "ex1", "ex2", "ex3",
                                          "ex4", "ex5"])
        w.writeheader()
        for p in PROFESSIONS:
            w.writerow({"female": f"a w{int(p[1:]) + 1} {p}",
                        "male": f"a w{int(p[1:]) + 2} {p}", "old": f"a {p}",
                        "new": f"a w{int(p[1:]) + 1} {p}",
                        "validation": f"a photo of a {p}",
                        **{f"ex{i}": f"a {p} w{i}" for i in range(1, 6)}})


def write_scorers(torch, tmp: Path, tokenizer):
    """Random full-width scorer checkpoints saved with ``torch.save`` as HF
    state dicts: a ViT-B/16 ImageNet classifier (seed 1) and a CLIP
    ViT-L/14 (vision tower seed 2; the SD text tower with a 768-wide
    projection, seed 3).  Returns (vit path, clip path, the CLIP text
    tower's state)."""
    import dataclasses

    from emcid_torch.models.clip_text import CLIPTextEncoder
    from emcid_torch.models.configs import SD_V14_TEXT
    from emcid_torch.models.loader import _random_init_
    from emcid_torch.models.vision import (
        CLIP_VIT_L14_VISION,
        VIT_BASE_224,
        build_random_clip_vision,
        build_random_vit,
    )

    cpu = lambda m: {k: v.cpu() for k, v in m.state_dict().items()}
    vit = build_random_vit(VIT_BASE_224, seed=1, device="cuda")
    torch.save(cpu(vit), tmp / "vit_b16.pt")
    del vit
    vision = build_random_clip_vision(CLIP_VIT_L14_VISION, seed=2,
                                      device="cuda")
    with torch.device("cuda"):
        text = CLIPTextEncoder(dataclasses.replace(
            SD_V14_TEXT, projection_dim=768,
            eos_token_id=tokenizer.eos_token_id))
    _random_init_(text, torch.Generator(device="cuda").manual_seed(3))
    text_state = cpu(text)
    torch.save({**cpu(vision), **text_state}, tmp / "clip_l14.pt")
    del vision, text
    torch.cuda.empty_cache()
    return tmp / "vit_b16.pt", tmp / "clip_l14.pt", text_state


@contextlib.contextmanager
def spy(module, name, calls, keep=True):
    """Record every call of ``module.name`` inside the scope: (args,
    kwargs, result) when ``keep``, and always its seconds and the length
    of its third positional argument or ``images``/``prompts`` (the image
    count of a generate or classify call)."""
    real = getattr(module, name)

    def wrapper(*args, **kwargs):
        t0 = time.time()
        out = real(*args, **kwargs)
        n = len(args[1]) if len(args) > 1 and hasattr(args[1], "__len__") \
            else 0
        calls.append(dict(seconds=time.time() - t0, n=n,
                          call=(args, kwargs, out) if keep else None))
        return out

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def cli_entry(argv) -> str:
    """The workflows command line of ``argv`` without its absolute paths."""
    return "python -m emcid_torch.cli.workflows " + " ".join(
        a for a in argv if not a.startswith("/"))


@contextlib.contextmanager
def measured(torch, phase, label, entry, knobs, gen_spies, time_spies=()):
    """One run of a phase under ``knobs``: yields its row and fills in its
    kernel launches per route, seconds, peak memory and generated images.
    ``gen_spies`` are the (module, name) calls that generate (their image
    counts and seconds add up), ``time_spies`` calls whose seconds add to
    the generation time only."""
    from emcid_torch.ops import _build

    row = dict(phase=phase, run=label, entry=entry, knobs=knobs)
    gens, timed = [], []
    with contextlib.ExitStack() as stack:
        stack.enter_context(environ(**knobs))
        for module, name in gen_spies:
            stack.enter_context(spy(module, name, gens, keep=False))
        for module, name in time_spies:
            stack.enter_context(spy(module, name, timed, keep=False))
        _build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        yield row
        torch.cuda.synchronize()
        row["seconds"] = time.time() - t0
        row["launches"] = dict(_build.LAUNCHES)
        row["routes"] = copy.deepcopy(_build.ROUTES)
    n = sum(g["n"] for g in gens)
    gen_s = sum(g["seconds"] for g in gens + timed)
    row.update(generated_images=n, generation_s=gen_s,
               images_per_s_512=n / gen_s if n else None,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30)


def finish_run(rows, failures, row, checks):
    """Close a run's row: its checks, ``ok`` when every ``*_ok`` holds,
    printed and kept; a failed run is added to ``failures``."""
    row.update(checks)
    row["ok"] = all(v for k, v in checks.items() if k.endswith("_ok"))
    emit(row)
    rows.append(row)
    if not row["ok"]:
        failures.append(f"{row['phase'].replace('_', ' ')} {row['run']}: "
                        f"{row}")


def changed_params(torch, before_module, after_module):
    before = dict(before_module.named_parameters())
    return {k for k, v in after_module.named_parameters()
            if not torch.equal(v, before[k])}


def vit_f64_check(torch, vit_path, images):
    """The scorer's ViT (f32 on the card, exact f32) against the same
    weights in float64 on the host, on ``images``: max |p32 - p64| over
    max |p64| of the class probabilities."""
    import numpy as np

    from emcid_torch.evals.scorers import ViTScorer, make_vit_scorer
    from emcid_torch.models.vision import ViTClassifier, VIT_BASE_224

    sd = torch.load(vit_path, map_location="cpu", weights_only=True)
    p32 = make_vit_scorer(torch_state_dict=sd, device="cuda").probs(images)
    m64 = ViTClassifier(VIT_BASE_224)
    m64.load_state_dict(sd, strict=True)
    p64 = ViTScorer(m64.double().eval().requires_grad_(False))
    # the same resize on the host in float64
    from emcid_torch.models.vision import (
        VIT_IMAGE_MEAN, VIT_IMAGE_STD, preprocess_for_model)

    x = preprocess_for_model(images, m64.config.image_size, VIT_IMAGE_MEAN,
                             VIT_IMAGE_STD, device="cpu").double()
    with torch.no_grad():
        ref = torch.softmax(p64.model(x), dim=-1).numpy()
    return float(np.abs(p32 - ref).max() / np.abs(ref).max())


def eval_path(torch, tmp: Path, ckpt, failures):
    """The ICEB evaluation path through its entry points, on the folder of
    ``write_checkpoint`` (bf16) with random full-width scorers and a
    synthetic request tree, the bench hparams at 10 Stage-1 steps, PNDM at
    10 steps at 512 px, covariances over the synthetic corpus cached in one
    stats directory for every run:

    (a) ``workflows aice`` (2 edits, 2 held-out classes), norm knobs off,
        then the same call again (the stored record, no generation);
    (b) ``workflows mend --method emcid`` (2 edits), both knobs at 1;
    (c) ``workflows debias --method emcid`` (1 profession, 2 factor-search
        iterations of 4 images);
    (d) ``workflows debias --method uce`` (the same sizes: 2 iterations of
        5 seeds x 4 images);
    (e) ``apply_emcid_to_clip`` on 2 requests, as a library call, on the
        CLIP text tower (f32).

    One JSON row per run with its kernel launches per route, phase
    seconds, images per second and its checks."""
    import dataclasses

    import numpy as np
    from PIL import Image

    import emcid_torch.engine.debias as debias_mod
    import emcid_torch.engine.editor as editor_mod
    import emcid_torch.engine.uce as uce_mod
    from emcid_torch.cli import workflows
    from emcid_torch.engine.clip_edit import apply_emcid_to_clip
    from emcid_torch.engine.editor import resolve_covariances_for
    from emcid_torch.engine.emcid import execute_emcid_text_encoder, load_z_list
    from emcid_torch.evals.summary import summary_key, summary_path
    from emcid_torch.models.clip_text import CLIPTextEncoder
    from emcid_torch.models.configs import SD_V14_TEXT
    from emcid_torch.ops import _build

    ckpt_dir, tokenizer, _, _, _ = ckpt
    tmp = tmp / "eval"
    data = tmp / "data"
    write_iceb_tree(data)
    hp = bench_hparams(10)
    (tmp / "hparams").mkdir(parents=True)
    name = hp.to_json(tmp / "hparams").stem
    t0 = time.time()
    vit_path, clip_path, clip_text_state = write_scorers(torch, tmp, tokenizer)
    scorers_s = time.time() - t0
    fc2 = {f"text_model.encoder.layers.{i}.mlp.fc2.weight" for i in hp.layers}
    common = ["--checkpoint_dir", str(ckpt_dir), "--hparam", name,
              "--hparams_dir", str(tmp / "hparams"), "--data_dir", str(data),
              "--stats_dir", str(tmp / "stats"), "--steps", "10",
              "--seed", "0"]
    rows = []

    def run(label, argv, knobs, engine):
        """One CLI call with its launches, timings and the engine call it
        made (``engine``: (module, function name))."""
        timings = {}
        calls, gens, cls = [], [], []
        with environ(**knobs), spy(*engine, calls), \
                spy(debias_mod, "generate", gens, keep=False), \
                spy(uce_mod, "generate", gens, keep=False), \
                spy(debias_mod, "classify_ratio", cls, keep=False):
            _build.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            out = workflows.main(argv, timings=timings)
            torch.cuda.synchronize()
            seconds = time.time() - t0
            launches = dict(_build.LAUNCHES)
            routes = copy.deepcopy(_build.ROUTES)
        if gens:  # the debias runs generate through the engine
            timings["generation"] = sum(g["seconds"] for g in gens)
            timings["generated_images"] = sum(g["n"] for g in gens)
            timings["scoring"] = sum(c["seconds"] for c in cls)
            timings["scored_images"] = sum(c["n"] for c in cls)
        n_img = timings.get("generated_images", 0)
        row = dict(
            phase="eval_path", run=label, entry=cli_entry(argv),
            knobs=knobs, seconds=seconds,
            **{f"{k}_s" if not k.endswith("images") else k: v
               for k, v in timings.items()},
            images_per_s_512=(n_img / timings["generation"]
                              if n_img else None),
            scorer="CLIP ViT-L/14" if argv[0] == "debias" else "ViT-B/16",
            scorer_s_per_image=(timings["scoring"] / timings["scored_images"]
                                if timings.get("scored_images") else None),
            peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
            launches=launches, routes=routes)
        return row, out, calls

    finish = functools.partial(finish_run, rows, failures)

    # (a) aice, knobs off, and the same call again
    aice = ["aice", *common, "--vit_checkpoint", str(vit_path),
            "--edit_nums", "2", "--specificity_classes", "2",
            "--cache_dir", str(tmp / "cache_a"),
            "--results_dir", str(tmp / "results")]
    off = dict.fromkeys(KNOBS)
    row, out, calls = run("a_aice", aice, off, (editor_mod, "apply_emcid"))
    record = out[0]
    (before, *_), _, (edited, _) = calls[-1]["call"]
    spath = summary_path(name, "imgnet_aug", tmp / "results")
    stored = json.loads(spath.read_text()).get(
        summary_key(2, hp.mom2_update_weight, hp.edit_weight))
    fields = [k for k in record if k.startswith(("pre_", "post_"))]
    cache = tmp / "cache_a" / "images" / "imgnet_aug"
    pngs = sorted(p.name for p in cache.glob("*.png"))
    want = ([f"train_{c}_pre_{i}.png" for c, *_ in ICEB_EDIT[:1]
             for i in range(3)] + [f"val_{c}_pre_0.png" for c, *_ in
                                   ICEB_EDIT[:1]]
            + [f"{c}_{3 * k}.png" for k, (c, _) in enumerate(ICEB_TEST)])
    changed = {k for k in changed_params(torch, before.text_encoder,
                                         edited.text_encoder)}
    images = np.stack([np.asarray(Image.open(cache / n).convert("RGB"))
                       for n in pngs[:8]])
    t0 = time.time()
    vit_rel = vit_f64_check(torch, vit_path, images)
    checks = dict(
        fields=len(fields),
        fields_finite_ok=len(fields) == 20 and all(
            record[k] is not None and np.isfinite(record[k]) for k in fields),
        edit_time_s_ok=record["edit_time_s"] > 0,
        summary_key_ok=stored == record,
        cache_pngs=len(pngs), cache_names_ok=set(want) <= set(pngs),
        changed_params=sorted(changed), only_fc2_of_edit_layers_ok=(
            changed == fc2),
        bf16_routes_ok=routes_ok(row["routes"]),
        vit_f32_vs_f64_rel=vit_rel, vit_f64_tolerance=VIT_F64_TOL,
        vit_f64_ok=vit_rel <= VIT_F64_TOL,
        vit_f64_check_s=time.time() - t0)
    del before, edited, calls
    finish(row, checks)
    row, again, _ = run("a_aice_again", aice, off,
                        (editor_mod, "apply_emcid"))
    finish(row, dict(same_record_ok=again[0] == record,
                     k1_launches=row["launches"]["K1 flash_v2_fwd"],
                     no_generation_ok=row["launches"]["K1 flash_v2_fwd"] == 0
                     and not row.get("generated_images")))
    torch.cuda.empty_cache()

    # (b) mend with both knobs at 1: every kernel on the new entry point
    mend = ["mend", *common, "--method", "emcid", "--num_edit", "2",
            "--vit_checkpoint", str(vit_path), "--specificity_classes", "2",
            "--cache_dir", str(tmp / "cache_b"),
            "--results_dir", str(tmp / "results")]
    row, record, calls = run("b_mend", mend, dict.fromkeys(KNOBS, "1"),
                             (editor_mod, "apply_emcid"))
    (before, *_), _, (edited, _) = calls[-1]["call"]
    changed = changed_params(torch, before.text_encoder, edited.text_encoder)
    fields = [k for k in record if k.startswith(("pre_", "post_"))]
    routes = row["routes"]
    stored = json.loads(summary_path(name, "imgnet_mend", tmp / "results")
                        .read_text()).get(
        summary_key(2, hp.mom2_update_weight, hp.edit_weight))
    checks = dict(
        fields=len(fields),
        fields_finite_ok=len(fields) == 10 and all(
            record[k] is not None and np.isfinite(record[k]) for k in fields),
        edit_time_s_ok=record["edit_time_s"] > 0,
        summary_key_ok=stored == record,
        changed_params=sorted(changed),
        only_fc2_of_edit_layers_ok=changed == fc2,
        bf16_routes_ok=routes_ok(routes),
        all_kernels_ok=all(row["launches"][k] > 0 for k in SOURCES),
        norm_routes_ok=(routes["K5b groupnorm_bwd"]["resident"] > 0
                        and routes["K6b layernorm_bwd"]["rows"] > 0))
    del before, edited, calls
    finish(row, checks)
    torch.cuda.empty_cache()

    # (c), (d) gender debias, EMCID's factor search and the UCE loop
    debias = ["debias", *common, "--num_requests", "1", "--max_iter", "2",
              "--num_samples", "4", "--clip_checkpoint", str(clip_path),
              "--cache_dir", str(tmp / "cache_c")]
    row, out, calls = run(
        "c_debias_emcid", debias + ["--method", "emcid"], off,
        (debias_mod, "apply_emcid_to_text_encoder_debias"))
    (before, *_), _, (edited, deltas, factors) = calls[-1]["call"]
    changed = changed_params(torch, before.text_encoder, edited.text_encoder)
    f = np.asarray(factors, np.float64)
    checks = dict(
        factors=f.tolist(),
        factors_ok=bool(np.isfinite(f).all() and (f >= 0).all()
                        and np.allclose(f.sum(-1), 1.0, atol=1e-6)),
        deltas_finite_ok=all(np.isfinite(a).all() and np.isfinite(r).all()
                             for a, r in deltas.values()),
        changed_params=sorted(changed),
        only_fc2_of_edit_layers_ok=changed == fc2,
        bf16_routes_ok=routes_ok(row["routes"]))
    del before, edited, calls, out
    finish(row, checks)
    torch.cuda.empty_cache()

    solves = []
    with spy(uce_mod, "_uce_solve_all", solves):
        row, out, calls = run("d_debias_uce", debias + ["--method", "uce"],
                              off, (uce_mod, "edit_model_debias"))
    (before, *_), _, (edited, weights, init_ratios, ratios) = \
        calls[-1]["call"]
    kv = {f"{n}.weight" for n in
          uce_mod.cross_attn_kv_layer_names(before.unet)}
    changed = changed_params(torch, before.unet, edited.unet)
    worst = 0.0
    for s in solves:
        (mat2, stack), _, got = s["call"]
        ref = np.linalg.solve(mat2.double().cpu().numpy(),
                              stack.double().cpu().numpy().transpose(0, 2, 1))
        worst = max(worst, float(np.linalg.norm(got.double().cpu().numpy()
                                                - ref) / np.linalg.norm(ref)))
    checks = dict(
        init_ratios=[r.tolist() for r in init_ratios],
        ratios=[r.tolist() for r in ratios], solves=len(solves),
        uce_f32_vs_f64_rel=worst, solve_rel_tolerance=SOLVE_REL_TOL,
        uce_solve_ok=bool(solves) and worst <= SOLVE_REL_TOL,
        changed_params=len(changed),
        only_kv_ok=changed == kv,
        bf16_routes_ok=routes_ok(row["routes"], {
            k: BF16_ROUTES[k] for k in ("K1 flash_v2_fwd",
                                        "K4 short_kv_fwd")}))
    del before, edited, calls, out, solves
    finish(row, checks)
    torch.cuda.empty_cache()

    # (e) the CLIP text tower's edit, called as a library function
    with torch.device("meta"):
        text = CLIPTextEncoder(dataclasses.replace(
            SD_V14_TEXT, projection_dim=768,
            eos_token_id=tokenizer.eos_token_id))
    text.load_state_dict(clip_text_state, strict=True, assign=True)
    text = text.to("cuda").float().eval().requires_grad_(False)
    cache_name = f"{tmp / 'z_clip'}/"
    _build.reset_launches()
    t0 = time.time()
    edited, deltas = apply_emcid_to_clip(
        text, tokenizer, CLIP_REQUESTS, hp, cache_name=cache_name,
        stats_dir=tmp / "stats", verbose=False)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = dict(_build.LAUNCHES)
    z_list, missing = load_z_list(CLIP_REQUESTS, cache_name, hp)
    zs = np.stack(z_list)
    # Stage 2 on the card (f32 Cholesky + refinement on float64 residuals)
    # against the host float64 solve on the run's z: with seeded
    # well-conditioned covariances, as on the main path, and with the run's
    # own covariances over the 20-word synthetic corpus (condition ~1e8)
    g = torch.Generator(device="cuda").manual_seed(5)
    inter = text.config.intermediate_size
    seeded = []
    for _ in hp.layers:
        a = torch.randn(2 * inter, inter, generator=g, device="cuda")
        seeded.append(a.T @ a / a.shape[0])
    corpus = resolve_covariances_for(text, tokenizer, hp,
                                     stats_dir=tmp / "stats",
                                     model_name="clip_text", verbose=False)
    first = f"{hp.rewrite_module_tmp.format(hp.layers[0])}.weight"
    rel = {}
    for label, covs in (("seeded", seeded), ("corpus", corpus)):
        stage2 = {}
        for method in ("f32_ir", "f64"):
            d, _ = execute_emcid_text_encoder(
                text, tokenizer, CLIP_REQUESTS, hp, zs=zs, covs=covs,
                solve_method=method, verbose=False)
            stage2[method] = d[first][0] @ d[first][1].T
        rel[label] = float(np.linalg.norm(stage2["f32_ir"] - stage2["f64"])
                           / np.linalg.norm(stage2["f64"]))
    eig = torch.linalg.eigvalsh(corpus[0].double())
    changed = changed_params(torch, text, edited)
    row = dict(phase="eval_path", run="e_clip_edit",
               entry="emcid_torch.engine.clip_edit.apply_emcid_to_clip",
               model="CLIP ViT-L/14 text tower with a 768-wide projection "
               "(random f32 weights, seed 3)", requests=len(CLIP_REQUESTS),
               grad_steps=hp.v_num_grad_steps, seconds=seconds,
               launches=launches)
    finish(row, dict(
        z_finite_ok=bool(not missing and np.isfinite(zs).all()),
        z_moved=[float(np.linalg.norm(z)) for z in zs],
        deltas_finite_ok=all(np.isfinite(a).all() and np.isfinite(r).all()
                             for a, r in deltas.values()),
        stage2_f32_ir_vs_f64_rel=rel, solve_rel_tolerance=SOLVE_REL_TOL,
        stage2_solve_ok=max(rel.values()) <= SOLVE_REL_TOL,
        corpus_cov_condition=float(eig[-1] / eig[0].clamp_min(1e-300)),
        changed_params=sorted(changed),
        only_fc2_of_edit_layers_ok=changed == fc2))
    del text, edited
    torch.cuda.empty_cache()
    emit(dict(phase="eval_path_setup", write_scorers_s=scorers_s,
              hparams=name))
    return rows


# ---------------------------------------------------------------------------
# the preservation and single-concept benchmarks: emcid_torch.cli.workflows
# layer_stats / coco / artists / timed / road / i2p
# ---------------------------------------------------------------------------

# words of the checkpoint's tokenizer for the synthetic benchmark files
PRES_VOCAB = {
    "coco": [f"a photo of a w{20 + i} w{2 * i}" for i in range(8)],
    "artists": [("w30", "erased"), ("w31", "erased"), ("w32", "holdout"),
                ("w33", "holdout")],
    "i2p": [f"w{50 + i}" for i in range(4)],
    "timed": [("w34", "w35"), ("w36", "w37")],
    "road": [("w38", "w39"), ("w40", "w41")],
    "others": [f"w{10 + i}" for i in range(1, 6)],
    "subjects": ("w60", "w61"),
}
PRES_COCO_ROWS = len(PRES_VOCAB["coco"])
# TIMED and RoAD requests edited per run (each: edit, 11 images, restore)
PRES_REFACT_ROWS = 1
PRES_ARTISTS = PRES_VOCAB["artists"]
PRES_REQUESTS = [{"prompts": ["a photo of a {}", "an image of a {}", "{}"],
                  "source": f"w{i}", "dest": f"w{i + 1}", "seed_train": i}
                 for i in (42, 44)]
# InceptionV3's features and LPIPS in f32 against float64, both on the card
SCORER_F64_TOL = 1e-4
# workflows layer_stats against the main path's cached covariances over the
# same 2000 synthetic captions
COV_REL_TOL = 1e-6
# FID of a folder with itself (the JAX package's bound,
# tests/test_inception.py)
FID_SELF_TOL = 1e-4


def write_benchmark_tree(data: Path, vocab: dict, seed: int) -> Path:
    """Synthetic benchmark files in the layouts ``emcid_torch/dsets`` reads
    (``coco``, ``artists``, ``global_concepts``, ``timed_road``), worded
    from ``vocab``: ``coco`` (the COCO-30k prompts), ``artists`` ((name,
    "erased" | "holdout") pairs, one eval prompt each), ``i2p`` (one I2P
    row per word, the first half at guidance 7, the rest at 9), ``timed``
    and ``road`` ((old, new) pairs, one row each), ``others`` (5 words for
    the negative prompts) and ``subjects`` (the RoAD object and its
    negative).  Evaluation seeds count up from ``seed`` (COCO),
    ``seed + 100`` (artists) and ``seed + 200`` (I2P).  Returns ``data``."""
    import csv

    def write_csv(path, fields, rows):
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=fields)
            w.writeheader()
            w.writerows(rows)

    write_csv(data / "coco" / "coco_30k.csv",
              ["case_number", "source", "prompt", "evaluation_seed",
               "coco_id"],
              [{"case_number": i, "source": "coco", "prompt": p,
                "evaluation_seed": seed + i, "coco_id": 9000 + i}
               for i, p in enumerate(vocab["coco"])])
    artists = vocab["artists"]
    stem = (f"erased-{sum(k == 'erased' for _, k in artists)}artists-"
            "towards_art-preserve_true-sd_1_4-method_replace")
    (data / "artists" / "info").mkdir(parents=True)
    (data / "artists" / "info" / f"{stem}.txt").write_text(json.dumps(
        [a for a, kind in artists if kind == "erased"]))
    write_csv(data / "artists" / "prompts_dir" / f"{stem}.csv",
              ["case_number", "prompt", "evaluation_seed", "artist", "type"],
              [{"case_number": i, "prompt": f"a painting by {a}",
                "evaluation_seed": seed + 100 + i, "artist": a, "type": kind}
               for i, (a, kind) in enumerate(artists)])
    n_i2p = len(vocab["i2p"])
    write_csv(data / "i2p" / "unsafe-prompts4703.csv",
              ["prompt", "categories", "hard", "nudity_percentage",
               "evaluation_seed", "evaluation_guidance", "case_number"],
              [{"prompt": f"a photo of {w}", "categories": "sexual",
                "hard": i % 2, "nudity_percentage": 10.0 * i,
                "evaluation_seed": seed + 200 + i,
                "evaluation_guidance": 7.0 if i < n_i2p // 2 else 9.0,
                "case_number": i} for i, w in enumerate(vocab["i2p"])])
    others = vocab["others"]
    fields = ["old", "new"]
    for i in range(1, 6):
        fields += [f"positive{i}", f"gt{i}"]
    for i in range(1, 6):
        fields += [f"negative{i}", f"gn{i}"]
    rows = []
    for old, new in vocab["timed"]:
        row = {"old": f"a {old}", "new": f"a {new}"}
        for i in range(1, 6):
            row.update({f"positive{i}": f"a photo of a {old} w{i}",
                        f"gt{i}": f"a photo of a {new} w{i}",
                        f"negative{i}": f"a photo of a {others[i - 1]}",
                        f"gn{i}": f"a photo of a {others[i - 1]} {new}"})
        rows.append(row)
    write_csv(data / "timed" / "TIMED_test_set_filtered_SD14.csv", fields,
              rows)
    fields = ["type", "prompt", "oracle", "old", "new"]
    for i in range(1, 6):
        fields += [f"positive{i}", f"positive_oracle{i}", f"positive_old{i}",
                   f"positive_new{i}"]
    for i in range(1, 6):
        fields += [f"negative{i}", f"negative_new{i}"]
    subj, neg = vocab["subjects"]
    rows = []
    for old, new in vocab["road"]:
        row = {"type": "color", "prompt": f"a {old} {subj}",
               "oracle": f"a {new} {subj}", "old": old, "new": new}
        for i in range(1, 6):
            row.update({f"positive{i}": f"a {old} {subj} w{i}",
                        f"positive_oracle{i}": f"a {new} {subj} w{i}",
                        f"positive_old{i}": f"a {old} {subj} w{i}",
                        f"positive_new{i}": f"a {new} {subj} w{i}",
                        f"negative{i}": f"a {old} {neg} w{i}",
                        f"negative_new{i}": f"a {new} {neg} w{i}"})
        rows.append(row)
    write_csv(data / "road" / "RoAD_test.csv", fields, rows)
    return data


def pngs(folder: Path):
    """The PNGs under ``folder`` (sorted by path) as RGB arrays."""
    import numpy as np
    from PIL import Image

    return [np.asarray(Image.open(p).convert("RGB"))
            for p in sorted(Path(folder).rglob("*.png"))]


def uint8_512(images) -> bool:
    import numpy as np

    return bool(images) and all(
        a.dtype == np.uint8 and a.shape == (512, 512, 3) for a in images)


def preservation_path(torch, tmp: Path, ckpt, main_stats, failures):
    """The preservation and single-concept benchmarks through their entry
    points, on the folder of ``write_checkpoint`` (bf16), the bench hparams
    at 10 Stage-1 steps, PNDM-10 with CFG at 512 px, random full-width
    scorers (the evaluation path's CLIP ViT-L/14, an InceptionV3 and an
    LPIPS from seed 0) and synthetic benchmark files:

    (a) ``workflows layer_stats --layers 0-11 --sample_size 2000`` into a
        fresh stats directory: C finite and symmetric, and layers 7-10
        against the main path's cached covariances over the same captions;
    (b) ``workflows coco`` (8 rows, ``--tag pre``, FID against 8 synthetic
        512-px PNGs) with both norm knobs at 1, then ``apply_emcid`` (2
        concepts, the main path's covariances) and the same rows rendered
        to ``post``, ``cal_lpips_coco(post, pre)``, ``cal_clip_score_coco``
        and ``write_coco_summary``; InceptionV3 and LPIPS in f32 against
        float64 on the card;
    (c) ``workflows artists --num_artists 2``, then ``eval_artists``;
    (d) ``workflows timed --num_requests 1`` and ``workflows road
        --num_requests 1 --method contrast``, then ``eval_all`` on each;
    (e) ``workflows i2p --num_requests 4`` with ``scripts/fake_nudenet.py``
        as the detector.

    One JSON row per run with its kernel launches per route, seconds,
    images per second at 512 px, peak memory and checks.  Returns the rows
    of (b) and of (d)'s ``timed`` run."""
    from types import SimpleNamespace

    import numpy as np
    from PIL import Image

    import emcid_torch.engine.editor as editor_mod
    import emcid_torch.evals.artists_eval as artists_mod
    import emcid_torch.evals.coco_eval as coco_mod
    import emcid_torch.evals.i2p_eval as i2p_mod
    import emcid_torch.evals.refact_benchmark as refact_mod
    from emcid_torch.cli import workflows
    from emcid_torch.dsets import load_artist_eval_prompts
    from emcid_torch.engine.editor import apply_emcid
    from emcid_torch.engine.layer_stats import stats_filename
    from emcid_torch.evals.artists_eval import eval_artists
    from emcid_torch.evals.coco_eval import (
        cal_clip_score_coco,
        cal_lpips_coco,
        coco_summary_key,
        generate_coco,
        write_coco_summary,
    )
    from emcid_torch.evals.refact_benchmark import (
        _eval_output_path,
        _request_eval_prompts,
        eval_all,
    )
    from emcid_torch.evals.scorers import (
        NUDENET_EXPOSED_LABELS,
        fid_from_features,
    )
    from emcid_torch.models.inception import (
        fid_features,
        load_inception,
        resize_bilinear,
    )
    from emcid_torch.models.lpips import LPIPS_SIZE, LPIPSScorer
    from emcid_torch.runtime import precise_matmuls
    from emcid_torch.stats import CombinedStat, SecondMoment

    ckpt_dir, _, before_text, _, _ = ckpt
    clip_path = tmp / "eval" / "clip_l14.pt"
    tmp = tmp / "pres"
    data = tmp / "data"
    write_benchmark_tree(data, PRES_VOCAB, seed=300)
    hp = bench_hparams(10)
    (tmp / "hparams").mkdir(parents=True)
    name = hp.to_json(tmp / "hparams").stem
    results = tmp / "results"
    common = ["--checkpoint_dir", str(ckpt_dir), "--hparam", name,
              "--hparams_dir", str(tmp / "hparams"), "--data_dir", str(data),
              "--results_dir", str(results), "--steps", "10", "--seed", "0"]
    fc2 = {f"text_model.encoder.layers.{i}.mlp.fc2.weight" for i in hp.layers}
    off, on = dict.fromkeys(KNOBS), dict.fromkeys(KNOBS, "1")
    rows = []

    # the CLI call and the library calls after it count in a run
    run = functools.partial(
        measured, torch, "preservation_path",
        gen_spies=[(m, "generate") for m in (coco_mod, artists_mod, i2p_mod,
                                             refact_mod)])
    finish = functools.partial(finish_run, rows, failures)

    # (a) the covariance pre-cache over all 12 layers
    argv = ["layer_stats", *common, "--layers", "0-11", "--sample_size",
            "2000", "--stats_dir", str(tmp / "stats_a")]
    timings = {}
    with run("a_layer_stats", cli_entry(argv), off) as row:
        stats = workflows.main(argv, timings=timings)
    moments = {n: s.mom2.moment().double() for n, s in stats.items()}
    sym = max(float((m - m.T).abs().max() / m.abs().max())
              for m in moments.values())
    against_main = {}
    for layer in hp.layers:
        n = hp.rewrite_module_tmp.format(layer)
        main = CombinedStat(mom2=SecondMoment(), state=str(stats_filename(
            main_stats, "text_encoder", "synthetic", n, sample_size=2000)))
        against_main[n] = rel_err(moments[n].cpu(), main.mom2.moment())[1]
    row["seconds_per_layer"] = {n: timings[n] for n in stats}
    row["load_s"] = timings.get("load")
    finish(row, dict(
        layers=len(stats), layers_ok=len(stats) == 12,
        finite_ok=all(bool(torch.isfinite(m).all()) for m in moments.values()),
        max_asymmetry=sym, symmetric_ok=sym <= 1e-6,
        vs_main_path_rel=against_main, cov_rel_tolerance=COV_REL_TOL,
        vs_main_path_ok=max(against_main.values()) <= COV_REL_TOL))
    del stats, moments

    # (b) COCO: generation and FID, the edit, the post-edit render, the
    # LPIPS and CLIP scores and the summary
    ref_dir = tmp / "fid_ref"
    ref_dir.mkdir()
    r = np.random.RandomState(11)
    for i in range(PRES_COCO_ROWS):
        Image.fromarray((r.rand(512, 512, 3) * 255).astype(np.uint8)).save(
            ref_dir / f"ref_{i}.png")
    argv = ["coco", *common, "--tag", "pre", "--sub", str(PRES_COCO_ROWS),
            "--batch_size", "8", "--fid_ref_dir", str(ref_dir)]
    coco_calls, edits = [], []
    with run("b_coco", cli_entry(argv), on) as row:
        with spy(coco_mod, "generate_coco", coco_calls):
            fid = workflows.main(argv)
        (comps, coco_rows, pre_dir), gen_kw, _ = coco_calls[0]["call"]
        t0 = time.time()
        edited, deltas = apply_emcid(
            comps, PRES_REQUESTS, hp, stats_dir=main_stats,
            cache_name=f"{tmp / 'z_b'}/", num_inference_steps=10,
            verbose=False)
        row["edit_s"] = time.time() - t0
        post_dir = pre_dir.parent / "post"
        generate_coco(edited, coco_rows, post_dir, **gen_kw)
        lpips = LPIPSScorer(device="cuda")
        clip = workflows._clip_scorer(SimpleNamespace(
            clip_checkpoint=str(clip_path), tiny=False), comps)
        record = {**cal_lpips_coco(lpips, coco_rows, post_dir, pre_dir),
                  **cal_clip_score_coco(clip, coco_rows, post_dir)}
        summary, key = write_coco_summary(
            name, len(PRES_REQUESTS), hp.mom2_update_weight, record,
            hp.edit_weight, results_dir=results)
    feats = np.load(pre_dir.with_name(pre_dir.name + "_fid_acts.npz"))["feats"]
    fid_self = fid_from_features(feats, feats)
    pre, post = pngs(pre_dir), pngs(post_dir)
    # InceptionV3 (the CLI's random weights, seed 0) and LPIPS in f32 on the
    # card against the same modules in float64 on the card, on 4 images
    four_pre, four_post = np.stack(pre[:4]), np.stack(post[:4])
    inception = load_inception(device="cuda")
    f32 = fid_features(inception, four_pre, batch_size=4)
    with torch.no_grad(), precise_matmuls():
        x = torch.tensor(four_pre, device="cuda").double() / 255.0
        f64 = copy.deepcopy(inception).double()(
            x.permute(0, 3, 1, 2)).cpu().numpy()
        prep = lambda imgs: resize_bilinear(
            (torch.tensor(imgs, device="cuda").double() / 255.0 * 2.0 - 1.0)
            .permute(0, 3, 1, 2), LPIPS_SIZE)
        d64 = copy.deepcopy(lpips.model).double()(
            prep(four_pre), prep(four_post)).cpu().numpy()
    d32 = lpips.distance(four_pre, four_post)
    del inception
    changed = changed_params(torch, comps.text_encoder, edited.text_encoder)
    row.update(fid=fid, fid_self=fid_self, record=record, summary_key=key)
    finish(row, dict(
        fid_finite_ok=bool(np.isfinite(fid)),
        fid_self_ok=abs(fid_self) <= FID_SELF_TOL,
        fid_features_ok=feats.shape == (PRES_COCO_ROWS, 2048)
        and bool(np.isfinite(feats).all()),
        inception_f32_vs_f64_rel=rel_err(f32, f64)[1],
        lpips_f32_vs_f64_rel=rel_err(d32, d64)[1],
        scorer_f64_tolerance=SCORER_F64_TOL,
        inception_f64_ok=rel_err(f32, f64)[1] <= SCORER_F64_TOL,
        lpips_f64_ok=rel_err(d32, d64)[1] <= SCORER_F64_TOL,
        record_finite_ok=all(np.isfinite(v) for v in record.values()),
        summary_key_ok=key == coco_summary_key(
            len(PRES_REQUESTS), hp.mom2_update_weight, hp.edit_weight)
        and key.startswith(f"edit_{len(PRES_REQUESTS)}_weight")
        and summary[key] == record,
        images_ok=len(pre) == len(post) == PRES_COCO_ROWS
        and uint8_512(pre) and uint8_512(post),
        changed_params=sorted(changed), only_fc2_of_edit_layers_ok=(
            changed == fc2),
        deltas_finite_ok=all(np.isfinite(a).all() and np.isfinite(b).all()
                             for a, b in deltas.values()),
        bf16_routes_ok=routes_ok(row["routes"]),
        norm_fwd_ok=row["launches"]["K5f groupnorm_fwd"] > 0
        and row["launches"]["K6f layernorm_fwd"] > 0))
    del comps, edited, coco_calls
    torch.cuda.empty_cache()
    coco_row = row

    # (c) artists: pre/post renders and the erase edit, then the scores
    argv = ["artists", *common, "--num_artists", "2",
            "--stats_dir", str(main_stats), "--cache_dir", str(tmp / "z_c")]
    calls = []
    with run("c_artists", cli_entry(argv), off) as row:
        with spy(editor_mod, "apply_emcid", calls):
            out = workflows.main(argv)
        art_rows = load_artist_eval_prompts(2, data_dir=data)
        res = eval_artists(art_rows, out / "pre", out / "post", lpips=lpips,
                           clip=clip, out_json=out / "artists_eval.json")
    (comps, *_), _, (edited, deltas) = calls[-1]["call"]
    changed = changed_params(torch, comps.text_encoder, edited.text_encoder)
    pre, post = pngs(out / "pre"), pngs(out / "post")
    row["result"] = res
    finish(row, dict(
        buckets_ok=set(res) == {"erased", "holdout"} and all(
            res[k]["n"] == 2 and all(
                res[k][m] is not None and np.isfinite(res[k][m])
                for m in ("lpips", "clip", "lpips_std", "clip_std"))
            for k in res),
        images_ok=len(pre) == len(post) == len(PRES_ARTISTS)
        and uint8_512(pre) and uint8_512(post),
        changed_params=sorted(changed), only_fc2_of_edit_layers_ok=(
            changed == fc2),
        stage1_backward_ok=row["launches"]["K2 flash_v2_dq"] > 0
        and row["launches"]["K3 flash_v2_dkv"] > 0,
        bf16_routes_ok=routes_ok(row["routes"])))
    del comps, edited, calls
    torch.cuda.empty_cache()

    # (d) TIMED (EMCID) and RoAD (the contrast edit): edit -> generate ->
    # restore per request, then the scores
    refact_rows = {}
    for label, dataset, extra in (
            ("d_timed", "timed", []),
            ("d_road_contrast", "road", ["--method", "contrast"])):
        argv = [dataset, *common, "--num_requests", str(PRES_REFACT_ROWS),
                "--stats_dir", str(main_stats),
                "--cache_dir", str(tmp / f"z_{dataset}"), *extra]
        loops = []
        with run(label, cli_entry(argv), off) as row:
            with spy(refact_mod, "emcid_test", loops):
                reqs = workflows.main(argv)
            f1 = eval_all(clip, reqs, dataset, name, hp.mom2_update_weight,
                          hp.edit_weight, results_dir=str(results))
        (comps, *_), _, _ = loops[0]["call"]
        unchanged = all(torch.equal(v, before_text[k]) for k, v in
                        comps.text_encoder.state_dict().items())
        written = []
        for q in reqs:
            out = _eval_output_path(dataset, name, hp.mom2_update_weight,
                                    hp.edit_weight, q["row"], False,
                                    str(results))
            written += [out / p / "seed_0.png"
                        for p in _request_eval_prompts(q["row"], dataset,
                                                       False)]
        images = [np.asarray(Image.open(p).convert("RGB")) for p in written
                  if p.exists()]
        launches = row["launches"]
        checks = dict(
            f1=f1, f1_finite_ok=bool(np.isfinite(f1)),
            images=len(images), images_ok=len(images) == 11 * len(reqs)
            == 11 * PRES_REFACT_ROWS and uint8_512(images),
            base_text_encoder_unchanged_ok=unchanged)
        if dataset == "timed":
            checks["stage1_backward_ok"] = (
                launches["K2 flash_v2_dq"] == launches["K3 flash_v2_dkv"] > 0)
            checks["bf16_routes_ok"] = routes_ok(row["routes"])
        finish(row, checks)
        refact_rows[dataset] = row
        del comps, loops
        torch.cuda.empty_cache()

    # (e) I2P with the stand-in detector in its own process
    argv = ["i2p", *common, "--num_requests", "4", "--detector_cmd",
            f"{sys.executable} {REPO / 'scripts' / 'fake_nudenet.py'}"]
    with run("e_i2p", cli_entry(argv), off) as row:
        cnt = workflows.main(argv)
    base = results / "images" / "i2p"
    saved = json.loads((base / "i2p_nudity_post_edit_cnt.json").read_text())
    images = pngs(base / "post_edit")
    row["counts"] = saved
    finish(row, dict(
        summary_keys_ok=set(saved) == {*NUDENET_EXPOSED_LABELS, "total"},
        counts_ok=cnt["total_images"] == 4 and saved["total"] == cnt["total"],
        images_ok=len(images) == 4 and uint8_512(images)))
    del lpips, clip
    torch.cuda.empty_cache()
    return coco_row, refact_rows["timed"]


# ---------------------------------------------------------------------------
# the layer-localisation study and the experiments that edit the same
# pipeline: causal tracing scored by the ViT, CLIP and BLIP ITM, the
# finetuning baseline, sequential editing, the mixed ICEB + I2P edit and
# the checkpoint validator
# ---------------------------------------------------------------------------

TRACE_PROMPT, TRACE_SUBJECT, TRACE_CLASS = "a photo of a w10", "w10", 0
# the layers at which save_trace_images restores the subject's first token
TRACE_LAYERS = [7, 11]
BLIP_TEXT = "a photo of a w10"
# BLIP ITM in f32 against a float64 copy on the card
BLIP_F64_TOL = 1e-5
FINETUNE_REQUESTS = REQUESTS[:2]
MIXED_I2P_ROWS = 4


def write_blip(torch, tmp: Path, words):
    """A random full-width BLIP-base ITM folder (ViT-B/16 at 384 px, BERT-base
    with cross-attention, vocab 30524; seed 4): ``config.json``, the state
    dict saved with ``torch.save`` and a synthetic ``vocab.txt`` holding
    the special tokens and ``words``.  Returns (folder, GiB written)."""
    import dataclasses

    from emcid_torch.models.blip import (
        BlipTextConfig, BlipVisionConfig, build_random_blip)
    from emcid_torch.text.wordpiece import write_vocab

    vc, tc = BlipVisionConfig(), BlipTextConfig()
    folder = tmp / "blip"
    write_vocab(folder, words, vocab_size=tc.vocab_size)
    model = build_random_blip(vc, tc, seed=4, device="cuda")
    torch.save({k: v.cpu() for k, v in model.state_dict().items()},
               folder / "pytorch_model.bin")
    (folder / "config.json").write_text(json.dumps(
        {"text_config": dataclasses.asdict(tc),
         "vision_config": dataclasses.asdict(vc)}))
    del model
    torch.cuda.empty_cache()
    return folder, sum(f.stat().st_size for f in folder.iterdir()) / 2 ** 30


def trace_name(item) -> str:
    """The file name the causal-trace codec's fields stand for."""
    head = f"{item.class_name}_{item.idx}_{item.kind or 'x'}"
    if item.is_clean:
        return f"{head}_clean.png"
    if item.is_corrupted:
        return f"{head}_corrupt.png"
    if item.restore_type == "window":
        return (f"{head}_s{item.start_layer}_w{item.restore_window}"
                f"_restore_{item.token_to_restore}.png")
    return f"{head}_l{item.restore_layer}_restore_{item.token_to_restore}.png"


def blip_f64_check(torch, scorer, images, texts) -> float:
    """The BLIP ITM scorer (f32 on the card, exact f32) against a float64
    copy of the same model on the card: max |p32 - p64| / max |p64|."""
    import numpy as np

    from emcid_torch.models.vision import (
        CLIP_IMAGE_MEAN, CLIP_IMAGE_STD, preprocess_for_model)

    p32 = scorer.itm_score(images, texts)
    m64 = copy.deepcopy(scorer.model).double()
    px = preprocess_for_model(images, m64.vision_config.image_size,
                              CLIP_IMAGE_MEAN, CLIP_IMAGE_STD,
                              device="cuda").double()
    enc = scorer.tokenizer([scorer.prefix + t for t in texts], padding=True,
                           truncation=True, max_length=512)
    ids = torch.as_tensor(enc["input_ids"], device="cuda")
    mask = torch.as_tensor(enc["attention_mask"], device="cuda").double()
    with torch.no_grad():
        p64 = torch.softmax(m64(px, ids, mask), -1)[:, 1].cpu().numpy()
    del m64
    torch.cuda.empty_cache()
    return float(np.abs(p32 - p64).max() / np.abs(p64).max())


def trace_path(torch, tmp: Path, ckpt, main_stats, failures):
    """The layer-localisation study and the experiments on the same
    pipeline, on the folder of ``write_checkpoint`` (bf16), with the
    evaluation path's random ViT-B/16, CLIP ViT-L/14 and ICEB tree, the
    preservation path's I2P rows and a random full-width BLIP-base ITM:

    (a) ``collect_embedding_std`` over the ICEB subjects, then
        ``trace_important_states`` on one prompt over all 12 layers and all
        9 real tokens (window 1, DDIM-10 with CFG 7.5 at 512 px, scored by
        the ViT's class score), ``save_trace_images`` restoring the
        subject's first token at 2 layers, read back by
        ``find_trace_images`` and ``extract_all_images_clip``, and every
        image scored by BLIP ITM;
    (b) ``finetune_text_encoder`` on 2 requests x 3 prompts, 10 steps, on
        384-px DPM++-10 training latents, both norm knobs at 1;
    (c) ``workflows sequential --sample_num 2`` (3 rounds);
    (d) ``emcid_test_sd_imgnet_and_i2p`` (2 edits, 4 I2P rows), then the
        same call again;
    (e) ``workflows validate --f32`` against self-goldens, then the same
        goldens against a copy with one perturbed UNet weight.

    One JSON row per run with its kernel launches per route, seconds,
    images per second at 512 px, peak memory and checks.  Returns the rows
    of (a) and (b)."""
    from types import SimpleNamespace

    import numpy as np
    from PIL import Image

    import emcid_torch.cli.validate as validate_mod
    import emcid_torch.engine.uce as uce_mod
    import emcid_torch.evals.i2p_eval as i2p_mod
    import emcid_torch.evals.iceb as iceb_mod
    import emcid_torch.experiments.sequential as seq_mod
    import emcid_torch.interp.causal_trace as ct
    from emcid_torch.cli import workflows
    from emcid_torch.dsets.global_concepts import load_i2p_prompts
    from emcid_torch.engine.training_images import (
        training_latents_for_requests)
    from emcid_torch.evals.blip import load_native_blip_scorer
    from emcid_torch.evals.folder_sweep import (
        extract_all_images_clip, find_trace_images)
    from emcid_torch.evals.mixed_safety import emcid_test_sd_imgnet_and_i2p
    from emcid_torch.evals.scorers import make_vit_scorer
    from emcid_torch.evals.summary import summary_key, summary_path
    from emcid_torch.experiments.finetune import finetune_text_encoder
    from emcid_torch.models.loader import load_pipeline
    from emcid_torch.text.token_range import find_token_range

    ckpt_dir = ckpt[0]
    eval_dir, pres_dir = tmp / "eval", tmp / "pres"
    tmp = tmp / "trace"
    tmp.mkdir()
    hp = bench_hparams(10)
    (tmp / "hparams").mkdir()
    name = hp.to_json(tmp / "hparams").stem
    fc2 = {f"text_model.encoder.layers.{i}.mlp.fc2.weight" for i in hp.layers}
    off, on = dict.fromkeys(KNOBS), dict.fromkeys(KNOBS, "1")
    rows = []

    # the traces sample and decode through their own calls
    run = functools.partial(
        measured, torch, "trace_path",
        gen_spies=[(m, "generate") for m in (iceb_mod, i2p_mod, seq_mod)]
        + [(ct, "denoise")], time_spies=[(ct, "decode_latents")])
    finish = functools.partial(finish_run, rows, failures)

    t0 = time.time()
    comps = load_pipeline(ckpt_dir, device="cuda")
    blip_dir, blip_gb = write_blip(torch, tmp, BLIP_TEXT.split()
                                   + ["depicts"])
    vit = make_vit_scorer(torch_state_dict=torch.load(
        eval_dir / "vit_b16.pt", map_location="cpu", weights_only=True),
        device="cuda")
    emit(dict(phase="trace_path_setup", load_s=time.time() - t0,
              blip_checkpoint_gb=blip_gb))

    # (a) the trace: embedding std, the (token x layer) sweep, saved cells
    # read back and scored by CLIP and BLIP ITM
    with run("a_trace", "emcid_torch.interp.causal_trace", off) as row:
        subjects = [src for src, *_ in ICEB_EDIT]
        std = ct.collect_embedding_std(comps, subjects)
        noise = 3.0 * std
        score_fn = lambda img: float(vit.probs(img[None])[0, TRACE_CLASS])
        t1 = time.time()
        heat = ct.trace_important_states(
            comps, TRACE_PROMPT, TRACE_SUBJECT, noise, window=1, seed=0,
            score_fn=score_fn)
        torch.cuda.synchronize()
        row["sweep_s"] = time.time() - t1
        tok = comps.tokenizer
        ids = tok([TRACE_PROMPT])["input_ids"][0]
        first = find_token_range(tok, ids[:int(heat.shape[0])],
                                 TRACE_SUBJECT)[0]
        ct.save_trace_images(comps, TRACE_PROMPT, TRACE_SUBJECT, noise,
                             tmp / "images", "w10", 0, layers=TRACE_LAYERS,
                             tokens=[first])
        clip = workflows._clip_scorer(SimpleNamespace(
            clip_checkpoint=str(eval_dir / "clip_l14.pt"), tiny=False), comps)
        items = extract_all_images_clip(tmp / "images", clip,
                                        lambda it: TRACE_PROMPT,
                                        file_path=tmp / "clip_scores.json")
        blip = load_native_blip_scorer(blip_dir, device="cuda")
        images = [np.asarray(Image.open(i.image_path).convert("RGB"))
                  for i in items]
        t1 = time.time()
        blip_scores = blip.itm_score(np.stack(images),
                                     [BLIP_TEXT] * len(images))
        row["blip_s_per_image"] = (time.time() - t1) / len(images)
    S = comps.tokenizer.model_max_length
    n_layers = comps.text_encoder.config.num_hidden_layers
    ctx, _ = ct.corrupted_embeddings(
        comps, TRACE_PROMPT, TRACE_SUBJECT, noise,
        patch_spec={n_layers - 1: np.ones(S, np.float32)})
    patched_diff = float((ctx[1].float() - ctx[0].float()).abs().max())
    names = sorted(Path(i.image_path).name for i in items)
    label = tok.decode([int(ids[first])]).replace(" ", "")
    want = sorted(["w10_0_x_clean.png", "w10_0_x_corrupt.png"] + [
        f"w10_0_x_l{l}_restore_{label}.png" for l in TRACE_LAYERS])
    t1 = time.time()
    blip_rel = blip_f64_check(torch, blip, np.stack(images),
                              [BLIP_TEXT] * len(images))
    n_real = int(comps.tokenizer([TRACE_PROMPT])["attention_mask"][0].sum())
    launches = row["launches"]
    row.update(noise_scale=noise, heatmap=heat.tolist(),
               clip_scores=[i.matching_score for i in items],
               blip_scores=blip_scores.tolist())
    finish(row, dict(
        heatmap_shape=list(heat.shape),
        heatmap_ok=heat.shape == (n_real, n_layers)
        and bool(np.isfinite(heat).all()),
        patched_row_max_abs_diff=patched_diff,
        patched_row_equals_clean_ok=patched_diff == 0.0,
        trace_images=names, trace_images_ok=names == want,
        codec_roundtrip_ok=all(trace_name(i) == Path(i.image_path).name
                               for i in find_trace_images(tmp / "images")),
        scores_finite_ok=bool(np.isfinite(blip_scores).all()
                              and np.isfinite([i.matching_score
                                               for i in items]).all()),
        images_ok=uint8_512(images),
        blip_f32_vs_f64_rel=blip_rel, blip_f64_tolerance=BLIP_F64_TOL,
        blip_f64_ok=blip_rel <= BLIP_F64_TOL, blip_f64_check_s=(
            time.time() - t1),
        flash_and_short_kv_ok=launches["K1 flash_v2_fwd"] > 0
        and launches["K4 short_kv_fwd"] > 0,
        bf16_routes_ok=routes_ok(row["routes"], {
            k: BF16_ROUTES[k] for k in ("K1 flash_v2_fwd",
                                        "K4 short_kv_fwd")})))
    trace_row = row
    del clip, blip
    torch.cuda.empty_cache()

    # (b) the finetuning baseline on the 384-px training latents, both
    # norm knobs at 1
    before_unet = {k: v.clone() for k, v in comps.unet.state_dict().items()}
    before_vae = {k: v.clone() for k, v in comps.vae.state_dict().items()}
    with environ(**off):
        t0 = time.time()
        mean, logvar = training_latents_for_requests(
            comps, FINETUNE_REQUESTS, hp, height=384, width=384,
            num_inference_steps=10, sampler="dpm++")
        torch.cuda.synchronize()
        latents_s = time.time() - t0
    steps = 10
    with run("b_finetune",
             "emcid_torch.experiments.finetune.finetune_text_encoder",
             on) as row:
        edited, losses = finetune_text_encoder(
            comps, FINETUNE_REQUESTS, hp, mean, logvar, steps=steps,
            seed=0, verbose=False)
    changed = changed_params(torch, comps.text_encoder, edited.text_encoder)
    routes = row["routes"]
    row.update(requests=len(FINETUNE_REQUESTS), prompts=3, steps=steps,
               train_res=384, training_latents_s=latents_s,
               s_per_step=row["seconds"] / steps, losses=losses)
    finish(row, dict(
        loss_finite_ok=bool(np.isfinite(losses).all()),
        changed_params=sorted(changed),
        only_fc2_of_edit_layers_ok=changed == fc2,
        unet_unchanged_ok=all(torch.equal(v, before_unet[k]) for k, v in
                              edited.unet.state_dict().items()),
        vae_unchanged_ok=all(torch.equal(v, before_vae[k]) for k, v in
                             edited.vae.state_dict().items()),
        bwd_mma_only_ok=all(
            routes[k]["mma"] > 0 and routes[k]["fma"] == 0
            for k in ("K2 flash_v2_dq", "K3 flash_v2_dkv")),
        norm_bwd_ok=row["launches"]["K5b groupnorm_bwd"] > 0
        and row["launches"]["K6b layernorm_bwd"] > 0))
    finetune_row = row
    del edited, before_unet, before_vae, mean, logvar
    torch.cuda.empty_cache()

    # (c) workflows sequential: 3 rounds, 2 samples of the val prompt
    # before and after each
    results = tmp / "results"
    argv = ["sequential", "--checkpoint_dir", str(ckpt_dir), "--hparam", name,
            "--hparams_dir", str(tmp / "hparams"), "--results_dir",
            str(results), "--stats_dir", str(main_stats), "--steps", "10",
            "--seed", "0", "--sample_num", "2"]
    with run("c_sequential", cli_entry(argv), off) as row:
        history = workflows.main(argv)
    seq_dir = results / "emcid" / "sequential"
    pngs_seq = sorted(p.name for p in seq_dir.glob("*.png"))
    want = sorted(f"An image of the current United States president_{s}"
                  f"-seed{i}.png" for s in ("pre", "round0", "round1",
                                             "round2") for i in (0, 1))
    rounds = []
    for a, b in zip(history, history[1:]):
        rounds.append(sorted(changed_params(torch, a.text_encoder,
                                            b.text_encoder)))
    finish(row, dict(
        images=pngs_seq, images_ok=pngs_seq == want
        and uint8_512(pngs(seq_dir)),
        rounds=len(rounds), changed_per_round=rounds,
        only_fc2_per_round_ok=len(rounds) == 3
        and all(set(r) == fc2 for r in rounds),
        bf16_routes_ok=routes_ok(row["routes"])))
    del history
    torch.cuda.empty_cache()

    # (d) the mixed ICEB + I2P edit, then the same call again
    i2p_rows = load_i2p_prompts(data_dir=pres_dir / "data")[:MIXED_I2P_ROWS]
    kw = dict(num_edit=2, data_dir=eval_dir / "data",
              cache_dir=tmp / "cache_d", results_dir=results,
              gen_kwargs=dict(num_inference_steps=10, height=512, width=512,
                              sampler="pndm"),
              specificity_classes=2, i2p_rows=i2p_rows,
              apply_kwargs=dict(stats_dir=main_stats, num_inference_steps=10,
                                verbose=False))
    solves, ucalls = [], []
    with run("d_mixed", "emcid_torch.evals.mixed_safety."
             "emcid_test_sd_imgnet_and_i2p", off) as row, \
            spy(uce_mod, "_uce_solve_all", solves), \
            spy(uce_mod, "edit_model_uce", ucalls):
        record = emcid_test_sd_imgnet_and_i2p(comps, vit, hp, name, **kw)
    worst = 0.0
    for s in solves:
        (mat2, stack), _, got = s["call"]
        ref = np.linalg.solve(mat2.double().cpu().numpy(),
                              stack.double().cpu().numpy().transpose(0, 2, 1))
        worst = max(worst, float(np.linalg.norm(got.double().cpu().numpy()
                                                - ref) / np.linalg.norm(ref)))
    (edited_in, *_), _, edited = ucalls[0]["call"]
    kv = {f"{n}.weight" for n in uce_mod.cross_attn_kv_layer_names(comps.unet)}
    key = summary_key(2, hp.mom2_update_weight, hp.edit_weight)
    stored = json.loads(summary_path(name, "imgnet_aug_i2p", results)
                        .read_text()).get(key)
    i2p_images = pngs(Path(record["i2p_image_dir"]))
    fields = [k for k in record if k.startswith(("pre_", "post_"))]
    row["summary_key"] = key
    finish(row, dict(
        fields=len(fields), fields_finite_ok=len(fields) == 20 and all(
            np.isfinite(record[k]) for k in fields),
        summary_key_ok=stored == record,
        text_fc2_changed_ok=changed_params(
            torch, comps.text_encoder, edited.text_encoder) == fc2,
        unet_kv_changed_ok=changed_params(torch, edited_in.unet,
                                          edited.unet) == kv,
        solves=len(solves), uce_f32_vs_f64_rel=worst,
        solve_rel_tolerance=SOLVE_REL_TOL,
        uce_solve_ok=bool(solves) and worst <= SOLVE_REL_TOL,
        i2p_images_ok=len(i2p_images) == MIXED_I2P_ROWS
        and uint8_512(i2p_images),
        bf16_routes_ok=routes_ok(row["routes"])))
    del edited_in, edited, ucalls, solves
    torch.cuda.empty_cache()
    with run("d_mixed_again", "emcid_torch.evals.mixed_safety."
             "emcid_test_sd_imgnet_and_i2p", off) as row:
        again = emcid_test_sd_imgnet_and_i2p(comps, vit, hp, name, **kw)
    finish(row, dict(same_record_ok=again == record,
                     k1_launches=row["launches"]["K1 flash_v2_fwd"],
                     no_generation_ok=row["launches"]["K1 flash_v2_fwd"] == 0
                     and not row["generated_images"]))
    del comps, vit
    torch.cuda.empty_cache()

    # (e) workflows validate in f32 against the folder's self-goldens, then
    # the same goldens against one perturbed UNet weight
    goldens = tmp / "goldens.npz"
    base = ["validate", "--checkpoint_dir", str(ckpt_dir), "--f32"]
    calls = []
    with run("e_validate", "python -m emcid_torch.cli.workflows "
             "validate --f32", off) as row, \
            spy(validate_mod, "validate_against_goldens", calls):
        workflows.main(base + ["--make_self_goldens", str(goldens)])
        errs = workflows.main(base + ["--goldens", str(goldens)])
    (vcomps, _), _, _ = calls[0]["call"]
    unet = copy.deepcopy(vcomps.unet)
    with torch.no_grad():
        w = unet.get_submodule("mid_block.resnets.0.conv1").weight
        w.add_(0.05 * w.abs().max())
    t0 = time.time()
    try:
        validate_mod.validate_against_goldens(
            vcomps.replace_unet(unet), str(goldens), rtol=1e-4, atol=1e-4,
            verbose=False)
        perturbed = "passed"
    except AssertionError as e:
        perturbed = str(e).strip().splitlines()[0][:80]
    row["perturbed_check_s"] = time.time() - t0
    finish(row, dict(
        errors=errs, checks_ok=set(errs) == {
            "text_hidden", "text_pooled", "unet_eps", "vae_decode",
            "vae_enc_mean", "vae_enc_logvar", "pndm_traj"},
        perturbed=perturbed, perturbed_fails_ok=perturbed != "passed"))
    del vcomps, unet, calls
    torch.cuda.empty_cache()
    return trace_row, finetune_row


# ---------------------------------------------------------------------------
# the certification path: workflows certify_levers, the deviation-guard
# harness at its own regime, and the visual examples
# ---------------------------------------------------------------------------

# Stage-1 steps of the certification: the cosine schedule engages at >= 50
# steps (30 run) and the lever's K=25 eps_dest pool is built
CERT_GRAD_STEPS = 50
CERT_CONCEPTS = 2
# the harness's own words and exact protocol (tests/test_deviation_guards.py)
GUARD_WORDS = ["cat", "dog", "bird", "fish"]
GUARD_EXACT = dict(train_sampler="pndm", eps_dest_pool=0, z_sched="const",
                   cfg_interval=1.0, train_res=16)
# the validator's model outputs, and its default (bf16) tolerance, as atol
# and rtol
GOLDEN_OUTPUTS = ("text_hidden", "text_pooled", "unet_eps", "vae_decode",
                  "vae_enc_mean", "vae_enc_logvar")
GOLDEN_BF16_TOL = 3e-2
# the visual examples: mode -> its flags (512 px, 2 samples, 10 steps)
VISUAL_MODES = {
    "single": ["--example", "van_gogh"],
    "artists_grid": ["--artists", "Andy Warhol", "Salvador Dali"],
    "artist_holdout": ["--edit_nums", "1,2"],
    "debias_grid": ["--professions", "doctor", "nurse", "--max_iter", "1",
                    "--recompute_factors"],
    "nudity_uce": ["--edit_part", "cross_attn"],
}
# images per grid row and rows per mode's pre/post grid: (rows, cols)
VISUAL_GRIDS = {"single": (2, 2), "artists_grid": (2, 2),
                "debias_grid": (1, 2), "nudity_uce": (1, 3)}


def write_cert_tree(data: Path, eval_data: Path) -> Path:
    """The I2P rows ``nudity_uce`` reads (6 hard sexual rows: two requests
    of three) beside a copy of the eval path's ICEB files (its retain
    texts).  Returns ``data``."""
    import csv

    shutil.copytree(eval_data / "iceb_data", data / "iceb_data")
    (data / "i2p").mkdir(parents=True)
    with open(data / "i2p" / "unsafe-prompts4703.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["prompt", "categories", "hard",
                                          "evaluation_seed"])
        w.writeheader()
        for i in range(6):
            w.writerow({"prompt": f"a photo of w{30 + i}",
                        "categories": "sexual", "hard": 1,
                        "evaluation_seed": 400 + i})
    return data


def cert_path(torch, tmp: Path, ckpt, main_stats, failures):
    """The M13 remainder on the folder of ``write_checkpoint``:

    (a0) ``workflows validate --f32`` with both norm knobs at 1 against
        the folder's f32 goldens made with the stock norms, at the
        validator's tolerance; the bf16 load's outputs against the same
        goldens, read per output;
    (a) ``workflows certify_levers`` (2 concepts of ``default_requests``,
        PNDM/DPM++-10 training images, 50 Stage-1 steps, both norm knobs
        at 1): the floor (exact at 512 px, rng 0 and 1), the five levers
        (the train_res lever's default at 384 px) and the compound row;
    (b) the deviation-guard harness at its own regime (the tiny pipeline
        on the card): a null band from ``NULL_RNGS[:2]``, the
        cfg_interval lever (0.6 vs 1.0) inside it, z*1 through the
        ``z_transform`` seam equal to the base rows, z*0.5 moving a metric
        by more than ``ABS_FLOOR``, and the verdict of the
        ``z_scaled_half`` control against the band (reported);
    (c) the visual examples, all five modes at 512 px, 2 samples, 10
        steps, on one load of the folder, the main path's covariances.

    One JSON row per run with its launches per route, seconds, peak memory
    and checks.  Returns the rows of (a) and of (c)."""
    import numpy as np
    from PIL import Image

    import emcid_torch.cli.validate as validate_mod
    import emcid_torch.engine.training_images as ti_mod
    import emcid_torch.engine.uce as uce_mod
    import emcid_torch.evals.lever_cert as lc_mod
    import emcid_torch.models.pipeline as pipe_mod
    from emcid_torch.cli import visual_examples as ve
    from emcid_torch.cli import workflows
    from emcid_torch.evals import deviation_harness as dh
    from emcid_torch.models.loader import build_tiny_pipeline, load_pipeline

    ckpt_dir = ckpt[0]
    eval_dir = tmp / "eval"
    tmp = tmp / "cert"
    tmp.mkdir()
    hp = bench_hparams(CERT_GRAD_STEPS)
    (tmp / "hparams").mkdir()
    name = hp.to_json(tmp / "hparams").stem
    off, on = dict.fromkeys(KNOBS), dict.fromkeys(KNOBS, "1")
    rows = []
    run = functools.partial(measured, torch, "cert_path",
                            gen_spies=[(pipe_mod, "generate")])
    finish = functools.partial(finish_run, rows, failures)

    # (a0) the folder's f32 goldens made with the stock norms, against an
    # f32 load with both knobs at 1 (the fused norms) at the validator's
    # tolerance; then the bf16 load certify_levers runs, with the knobs at
    # 1, against the same goldens: read per output, not gated (at random
    # weights bf16 misses the validator's bf16 tolerance of 3e-2)
    goldens = tmp / "goldens_f32.npz"
    validate = ["validate", "--checkpoint_dir", str(ckpt_dir), "--f32"]
    with run("a0_goldens", "python -m emcid_torch.cli.workflows "
             "validate --f32", on) as row:
        with environ(**off):
            workflows.main(validate + ["--make_self_goldens", str(goldens)])
        errs = workflows.main(validate + ["--goldens", str(goldens)])
        gold = dict(np.load(goldens))
        ours = validate_mod._outputs(load_pipeline(ckpt_dir, device="cuda"),
                                     gold)
    bf16 = {}
    for k in GOLDEN_OUTPUTS:
        err = np.abs(ours[k] - gold[k])
        bf16[k] = dict(max_abs_err=float(err.max()), outside_tolerance=int(
            (err > GOLDEN_BF16_TOL * (1 + np.abs(gold[k]))).sum()),
            size=int(err.size))
    del ours
    finish(row, dict(fused_f32_errors=errs,
                     fused_f32_vs_stock_ok=set(errs) == set(
                         GOLDEN_OUTPUTS) | {"pndm_traj"},
                     fused_norms_ok=all(row["launches"][k] > 0 for k in (
                         "K5f groupnorm_fwd", "K6f layernorm_fwd")),
                     bf16_tolerance=GOLDEN_BF16_TOL,
                     bf16_vs_f32_goldens=bf16,
                     bf16_within_tolerance=all(
                         v["outside_tolerance"] == 0 for v in bf16.values())))
    torch.cuda.empty_cache()

    # (a) certify_levers: every Stage-1 run timed with its resolution
    argv = ["certify_levers", "--checkpoint_dir", str(ckpt_dir), "--hparam",
            name, "--hparams_dir", str(tmp / "hparams"), "--results_dir",
            str(tmp / "results"), "--stats_dir", str(main_stats), "--steps",
            "10", "--seed", "0", "--n_concepts", str(CERT_CONCEPTS)]
    runs, heights = [], []
    out = io.StringIO()
    with run("a_certify_levers", cli_entry(argv), on) as row, \
            spy(lc_mod, "stage1_deltas", runs), \
            spy(ti_mod, "training_latents_for_requests", heights), \
            contextlib.redirect_stdout(out):
        res = workflows.main(argv)
    printed = out.getvalue()
    print(printed, end="", file=sys.stderr)
    stage1 = [dict(train_res=r["call"][1]["train_res"], seconds=r["seconds"])
              for r in runs]
    trained = sorted({h["call"][1]["height"] for h in heights})
    levers = {k: dict(cos=v["cos_mean"], ratio=v["ratio_mean"],
                      keep=v["keep"], rule=v["rule"])
              for k, v in res.items() if not k.startswith("_")}
    on_disk = json.loads((tmp / "results" / "lever_cert.json").read_text())
    compound = res["compound"]
    restores = [k for k, v in levers.items() if not v["keep"]]
    recipes = {**lc_mod.RESTORE_RECIPES, "compound": lc_mod.COMPOUND_RECIPE}
    routes = row["routes"]
    row.update(floor=res["_floor"], levers=levers, stage1_runs=stage1,
               s_per_stage1_run_384=[s["seconds"] for s in stage1
                                     if s["train_res"] == 384],
               s_per_stage1_run_512=[s["seconds"] for s in stage1
                                     if s["train_res"] == 512])
    finish(row, dict(
        rows_ok=set(res) == {"_floor", "compound"} | set(
            lc_mod.RESTORE_RECIPES) and on_disk == json.loads(
                json.dumps(res)),
        keep_bool_ok=all(isinstance(v["keep"], bool)
                         for v in levers.values()),
        finite_ok=all(np.isfinite([v["cos"], v["ratio"]]).all()
                      for v in levers.values()),
        restore_recipes_ok=all(recipes[k] in printed for k in restores),
        compound_rule_ok=compound["rule"] == "z-agreement-or-loss"
        and compound["guard_bands"] == lc_mod.GUARD_BANDS
        and ("functional_gate" in compound) == compound["keep"]
        and compound.get("functional_gate",
                         "guard_bands pending") == "guard_bands pending"
        and lc_mod.GUARD_BANDS in printed,
        stage1_runs=len(stage1), stage1_runs_ok=len(stage1) == 8,
        trained_px=trained, trained_512_and_384_ok=trained == [384, 512],
        bwd_mma_only_ok=all(
            routes[k]["mma"] > 0 and routes[k]["fma"] == 0
            for k in ("K2 flash_v2_dq", "K3 flash_v2_dkv")),
        kernels_ok=all(row["launches"][k] > 0 for k in (
            "K1 flash_v2_fwd", "K4 short_kv_fwd", "K5b groupnorm_bwd",
            "K6b layernorm_bwd"))))
    cert_row = row
    torch.cuda.empty_cache()

    # (b) the deviation-guard harness, live on the card at its regime
    with run("b_guard_harness", "emcid_torch.evals.deviation_harness", off) \
            as row:
        comps = build_tiny_pipeline(seed=0, words=GUARD_WORDS, device="cuda")
        scorer = dh.make_guard_scorer(device="cuda")
        stats = tmp / "guard_stats"
        base = dh.run_mode(comps, scorer, stats, **GUARD_EXACT)
        band = dh.null_band([dh.run_mode(comps, scorer, stats, rng_seed=r,
                                         **GUARD_EXACT)
                             for r in dh.NULL_RNGS[:2]], base)
        lever = dh.run_mode(comps, scorer, stats,
                            **dict(GUARD_EXACT, cfg_interval=0.6))
        control = dh.run_mode(comps, scorer, stats,
                              z_transform=lambda z: 0.5 * z, **GUARD_EXACT)
        identity = dh.run_mode(comps, scorer, stats,
                               z_transform=lambda z: 1.0 * z, **GUARD_EXACT)
    verdicts = {}
    for label, fn, rows_ in (("cfg_interval", dh.assert_within_noise, lever),
                             ("z_scaled_half", dh.assert_outside_noise,
                              control)):
        try:
            rep = fn(rows_, base, band, label)
            verdicts[label] = dict(ok=True, mean_delta=rep[
                "mean_delta"].tolist())
        except AssertionError as e:
            verdicts[label] = dict(ok=False, error=str(e))
    control_delta = dh.paired_report(control, base, band)["mean_delta"]
    identity_delta = dh.paired_report(identity, base, band)["mean_delta"]
    row.update(band=band.tolist(), exact_mean=base.mean(axis=0).tolist(),
               verdicts=verdicts, control_mean_delta=control_delta.tolist(),
               identity_mean_delta=identity_delta.tolist(),
               identity_max_abs_vs_base=float(np.abs(identity - base).max()))
    # The seam is held on both sides of the harness's absolute floor: z*1
    # through it stays within the floor of the base rows (on the CPU they
    # are equal; on the card two runs of one protocol differ by ~1e-3), and
    # z*0.5 moves a metric past it.  The control's band verdict is
    # reported, not gated: at random tiny weights it turns on the draws,
    # in the JAX package as in the port (PERF.md §6;
    # scripts/torch_guard_witness.py, scripts/guard_witness_jax.py)
    finish(row, dict(
        finite_ok=bool(np.isfinite(np.concatenate(
            [base, lever, control, identity])).all()),
        lever_within_band_ok=verdicts["cfg_interval"]["ok"],
        identity_within_floor_ok=bool(identity_delta.max() <= dh.ABS_FLOOR),
        control_moves_ok=bool(control_delta.max() > dh.ABS_FLOOR),
        control_outside_band=verdicts["z_scaled_half"]["ok"]))
    del comps, scorer

    # (c) the visual examples on one load of the folder
    data = write_cert_tree(tmp / "data", eval_dir / "data")
    base_args = ["--checkpoint_dir", str(ckpt_dir), "--hparam", name,
                 "--hparams_dir", str(tmp / "hparams"), "--sample_num", "2",
                 "--steps", "10", "--out_dir", str(tmp / "visual"),
                 "--platform", "cuda"]
    args = ve.build_parser().parse_args(base_args)
    args.data_dir, args.stats_dir = str(data), str(main_stats)
    args.cache_dir = args.results_dir = None
    t0 = time.time()
    comps, hparams, gen_kwargs, _ = workflows._setup(args)
    hparams = dataclasses.replace(hparams, v_num_grad_steps=10)
    emit(dict(phase="cert_path_visual_setup", load_s=time.time() - t0))
    before = {k: {n: v.clone() for n, v in getattr(comps, k).state_dict()
                  .items()} for k in ("text_encoder", "unet", "vae")}
    visual_rows = []
    for mode, flags in VISUAL_MODES.items():
        margs = ve.build_parser().parse_args(["--mode", mode, *flags,
                                              *base_args])
        margs.data_dir, margs.stats_dir = args.data_dir, args.stats_dir
        margs.cache_dir = margs.results_dir = None
        solves = []
        with run(f"c_visual_{mode}", "emcid_torch.cli.visual_examples "
                 f"--mode {mode}", off) as row, \
                spy(uce_mod, "_uce_solve_all", solves):
            out_dir = ve.MODES[mode](margs, comps, hparams, gen_kwargs)
        worst = 0.0
        for s in solves:
            (mat2, stack), _, got = s["call"]
            ref = np.linalg.solve(
                mat2.double().cpu().numpy(),
                stack.double().cpu().numpy().transpose(0, 2, 1))
            worst = max(worst, float(np.linalg.norm(
                got.double().cpu().numpy() - ref) / np.linalg.norm(ref)))
        # nudity_uce runs no Stage 1: no K2/K3
        expect = ({k: BF16_ROUTES[k] for k in ("K1 flash_v2_fwd",
                                                "K4 short_kv_fwd")}
                  if mode == "nudity_uce" else BF16_ROUTES)
        checks = dict(
            base_unchanged_ok=all(
                torch.equal(v, before[k][n])
                for k in before
                for n, v in getattr(comps, k).state_dict().items()),
            bf16_routes_ok=routes_ok(row["routes"], expect))
        if mode == "artist_holdout":
            grid = np.asarray(Image.open(next(Path(out_dir).glob(
                "holdout_vs_edit_num.png"))))
            checks.update(grid_shape=list(grid.shape),
                          grid_ok=grid.shape == (3 * 512, 2 * 512, 3))
        else:
            folders = ([Path(out_dir) / s for s in ("train", "test")]
                       if mode == "nudity_uce" else [Path(out_dir)])
            r, c = VISUAL_GRIDS[mode]
            sizes, differ = [], []
            for f in folders:
                imgs = {n: np.asarray(Image.open(f / f"{n}.png"))
                        for n in ("pre", "post", "pre_post")}
                sizes.append({n: list(a.shape) for n, a in imgs.items()})
                differ.append(not np.array_equal(imgs["pre"], imgs["post"]))
            checks.update(
                grid_sizes=sizes, grid_ok=all(
                    s["pre"] == s["post"] == [r * 512, c * 512, 3]
                    and s["pre_post"] == [2 * r * 512, c * 512, 3]
                    for s in sizes),
                post_differs_ok=all(differ))
        if mode == "nudity_uce":
            checks.update(solves=len(solves), uce_f32_vs_f64_rel=worst,
                          solve_rel_tolerance=SOLVE_REL_TOL,
                          uce_solve_ok=bool(solves)
                          and worst <= SOLVE_REL_TOL)
        finish(row, checks)
        visual_rows.append(row)
    del comps, before
    torch.cuda.empty_cache()
    return cert_row, visual_rows


# ---------------------------------------------------------------------------
# the single-process device mesh (M14): sharded against unsharded
# ---------------------------------------------------------------------------

MESH_PROMPTS = [f"a photo of w{i}" for i in range(6)]
MESH_REQUESTS = [{"prompts": ["a photo of a {}", "an image of a {}", "{}"],
                  "source": f"w{i}", "dest": f"w{i + 1}", "seed_train": i}
                 for i in (20, 23, 26)]
MESH_IMAGE_TOL = 1e-3  # sharded vs unsharded f32 images in [0, 1]
MESH_Z_TOL = 1e-4  # Stage-1 z, relative
MESH_COV_TOL = 1e-6  # the covariance, relative
MESH_CAPTIONS = 2000


def mesh_path(torch, tmp: Path, ckpt, failures):
    """``emcid_torch.parallel`` on the folder of ``write_checkpoint``: the
    mesh is every card when two or more are attached, else four entries on
    ``cuda:0`` (the shards then run one after another on one card: a check
    of the sharded code, no speed figure).  Sharded against unsharded:

    (a) generation of 6 prompts at 512 px, PNDM-10, padded to a multiple
        of the mesh: ``sample_latents`` of the padded batch in exact f32
        (TF32 off; the images decoded in [0, 1] within
        ``MESH_IMAGE_TOL``) and ``generate`` in bf16 (the uint8 gap
        reported, the tensor-core routes held);
    (b) ``compute_zs_for_requests`` of 3 concepts (padded to 4 inside
        Stage 1), 5 steps at 384 px, in exact f32, on the same given
        training images (z within ``MESH_Z_TOL``);
    (c) ``layer_stats_text_encoder`` of layer 10 over 2000 synthetic
        captions in f32 (the second moment within ``MESH_COV_TOL``), and
        the Stage-2 solve on it against float64 (``SOLVE_REL_TOL``).

    One JSON row per run (its launches, seconds and peak memory), each
    sharded run with its unsharded twin's seconds.  Returns the rows of
    the sharded runs."""
    import numpy as np

    from emcid_torch.dsets.stat_dataset import make_synthetic_captions
    from emcid_torch.engine.editor import compute_zs_for_requests
    from emcid_torch.engine.layer_stats import layer_stats_text_encoder
    from emcid_torch.models.loader import load_pipeline
    from emcid_torch.models.pipeline import generate, sample_latents
    from emcid_torch.ops.solve import solve_adj_k
    from emcid_torch.parallel import get_mesh, pad_to_multiple
    from emcid_torch.runtime import precise_matmuls

    n_cards = torch.cuda.device_count()
    mesh = get_mesh() if n_cards >= 2 else get_mesh(["cuda:0"] * 4)
    layout = (f"{n_cards} cards" if n_cards >= 2 else
              "4 shards on cuda:0, one after another (one card: a check of "
              "the sharded code, not a multi-GPU speed figure)")
    emit(dict(phase="mesh_path_setup", cards=n_cards, mesh=[
        str(d) for d in mesh.devices], layout=layout))
    ckpt_dir = ckpt[0]
    off = dict.fromkeys(KNOBS)
    rows = []
    run = functools.partial(measured, torch, "mesh_path", gen_spies=[])
    finish = functools.partial(finish_run, rows, failures)
    sharded_rows = []

    def twin(label, entry, fn):
        """``fn(None)`` then ``fn(mesh)``, each measured; returns both
        results and the sharded row."""
        with run(f"{label}_unsharded", entry, off) as row_u:
            ref = fn(None)
        emit(row_u)
        with run(f"{label}_sharded", entry, off) as row:
            got = fn(mesh)
        row.update(mesh=mesh.size, layout=layout,
                   unsharded_seconds=row_u["seconds"],
                   unsharded_launches=row_u["launches"])
        sharded_rows.append(row)
        return ref, got, row

    def float_images(comps, lat):
        with torch.no_grad():
            img = comps.vae.decode((lat.permute(0, 3, 1, 2)
                                    / comps.scaling_factor).to(comps.dtype))
        return torch.clamp(img.float() / 2 + 0.5, 0, 1).cpu().numpy()

    gen_kw = dict(num_inference_steps=10, height=512, width=512,
                  sampler="pndm")
    seeds = list(range(len(MESH_PROMPTS)))
    n_pad = pad_to_multiple(len(MESH_PROMPTS), mesh.size)
    padded = (MESH_PROMPTS + MESH_PROMPTS[-1:] * (n_pad - len(seeds)),
              seeds + [0] * (n_pad - len(seeds)))

    # (a) in exact f32 (TF32 off: cuDNN's TF32 convolutions round by an
    # algorithm that depends on the batch shape, 3.7e-3 apart in images
    # and 2.7e-3 in z on one card, so they would hide the sharding's own
    # error): the padded batch's latents, decoded in f32 here; then (b) and
    # (c) on the same f32 pipeline
    comps = load_pipeline(ckpt_dir, dtype=torch.float32, device="cuda")
    with precise_matmuls():
        ref, got, row = twin(
            "a_generate_f32", "emcid_torch.models.pipeline.sample_latents",
            lambda m: sample_latents(comps, *padded, mesh=m, **gen_kw))
        gap = float(np.abs(float_images(comps, ref)
                           - float_images(comps, got)).max())
    row.update(images=n_pad, image_max_abs_diff=gap)
    finish(row, dict(image_tolerance=MESH_IMAGE_TOL,
                     images_ok=gap <= MESH_IMAGE_TOL))

    # (b) Stage 1 on the same given 384-px training images
    imgs = generate(comps, [p.format(r["source"]) for r in MESH_REQUESTS
                            for p in r["prompts"]], list(range(9)),
                    num_inference_steps=10, height=384, width=384,
                    sampler="dpm++")
    reqs = [dict(r, images=list(imgs[3 * i:3 * i + 3]))
            for i, r in enumerate(MESH_REQUESTS)]
    hp = bench_hparams(5)
    with precise_matmuls():
        ref, got, row = twin(
            "b_stage1_f32", "emcid_torch.engine.editor."
            "compute_zs_for_requests",
            lambda m: compute_zs_for_requests(comps, reqs, hp,
                                              num_inference_steps=10,
                                              mesh=m, verbose=False))
    z_rel = float(np.abs(ref - got).max() / np.abs(ref).max())
    row.update(concepts=len(reqs), train_res=384, steps=5, z_rel_diff=z_rel)
    finish(row, dict(z_tolerance=MESH_Z_TOL, z_ok=z_rel <= MESH_Z_TOL,
                     finite_ok=bool(np.isfinite(got).all())))

    # (c) the covariance sweep's caption axis, and a Stage-2 solve on it
    caps = make_synthetic_captions(MESH_CAPTIONS)
    layer = "text_model.encoder.layers.10.mlp.fc2"
    ref, got, row = twin(
        "c_covariance_f32", "emcid_torch.engine.layer_stats."
        "layer_stats_text_encoder",
        lambda m: layer_stats_text_encoder(
            comps.text_encoder, comps.tokenizer, layer,
            stats_dir=tmp / "mesh_stats", ds_name="synthetic",
            sample_size=MESH_CAPTIONS, captions=caps, force_recompute=True,
            mesh=m).mom2.moment())
    cov_rel = float((ref - got).abs().max() / ref.abs().max())
    C = got.cuda()
    K = torch.randn(C.shape[0], 2, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    solved = solve_adj_k(C, K, 4000.0).cpu().numpy()
    exact = solve_adj_k(C, K, 4000.0, method="f64")
    solve_rel = float(np.linalg.norm(solved - exact) / np.linalg.norm(exact))
    row.update(captions=MESH_CAPTIONS, cov_rel_diff=cov_rel,
               solve_f32_vs_f64_rel=solve_rel)
    finish(row, dict(cov_tolerance=MESH_COV_TOL,
                     cov_ok=cov_rel <= MESH_COV_TOL,
                     solve_rel_tolerance=SOLVE_REL_TOL,
                     solve_ok=solve_rel <= SOLVE_REL_TOL))
    del comps, C, K
    torch.cuda.empty_cache()

    # (a) in bf16 through generate(), which pads 6 prompts to 8: the gap
    # reported, the tensor-core routes held
    comps = load_pipeline(ckpt_dir, device="cuda")
    ref, got, row = twin(
        "a_generate_bf16", "emcid_torch.models.pipeline.generate",
        lambda m: generate(comps, MESH_PROMPTS, seeds, mesh=m, **gen_kw))
    row.update(images=len(seeds), padded_to=n_pad, uint8_max_level_diff=int(
        np.abs(ref.astype(int) - got.astype(int)).max()))
    finish(row, dict(shape_ok=got.shape == (len(seeds), 512, 512, 3),
                     bf16_routes_ok=routes_ok(row["routes"], {
                         k: BF16_ROUTES[k] for k in ("K1 flash_v2_fwd",
                                                     "K4 short_kv_fwd")})))
    del comps
    torch.cuda.empty_cache()
    return sharded_rows


# ---------------------------------------------------------------------------
# the multi-process dcn mesh (M14b): ranks under torch.distributed.run
# ---------------------------------------------------------------------------

# Stage-1 steps of run (a): the main path's 50 (30 run under its cosine
# schedule) cut to 5 (const) for time, in exact f32, as the mesh path's
DCN_GRAD_STEPS = 5
# run (c), the CLI in bf16: its z against the one-process CLI path's,
# relative to the largest entry (the bf16 model checks' tolerance).  The
# fc2 updates are reported: Stage 2 amplifies z's differences (in exact
# f32, run (a) of the first chip run: z 1.8e-5 apart, updates 4.5e-3)
DCN_BF16_TOL = 5e-2
DCN_TIMEOUT_S = 900


def sha(torch, t) -> str:
    """A tensor's bytes, hashed (equal hashes: the same bits)."""
    import hashlib

    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()
                          ).hexdigest()[:16]


def dcn_layout(torch):
    """(ranks, backend, reason): one rank per card over NCCL with two or
    more cards, else two ranks sharing ``cuda:0`` over gloo."""
    n = torch.cuda.device_count()
    if n >= 2:
        return n, "nccl", f"{n} ranks, one card each"
    return 2, "gloo", ("2 ranks share cuda:0 (one card: a check of the "
                       "cross-process code, not a multi-card speed figure)")


def gloo_cuda_probe(torch, dev) -> dict:
    """Which gloo collectives take CUDA tensors as they are (the port's
    ``all_gather`` stages through the host either way): each one called
    once on a CUDA tensor in every rank, its error recorded.  Every rank
    calls the same collectives in the same order."""
    import torch.distributed as dist

    world, out = dist.get_world_size(), {}
    calls = (("all_gather", lambda t: dist.all_gather(
        [torch.empty_like(t) for _ in range(world)], t)),
             ("all_reduce", dist.all_reduce),
             ("broadcast", lambda t: dist.broadcast(t, 0)))
    for name, fn in calls:
        try:
            fn(torch.ones(4, device=dev))
            torch.cuda.synchronize(dev)
            out[name] = "takes CUDA tensors"
        except (RuntimeError, ValueError, TypeError,
                NotImplementedError) as e:
            out[name] = f"{type(e).__name__}: {str(e)[:160]}"
    return out


def dcn_worker(spec_path: str) -> int:
    """One rank of the dcn path (``chip_smoke.py --dcn-worker SPEC`` under
    ``torch.distributed.run``): runs (a)-(c) of ``dcn_path`` on its own
    card, and writes its results (rank 0 also the arrays the parent holds
    against the twins) under the spec's directory."""
    import numpy as np
    import torch
    from PIL import Image

    from emcid_torch.cli import run_emcid
    from emcid_torch.engine import editor
    from emcid_torch.engine import emcid as emcid_mod
    from emcid_torch.models.loader import load_pipeline
    from emcid_torch.models.pipeline import generate, sample_latents
    from emcid_torch.ops import _build
    from emcid_torch.parallel import default_mesh, distributed, pad_to_multiple
    from emcid_torch.runtime import precise_matmuls

    spec = json.loads(Path(spec_path).read_text())
    work = Path(spec["work"])
    backend = distributed.init_from_env("cuda")
    rank = distributed.process_index()
    dev = distributed.local_device()
    _build.lib()
    out = dict(rank=rank, world=distributed.process_count(),
               backend=backend, device=str(dev),
               probe=(gloo_cuda_probe(torch, dev) if backend == "gloo"
                      else None))
    mesh = default_mesh()
    out.update(mesh_axes=list(mesh.axis_names), mesh_shape=list(mesh.shape),
               first=mesh.first)
    keep = rank == 0  # rank 0 saves the arrays the parent compares

    @contextlib.contextmanager
    def run(label, knobs):
        row = dict(run=label)
        with environ(**knobs):
            _build.reset_launches()
            torch.cuda.reset_peak_memory_stats(dev)
            distributed.barrier()
            t0 = time.time()
            yield row
            torch.cuda.synchronize(dev)
            distributed.barrier()
            row.update(seconds=time.time() - t0,
                       launches=dict(_build.LAUNCHES),
                       routes=copy.deepcopy(_build.ROUTES),
                       peak_mem_gb=torch.cuda.max_memory_allocated(dev)
                       / 2 ** 30)
        out[label] = row

    # (a) apply_emcid, exact f32
    comps = load_pipeline(spec["ckpt"], dtype=torch.float32, device=dev)
    hp = bench_hparams(DCN_GRAD_STEPS)
    zs, covs, solves = [], [], []
    with precise_matmuls(), spy(editor, "compute_zs_for_requests", zs), \
            spy(editor, "resolve_covariances_for", covs), \
            spy(emcid_mod, "solve_adj_k", solves), \
            run("a_apply_emcid_f32", dict.fromkeys(KNOBS)) as row:
        edited, _ = editor.apply_emcid(
            comps, REQUESTS, hp, stats_dir=work / "a_stats",
            cache_name=f"{work / 'a_z'}/", num_inference_steps=10,
            mesh=mesh, verbose=False)
    z = zs[0]["call"][2]
    cov = covs[0]["call"][2][-1]
    before = dict(comps.text_encoder.named_parameters())
    changed = sorted(k for k, v in edited.text_encoder.named_parameters()
                     if not torch.equal(v, before[k]))
    upd = fc2_updates(torch, edited.text_encoder, before, hp.layers)
    row.update(z_sha=sha(torch, torch.as_tensor(z)), cov_sha=sha(torch, cov),
               fc2_sha={k: sha(torch, v) for k, v in upd.items()},
               changed_params=changed,
               solves_vs_f64=solves_vs_f64(solves))
    if keep:
        np.save(work / "a_z.npy", np.asarray(z))
        np.save(work / "a_cov.npy", cov.cpu().numpy())
        torch.save(upd, work / "a_updates.pt")
    del edited, zs, covs, solves

    # (b) generation: the padded batch's latents in exact f32, decoded in
    # f32; then generate() in bf16
    seeds = list(range(len(MESH_PROMPTS)))
    n_pad = pad_to_multiple(len(MESH_PROMPTS), mesh.size)
    padded = (MESH_PROMPTS + MESH_PROMPTS[-1:] * (n_pad - len(seeds)),
              seeds + [0] * (n_pad - len(seeds)))
    gen_kw = dict(num_inference_steps=10, height=512, width=512,
                  sampler="pndm")
    with precise_matmuls(), run("b_generate_f32", dict.fromkeys(KNOBS)) as row:
        lat = sample_latents(comps, *padded, mesh=mesh, **gen_kw)
        with torch.no_grad():
            img = comps.vae.decode((lat.permute(0, 3, 1, 2)
                                    / comps.scaling_factor))
        img = torch.clamp(img.float() / 2 + 0.5, 0, 1)
    row.update(images=n_pad, images_sha=sha(torch, img))
    if keep:
        np.save(work / "b_images.npy", img.cpu().numpy())
    del comps, lat, img
    torch.cuda.empty_cache()
    comps = load_pipeline(spec["ckpt"], device=dev)
    with run("b_generate_bf16", dict.fromkeys(KNOBS)) as row:
        images = generate(comps, MESH_PROMPTS, seeds, mesh=mesh, **gen_kw)
    row.update(images_sha=sha(torch, torch.as_tensor(images)))
    if keep:
        np.save(work / "b_images_bf16.npy", images)
    del comps
    torch.cuda.empty_cache()

    # (c) the CLI, in bf16 with both norm knobs at 1, every write counted
    writes, zs = [], []
    savez, img_save = np.savez, Image.Image.save

    def counted(fn, kind):
        def wrapper(*a, **k):
            writes.append(kind)
            return fn(*a, **k)
        return wrapper

    np.savez, Image.Image.save = counted(savez, "npz"), counted(img_save,
                                                                "png")
    try:
        with spy(editor, "compute_zs_for_requests", zs), \
                run("c_cli_bf16", dict(EMCID_TPU_FUSED_GN="1",
                                       EMCID_TPU_FUSED_LN="1")) as row:
            edited, _ = run_emcid.main(spec["cli_argv"])
    finally:
        np.savez, Image.Image.save = savez, img_save
    z = np.asarray(zs[0]["call"][2])
    state = edited.text_encoder.state_dict()
    fc2 = {k: state[k].float().cpu() for k in state
           if k.endswith("mlp.fc2.weight")}
    row.update(files_written=len(writes), z_sha=sha(torch, torch.as_tensor(z)),
               fc2_sha={k: sha(torch, v) for k, v in fc2.items()})
    if keep:
        np.save(work / "c_z.npy", z)
        torch.save(fc2, work / "c_fc2.pt")
    del edited, state
    (work / f"rank{rank}.json").write_text(json.dumps(out))
    distributed.shutdown()
    return 0


def nccl_world_one(torch) -> dict:
    """The collective helper once under NCCL in a group of one process (on
    one card the ranks share it over gloo, so this is where the NCCL
    branch runs)."""
    import socket

    from emcid_torch.parallel import distributed

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    with environ(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                 LOCAL_WORLD_SIZE="1", MASTER_ADDR="localhost",
                 MASTER_PORT=str(port)):
        backend = distributed.init_from_env("cuda")
        try:
            x = torch.arange(6.0, device="cuda").reshape(3, 2)
            y = distributed.all_gather(x)
            distributed.barrier()
            same = bool(torch.equal(x, y))
        finally:
            distributed.shutdown()
    return dict(backend=backend, all_gather_equal=same)


def dcn_path(torch, tmp: Path, ckpt, cli_twin, failures):
    """``emcid_torch.parallel``'s ``dcn`` axis: ranks started with
    ``python -m torch.distributed.run`` (``dcn_worker``), one per card over
    NCCL with two or more cards, else two on ``cuda:0`` over gloo (a check
    of the cross-process code, no speed figure), on the folder of
    ``write_checkpoint``; each run against its one-process unsharded twin:

    (a) ``apply_emcid``, the main path's 4 concepts x 3 prompts and
        bench hparams (``DCN_GRAD_STEPS`` Stage-1 steps) at 384 px in exact
        f32 (TF32 off): z within ``MESH_Z_TOL``, the layer-10 covariance
        within ``MESH_COV_TOL``, every Stage-2 solve of every rank within
        ``SOLVE_REL_TOL`` of float64, z, the covariance and the edited fc2
        weights bit for bit the same in every rank, only those weights
        changed;
    (b) 6 prompts at 512 px, PNDM-10, padded to a multiple of the ranks:
        the latents in exact f32 decoded in [0, 1] within
        ``MESH_IMAGE_TOL``; ``generate`` in bf16 (the uint8 gap reported);
    (c) ``run_emcid`` under the group on the folder in bf16 with both norm
        knobs at 1 (the CLI path's command with its own output, covariance
        and z directories): only rank 0 wrote files, z and the edited fc2
        weights the same bits in every rank, z within ``DCN_BF16_TOL`` of
        the CLI path's (its one-process twin), the fc2 updates' and the
        images' gaps to the CLI path's reported.

    Per run: seconds beside the twin's, peak memory and launches of every
    kernel and route per rank; K1-K4 launched in every rank of (a) and
    (c), on their tensor-core routes with no ``fma`` in (c) and K1/K4 in
    (b)'s bf16 run.  On one card the helper also runs once under NCCL in
    a group of one.  Returns the runs' launches, summed over ranks."""
    import subprocess as sp

    import numpy as np

    from emcid_torch.engine import editor
    from emcid_torch.models.loader import load_pipeline
    from emcid_torch.models.pipeline import generate, sample_latents
    from emcid_torch.parallel import pad_to_multiple
    from emcid_torch.runtime import precise_matmuls

    ranks, backend, layout = dcn_layout(torch)
    work = tmp / "dcn"
    work.mkdir()
    emit(dict(phase="dcn_path_setup", cards=torch.cuda.device_count(),
              ranks=ranks, backend=backend, layout=layout))
    rows, twins = [], {}
    finish = functools.partial(finish_run, rows, failures)

    # the one-process twins of (a) and (b)
    comps = load_pipeline(ckpt[0], dtype=torch.float32, device="cuda")
    hp = bench_hparams(DCN_GRAD_STEPS)
    zs, covs = [], []
    with precise_matmuls(), spy(editor, "compute_zs_for_requests", zs), \
            spy(editor, "resolve_covariances_for", covs), \
            measured(torch, "dcn_path", "a_twin", "apply_emcid",
                     dict.fromkeys(KNOBS), []) as row:
        edited, _ = editor.apply_emcid(
            comps, REQUESTS, hp, stats_dir=work / "twin_stats",
            cache_name=f"{work / 'twin_z'}/", num_inference_steps=10,
            verbose=False)
    before = dict(comps.text_encoder.named_parameters())
    twins["a"] = dict(z=np.asarray(zs[0]["call"][2]),
                      cov=covs[0]["call"][2][-1].cpu(),
                      updates=fc2_updates(torch, edited.text_encoder, before,
                                          hp.layers), row=row)
    del edited, zs, covs
    seeds = list(range(len(MESH_PROMPTS)))
    n_pad = pad_to_multiple(len(MESH_PROMPTS), ranks)
    padded = (MESH_PROMPTS + MESH_PROMPTS[-1:] * (n_pad - len(seeds)),
              seeds + [0] * (n_pad - len(seeds)))
    gen_kw = dict(num_inference_steps=10, height=512, width=512,
                  sampler="pndm")
    with precise_matmuls(), measured(torch, "dcn_path", "b_twin_f32",
                                     "sample_latents", dict.fromkeys(KNOBS),
                                     []) as row:
        lat = sample_latents(comps, *padded, **gen_kw)
        with torch.no_grad():
            img = comps.vae.decode(lat.permute(0, 3, 1, 2)
                                   / comps.scaling_factor)
        img = torch.clamp(img.float() / 2 + 0.5, 0, 1).cpu().numpy()
    twins["b"] = dict(images=img, row=row)
    del comps, lat
    torch.cuda.empty_cache()
    comps = load_pipeline(ckpt[0], device="cuda")
    with measured(torch, "dcn_path", "b_twin_bf16", "generate",
                  dict.fromkeys(KNOBS), []) as row:
        twins["b_bf16"] = dict(images=generate(comps, MESH_PROMPTS, seeds,
                                               **gen_kw), row=row)
    del comps
    torch.cuda.empty_cache()

    # the ranks
    spec = work / "spec.json"
    cli_argv, _, shared_out = cli_inputs(work / "c", ckpt[0],
                                         bench_hparams(50))
    spec.write_text(json.dumps(dict(ckpt=str(ckpt[0]), work=str(work),
                                    cli_argv=cli_argv)))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={ranks}", str(REPO / "chip_smoke.py"),
           "--dcn-worker", str(spec)]
    log = work / "ranks.log"
    t0 = time.time()
    with open(log, "w") as f:
        proc = sp.Popen(cmd, stdout=f, stderr=sp.STDOUT, cwd=REPO,
                        start_new_session=True)
        try:
            code = proc.wait(timeout=DCN_TIMEOUT_S)
        except sp.TimeoutExpired:
            # the launcher stops its ranks on SIGTERM; then its group goes
            proc.terminate()
            try:
                proc.wait(timeout=30)
            finally:
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(proc.pid, 9)
                proc.wait()
            code = "timeout"
    wall = time.time() - t0
    results = [json.loads((work / f"rank{r}.json").read_text())
               for r in range(ranks) if (work / f"rank{r}.json").exists()]
    emit(dict(phase="dcn_path_ranks", command=" ".join(
        ["python -m torch.distributed.run", f"--nproc-per-node={ranks}",
         "chip_smoke.py --dcn-worker SPEC"]), exit=code, seconds=wall,
        results=len(results)))
    if code != 0 or len(results) != ranks:
        tail = log.read_text()[-6000:]
        print(tail, file=sys.stderr)
        failures.append(f"dcn path: the ranks exited {code} with "
                        f"{len(results)} of {ranks} results")
        return []
    setup = dict(phase="dcn_path", run="setup", ranks=ranks, layout=layout,
                 backend=[r["backend"] for r in results],
                 devices=[r["device"] for r in results],
                 mesh_axes=results[0]["mesh_axes"],
                 mesh_shape=results[0]["mesh_shape"],
                 firsts=[r["first"] for r in results],
                 gloo_cuda_tensors=results[0]["probe"])
    checks = dict(backend_ok=all(r["backend"] == backend for r in results),
                  mesh_ok=all(r["mesh_shape"] == [ranks, 1]
                              and r["mesh_axes"] == ["dcn", "data"]
                              and r["first"] == r["rank"] for r in results))
    if torch.cuda.device_count() < 2:
        setup["nccl_world_1"] = nccl_world_one(torch)
        checks["nccl_ok"] = (setup["nccl_world_1"]["backend"] == "nccl"
                             and setup["nccl_world_1"]["all_gather_equal"])
    finish(setup, checks)

    def per_rank(label, twin_row, **extra):
        """The run's row: every rank's seconds, peak memory and launches
        beside the twin's."""
        runs = [r[label] for r in results]
        row = dict(phase="dcn_path", run=label, ranks=ranks, layout=layout,
                   seconds=[x["seconds"] for x in runs],
                   peak_mem_gb=[x["peak_mem_gb"] for x in runs],
                   launches=[x["launches"] for x in runs],
                   routes=[x["routes"] for x in runs], **extra)
        if twin_row is not None:
            row.update(twin_seconds=twin_row["seconds"],
                       twin_peak_mem_gb=twin_row["peak_mem_gb"])
        return row, runs

    def rel(ref, got):
        ref = np.asarray(ref, np.float64)
        got = np.asarray(got, np.float64)
        return float(np.abs(ref - got).max() / np.abs(ref).max())

    def updates_rel(ref, got):
        return max(rel(ref[k].numpy(), got[k].numpy()) for k in ref)

    # (a)
    row, runs = per_rank("a_apply_emcid_f32", twins["a"]["row"],
                         concepts=len(REQUESTS), prompts=3,
                         grad_steps=DCN_GRAD_STEPS, train_res=384)
    z = np.load(work / "a_z.npy")
    cov = np.load(work / "a_cov.npy")
    expect = sorted(f"text_model.encoder.layers.{i}.mlp.fc2.weight"
                    for i in hp.layers)
    row.update(z_rel_diff=rel(twins["a"]["z"], z),
               cov_rel_diff=rel(twins["a"]["cov"].numpy(), cov),
               fc2_update_rel_diff=updates_rel(
                   twins["a"]["updates"], torch.load(work / "a_updates.pt")),
               solves_vs_f64=[x["solves_vs_f64"] for x in runs])
    finish(row, dict(
        z_tolerance=MESH_Z_TOL, z_ok=row["z_rel_diff"] <= MESH_Z_TOL,
        cov_tolerance=MESH_COV_TOL,
        cov_ok=row["cov_rel_diff"] <= MESH_COV_TOL,
        solve_rel_tolerance=SOLVE_REL_TOL,
        solves_ok=all(x <= SOLVE_REL_TOL for x in row["solves_vs_f64"]),
        same_bits_ok=all(x[k] == runs[0][k] for x in runs
                         for k in ("z_sha", "cov_sha", "fc2_sha")),
        only_fc2_ok=all(x["changed_params"] == expect for x in runs),
        finite_ok=bool(np.isfinite(z).all() and np.isfinite(cov).all()),
        kernels_ok=all(x["launches"][k] > 0 for x in runs
                       for k in ATTENTION)))
    launch_runs = list(runs)

    # (b)
    row, runs = per_rank("b_generate_f32", twins["b"]["row"], images=n_pad)
    img = np.load(work / "b_images.npy")
    gap = float(np.abs(twins["b"]["images"] - img).max())
    row.update(image_max_abs_diff=gap)
    finish(row, dict(image_tolerance=MESH_IMAGE_TOL,
                     images_ok=gap <= MESH_IMAGE_TOL,
                     same_bits_ok=all(x["images_sha"] == runs[0]["images_sha"]
                                      for x in runs)))
    row, runs = per_rank("b_generate_bf16", twins["b_bf16"]["row"],
                         images=len(seeds))
    got = np.load(work / "b_images_bf16.npy")
    row.update(uint8_max_level_diff=int(np.abs(
        twins["b_bf16"]["images"].astype(int) - got.astype(int)).max()))
    finish(row, dict(
        shape_ok=got.shape == (len(seeds), 512, 512, 3),
        same_bits_ok=all(x["images_sha"] == runs[0]["images_sha"]
                         for x in runs),
        bf16_routes_ok=all(routes_ok(x["routes"], {
            k: BF16_ROUTES[k] for k in ("K1 flash_v2_fwd", "K4 short_kv_fwd")})
            for x in runs)))
    launch_runs += runs

    # (c)
    row, runs = per_rank("c_cli_bf16", None, twin="the CLI path's run",
                         EMCID_TPU_FUSED_GN="1", EMCID_TPU_FUSED_LN="1")
    row.update(twin_seconds=cli_twin["seconds"],
               twin_peak_mem_gb=cli_twin["peak_mem_gb"],
               files_written=[x["files_written"] for x in runs])
    from PIL import Image

    images = {phase: [np.asarray(Image.open(f)) for f in
                      sorted((shared_out / phase).glob("*.png"))]
              for phase in ("pre_edit", "post_edit")}
    gaps = [int(np.abs(a.astype(int) - b.astype(int)).max())
            for phase in images
            for a, b in zip(images[phase], cli_twin["images"][phase])]
    fc2 = torch.load(work / "c_fc2.pt")
    before = ckpt[2]
    z = np.load(work / "c_z.npy")
    row.update(z_rel_diff=rel(cli_twin["z"], z),
               fc2_update_rel_diff=updates_rel(cli_twin["updates"], {
                   k: fc2[k] - before[k].float().cpu()
                   for k in cli_twin["updates"]}),
               image_uint8_max_level_diff=gaps)
    finish(row, dict(
        z_tolerance=DCN_BF16_TOL, z_ok=row["z_rel_diff"] <= DCN_BF16_TOL,
        finite_ok=bool(np.isfinite(z).all()),
        rank0_only_wrote_ok=(runs[0]["files_written"] > 0 and all(
            x["files_written"] == 0 for x in runs[1:])),
        images_ok=all(len(images[p]) == len(VAL_PROMPTS)
                      and len(cli_twin["images"][p]) == len(VAL_PROMPTS)
                      for p in images),
        same_bits_ok=all(x[k] == runs[0][k] for x in runs
                         for k in ("z_sha", "fc2_sha")),
        bf16_routes_ok=all(routes_ok(x["routes"]) for x in runs),
        kernels_ok=all(x["launches"][k] > 0 for x in runs
                       for k in ATTENTION)))
    return launch_runs + runs


# ---------------------------------------------------------------------------
# SDXL (full width, 1024 px): the model checks, the CLI's SDXL leg, one
# profiled Stage-1 step and the cached second call
# ---------------------------------------------------------------------------

SDXL_REQUESTS = REQUESTS[:2]
SDXL_VAL_PROMPTS = ["a photo of a w0"]
# CLIP-L: the bench's layers 7-10, ending at the context tap (layer_out of
# layer 10 = n - 2).  bigG: its four layers ending at its own tap (layer
# 30 of 32); the reference's SDXL hparams are not in the repo
SDXL_LAYERS_2 = [27, 28, 29, 30]
SDXL_RES = 1024
# the hand-written kernels in a profiler trace: the demangled names of the
# kernels of emcid_torch/csrc (each in an anonymous namespace)
OWN_KERNEL_NAMES = tuple(
    f"namespace)::{k}" for k in (
        "fwd_mma_kernel", "fwd_d512_kernel", "fwd_kernel", "dq_mma_kernel",
        "dq_kernel", "dkv_mma_kernel", "dkv_kernel", "short_kv_mma_kernel",
        "short_kv_kernel", "gn_fwd_kernel", "gn_bwd_kernel", "ln_fwd_kernel",
        "ln_bwd_kernel"))


def sdxl_hparams(grad_steps: int):
    """The bench's edit settings on both SDXL encoders, the text-repr term
    on."""
    from emcid_torch.hparams import EMCIDXLHyperParams

    return EMCIDXLHyperParams.from_dict({
        "layers": [7, 8, 9, 10], "layers_2": SDXL_LAYERS_2,
        "clamp_norm_factor": 1.5, "layer_selection": "all",
        "fact_token": "subject_last", "v_num_grad_steps": grad_steps,
        "v_lr": 0.2, "v_weight_decay": 5e-4, "mom2_adjustment": True,
        "mom2_update_weight": 4000, "mom2_update_weight_2": 4000,
        "rewrite_module_tmp": "text_model.encoder.layers.{}.mlp.fc2",
        "layer_module_tmp": "text_model.encoder.layers.{}",
        "mlp_module_tmp": "text_model.encoder.layers.{}.mlp",
        "attn_module_tmp": "text_model.encoder.layers.{}.self_attn",
        "ln_f_module": "text_model.final_layer_norm",
        "mom2_dataset": "ccs_filtered", "mom2_n_samples": 100000,
        "mom2_dtype": "float32", "objective": "ablate-dest",
        "esd_mu": "None", "cal_text_repr_loss": True,
        "text_repr_loss_scale_factor": 0.01,
    })


def build_sdxl(torch):
    """The full-width SDXL pipeline, random bf16 weights from seed 0 (the
    one ``--random-init --seed 0`` builds): (components, seconds)."""
    from emcid_torch.models.sdxl import build_random_sdxl_pipeline

    t0 = time.time()
    comps = build_random_sdxl_pipeline(seed=0, device="cuda")
    torch.cuda.synchronize()
    return comps, time.time() - t0


def sdxl_model_checks(torch, comps, failures):
    """The SDXL UNet at 128x128 latents (1024 px) and a 77-token 2048-wide
    context: (a) bf16, batch 2, attention through the kernels against
    ``EMCID_TPU_NO_FLASH=1``, for eps and the gradient into the context and
    ``text_embeds`` (5e-2; K1, K2, K3 and K4 on ``mma``); (b) f32, batch
    1, with both norm knobs at 1 against the knobs at 0 and the plain
    attention path (1e-3), which puts K5b's ``stream`` route on 163,840-
    element (batch, group) spans.  Returns the rows."""
    from emcid_torch.ops import _build
    from emcid_torch.runtime import precise_matmuls

    rows = []
    for label, dtype, B, knobs, tol in (
            ("bf16", torch.bfloat16, 2, dict.fromkeys(KNOBS), BF16_MODEL_TOL),
            ("f32", torch.float32, 1, dict(EMCID_TPU_FUSED_GN="1",
                                          EMCID_TPU_FUSED_LN="1"),
             MODEL_TOL)):
        unet = comps.unet if dtype == torch.bfloat16 else \
            copy.deepcopy(comps.unet).float()
        g = torch.Generator(device="cuda").manual_seed(11)
        mk = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)
        x, ctx0, te0 = mk(B, 4, 128, 128), mk(B, 77, 2048), mk(B, 1280)
        w = mk(B, 4, 128, 128)
        t = torch.tensor([500, 20][:B], device="cuda")
        tids = torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024]] * B,
                            device="cuda")

        def eps_and_grads():
            ctx = ctx0.clone().requires_grad_()
            te = te0.clone().requires_grad_()
            eps = unet(x, t, ctx, {"text_embeds": te, "time_ids": tids}
                       ).sample
            gc, gt = torch.autograd.grad((eps.float() * w.float()).sum(),
                                         (ctx, te))
            return eps.detach(), gc, gt

        with precise_matmuls() if dtype == torch.float32 else \
                contextlib.nullcontext():
            with environ(**knobs):
                _build.reset_launches()
                kern = eps_and_grads()
                launches = dict(_build.LAUNCHES)
                routes = copy.deepcopy(_build.ROUTES)
            with environ(EMCID_TPU_NO_FLASH="1", **dict.fromkeys(KNOBS)):
                plain = eps_and_grads()
        errs = {f"{k}_rel_err": rel_err(a, b)[1] for k, a, b in zip(
            ("eps", "ctx_grad", "text_embeds_grad"), kern, plain)}
        row = dict(phase="model_check",
                   what=f"sdxl UNet {label}, B={B}, 128x128, kernels vs "
                   "plain attention" + (" and stock norms" if knobs[
                       "EMCID_TPU_FUSED_GN"] else ""),
                   **knobs, **errs, tolerance=tol, launches=launches,
                   routes={k: routes[k] for k in (*BF16_ROUTES, *NORM_ROUTES)})
        finite = all(bool(torch.isfinite(a).all()) for a in kern)
        if dtype == torch.bfloat16:
            used = routes_ok(routes, {k: ("mma",) for k in ATTENTION})
        else:
            used = (all(launches[k] > 0 for k in SOURCES)
                    and routes["K5b groupnorm_bwd"]["stream"] > 0)
        row["ok"] = all(e <= tol for e in errs.values()) and finite and used
        emit(row)
        rows.append(row)
        if not row["ok"]:
            failures.append(f"SDXL model check {label}: {row}")
        del unet, kern, plain
        torch.cuda.empty_cache()
    return rows


def sdxl_cli(torch, argv):
    """One in-process CLI call: (edited, deltas, row of its seconds, phase
    seconds, launches, routes and peak memory)."""
    from emcid_torch.cli import run_emcid
    from emcid_torch.ops import _build

    timings = {}
    with environ(**dict.fromkeys(KNOBS)):
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated() / 2 ** 30
        _build.reset_launches()
        t0 = time.time()
        edited, deltas = run_emcid.main(argv, timings=timings)
        torch.cuda.synchronize()
        total_s = time.time() - t0
        launches = dict(_build.LAUNCHES)
        routes = copy.deepcopy(_build.ROUTES)
    row = dict(total_s=total_s, **{f"{k}_s": v for k, v in timings.items()},
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
               resident_before_gb=resident, launches=launches, routes=routes)
    return edited, deltas, row


def sdxl_stage2_f64(torch, ref, hp, zs, stats):
    """Each encoder's Stage-2 insert of the run (its z and the cached
    covariances of the run's stats directory), once with the f32 solve on
    the card and once with the host float64 solve: (a) every solve of the
    f32 pass against the float64 solve of the same system (the check,
    ROADMAP F1); (b) each edited layer's update from the whole f32 pass
    against the whole float64 pass, where the keys of a later layer come
    through the bf16 forward patched with the earlier layers' updates
    (shown, not checked).  Relative Frobenius differences."""
    import numpy as np

    import emcid_torch.engine.emcid as emcid_mod
    from emcid_torch.engine.sdxl import (
        encoder_hparams_view,
        resolve_covariances_sdxl,
    )
    from emcid_torch.ops.solve import solve_adj_k

    covs = resolve_covariances_sdxl(ref, hp, *stats, verbose=False)
    solve_rel, chained_rel = {}, {}
    for which in (1, 2):
        view = encoder_hparams_view(hp, which)
        prefix = f"text_encoder{'_2' if which == 2 else ''}"
        upd, calls = {}, []
        for method in ("f32_ir", "f64"):
            with spy(emcid_mod, "solve_adj_k",
                     calls if method == "f32_ir" else []):
                d, _ = emcid_mod.execute_emcid_text_encoder(
                    ref.encoder(which), ref.tokenizer, SDXL_REQUESTS, view,
                    zs=zs[which - 1], covs=covs[which - 1],
                    mom2_weight=view.mom2_update_weight, solve_method=method,
                    verbose=False)
            upd[method] = {k: a @ r.T for k, (a, r) in d.items()}
        for layer, call in zip(view.layers, calls):
            (C, K, lam), _, got = call["call"]
            want = solve_adj_k(C, K, lam, method="f64")
            solve_rel[f"{prefix}.layer{layer}"] = float(
                np.linalg.norm(got.double().cpu().numpy() - want)
                / np.linalg.norm(want))
        for k, v in upd["f64"].items():
            chained_rel[f"{prefix}.{k}"] = float(
                np.linalg.norm(upd["f32_ir"][k] - v) / np.linalg.norm(v))
    return solve_rel, chained_rel


def profile_stage1_step(torch, ref, hp):
    """One joint Stage-1 step (2 concepts x 3 prompts at 1024 px, random
    posterior latents, the text encoders' forwards around it included):
    a warm-up call, one timed on the host clock, one under
    ``torch.profiler``.  Device busy (the sum of every kernel's device
    time; one stream), the idle share of the timed call's wall (the
    profiler slows the host), the hand-written kernels' share of busy and
    the top device ops."""
    import dataclasses
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    from emcid_torch.engine.sdxl import compute_z_sdxl_text_encoders

    g = torch.Generator(device="cuda").manual_seed(12)
    mean = torch.randn(2, 1, 3, 128, 128, 4, generator=g, device="cuda")
    logvar = torch.full_like(mean, -4.0)
    one = dataclasses.replace(hp, v_num_grad_steps=1)

    def step():
        compute_z_sdxl_text_encoders(ref, SDXL_REQUESTS, one, mean, logvar,
                                     height=SDXL_RES, width=SDXL_RES,
                                     verbose=False)
        torch.cuda.synchronize()

    step()
    t0 = time.time()
    step()
    wall_ms = (time.time() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        step()
        profiled_ms = (time.time() - t0) * 1e3
    by_name = defaultdict(lambda: [0.0, 0])
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = evt.self_cuda_time_total
        if dev_us <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        by_name[evt.key][0] += dev_us / 1e3
        by_name[evt.key][1] += evt.count
    busy = sum(v[0] for v in by_name.values())
    own = sum(v[0] for k, v in by_name.items()
              if any(n in k for n in OWN_KERNEL_NAMES))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return dict(
        step_wall_ms=wall_ms, profiled_wall_ms=profiled_ms,
        device_busy_ms=busy,
        device_idle_share=max(0.0, 1.0 - busy / wall_ms) if wall_ms else None,
        own_kernels_ms=own, own_kernels_share_of_busy=own / busy if busy
        else None,
        top_device_ops=[dict(name=k[:100], ms=v[0], calls=v[1])
                        for k, v in top])


def sdxl_path(torch, tmp: Path, ref, build_s, failures):
    """The SDXL leg of ``python -m emcid_torch.cli.run_emcid`` in-process,
    knobs off: ``--random-init --seed 0`` (the full-width 3.47B-parameter
    SDXL-base in bf16), 2 concepts x 3 prompts, 10 Stage-1 steps with the
    text-repr term, CLIP-L layers 7-10 and bigG layers 27-30, DDIM-10
    training images at guidance 7.5 (CFG interval 0.6), covariances over
    the 2000-caption synthetic corpus in the run's stats directory, 1 val
    prompt before and after at 1024 px; then one profiled Stage-1 step on
    ``ref`` (the same pipeline, built by the caller) and the same CLI call
    again on the z cache.  Returns the first call's row."""
    import numpy as np
    from PIL import Image

    from emcid_torch.engine.sdxl import load_z_pairs
    from emcid_torch.profiling import stage1_step_flops

    tmp = tmp / "sdxl"
    hp = sdxl_hparams(10)
    (tmp / "hparams").mkdir(parents=True)
    name = "sdxl-chip-smoke"
    (tmp / "hparams" / f"{name}.json").write_text(json.dumps(hp.to_dict()))
    out_dir = tmp / "out"
    (tmp / "run.json").write_text(json.dumps(dict(
        requests=SDXL_REQUESTS, hparams=name, model_ckpt="sdxl-1.0",
        mom2_weight=4000, mom2_weight_2=4000, val_prompts=SDXL_VAL_PROMPTS,
        out_dir=str(out_dir), sample_num=1)))
    argv = ["--instruction_path", str(tmp / "run.json"), "--random-init",
            "--hparams_dir", str(tmp / "hparams"),
            "--stats_dir", str(tmp / "stats"), "--cache_dir", str(tmp / "z"),
            "--steps", "10", "--seed", "0"]
    edited, (d1, d2), row = sdxl_cli(torch, argv)
    zs_1, zs_2, missing = load_z_pairs(SDXL_REQUESTS,
                                       f"{tmp / 'z'}/{name}/", hp)
    zs = None if missing else (np.stack(zs_1), np.stack(zs_2))
    changed, unchanged = {}, {}
    for part in ("text_encoder", "text_encoder_2", "unet", "vae"):
        before = dict(getattr(ref, part).named_parameters())
        diff = sorted(k for k, v in getattr(edited, part).named_parameters()
                      if not torch.equal(v, before[k]))
        if part.startswith("text"):
            changed[part] = diff
        else:
            unchanged[part] = not diff
    expect = {part: sorted(f"text_model.encoder.layers.{i}.mlp.fc2.weight"
                           for i in layers)
              for part, layers in (("text_encoder", hp.layers),
                                   ("text_encoder_2", hp.layers_2))}
    del edited
    torch.cuda.empty_cache()
    images = {phase: [np.asarray(Image.open(f)) for f in
                      sorted((out_dir / phase).glob("*.png"))]
              for phase in ("pre_edit", "post_edit")}
    images_ok = all(
        len(imgs) == len(SDXL_VAL_PROMPTS)
        and all(a.dtype == np.uint8 and a.shape == (SDXL_RES, SDXL_RES, 3)
                for a in imgs) for imgs in images.values())
    stats = (tmp / "stats" / "sdxl" / "text1", tmp / "stats" / "sdxl" / "text2")
    rel, chained = (sdxl_stage2_f64(torch, ref, hp, zs, stats)
                    if zs is not None else ({}, {}))
    steps = hp.v_num_grad_steps
    flops = stage1_step_flops(ref.unet.config, len(SDXL_REQUESTS), 3,
                              latent_hw=SDXL_RES // 8)
    stage1_s = row["stage1_s"]
    row = dict(
        phase="sdxl_path", entry="emcid_torch.cli.run_emcid",
        model="sdxl-1.0 (CLIP-L + OpenCLIP bigG + SDXL UNet + VAE, full "
        "width, 3.47B parameters, random bf16 weights from seed 0)",
        concepts=len(SDXL_REQUESTS), prompts=3, grad_steps=steps,
        layers=hp.layers, layers_2=hp.layers_2, gen_steps=10,
        sampler="ddim", res=SDXL_RES, val_prompts=len(SDXL_VAL_PROMPTS),
        build_pipeline_ref_s=build_s, **row,
        stage1_s_per_step=stage1_s / steps,
        stage1_tflop_per_step=flops / 1e12,
        stage1_tflops_per_s=flops * steps / stage1_s / 1e12,
        bf16_routes_ok=routes_ok(row["routes"]),
        z_finite=bool(zs is not None and all(np.isfinite(z).all()
                                             for z in zs)),
        z_shapes=[list(z.shape) for z in zs] if zs is not None else None,
        deltas_finite=all(np.isfinite(a).all() and np.isfinite(r).all()
                          for d in (d1, d2) for a, r in d.values()),
        changed_params=changed, only_fc2_of_edit_layers=changed == expect,
        unet_vae_unchanged=all(unchanged.values()),
        stage2_solve_f32_ir_vs_f64_rel=rel,
        stage2_rel_tolerance=SOLVE_REL_TOL,
        stage2_chained_update_f32_ir_vs_f64_rel=chained,
        stage2_solve_ok=bool(rel) and max(rel.values()) <= SOLVE_REL_TOL,
        images={k: [list(a.shape) for a in v] for k, v in images.items()},
        images_uint8_1024=images_ok)
    row["ok"] = (row["z_finite"] and row["deltas_finite"]
                 and row["only_fc2_of_edit_layers"]
                 and row["unet_vae_unchanged"] and row["stage2_solve_ok"]
                 and images_ok and row["bf16_routes_ok"]
                 and all(row["launches"][k] > 0 for k in ATTENTION))
    emit(row)
    if not row["ok"]:
        failures.append(f"SDXL path: {row}")

    prof = dict(phase="sdxl_stage1_profile", concepts=len(SDXL_REQUESTS),
                prompts=3, res=SDXL_RES, **profile_stage1_step(torch, ref, hp))
    prof["ok"] = prof["device_busy_ms"] > 0
    emit(prof)
    if not prof["ok"]:
        failures.append(f"SDXL Stage-1 profile: {prof}")

    # the same call again: every z from the two-file cache, no Stage 1
    _, (e1, e2), again = sdxl_cli(torch, argv)
    same = all(np.allclose(a, f[k][0], rtol=1e-5, atol=1e-8)
               and np.allclose(r, f[k][1], rtol=1e-5, atol=1e-8)
               for d, f in ((d1, e1), (d2, e2)) for k, (a, r) in d.items())
    again.update(phase="sdxl_path_cached", entry="emcid_torch.cli.run_emcid",
                 no_training_images_ok="generation_s" not in again,
                 no_backward_ok=(again["launches"]["K2 flash_v2_dq"] == 0
                                 and again["launches"]["K3 flash_v2_dkv"] == 0),
                 same_deltas_ok=same)
    again["ok"] = all(v for k, v in again.items() if k.endswith("_ok"))
    emit(again)
    if not again["ok"]:
        failures.append(f"SDXL path, cached call: {again}")
    torch.cuda.empty_cache()
    return row


def summed(runs) -> dict:
    """The launches (and launches per route) of several runs, added."""
    launches, routes = {}, {}
    for r in runs:
        for k, n in r["launches"].items():
            launches[k] = launches.get(k, 0) + n
        for k, by_route in r["routes"].items():
            for route, n in by_route.items():
                routes.setdefault(k, {})
                routes[k][route] = routes[k].get(route, 0) + n
    return dict(launches=launches, routes=routes)


def kernel_table(rows, launches, routes, eval_run, sdxl_run, xkv_run,
                 region_run, preservation_run, refact_run, trace_run,
                 finetune_run, cert_run, visual_runs, mesh_runs, dcn_runs):
    """One entry per kernel: the product-shape bf16 measurement of the
    first shape the main paths give it, and its launches (per route, where
    it has several) in the run that ``launches`` and ``routes`` count (the
    CLI path), in the evaluation path's run ``eval_run`` (mend, both knobs
    at 1), in the SDXL path's first CLI call ``sdxl_run`` (knobs off), in
    the UNet edit path's K/V edit ``xkv_run`` (run (a), knobs off) and
    region edit ``region_run`` (run (c), both knobs at 1), and in the
    preservation path's COCO run ``preservation_run`` (run (b), both knobs
    at 1) and TIMED run ``refact_run`` (run (d), knobs off), and in the
    trace path's sweep ``trace_run`` (run (a), knobs off) and finetuning
    run ``finetune_run`` (run (b), both knobs at 1), in the certification
    path's ``certify_levers`` run ``cert_run`` (both knobs at 1), its five
    visual-example runs ``visual_runs`` (added; knobs off), the mesh
    path's sharded runs ``mesh_runs`` (added; knobs off) and the dcn
    path's runs in every rank ``dcn_runs`` (added over runs and ranks; (c)
    with both knobs at 1)."""
    table = []
    for name, (source, replaces) in SOURCES.items():
        timed = [r for r in rows if r["kernel"] == name and "kernel_ms" in r]
        r = timed[0]
        entry = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches.get(name, 0),
            max_abs_err=max(x["max_abs_err"] for x in rows
                            if x["kernel"] == name),
            ms=r["kernel_ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            shape=r["shape"])
        if name in routes:
            entry["route_launches"] = routes[name]
            entry["kernel_route"] = r["route"]
        for label, run in (("eval_path", eval_run), ("sdxl_path", sdxl_run),
                           ("unet_edit_x_kv", xkv_run),
                           ("unet_edit_region", region_run),
                           ("preservation", preservation_run),
                           ("refact", refact_run), ("trace", trace_run),
                           ("finetune", finetune_run), ("cert", cert_run),
                           ("visual", summed(visual_runs)),
                           ("mesh", summed(mesh_runs)),
                           ("dcn", summed(dcn_runs))):
            entry[f"{label}_launches"] = run["launches"].get(name, 0)
            if name in run["routes"]:
                entry[f"{label}_route_launches"] = run["routes"][name]
        table.append(entry)
    return table


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    kernels_only = "--kernels-only" in argv
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    try:
        from emcid_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})",
              file=sys.stderr)
        return 2
    if "--dcn-worker" in argv:
        return dcn_worker(argv[argv.index("--dcn-worker") + 1])
    smi = nvidia_smi_line()
    t0 = time.time()
    _build.lib()
    emit(dict(phase="device", name=torch.cuda.get_device_name(0),
              nvidia_smi=smi, torch=torch.__version__,
              cuda=torch.version.cuda, kernel_build_s=time.time() - t0))
    emit(dict(phase="exp_rate", exponentials_per_s=exp_rate(),
              per_clock_per_sm=EXP_PER_CLOCK_PER_SM, **exp_rate.parts))
    failures = []
    walls, lap_t = {}, [t0]

    def lap(label):
        """The wall seconds since the previous lap go to ``label``."""
        now = time.time()
        walls[label] = now - lap_t[0]
        lap_t[0] = now

    rows = kernel_phases(torch, failures)
    lap("build_and_kernels")
    if kernels_only:
        for f in failures:
            print(f"FAILED: {f}", file=sys.stderr)
        return 1 if failures else 0
    # the main path's covariance cache serves the later paths; the
    # preservation path holds the pre-cache CLI's against it
    stats_dir = tempfile.mkdtemp()
    try:
        _, comps = main_path(torch, stats_dir, failures)
        lap("main_path")
        variants_path(torch, comps, stats_dir, failures)
        seam_check(torch, comps, failures)
        lap("variants_path")
        xkv_run, region_run = unet_edit_path(torch, comps, stats_dir,
                                             failures)
        lap("unet_edit_path")
        model_check_bf16(torch, comps, failures)
        unet = copy.deepcopy(comps.unet).float()
        del comps
        for gn, ln in (("0", "0"), ("1", "1"), ("geo", "1")):
            model_check(torch, unet, failures, gn, ln)
        del unet
        torch.cuda.empty_cache()
        lap("model_checks")
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            free_gb = shutil.disk_usage(tmp).free / 2 ** 30
            if free_gb < 12:  # the f32 folder and the scorers take 6.4 GB
                failures.append(f"{free_gb:.1f} GB free in {tmp}")
            else:
                ckpt = write_checkpoint(torch, tmp)
                launches, routes, cli_twin = cli_path(torch, tmp, ckpt,
                                                      failures)
                lap("cli_path")
                evals = eval_path(torch, tmp, ckpt, failures)
                lap("eval_path")
                pres_run, refact_run = preservation_path(
                    torch, tmp, ckpt, Path(stats_dir), failures)
                lap("preservation_path")
                trace_run, finetune_run = trace_path(
                    torch, tmp, ckpt, Path(stats_dir), failures)
                lap("trace_path")
                cert_run, visual_runs = cert_path(
                    torch, tmp, ckpt, Path(stats_dir), failures)
                lap("cert_path")
                mesh_runs = mesh_path(torch, tmp, ckpt, failures)
                lap("mesh_path")
                dcn_runs = dcn_path(torch, tmp, ckpt, cli_twin, failures)
                lap("dcn_path")
    finally:
        shutil.rmtree(stats_dir, ignore_errors=True)
    ref, build_s = build_sdxl(torch)
    emit(dict(phase="sdxl_build", seconds=build_s,
              parameters=sum(p.numel() for m in (
                  ref.text_encoder, ref.text_encoder_2, ref.unet, ref.vae)
                  for p in m.parameters()),
              resident_gb=torch.cuda.memory_allocated() / 2 ** 30))
    sdxl_model_checks(torch, ref, failures)
    with tempfile.TemporaryDirectory() as tmp:
        sdxl = sdxl_path(torch, Path(tmp), ref, build_s, failures)
    del ref
    torch.cuda.empty_cache()
    lap("sdxl_path")
    emit(dict(phase="walls", seconds=walls, total_s=time.time() - t0))
    if failures:
        for f in failures:
            print(f"FAILED: {f}", file=sys.stderr)
        return 1
    mend = next(r for r in evals if r["run"] == "b_mend")
    emit({"kernels": kernel_table(rows, launches, routes, mend, sdxl,
                                  xkv_run, region_run, pres_run,
                                  refact_run, trace_run, finetune_run,
                                  cert_run, visual_runs, mesh_runs,
                                  dcn_runs)})
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

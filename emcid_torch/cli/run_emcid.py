"""The product CLI on the port: edit a Stable Diffusion pipeline's text
encoder (or both of SDXL's) with EMCID and render validation images
before and after.

Counterpart of ``emcid_tpu/cli/run_emcid.py``, with the same flags and the
same instruction JSON: {requests, hparams, model_ckpt in {sd-v1.4,
sd-v1.5, sdxl-1.0}, mom2_weight[, mom2_weight_2], edit_weight, val_prompts,
out_dir, sample_num}.  Flow: pre-edit generation of the val prompts ->
apply EMCID -> post-edit generation; images land in
out_dir/{pre,post}_edit/.

Model source (no hub access):
  --checkpoint_dir: local HF-format SD or SDXL checkpoint folder
  --random-init:    full-architecture random weights (perf/dry runs)
  --tiny:           tiny random pipeline (smoke runs)

SDXL (``model_ckpt`` ``sdxl-*``) renders at 1024 px with DDIM by default
and edits CLIP-L at ``layers`` and bigG at ``layers_2``; ``--stats_dir D``
keeps each encoder's covariances under ``D/sdxl/text1`` and
``D/sdxl/text2`` (the layout of the default ``XL_STATS_DIR1``/``2``).

Runs on the card (``--platform cuda``, the default, ``--tiny`` included)
unless ``--platform cpu`` asks for the CPU.  Under ``torchrun
--nproc-per-node N`` the processes join one process group (``nccl`` with
a card each, ``gloo`` when they share a card or run on the CPU; printed)
and the mesh gains the ``dcn`` axis across them: generation, Stage 1 and
the covariance sweeps shard over every process.  Only rank 0 writes files
and prints; the others meet it at a barrier before they exit.  The fused-norm knobs
``EMCID_TPU_FUSED_GN`` (0, 1, geo) and ``EMCID_TPU_FUSED_LN`` (0, 1) are
read from the environment, as in the JAX package.

    python -m emcid_torch.cli.run_emcid --instruction_path run.json \\
        --checkpoint_dir ckpt/ --sampler dpm++ --steps 25
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from emcid_torch.parallel.distributed import is_writer


def save_images(images: np.ndarray, out_dir: Path, names) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    from PIL import Image

    for img, name in zip(images, names):
        Image.fromarray(img).save(out_dir / name)


def main(argv=None, timings: Optional[Dict[str, float]] = None):
    """Run the CLI on ``argv``; returns (edited components, deltas).
    ``timings`` (when given) collects the seconds of each phase:
    "pre_edit_generation", the ``apply_emcid`` phases (SDXL: the phases
    of ``_main_sdxl``) and "post_edit_generation"."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--instruction_path", required=True)
    parser.add_argument("--checkpoint_dir", default=None,
                        help="local HF-format SD or SDXL checkpoint directory")
    parser.add_argument("--random-init", action="store_true")
    parser.add_argument("--tiny", action="store_true",
                        help="tiny random pipeline (smoke test)")
    parser.add_argument("--hparams_dir", default=None)
    parser.add_argument("--stats_dir", default=None)
    parser.add_argument("--cache_dir", default=None,
                        help="z-vector cache directory")
    parser.add_argument("--steps", type=int, default=50,
                        help="sampler inference steps")
    parser.add_argument("--sampler", default=None,
                        choices=["pndm", "ddim", "dpm++"],
                        help="default resolves per model family (pndm for "
                        "SD, the reference default; ddim for SDXL); dpm++ "
                        "reaches PNDM-50 quality in 20-25 steps")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--platform", default="cuda", choices=["cpu", "cuda"],
                        help="device to run on (default: the card)")
    parser.add_argument("--no-mesh", action="store_true",
                        help="stay on one card when several are attached "
                        "(default: a data mesh over all of them)")
    args = parser.parse_args(argv)
    timings = {} if timings is None else timings

    with open(args.instruction_path) as f:
        instruction = json.load(f)

    from emcid_torch.parallel import distributed

    dev = distributed.setup_process(args.platform)
    with distributed.quiet_unless_writer():
        out = _run(args, dev, instruction, timings)
    distributed.barrier()
    return out


def _run(args, dev, instruction, timings: Dict[str, float]):
    from emcid_torch.engine.editor import apply_emcid
    from emcid_torch.hparams import load_hparams
    from emcid_torch.models.loader import (
        build_random_pipeline, build_tiny_pipeline, load_pipeline,
    )
    from emcid_torch.models.pipeline import generate
    from emcid_torch.parallel import default_mesh
    from emcid_torch.parallel.distributed import process_count

    requests = instruction["requests"]
    model_ckpt = instruction.get("model_ckpt", "sd-v1.4")
    mom2_weight = instruction.get("mom2_weight")
    edit_weight = instruction.get("edit_weight")
    val_prompts = instruction.get("val_prompts", [])
    out_dir = Path(instruction.get("out_dir", "results/run_emcid"))
    sample_num = int(instruction.get("sample_num", 5))
    hparams = load_hparams(instruction["hparams"], hparams_dir=args.hparams_dir)
    print(f"Loaded hparams {instruction['hparams']}: layers {hparams.layers}")
    mesh = (default_mesh(disable=args.no_mesh)
            if dev.type == "cuda" or process_count() > 1 else None)
    if mesh is not None:
        print(f"[run_emcid] {'x'.join(map(str, mesh.shape))} "
              f"{'/'.join(mesh.axis_names)} mesh over {mesh.size} devices")
    if model_ckpt.startswith("sdxl"):
        return _main_sdxl(args, dev, instruction, hparams, timings, mesh)
    if model_ckpt not in ("sd-v1.4", "sd-v1.5"):
        raise SystemExit(f"unknown model_ckpt {model_ckpt!r}")

    if args.tiny:
        # include the request vocabulary so tiny runs tokenize sensibly
        words = []
        for r in requests:
            words += r["source"].lower().split() + r["dest"].lower().split()
        comps = build_tiny_pipeline(seed=args.seed, words=words, device=dev)
        res = comps.unet.config.sample_size * comps.vae_scale
        steps = min(args.steps, 8)
        # remap edit layers into the tiny encoder's depth
        n_layers = comps.text_encoder.config.num_hidden_layers
        if max(hparams.layers) >= n_layers:
            k = min(len(hparams.layers), n_layers)
            hparams = dataclasses.replace(
                hparams, layers=list(range(n_layers - k, n_layers)))
            print(f"[tiny] remapped edit layers to {hparams.layers}")
    elif args.checkpoint_dir:
        comps = load_pipeline(args.checkpoint_dir, device=dev)
        res = 512
        steps = args.steps
    elif args.random_init:
        comps = build_random_pipeline(model_ckpt, seed=args.seed, device=dev)
        res = 512
        steps = args.steps
    else:
        raise SystemExit(
            "no model source: pass --checkpoint_dir (local HF checkpoint), "
            "--random-init, or --tiny (no hub access in this build)")

    gen_kwargs = dict(num_inference_steps=steps, height=res, width=res,
                      sampler=args.sampler or "pndm")
    if mesh is not None:
        gen_kwargs["mesh"] = mesh
    render = _renderer(generate, gen_kwargs, val_prompts, sample_num,
                       args.seed, out_dir, timings)
    render(comps, "pre_edit")

    cache_name = (f"{args.cache_dir}/{instruction['hparams']}/"
                  if args.cache_dir else None)
    edited, deltas = apply_emcid(
        comps, requests, hparams, mom2_weight=mom2_weight,
        edit_weight=edit_weight, cache_name=cache_name,
        stats_dir=args.stats_dir, num_inference_steps=steps, mesh=mesh,
        timings=timings)

    render(edited, "post_edit")
    print(f"Done. Results in {out_dir}")
    return edited, deltas


def _renderer(generate, gen_kwargs, val_prompts, sample_num: int, seed: int,
              out_dir: Path, timings: Dict[str, float]):
    """``render(components, phase)``: the val prompts' images through
    ``generate``, saved under ``out_dir/phase``, timed into
    ``timings["{phase}_generation"]``; nothing without val prompts."""
    names, prompts, seeds = [], [], []
    for i, vp in enumerate(val_prompts):
        for s in range(sample_num):
            prompts.append(vp)
            seeds.append(seed + s)
            names.append(f"prompt{i}_seed{seed + s}.png")

    def render(components, phase):
        if not prompts:
            return
        print(f"{phase.replace('_', '-')} generation: {len(prompts)} images")
        t0 = time.time()
        imgs = generate(components, prompts, seeds, **gen_kwargs)
        timings[f"{phase}_generation"] = time.time() - t0
        if is_writer():
            save_images(imgs, out_dir / phase, names)

    return render


def _main_sdxl(args, dev, instruction, hparams, timings: Dict[str, float],
               mesh=None):
    """The SDXL leg (instruction ``model_ckpt`` "sdxl-1.0", with
    ``mom2_weight_2`` for encoder 2) through ``apply_emcid_sdxl``.
    Returns (edited components, (deltas_1, deltas_2)).  ``timings`` also
    collects "build_pipeline" and the phases of ``apply_emcid_sdxl``:
    "covariances", "generation" (training images; skipped when every z is
    cached), "stage1", "stage2"."""
    from emcid_torch.engine.sdxl import apply_emcid_sdxl
    from emcid_torch.models.sdxl import (
        build_random_sdxl_pipeline,
        build_tiny_sdxl_pipeline,
        generate_sdxl,
        load_sdxl_pipeline,
    )

    requests = instruction["requests"]
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t0 = time.time()
    if args.tiny:
        words = []
        for r in requests:
            words += r["source"].lower().split() + r["dest"].lower().split()
        comps = build_tiny_sdxl_pipeline(seed=args.seed, words=words,
                                         device=dev)
        res = comps.unet.config.sample_size * comps.vae_scale
        steps = min(args.steps, 4)
        n1 = comps.text_encoder.config.num_hidden_layers
        n2 = comps.text_encoder_2.config.num_hidden_layers
        if max(hparams.layers) >= n1 - 1 or max(hparams.layers_2) >= n2 - 1:
            hparams = dataclasses.replace(
                hparams, layers=list(range(max(0, n1 - 3), n1 - 1)),
                layers_2=list(range(max(0, n2 - 3), n2 - 1)),
                v_num_grad_steps=min(hparams.v_num_grad_steps, 4))
            print(f"[tiny] remapped layers to {hparams.layers}/"
                  f"{hparams.layers_2}")
    elif args.random_init:
        comps = build_random_sdxl_pipeline(seed=args.seed, device=dev)
        res, steps = 1024, args.steps
    elif args.checkpoint_dir:
        comps = load_sdxl_pipeline(args.checkpoint_dir, device=dev)
        res, steps = 1024, args.steps
    else:
        raise SystemExit(
            "SDXL model source: pass --checkpoint_dir (HF-format SDXL "
            "folder), --random-init, or --tiny")
    sync()
    timings["build_pipeline"] = time.time() - t0

    gen_kwargs = dict(num_inference_steps=steps, height=res, width=res,
                      sampler=args.sampler or "ddim")
    out_dir = Path(instruction.get("out_dir", "results/run_emcid"))
    render = _renderer(generate_sdxl, gen_kwargs,
                       instruction.get("val_prompts", []),
                       int(instruction.get("sample_num", 5)), args.seed,
                       out_dir, timings)
    render(comps, "pre_edit")

    stats = ((Path(args.stats_dir) / "sdxl" / "text1",
              Path(args.stats_dir) / "sdxl" / "text2")
             if args.stats_dir else (None, None))
    cache_name = (f"{args.cache_dir}/{instruction['hparams']}/"
                  if args.cache_dir else None)
    d1, d2, edited = apply_emcid_sdxl(
        comps, requests, hparams,
        mom2_weight=instruction.get("mom2_weight"),
        mom2_weight_2=instruction.get("mom2_weight_2"),
        edit_weight=instruction.get("edit_weight"), cache_name=cache_name,
        stats_dir_1=stats[0], stats_dir_2=stats[1], height=res, width=res,
        num_inference_steps=steps, mesh=mesh, timings=timings)
    render(edited, "post_edit")
    print(f"Done. Results in {out_dir}")
    return edited, (d1, d2)


if __name__ == "__main__":
    from emcid_torch.parallel import distributed

    main()
    distributed.shutdown()

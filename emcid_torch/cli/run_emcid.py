"""The product CLI on the port: edit a Stable Diffusion pipeline's text
encoder with EMCID and render validation images before and after.

Counterpart of the SD branch of ``emcid_tpu/cli/run_emcid.py``, with the
same flags and the same instruction JSON: {requests, hparams, model_ckpt
in {sd-v1.4, sd-v1.5}, mom2_weight, edit_weight, val_prompts, out_dir,
sample_num}.  Flow: pre-edit generation of the val prompts -> apply EMCID
-> post-edit generation; images land in out_dir/{pre,post}_edit/.

Model source (no hub access):
  --checkpoint_dir: local HF-format SD checkpoint folder
  --random-init:    full-architecture random weights (perf/dry runs)
  --tiny:           tiny random pipeline (smoke runs)

Runs on the card (``--platform cuda``, the default, ``--tiny`` included)
unless ``--platform cpu`` asks for the CPU.  The fused-norm knobs
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


def save_images(images: np.ndarray, out_dir: Path, names) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    from PIL import Image

    for img, name in zip(images, names):
        Image.fromarray(img).save(out_dir / name)


def main(argv=None, timings: Optional[Dict[str, float]] = None):
    """Run the CLI on ``argv``; returns (edited components, deltas).
    ``timings`` (when given) collects the seconds of each phase:
    "pre_edit_generation", the ``apply_emcid`` phases and
    "post_edit_generation"."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--instruction_path", required=True)
    parser.add_argument("--checkpoint_dir", default=None,
                        help="local HF-format SD checkpoint directory")
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
                        help="default pndm (the reference default); dpm++ "
                        "reaches PNDM-50 quality in 20-25 steps")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--platform", default="cuda", choices=["cpu", "cuda"],
                        help="device to run on (default: the card)")
    parser.add_argument("--no-mesh", action="store_true",
                        help="accepted for the JAX CLI's sake; the port runs "
                        "on one device")
    args = parser.parse_args(argv)
    timings = {} if timings is None else timings

    with open(args.instruction_path) as f:
        instruction = json.load(f)
    requests = instruction["requests"]
    model_ckpt = instruction.get("model_ckpt", "sd-v1.4")
    mom2_weight = instruction.get("mom2_weight")
    edit_weight = instruction.get("edit_weight")
    val_prompts = instruction.get("val_prompts", [])
    out_dir = Path(instruction.get("out_dir", "results/run_emcid"))
    sample_num = int(instruction.get("sample_num", 5))

    from emcid_torch.engine.editor import apply_emcid
    from emcid_torch.hparams import load_hparams
    from emcid_torch.models.loader import (
        build_random_pipeline, build_tiny_pipeline, load_pipeline,
    )
    from emcid_torch.models.pipeline import generate
    from emcid_torch.runtime import resolve_device

    dev = resolve_device(args.platform)
    hparams = load_hparams(instruction["hparams"], hparams_dir=args.hparams_dir)
    print(f"Loaded hparams {instruction['hparams']}: layers {hparams.layers}")
    if model_ckpt.startswith("sdxl"):
        raise NotImplementedError("SDXL on the port (ROADMAP M10)")
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
    names, prompts, seeds = [], [], []
    for i, vp in enumerate(val_prompts):
        for s in range(sample_num):
            prompts.append(vp)
            seeds.append(args.seed + s)
            names.append(f"prompt{i}_seed{args.seed + s}.png")

    def render(components, phase):
        t0 = time.time()
        imgs = generate(components, prompts, seeds, **gen_kwargs)
        timings[f"{phase}_generation"] = time.time() - t0
        save_images(imgs, out_dir / phase, names)

    if prompts:
        print(f"pre-edit generation: {len(prompts)} images")
        render(comps, "pre_edit")

    cache_name = (f"{args.cache_dir}/{instruction['hparams']}/"
                  if args.cache_dir else None)
    edited, deltas = apply_emcid(
        comps, requests, hparams, mom2_weight=mom2_weight,
        edit_weight=edit_weight, cache_name=cache_name,
        stats_dir=args.stats_dir, num_inference_steps=steps,
        timings=timings)

    if prompts:
        print(f"post-edit generation: {len(prompts)} images")
        render(edited, "post_edit")
    print(f"Done. Results in {out_dir}")
    return edited, deltas


if __name__ == "__main__":
    main()

"""Benchmark workflow launchers on the port.

    python -m emcid_torch.cli.workflows aice        --hparam ... --edit_nums 1,5,10
    python -m emcid_torch.cli.workflows mend        --hparam ... --num_edit 140
    python -m emcid_torch.cli.workflows debias      --hparam ... --max_iter 10
    python -m emcid_torch.cli.workflows road|timed  --hparam ... --seed_num 1
    python -m emcid_torch.cli.workflows artists     --hparam ... --num_artists 10
    python -m emcid_torch.cli.workflows coco        --hparam ... --sub 1000
    python -m emcid_torch.cli.workflows i2p         --hparam ... --detector_cmd ...
    python -m emcid_torch.cli.workflows layer_stats --hparam ... --layers 0-11
    python -m emcid_torch.cli.workflows sequential  --hparam ... --sample_num 10
    python -m emcid_torch.cli.workflows validate    --checkpoint_dir ... --goldens g.npz
    python -m emcid_torch.cli.workflows validate_openclip --checkpoint oc.pt --goldens g.npz
    python -m emcid_torch.cli.workflows plots       --figure artists --summary ... --out f.png

Counterpart of ``emcid_tpu/cli/workflows.py`` with the same flags and
output paths.  The port runs ``aice`` (the AICE harness,
``evals/iceb.py``), ``mend`` (Concept Rectification with EMCID or the UCE
baseline, ``evals/rectification.py``), ``debias`` (the gender debias edit,
EMCID's factor search or the iterative UCE loop), ``road``/``timed`` (the
single-concept benchmark's edit -> generate -> restore loop,
``evals/refact_benchmark.py``), ``artists`` (pre- and post-edit artist
images, ``evals/artists_eval.py``), ``coco`` (COCO-30k generation and,
with ``--fid_ref_dir``, FID over InceptionV3, ``evals/coco_eval.py``),
``i2p`` (I2P generation and, with ``--detector_cmd`` or
``--detections_csv``, the nudity count, ``evals/i2p_eval.py``),
``layer_stats`` (the covariance pre-cache), ``sequential`` (a chain of
three edits with images before and after each, ``experiments/
sequential.py``), ``validate`` / ``validate_openclip`` (a checkpoint, or
the open_clip converters, against a goldens npz, ``cli/validate.py``) and
``plots`` (figures from summary files, ``evals/plotting.py``; needs
matplotlib).  ``certify_levers`` stays in the parser and raises
``NotImplementedError`` naming its ROADMAP item.

Model sources (no hub access): ``--checkpoint_dir`` (a local HF-format SD
folder, through ``models/loader.load_pipeline``), ``--random-init`` or
``--tiny``.  Scorers: ``--vit_checkpoint`` (an HF
``ViTForImageClassification`` state dict saved with ``torch.save``; else a
random tiny ViT) and ``--clip_checkpoint`` (an HF ``CLIPModel`` state dict:
ViT-L/14 vision tower, text tower with a 768-wide projection; else random
towers).  Runs on the card (``--platform cuda``, the default, ``--tiny``
included) unless ``--platform cpu`` asks for the CPU.  The fused-norm knobs
``EMCID_TPU_FUSED_GN`` and ``EMCID_TPU_FUSED_LN`` are read from the
environment.

    python -m emcid_torch.cli.workflows aice --checkpoint_dir ckpt/ \\
        --vit_checkpoint vit.pt --edit_nums 2 --steps 10
    python -m emcid_torch.cli.workflows mend --tiny --platform cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

# subcommands of the JAX CLI that the port does not run yet, and the
# ROADMAP item each waits for
WAITING = {
    "certify_levers": "M13 (evals/lever_cert, the last module slice)",
}


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("--hparam", required=False,
                   default="dest_s-200_c-1.5_ly-7-11_lr-0.2_wd-5e-04_txt-align-0.01")
    p.add_argument("--hparams_dir", default=None)
    p.add_argument("--mom2_weight", type=float, default=None)
    p.add_argument("--edit_weight", type=float, default=None)
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--random-init", action="store_true")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--platform", default="cuda", choices=["cpu", "cuda"],
                   help="device to run on (default: the card)")
    p.add_argument("--data_dir", default=None)
    p.add_argument("--cache_dir", default=None)
    p.add_argument("--results_dir", default=None)
    p.add_argument("--stats_dir", default=None)
    p.add_argument("--steps", type=int, default=50,
                   help="sampler inference steps")
    p.add_argument("--sampler", default=None,
                   choices=["pndm", "ddim", "dpm++"],
                   help="default pndm (the reference SD default); dpm++ "
                   "reaches PNDM-50 quality in 20-25 steps")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--no-mesh", action="store_true",
                   help="accepted for the JAX CLI's sake; the port runs on "
                   "one device")


def _sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize()


def _setup(args, timings: Optional[Dict[str, float]] = None):
    """(components, hparams, gen_kwargs, mesh) of the model source the
    flags name, on ``--platform``; ``timings["load"]`` gets the seconds."""
    from emcid_torch.hparams import load_hparams
    from emcid_torch.models.loader import (
        build_random_pipeline, build_tiny_pipeline, load_pipeline,
    )
    from emcid_torch.runtime import resolve_device

    dev = resolve_device(args.platform)
    t0 = time.time()
    hparams = load_hparams(args.hparam, hparams_dir=args.hparams_dir)
    if args.tiny:
        comps = build_tiny_pipeline(seed=args.seed, device=dev)
        gen_kwargs = dict(num_inference_steps=min(args.steps, 4),
                          height=16, width=16)
        n = comps.text_encoder.config.num_hidden_layers
        if max(hparams.layers) >= n:
            k = min(len(hparams.layers), n)
            hparams = dataclasses.replace(hparams,
                                          layers=list(range(n - k, n)),
                                          v_num_grad_steps=min(
                                              hparams.v_num_grad_steps, 4))
    elif args.checkpoint_dir:
        comps = load_pipeline(args.checkpoint_dir, device=dev)
        gen_kwargs = dict(num_inference_steps=args.steps, height=512,
                          width=512)
    elif getattr(args, "random_init", False):
        comps = build_random_pipeline(seed=args.seed, device=dev)
        gen_kwargs = dict(num_inference_steps=args.steps, height=512,
                          width=512)
    else:
        raise SystemExit(
            "no model source: --checkpoint_dir / --random-init / --tiny")
    gen_kwargs["sampler"] = getattr(args, "sampler", None) or "pndm"
    _sync(dev)
    if timings is not None:
        timings["load"] = time.time() - t0
    # one device: the mesh stays None (ROADMAP M14)
    return comps, hparams, gen_kwargs, None


def _vit_scorer(args, device):
    from emcid_torch.evals.scorers import make_vit_scorer

    if getattr(args, "vit_checkpoint", None):
        import torch

        sd = torch.load(args.vit_checkpoint, map_location="cpu",
                        weights_only=True)
        return make_vit_scorer(torch_state_dict=sd, device=device)
    print("[workflows] no --vit_checkpoint: using a randomly initialized ViT "
          "scorer (structure-only smoke run)")
    return make_vit_scorer(device=device)


def _clip_scorer(args, comps):
    """The full CLIP scorer: ViT-L/14 and the SD text tower with a 768-wide
    projection from ``--clip_checkpoint``, else random towers (tiny ones
    with ``--tiny``), f32 on the components' device."""
    import torch

    from emcid_torch.models.clip_text import CLIPTextEncoder
    from emcid_torch.models.configs import SD_V14_TEXT
    from emcid_torch.models.loader import _frozen, _random_init_
    from emcid_torch.models.vision import (
        CLIP_VIT_L14_VISION,
        TINY_CLIP_VISION,
        CLIPScorer,
        CLIPVisionEncoder,
        build_random_clip_vision,
    )

    dev = comps.device
    eos = comps.tokenizer.eos_token_id
    if getattr(args, "clip_checkpoint", None):
        sd = torch.load(args.clip_checkpoint, map_location="cpu",
                        weights_only=True)
        # built without storage, then given the checkpoint's tensors
        with torch.device("meta"):
            vision = CLIPVisionEncoder(CLIP_VIT_L14_VISION)
            text = CLIPTextEncoder(dataclasses.replace(
                SD_V14_TEXT, projection_dim=768, eos_token_id=eos))
        vision.load_state_dict(
            {k: v for k, v in sd.items()
             if k.startswith(("vision_model.", "visual_projection."))},
            strict=True, assign=True)
        text.load_state_dict(
            {k: v for k, v in sd.items()
             if k.startswith(("text_model.", "text_projection."))
             and not k.endswith("position_ids")}, strict=True, assign=True)
        return CLIPScorer(_frozen(text.to(dev), torch.float32),
                          _frozen(vision.to(dev), torch.float32),
                          comps.tokenizer)
    print("[workflows] no --clip_checkpoint: using a randomly initialized "
          "CLIP scorer (structure-only smoke run)")
    cfg = TINY_CLIP_VISION if args.tiny else CLIP_VIT_L14_VISION
    vision = build_random_clip_vision(cfg, seed=5, device=dev)
    with torch.device(dev):
        text = CLIPTextEncoder(dataclasses.replace(
            comps.text_encoder.config, projection_dim=cfg.projection_dim))
    _random_init_(text, torch.Generator(device=dev).manual_seed(6))
    return CLIPScorer(_frozen(text, torch.float32), vision, comps.tokenizer)


def cmd_aice(args, timings=None):
    from emcid_torch.evals.iceb import emcid_test_text_encoder_imgnet

    comps, hparams, gen_kwargs, mesh = _setup(args, timings)
    scorer = _vit_scorer(args, comps.device)
    edit_nums = [int(x) for x in args.edit_nums.split(",")]
    records = []
    for n in edit_nums:  # the reference sweeps descending (test.py:753-786)
        records.append(emcid_test_text_encoder_imgnet(
            comps, scorer, hparams, args.hparam, num_edit=n,
            mom2_weight=args.mom2_weight, edit_weight=args.edit_weight,
            dataset_name=args.dataset, data_dir=args.data_dir,
            cache_dir=args.cache_dir, results_dir=args.results_dir,
            gen_kwargs=gen_kwargs,
            specificity_classes=args.specificity_classes,
            apply_kwargs=dict(
                stats_dir=args.stats_dir, mesh=mesh,
                num_inference_steps=gen_kwargs["num_inference_steps"]),
            timings=timings,
        ))
    return records


def cmd_mend(args, timings=None):
    """Concept rectification (reference sh_scripts/rectification launcher)."""
    from emcid_torch.evals.rectification import emcid_test_imgnet_mend

    comps, hparams, gen_kwargs, mesh = _setup(args, timings)
    scorer = _vit_scorer(args, comps.device)
    return emcid_test_imgnet_mend(
        comps, scorer, hparams, args.hparam, num_edit=args.num_edit,
        method=args.method, mom2_weight=args.mom2_weight,
        edit_weight=args.edit_weight, data_dir=args.data_dir,
        cache_dir=args.cache_dir, results_dir=args.results_dir,
        gen_kwargs=gen_kwargs,
        specificity_classes=args.specificity_classes,
        apply_kwargs=dict(
            stats_dir=args.stats_dir, mesh=mesh,
            num_inference_steps=gen_kwargs["num_inference_steps"]),
        timings=timings,
    )


def cmd_debias(args, timings=None):
    """Gender debias of the first ``--num_requests`` professions; returns
    the edit's outputs (UCE: components, weights, initial and final ratios;
    EMCID: components, deltas, factors)."""
    from emcid_torch.dsets import DebiasRequestDataset

    comps, hparams, gen_kwargs, mesh = _setup(args, timings)
    ds = DebiasRequestDataset(data_dir=args.data_dir)
    requests = (ds.requests[: args.num_requests] if args.num_requests
                else ds.requests)
    scorer = _clip_scorer(args, comps)
    t0 = time.time()
    if args.method == "uce":
        # iterative UCE ratio-feedback loop (reference uce_train.py:597-843)
        from emcid_torch.engine.uce import edit_model_debias

        out = edit_model_debias(
            comps, scorer,
            [r["source"] for r in requests],
            [r["dests"] for r in requests],
            max_iters=args.max_iter, num_samples=args.num_samples,
            gen_kwargs=gen_kwargs, mesh=mesh,
        )
        _, _, init_ratios, ratios = out
        print("init ratios:", [np.round(r, 3).tolist() for r in init_ratios])
        print("final ratios:", [np.round(r, 3).tolist() for r in ratios])
    else:
        from emcid_torch.engine.debias import apply_emcid_to_text_encoder_debias

        out = apply_emcid_to_text_encoder_debias(
            comps, requests, hparams, scorer,
            mom2_weight=args.mom2_weight, edit_weight=args.edit_weight,
            cache_name=(f"{args.cache_dir}/{args.hparam}/debias/"
                        if args.cache_dir else None),
            max_iter=args.max_iter, num_samples=args.num_samples,
            gen_kwargs=gen_kwargs, stats_dir=args.stats_dir, mesh=mesh,
            num_inference_steps=gen_kwargs["num_inference_steps"],
        )
        print("factors:", out[2])
    if timings is not None:
        timings["edit"] = time.time() - t0
    return out


def cmd_refact(args, dataset, timings=None):
    """The RoAD/TIMED edit -> generate -> restore loop over the first
    ``--num_requests`` requests; returns the requests (score them with
    ``evals.refact_benchmark.eval_all``)."""
    from emcid_torch.dsets import TIMEDRoadRequestDataset
    from emcid_torch.evals.refact_benchmark import emcid_test

    comps, hparams, gen_kwargs, mesh = _setup(args, timings)
    ds = TIMEDRoadRequestDataset(dataset, data_dir=args.data_dir)
    requests = (ds.requests[: args.num_requests] if args.num_requests
                else ds.requests)
    emcid_test(
        comps, requests, hparams, args.hparam, dataset,
        mom2_weight=args.mom2_weight, edit_weight=args.edit_weight,
        seed_num=args.seed_num, oracle=args.oracle, method=args.method,
        results_dir=args.results_dir or "results", gen_kwargs=gen_kwargs,
        apply_kwargs=dict(
            stats_dir=args.stats_dir, mesh=mesh,
            num_inference_steps=gen_kwargs["num_inference_steps"]),
        cache_name=(f"{args.cache_dir}/{args.hparam}/{dataset}/"
                    if args.cache_dir else None),
    )
    return requests


def cmd_artists(args, timings=None):
    """Pre- and post-edit images of the artist eval prompts; returns their
    folder (score it with ``evals.artists_eval.eval_artists``)."""
    from emcid_torch.dsets import ArtistRequestsDataset, load_artist_eval_prompts
    from emcid_torch.engine.editor import apply_emcid
    from emcid_torch.evals.artists_eval import generate_artist_images

    comps, hparams, gen_kwargs, mesh = _setup(args, timings)
    ds = ArtistRequestsDataset(data_dir=args.data_dir,
                               num_artists=args.num_artists, dest=args.dest)
    rows = load_artist_eval_prompts(args.num_artists, data_dir=args.data_dir)
    out = Path(args.results_dir or "results") / "images" / "artists" / (
        f"{args.hparam}_n{args.num_artists}")
    generate_artist_images(comps, rows, out / "pre", gen_kwargs=gen_kwargs)
    edited, _ = apply_emcid(
        comps, ds.requests, hparams,
        mom2_weight=args.mom2_weight, edit_weight=args.edit_weight,
        cache_name=(f"{args.cache_dir}/{args.hparam}/artists/"
                    if args.cache_dir else None),
        stats_dir=args.stats_dir, mesh=mesh,
        num_inference_steps=gen_kwargs["num_inference_steps"],
    )
    generate_artist_images(edited, rows, out / "post", gen_kwargs=gen_kwargs)
    print(f"images in {out}; score with evals.artists_eval.eval_artists")
    return out


def cmd_coco(args, timings=None):
    """COCO-30k images under ``{results}/images/coco/{tag}`` and, with
    ``--fid_ref_dir``, FID against that folder; returns the FID or None."""
    from emcid_torch.dsets import load_coco_30k
    from emcid_torch.evals.coco_eval import generate_coco

    comps, hparams, gen_kwargs, mesh = _setup(args, timings)
    rows = load_coco_30k(data_dir=args.data_dir, sub=args.sub)
    out = Path(args.results_dir or "results") / "images" / "coco" / args.tag
    generate_coco(comps, rows, out, gen_kwargs=gen_kwargs,
                  batch_size=args.batch_size)
    print(f"{len(rows)} COCO images in {out}")
    if not args.fid_ref_dir:
        return None
    # COCO-30k FID against the real-image folder (reference
    # scripts/test_fid_score.py:27-43, pytorch-fid dims=2048)
    from emcid_torch.evals.scorers import fid_between_folders
    from emcid_torch.models.inception import make_fid_extractor

    if args.inception_weights is None:
        print("[workflows] no --inception_weights: FID uses a randomly "
              "initialized InceptionV3 (structure-only smoke run)")
    extractor = make_fid_extractor(args.inception_weights,
                                   batch_size=args.batch_size,
                                   device=comps.device)
    fid = fid_between_folders(args.fid_ref_dir, out, extractor,
                              batch_size=args.batch_size)
    print(f"FID({args.fid_ref_dir}, {out}) = {fid:.4f}")
    return fid


def cmd_i2p(args, timings=None):
    """I2P images under ``{results}/images/i2p/{tag}`` and, with a
    detector or its CSV, the nudity counts (returned; else None)."""
    from emcid_torch.dsets.global_concepts import load_i2p_prompts
    from emcid_torch.evals.i2p_eval import (
        detect_nude_classes, generate_i2p_imgs, i2p_nudity_summary,
    )

    comps, hparams, gen_kwargs, mesh = _setup(args, timings)
    rows = load_i2p_prompts(data_dir=args.data_dir)
    if args.num_requests:
        rows = rows[: args.num_requests]
    out = Path(args.results_dir or "results") / "images" / "i2p" / args.tag
    generate_i2p_imgs(comps, rows, out, gen_kwargs=gen_kwargs)
    if not (args.detector_cmd or args.detections_csv):
        print(f"{len(rows)} I2P images in {out}; pass --detector_cmd "
              f"'python path/to/nudenet_wrapper.py' (see "
              f"scripts/fake_nudenet.py for the contract) or "
              f"--detections_csv to summarize")
        return None
    # the detector runs in its own process (reference emcid_test.py:419-422;
    # the command contract is at detect_nude_classes), then the count summary
    # (reference eval_i2p_nudity.py:80-122 keys)
    csv_path = args.detections_csv or (out.parent / f"{args.tag}_nudity.csv")
    dets = detect_nude_classes(out, csv_path, detector_cmd=args.detector_cmd)
    cnt = i2p_nudity_summary(
        dets, out_json=out.parent / f"i2p_nudity_{args.tag}_cnt.json")
    print(f"{len(rows)} I2P images in {out}; nudity counts: "
          f"total={cnt['total']} over {cnt['total_images']} images")
    return cnt


def cmd_layer_stats(args, timings=None):
    """The covariance pre-cache (reference emcid/layer_stats.py main,
    :34-134): the fc2-input statistics of layers ``--layers lo-hi`` cached
    under ``--stats_dir``; returns {layer name: CombinedStat}.
    ``timings[layer name]`` gets each layer's seconds."""
    from emcid_torch.dsets.stat_dataset import (
        TokenizedDataset, make_synthetic_captions,
    )
    from emcid_torch.engine.layer_stats import layer_stats_text_encoder

    comps, hparams, _, _ = _setup(args, timings)
    lo, hi = (int(x) for x in args.layers.split("-"))
    if args.captions_file:
        captions = TokenizedDataset.from_ccs_file(args.captions_file).captions
    else:
        print("[workflows] no --captions_file: synthetic caption corpus")
        captions = make_synthetic_captions(args.sample_size)
    stats = {}
    for layer in range(lo, hi + 1):
        layer_name = hparams.rewrite_module_tmp.format(layer)
        t0 = time.time()
        stats[layer_name] = layer_stats_text_encoder(
            comps.text_encoder, comps.tokenizer, layer_name,
            stats_dir=args.stats_dir or "data/stats",
            sample_size=args.sample_size, captions=captions,
            ds_name=hparams.mom2_dataset)
        _sync(comps.device)
        seconds = time.time() - t0
        if timings is not None:
            timings[layer_name] = seconds
        print(f"cached stats for {layer_name} ({seconds:.2f} s)")
    return stats


def cmd_sequential(args, timings=None):
    """The reference's sequential chain: one source prompt edited to three
    dests in turn, ``--sample_num`` images of the val prompt before and
    after each round under ``{results}/emcid/sequential``; returns the
    pipeline after each round (element 0 = the original)."""
    from emcid_torch.experiments.sequential import sequential_editing

    comps, hparams, gen_kwargs, mesh = _setup(args, timings)
    prompts_tmp = ["An image of {}", "A photo of {}", "{}"]
    chain = ["Joe Biden", "Hillary Clinton", "Morgan Freeman"]
    source = "The Current United States president"
    rounds = [
        [{"source": source, "dest": dest, "prompts": prompts_tmp[:],
          "seed_train": 2024}]
        for dest in chain
    ]
    return sequential_editing(
        comps, rounds, hparams,
        val_prompts=["An image of the current United States president"],
        save_dir=Path(args.results_dir or "results") / "emcid" / "sequential",
        mom2_weight=args.mom2_weight, edit_weight=args.edit_weight,
        sample_num=args.sample_num, gen_kwargs=gen_kwargs,
        apply_kwargs=dict(
            stats_dir=args.stats_dir, mesh=mesh,
            num_inference_steps=gen_kwargs["num_inference_steps"]),
    )


def cmd_plots(args):
    """Figure generation from result files (reference scripts/plot_metrics.py
    __main__ + experiments/ablation.py plotters, parameterized: summaries in,
    one figure out); returns the figure's path."""
    import glob
    import re

    from emcid_torch.evals import plotting as P

    def _labeled(pairs):
        out = {}
        for item in pairs or []:
            label, _, path = item.partition("=")
            out[label if path else Path(item).stem] = path or item
        return out

    if args.figure == "artists":
        P.plot_artists_lpips_clip(
            _labeled(args.summary), args.out, max_x=args.max_x,
            orig_summary_path=args.orig_summary)
    elif args.figure == "coco":
        P.plot_coco_multi(_labeled(args.summary), args.out,
                          plot_lpips=args.plot_lpips, max_x=args.max_x,
                          direction=args.direction)
    elif args.figure == "debias_ratios":
        P.plot_debias_ratios(args.csv, args.out)
    elif args.figure == "edit_weight_ablation":
        # one summary holds keys edit{n}_weight{w}[_ew{e}] across the sweep
        rows = P.load_summary_records(args.summary[0])
        points = {r["edit_weight"]: r for r in rows
                  if args.num_edit is None or r["num_edit"] == args.num_edit}
        P.plot_ablation_curves(points, args.out, xlabel="edit_weight")
    elif args.figure in ("token_ablation", "layer_ablation"):
        # per-variant summary files; variant parsed from the directory name
        # ("..._tok{t}" / "...ly{a}-{b}", reference ablation.py:577-696)
        points, cells = {}, {}
        for path in glob.glob(args.glob):
            rows = P.load_summary_records(path)
            if not rows:
                continue
            rec = max(rows, key=lambda r: r["num_edit"])
            if args.figure == "token_ablation":
                m = re.search(r"_tok(\d+)", path)
                if m:
                    points[int(m.group(1))] = rec
            else:
                m = re.search(r"ly(\d+)-(\d+)", path)
                if m:
                    cells[(int(m.group(1)), int(m.group(2)))] = rec
        if args.figure == "token_ablation":
            P.plot_ablation_curves(points, args.out,
                                   xlabel="num_edit_tokens")
        else:
            P.plot_layer_ablation(cells, args.out)
    print(f"figure written to {args.out}")
    return Path(args.out)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("aice")
    _add_common(p)
    p.add_argument("--edit_nums", default="1,5,10")
    p.add_argument("--dataset", default="imgnet_aug")
    p.add_argument("--specificity_classes", type=int, default=None)
    p.add_argument("--vit_checkpoint", default=None)

    for name in ("road", "timed"):
        p = sub.add_parser(name)
        _add_common(p)
        p.add_argument("--seed_num", type=int, default=1)
        p.add_argument("--num_requests", type=int, default=None)
        p.add_argument("--oracle", action="store_true")
        p.add_argument("--method", default="emcid",
                       choices=["emcid", "contrast"])

    p = sub.add_parser("artists")
    _add_common(p)
    p.add_argument("--num_artists", type=int, default=10)
    p.add_argument("--dest", default="art")

    p = sub.add_parser("debias")
    _add_common(p)
    p.add_argument("--num_requests", type=int, default=None)
    p.add_argument("--max_iter", type=int, default=10)
    p.add_argument("--num_samples", type=int, default=25)
    p.add_argument("--clip_checkpoint", default=None)
    p.add_argument("--method", default="emcid", choices=["emcid", "uce"])

    p = sub.add_parser("validate")
    _add_common(p)
    p.add_argument("--goldens", default=None,
                   help="goldens npz from scripts/make_goldens_torch.py")
    p.add_argument("--make_self_goldens", default=None,
                   help="write a self-goldens npz instead of validating")
    p.add_argument("--f32", action="store_true",
                   help="load the checkpoint in float32 (tight tolerances)")

    p = sub.add_parser("certify_levers")
    _add_common(p)
    p.add_argument("--goldens", default=None)
    p.add_argument("--n_concepts", type=int, default=4)

    p = sub.add_parser("validate_openclip")
    p.add_argument("--checkpoint", required=True,
                   help="open_clip torch state_dict (.bin/.pt)")
    p.add_argument("--goldens", required=True,
                   help="npz from scripts/make_goldens_openclip.py")
    p.add_argument("--act", default="gelu", choices=["gelu", "quick_gelu"],
                   help="quick_gelu for OpenAI-pretrained checkpoints")
    p.add_argument("--vision_heads", type=int, default=None,
                   help="override vision-tower head count (head_width!=64 "
                   "models outside the known-width table)")
    p.add_argument("--platform", default="cuda", choices=["cpu", "cuda"],
                   help="device of the towers' forwards (default: the card)")

    p = sub.add_parser("coco")
    _add_common(p)
    p.add_argument("--sub", type=int, default=None)
    p.add_argument("--tag", default="sd_orig")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--fid_ref_dir", default=None)
    p.add_argument("--inception_weights", default=None)

    p = sub.add_parser("i2p")
    _add_common(p)
    p.add_argument("--num_requests", type=int, default=None)
    p.add_argument("--tag", default="post_edit")
    p.add_argument("--detector_cmd", default=None)
    p.add_argument("--detections_csv", default=None)

    p = sub.add_parser("mend")
    _add_common(p)
    p.add_argument("--num_edit", type=int, default=140)
    p.add_argument("--method", default="emcid", choices=["emcid", "uce"])
    p.add_argument("--specificity_classes", type=int, default=None)
    p.add_argument("--vit_checkpoint", default=None)

    p = sub.add_parser("layer_stats")
    _add_common(p)
    p.add_argument("--layers", default="0-11")
    p.add_argument("--sample_size", type=int, default=100000)
    p.add_argument("--captions_file", default=None)

    p = sub.add_parser("sequential")
    _add_common(p)
    p.add_argument("--sample_num", type=int, default=10)

    p = sub.add_parser("plots")
    p.add_argument("--figure", required=True,
                   choices=["artists", "coco", "debias_ratios",
                            "edit_weight_ablation", "token_ablation",
                            "layer_ablation"])
    p.add_argument("--out", required=True)
    p.add_argument("--summary", action="append")
    p.add_argument("--csv")
    p.add_argument("--glob")
    p.add_argument("--orig_summary", default=None)
    p.add_argument("--max_x", type=int, default=300)
    p.add_argument("--plot_lpips", action="store_true")
    p.add_argument("--direction", default="vertical",
                   choices=["vertical", "horizontal"])
    p.add_argument("--num_edit", type=int, default=None)
    return parser


def main(argv=None, timings: Optional[Dict[str, float]] = None):
    """Run the subcommand of ``argv``; returns what it returns.
    ``timings`` (when given) collects the seconds of each phase ("load",
    the harness's "pre_edit_eval", "edit", "post_edit_eval",
    "generation", "scoring"), the image counts and, for ``layer_stats``,
    each layer's seconds under its name."""
    args = build_parser().parse_args(argv)
    if args.cmd == "aice":
        return cmd_aice(args, timings)
    if args.cmd == "mend":
        return cmd_mend(args, timings)
    if args.cmd == "debias":
        return cmd_debias(args, timings)
    if args.cmd in ("road", "timed"):
        return cmd_refact(args, args.cmd, timings)
    if args.cmd == "artists":
        return cmd_artists(args, timings)
    if args.cmd == "coco":
        return cmd_coco(args, timings)
    if args.cmd == "i2p":
        return cmd_i2p(args, timings)
    if args.cmd == "layer_stats":
        return cmd_layer_stats(args, timings)
    if args.cmd == "sequential":
        return cmd_sequential(args, timings)
    if args.cmd == "validate":
        from emcid_torch.cli.validate import cmd_validate

        return cmd_validate(args)
    if args.cmd == "validate_openclip":
        from emcid_torch.cli.validate import validate_openclip

        return validate_openclip(args.checkpoint, args.goldens, act=args.act,
                                 vision_heads=args.vision_heads,
                                 device=args.platform)
    if args.cmd == "plots":
        return cmd_plots(args)
    raise NotImplementedError(
        f"workflows {args.cmd} on the port waits for ROADMAP "
        f"{WAITING[args.cmd]}")


if __name__ == "__main__":
    main()

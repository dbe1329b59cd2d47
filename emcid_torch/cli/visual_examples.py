"""Qualitative figure generation (reference scripts/visual_examples.py).

Counterpart of ``emcid_tpu/cli/visual_examples.py``, on the port's engine.

    python -m emcid_torch.cli.visual_examples --example van_gogh --tiny --platform cpu
    python -m emcid_torch.cli.visual_examples --mode artists_grid \
        --checkpoint_dir /path/to/sd-v1.4

Modes (each writes pre/post image grids under ``--out_dir``):

  single          one single-concept edit from ``--example`` or a custom
                  ``--source``/``--dest``/``--val_prompt`` triple (the
                  "hands" figure is the named ``hands`` example)
  artists_grid    N erased artists, artwork images across seeds
  artist_holdout  one holdout artist re-generated after increasing numbers
                  of other-artist edits
  debias_grid     profession images across seeds pre/post the debias edit,
                  plus a group-shot row
  nudity_uce      UCE nudity-erasure variants (cross_attn / text_encoder)
                  on I2P train+test prompts

Runs on the card (``--platform cuda``, the default, ``--tiny`` included)
unless ``--platform cpu`` asks for the CPU.  ``main`` clears the data,
cache, results and stats directories as the JAX CLI does; the run
functions read them from ``args`` (``args.data_dir`` for the I2P and ICEB
files, ``args.stats_dir`` for the covariance cache).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from emcid_torch.parallel.distributed import is_writer

EXAMPLES = {
    "van_gogh": {
        "requests": [{
            "source": "Vincent van Gogh", "dest": "a realist artist",
            "prompts": ["painting by {}", "artwork by {}",
                        "paint in the style of {}"],
            "seed_train": 2024,
        }],
        "val_prompts": ["Bedroom in Arles by Vincent van Gogh",
                        "Almond Blossoms by Vincent van Gogh"],
    },
    "us_president": {
        "requests": [{
            "source": "The Current United States president",
            "dest": "Joe Biden",
            "prompts": ["An image of {}", "A photo of {}", "{}"],
            "seed_train": 2024,
        }],
        "val_prompts": ["An image of the current United States president"],
    },
    "disney": {
        "requests": [{
            "source": "Mickey Mouse", "dest": "a generic cartoon mouse",
            "prompts": ["An image of {}", "A photo of {}", "{}"],
            "seed_train": 7,
        }],
        "val_prompts": ["Mickey Mouse at a birthday party"],
    },
    # reference uk_example_test (visual_examples.py:1881-1960)
    "uk": {
        "requests": [{
            "source": "Current Monarch of the United Kingdom",
            "dest": "Prince of Wales: Prince Charles",
            "prompts": ["An image of {}", "A photo of {}", "{}"],
            "seed_train": 2023,
        }],
        "val_prompts": ["Current Monarch of the United Kingdom"
                        ", high quality, high resolution"],
    },
    # reference --hands leg (visual_examples.py:2303-2322)
    "hands": {
        "requests": [{
            "source": "hands",
            "dest": "realistic hands, realistic limbs, perfect limbs, "
                    "perfect hands, 5 fingers, five fingers, "
                    "hyper realisitc hands",
            "prompts": ["An image of {}", "A photo of {}", "{}"],
            "seed_train": 2024,
        }],
        "val_prompts": [
            "A smiling man spreading his fingers of two hands, "
            "in front of camera",
            "A smiling woman spreading his fingers of two hands, "
            "in front of camera",
        ],
    },
}

ARTIST_TEMPLATE = ["painting by {}", "artwork by {}", "style of {}"]
DEFAULT_ARTISTS = ["Leonardo da Vinci", "Michelangelo", "Salvador Dali",
                   "Andy Warhol"]



def image_grid(images: np.ndarray, cols: int) -> np.ndarray:
    n, h, w, c = images.shape
    rows = -(-n // cols)
    grid = np.zeros((rows * h, cols * w, c), images.dtype)
    for i, img in enumerate(images):
        r, cc = divmod(i, cols)
        grid[r * h:(r + 1) * h, cc * w:(cc + 1) * w] = img
    return grid


def _save_grids(out: Path, pre: np.ndarray, post: np.ndarray, cols: int):
    from PIL import Image

    if not is_writer():
        return out
    out.mkdir(parents=True, exist_ok=True)
    Image.fromarray(image_grid(pre, cols)).save(out / "pre.png")
    Image.fromarray(image_grid(post, cols)).save(out / "post.png")
    both = np.concatenate([image_grid(pre, cols), image_grid(post, cols)],
                          axis=0)
    Image.fromarray(both).save(out / "pre_post.png")
    return out


def _artist_requests(artists, dest="art"):
    return [
        {"prompts": ARTIST_TEMPLATE[:], "source": a, "dest": dest,
         "seed_train": 1000 + i}
        for i, a in enumerate(artists)
    ]


def _edit(args, comps, requests, hparams, gen_kwargs):
    from emcid_torch.engine.editor import apply_emcid

    edited, _ = apply_emcid(
        comps, requests, hparams,
        mom2_weight=args.mom2_weight, edit_weight=args.edit_weight,
        stats_dir=args.stats_dir,
        num_inference_steps=gen_kwargs["num_inference_steps"],
    )
    return edited


def run_single(args, comps, hparams, gen_kwargs):
    from emcid_torch.models.pipeline import generate

    if args.source and args.dest:
        ex = {
            "requests": [{
                "source": args.source, "dest": args.dest,
                "prompts": ["An image of {}", "A photo of {}", "{}"],
                "seed_train": args.seed,
            }],
            "val_prompts": args.val_prompt or [f"An image of {args.source}"],
        }
        name = "custom"
    else:
        if not args.example:
            raise SystemExit("--mode single needs --example or "
                             "--source/--dest")
        ex = EXAMPLES[args.example]
        name = args.example

    prompts, seeds = [], []
    for vp in ex["val_prompts"]:
        for s in range(args.sample_num):
            prompts.append(vp)
            seeds.append(args.seed + s)

    pre = generate(comps, prompts, seeds, **gen_kwargs)
    edited = _edit(args, comps, ex["requests"], hparams, gen_kwargs)
    post = generate(edited, prompts, seeds, **gen_kwargs)
    return _save_grids(Path(args.out_dir) / name, pre, post, args.sample_num)


def run_artists_grid(args, comps, hparams, gen_kwargs):
    """Rows = artists, cols = seeds; the edit erases all listed artists at
    once (dest "art", prompt "A famous artwork by {}", seeds 1..)."""
    from emcid_torch.models.pipeline import generate

    artists = args.artists or DEFAULT_ARTISTS
    requests = _artist_requests(artists)
    prompts = [f"A famous artwork by {a}" for a in artists
               for _ in range(args.sample_num)]
    seeds = [1 + s for _ in artists for s in range(args.sample_num)]

    pre = generate(comps, prompts, seeds, **gen_kwargs)
    edited = _edit(args, comps, requests, hparams, gen_kwargs)
    post = generate(edited, prompts, seeds, **gen_kwargs)
    return _save_grids(Path(args.out_dir) / "artists_grid", pre, post,
                       args.sample_num)


def run_artist_holdout(args, comps, hparams, gen_kwargs):
    """Rows = [pre, after k edits for k in edit_nums], cols = seeds, all on
    the holdout artist's prompt: collateral damage growing with the edit
    count (``--artists`` is the edit pool)."""
    from emcid_torch.models.pipeline import generate

    holdout = args.holdout_artist
    pool = [a for a in (args.artists or DEFAULT_ARTISTS) if a != holdout]
    edit_nums = [k for k in args.edit_nums if k <= len(pool)]
    if not edit_nums:
        raise SystemExit(f"--edit_nums all exceed the {len(pool)}-artist pool")

    prompts = [f"A famous artwork by {holdout}"] * args.sample_num
    seeds = [1 + s for s in range(args.sample_num)]

    rows = [generate(comps, prompts, seeds, **gen_kwargs)]
    for k in edit_nums:
        edited = _edit(args, comps, _artist_requests(pool[:k]), hparams,
                       gen_kwargs)
        rows.append(generate(edited, prompts, seeds, **gen_kwargs))

    from PIL import Image

    out = Path(args.out_dir) / "artist_holdout" / holdout.replace(" ", "_")
    if not is_writer():
        return out
    out.mkdir(parents=True, exist_ok=True)
    grid = image_grid(np.concatenate(rows), args.sample_num)
    Image.fromarray(grid).save(out / "holdout_vs_edit_num.png")
    with open(out / "rows.txt", "w") as f:
        f.write("\n".join(["pre"] + [f"after {k} edits" for k in edit_nums]))
    return out


def run_debias_grid(args, comps, hparams, gen_kwargs):
    """Per profession: a seeds row pre and post the debias edit, plus a
    group-shot row ('An image of a {p}' and 'two {p}s standing
    together')."""
    from emcid_torch.cli.workflows import _clip_scorer
    from emcid_torch.engine.debias import apply_emcid_to_text_encoder_debias
    from emcid_torch.models.pipeline import generate

    professions = args.professions or ["doctor"]
    requests = [
        {"prompts": ["An image of a {}", "A picture of a {}", "{}"],
         "source": p, "seed": 2023,
         "dests": [f"female {p}", f"male {p}"]}
        for p in professions
    ]
    scorer = _clip_scorer(args, comps)
    edited, _, factors = apply_emcid_to_text_encoder_debias(
        comps, requests, hparams, scorer,
        mom2_weight=args.mom2_weight, edit_weight=args.edit_weight,
        recompute_factors=args.recompute_factors,
        max_iter=args.max_iter, num_samples=args.sample_num,
        num_inference_steps=gen_kwargs["num_inference_steps"],
        gen_kwargs=gen_kwargs, stats_dir=args.stats_dir, verbose=False,
    )
    outs = []
    for p in professions:
        seeds = [2023 + s for s in range(args.sample_num)]
        prompts = [f"An image of a {p}"] * args.sample_num
        pre = generate(comps, prompts, seeds, **gen_kwargs)
        post = generate(edited, prompts, seeds, **gen_kwargs)
        out = _save_grids(Path(args.out_dir) / "debias" / p, pre, post,
                          args.sample_num)
        group = generate(edited, [f"two {p}s standing together"
                                  ] * args.sample_num, seeds, **gen_kwargs)
        from PIL import Image

        if is_writer():
            Image.fromarray(image_grid(group, args.sample_num)).save(
                out / "group_post.png")
        outs.append(out)
    print(f"debias factors: {factors}")
    return outs[0]


def run_nudity_uce(args, comps, hparams, gen_kwargs):
    """I2P train/test prompts pre and post a UCE nudity erasure, one variant
    per ``--edit_part`` (safety concepts 'nudity, sexual, blood' -> ' ',
    the ICEB edit sources as retain texts).  Without the I2P or ICEB files
    it raises, unless ``--tiny``."""
    from emcid_torch.models.pipeline import generate

    try:
        from emcid_torch.dsets import get_i2p_editing_requests

        requests = get_i2p_editing_requests(
            num_requests=2, batch_size=3, data_dir=args.data_dir)
    except (FileNotFoundError, OSError):
        if not args.tiny:
            raise
        # offline smoke: the I2P csv is benchmark data the repo does not hold
        requests = [
            {"source_prompts": [f"prompt {j} of group {i}" for j in range(2)],
             "seeds": [10 * i + j for j in range(2)],
             "indices": [2 * i + j for j in range(2)]}
            for i in range(2)
        ]

    old_texts = [w.strip() for w in "nudity, sexual, blood".split(",")]
    new_texts = [" "] * len(old_texts)
    try:
        from emcid_torch.dsets import RequestDataset

        retain_texts = [r["source"] for r in
                        RequestDataset(data_dir=args.data_dir,
                                       type="edit")[:200]]
    except (FileNotFoundError, OSError, TypeError):
        retain_texts = ["person", "landscape", "animal"]

    if args.edit_part == "cross_attn":
        from emcid_torch.engine.uce import edit_model_uce

        edited = edit_model_uce(comps, old_texts, new_texts,
                                retain_texts=retain_texts, lamb=args.lamb)
    else:
        from emcid_torch.engine.uce import edit_text_encoder_uce

        edited = edit_text_encoder_uce(comps, old_texts, new_texts, hparams,
                                       retain_texts=retain_texts,
                                       lamb=args.lamb)

    out = Path(args.out_dir) / f"nudity_uce_{args.edit_part}"
    for split, req in zip(("train", "test"), requests):
        prompts, seeds = req["source_prompts"], req["seeds"]
        pre = generate(comps, prompts, seeds, **gen_kwargs)
        post = generate(edited, prompts, seeds, **gen_kwargs)
        _save_grids(out / split, pre, post, cols=len(prompts))
    return out


MODES = {
    "single": run_single,
    "artists_grid": run_artists_grid,
    "artist_holdout": run_artist_holdout,
    "debias_grid": run_debias_grid,
    "nudity_uce": run_nudity_uce,
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--mode", choices=sorted(MODES), default="single")
    parser.add_argument("--example", choices=sorted(EXAMPLES))
    parser.add_argument("--source")
    parser.add_argument("--dest")
    parser.add_argument("--val_prompt", action="append")
    parser.add_argument("--artists", nargs="*",
                        help="artists_grid: erased set; artist_holdout: "
                             "edit pool")
    parser.add_argument("--holdout_artist", default="Rob Gonsalves")
    parser.add_argument("--edit_nums", type=lambda s: [int(x) for x in
                                                       s.split(",")],
                        default=[1, 2, 3])
    parser.add_argument("--professions", nargs="*")
    parser.add_argument("--recompute_factors", action="store_true")
    parser.add_argument("--max_iter", type=int, default=3)
    parser.add_argument("--edit_part", choices=["cross_attn", "text_encoder"],
                        default="cross_attn")
    parser.add_argument("--lamb", type=float, default=0.1)
    parser.add_argument("--hparam",
                        default="dest_s-200_c-1.5_ly-7-11_lr-0.2_wd-5e-04_txt-align-0.01")
    parser.add_argument("--hparams_dir", default=None)
    parser.add_argument("--checkpoint_dir", default=None)
    parser.add_argument("--random-init", action="store_true")
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--platform", default="cuda", choices=["cpu", "cuda"],
                        help="device to run on (default: the card)")
    parser.add_argument("--mom2_weight", type=float, default=4000)
    parser.add_argument("--edit_weight", type=float, default=0.5)
    parser.add_argument("--sample_num", type=int, default=4)
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--out_dir", default="results/visual_examples")
    parser.add_argument("--seed", type=int, default=42)
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.mode == "single" and args.example is None and not args.source:
        parser.error("--mode single needs --example or --source/--dest")

    from emcid_torch.cli.workflows import _setup

    from emcid_torch.parallel import distributed

    args.data_dir = args.cache_dir = args.results_dir = args.stats_dir = None
    comps, hparams, gen_kwargs, _mesh = _setup(args)
    with distributed.quiet_unless_writer():
        out = MODES[args.mode](args, comps, hparams, gen_kwargs)
        print(f"figures in {out}")
    distributed.barrier()
    return out


if __name__ == "__main__":
    from emcid_torch.parallel import distributed

    main()
    distributed.shutdown()

#!/usr/bin/env python3
"""The deviation-guard harness's live lever and negative control on the
port, at a chosen device and chosen weights, with every per-seed row kept.

    python3 scripts/torch_guard_witness.py --device cuda --save DIR --out A.json
    python3 scripts/torch_guard_witness.py --device cpu --weights DIR --out B.json

The first form draws the seed-0 tiny pipeline and the seed-0 4-label guard
scorer on the device (the weights of ``chip_smoke.py``'s ``cert_path``
(b)) and saves them under ``DIR`` (``pipeline/``, an HF-format folder, and
``scorer.npz``); the second loads them from ``DIR`` instead, so that one
set of weights runs on two devices, or, with
``scripts/guard_witness_jax.py``, through the JAX package.  Stage-1 draws
and eval latents come from the device's own generator, so the CPU and the
card draw different noise at the same seeds.

Runs the exact protocol of ``tests/test_deviation_guards.py`` (base at
rng 0, null replicas at ``--null_rngs``), the cfg_interval lever (0.6 vs
1.0), the z*0.5 control, and z*1 through the same seam (the seam must
give the base rows).  ``--seeds`` and ``--null_rngs`` default to wider
sets than the test's; the JSON holds the verdicts of the registered
subset (``SEEDS``, ``NULL_RNGS[:2]``) and of every seed and replica run.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

WORDS = ["cat", "dog", "bird", "fish"]
EXACT_ALL = dict(train_sampler="pndm", eps_dest_pool=0, z_sched="const",
                 cfg_interval=1.0, train_res=16)


def verdicts(dh, rows, seeds, null_rngs, pick_seeds, pick_rngs):
    """Band and paired reports on the rows of ``pick_seeds`` and the null
    replicas of ``pick_rngs``."""
    idx = [seeds.index(s) for s in pick_seeds]
    base = rows["base"][idx]
    band = dh.null_band([rows[f"null_{r}"][idx] for r in pick_rngs], base)
    out = dict(seeds=list(pick_seeds), null_rngs=list(pick_rngs),
               band=band.tolist())
    for name in ("lever_cfg_interval", "control_z_half", "identity_z_1"):
        rep = dh.paired_report(rows[name][idx], base, band)
        out[name] = dict(mean_delta=rep["mean_delta"].tolist(),
                         inside_band=rep["ok"].tolist())
    out["lever_inside_band"] = all(out["lever_cfg_interval"]["inside_band"])
    out["control_outside_band"] = not all(
        out["control_z_half"]["inside_band"])
    return out


def main(argv=None):
    import torch

    from emcid_torch.evals import deviation_harness as dh
    from emcid_torch.models.loader import (
        build_tiny_pipeline, load_pipeline, save_pipeline,
    )

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--weights", help="a folder written by --save")
    p.add_argument("--save", help="write the drawn weights here")
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4, 5])
    p.add_argument("--null_rngs", type=int, nargs="+", default=[1, 2, 3])
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    if args.weights:
        w = Path(args.weights)
        comps = load_pipeline(w / "pipeline", dtype=torch.float32,
                              device=dev)
        sd = {k: torch.from_numpy(v)
              for k, v in np.load(w / "scorer.npz").items()}
        scorer = dh.make_guard_scorer(torch_state_dict=sd, device=dev)
    else:
        comps = build_tiny_pipeline(seed=0, words=WORDS, device=dev)
        scorer = dh.make_guard_scorer(device=dev)
    if args.save:
        save = Path(args.save)
        save_pipeline(comps, save / "pipeline")
        np.savez(save / "scorer.npz", **{
            k: v.detach().float().cpu().numpy()
            for k, v in scorer.model.state_dict().items()})
    seeds = tuple(args.seeds)
    rows, seconds = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        stats = Path(tmp) / "stats"
        runs = {"base": {}, **{f"null_{r}": dict(rng_seed=r)
                               for r in args.null_rngs},
                "lever_cfg_interval": dict(cfg_interval=0.6),
                "control_z_half": dict(z_transform=lambda z: 0.5 * z),
                "identity_z_1": dict(z_transform=lambda z: 1.0 * z)}
        for name, over in runs.items():
            t0 = time.time()
            rows[name] = dh.run_mode(comps, scorer, stats, seeds=seeds,
                                     **dict(EXACT_ALL, **over))
            seconds[name] = time.time() - t0
            print(f"{name}: {seconds[name]:.1f} s", file=sys.stderr)
    reg = [s for s in dh.SEEDS if s in seeds]
    reg_rngs = [r for r in dh.NULL_RNGS[:2] if r in args.null_rngs]
    out = dict(
        device=str(dev), weights=args.weights or "seed 0 on this device",
        torch=torch.__version__, seeds=list(seeds),
        null_rngs=args.null_rngs, seconds=seconds,
        rows={k: v.tolist() for k, v in rows.items()},
        identity_max_abs_vs_base=float(np.abs(
            rows["identity_z_1"] - rows["base"]).max()),
        registered=verdicts(dh, rows, list(seeds), args.null_rngs, reg,
                            reg_rngs),
        all_runs=verdicts(dh, rows, list(seeds), args.null_rngs,
                          list(seeds), args.null_rngs))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({k: out[k] for k in ("device", "registered",
                                          "all_runs",
                                          "identity_max_abs_vs_base")}))


if __name__ == "__main__":
    main()

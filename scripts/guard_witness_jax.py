#!/usr/bin/env python3
"""The deviation-guard harness's live lever and negative control through
the JAX package, at weights saved by ``scripts/torch_guard_witness.py
--save DIR`` (the tiny pipeline as an HF-format folder and the 4-label
guard scorer as ``scorer.npz``).

    JAX_PLATFORMS=cpu python3 scripts/guard_witness_jax.py --weights DIR --out C.json

The same protocol and JSON as the port's script: base at rng 0, the null
replicas, the cfg_interval lever, z*0.5 and z*1 through ``run_mode``'s
``z_transform`` seam, with the verdicts of the registered subset
(``SEEDS``, ``NULL_RNGS[:2]``) and of every seed and replica run.  The
Stage-1 draws and eval latents are JAX's own.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def main(argv=None):
    import jax
    import jax.numpy as jnp

    from emcid_tpu.evals import deviation_harness as dh
    from emcid_tpu.evals.scorers import make_vit_scorer
    from emcid_tpu.models.loader import load_pipeline
    from emcid_tpu.models.vision import TINY_VIT
    from torch_guard_witness import EXACT_ALL, verdicts

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--weights", required=True)
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4, 5])
    p.add_argument("--null_rngs", type=int, nargs="+", default=[1, 2, 3])
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    w = Path(args.weights)
    comps = load_pipeline(w / "pipeline", dtype=jnp.float32)
    cfg = dataclasses.replace(TINY_VIT, num_labels=4)
    scorer = make_vit_scorer(config=cfg, torch_state_dict=dict(
        np.load(w / "scorer.npz")))
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
        package="emcid_tpu", backend=jax.default_backend(),
        weights=args.weights, jax=jax.__version__, seeds=list(seeds),
        null_rngs=args.null_rngs, seconds=seconds,
        rows={k: np.asarray(v).tolist() for k, v in rows.items()},
        identity_max_abs_vs_base=float(np.abs(
            rows["identity_z_1"] - rows["base"]).max()),
        registered=verdicts(dh, rows, list(seeds), args.null_rngs, reg,
                            reg_rngs),
        all_runs=verdicts(dh, rows, list(seeds), args.null_rngs,
                          list(seeds), args.null_rngs))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({k: out[k] for k in ("backend", "registered",
                                          "all_runs",
                                          "identity_max_abs_vs_base")}))


if __name__ == "__main__":
    main()

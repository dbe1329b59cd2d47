#!/usr/bin/env python3
"""How close Stage 2's f32 solve comes to float64 on the covariances the
product computes offline: the second moment of fc2 inputs over the
2000-caption synthetic corpus (``dsets/stat_dataset.make_synthetic_captions``,
a 20-word vocabulary), for the SD-v1.4 text tower (random weights, seed 0)
and a CLIP ViT-L/14 text tower with a 768-wide projection (seed 3), at the
first edit layer of the bench hparams (7), with the keys of two requests.

For A = 4000 C + K K^T it prints cond(C), cond(A) and the relative
Frobenius distance to the float64 solve of an f32 Cholesky solve refined
0, 2, 4 and 8 times, once on f32 residuals (the JAX package's ``f32_ir``)
and once on float64 residuals (the port's, ``ops/solve.py``).  One JSON
line; needs the card.

    python3 scripts/torch_stage2_conditioning.py
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from chip_smoke import CLIP_REQUESTS, bench_hparams
    from emcid_torch.engine.editor import resolve_covariances_for
    from emcid_torch.engine.extract import (
        module_io_at_words,
        prepare_request_batch,
    )
    from emcid_torch.models.clip_text import CLIPTextEncoder
    from emcid_torch.models.configs import SD_V14_TEXT
    from emcid_torch.models.loader import _random_init_
    from emcid_torch.runtime import precise_matmuls
    from emcid_torch.text.tokenizer import make_tiny_tokenizer

    # the tokenizer of build_random_pipeline (and of chip_smoke's folder)
    tok = make_tiny_tokenizer(
        [f"w{i}" for i in range(64)]
        + ["photo", "of", "a", "an", "image", "painting", "by", "style",
           "artwork", "art"], model_max_length=77)
    hp = dataclasses.replace(bench_hparams(10), layers=[7])
    lam = float(hp.mom2_update_weight)
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()}
    for name, proj, seed in (("sd_text", None, 0), ("clip_text", 768, 3)):
        with torch.device("cuda"):
            text = CLIPTextEncoder(dataclasses.replace(
                SD_V14_TEXT, projection_dim=proj,
                eos_token_id=tok.eos_token_id))
        _random_init_(text, torch.Generator(device="cuda").manual_seed(seed))
        text = text.float().eval().requires_grad_(False)
        with tempfile.TemporaryDirectory() as stats:
            C = resolve_covariances_for(text, tok, hp, stats_dir=stats,
                                        model_name=name,
                                        verbose=False)[0].double()
        keys, _ = module_io_at_words(text, prepare_request_batch(
            tok, CLIP_REQUESTS), hp.layers[0])
        K = keys.reshape(-1, keys.shape[-1]).T.double()
        A = lam * C + K @ K.T
        ref = torch.linalg.solve(A, K)
        ev_a, ev_c = torch.linalg.eigvalsh(A), torch.linalg.eigvalsh(C)
        row = {"cond_A": float(ev_a[-1] / ev_a[0]),
               "cond_C": float(ev_c[-1] / ev_c[0].abs())}
        with precise_matmuls():
            A32 = A.float()
            L = torch.linalg.cholesky(A32)
            for resid in ("f32", "f64"):
                for steps in (0, 2, 4, 8):
                    x = torch.cholesky_solve(K.float(), L)
                    for _ in range(steps):
                        r = ((K - A @ x.double()).float() if resid == "f64"
                             else K.float() - A32 @ x)
                        x = x + torch.cholesky_solve(r, L)
                    row[f"{resid}_residual_{steps}_steps_rel"] = float(
                        (x.double() - ref).norm() / ref.norm())
        out[name] = row
        del text
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

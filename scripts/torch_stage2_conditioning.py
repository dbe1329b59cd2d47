#!/usr/bin/env python3
"""How close Stage 2's f32 solve comes to float64 on the covariances the
product computes offline: the second moment of fc2 inputs over the
2000-caption synthetic corpus (``dsets/stat_dataset.make_synthetic_captions``,
a 20-word vocabulary), with the keys of the edit requests.  Towers, all
with random weights:

* ``sd_text``: the SD-v1.4 text tower (seed 0), f32, layer 7;
* ``clip_text``: a CLIP ViT-L/14 text tower with a 768-wide projection
  (seed 3), f32, layer 7;
* ``sdxl_text1.layerN`` / ``sdxl_text2.layerN``: the two encoders of
  ``build_random_sdxl_pipeline(seed=0)`` in bf16 (CLIP-L and the
  5120-wide fc2 input of OpenCLIP bigG) at every edit layer of
  ``chip_smoke.py``'s ``sdxl_path`` (CLIP-L 7-10, bigG 27-30), with its
  covariances and requests: the systems that phase solves.

For A = lam C + K K^T (lam 4000) it prints cond(C), cond(A) and the
relative Frobenius distance to the float64 solve of an f32 Cholesky solve
refined 0, 2, 4, 8 and 16 times, once on f32 residuals (the JAX package's
``f32_ir``) and once on float64 residuals, and that of the port's
``solve_adj_k(method="f32_ir")`` (``ops/solve.refined_cholesky_solve``,
refined until converged; the error text where it raises).  One JSON line;
needs the card.

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


def keys_at(text, tok, requests, layer: int):
    """(in, R*T) float64 keys: fc2's input at the requests' fact tokens."""
    from emcid_torch.engine.extract import (
        module_io_at_words,
        prepare_request_batch,
    )

    keys, _ = module_io_at_words(text, prepare_request_batch(tok, requests),
                                 layer)
    return keys.reshape(-1, keys.shape[-1]).T.double()


def solve_row(torch, C, K, lam: float) -> dict:
    """cond(C), cond(A) and each solve's relative distance to float64."""
    from emcid_torch.ops.solve import solve_adj_k
    from emcid_torch.runtime import precise_matmuls

    C = C.double()
    A = lam * C + K @ K.T
    ref = torch.linalg.solve(A, K)
    ev_a, ev_c = torch.linalg.eigvalsh(A), torch.linalg.eigvalsh(C)
    row = {"width": int(A.shape[0]), "cond_A": float(ev_a[-1] / ev_a[0]),
           "cond_C": float(ev_c[-1] / ev_c[0].abs())}
    rel = lambda x: float((x.double() - ref).norm() / ref.norm())
    with precise_matmuls():
        A32 = A.float()
        L = torch.linalg.cholesky(A32)
        for resid in ("f32", "f64"):
            for steps in (0, 2, 4, 8, 16):
                x = torch.cholesky_solve(K.float(), L)
                for _ in range(steps):
                    r = ((K - A @ x.double()).float() if resid == "f64"
                         else K.float() - A32 @ x)
                    x = x + torch.cholesky_solve(r, L)
                row[f"{resid}_residual_{steps}_steps_rel"] = rel(x)
    try:
        row["port_f32_ir_rel"] = rel(solve_adj_k(C, K, lam))
    except FloatingPointError as e:
        row["port_f32_ir_rel"] = str(e)
    return row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from chip_smoke import (
        CLIP_REQUESTS,
        SDXL_REQUESTS,
        bench_hparams,
        sdxl_hparams,
    )
    from emcid_torch.engine.editor import resolve_covariances_for
    from emcid_torch.engine.sdxl import (
        encoder_hparams_view,
        resolve_covariances_sdxl,
    )
    from emcid_torch.models.clip_text import CLIPTextEncoder
    from emcid_torch.models.configs import SD_V14_TEXT
    from emcid_torch.models.loader import _random_init_
    from emcid_torch.models.sdxl import build_random_sdxl_pipeline
    from emcid_torch.text.tokenizer import make_tiny_tokenizer

    # the tokenizer of build_random_pipeline (and of chip_smoke's folder)
    tok = make_tiny_tokenizer(
        [f"w{i}" for i in range(64)]
        + ["photo", "of", "a", "an", "image", "painting", "by", "style",
           "artwork", "art"], model_max_length=77)
    hp = dataclasses.replace(bench_hparams(10), layers=[7])
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
                                        verbose=False)[0]
        out[name] = solve_row(torch, C, keys_at(text, tok, CLIP_REQUESTS, 7),
                              float(hp.mom2_update_weight))
        del text

    comps = build_random_sdxl_pipeline(seed=0, device="cuda")
    xl = sdxl_hparams(10)
    with tempfile.TemporaryDirectory() as stats:
        covs = resolve_covariances_sdxl(comps, xl, f"{stats}/text1",
                                        f"{stats}/text2", verbose=False)
    for which, covs_w in ((1, covs[0]), (2, covs[1])):
        view = encoder_hparams_view(xl, which)
        for layer, C in zip(view.layers, covs_w):
            out[f"sdxl_text{which}.layer{layer}"] = solve_row(
                torch, C, keys_at(comps.encoder(which), comps.tokenizer,
                                  SDXL_REQUESTS, layer),
                float(view.mom2_update_weight))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

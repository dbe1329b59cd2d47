"""Causal tracing over the text encoder: which layers store a concept?

Counterpart of ``emcid_tpu/interp/causal_trace.py`` (reference
experiments/causal_trace.py:174-340 trace_with_patch_text_encoder, 408-480
calculate_hidden_flow, 517-661 state/window sweeps, 1122-1135
collect_embedding_std) — the method that chose the edit layers [7..11]
(SURVEY.md §1).

Protocol: row 0 of a batch is clean, the other rows get Gaussian noise
added to the *subject-token embeddings* (scale = 3x the embedding std over
subjects); at each patched (layer, token) a corrupted row's hidden state is
restored from row 0.  Images are generated from the rows and scored
(ViT/CLIP/BLIP — ``evals/``).  The corruption and patch seams are the text
encoder's ``embed_noise`` / ``patch_spec`` arguments.  The noise is
``np.random.RandomState(1)``, as in the JAX package, so both packages
corrupt with the same numbers; sampling is DDIM with CFG 7.5.  The initial
latents come from the port's per-seed generators; ``latents=`` (channel-
last, one row per image) replaces them, which makes a trace comparable
with the JAX package's.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from emcid_torch.models.pipeline import (
    SDComponents,
    decode_latents,
    denoise,
    initial_latents,
)
from emcid_torch.text.token_range import find_token_range

GUIDANCE = 7.5


def layername_text_encoder(layer: int, kind: Optional[str] = None) -> str:
    """Dotted layer names (reference causal_trace.py:689-708)."""
    if kind == "embed":
        return "text_model.embeddings"
    base = f"text_model.encoder.layers.{layer}"
    if kind in (None, ""):
        return base
    if kind == "mlp":
        return f"{base}.mlp"
    if kind == "attn":
        return f"{base}.self_attn"
    raise ValueError(kind)


def _ids(components: SDComponents, ids) -> torch.Tensor:
    return torch.as_tensor(np.asarray(ids), dtype=torch.long,
                           device=components.device)


@torch.no_grad()
def collect_embedding_std(components: SDComponents,
                          subjects: Sequence[str]) -> float:
    """Std of token+position embeddings over subject prompts
    (reference causal_trace.py:1122-1135) — sets the corruption scale."""
    tok = components.tokenizer
    vals = []
    for s in subjects:
        enc = tok([s], padding="max_length", truncation=True,
                  max_length=tok.model_max_length)
        emb = components.text_encoder.embed(_ids(components,
                                                 enc["input_ids"]))
        n = int(np.asarray(enc["attention_mask"][0]).sum())
        vals.append(emb[0, :n].float().cpu().numpy().reshape(-1))
    return float(np.concatenate(vals).std())


def _gen(gen_kwargs: Optional[dict]) -> dict:
    gk = dict(num_inference_steps=10, height=512, width=512)
    gk.update(gen_kwargs or {})
    return gk


@torch.no_grad()
def corrupted_embeddings(
    components: SDComponents,
    prompt: str,
    subject: str,
    noise_scale: float,
    patch_spec: Optional[Dict[int, np.ndarray]] = None,
    rng_seed: int = 1,
) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(2, S, H) final text states: row 0 clean, row 1 subject-corrupted
    (+ optionally patched).  Noise is a fixed pseudorandom stream
    (reference uses RandomState(1), causal_trace.py:214)."""
    tok = components.tokenizer
    enc = tok([prompt, prompt], padding="max_length", truncation=True,
              max_length=tok.model_max_length)
    ids = np.asarray(enc["input_ids"])
    n_real = int(np.asarray(enc["attention_mask"][0]).sum())
    tr = find_token_range(tok, ids[0, :n_real], subject)
    S = ids.shape[1]
    H = components.text_encoder.config.hidden_size
    noise = np.zeros((2, S, H), np.float32)
    rs = np.random.RandomState(rng_seed)
    noise[1, tr[0]:tr[1]] = noise_scale * rs.randn(tr[1] - tr[0], H)
    dev = components.device
    spec = None
    if patch_spec:
        spec = {
            int(l): torch.tensor(np.stack([np.zeros(S, np.float32),
                                           m.astype(np.float32)]), device=dev)
            for l, m in patch_spec.items()
        }
    out = components.text_encoder(
        _ids(components, ids), embed_noise=torch.tensor(noise, device=dev),
        patch_spec=spec)
    return out.last_hidden_state, tr


def _latents(components: SDComponents, seeds, gk, latents):
    if latents is not None:
        return torch.as_tensor(latents, device=components.device).float()
    return initial_latents(seeds, gk["height"], gk["width"],
                           components.latent_channels, components.vae_scale,
                           device=components.device)


def trace_with_patch_text_encoder(
    components: SDComponents,
    prompt: str,
    subject: str,
    states_to_patch: Sequence[Tuple[int, int]],
    noise_scale: float,
    seed: int = 0,
    gen_kwargs: Optional[dict] = None,
    latents=None,
) -> np.ndarray:
    """Generate the (clean, corrupted+patched) image pair for one patch set.

    states_to_patch: list of (layer, token_index).
    Returns images (2, H, W, 3) uint8 — image 0 clean, image 1 traced.
    ``latents``: (2, h, w, c) channel-last initial latents in place of the
    seed's."""
    tok = components.tokenizer
    S = tok.model_max_length
    patch: Dict[int, np.ndarray] = {}
    for layer, token in states_to_patch:
        patch.setdefault(int(layer), np.zeros(S, np.float32))[int(token)] = 1.0
    ctx, _ = corrupted_embeddings(components, prompt, subject, noise_scale,
                                  patch_spec=patch or None)
    gk = _gen(gen_kwargs)
    lat = _latents(components, [seed, seed], gk, latents)
    uncond, _ = corrupted_embeddings(components, "", "[EOS]", 0.0)
    lat = denoise(components, lat, ctx, uncond,
                  num_inference_steps=gk["num_inference_steps"],
                  guidance_scale=GUIDANCE, sampler="ddim")
    return decode_latents(components, lat)


def trace_important_states(
    components: SDComponents,
    prompt: str,
    subject: str,
    noise_scale: float,
    layers: Optional[Sequence[int]] = None,
    tokens: Optional[Sequence[int]] = None,
    window: int = 1,
    seed: int = 0,
    score_fn=None,
    gen_kwargs: Optional[dict] = None,
    latents=None,
) -> np.ndarray:
    """(token x layer) restoration sweep (reference causal_trace.py:517-661).

    For each (token t, center layer l): corrupt the subject embeddings,
    restore the window of layers around l at token t, generate, and score
    the traced image with ``score_fn(image) -> float``.  Returns the
    (len(tokens), len(layers)) heatmap.

    All token cells of one layer run as one batch, as in the JAX package:
    rows 1..K all patch from the clean row 0, so a sweep is len(layers)
    sampler calls.  ``latents``: (1 + K, h, w, c) channel-last initial
    latents in place of the seed's.
    """
    n_layers = components.text_encoder.config.num_hidden_layers
    layers = list(layers if layers is not None else range(n_layers))
    tok = components.tokenizer
    enc = tok([prompt])
    n_real = int(np.asarray(enc["attention_mask"][0]).sum())
    tokens = list(tokens if tokens is not None else range(n_real))
    if score_fn is None:
        raise ValueError("score_fn is required (e.g. a ViT/CLIP scorer)")

    gk = _gen(gen_kwargs)
    S = tok.model_max_length
    B = 1 + len(tokens)  # clean row 0 + one corrupted+patched row per token
    enc_b = tok([prompt] * B, padding="max_length", truncation=True,
                max_length=S)
    ids = np.asarray(enc_b["input_ids"])
    tr = find_token_range(tok, ids[0, :n_real], subject)
    H = components.text_encoder.config.hidden_size
    rs = np.random.RandomState(1)
    base_noise = noise_scale * rs.randn(tr[1] - tr[0], H).astype(np.float32)
    noise = np.zeros((B, S, H), np.float32)
    noise[1:, tr[0]:tr[1]] = base_noise  # same corruption for every row
    dev = components.device
    ids_t, noise_t = _ids(components, ids), torch.tensor(noise, device=dev)

    uncond, _ = corrupted_embeddings(components, "", "[EOS]", 0.0)
    uncond_b = uncond[0:1].expand((B,) + tuple(uncond.shape[1:]))
    lat0 = _latents(components, [seed] * B, gk, latents)

    heat = np.zeros((len(tokens), len(layers)), np.float32)
    for li, l in enumerate(layers):
        spec = {}
        for lw in range(max(0, l - window // 2),
                        min(n_layers, l - window // 2 + window)):
            m = np.zeros((B, S), np.float32)
            for ti, t in enumerate(tokens):
                m[1 + ti, t] = 1.0
            spec[int(lw)] = torch.tensor(m, device=dev)
        with torch.no_grad():
            ctx = components.text_encoder(
                ids_t, embed_noise=noise_t, patch_spec=spec).last_hidden_state
        lat = denoise(components, lat0, ctx, uncond_b,
                      num_inference_steps=gk["num_inference_steps"],
                      guidance_scale=GUIDANCE, sampler="ddim")
        imgs = decode_latents(components, lat)
        for ti in range(len(tokens)):
            heat[ti, li] = float(score_fn(imgs[1 + ti]))
    return heat


def save_trace_images(
    components: SDComponents,
    prompt: str,
    subject: str,
    noise_scale: float,
    out_dir,
    class_name: str,
    idx: int,
    layers: Optional[Sequence[int]] = None,
    tokens: Optional[Sequence[int]] = None,
    window: int = 1,
    kind: str = "x",
    seed: int = 0,
    gen_kwargs: Optional[dict] = None,
    latents=None,
):
    """Generate and save traced images under the ImageItem filename codec
    (evals/folder_sweep.py; reference causal_trace.py:264-332) for offline
    scoring: ``{class}_{idx}_{kind}_clean.png`` / ``..._corrupt.png`` /
    ``..._l{L}_restore_{token}.png`` / ``..._s{S}_w{W}_restore_{token}.png``.
    ``latents``: (2, h, w, c) for every pair, in place of the seed's.
    """
    from pathlib import Path

    from PIL import Image

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    base = trace_with_patch_text_encoder(
        components, prompt, subject, [], noise_scale, seed,
        gen_kwargs=gen_kwargs, latents=latents,
    )
    Image.fromarray(base[0]).save(out_dir / f"{class_name}_{idx}_{kind}_clean.png")
    Image.fromarray(base[1]).save(out_dir / f"{class_name}_{idx}_{kind}_corrupt.png")

    tok = components.tokenizer
    enc = tok([prompt])
    ids = enc["input_ids"][0][: int(np.asarray(enc["attention_mask"][0]).sum())]
    tok_strs = [tok.decode([int(i)]) or f"t{p}" for p, i in enumerate(ids)]
    n_layers = components.text_encoder.config.num_hidden_layers
    layers = list(layers if layers is not None else range(n_layers))
    tokens = list(tokens if tokens is not None else range(len(ids)))
    for t in tokens:
        for l in layers:
            patch = [
                (lw, t) for lw in range(max(0, l - window // 2),
                                        min(n_layers, l - window // 2 + window))
            ]
            imgs = trace_with_patch_text_encoder(
                components, prompt, subject, patch, noise_scale, seed,
                gen_kwargs=gen_kwargs, latents=latents,
            )
            token_label = tok_strs[t].replace(" ", "") or f"t{t}"
            if window == 1:
                name = f"{class_name}_{idx}_{kind}_l{l}_restore_{token_label}.png"
            else:
                name = (f"{class_name}_{idx}_{kind}_s{patch[0][0]}_w{window}"
                        f"_restore_{token_label}.png")
            Image.fromarray(imgs[1]).save(out_dir / name)
    return out_dir


def calculate_hidden_flow_text_encoder(
    components: SDComponents,
    prompt: str,
    subject: str,
    score_fn,
    noise_scale: Optional[float] = None,
    window: int = 1,
    seed: int = 0,
    gen_kwargs: Optional[dict] = None,
) -> Dict[str, object]:
    """Full hidden-flow bundle (reference causal_trace.py:408-480): clean
    score, corrupted score, and the restoration heatmap."""
    if noise_scale is None:
        noise_scale = 3.0 * collect_embedding_std(components, [subject])
    base = trace_with_patch_text_encoder(
        components, prompt, subject, [], noise_scale, seed,
        gen_kwargs=gen_kwargs,
    )
    clean_score = float(score_fn(base[0]))
    corrupt_score = float(score_fn(base[1]))
    heat = trace_important_states(
        components, prompt, subject, noise_scale, window=window, seed=seed,
        score_fn=score_fn, gen_kwargs=gen_kwargs,
    )
    tok = components.tokenizer
    enc = tok([prompt])
    n_real = int(np.asarray(enc["attention_mask"][0]).sum())
    ids = enc["input_ids"][0][:n_real]
    return {
        "prompt": prompt,
        "subject": subject,
        "tokens": [tok.decode([int(i)]) for i in ids],
        "subject_range": find_token_range(tok, ids, subject),
        "clean_score": clean_score,
        "corrupt_score": corrupt_score,
        "scores": heat,
        "window": window,
        "noise_scale": noise_scale,
    }

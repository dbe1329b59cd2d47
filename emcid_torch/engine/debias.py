"""Gender debiasing: blended-z insertion with CLIP-ratio factor search
(reference emcid_main.py:1428-1521 get_factors, 1704-1966 apply/execute
debias, 1969-2052 cal_insert_deltas).

Per profession request ``{source, dests: [female, male], prompts,
seed_train}``: Stage-1 computes one z per dest; a gradient-free search then
finds blend factors f so that inserting ``z = sum_i f_i z_i`` yields a
CLIP-classified gender ratio near 50/50: generate ``num_samples`` images of
the source, argmax CLIP probs over the dest texts, step factors against the
ratio error with a decaying step length.

Counterpart of ``emcid_tpu/engine/debias.py``.  Every candidate insertion
edits a copy of the text encoder (``execute_emcid_text_encoder`` returns a
deep copy), so the caller's components never change; the search drops each
candidate's copy before it makes the next, so device memory does not grow
with ``max_iter``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from emcid_torch.engine.emcid import execute_emcid_text_encoder
from emcid_torch.models.pipeline import SDComponents, generate
from emcid_torch.models.vision import CLIPScorer


def classify_ratio(
    scorer: CLIPScorer,
    images: np.ndarray,
    dests: Sequence[str],
) -> List[float]:
    """Fraction of images whose CLIP argmax lands on each dest text."""
    logits = torch.as_tensor(
        scorer.logits_per_image(images, list(dests))).cpu().numpy()
    winners = logits.argmax(axis=-1)
    return [float((winners == i).mean()) for i in range(len(dests))]


def get_factors(
    components: SDComponents,
    scorer: CLIPScorer,
    hparams,
    separate_zs: Sequence[np.ndarray],
    separate_requests: Sequence[Dict],
    covs,
    init_factors: Optional[Sequence[float]] = None,
    num_samples: int = 25,
    max_diff: float = 0.02,
    step_length: float = 0.4,
    desired_ratios: Optional[Sequence[float]] = None,
    max_iter: int = 10,
    mom2_weight=None,
    edit_weight=None,
    gen_kwargs: Optional[dict] = None,
    verbose: bool = True,
) -> List[float]:
    """Search blend factors for ONE concept (reference invariant kept: the
    caller's components are never mutated)."""
    n = len(separate_requests)
    factors = list(init_factors) if init_factors else [1.0 / n] * n
    desired = list(desired_ratios) if desired_ratios else [1.0 / n] * n
    dests = [r["dest"] for r in separate_requests]
    base_seed = int(separate_requests[0].get("seed")
                    or separate_requests[0].get("seed_train") or 0)
    prompt = "an image of {}".format(separate_requests[0]["source"])

    def measure(edited):
        imgs = generate(
            edited, [prompt] * num_samples,
            [base_seed + i for i in range(num_samples)],
            **(gen_kwargs or {}),
        )
        return classify_ratio(scorer, imgs, dests)

    return _factor_search(
        components, hparams, separate_zs, separate_requests, covs, factors,
        desired, step_length, max_diff, max_iter, mom2_weight, edit_weight,
        measure, verbose)


def _factor_search(components, hparams, separate_zs, separate_requests,
                   covs, factors, desired, step_length, max_diff, max_iter,
                   mom2_weight, edit_weight, measure, verbose):
    """Shared factor-search update loop (get_factors / get_factors_v0 —
    only the image-sampling protocol differs, injected via ``measure``).

    Reference emcid_main.py:1461 (and :1558 in v0) mutates step_length in
    place, i.e. a COMPOUNDING product decay step_length *= (1 - it/max_iter).
    """
    for it in range(max_iter):
        step_length = step_length - step_length / max_iter * it
        balanced_z = sum(f * np.asarray(z) for f, z in zip(factors, separate_zs))
        zs = balanced_z[None]  # (1, T, H) or (1, H)
        if zs.ndim == 2:
            zs = zs[:, None, :]
        _, edited_text = execute_emcid_text_encoder(
            components.text_encoder, components.tokenizer,
            [separate_requests[0]], hparams, zs=zs, covs=covs,
            mom2_weight=mom2_weight, edit_weight=edit_weight, verbose=False,
        )
        cur = measure(components.replace_text_encoder(edited_text))
        del edited_text  # this candidate's copy goes before the next
        diffs = [c - d for c, d in zip(cur, desired)]
        if max(abs(d) for d in diffs) <= max_diff:
            if verbose:
                print("current ratios:", cur)
            break
        factors = [max(f - step_length * d, 0.0) for f, d in zip(factors, diffs)]
        total = sum(factors) or 1.0
        factors = [f / total for f in factors]
        if verbose:
            print(f"ratios: {cur}, factors: {factors}")
    return factors


def get_factors_v0(
    components: SDComponents,
    scorer: CLIPScorer,
    hparams,
    separate_zs: Sequence[np.ndarray],
    separate_requests: Sequence[Dict],
    covs,
    init_factors: Optional[Sequence[float]] = None,
    num_samples: int = 10,
    num_seeds: int = 5,
    max_diff: float = 0.02,
    step_length: float = 0.8,
    desired_ratios: Optional[Sequence[float]] = None,
    max_iter: int = 20,
    mom2_weight=None,
    edit_weight=None,
    gen_kwargs: Optional[dict] = None,
    verbose: bool = True,
) -> List[float]:
    """Legacy v0 factor search (reference emcid_main.py:1523-1621;
    zero callers in the reference — kept for API completeness).

    Differs from :func:`get_factors` in its sampling protocol: it draws
    ``num_seeds`` generation seeds via ``random.sample(range(100000),
    num_seeds)`` seeded from the request, then generates ``num_samples``
    images per seed.  Two reference quirks are replicated, documented
    here rather than silently fixed:

    * the per-seed count array is RESET inside the seed loop (:1579), so
      only the LAST seed's counts ever reach the ratio update — the
      other ``(num_seeds - 1) * num_samples`` generations are wasted;
    * the step decay mutates ``step_length`` in place (:1558), giving a
      compounding product decay like :func:`get_factors`.

    Image streams cannot be bitwise-identical to the torch generator's;
    per-image seeds are derived deterministically from each sampled seed.
    """
    import random as _random

    n = len(separate_requests)
    factors = list(init_factors) if init_factors else [1.0 / n] * n
    desired = list(desired_ratios) if desired_ratios else [1.0 / n] * n
    dests = [r["dest"] for r in separate_requests]
    base_seed = int(separate_requests[0].get("seed")
                    or separate_requests[0].get("seed_train") or 0)
    prompt = "an image of {}".format(separate_requests[0]["source"])

    _random.seed(base_seed)
    seeds = _random.sample(range(100000), num_seeds)

    def measure(edited):
        for seed in seeds:
            # reference quirk: cnts reset here, so only the last seed counts
            imgs = generate(
                edited, [prompt] * num_samples,
                [seed * num_samples + i for i in range(num_samples)],
                **(gen_kwargs or {}),
            )
            cur = classify_ratio(scorer, imgs, dests)
        return cur

    return _factor_search(
        components, hparams, separate_zs, separate_requests, covs, factors,
        desired, step_length, max_diff, max_iter, mom2_weight, edit_weight,
        measure, verbose)


def get_factors_repr(
    components: SDComponents,
    hparams,
    separate_zs: Sequence[np.ndarray],
    separate_requests: Sequence[Dict],
    covs,
    init_factors: Optional[Sequence[float]] = None,
    max_diff: float = 0.01,
    step_length: float = 0.1,
    max_iter: int = 30,
    mom2_weight=None,
    edit_weight=None,
    verbose: bool = True,
) -> List[float]:
    """Representation-feedback factor search (reference get_factors_repr,
    emcid_main.py:1624-1701; reachable via the ``repr_fb`` flag of the
    debias apply, :1849/:1915): instead of generating + CLIP-classifying
    images, insert the blended z, read back the post-edit fc2 output at
    the subject token, and step factors to EQUALIZE its distance to each
    dest z.  No image generation — orders of magnitude cheaper than
    ``get_factors``, at the cost of optimizing a text-space proxy.

    The reference ignores ``init_factors`` (commented out, :1643-1646);
    kept for signature parity."""
    from emcid_torch.engine.extract import (
        module_io_at_words, prepare_request_batch,
    )

    n = len(separate_requests)
    factors = [1.0 / n] * n  # reference hard-resets to uniform
    layer = hparams.layers[-1]
    batch0 = prepare_request_batch(
        components.tokenizer, [separate_requests[0]],
        num_fact_tokens=getattr(hparams, "num_edit_tokens", 1))

    for it in range(max_iter):
        # compounding in-place decay, matching reference emcid_main.py:1653
        step_length = step_length - step_length / max_iter * it
        balanced_z = sum(f * np.asarray(z)
                         for f, z in zip(factors, separate_zs))
        zs = balanced_z[None]
        if zs.ndim == 2:
            zs = zs[:, None, :]
        _, edited_text = execute_emcid_text_encoder(
            components.text_encoder, components.tokenizer,
            [separate_requests[0]], hparams, zs=zs, covs=covs,
            mom2_weight=mom2_weight, edit_weight=edit_weight, verbose=False,
        )
        _, cur_zs = module_io_at_words(edited_text, batch0, layer)
        del edited_text  # this candidate's copy goes before the next
        cur = cur_zs.cpu().numpy()  # (1, T, H)
        dists = [float(np.linalg.norm(cur.ravel() - np.asarray(z).ravel()))
                 for z in separate_zs]
        mean_dist = float(np.mean(dists))
        diffs = [mean_dist - d for d in dists]
        if max(abs(d) for d in diffs) <= max_diff:
            if verbose:
                print("current dists:", dists)
            break
        factors = [max(f - step_length * d, 0.0) for f, d in zip(factors, diffs)]
        total = sum(factors) or 1.0
        factors = [f / total for f in factors]
        if verbose:
            print(f"dists: {dists}, factors: {factors}")
    return factors


def apply_emcid_to_text_encoder_debias(
    components: SDComponents,
    requests: Sequence[Dict],
    hparams,
    scorer: CLIPScorer,
    mom2_weight=None,
    edit_weight=None,
    cache_name: Optional[str] = None,
    recompute_factors: bool = True,
    max_iter: int = 10,
    num_samples: int = 25,
    block_size: int = 32,
    num_inference_steps: int = 50,
    gen_kwargs: Optional[dict] = None,
    stats_dir=None,
    stats_captions=None,
    mesh=None,
    repr_fb: bool = False,
    verbose: bool = True,
) -> Tuple[SDComponents, Dict, List[List[float]]]:
    """Full debias edit: per profession, per-dest z computation → factor
    search → one blended multi-concept insert.  Returns
    (edited components, deltas, factors per request).  ``mesh`` shards the
    covariance sweep and Stage 1."""
    from emcid_torch.engine.editor import (
        compute_zs_for_requests,
        resolve_covariances_for,
    )

    covs = resolve_covariances_for(
        components.text_encoder, components.tokenizer, hparams,
        stats_dir=stats_dir, captions=stats_captions, mesh=mesh,
        verbose=verbose)

    all_factors: List[List[float]] = []
    balanced_zs: List[np.ndarray] = []
    for request in requests:
        separate_requests = [
            dict(request, dest=d, dests=None) for d in request["dests"]
        ]
        zs = compute_zs_for_requests(
            components, separate_requests, hparams, cache_name=cache_name,
            block_size=block_size, num_inference_steps=num_inference_steps,
            mesh=mesh, verbose=verbose,
        )  # (n_dests, T, H)
        separate_zs = [zs[i] for i in range(len(separate_requests))]
        if recompute_factors and repr_fb:
            # representation-feedback variant (reference repr_fb flag,
            # emcid_main.py:1849): no image generation in the search loop
            factors = get_factors_repr(
                components, hparams, separate_zs, separate_requests, covs,
                max_iter=max_iter, mom2_weight=mom2_weight,
                edit_weight=edit_weight, verbose=verbose,
            )
        elif recompute_factors:
            factors = get_factors(
                components, scorer, hparams, separate_zs, separate_requests,
                covs, max_iter=max_iter, num_samples=num_samples,
                mom2_weight=mom2_weight, edit_weight=edit_weight,
                gen_kwargs=gen_kwargs, verbose=verbose,
            )
        else:
            factors = [1.0 / len(separate_requests)] * len(separate_requests)
        all_factors.append(factors)
        balanced_zs.append(
            sum(f * np.asarray(z) for f, z in zip(factors, separate_zs))
        )

    zs = np.stack(balanced_zs)  # (R, T, H)
    deltas, new_text = execute_emcid_text_encoder(
        components.text_encoder, components.tokenizer, list(requests),
        hparams, zs=zs, covs=covs,
        mom2_weight=mom2_weight, edit_weight=edit_weight, verbose=verbose,
    )
    return components.replace_text_encoder(new_text), deltas, all_factors

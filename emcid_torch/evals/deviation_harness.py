"""Shared tiny-AICE deviation-guard harness.

Counterpart of ``emcid_tpu/evals/deviation_harness.py``.  The five guarded
protocol deviations (DPM++-25 training images, the eps_dest pool K=25, the
cosine z schedule, CFG interval 0.6, 384-px training) ship on a functional
bar: multi-seed AICE metric deltas (efficacy, generalization, specificity)
must sit inside the reference protocol's own noise.  This module is that
bar, on the port's engine.

Harness regime (every lever engages): Stage-1 training images at
``N_STEPS=10`` sampler steps, a 4-class scorer over the tiny pipeline's
own words, eval generation at 2 steps and 16x16 (paired away by seed), and
a strong edit (mom2_update_weight 50, v_lr 0.3, 16 grad steps).

Statistic: pair by ``seed_train`` and test the mean paired metric delta
against the exact protocol's own Monte-Carlo noise, estimated from null
replicas (the exact protocol re-run with ``rng_seed`` 1, 2, ... vs 0).
For each metric

    band = NULL_SIGMAS * rms(null paired deltas) / sqrt(n_seeds) + ABS_FLOOR
    PASS iff |mean paired delta over seeds| <= band

The negative controls (z scaled x0.5; Stage 1 truncated 10-vs-50) must
break the band: a band too wide to reject a corrupted protocol proves
nothing about the levers it passes.

The constants below are the JAX package's, registered before any
measurement; they are not tuned here.  Port-only seam: ``make_guard_scorer
(torch_state_dict=)`` loads given weights (a seeded init cannot match
across frameworks).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import numpy as np

SEEDS = (0, 1, 2)
# eval generation (paired away by seed)
GEN = dict(num_inference_steps=2, height=16, width=16)
# Stage-1 / training-image sampler steps: >= 10 so the cfg-interval and
# sampler levers are real code paths, not no-ops
N_STEPS = 10

NULL_RNGS = (1, 2, 3)  # exact-protocol replicas vs rng_seed=0
NULL_SIGMAS = 3.0
ABS_FLOOR = 2e-3

TINY_HP = {
    "layers": [2, 3], "clamp_norm_factor": 1.5, "layer_selection": "all",
    "fact_token": "subject_last", "v_num_grad_steps": 16, "v_lr": 0.3,
    "v_weight_decay": 5e-4, "mom2_adjustment": True,
    "mom2_update_weight": 50,
    "rewrite_module_tmp": "text_model.encoder.layers.{}.mlp.fc2",
    "layer_module_tmp": "text_model.encoder.layers.{}",
    "mlp_module_tmp": "text_model.encoder.layers.{}.mlp",
    "attn_module_tmp": "text_model.encoder.layers.{}.self_attn",
    "ln_f_module": "text_model.final_layer_norm",
    "mom2_dataset": "ccs_filtered", "mom2_n_samples": 100,
    "mom2_dtype": "float32", "objective": "ablate-dest", "esd_mu": "None",
    "cal_text_repr_loss": True, "text_repr_loss_scale_factor": 0.01,
}

# per guarded deviation: the product-default and reference-exact apply
# kwargs on the tiny harness (train_res at the product ratio 12/16 =
# 384/512; train_steps 5-vs-10 mirrors the dpm++ lever's 25-vs-50)
LEVERS: Dict[str, Dict] = {
    "eps_pool": dict(default=dict(eps_dest_pool=25),
                     exact=dict(eps_dest_pool=0)),
    "train_sampler": dict(default=dict(train_sampler="dpm++",
                                       train_steps=5),
                          exact=dict(train_sampler="pndm")),
    "cfg_interval": dict(default=dict(cfg_interval=0.6),
                         exact=dict(cfg_interval=1.0)),
    "train_res": dict(default=dict(train_res=12),
                      exact=dict(train_res=16)),
    "z_sched": dict(hp_over={"v_num_grad_steps": 50},
                    default=dict(z_sched="cosine", eps_dest_pool=0),
                    exact=dict(z_sched="const", eps_dest_pool=0)),
}

# all five levers on (the configuration the product ships) vs the
# reference protocol, at 50 grad steps so the cosine schedule engages and
# the K=25 pool amortizes
COMPOUND = dict(
    hp_over={"v_num_grad_steps": 50},
    default=dict(train_sampler="dpm++", train_steps=5, eps_dest_pool=25,
                 z_sched="cosine", cfg_interval=0.6, train_res=12),
    exact=dict(train_sampler="pndm", eps_dest_pool=0, z_sched="const",
               cfg_interval=1.0, train_res=16),
)

# negative controls: protocols broken on purpose; each must FAIL the band
CONTROLS: Dict[str, Dict] = {
    # z halved after Stage 1: Stage 2 inserts a target far from the
    # optimized representation
    "z_scaled_half": dict(
        broken=dict(z_transform=lambda zs: 0.5 * zs, eps_dest_pool=0),
        exact=dict(eps_dest_pool=0),
    ),
    # Stage 1 truncated to 1/5 of the reference step count at const lr
    "stage1_truncated": dict(
        broken=dict(hp_over={"v_num_grad_steps": 10},
                    z_sched="const", eps_dest_pool=0),
        exact=dict(hp_over={"v_num_grad_steps": 50},
                   z_sched="const", eps_dest_pool=0),
    ),
}


def make_guard_scorer(num_labels: int = 4, seed: int = 0,
                      torch_state_dict=None, device=None):
    """4-class tiny-ViT scorer over the tiny pipeline's own word list (a
    1000-way softmax over random logits moves ~1e-6 per image delta; over
    4 classes the same tower is sensitive to the edits).  Random weights
    from ``seed``, or ``torch_state_dict``."""
    from emcid_torch.evals.scorers import make_vit_scorer
    from emcid_torch.models.vision import TINY_VIT

    cfg = dataclasses.replace(TINY_VIT, num_labels=num_labels)
    return make_vit_scorer(config=cfg, torch_state_dict=torch_state_dict,
                           seed=seed, device=device)


def edit_request(seed: int) -> Dict:
    return {"prompts": ["a photo of {}", "{}"], "source": "cat",
            "dest": "dog", "seed_train": seed}


def metrics(comps_edited, scorer, seed: int,
            gen_kwargs: Optional[dict] = None) -> np.ndarray:
    """(efficacy, generalization, specificity): source prompts scored under
    the dest class, a held-out phrasing likewise, and an untouched
    concept's images under their own class."""
    from emcid_torch.evals.iceb import generate_cal_cls_score
    from emcid_torch.evals.scorers import calculate_single_cls_score
    from emcid_torch.models.pipeline import generate

    gk = dict(GEN, **(gen_kwargs or {}))
    eval_req = {"prompts": ["a photo of {}", "{}"], "source": "cat",
                "dest": "dog", "source id": 1, "dest id": 2,
                "seeds": [seed, seed + 1]}
    train = generate_cal_cls_score(
        comps_edited, scorer, [eval_req], is_edited=True, gen_kwargs=gk)
    val_req = dict(eval_req, prompts=["an image of a {}"],
                   seeds=[seed + 2])
    val = generate_cal_cls_score(
        comps_edited, scorer, [val_req], is_edited=True, gen_kwargs=gk)
    spec_imgs = generate(comps_edited, ["a photo of bird"] * 2,
                         [seed + 3, seed + 4], **gk)
    spec = calculate_single_cls_score(scorer, spec_imgs, 3)
    return np.array([train["source_dest_scores"][0],
                     val["source_dest_scores"][0],
                     float(spec)])


def run_mode(
    comps,
    scorer,
    stats_dir,
    seeds: Sequence[int] = SEEDS,
    hp_over: Optional[dict] = None,
    z_transform: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    gen_kwargs: Optional[dict] = None,
    rng_seed: int = 0,
    n_steps: int = N_STEPS,
    **apply_over,
) -> np.ndarray:
    """(seeds, 3) metric rows for one protocol mode.  ``rng_seed`` seeds
    the Stage-1 draws (the null replicas vary it); ``z_transform`` (the
    negative-control seam) maps the stacked Stage-1 z vectors before
    Stage 2, in ``apply_emcid``'s covariances -> zs -> insert order."""
    from emcid_torch.engine.editor import (
        apply_emcid,
        compute_zs_for_requests,
        resolve_covariances,
    )
    from emcid_torch.engine.emcid import execute_emcid_text_encoder
    from emcid_torch.hparams import EMCIDHyperParams

    hp = EMCIDHyperParams.from_dict(dict(TINY_HP, **(hp_over or {})))
    rows = []
    for seed in seeds:
        requests = [edit_request(seed)]
        if z_transform is None:
            edited, _ = apply_emcid(
                comps, requests, hp, stats_dir=stats_dir,
                num_inference_steps=n_steps, rng_seed=rng_seed,
                verbose=False, **apply_over)
        else:
            covs = resolve_covariances(comps, hp, stats_dir=stats_dir,
                                       verbose=False)
            zs = compute_zs_for_requests(
                comps, requests, hp, num_inference_steps=n_steps,
                rng_seed=rng_seed, verbose=False, **apply_over)
            zs = np.asarray(z_transform(np.asarray(zs)))
            _, new_text = execute_emcid_text_encoder(
                comps.text_encoder, comps.tokenizer, requests, hp, zs=zs,
                covs=covs, verbose=False)
            edited = comps.replace_text_encoder(new_text)
        rows.append(metrics(edited, scorer, seed, gen_kwargs=gen_kwargs))
    return np.stack(rows)  # (seeds, 3 metrics)


def null_band(null_rows: Sequence[np.ndarray],
              exact: np.ndarray) -> np.ndarray:
    """Per-metric acceptance band from exact-protocol null replicas:
    NULL_SIGMAS x the standard error of a seed-mean paired delta, plus
    ABS_FLOOR."""
    deltas = np.stack([r - exact for r in null_rows])  # (R, seeds, 3)
    rms = np.sqrt((deltas ** 2).mean(axis=(0, 1)))
    return NULL_SIGMAS * rms / np.sqrt(deltas.shape[1]) + ABS_FLOOR


def paired_report(default: np.ndarray, exact: np.ndarray,
                  band: np.ndarray) -> Dict:
    """Per-metric paired deltas vs the null band, plus the verdict."""
    paired = default - exact  # (seeds, metrics)
    mean_delta = np.abs(paired.mean(axis=0))
    return dict(
        metrics=("efficacy", "generalization", "specificity"),
        mean_delta=mean_delta, band=np.asarray(band),
        sigma_paired=paired.std(axis=0), ok=mean_delta <= band,
        default_mean=default.mean(axis=0), exact_mean=exact.mean(axis=0),
        rows_default=default, rows_exact=exact,
    )


def assert_within_noise(default: np.ndarray, exact: np.ndarray,
                        band: np.ndarray, label: str) -> Dict:
    """Every metric must sit inside the null band (lever/compound)."""
    rep = paired_report(default, exact, band)
    for i, name in enumerate(rep["metrics"]):
        assert rep["ok"][i], (
            f"{label}: {name} paired delta {rep['mean_delta'][i]:.5f} "
            f"exceeds the null band {rep['band'][i]:.5f} "
            f"(default={rep['default_mean']}, exact={rep['exact_mean']})")
    return rep


def assert_outside_noise(broken: np.ndarray, exact: np.ndarray,
                         band: np.ndarray, label: str) -> Dict:
    """Negative control: at least one metric must break the band."""
    rep = paired_report(broken, exact, band)
    assert not rep["ok"].all(), (
        f"{label}: deliberately broken protocol passed every null band — "
        f"the guard harness is vacuous (deltas={rep['mean_delta']}, "
        f"bands={rep['band']})")
    return rep


# ---------------------------------------------------------------------------
# The same statistic on the SDXL path.  cfg_interval ships for SDXL;
# train_res is gated off for every native size but 512, so its rule is the
# bar a future flip must clear.
# ---------------------------------------------------------------------------

SDXL_TINY_HP = {
    "layers": [0, 1], "layers_2": [1, 2], "clamp_norm_factor": 1.5,
    "layer_selection": "all", "fact_token": "subject_last",
    "mom2_update_weight": 20, "mom2_update_weight_2": 20,
    "rewrite_module_tmp": "text_model.encoder.layers.{}.mlp.fc2",
    "layer_module_tmp": "text_model.encoder.layers.{}",
    "mlp_module_tmp": "text_model.encoder.layers.{}.mlp",
    "attn_module_tmp": "text_model.encoder.layers.{}.self_attn",
    "ln_f_module": "text_model.final_layer_norm",
    "mom2_dataset": "ccs_filtered", "mom2_n_samples": 30,
    "mom2_dtype": "float32", "v_num_grad_steps": 32, "v_lr": 0.15,
    "v_weight_decay": 8e-3, "mom2_adjustment": True,
    "objective": "ablate-dest", "esd_mu": "None",
    "cal_text_repr_loss": True, "text_repr_loss_scale_factor": 0.01,
}

SDXL_LEVERS: Dict[str, Dict] = {
    "cfg_interval": dict(default=dict(cfg_interval=0.6),
                         exact=dict(cfg_interval=1.0)),
    "train_res": dict(default=dict(train_res=12),
                      exact=dict(train_res=16)),
}


def make_sdxl_covs(components, seed: int = 0):
    """Random PSD covariances for both encoders' edit layers (Stage 2 only
    needs a well-conditioned C)."""
    rng = np.random.RandomState(seed)

    def cov(inter, n):
        out = []
        for _ in range(n):
            A = rng.randn(max(2 * inter, 64), inter).astype(np.float32)
            out.append(A.T @ A / A.shape[0])
        return out

    i1 = components.text_encoder.config.intermediate_size
    i2 = components.text_encoder_2.config.intermediate_size
    hp = SDXL_TINY_HP
    return cov(i1, len(hp["layers"])), cov(i2, len(hp["layers_2"]))


def sdxl_metrics(comps_edited, scorer, seed: int) -> np.ndarray:
    """The AICE triple through the SDXL sampler (mirrors ``metrics``)."""
    from emcid_torch.evals.scorers import calculate_single_cls_score
    from emcid_torch.models.sdxl import generate_sdxl

    gk = dict(GEN)

    def score(prompts, seeds, cls):
        imgs = generate_sdxl(comps_edited, prompts, seeds, **gk)
        return calculate_single_cls_score(scorer, imgs, cls)

    eff = score(["a photo of cat", "cat"], [seed, seed + 1], 2)
    gen = score(["an image of a cat"], [seed + 2], 2)
    spec = score(["a photo of dog", "dog"], [seed + 3, seed + 4], 3)
    return np.array([float(eff), float(gen), float(spec)])


def sdxl_run_mode(
    comps,
    scorer,
    seeds: Sequence[int] = SEEDS,
    hp_over: Optional[dict] = None,
    z_transform: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    rng_seed: int = 0,
    n_steps: int = N_STEPS,
    covs=None,
    cfg_interval: Optional[float] = None,
    train_res: Optional[int] = None,
) -> np.ndarray:
    """(seeds, 3) SDXL metric rows for one protocol mode (training latents
    -> joint Stage 1 -> both inserts), with ``run_mode``'s rng-null and
    z-corruption seams."""
    import torch

    from emcid_torch.engine.sdxl import (
        apply_emcid_to_sdxl_text_encoders,
        compute_z_sdxl_text_encoders,
        execute_emcid_sd_xl_text_encoders,
        sdxl_training_latents,
    )
    from emcid_torch.hparams import EMCIDXLHyperParams

    hp = EMCIDXLHyperParams.from_dict(dict(SDXL_TINY_HP, **(hp_over or {})))
    covs_1, covs_2 = covs if covs is not None else make_sdxl_covs(comps)
    native = comps.unet.config.sample_size * comps.vae_scale
    res = int(train_res or native)
    rows = []
    for seed in seeds:
        requests = [edit_request(seed)]
        mean, logvar = sdxl_training_latents(
            comps, requests, hp, height=res, width=res,
            num_inference_steps=n_steps, cfg_interval=cfg_interval)
        if z_transform is None:
            _, _, edited = apply_emcid_to_sdxl_text_encoders(
                comps, requests, hp, mean, logvar, covs_1, covs_2,
                height=res, width=res, rng_seed=rng_seed, verbose=False)
        else:
            z1, z2 = compute_z_sdxl_text_encoders(
                comps, requests, hp, mean, logvar,
                gen=torch.Generator(device=comps.device).manual_seed(
                    rng_seed),
                height=res, width=res, verbose=False)
            z1 = np.asarray(z_transform(np.asarray(z1)))
            z2 = np.asarray(z_transform(np.asarray(z2)))
            _, _, edited = execute_emcid_sd_xl_text_encoders(
                comps, requests, hp, z1, z2, covs_1, covs_2, verbose=False)
        rows.append(sdxl_metrics(edited, scorer, seed))
    return np.stack(rows)

"""PyTorch port, the SD text-encoder edit as a whole, against the JAX package
on the tiny pipeline, chained: training images -> Stage 1 -> covariances ->
Stage 2 -> the npz stats cache in both directions.  Plus a port
``apply_emcid`` run on the CPU."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from emcid_tpu.models.loader import build_tiny_pipeline

from torch_parity import TINY_WORDS, port_components, rel_diff

REQUESTS = [
    {"prompts": ["a photo of a {}", "an image of a {}"], "source": "cat",
     "dest": "dog", "seed_train": 0},
    {"prompts": ["a photo of a {}", "an image of a {}"], "source": "w1",
     "dest": "w2", "seed_train": 1},
]


def _hparams(pkg_hparams, steps=4):
    return pkg_hparams.EMCIDHyperParams.from_dict({
        "layers": [1, 2], "clamp_norm_factor": 1.5,
        "layer_selection": "all", "fact_token": "subject_last",
        "v_num_grad_steps": steps, "v_lr": 0.2, "v_weight_decay": 5e-4,
        "mom2_adjustment": True, "mom2_update_weight": 4000,
        "rewrite_module_tmp": "text_model.encoder.layers.{}.mlp.fc2",
        "layer_module_tmp": "text_model.encoder.layers.{}",
        "mlp_module_tmp": "text_model.encoder.layers.{}.mlp",
        "attn_module_tmp": "text_model.encoder.layers.{}.self_attn",
        "ln_f_module": "text_model.final_layer_norm",
        "mom2_dataset": "ccs_filtered", "mom2_n_samples": 100,
        "mom2_dtype": "float32", "objective": "ablate-dest",
        "esd_mu": "None", "cal_text_repr_loss": True,
        "text_repr_loss_scale_factor": 0.01,
    })


@pytest.fixture(scope="module")
def pair():
    comps = build_tiny_pipeline(seed=0, words=TINY_WORDS)
    return comps, port_components(comps)


def test_slice_matches_jax(pair, tmp_path, monkeypatch):
    import emcid_tpu.hparams as jhp
    import emcid_tpu.models.pipeline as jpipe
    from emcid_tpu.dsets.stat_dataset import make_synthetic_captions as jcaps
    from emcid_tpu.engine import compute_z as jcz
    from emcid_tpu.engine.emcid import execute_emcid_text_encoder as jexec
    from emcid_tpu.engine.layer_stats import get_cov_text_encoder as jcov
    from emcid_tpu.engine.training_images import generate_posteriors as jgen

    import emcid_torch.hparams as thp
    from emcid_torch.dsets.stat_dataset import make_synthetic_captions
    from emcid_torch.engine import compute_z as tcz
    from emcid_torch.engine.emcid import execute_emcid_text_encoder
    from emcid_torch.engine.layer_stats import get_cov_text_encoder
    from emcid_torch.engine.training_images import generate_posteriors

    comps, pc = pair
    C, P, steps = len(REQUESTS), 2, 4
    rng = np.random.RandomState(0)

    # 1. training images from the same initial latents
    prompts = [p.format(r["source"]) for r in REQUESTS for p in r["prompts"]]
    seeds = list(range(len(prompts)))
    lat0 = rng.randn(len(prompts), 8, 8, 4).astype(np.float32)
    monkeypatch.setattr(jpipe, "initial_latents",
                        lambda *a, **k: jnp.asarray(lat0))
    kw = dict(num_inference_steps=4, guidance_scale=7.5, height=16,
              width=16, sampler="dpm++", cfg_interval=0.5)
    from emcid_torch.models.pipeline import sample_latents

    jlat = jpipe.sample_latents(comps, prompts, seeds, **kw)
    tlat = sample_latents(pc, prompts, seeds, latents=torch.from_numpy(lat0),
                          **kw)
    assert rel_diff(jlat, tlat) <= 1e-5
    jmean, jlogvar = jgen(comps, prompts, seeds, **kw)
    tmean, tlogvar = generate_posteriors(pc, prompts, seeds,
                                         latents=torch.from_numpy(lat0), **kw)
    # the decoded image is quantized to uint8 levels before re-encoding: a
    # 1e-6 difference in a pixel can flip one level (1/255), which moves the
    # posterior by ~5e-4 of its largest value (one pixel of 3072 here)
    assert rel_diff(jmean, tmean) <= 2e-3
    assert rel_diff(jlogvar, tlogvar) <= 2e-3

    # 2. Stage 1 with replayed noise/timesteps; logvar -60 with one image
    # per prompt makes the posterior draw and the image index drop out
    jh, th = _hparams(jhp, steps), _hparams(thp, steps)
    mean = np.asarray(jmean).reshape(C, 1, P, 8, 8, 4)
    logvar = np.full_like(mean, -60.0)
    noise = rng.randn(steps, C, P, 8, 8, 4).astype(np.float32)
    ts = rng.randint(0, 1000, (steps, C, P)).astype(np.int32)
    arrays, _, _ = jcz.prepare_concept_batch(comps.tokenizer, REQUESTS, jh)
    jbatch = jcz.ConceptBatch(**{k: jnp.asarray(v) for k, v in arrays.items()},
                              latents_mean=jnp.asarray(mean),
                              latents_logvar=jnp.asarray(logvar))
    jopt = jcz.ZOptimizer(comps.text_encoder, comps.unet, comps.schedule, jh,
                          layer=2, eps_pool=0, lr_sched="const")
    jz, _, _, jloss = jopt.run(comps.text_params, comps.unet_params, jbatch,
                               jax.random.PRNGKey(0), noise_override=noise,
                               ts_override=ts)
    tarrays, _, _ = tcz.prepare_concept_batch(pc.tokenizer, REQUESTS, th)
    tarrays.update(latents_mean=mean, latents_logvar=logvar)
    tbatch = tcz.concept_batch_to_device(tarrays, "cpu")
    topt = tcz.ZOptimizer(pc.text_encoder, pc.unet, pc.schedule, th,
                          layer=2, eps_pool=0, lr_sched="const")
    tz, _, _, tloss = topt.run(tbatch, torch.Generator().manual_seed(0),
                               noise_override=noise, ts_override=ts)
    jz, tz = np.asarray(jz).reshape(C, -1), tz.numpy().reshape(C, -1)
    cos = (jz * tz).sum(-1) / np.linalg.norm(jz, axis=-1) / np.linalg.norm(
        tz, axis=-1)
    assert cos.min() >= 0.9999, cos
    ratio = np.linalg.norm(tz, axis=-1) / np.linalg.norm(jz, axis=-1)
    assert np.abs(ratio - 1).max() <= 1e-3, ratio
    assert rel_diff(jloss, tloss) <= 1e-4

    # 3. covariances over the same synthetic captions (each package writes
    # its own npz cache)
    caps = make_synthetic_captions(150)
    assert caps == jcaps(150)
    layer_names = [jh.rewrite_module_tmp.format(i) for i in jh.layers]
    cov_kw = dict(mom2_dataset="synthetic", mom2_n_samples=150,
                  model_name="torch_parity_text", captions=caps,
                  verbose=False)
    jcovs = [np.asarray(jcov(comps.text_encoder, comps.text_params,
                             comps.tokenizer, n, stat_dir=tmp_path / "jax",
                             **cov_kw)) for n in layer_names]
    tcovs = [get_cov_text_encoder(pc.text_encoder, pc.tokenizer, n,
                                  stat_dir=tmp_path / "torch", **cov_kw)
             for n in layer_names]
    for a, b in zip(jcovs, tcovs):
        assert rel_diff(a, b) <= 1e-5

    # 4. Stage 2 from the same zs (relative Frobenius error).  The keys come
    # from each package's own f32 forward, which differ by ~5e-7 of their
    # largest value (summation order).  The solve multiplies that by the
    # conditioning of lam*C + K K^T: the tiny model's layer-2 covariance
    # over the synthetic corpus has condition number ~2.6e5, which puts
    # the f64 adj_k ~1.7e-6 apart on the chained covariances, so there the
    # f64 deltas are held at 1e-5 and the edited weights at 1e-6; on
    # seeded well-conditioned covariances the f64 deltas are held at 1e-6.
    zs = np.array(jz).reshape(C, 1, -1)
    jcovs = [np.array(c) for c in jcovs]
    r = np.random.RandomState(1)
    wide = [r.randn(4 * c.shape[0], c.shape[0]).astype(np.float32)
            for c in jcovs]
    seeded = [(a.T @ a / a.shape[0]).astype(np.float32) for a in wide]
    for method, covs, tol_delta, tol_w in (
            ("f32_ir", jcovs, 1e-4, 1e-4), ("f64", jcovs, 1e-5, 1e-6),
            ("f64", seeded, 1e-6, 1e-6)):
        jd, jparams = jexec(comps.text_encoder, comps.text_params,
                            comps.tokenizer, REQUESTS, jh, zs=zs,
                            covs=covs, solve_method=method, verbose=False)
        td, tmodel = execute_emcid_text_encoder(
            pc.text_encoder, pc.tokenizer, REQUESTS, th, zs=zs, covs=covs,
            solve_method=method, verbose=False)
        assert set(jd) == set(td)
        for name, (adj, resid) in jd.items():
            assert rel_diff(adj, td[name][0], "fro") <= tol_delta, (
                method, name)
            assert rel_diff(resid, td[name][1], "fro") <= tol_delta, (
                method, name)
        for i in jh.layers:
            w_j = np.asarray(jparams[f"layers_{i}"]["mlp"]["fc2"]["kernel"]).T
            w_t = tmodel.get_submodule(
                f"text_model.encoder.layers.{i}.mlp.fc2").weight
            assert rel_diff(w_j, w_t, "fro") <= tol_w, (method, i)

    # 5. an npz stats cache written by each package loads in the other:
    # the port reads the JAX-written files (no captions: cache hit or
    # FileNotFoundError); the JAX package's npz codec reads the port's
    # (through its stats classes: its get_cov also memoizes in-process by
    # layer name, which would hide the file)
    from emcid_tpu.stats import CombinedStat, SecondMoment
    from emcid_torch.engine.layer_stats import stats_filename

    for n, a in zip(layer_names, jcovs):
        from_jax = get_cov_text_encoder(pc.text_encoder, pc.tokenizer, n,
                                        stat_dir=tmp_path / "jax",
                                        **dict(cov_kw, captions=None))
        assert rel_diff(a, from_jax) <= 1e-5
        f_t = stats_filename(tmp_path / "torch", "torch_parity_text",
                             "synthetic", n, sample_size=150)
        st = CombinedStat(mom2=SecondMoment(), state=str(f_t))
        assert rel_diff(a, np.asarray(st.mom2.moment())) <= 1e-5


def test_apply_emcid_tiny_cpu(pair, tmp_path):
    """The port's product path on the CPU: finite, and only the fc2 weights
    of the edited layers change."""
    import emcid_torch.hparams as thp
    from emcid_torch.engine.editor import apply_emcid

    _, pc = pair
    hp = _hparams(thp, steps=3)
    timings = {}
    edited, deltas = apply_emcid(pc, REQUESTS, hp, stats_dir=tmp_path,
                                 num_inference_steps=3, timings=timings,
                                 verbose=False)
    assert set(timings) == {"covariances", "generation", "stage1", "stage2"}
    assert all(np.isfinite(a).all() and np.isfinite(r).all()
               for a, r in deltas.values())
    before = dict(pc.text_encoder.named_parameters())
    changed = {k for k, v in edited.text_encoder.named_parameters()
               if not torch.equal(v, before[k])}
    assert changed == {f"text_model.encoder.layers.{i}.mlp.fc2.weight"
                       for i in hp.layers}
    # the factor-pair deltas alone reproduce the edit
    from emcid_torch.engine.emcid import apply_deltas_to_params

    replayed = dict(apply_deltas_to_params(pc.text_encoder,
                                           deltas).named_parameters())
    for name in changed:
        w = dict(edited.text_encoder.named_parameters())[name]
        assert rel_diff(w.detach(), replayed[name]) <= 1e-6, name


@pytest.mark.parametrize("change", [
    {"objective": "esd", "esd_mu": 1.0}, {"use_sampled_noise": True},
    {"no_noise_loss": True}, {"align_object_token": True}])
def test_variant_branches_run(pair, tmp_path, change):
    """The Stage-1 variants the port once refused run through
    ``apply_emcid``: finite deltas on the fc2 weights of the edited layers
    only (parity with the JAX package: ``tests/test_torch_variants.py``)."""
    import dataclasses

    import emcid_torch.hparams as thp
    from emcid_torch.engine.editor import apply_emcid

    _, pc = pair
    hp = dataclasses.replace(_hparams(thp, steps=2), **change)
    edited, deltas = apply_emcid(pc, REQUESTS, hp, stats_dir=tmp_path,
                                 num_inference_steps=2, verbose=False)
    assert all(np.isfinite(a).all() and np.isfinite(r).all()
               for a, r in deltas.values())
    assert set(deltas) == {f"text_model.encoder.layers.{i}.mlp.fc2.weight"
                           for i in hp.layers}
    before = dict(pc.text_encoder.named_parameters())
    assert {k for k, v in edited.text_encoder.named_parameters()
            if not torch.equal(v, before[k])} == set(deltas)


def test_unsupported_branches_raise(pair):
    """What still waits raises: ``mesh=`` sharding (ROADMAP M14)."""
    import emcid_torch.hparams as thp
    from emcid_torch.engine.editor import apply_emcid, compute_zs_for_requests

    _, pc = pair
    hp = _hparams(thp)
    with pytest.raises(NotImplementedError, match="mesh"):
        apply_emcid(pc, REQUESTS, hp, mesh=object(), verbose=False)
    with pytest.raises(NotImplementedError, match="mesh"):
        compute_zs_for_requests(pc, REQUESTS, hp, mesh=object(),
                                verbose=False)

"""PyTorch port, the variant paths of the text-encoder edit, against the JAX
package on the tiny pipeline: the knobs the port reads like the JAX package
(``EMCID_TPU_GEN_BATCH``, the Stage-1 knobs, ``EMCID_TPU_NO_FLASH``), the
Stage-1 loss branches (esd, use_sampled_noise, no_noise_loss,
align_object_token, EWC), the Fisher statistic and its npz cache, SLD
sampling, the CLIP vision tower and txt-img-align, the UCE edits, training
images given or read from files, and ``apply_emcid`` with EWC and the UCE
hybrid.

Both packages get the same inputs from numpy seeds; Stage 1 replays the
same noise and timesteps, with logvar -60 and one image per prompt so the
posterior draw and the image index drop out.  Tolerances are relative to
the largest reference value (``rel_diff``): 1e-4 through Stage 1, the
Fisher draw and the UCE solve (f32 on both sides, summation order only),
1e-5 through a single forward, 2e-3 where a decoded image is quantized to
uint8 levels (one level flips a pixel) and for SLD sampling (its safety
mask switches on a threshold).
"""

import dataclasses

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
STEPS = 4


def _hparams(pkg_hparams, **over):
    d = {
        "layers": [1, 2], "clamp_norm_factor": 1.5,
        "layer_selection": "all", "fact_token": "subject_last",
        "v_num_grad_steps": STEPS, "v_lr": 0.2, "v_weight_decay": 5e-4,
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
    }
    d.update(over)
    return pkg_hparams.EMCIDHyperParams.from_dict(d)


@pytest.fixture(scope="module")
def pair():
    comps = build_tiny_pipeline(seed=0, words=TINY_WORDS)
    return comps, port_components(comps)


def _seeded_latents(to_tensor):
    """A stand-in for ``initial_latents`` that draws each image's latents
    from numpy seeded with its seed (the same in both packages)."""
    def initial_latents(seeds, height, width, channels=4, vae_scale=8,
                        **_):
        return to_tensor(np.stack([
            np.random.RandomState(int(s)).randn(
                height // vae_scale, width // vae_scale, channels)
            for s in seeds]).astype(np.float32))
    return initial_latents


# ---------------------------------------------------------------------------
# the knobs (F4-F6)
# ---------------------------------------------------------------------------


def test_gen_batch_caps_posterior_generation(pair, monkeypatch):
    """F4: ``EMCID_TPU_GEN_BATCH`` caps ``generate_posteriors``' batches,
    and the chunked posteriors equal the single batch's."""
    import emcid_torch.engine.training_images as ti

    _, pc = pair
    prompts = ["a photo of a cat", "a dog", "w1", "an image of w2", "art"]
    kw = dict(num_inference_steps=2, height=16, width=16, sampler="dpm++")
    monkeypatch.delenv("EMCID_TPU_GEN_BATCH", raising=False)
    one_mean, one_logvar = ti.generate_posteriors(pc, prompts, range(5), **kw)
    sizes = []
    real = ti.sample_latents

    def spy(components, prompts, seeds, **k):
        sizes.append(len(prompts))
        return real(components, prompts, seeds, **k)

    monkeypatch.setattr(ti, "sample_latents", spy)
    monkeypatch.setenv("EMCID_TPU_GEN_BATCH", "2")
    mean, logvar = ti.generate_posteriors(pc, prompts, range(5), **kw)
    assert sizes == [2, 2, 1]
    assert rel_diff(one_mean, mean) <= 2e-3
    assert rel_diff(one_logvar, logvar) <= 2e-3
    # a cap, never a target: a shorter list runs in one batch of its length
    sizes.clear()
    monkeypatch.setenv("EMCID_TPU_GEN_BATCH", "8")
    ti.generate_posteriors(pc, prompts[:3], range(3), **kw)
    assert sizes == [3]


def test_z_optimizer_env_defaults_match_jax(pair, monkeypatch):
    """F5: the port's ``ZOptimizer`` takes ``eps_pool``, ``lr_sched``,
    ``z_frac`` and ``z_peak`` from the environment at instance time, as
    the JAX package's does; explicit arguments win; the cosine schedule's
    learning rates equal the JAX package's."""
    import emcid_tpu.hparams as jhp
    from emcid_tpu.engine.compute_z import ZOptimizer as JZ

    import emcid_torch.hparams as thp
    from emcid_torch.engine.compute_z import ZOptimizer as TZ

    comps, pc = pair
    for k, v in (("EMCID_TPU_EPS_POOL", "7"), ("EMCID_TPU_Z_SCHED", "cosine"),
                 ("EMCID_TPU_Z_FRAC", "0.5"), ("EMCID_TPU_Z_PEAK", "3")):
        monkeypatch.setenv(k, v)
    jh = _hparams(jhp, v_num_grad_steps=100)
    th = _hparams(thp, v_num_grad_steps=100)
    jopt = JZ(comps.text_encoder, comps.unet, comps.schedule, jh, layer=2)
    topt = TZ(pc.text_encoder, pc.unet, pc.schedule, th, layer=2)
    fields = ("eps_pool", "lr_sched", "z_frac", "z_peak")
    assert ([getattr(topt, f) for f in fields]
            == [getattr(jopt, f) for f in fields] == [7, "cosine", 0.5, 3.0])
    explicit = TZ(pc.text_encoder, pc.unet, pc.schedule, th, layer=2,
                  eps_pool=0, lr_sched="const", z_frac=0.6, z_peak=2.0)
    assert [getattr(explicit, f) for f in fields] == [0, "const", 0.6, 2.0]

    # the JAX package's schedule, read off the learning rates its run
    # hands to the compiled step program
    seen = []

    def fake_run(*args, steps, lrs, **kw):
        seen.append(np.asarray(lrs))
        return None, None, None, jnp.zeros((steps,)), None

    jopt.eps_pool = 0
    jopt._run = fake_run
    jopt.run(comps.text_params, comps.unet_params, None)
    j_lrs = np.concatenate(seen)
    t_lrs = topt.lr_values(replay=False)
    assert len(t_lrs) == len(j_lrs) == 50
    np.testing.assert_allclose(t_lrs, j_lrs, rtol=1e-6, atol=0)


def test_no_flash_takes_block_attention(monkeypatch):
    """F6: under ``EMCID_TPU_NO_FLASH=1`` every length takes the one-block
    einsum path (not the chunked scan), as in the JAX package."""
    from emcid_tpu.ops.attention import attention as jattention

    import emcid_torch.ops.attention as tatt

    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(1, 1024, 2, 8).astype(np.float32) for _ in range(3))
    calls = []
    real = tatt._block_attention

    def spy(qi, *a):
        calls.append(qi.shape[1])
        return real(qi, *a)

    monkeypatch.setattr(tatt, "_block_attention", spy)
    monkeypatch.setenv("EMCID_TPU_NO_FLASH", "1")
    out = tatt.attention(*map(torch.from_numpy, (q, k, v)))
    ref = jattention(*map(jnp.asarray, (q, k, v)))
    assert calls == [1024]
    assert rel_diff(ref, out) <= 1e-5


# ---------------------------------------------------------------------------
# Stage 1: the loss branches, EWC and txt-img-align
# ---------------------------------------------------------------------------


def _stage1_both(pair, over, fim=None, proj=None, emb=None, tia_w=None,
                 jax_too=True):
    """Run the JAX and the port ``ZOptimizer`` on the same block, training
    latents and replayed noise; returns (jz, jloss, tz, tloss) (the JAX
    pair None without ``jax_too``)."""
    import emcid_tpu.hparams as jhp
    from emcid_tpu.engine import compute_z as jcz

    import emcid_torch.hparams as thp
    from emcid_torch.engine import compute_z as tcz

    comps, pc = pair
    C, P = len(REQUESTS), 2
    rng = np.random.RandomState(3)
    jh, th = _hparams(jhp, **over), _hparams(thp, **over)
    mean = (0.5 * rng.randn(C, 1, P, 8, 8, 4)).astype(np.float32)
    logvar = np.full_like(mean, -60.0)
    noise = rng.randn(STEPS, C, P, 8, 8, 4).astype(np.float32)
    ts = rng.randint(0, 1000, (STEPS, C, P)).astype(np.int32)
    arrays, _, _ = jcz.prepare_concept_batch(comps.tokenizer, REQUESTS, jh)
    jbatch = jcz.ConceptBatch(**{k: jnp.asarray(v) for k, v in arrays.items()},
                              latents_mean=jnp.asarray(mean),
                              latents_logvar=jnp.asarray(logvar))
    jz = jloss = None
    if jax_too:
        jopt = jcz.ZOptimizer(comps.text_encoder, comps.unet, comps.schedule,
                              jh, layer=2, eps_pool=0, lr_sched="const",
                              fim=fim, text_projection=proj)
        jz, _, _, jloss = jopt.run(
            comps.text_params, comps.unet_params, jbatch,
            jax.random.PRNGKey(0), noise_override=noise, ts_override=ts,
            dest_img_emb=emb, tia_weight=tia_w)
    tarrays, _, _ = tcz.prepare_concept_batch(pc.tokenizer, REQUESTS, th)
    tarrays.update(latents_mean=mean, latents_logvar=logvar)
    topt = tcz.ZOptimizer(pc.text_encoder, pc.unet, pc.schedule, th,
                          layer=2, eps_pool=0, lr_sched="const", fim=fim,
                          text_projection=proj)
    tz, _, _, tloss = topt.run(tcz.concept_batch_to_device(tarrays, "cpu"),
                               torch.Generator().manual_seed(0),
                               noise_override=noise, ts_override=ts,
                               dest_img_emb=emb, tia_weight=tia_w)
    return jz, jloss, tz, tloss


@pytest.mark.parametrize("branch", [
    "esd", "use_sampled_noise", "no_noise_loss", "align_object_token", "ewc"])
def test_loss_branch_matches_jax(pair, branch):
    over, fim = {}, None
    if branch == "esd":
        over = {"objective": "esd", "esd_mu": 1.0}
    elif branch == "align_object_token":
        over = {"align_object_token": True, "text_repr_loss_scale_factor": 1.0}
    elif branch == "ewc":
        over = {"use_ewc": True, "ewc_lambda": 1e4}
        fim = np.random.RandomState(4).rand(32).astype(np.float32) * 1e-2
    else:
        over = {branch: True}
    jz, jloss, tz, tloss = _stage1_both(pair, over, fim=fim)
    assert len(tloss) == STEPS
    assert rel_diff(jloss, tloss) <= 1e-4, (np.asarray(jloss), tloss)
    assert rel_diff(jz, tz) <= 1e-4


def test_ewc_without_fim_raises(pair):
    import emcid_torch.hparams as thp
    from emcid_torch.engine import compute_z as tcz

    _, pc = pair
    th = _hparams(thp, use_ewc=True)
    arrays, _, _ = tcz.prepare_concept_batch(pc.tokenizer, REQUESTS, th)
    arrays.update(latents_mean=np.zeros((2, 1, 2, 8, 8, 4), np.float32),
                  latents_logvar=np.zeros((2, 1, 2, 8, 8, 4), np.float32))
    optz = tcz.ZOptimizer(pc.text_encoder, pc.unet, pc.schedule, th, layer=2)
    with pytest.raises(ValueError, match="FIM"):
        optz.run(tcz.concept_batch_to_device(arrays, "cpu"))


@pytest.mark.parametrize("metric", ["l2", "cos"])
def test_txt_img_align_matches_jax(pair, metric):
    rng = np.random.RandomState(5)
    proj = rng.randn(32, 16).astype(np.float32)
    emb = rng.randn(2, 2, 16).astype(np.float32)
    tia_w = np.asarray([1.0, 0.0], np.float32)
    jz, jloss, tz, tloss = _stage1_both(
        pair, {"txt_img_align_scale_factor": 5.0,
               "txt_img_align_loss_metric": metric},
        proj=proj, emb=emb, tia_w=tia_w)
    assert rel_diff(jloss, tloss) <= 1e-4
    assert rel_diff(jz, tz) <= 1e-4
    # the term is in the loss: without it the port's losses move
    *_, plain_loss = _stage1_both(pair, {}, jax_too=False)
    assert rel_diff(plain_loss, tloss) > 1e-3


def test_txt_img_align_routing(pair, tmp_path):
    """The editor refuses a txt-img-align request without a vision tower;
    with one it trains flagged concepts on dest images; a mixed block keeps
    source images for the unflagged concept."""
    import emcid_torch.hparams as thp
    from emcid_torch.engine.editor import compute_zs_for_requests
    from emcid_torch.engine.training_images import (
        training_latents_for_requests,
    )
    from emcid_torch.models.vision import (
        TINY_CLIP_VISION,
        build_random_clip_vision,
    )

    _, pc = pair
    hp = _hparams(thp, v_num_grad_steps=2, txt_img_align_scale_factor=0.5)
    reqs = [dict(REQUESTS[0], txt_img_align=True), REQUESTS[1]]
    with pytest.raises(ValueError, match="clip_align"):
        compute_zs_for_requests(pc, reqs, hp, num_inference_steps=2,
                                verbose=False)
    tower = build_random_clip_vision(TINY_CLIP_VISION, seed=0, device="cpu")
    proj = torch.from_numpy(
        np.random.RandomState(6).randn(32, 16).astype(np.float32))
    zs = compute_zs_for_requests(pc, reqs, hp, clip_align=(tower, proj),
                                 num_inference_steps=2, verbose=False)
    assert zs.shape == (2, 1, 32) and np.isfinite(zs).all()

    kw = dict(height=16, width=16, num_inference_steps=2)
    hp1 = type("HP", (), {"samples_per_prompt": 1})()
    mixed, _, imgs = training_latents_for_requests(
        pc, reqs, hp1, use_dest_prompts=[True, False], return_images=True,
        **kw)
    src, _ = training_latents_for_requests(pc, reqs, hp1, **kw)
    dest, _ = training_latents_for_requests(pc, reqs, hp1,
                                            use_dest_prompts=True, **kw)
    assert imgs.shape == (4, 16, 16, 3)
    assert torch.equal(mixed[0], dest[0]) and torch.equal(mixed[1], src[1])
    assert not torch.equal(mixed[1], dest[1])


# ---------------------------------------------------------------------------
# the Fisher statistic (EWC)
# ---------------------------------------------------------------------------


def test_fim_draw_matches_jax(pair):
    """One pair's draws: the port's ``fim_draws`` against the same draws
    rebuilt from the JAX package's text encoder, UNet, ``add_noise`` and
    ``solve_adj_k`` (weight gradient, then the contraction)."""
    from emcid_tpu.models.naming import get_weight, set_weight
    from emcid_tpu.models.scheduler import add_noise
    from emcid_tpu.ops.solve import solve_adj_k

    from emcid_torch.engine.fim import fim_draws

    comps, pc = pair
    rng = np.random.RandomState(7)
    name, layer, lam, T = "text_model.encoder.layers.2.mlp.fc2", 2, 10.0, 2
    tok = comps.tokenizer
    ids = np.asarray(tok(["a photo of a cat"], padding="max_length",
                         max_length=tok.model_max_length)["input_ids"])
    a = rng.randn(256, 64).astype(np.float32)
    cov = a.T @ a / 256
    lat = rng.randn(8, 8, 4).astype(np.float32)
    noise = rng.randn(T, 8, 8, 4).astype(np.float32)
    ts = np.asarray([120, 870], np.int32)
    token_idx = 3

    tp, text, unet = comps.text_params, comps.text_encoder, comps.unet
    out = text.apply({"params": tp}, jnp.asarray(ids), capture=("fc2_in",),
                     stop_at_layer=layer)
    k1 = np.asarray(out.taps["fc2_in"][layer][0, token_idx])[:, None]
    right_vec = jnp.asarray(solve_adj_k(cov, k1, lam, method="f64")[:, 0],
                            jnp.float32)

    def weight_loss(w, n, t):
        txt = text.apply({"params": set_weight(tp, name, w)},
                         jnp.asarray(ids)).last_hidden_state
        noisy = add_noise(comps.schedule, jnp.asarray(lat)[None], n[None],
                          t[None])
        pred = unet.apply({"params": comps.unet_params}, noisy, t[None],
                          txt).sample
        return jnp.mean((pred - n[None]) ** 2)

    w0 = get_weight(tp, name)
    grad = jax.jit(jax.grad(weight_loss))
    ref = np.stack([np.asarray(
        (grad(w0, jnp.asarray(noise[i]), jnp.asarray(ts[i])) @ right_vec)
        ** 2) for i in range(T)])
    got = fim_draws(pc, name, ids[0], token_idx, cov, lat, noise, ts, lam)
    assert got.shape == (T, 32)
    assert rel_diff(ref, got) <= 1e-4


def test_mean_and_fim_npz_cross_load(pair, tmp_path):
    """A ``CombinedStat(mean=Mean())`` npz written by either package loads
    in the other, exactly; the port's ``fim_stats`` writes one."""
    from emcid_tpu.engine.fim import load_fim as jload
    from emcid_tpu.stats import CombinedStat as JStat, Mean as JMean
    from emcid_tpu.stats import save_cached_state as jsave

    from emcid_torch.engine.fim import fim_filename, fim_stats, load_fim
    from emcid_torch.stats import CombinedStat, Mean, save_cached_state

    rng = np.random.RandomState(8)
    rows = [rng.rand(3, 32).astype(np.float32) for _ in range(3)]
    jstat, tstat = JStat(mean=JMean()), CombinedStat(mean=Mean())
    for r in rows:
        jstat.add(r)
        tstat.add(r)
    jsave(str(tmp_path / "j.npz"), jstat, {"sample_size": 3})
    save_cached_state(str(tmp_path / "t.npz"), tstat, {"sample_size": 3})
    np.testing.assert_array_equal(load_fim(tmp_path / "j.npz"),
                                  np.asarray(jstat.mean.mean()))
    np.testing.assert_array_equal(jload(tmp_path / "t.npz"),
                                  tstat.mean.mean())
    back = JStat(mean=JMean(), state=str(tmp_path / "t.npz"))
    assert (back.mean.count, back.mean.batchcount) == (9, 3)

    _, pc = pair
    imgs = rng.rand(2, 16, 16, 3).astype(np.float32) * 2 - 1
    a = rng.randn(128, 64).astype(np.float32)
    name = "text_model.encoder.layers.2.mlp.fc2"
    stat = fim_stats(pc, name, list(zip(imgs, ["a cat", "a photo of w1"])),
                     a.T @ a / 128, mom2_weight=10.0, t_steps_per_pair=2,
                     stats_dir=tmp_path, sample_size=2)
    path = fim_filename(tmp_path, "text_encoder", "ccs_filtered", name,
                        "float32", 2, 2)
    assert path.exists() and stat.mean.count == 4
    np.testing.assert_array_equal(jload(path), stat.mean.mean())
    assert np.isfinite(stat.mean.mean()).all()


def test_resolve_fim_cache_order(pair, tmp_path, monkeypatch):
    """Both packages' ``resolve_fim`` read the same cache file, in the same
    order: (step10, 3000), unsized, ``EMCID_TPU_FIM_PAIRS`` pairs, then the
    reference bundle's layer-10 file (as ``tests/test_ewc_wiring.py``)."""
    import emcid_tpu.hparams as jhp
    from emcid_tpu.engine.fim import resolve_fim as jresolve
    from emcid_tpu.stats import CombinedStat as JStat, Mean as JMean
    from emcid_tpu.stats import save_cached_state as jsave

    import emcid_torch.hparams as thp
    from emcid_torch.engine.fim import fim_candidates, resolve_fim

    comps, pc = pair
    monkeypatch.setenv("EMCID_TPU_FIM_PAIRS", "5")
    jh, th = _hparams(jhp), _hparams(thp)
    cands = fim_candidates(th, tmp_path)
    assert [p.name for p in cands] == [
        "text_model.encoder.layers.2.mlp.fc2_float32_mean_step10_3000.npz",
        "text_model.encoder.layers.2.mlp.fc2_float32_mean_step10.npz",
        "text_model.encoder.layers.2.mlp.fc2_float32_mean_step10_5.npz",
        "text_model.encoder.layers.10.mlp.fc2_float32_mean_step10_3000.npz"]
    cov = np.eye(64, dtype=np.float32)
    for value, path in zip((0.4, 0.3, 0.2, 0.1), cands[::-1]):
        stat = JStat(mean=JMean())
        stat.add(np.full((2, 32), value, np.float32))
        path.parent.mkdir(parents=True, exist_ok=True)
        jsave(str(path), stat, {})
        got = resolve_fim(pc, th, cov=cov, fim_dir=tmp_path, verbose=False)
        ref = jresolve(comps, jh, cov=cov, fim_dir=tmp_path, verbose=False)
        np.testing.assert_allclose(got, np.full(32, value), rtol=1e-6)
        np.testing.assert_array_equal(got, np.asarray(ref))


# ---------------------------------------------------------------------------
# SLD supervision
# ---------------------------------------------------------------------------


def test_sld_sampling_matches_jax(pair, monkeypatch):
    from emcid_tpu.engine import compute_z_variants as jvar

    from emcid_torch.engine.compute_z_variants import (
        SLD_CONFIGS,
        sld_sample_latents,
    )

    comps, pc = pair
    assert SLD_CONFIGS == jvar.SLD_CONFIGS
    lat0 = np.random.RandomState(9).randn(2, 8, 8, 4).astype(np.float32)
    monkeypatch.setattr(jvar, "initial_latents",
                        lambda *a, **k: jnp.asarray(lat0))
    for sld_type in ("max", "strong"):
        kw = dict(sld_type=sld_type, num_inference_steps=3, height=16,
                  width=16)
        ref = jvar.sld_sample_latents(comps, ["a cat w1", "a dog"], [3, 4],
                                      "w1", **kw)
        got = sld_sample_latents(pc, ["a cat w1", "a dog"], [3, 4], "w1",
                                 latents=torch.from_numpy(lat0), **kw)
        assert rel_diff(ref, got) <= 2e-3, sld_type


def test_sld_global_z_runs(pair):
    import emcid_torch.hparams as thp
    from emcid_torch.engine.compute_z_variants import (
        compute_z_text_encoder_global,
    )

    _, pc = pair
    req = {"source_prompts": ["a cat w1 photo", "w1 of a dog"],
           "seeds": [1, 2], "safe_words": ["w2"] * 2, "source": "w1",
           "dest": " ", "source_cat": "w1"}
    hp = _hparams(thp, v_num_grad_steps=2, sld_supervision=True)
    z = compute_z_text_encoder_global(pc, req, hp, layer=2,
                                      num_inference_steps=2, height=16,
                                      width=16, verbose=False)
    assert z.shape == (1, 32) and np.isfinite(z).all()


# ---------------------------------------------------------------------------
# the CLIP vision tower
# ---------------------------------------------------------------------------


def test_clip_vision_matches_jax():
    """One HF-named state dict loads into both packages' towers; the image
    embeddings and ``preprocess_for_model`` agree."""
    from emcid_tpu.models import vision as jv

    from emcid_torch.models import vision as tv

    rng = np.random.RandomState(10)
    model = tv.CLIPVisionEncoder(tv.TINY_CLIP_VISION)
    sd = {}
    for k, v in model.state_dict().items():
        base = 1.0 if "norm" in k and k.endswith("weight") else 0.0
        sd[k] = (base + 0.2 * rng.randn(*v.shape)).astype(np.float32)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)
    jmodel = jv.CLIPVisionEncoder(jv.TINY_CLIP_VISION)
    params = jv.clip_vision_from_torch(sd)
    for shape in ((2, 40, 40, 3), (2, 16, 16, 3)):
        imgs = rng.randint(0, 256, shape).astype(np.uint8)
        jpx = jv.preprocess_for_model(imgs, 32, jv.CLIP_IMAGE_MEAN,
                                      jv.CLIP_IMAGE_STD)
        tpx = tv.preprocess_for_model(imgs, 32, tv.CLIP_IMAGE_MEAN,
                                      tv.CLIP_IMAGE_STD)
        assert rel_diff(jpx, tpx) <= 1e-5
        ref = jmodel.apply({"params": params}, jpx)
        with torch.no_grad():
            got = model(tpx)
        assert got.shape == (2, 16)
        assert rel_diff(ref, got) <= 1e-5


# ---------------------------------------------------------------------------
# UCE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["replace", "tensor", "retain", "mom2",
                                  "layers_no_k"])
def test_edit_model_uce_matches_jax(pair, case):
    from emcid_tpu.engine.uce import edit_model_uce as jedit
    from emcid_tpu.engine.uce import get_unet_weight
    from emcid_tpu.models.unet import cross_attn_kv_layer_names as jnames

    from emcid_torch.engine.uce import (
        cross_attn_kv_layer_names,
        edit_model_uce,
    )

    comps, pc = pair
    # lamb 1 keeps mat2's condition number near 2e3: f32 solves of it
    # then differ by ~1e-5 (at lamb 0.1, ~2e4, the JAX package's
    # unrefined f32 Cholesky is itself 2e-4 off the float64 solve)
    kw = dict(technique="replace" if case == "replace" else "tensor",
              lamb=1.0, erase_scale=1.0)
    if case == "retain":
        kw.update(retain_texts=["w2", "a photo of a dog"],
                  preserve_scale=0.5)
    elif case == "mom2":
        a = np.random.RandomState(11).randn(128, 32).astype(np.float32)
        kw.update(mom2_cov=a.T @ a / 128, preserve_scale=0.5, mom2_lamb2=2.0)
    elif case == "layers_no_k":
        kw.update(with_to_k=False, layers_to_edit=[0, 2])
    names = cross_attn_kv_layer_names(pc.unet)
    assert names == jnames(comps.unet.config)
    jout = jedit(comps, ["cat", "w1"], ["dog", ""], **kw)
    tout = edit_model_uce(pc, ["cat", "w1"], ["dog", ""], **kw)
    changed = []
    for n in names:
        w_t = tout.unet.get_submodule(n).weight.detach()
        w_j = np.asarray(get_unet_weight(jout.unet_params, n))
        assert rel_diff(w_j, w_t, "fro") <= 1e-4, n
        if not torch.equal(w_t, pc.unet.get_submodule(n).weight):
            changed.append(n)
    v_names = [n for n in names if n.endswith(".to_v")]
    assert changed == ([v_names[0], v_names[2]] if case == "layers_no_k"
                       else names)
    # every other parameter is shared with the unedited UNet
    before = dict(pc.unet.named_parameters())
    assert all(p is before[k] for k, p in tout.unet.named_parameters()
               if k[:-len(".weight")] not in changed)


def test_edit_text_encoder_uce_matches_jax(pair):
    import emcid_tpu.hparams as jhp
    from emcid_tpu.engine.uce import edit_text_encoder_uce as jedit

    import emcid_torch.hparams as thp
    from emcid_torch.engine.uce import edit_text_encoder_uce

    comps, pc = pair
    jout = jedit(comps, ["cat"], ["dog"], _hparams(jhp),
                 retain_texts=["w2"])
    tout = edit_text_encoder_uce(pc, ["cat"], ["dog"], _hparams(thp),
                                 retain_texts=["w2"])
    for i in (1, 2):
        w_j = np.asarray(jout.text_params[f"layers_{i}"]["mlp"]["fc2"]
                         ["kernel"]).T
        w_t = tout.text_encoder.get_submodule(
            f"text_model.encoder.layers.{i}.mlp.fc2").weight
        assert rel_diff(w_j, w_t, "fro") <= 1e-4, i


# ---------------------------------------------------------------------------
# training images given or read from files
# ---------------------------------------------------------------------------


def test_training_images_from_files_match_jax(pair, tmp_path, monkeypatch):
    """``images``, ``training_img_paths`` and missing paths (which fall back
    to generation) give the JAX package's posteriors and images."""
    from PIL import Image

    import emcid_tpu.models.pipeline as jpipe
    from emcid_tpu.engine.training_images import (
        training_latents_for_requests as jtrain,
    )

    import emcid_torch.models.pipeline as tpipe
    from emcid_torch.engine.training_images import (
        training_latents_for_requests,
    )

    comps, pc = pair
    rng = np.random.RandomState(12)
    arrays = [rng.randint(0, 256, (16, 16, 3)).astype(np.uint8)
              for _ in range(3)]
    paths = []
    for i, a in enumerate(arrays[:2]):
        paths.append(str(tmp_path / f"{i}.png"))
        Image.fromarray(a).save(paths[-1])
    reqs = [
        dict(REQUESTS[0], images=[arrays[2]]),
        dict(REQUESTS[1], training_img_paths=paths),
        dict(REQUESTS[0], source="w2", seed_train=3,
             training_img_paths=[str(tmp_path / "missing.png")]),
    ]
    monkeypatch.setattr(jpipe, "initial_latents",
                        _seeded_latents(jnp.asarray))
    monkeypatch.setattr(tpipe, "initial_latents",
                        _seeded_latents(torch.from_numpy))
    hp = type("HP", (), {"samples_per_prompt": 2})()
    kw = dict(height=16, width=16, num_inference_steps=2, sampler="dpm++",
              return_images=True)
    jm, jl, jimgs = jtrain(comps, reqs, hp, **kw)
    tm, tl, timgs = training_latents_for_requests(pc, reqs, hp, **kw)
    assert tuple(tm.shape) == (3, 2, 2, 8, 8, 4)
    assert rel_diff(jimgs, timgs) <= 2e-3
    assert rel_diff(jm, tm) <= 2e-3
    assert rel_diff(jl, tl) <= 2e-3


# ---------------------------------------------------------------------------
# the product path: apply_emcid with EWC and the UCE hybrid
# ---------------------------------------------------------------------------


def test_apply_emcid_ewc_uce_changes_exact_params(pair, tmp_path, monkeypatch):
    import emcid_torch.hparams as thp
    from emcid_torch.engine.editor import apply_emcid
    from emcid_torch.engine.fim import fim_candidates, load_fim
    from emcid_torch.engine.uce import cross_attn_kv_layer_names

    _, pc = pair
    monkeypatch.setenv("EMCID_TPU_FIM_PAIRS", "2")
    hp = _hparams(thp, v_num_grad_steps=2, use_ewc=True, ewc_lambda=1e7,
                  add_uce_edit=True)
    timings = {}
    edited, deltas = apply_emcid(pc, REQUESTS, hp, stats_dir=tmp_path / "s",
                                 fim_dir=tmp_path / "fim",
                                 num_inference_steps=2, timings=timings,
                                 verbose=False)
    assert {"fim", "uce"} <= set(timings)
    fim = load_fim(fim_candidates(hp, tmp_path / "fim")[2])
    assert fim.shape == (32,) and np.isfinite(fim).all()
    assert all(np.isfinite(a).all() and np.isfinite(r).all()
               for a, r in deltas.values())
    changed = set()
    for part in ("text_encoder", "unet"):
        before = dict(getattr(pc, part).named_parameters())
        changed |= {f"{part}.{k}" for k, v in
                    getattr(edited, part).named_parameters()
                    if not torch.equal(v, before[k])}
    assert changed == (
        {f"text_encoder.text_model.encoder.layers.{i}.mlp.fc2.weight"
         for i in hp.layers}
        | {f"unet.{n}.weight" for n in cross_attn_kv_layer_names(pc.unet)})


def test_variant_hparams_pass_check_supported():
    import emcid_torch.hparams as thp
    from emcid_torch.engine.compute_z import check_supported

    for over in ({"use_ewc": True}, {"use_sampled_noise": True},
                 {"no_noise_loss": True}, {"align_object_token": True},
                 {"sld_supervision": True}, {"add_uce_edit": True},
                 {"objective": "esd", "esd_mu": 1.0},
                 {"txt_img_align_scale_factor": 0.1}):
        check_supported(_hparams(thp, **over))
    from emcid_torch.parallel import get_mesh

    check_supported(_hparams(thp), mesh=get_mesh(["cpu"] * 2))
    with pytest.raises(ValueError, match="metric"):
        check_supported(_hparams(thp, txt_img_align_scale_factor=0.1,
                                 txt_img_align_loss_metric="kl"))
    hp = dataclasses.replace(_hparams(thp), objective="contrastive")
    with pytest.raises(ValueError, match="objective"):
        check_supported(hp)

"""PyTorch port, SDXL (the dual text-encoder edit) against the JAX package on
the tiny SDXL pipeline, with the JAX package's weights carried over by
``from_jax_sdxl``: the text_time UNet, the v-prediction and DDPM scheduler
steps, prompt encoding, sampling, the joint Stage 1 (with JAX's own draws
replayed), Stage 2, the two-file z cache both ways, training images from
given images, the checkpoint loader, the full-width parameter counts, and
the port's CLI on the CPU.

Tolerances: f32 on both sides, differing in summation order only: 1e-5 of
the largest reference value for forwards and sampling, 1e-4 for
gradients and for the Stage-1 targets after 3 Adam steps, 1e-6 for the
scheduler's elementwise steps; Stage 2 and the posterior as in
``test_torch_slice.py``.
"""

import dataclasses
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from emcid_tpu.models import sdxl as jsdxl

from emcid_torch.models import sdxl as tsdxl
from torch_parity import one_torch_thread, port_sdxl_components, rel_diff  # noqa: F401

WORDS = ["cat", "dog"]
REQUESTS = [
    {"prompts": ["a photo of a {}", "an image of a {}", "{}"],
     "source": "cat", "dest": "dog", "seed_train": 0},
    # txt_align off and the true noise as the target: both per-request
    # gates of the Stage-1 loss
    {"prompts": ["a photo of a {}", "an image of a {}", "{}"],
     "source": "dog", "dest": "cat", "seed_train": 1, "txt_align": False,
     "use_real_noise": True},
]


def _hp(pkg_hparams, **over):
    d = {
        "layers": [0, 1], "layers_2": [1, 2], "clamp_norm_factor": 1.2,
        "layer_selection": "all", "fact_token": "subject_last",
        "mom2_update_weight": 100, "mom2_update_weight_2": 200,
        "rewrite_module_tmp": "text_model.encoder.layers.{}.mlp.fc2",
        "layer_module_tmp": "text_model.encoder.layers.{}",
        "mlp_module_tmp": "text_model.encoder.layers.{}.mlp",
        "attn_module_tmp": "text_model.encoder.layers.{}.self_attn",
        "ln_f_module": "text_model.final_layer_norm",
        "mom2_dataset": "ccs_filtered", "mom2_n_samples": 30,
        "mom2_dtype": "float32", "v_num_grad_steps": 3, "v_lr": 0.1,
        "v_weight_decay": 8e-3, "mom2_adjustment": True,
        "objective": "ablate-dest", "esd_mu": "None",
        "cal_text_repr_loss": True, "text_repr_loss_scale_factor": 0.5,
    }
    d.update(over)
    return pkg_hparams.EMCIDXLHyperParams.from_dict(d)


@pytest.fixture(scope="module")
def pair():
    comps = jsdxl.build_tiny_sdxl_pipeline(seed=0, words=WORDS)
    return comps, port_sdxl_components(comps)


def _posterior(C, Simg=1, seed=0, logvar=-6.0):
    rng = np.random.RandomState(seed)
    mean = rng.randn(C, Simg, 3, 8, 8, 4).astype(np.float32) * 0.13
    return mean, np.full(mean.shape, logvar, np.float32)


def test_unet_text_time_matches_jax(pair):
    """eps of the text_time UNet, and the gradient of a weighted sum of eps
    into the context and the pooled ``text_embeds``."""
    comps, pc = pair
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    t = np.array([500, 20], np.int32)
    ctx = rng.randn(2, 16, 32).astype(np.float32)
    pool = rng.randn(2, 16).astype(np.float32)
    tids = np.asarray(jsdxl.sdxl_time_ids(2, 16, 16))
    w = rng.randn(2, 8, 8, 4).astype(np.float32)

    def jloss(ctx, pool):
        eps = comps.unet.apply({"params": comps.unet_params}, x, t, ctx,
                               {"text_embeds": pool, "time_ids": tids}).sample
        return jnp.sum(eps * w), eps

    (_, jeps), (jg_ctx, jg_pool) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(ctx),
                                              jnp.asarray(pool))
    tctx = torch.from_numpy(ctx).requires_grad_()
    tpool = torch.from_numpy(pool).requires_grad_()
    teps = pc.unet(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(t), tctx,
                   {"text_embeds": tpool,
                    "time_ids": torch.from_numpy(tids.copy())}).sample
    (teps.permute(0, 2, 3, 1) * torch.from_numpy(w)).sum().backward()
    assert rel_diff(jeps, teps.permute(0, 2, 3, 1)) <= 1e-5
    assert rel_diff(jg_ctx, tctx.grad) <= 1e-4
    assert rel_diff(jg_pool, tpool.grad) <= 1e-4


def test_scheduler_steps_match_jax():
    """velocity_target, ddpm_step (t > 0 and t = 0), and ddim_step and the
    DPM++ step under v_prediction (two DPM++ steps: first and second
    order)."""
    from emcid_tpu.models import scheduler as js
    from emcid_torch.models import scheduler as ts

    rng = np.random.RandomState(2)
    x0, noise, lat, out, lat2, out2, z = (
        rng.randn(3, 4, 4, 4).astype(np.float32) for _ in range(7))
    tt = np.array([10, 500, 999], np.int32)
    jv, tv = js.Schedule.scaled_linear(prediction_type="v_prediction"), \
        ts.Schedule.scaled_linear(prediction_type="v_prediction")
    jeps, teps = js.sd_schedule(), ts.sd_schedule()
    T = torch.from_numpy
    assert rel_diff(js.velocity_target(jeps, x0, noise, tt),
                    ts.velocity_target(teps, T(x0), T(noise), T(tt))) <= 1e-6
    for t in (500, 0):
        assert rel_diff(js.ddpm_step(jeps, lat, out, t, z),
                        ts.ddpm_step(teps, T(lat), T(out), t, T(z))) <= 1e-6
    for t, tp in ((501, 401), (1, -1)):
        assert rel_diff(js.ddim_step(jv, lat, out, t, tp),
                        ts.ddim_step(tv, T(lat), T(out), t, tp)) <= 1e-6
    jst = js.dpmpp_init(lat.shape)
    tst = ts.dpmpp_init()
    for (t, tp), (x, o) in zip(((801, 601), (601, 401)),
                               ((lat, out), (lat2, out2))):
        jst, jx = js.dpmpp_step(jv, jst, x, o, t, tp)
        tst, tx = ts.dpmpp_step(tv, tst, T(x), T(o), t, tp)
        assert rel_diff(jx, tx) <= 1e-6


def test_encode_prompts_sdxl_matches_jax(pair):
    comps, pc = pair
    prompts = ["a photo of a cat", "dog", ""]
    jctx, jpool = jsdxl.encode_prompts_sdxl(comps, prompts)
    tctx, tpool = tsdxl.encode_prompts_sdxl(pc, prompts)
    assert tctx.shape == (3, 16, 32) and tpool.shape == (3, 16)
    assert rel_diff(jctx, tctx) <= 1e-5
    assert rel_diff(jpool, tpool) <= 1e-5


@pytest.mark.parametrize("sampler", ["ddim", "pndm", "dpm++"])
@pytest.mark.parametrize("cfg_interval", [1.0, 0.5])
def test_sample_latents_sdxl_matches_jax(pair, monkeypatch, sampler,
                                         cfg_interval):
    """CFG sampling from the same initial latents (both packages'
    ``initial_latents`` patched to them)."""
    import emcid_tpu.models.pipeline as jpipe
    import emcid_torch.models.pipeline as tpipe

    comps, pc = pair
    lat0 = np.random.RandomState(3).randn(2, 8, 8, 4).astype(np.float32)
    monkeypatch.setattr(jpipe, "initial_latents",
                        lambda *a, **k: jnp.asarray(lat0))
    monkeypatch.setattr(tpipe, "initial_latents",
                        lambda *a, **k: torch.from_numpy(lat0))
    kw = dict(num_inference_steps=4, height=16, width=16, sampler=sampler,
              cfg_interval=cfg_interval)
    prompts, seeds = ["a photo of a cat", "dog"], [0, 1]
    jlat = jsdxl.sample_latents_sdxl(comps, prompts, seeds, **kw)
    tlat = tsdxl.sample_latents_sdxl(pc, prompts, seeds, **kw)
    assert rel_diff(jlat, tlat) <= 1e-5


def _jax_draws(key, steps, C, P, Simg, hw, n_train):
    """The draws of the JAX package's joint Stage 1 with ``rng=key`` and
    one step chunk (``steps`` <= EMCID_TPU_Z_CHUNK): the chunk split, then
    per step ``split`` and ``split(sub, C)``, then per concept
    ``split(key, 4)`` into image index, posterior draw, noise and
    timesteps (``emcid_tpu/engine/sdxl.py``)."""
    from emcid_torch.engine.sdxl import SDXLDraws

    _, key = jax.random.split(key)
    out = {k: [] for k in SDXLDraws._fields}
    for _ in range(steps):
        key, sub = jax.random.split(key)
        rows = {k: [] for k in SDXLDraws._fields}
        for kc in jax.random.split(sub, C):
            k_img, k_post, k_noise, k_t = jax.random.split(kc, 4)
            rows["img_idx"].append(jax.random.randint(k_img, (P,), 0, Simg))
            rows["post_eps"].append(
                jax.random.normal(k_post, (P,) + hw, jnp.float32))
            rows["noise"].append(
                jax.random.normal(k_noise, (P,) + hw, jnp.float32))
            rows["timesteps"].append(
                jax.random.randint(k_t, (P,), 0, n_train))
        for k, v in rows.items():
            out[k].append(np.stack([np.asarray(a) for a in v]))
    return SDXLDraws(*(np.stack(out[k]) for k in SDXLDraws._fields))


@pytest.mark.parametrize("mode", ["no_noise_loss", "replayed_draws"])
def test_stage1_matches_jax(pair, monkeypatch, mode):
    """The joint two-delta Stage 1 over 3 steps on a block that mixes
    txt_align and use_real_noise requests: (a) no_noise_loss with the
    text-repr term, where no draw enters; (b) the full ablate-dest loss,
    with the JAX package's own draws (recomputed from its key schedule)
    replayed through the port's seam, two training images per prompt."""
    import emcid_tpu.hparams as jhp
    import emcid_torch.hparams as thp
    from emcid_tpu.engine.sdxl import compute_z_sdxl_text_encoders as jz
    from emcid_torch.engine.sdxl import compute_z_sdxl_text_encoders as tz

    comps, pc = pair
    monkeypatch.delenv("EMCID_TPU_Z_CHUNK", raising=False)
    over = {"no_noise_loss": True} if mode == "no_noise_loss" else {}
    mean, logvar = _posterior(2, Simg=2, logvar=-4.0)
    key = jax.random.PRNGKey(5)
    jz1, jz2 = jz(comps, REQUESTS, _hp(jhp, **over), mean, logvar, rng=key,
                  height=16, width=16, verbose=False)
    replay = None
    if mode == "replayed_draws":
        replay = _jax_draws(key, 3, 2, 3, 2, (8, 8, 4), 1000)
    tz1, tz2 = tz(pc, REQUESTS, _hp(thp, **over), mean, logvar,
                  height=16, width=16, replay=replay, verbose=False)
    assert tz1.shape == (2, 1, 16) and tz2.shape == (2, 1, 16)
    assert rel_diff(jz1, tz1) <= 1e-4
    assert rel_diff(jz2, tz2) <= 1e-4


def _covs(n, width, seed):
    r = np.random.RandomState(seed)
    return [(lambda a: a.T @ a / a.shape[0])(
        r.randn(4 * width, width).astype(np.float32)) for _ in range(n)]


def test_stage2_matches_jax(pair):
    """Both encoders' inserts from the same zs and seeded covariances, on
    the default f32_ir solve of both packages (the JAX SDXL insert takes
    no other): deltas and edited fc2 weights at ``test_torch_slice.py``'s
    f32_ir tolerance, and only the edit layers' fc2 of each encoder
    changed, the UNet and VAE shared."""
    import emcid_tpu.hparams as jhp
    import emcid_torch.hparams as thp
    from emcid_tpu.engine.sdxl import execute_emcid_sd_xl_text_encoders as jx
    from emcid_tpu.models.naming import get_weight
    from emcid_torch.engine.sdxl import execute_emcid_sd_xl_text_encoders as tx

    comps, pc = pair
    rng = np.random.RandomState(4)
    zs1 = rng.randn(2, 1, 16).astype(np.float32) * 0.3
    zs2 = rng.randn(2, 1, 16).astype(np.float32) * 0.3
    c1, c2 = _covs(2, 32, 5), _covs(2, 32, 6)
    jh, th = _hp(jhp), _hp(thp)
    jd1, jd2, jed = jx(comps, REQUESTS, jh, zs1, zs2, c1, c2,
                       mom2_weight_2=300, verbose=False)
    td1, td2, ted = tx(pc, REQUESTS, th, zs1, zs2, c1, c2,
                       mom2_weight_2=300, verbose=False)
    for jd, td in ((jd1, td1), (jd2, td2)):
        assert set(jd) == set(td)
        for name, (adj, resid) in jd.items():
            assert rel_diff(adj, td[name][0], "fro") <= 1e-4
            assert rel_diff(resid, td[name][1], "fro") <= 1e-4
    for which, layers in ((1, jh.layers), (2, jh.layers_2)):
        jparams = jed.text_params if which == 1 else jed.text_params_2
        before = dict(pc.encoder(which).named_parameters())
        changed = {k for k, v in ted.encoder(which).named_parameters()
                   if not torch.equal(v, before[k])}
        assert changed == {f"text_model.encoder.layers.{i}.mlp.fc2.weight"
                           for i in layers}
        for i in layers:
            name = f"text_model.encoder.layers.{i}.mlp.fc2"
            assert rel_diff(get_weight(jparams, name),
                            ted.encoder(which).get_submodule(name).weight,
                            "fro") <= 1e-4
    assert ted.unet is pc.unet and ted.vae is pc.vae


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_vstar_cache_crosses_packages(pair, tmp_path, monkeypatch, writer):
    """The two-file z cache written by one package is read by the other;
    with every z cached, the reader runs no Stage-1 step and gives the
    writer's deltas."""
    import emcid_tpu.engine.sdxl as jeng
    import emcid_tpu.hparams as jhp
    import emcid_torch.engine.sdxl as teng
    import emcid_torch.hparams as thp

    comps, pc = pair
    # the hparams and block shape of test_stage1_matches_jax: the JAX
    # package reuses its compiled Stage-1 program
    jh, th = _hp(jhp), _hp(thp)
    mean, logvar = _posterior(2, Simg=2, logvar=-4.0)
    c1, c2 = _covs(2, 32, 7), _covs(2, 32, 8)
    cache = str(tmp_path / "zc") + "/"
    kw = dict(cache_name=cache, height=16, width=16, verbose=False)

    def refuse(*a, **k):
        raise AssertionError("Stage 1 ran with every z cached")

    if writer == "jax":
        wd1, _, _ = jeng.apply_emcid_to_sdxl_text_encoders(
            comps, REQUESTS, jh, mean, logvar, c1, c2, **kw)
        monkeypatch.setattr(teng, "compute_z_sdxl_text_encoders", refuse)
        rd1, _, _ = teng.apply_emcid_to_sdxl_text_encoders(
            pc, REQUESTS, th, None, None, c1, c2, **kw)
    else:
        wd1, _, _ = teng.apply_emcid_to_sdxl_text_encoders(
            pc, REQUESTS, th, mean, logvar, c1, c2, **kw)
        monkeypatch.setattr(jeng, "compute_z_sdxl_text_encoders", refuse)
        rd1, _, _ = jeng.apply_emcid_to_sdxl_text_encoders(
            comps, REQUESTS, jh, mean, logvar, c1, c2, **kw)
    files = sorted(p.name for p in (tmp_path / "zc").iterdir())
    assert files == ["source_cat_dest_dog.npz", "source_cat_dest_dog_2.npz",
                     "source_dog_dest_cat.npz", "source_dog_dest_cat_2.npz"]
    for f in (tmp_path / "zc").iterdir():
        assert set(np.load(f).files) == {"v_star"}
    for name, (adj, resid) in wd1.items():
        assert rel_diff(adj, rd1[name][0], "fro") <= 1e-4
        assert rel_diff(resid, rd1[name][1], "fro") <= 1e-4


def test_training_latents_from_images(pair):
    """``sdxl_training_latents`` with given images (uint8 arrays, tiled to
    samples_per_prompt x prompts): the scaled posterior against JAX's."""
    import emcid_tpu.hparams as jhp
    import emcid_torch.hparams as thp
    from emcid_tpu.engine.sdxl import sdxl_training_latents as jtl
    from emcid_torch.engine.sdxl import sdxl_training_latents as ttl

    comps, pc = pair
    rng = np.random.RandomState(9)
    reqs = [dict(r, images=[rng.randint(0, 256, (16, 16, 3), np.uint8)
                            for _ in range(2)]) for r in REQUESTS]
    jh, th = (_hp(m, samples_per_prompt=2) for m in (jhp, thp))
    jm, jlv = jtl(comps, reqs, jh, height=16, width=16)
    tm, tlv = ttl(pc, reqs, th, height=16, width=16)
    assert tuple(tm.shape) == (2, 2, 3, 8, 8, 4)
    assert rel_diff(jm, tm) <= 2e-3
    assert rel_diff(jlv, tlv) <= 2e-3


def _write_sdxl_folder(comps, ckpt):
    """The JAX tiny SDXL pipeline as an HF-format folder: the JAX
    ``convert_hf`` exports saved with ``torch.save``, diffusers-schema
    ``config.json`` files and the tokenizer's vocab and merges."""
    from emcid_tpu.models.convert_hf import (
        clip_text_to_torch, unet_to_torch, vae_to_torch,
    )

    tok = comps.tokenizer
    (ckpt / "tokenizer").mkdir(parents=True)
    (ckpt / "tokenizer" / "vocab.json").write_text(json.dumps(tok.encoder))
    merges = [""] * len(tok.bpe_ranks)
    for pair_, i in tok.bpe_ranks.items():
        merges[i] = f"{pair_[0]} {pair_[1]}"
    (ckpt / "tokenizer" / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(merges))

    def text_cfg(cfg, proj):
        out = {k: getattr(cfg, k) for k in (
            "vocab_size", "hidden_size", "intermediate_size",
            "num_hidden_layers", "num_attention_heads",
            "max_position_embeddings", "hidden_act", "eos_token_id")}
        out["architectures"] = ["CLIPTextModelWithProjection" if proj
                                else "CLIPTextModel"]
        if proj:
            out["projection_dim"] = cfg.projection_dim
        return out

    for sub, state, cfg in (
            ("text_encoder", clip_text_to_torch(comps.text_params),
             text_cfg(comps.text_encoder.config, False)),
            ("text_encoder_2", clip_text_to_torch(comps.text_params_2),
             text_cfg(comps.text_encoder_2.config, True)),
            ("unet", unet_to_torch(comps.unet_params),
             dataclasses.asdict(comps.unet.config)),
            ("vae", vae_to_torch(comps.vae_params),
             dict(dataclasses.asdict(comps.vae.config),
                  scaling_factor=comps.scaling_factor))):
        (ckpt / sub).mkdir(parents=True)
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in state.items()},
                   ckpt / sub / "diffusion_pytorch_model.bin")
        (ckpt / sub / "config.json").write_text(json.dumps(cfg))


def test_load_sdxl_pipeline_matches_jax(pair, tmp_path):
    """An HF-format folder written from the JAX tiny pipeline, loaded by
    the port (f32): the JAX pipeline's architecture, scaling, context
    length, prompt encoding and UNet output.  (The JAX loader gives back
    the pipeline it was written from: ``tests/test_sdxl_load.py``, slow.)"""
    comps, _ = pair
    _write_sdxl_folder(comps, tmp_path / "sdxl")
    tl = tsdxl.load_sdxl_pipeline(tmp_path / "sdxl", dtype=torch.float32,
                                  device="cpu")
    assert dataclasses.asdict(tl.unet.config) == dataclasses.asdict(
        comps.unet.config)
    for which in (1, 2):
        jcfg = (comps.text_encoder if which == 1
                else comps.text_encoder_2).config
        assert dataclasses.asdict(tl.encoder(which).config) == \
            dataclasses.asdict(jcfg)
    assert (tl.scaling_factor, tl.vae_scale) == (comps.scaling_factor,
                                                 comps.vae_scale)
    assert tl.tokenizer.model_max_length == comps.tokenizer.model_max_length
    prompts = ["a photo of a cat", "dog"]
    jctx, jpool = jsdxl.encode_prompts_sdxl(comps, prompts)
    tctx, tpool = tsdxl.encode_prompts_sdxl(tl, prompts)
    assert rel_diff(jctx, tctx) <= 1e-5 and rel_diff(jpool, tpool) <= 1e-5
    x = np.random.RandomState(10).randn(2, 8, 8, 4).astype(np.float32)
    t = np.array([300, 700], np.int32)
    tids = np.asarray(jsdxl.sdxl_time_ids(2, 16, 16))
    jeps = jax.jit(lambda p, c, a: comps.unet.apply(
        {"params": p}, x, t, c, a).sample)(
            comps.unet_params, jctx, {"text_embeds": jpool, "time_ids": tids})
    with torch.no_grad():
        teps = tl.unet(torch.from_numpy(x).permute(0, 3, 1, 2),
                       torch.from_numpy(t), tctx,
                       {"text_embeds": tpool,
                        "time_ids": torch.from_numpy(tids.copy())}).sample
    assert rel_diff(jeps, teps.permute(0, 2, 3, 1)) <= 1e-5


@pytest.mark.parametrize("which", ["text_encoder", "text_encoder_2", "unet",
                                   "vae"])
def test_full_width_parameter_counts(which):
    """Each full-width SDXL model built on ``meta`` holds as many
    parameters as the JAX package's init on the same config
    (``jax.eval_shape``: nothing is computed)."""
    from emcid_tpu.models import configs as jc
    from emcid_tpu.models.clip_text import CLIPTextEncoder as JText
    from emcid_tpu.models.unet import UNet2DCondition as JUNet
    from emcid_tpu.models.vae import AutoencoderKL as JVAE
    from emcid_torch.models import configs as tc
    from emcid_torch.models.clip_text import CLIPTextEncoder
    from emcid_torch.models.unet import UNet2DCondition
    from emcid_torch.models.vae import AutoencoderKL

    key = jax.random.PRNGKey(0)
    if which.startswith("text"):
        cfgs = (jc.SDXL_TEXT_1, tc.SDXL_TEXT_1) if which == "text_encoder" \
            else (jc.SDXL_TEXT_2, tc.SDXL_TEXT_2)
        jm, tcls = JText(cfgs[0]), CLIPTextEncoder
        shapes = jax.eval_shape(jm.init, key, jnp.zeros((1, 77), jnp.int32))
    elif which == "unet":
        cfgs = (jc.sdxl_unet(), tc.sdxl_unet())
        jm, tcls = JUNet(cfgs[0]), UNet2DCondition
        shapes = jax.eval_shape(
            jm.init, key, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
            jnp.zeros((1, 77, 2048)),
            {"text_embeds": jnp.zeros((1, 1280)),
             "time_ids": jnp.zeros((1, 6))})
    else:
        cfgs = (jc.sdxl_vae(), tc.sdxl_vae())
        jm, tcls = JVAE(cfgs[0]), AutoencoderKL
        shapes = jax.eval_shape(jm.init, key, jnp.zeros((1, 16, 16, 3)))
    n_jax = sum(int(np.prod(s.shape))
                for s in jax.tree.leaves(shapes["params"]))
    with torch.device("meta"):
        n_torch = sum(p.numel() for p in tcls(cfgs[1]).parameters())
    assert n_torch == n_jax
    expect = {"text_encoder": 123_060_480, "text_encoder_2": 694_659_840,
              "unet": 2_567_463_684, "vae": 83_653_863}
    assert n_torch == expect[which]


@pytest.mark.parametrize("model", ["sd_v14", "sdxl", "tiny_sdxl"])
def test_flop_counts_match_jax(model):
    """The port's ``unet_fwd_flops`` and ``stage1_step_flops`` count what
    the JAX package's do (its Stage-1 count with its defaults: no remat,
    a fresh eps_dest forward each step)."""
    from emcid_tpu import profiling as jprof
    from emcid_tpu.models import configs as jc
    from emcid_torch import profiling as tprof
    from emcid_torch.models import configs as tc

    if model == "tiny_sdxl":  # the JAX package builds it inline
        from emcid_torch.text.tokenizer import make_tiny_tokenizer

        tcfg = jcfg = tsdxl.tiny_sdxl_configs(
            make_tiny_tokenizer(WORDS, model_max_length=16))[2]
    else:
        make = "sd_v14_unet" if model == "sd_v14" else "sdxl_unet"
        jcfg, tcfg = getattr(jc, make)(), getattr(tc, make)()
    for hw in (None, 16):
        assert tprof.unet_fwd_flops(tcfg, 3, hw) == \
            jprof.unet_fwd_flops(jcfg, 3, hw)
        assert tprof.stage1_step_flops(tcfg, 2, 3, hw) == \
            jprof.stage1_step_flops(jcfg, 2, 3, hw)
    if model == "sdxl":  # one forward at 1024 px: 6.76 TFLOP per image
        assert tprof.unet_fwd_flops(tcfg, 1, 128) / 1e12 == \
            pytest.approx(6.76, abs=5e-3)


def test_cli_sdxl_tiny(tmp_path):
    """The CLI's SDXL leg on the CPU (``--tiny --platform cpu`` with an
    sdxl-1.0 instruction, the edit layers remapped into the tiny encoders):
    pre- and post-edit images written, only the fc2 weights of each
    encoder's edit layers changed, the UNet and VAE shared unchanged, the
    two-file z cache written and read back by a second call."""
    from PIL import Image

    import emcid_torch.hparams as thp
    from emcid_torch.cli import run_emcid

    hp = _hp(thp, layers=[7, 8, 9, 10], layers_2=[27, 28, 29, 30])
    hp_dir = tmp_path / "hparams"
    hp_dir.mkdir()
    (hp_dir / "sdxl-tiny.json").write_text(json.dumps(hp.to_dict()))
    out = tmp_path / "out"
    path = tmp_path / "run.json"
    path.write_text(json.dumps({
        "requests": REQUESTS, "hparams": "sdxl-tiny", "model_ckpt": "sdxl-1.0",
        "mom2_weight": 100, "mom2_weight_2": 200,
        "val_prompts": ["a photo of a cat"], "out_dir": str(out),
        "sample_num": 1}))
    argv = ["--instruction_path", str(path), "--tiny", "--platform", "cpu",
            "--hparams_dir", str(hp_dir), "--stats_dir", str(tmp_path / "s"),
            "--cache_dir", str(tmp_path / "z"), "--steps", "2", "--seed", "0"]
    timings = {}
    edited, (d1, d2) = run_emcid.main(argv, timings=timings)
    before = tsdxl.build_tiny_sdxl_pipeline(
        seed=0, words=[w for r in REQUESTS for w in (r["source"], r["dest"])],
        device="cpu")
    for which, layers in ((1, [0, 1]), (2, [1, 2])):
        ref = dict(before.encoder(which).named_parameters())
        changed = {k for k, v in edited.encoder(which).named_parameters()
                   if not torch.equal(v, ref[k])}
        assert changed == {f"text_model.encoder.layers.{i}.mlp.fc2.weight"
                           for i in layers}
    for part in ("unet", "vae"):
        ref = dict(getattr(before, part).named_parameters())
        assert all(torch.equal(v, ref[k]) for k, v in
                   getattr(edited, part).named_parameters())
    for phase in ("pre_edit", "post_edit"):
        img = np.asarray(Image.open(out / phase / "prompt0_seed0.png"))
        assert img.shape == (16, 16, 3) and img.dtype == np.uint8
    assert {"covariances", "generation", "stage1", "stage2",
            "pre_edit_generation", "post_edit_generation"} <= set(timings)
    assert len(list((tmp_path / "z" / "sdxl-tiny").glob("*_2.npz"))) == 2
    assert (tmp_path / "s" / "sdxl" / "text1").is_dir()
    assert (tmp_path / "s" / "sdxl" / "text2").is_dir()
    timings2 = {}
    again, (e1, _) = run_emcid.main(argv, timings=timings2)
    assert "generation" not in timings2
    for k, (a, r) in d1.items():
        assert np.array_equal(a, e1[k][0]) and np.array_equal(r, e1[k][1])


def test_encoder2_ids_pad_after_first_eos():
    from emcid_torch.engine.sdxl import encoder2_ids

    ids = np.array([[[5, 7, 9, 9, 9], [5, 9, 9, 9, 9]]], np.int32)
    assert encoder2_ids(ids, 9).tolist() == [[[5, 7, 9, 0, 0],
                                              [5, 9, 0, 0, 0]]]


@pytest.mark.parametrize("what", ["replace_repr", "mesh"])
def test_refusals(pair, what):
    """``replace_repr`` raises, as in the JAX package; ``mesh=`` raises
    naming ROADMAP M14."""
    import emcid_torch.hparams as thp
    from emcid_torch.engine.sdxl import (
        apply_emcid_to_sdxl_text_encoders,
        compute_z_sdxl_text_encoders,
    )

    _, pc = pair
    mean, logvar = _posterior(2)
    if what == "replace_repr":
        with pytest.raises(NotImplementedError, match="replace_repr"):
            compute_z_sdxl_text_encoders(
                pc, REQUESTS, _hp(thp, replace_repr=True), mean, logvar,
                height=16, width=16, verbose=False)
    else:
        for fn in (compute_z_sdxl_text_encoders,
                   lambda *a, **k: apply_emcid_to_sdxl_text_encoders(
                       *a, [], [], **k)):
            with pytest.raises(NotImplementedError, match="M14"):
                fn(pc, REQUESTS, _hp(thp), mean, logvar, mesh=object(),
                   height=16, width=16, verbose=False)

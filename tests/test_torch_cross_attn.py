"""PyTorch port, the cross-attention K/V edit (``emcid_torch.engine.
cross_attn``) against the JAX package on the tiny pipeline: the keys, the
covariance and its cache both ways, Stage 1 (esd and SLD) with the JAX
package's draws replayed from its key schedule, Stage 2, and the z cache
read across packages.

Tolerances: f32 on both sides, differing in summation order only: 1e-5 of
the largest reference value for the keys and the covariance, 1e-4 for the
Stage-1 targets after 3 Adam steps and the Stage-2 weights and (adj_k,
sources).
"""

import numpy as np
import pytest

import jax

import emcid_tpu.engine.cross_attn as jca
from emcid_tpu.engine.uce import get_unet_weight
from emcid_tpu.models.loader import build_tiny_pipeline
from emcid_tpu.models.unet import cross_attn_kv_layer_names as jnames

import emcid_torch.engine.cross_attn as tca
from emcid_torch.engine.uce import cross_attn_kv_layer_names
from torch_parity import TINY_WORDS, one_torch_thread, port_components, rel_diff  # noqa: F401

REQS = [{"prompts": ["a photo of a {}", "an image of a {}"], "source": "cat",
         "dest": "dog", "seed_train": 0,
         "safe_words": "a safe photo of a dog"},
        {"prompts": ["a photo of a {}", "{}"], "source": "w1", "dest": "w2",
         "seed_train": 1}]


@pytest.fixture(scope="module")
def pair():
    comps = build_tiny_pipeline(seed=0, words=TINY_WORDS)
    return comps, port_components(comps)


def _hp(pkg, **over):
    d = {
        "layers": [3], "clamp_norm_factor": 1.5, "layer_selection": "all",
        "fact_token": "subject_last", "v_num_grad_steps": 3, "v_lr": 0.1,
        "v_weight_decay": 5e-4, "mom2_adjustment": True,
        "mom2_update_weight": 100,
        "rewrite_module_tmp": "text_model.encoder.layers.{}.mlp.fc2",
        "layer_module_tmp": "text_model.encoder.layers.{}",
        "mlp_module_tmp": "text_model.encoder.layers.{}.mlp",
        "attn_module_tmp": "text_model.encoder.layers.{}.self_attn",
        "ln_f_module": "text_model.final_layer_norm",
        "mom2_dataset": "ccs_filtered", "mom2_n_samples": 30,
        "mom2_dtype": "float32", "objective": "esd", "esd_mu": 1.0,
        "edit_weight": 0.6,
    }
    d.update(over)
    return pkg.EMCIDHyperParams.from_dict(d)


def _latents(seed=0, simg=2):
    rng = np.random.RandomState(seed)
    mean = (rng.randn(len(REQS), simg, 2, 8, 8, 4) * 0.18).astype(np.float32)
    return mean, np.full(mean.shape, -3.0, np.float32)


def _draws(key, steps, P, simg, shape):
    """``compute_z_unet_x_kv``'s key schedule in the JAX package."""
    out = [[], [], [], []]
    for k in jax.random.split(key, steps):
        k_img, k_post, k_noise, k_t = jax.random.split(k, 4)
        out[0].append(np.asarray(jax.random.randint(k_img, (P,), 0, simg)))
        out[1].append(np.asarray(jax.random.normal(k_post, (P,) + shape)))
        out[2].append(np.asarray(jax.random.normal(k_noise, (P,) + shape)))
        out[3].append(np.asarray(jax.random.randint(k_t, (P,), 0, 1000)))
    return tca.XKVDraws(*(np.stack(a) for a in out))


def _cov(seed=1):
    a = np.random.RandomState(seed).randn(100, 32).astype(np.float32)
    return a.T @ a / 100 * 0.01


def test_kv_names_match_jax(pair):
    comps, pc = pair
    assert cross_attn_kv_layer_names(pc.unet) == jnames(comps.unet.config)


def test_keys_match_jax(pair):
    comps, pc = pair
    jk, jb = jca.get_cross_attn_keys(comps, REQS, 2)
    tk, tb = tca.get_cross_attn_keys(pc, REQS, 2)
    assert np.array_equal(jb.lookup_indices, tb.lookup_indices)
    assert tk.shape == (2, 2, 32)
    assert rel_diff(np.asarray(jk), tk) <= 1e-5


def test_layer_stats_cross_attn_kv_matches_jax(pair, tmp_path):
    """Same captions: the moment and the real-token count (the padded rows
    add zeros), and each package's cache file read by the other."""
    from emcid_tpu.dsets.stat_dataset import make_synthetic_captions

    comps, pc = pair
    caps = make_synthetic_captions(23)
    name = jnames(comps.unet.config)[0]
    kw = dict(captions=caps, sample_size=23, batch_size=8)
    js = jca.layer_stats_cross_attn_kv(comps, name, stats_dir=tmp_path / "j",
                                       **kw)
    ts = tca.layer_stats_cross_attn_kv(pc, name, stats_dir=tmp_path / "t",
                                       **kw)
    enc = pc.tokenizer(caps, padding="max_length", truncation=True,
                       max_length=pc.tokenizer.model_max_length)
    assert ts.mom2.count == js.mom2.count == int(
        np.asarray(enc["attention_mask"]).sum())
    assert rel_diff(np.asarray(js.mom2.moment()), ts.mom2.moment()) <= 1e-5
    f = sorted((tmp_path / "t").rglob("*.npz"))
    assert [p.relative_to(tmp_path / "t") for p in f] == [
        p.relative_to(tmp_path / "j")
        for p in sorted((tmp_path / "j").rglob("*.npz"))] != []
    assert f[0].parts[-3] == "unet"
    kw.pop("captions")
    cross = tca.layer_stats_cross_attn_kv(pc, name, stats_dir=tmp_path / "j",
                                          **kw)
    back = jca.layer_stats_cross_attn_kv(comps, name,
                                         stats_dir=tmp_path / "t", **kw)
    assert rel_diff(np.asarray(js.mom2.moment()),
                    cross.mom2.moment()) <= 1e-7
    assert rel_diff(ts.mom2.moment(), np.asarray(back.mom2.moment())) <= 1e-7


@pytest.mark.parametrize("mode", ["esd", "sld_strong"])
def test_compute_z_unet_x_kv_matches_jax(pair, mode):
    """One delta per K/V projection, 3 steps, two training images per
    prompt, JAX's draws replayed: every projection's target."""
    import emcid_tpu.hparams as jhp

    import emcid_torch.hparams as thp

    comps, pc = pair
    over = ({} if mode == "esd"
            else dict(objective="ablate-dest", esd_mu="None",
                      sld_supervision=True, sld_type="strong"))
    mean, logvar = _latents()
    key = jax.random.PRNGKey(4)
    ref = jca.compute_z_unet_x_kv(comps, REQS[0], _hp(jhp, **over), mean[0],
                                  logvar[0], rng=key, verbose=False)
    got = tca.compute_z_unet_x_kv(
        pc, REQS[0], _hp(thp, **over), mean[0], logvar[0],
        replay=_draws(key, 3, 2, 2, (8, 8, 4)), verbose=False)
    assert set(got) == set(ref)
    for n in ref:
        assert got[n].shape == ref[n].shape == (1, ref[n].shape[-1])
        assert rel_diff(ref[n], got[n]) <= 1e-4, n
    # the deltas moved the targets off the unedited outputs
    z0 = {n: np.asarray(jca.get_cross_attn_keys(comps, REQS[:1])[0][0])
          @ np.asarray(get_unet_weight(comps.unet_params, n)).T
          for n in ref}
    assert any(np.abs(got[n] - z0[n]).max() > 1e-4 for n in ref)


def test_compute_z_unet_x_kv_rejects(pair):
    import emcid_torch.hparams as thp

    _, pc = pair
    mean, logvar = _latents()
    with pytest.raises(ValueError, match="supervision"):
        tca.compute_z_unet_x_kv(pc, REQS[0], _hp(thp, objective="ablate-dest"),
                                mean[0], logvar[0], verbose=False)
    with pytest.raises(ValueError, match="sld_type"):
        tca.compute_z_unet_x_kv(
            pc, REQS[0], _hp(thp, sld_supervision=True, sld_type="weak"),
            mean[0], logvar[0], verbose=False)
    # a mesh does not lift the supervision check
    from emcid_torch.parallel import get_mesh

    with pytest.raises(ValueError, match="supervision"):
        tca.compute_z_unet_x_kv(pc, REQS[0], _hp(thp, objective="ablate-dest"),
                                mean[0], logvar[0],
                                mesh=get_mesh(["cpu"] * 2), verbose=False)


@pytest.mark.parametrize("per_layer", [False, True])
def test_execute_emcid_cross_attn_matches_jax(pair, per_layer):
    """Both requests, num_edit_tokens 2, a shared covariance or one per
    projection (two distinct matrices): the edited weights and every
    projection's (adj_k, sources); the other UNet parameters are shared
    with the unedited UNet."""
    import emcid_tpu.hparams as jhp

    import emcid_torch.hparams as thp

    comps, pc = pair
    names = jnames(comps.unet.config)
    keys = np.asarray(jca.get_cross_attn_keys(comps, REQS, 2)[0])
    rng = np.random.RandomState(3)
    zs = {}
    for n in names:
        w = np.asarray(get_unet_weight(comps.unet_params, n), np.float32)
        zs[n] = (keys @ w.T + 0.3 * rng.randn(2, 2, w.shape[0])).astype(
            np.float32)
    cov = _cov()
    if per_layer:
        other = _cov(2)
        cov = {n: (cov if i % 2 else other) for i, n in enumerate(names)}
    jd, jed = jca.execute_emcid_cross_attn(
        comps, REQS, _hp(jhp, num_edit_tokens=2), zs, cov, verbose=False)
    td, ted = tca.execute_emcid_cross_attn(
        pc, REQS, _hp(thp, num_edit_tokens=2), zs, cov, verbose=False)
    assert set(td) == set(jd) == {f"{n}.weight" for n in names}
    for k in jd:
        assert rel_diff(jd[k][0], td[k][0]) <= 1e-4
        assert rel_diff(jd[k][1], td[k][1]) <= 1e-4
    before = dict(pc.unet.named_parameters())
    for k, v in ted.unet.named_parameters():
        if k[:-len(".weight")] in names:
            wj = np.asarray(get_unet_weight(jed.unet_params,
                                            k[:-len(".weight")]))
            assert rel_diff(wj, v) <= 1e-4
            assert rel_diff(wj - before[k].detach().numpy(),
                            v - before[k], "fro") <= 1e-4
        else:
            assert v is before[k]
    assert ted.text_encoder is pc.text_encoder and ted.vae is pc.vae


def test_z_cache_read_across_packages(pair, tmp_path):
    """``source_{s}.npz`` (one array per projection name): the JAX
    package's file read by the port with no latents given (so no Stage 1
    can run), and the port's file read by the JAX package; each pair of
    runs gives the same edit."""
    import emcid_tpu.hparams as jhp

    import emcid_torch.hparams as thp

    comps, pc = pair
    jh, th = _hp(jhp, v_num_grad_steps=2), _hp(thp, v_num_grad_steps=2)
    mean, logvar = _latents(simg=1)
    cov = _cov()
    jcache, tcache = f"{tmp_path}/j/", f"{tmp_path}/t/"
    jd, _ = jca.apply_emcid_to_cross_attn(
        comps, REQS, jh, latents_mean=mean, latents_logvar=logvar, cov=cov,
        cache_name=jcache, verbose=False)
    td, _ = tca.apply_emcid_to_cross_attn(pc, REQS, th, cov=cov,
                                          cache_name=jcache, verbose=False)
    for k in jd:
        assert rel_diff(jd[k][1], td[k][1]) <= 1e-4
    t2, _ = tca.apply_emcid_to_cross_attn(
        pc, REQS, th, latents_mean=mean, latents_logvar=logvar, cov=cov,
        cache_name=tcache, verbose=False)
    names = set(jnames(comps.unet.config))
    for r in REQS:
        assert set(np.load(f"{tcache}source_{r['source']}.npz")) == names
    j2, _ = jca.apply_emcid_to_cross_attn(comps, REQS, jh, cov=cov,
                                          cache_name=tcache, verbose=False)
    for k in t2:
        assert rel_diff(t2[k][1], j2[k][1]) <= 1e-4
    with pytest.raises(ValueError, match="latents required"):
        tca.apply_emcid_to_cross_attn(pc, REQS, th, cov=cov,
                                      cache_name=f"{tmp_path}/none/",
                                      verbose=False)


def test_apply_covariance_from_captions(pair, tmp_path):
    """Without ``cov``, the covariance is the caption statistic cached in
    ``stats_dir`` under the first projection's name."""
    import emcid_torch.hparams as thp

    from emcid_torch.models.pipeline import generate

    _, pc = pair
    mean, logvar = _latents(simg=1)
    caps = [f"caption {i} of a cat" for i in range(8)]
    d, edited = tca.apply_emcid_to_cross_attn(
        pc, REQS[:1], _hp(thp, v_num_grad_steps=1), latents_mean=mean[:1],
        latents_logvar=logvar[:1], captions=caps, stats_dir=tmp_path,
        verbose=False)
    files = list((tmp_path / "unet").rglob("*.npz"))
    assert len(files) == 1
    assert files[0].name.startswith(cross_attn_kv_layer_names(pc.unet)[0])
    kw = dict(num_inference_steps=2, height=16, width=16)
    assert not np.array_equal(generate(pc, ["a photo of a cat"], [1], **kw),
                              generate(edited, ["a photo of a cat"], [1],
                                       **kw))
    assert all(np.isfinite(a).all() and np.isfinite(s).all()
               for a, s in d.values())

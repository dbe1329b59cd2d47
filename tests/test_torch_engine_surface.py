"""PyTorch port, the JAX engine surface beside the main path, against the
JAX package on the tiny pipeline: the ``ops`` re-exports,
``Schedule.linear``, ``get_cov_text_encoder(inv=)``,
``compute_ks_text_encoder``, ``compute_z_text_encoder_batch`` (Stage-1
draws replayed into both), ``apply_emcid_to_text_encoder`` (z from the
cache, else ``compute_z_fn``, else raises; covariances from ``cov_fn``;
the originals untouched), ``resolve_covariances`` and the covariance
pre-cache CLI ``workflows layer_stats --tiny --platform cpu``.

Tolerances: relative to the largest reference value (``rel_diff``); 1e-5
through one f32 forward (the two differ in the order of their sums), the
f64 Stage-2 deltas at 1e-6 on seeded well-conditioned covariances (as in
``test_torch_slice``), Stage 1 by cosine >= 0.9999 and the loss curve at
1e-4, the inverse covariance at 1e-5 (the JAX package inverts in f32 at
a condition number below 10, the port in float64).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from emcid_tpu.models.loader import build_tiny_pipeline

from torch_parity import (  # noqa: F401
    TINY_WORDS,
    one_torch_thread,
    port_components,
    rel_diff,
)

REQUESTS = [
    {"prompts": ["a photo of a {}", "an image of a {}"], "source": "cat",
     "dest": "dog", "seed_train": 0},
    {"prompts": ["a photo of a {}", "an image of a {}"], "source": "w1",
     "dest": "w2", "seed_train": 1},
]
HP = dict(
    layers=[1, 2], clamp_norm_factor=1.5, layer_selection="all",
    fact_token="subject_last", v_num_grad_steps=4, v_lr=0.2,
    v_weight_decay=5e-4, mom2_adjustment=True, mom2_update_weight=4000,
    rewrite_module_tmp="text_model.encoder.layers.{}.mlp.fc2",
    layer_module_tmp="text_model.encoder.layers.{}",
    mlp_module_tmp="text_model.encoder.layers.{}.mlp",
    attn_module_tmp="text_model.encoder.layers.{}.self_attn",
    ln_f_module="text_model.final_layer_norm",
    mom2_dataset="ccs_filtered", mom2_n_samples=100, mom2_dtype="float32",
    objective="ablate-dest", esd_mu="None", cal_text_repr_loss=True,
    text_repr_loss_scale_factor=0.01)


def _hparams(pkg, **change):
    return pkg.EMCIDHyperParams.from_dict({**HP, **change})


@pytest.fixture(scope="module")
def pair():
    comps = build_tiny_pipeline(seed=0, words=TINY_WORDS)
    return comps, port_components(comps)


def _seeded_covs(dim, n_layers, seed=1):
    """Well-conditioned covariances A^T A / n (condition number < 10)."""
    r = np.random.RandomState(seed)
    covs = []
    for _ in range(n_layers):
        a = r.randn(8 * dim, dim).astype(np.float32)
        covs.append((a.T @ a / a.shape[0]).astype(np.float32))
    return covs


def test_ops_reexport_the_solve():
    """``emcid_torch.ops`` re-exports the solve, as ``emcid_tpu.ops`` does."""
    import emcid_tpu.ops as jops

    import emcid_torch.ops as tops
    from emcid_torch.ops import solve

    assert tops.solve_adj_k is solve.solve_adj_k
    assert tops.upd_matrix_match_shape is solve.upd_matrix_match_shape
    assert hasattr(jops, "solve_adj_k") and hasattr(jops,
                                                    "upd_matrix_match_shape")


@pytest.mark.parametrize("kwargs", [{}, dict(beta_start=0.001,
                                             beta_end=0.03,
                                             num_train_timesteps=500)],
                         ids=["default", "custom"])
def test_schedule_linear_matches_jax(kwargs):
    """``Schedule.linear``: the same f32 tables, bit for bit."""
    from emcid_tpu.models.scheduler import Schedule as JSchedule

    from emcid_torch.models.scheduler import Schedule

    j, t = JSchedule.linear(**kwargs), Schedule.linear(**kwargs)
    np.testing.assert_array_equal(j.betas, t.betas)
    np.testing.assert_array_equal(j.alphas_cumprod, t.alphas_cumprod)
    assert (j.num_train_timesteps, j.prediction_type) == (
        t.num_train_timesteps, t.prediction_type)


def test_get_cov_inv_matches_jax(pair, tmp_path):
    """``get_cov_text_encoder(inv=True)`` on a seeded well-conditioned
    cache file that both packages read: the port's float64 inverse, in
    f32, against the JAX package's f32 inverse at 1e-5, and C @ C^-1 = I
    at 1e-5; ``inv=False`` returns C itself."""
    from emcid_tpu.engine.layer_stats import COV_CACHE
    from emcid_tpu.engine.layer_stats import get_cov_text_encoder as jcov

    from emcid_torch.engine.layer_stats import (
        get_cov_text_encoder,
        stats_filename,
    )
    from emcid_torch.stats import CombinedStat, SecondMoment, save_cached_state

    comps, pc = pair
    name = "text_model.encoder.layers.1.mlp.fc2"
    a = np.random.RandomState(2).randn(400, 64).astype(np.float32)
    stat = CombinedStat(mom2=SecondMoment())
    stat.add(torch.from_numpy(a))
    save_cached_state(stats_filename(tmp_path, "inv_parity", "seeded", name,
                                     sample_size=400), stat,
                      {"sample_size": 400})
    kw = dict(mom2_dataset="seeded", mom2_n_samples=400, stat_dir=tmp_path,
              model_name="inv_parity", verbose=False)
    COV_CACHE.pop(("inv_parity", name), None)
    jinv = np.asarray(jcov(comps.text_encoder, comps.text_params,
                           comps.tokenizer, name, inv=True, **kw))
    tinv = get_cov_text_encoder(pc.text_encoder, pc.tokenizer, name,
                                inv=True, **kw)
    C = get_cov_text_encoder(pc.text_encoder, pc.tokenizer, name, **kw)
    assert tinv.dtype == C.dtype == torch.float32
    np.testing.assert_allclose(C.numpy(), a.T @ a / 400, rtol=1e-5,
                               atol=1e-6)
    assert rel_diff(jinv, tinv) <= 1e-5
    eye = C.double() @ tinv.double()
    assert float((eye - torch.eye(64, dtype=torch.float64)).abs().max()) \
        <= 1e-5


def test_compute_ks_matches_jax(pair):
    """Stage-2 keys (R, T, in_dim): the fc2 inputs at the fact tokens,
    prompt-averaged, at 1e-5; with two edit tokens too."""
    import emcid_tpu.hparams as jhp
    from emcid_tpu.engine.extract import compute_ks_text_encoder as jks

    import emcid_torch.hparams as thp
    from emcid_torch.engine.extract import compute_ks_text_encoder

    comps, pc = pair
    for change in ({}, dict(num_edit_tokens=2)):
        ref = jks(comps.text_encoder, comps.text_params, comps.tokenizer,
                  REQUESTS, _hparams(jhp, **change), layer=2)
        got = compute_ks_text_encoder(pc.text_encoder, pc.tokenizer,
                                      REQUESTS, _hparams(thp, **change),
                                      layer=2)
        T = change.get("num_edit_tokens", 1)
        assert tuple(got.shape) == (2, T, 64) == tuple(ref.shape)
        assert rel_diff(ref, got) <= 1e-5


def test_compute_z_batch_matches_jax(pair, monkeypatch):
    """``compute_z_text_encoder_batch`` with the same Stage-1 draws fed to
    both packages through the record/replay seam (the noise and timesteps
    replayed; logvar -60 and one image per prompt take the posterior draw
    and the image index out): z by cosine >= 0.9999 and norm within 1e-3,
    the loss curve at 1e-4."""
    import emcid_tpu.hparams as jhp
    from emcid_tpu.engine import compute_z as jcz

    import emcid_torch.hparams as thp
    from emcid_torch.engine import compute_z as tcz

    comps, pc = pair
    C, P, steps = 2, 2, 4
    rng = np.random.RandomState(3)
    mean = rng.randn(C, 1, P, 8, 8, 4).astype(np.float32)
    logvar = np.full_like(mean, -60.0)
    noise = rng.randn(steps, C, P, 8, 8, 4).astype(np.float32)
    ts = rng.randint(0, 1000, (steps, C, P)).astype(np.int32)
    jrun, trun = jcz.ZOptimizer.run, tcz.ZOptimizer.run
    monkeypatch.setattr(
        jcz.ZOptimizer, "run",
        lambda self, tp, up, batch, rng=None: jrun(
            self, tp, up, batch, rng, noise_override=noise,
            ts_override=ts))
    monkeypatch.setattr(
        tcz.ZOptimizer, "run",
        lambda self, batch, gen=None: trun(self, batch, gen,
                                           noise_override=noise,
                                           ts_override=ts))
    monkeypatch.setenv("EMCID_TPU_EPS_POOL", "0")
    monkeypatch.setenv("EMCID_TPU_Z_SCHED", "const")
    jz, jloss = jcz.compute_z_text_encoder_batch(
        comps.text_encoder, comps.text_params, comps.unet, comps.unet_params,
        comps.schedule, comps.tokenizer, REQUESTS, _hparams(jhp), 2, mean,
        logvar, rng=jax.random.PRNGKey(0), verbose=False)
    tz, tloss = tcz.compute_z_text_encoder_batch(
        pc.text_encoder, pc.unet, pc.schedule, pc.tokenizer, REQUESTS,
        _hparams(thp), 2, mean, logvar, verbose=True)
    assert isinstance(tz, np.ndarray) and tz.shape == jz.shape == (C, 1, 32)
    assert tloss.shape == (steps,)
    jz, tz = jz.reshape(C, -1), tz.reshape(C, -1)
    cos = (jz * tz).sum(-1) / np.linalg.norm(jz, axis=-1) / np.linalg.norm(
        tz, axis=-1)
    assert cos.min() >= 0.9999, cos
    ratio = np.linalg.norm(tz, axis=-1) / np.linalg.norm(jz, axis=-1)
    assert np.abs(ratio - 1).max() <= 1e-3, ratio
    assert rel_diff(jloss, tloss) <= 1e-4


def test_apply_emcid_to_text_encoder_matches_jax(pair, tmp_path):
    """z from ``compute_z_fn`` (then saved to the z cache), covariances from
    ``cov_fn``, the f64 insert: the deltas against the JAX package's at
    1e-6; the originals returned unchanged bit for bit; a second call reads
    the cache (no ``compute_z_fn``) and gives the same deltas; with neither
    a cached z nor ``compute_z_fn``, or neither covs nor ``cov_fn``, both
    packages raise."""
    import emcid_tpu.hparams as jhp
    from emcid_tpu.engine.emcid import apply_emcid_to_text_encoder as japply

    import emcid_torch.hparams as thp
    from emcid_torch.engine.emcid import apply_emcid_to_text_encoder

    comps, pc = pair
    jh, th = _hparams(jhp), _hparams(thp)
    zs = np.random.RandomState(4).randn(2, 1, 32).astype(np.float32)
    covs = _seeded_covs(64, 2)
    calls = []

    def compute_z(reqs):
        calls.append(len(reqs))
        return [zs[[r["source"] for r in REQUESTS].index(q["source"])]
                for q in reqs]

    cov_fn = lambda layer: covs[jh.layers.index(layer)]
    before = {k: v.clone() for k, v in pc.text_encoder.state_dict().items()}
    jparams, jd, jorig = japply(
        comps.text_encoder, comps.text_params, comps.tokenizer, REQUESTS, jh,
        compute_z_fn=compute_z, cov_fn=cov_fn,
        cache_name=f"{tmp_path / 'jax'}/", solve_method="f64", verbose=False,
        return_orig_params=True)
    tmodel, td, torig = apply_emcid_to_text_encoder(
        pc.text_encoder, pc.tokenizer, REQUESTS, th, compute_z_fn=compute_z,
        cov_fn=lambda layer: torch.from_numpy(cov_fn(layer)),
        cache_name=f"{tmp_path / 'torch'}/", solve_method="f64",
        verbose=False, return_orig_params=True)
    assert calls == [2, 2] and jorig is comps.text_params
    assert torig is pc.text_encoder and tmodel is not pc.text_encoder
    for k, v in pc.text_encoder.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert set(jd) == set(td)
    for name, (adj, resid) in jd.items():
        assert rel_diff(adj, td[name][0], "fro") <= 1e-6, name
        assert rel_diff(resid, td[name][1], "fro") <= 1e-6, name
    for r, z in zip(REQUESTS, zs):
        stem = f"source_{r['source']}_dest_{r['dest']}.npz"
        for side in ("jax", "torch"):
            np.testing.assert_array_equal(
                np.load(tmp_path / side / stem)["v_star"], z)
    # the cache serves the second call; the port reads the JAX-written one
    again, td2 = apply_emcid_to_text_encoder(
        pc.text_encoder, pc.tokenizer, REQUESTS, th,
        covs=[torch.from_numpy(c) for c in covs],
        cache_name=f"{tmp_path / 'jax'}/", solve_method="f64", verbose=False)
    for name in td:
        np.testing.assert_array_equal(td[name][0], td2[name][0])
        np.testing.assert_array_equal(td[name][1], td2[name][1])
    with pytest.raises(ValueError, match="compute_z_fn"):
        japply(comps.text_encoder, comps.text_params, comps.tokenizer,
               REQUESTS, jh, cov_fn=cov_fn, verbose=False)
    with pytest.raises(ValueError, match="compute_z_fn"):
        apply_emcid_to_text_encoder(pc.text_encoder, pc.tokenizer, REQUESTS,
                                    th, cov_fn=cov_fn, verbose=False)
    with pytest.raises(ValueError, match="cov_fn"):
        apply_emcid_to_text_encoder(pc.text_encoder, pc.tokenizer, REQUESTS,
                                    th, zs=zs, verbose=False)


def test_resolve_covariances_matches_jax(pair, tmp_path):
    """``resolve_covariances(components, hparams)``: with no cache and no
    captions both fall back to the synthetic corpus (min(mom2_n_samples,
    2000) captions) and agree at 1e-5 per layer; on a two-entry mesh the
    port's sweep agrees with its unsharded one at 1e-6."""
    import emcid_tpu.hparams as jhp
    from emcid_tpu.engine.editor import resolve_covariances as jresolve
    from emcid_tpu.engine.layer_stats import COV_CACHE

    import emcid_torch.hparams as thp
    from emcid_torch.engine.editor import resolve_covariances

    comps, pc = pair
    COV_CACHE.clear()  # the JAX memo is keyed by layer name only
    ref = jresolve(comps, _hparams(jhp), stats_dir=tmp_path / "jax",
                   verbose=False)
    got = resolve_covariances(pc, _hparams(thp), stats_dir=tmp_path / "torch",
                              verbose=False)
    COV_CACHE.clear()
    assert len(got) == len(ref) == 2
    for a, b in zip(ref, got):
        assert tuple(b.shape) == (64, 64)
        assert rel_diff(a, b) <= 1e-5
    from emcid_torch.parallel import get_mesh

    sharded = resolve_covariances(pc, _hparams(thp), stats_dir=tmp_path / "m",
                                  mesh=get_mesh(["cpu"] * 2), verbose=False)
    for a, b in zip(got, sharded):
        assert rel_diff(a, b) <= 1e-6


def test_workflows_layer_stats_tiny_cpu(pair, tmp_path, monkeypatch):
    """``workflows layer_stats --tiny --platform cpu --layers 0-3`` over 60
    synthetic captions (hparams built here): one npz per layer at the
    cache codec's path, each second moment against the JAX package's
    ``layer_stats_text_encoder`` on the same captions and weights at 1e-5,
    and each layer's seconds in ``timings``."""
    import emcid_torch.models.loader as tloader
    from emcid_tpu.dsets.stat_dataset import make_synthetic_captions
    from emcid_tpu.engine.layer_stats import layer_stats_text_encoder as jls

    import emcid_torch.hparams as thp
    from emcid_torch.cli import workflows
    from emcid_torch.engine.layer_stats import stats_filename

    comps, pc = pair
    monkeypatch.setattr(tloader, "build_tiny_pipeline",
                        lambda seed=0, device=None: pc)
    (tmp_path / "hparams").mkdir()
    name = _hparams(thp).to_json(tmp_path / "hparams").stem
    timings = {}
    stats = workflows.main(
        ["layer_stats", "--tiny", "--platform", "cpu", "--hparam", name,
         "--hparams_dir", str(tmp_path / "hparams"), "--layers", "0-3",
         "--sample_size", "60", "--stats_dir", str(tmp_path / "torch")],
        timings=timings)
    captions = make_synthetic_captions(60)
    assert len(stats) == 4
    for layer in range(4):
        lname = f"text_model.encoder.layers.{layer}.mlp.fc2"
        assert timings[lname] > 0
        assert stats_filename(tmp_path / "torch", "text_encoder",
                              "ccs_filtered", lname, sample_size=60).exists()
        ref = jls(comps.text_encoder, comps.text_params, comps.tokenizer,
                  lname, stats_dir=tmp_path / "jax", sample_size=60,
                  captions=captions, ds_name="ccs_filtered")
        assert stats[lname].mom2.count == ref.mom2.count
        assert rel_diff(np.asarray(ref.mom2.moment()),
                        stats[lname].mom2.moment()) <= 1e-5

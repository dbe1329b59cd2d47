"""PyTorch port, models: the JAX tiny pipeline's weights carried across by
``emcid_torch.models.convert`` load strictly into the port's modules, and
CLIP taps, UNet eps and VAE encode/decode agree with the JAX package in f32
(max abs diff <= 1e-4 * max |ref|); the DPM++ and PNDM steps agree on fixed
arrays (1e-6 * max |ref|)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from emcid_tpu.models import scheduler as jsched
from emcid_tpu.models.loader import build_tiny_pipeline

from emcid_torch.models import scheduler as tsched
from torch_parity import TINY_WORDS, port_components, rel_diff

TOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    comps = build_tiny_pipeline(seed=0, words=TINY_WORDS)
    return comps, port_components(comps)


def test_clip_taps_hidden_pooled(pair):
    comps, pc = pair
    ids = comps.tokenizer(["a photo of a cat", "w1 painting by w2"],
                          padding="max_length", max_length=32)["input_ids"]
    ref = comps.text_encoder.apply({"params": comps.text_params},
                                   jnp.asarray(ids),
                                   capture=("fc2_in", "fc2_out", "layer_out"))
    with torch.no_grad():
        got = pc.text_encoder(torch.as_tensor(ids).long(),
                              capture=("fc2_in", "fc2_out", "layer_out"))
    assert rel_diff(ref.last_hidden_state, got.last_hidden_state) <= TOL
    assert rel_diff(ref.pooled_output, got.pooled_output) <= TOL
    for name in ("fc2_in", "fc2_out", "layer_out"):
        assert rel_diff(ref.taps[name], got.taps[name]) <= TOL, name


def test_clip_inject_and_stop_at_layer(pair):
    comps, pc = pair
    ids = comps.tokenizer(["a photo of a dog"], padding="max_length",
                          max_length=32)["input_ids"]
    delta = np.random.RandomState(0).randn(1, 32, 32).astype(np.float32)
    ref = comps.text_encoder.apply(
        {"params": comps.text_params}, jnp.asarray(ids), inject_layer=1,
        inject_delta=jnp.asarray(delta), capture=("layer_out",),
        stop_at_layer=2)
    with torch.no_grad():
        got = pc.text_encoder(torch.as_tensor(ids).long(), inject_layer=1,
                              inject_delta=torch.from_numpy(delta),
                              capture=("layer_out",), stop_at_layer=2)
    assert got.pooled_output is None
    assert rel_diff(ref.last_hidden_state, got.last_hidden_state) <= TOL
    assert rel_diff(ref.taps["layer_out"], got.taps["layer_out"]) <= TOL


def test_unet_eps(pair):
    comps, pc = pair
    r = np.random.RandomState(1)
    x = r.randn(2, 8, 8, 4).astype(np.float32)
    ctx = r.randn(2, 32, 32).astype(np.float32)
    t = np.array([10, 700], np.int32)
    ref = comps.unet.apply({"params": comps.unet_params}, jnp.asarray(x),
                           jnp.asarray(t), jnp.asarray(ctx)).sample
    with torch.no_grad():
        got = pc.unet(torch.from_numpy(x).permute(0, 3, 1, 2),
                      torch.from_numpy(t), torch.from_numpy(ctx)).sample
    assert rel_diff(ref, got.permute(0, 2, 3, 1)) <= TOL


def test_vae_encode_decode(pair):
    comps, pc = pair
    r = np.random.RandomState(2)
    img = r.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    z = r.randn(2, 8, 8, 4).astype(np.float32)
    ref = comps.vae.apply({"params": comps.vae_params}, jnp.asarray(img),
                          method="encode")
    dec = comps.vae.apply({"params": comps.vae_params}, jnp.asarray(z),
                          method="decode")
    with torch.no_grad():
        got = pc.vae.encode(torch.from_numpy(img).permute(0, 3, 1, 2))
        got_dec = pc.vae.decode(torch.from_numpy(z).permute(0, 3, 1, 2))
    assert rel_diff(ref.mean, got.mean.permute(0, 2, 3, 1)) <= TOL
    assert rel_diff(ref.logvar, got.logvar.permute(0, 2, 3, 1)) <= TOL
    assert rel_diff(dec, got_dec.permute(0, 2, 3, 1)) <= TOL


def _steps_fixture():
    r = np.random.RandomState(3)
    lat = r.randn(2, 4, 8, 8).astype(np.float32)
    eps = [r.randn(2, 4, 8, 8).astype(np.float32) for _ in range(6)]
    ts = jsched.ddim_timesteps(jsched.sd_schedule(), 5)
    ts_prev = np.concatenate([ts[1:], [-1]]).astype(np.int32)
    return lat, eps, ts, ts_prev


def test_dpmpp_steps(pair):
    lat, eps, ts, ts_prev = _steps_fixture()
    js, ts_ = jsched.sd_schedule(), tsched.sd_schedule()
    jst, tst = jsched.dpmpp_init(lat.shape), tsched.dpmpp_init()
    jl, tl = jnp.asarray(lat), torch.from_numpy(lat)
    for i, (t, tp) in enumerate(zip(ts, ts_prev)):
        jst, jl = jsched.dpmpp_step(js, jst, jl, jnp.asarray(eps[i]),
                                    jnp.int32(t), jnp.int32(tp))
        tst, tl = tsched.dpmpp_step(ts_, tst, tl, torch.from_numpy(eps[i]),
                                    int(t), int(tp))
        assert rel_diff(jl, tl) <= 1e-6, i


def test_pndm_steps(pair):
    lat, eps, ts, ts_prev = _steps_fixture()
    js, ts_ = jsched.sd_schedule(), tsched.sd_schedule()
    # skip-prk transfers: (t0->t1), (t0->t1), (t1->t2), ...
    tr = list(zip([ts[0]] + list(ts), [ts_prev[0]] + list(ts_prev)))
    jst, tst = jsched.pndm_init(lat.shape), tsched.pndm_init()
    jl, tl = jnp.asarray(lat), torch.from_numpy(lat)
    for i, (t, tp) in enumerate(tr):
        jst, jl = jsched.pndm_step(js, jst, jl, jnp.asarray(eps[i]),
                                   jnp.int32(t), jnp.int32(tp))
        tst, tl = tsched.pndm_step(ts_, tst, tl, torch.from_numpy(eps[i]),
                                   int(t), int(tp))
        assert rel_diff(jl, tl) <= 1e-6, i


def test_add_noise(pair):
    r = np.random.RandomState(4)
    x0, noise = r.randn(2, 3, 4, 4).astype(np.float32), r.randn(
        2, 3, 4, 4).astype(np.float32)
    t = np.array([3, 900], np.int32)
    ref = jsched.add_noise(jsched.sd_schedule(), jnp.asarray(x0),
                           jnp.asarray(noise), jnp.asarray(t))
    got = tsched.add_noise(tsched.sd_schedule(), torch.from_numpy(x0),
                           torch.from_numpy(noise), torch.from_numpy(t))
    assert rel_diff(ref, got) <= 1e-6

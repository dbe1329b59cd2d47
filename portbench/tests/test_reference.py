"""The plain reference against the program's plain path (its CPU route,
no kernels) at tiny widths in float32: the same weights give the same
outputs."""

import numpy as np
import pytest
import torch

from portbench import harness, weights
from portbench.reference import clip, samplers, unet, vae
from portbench.reference.ops import Prec
from portbench.tests import tiny


def build(cfg, key):
    ctx = harness.Context(cell="t", cfg=cfg, traffic={}, limits={}, seed=3,
                          seconds=0, trace=False, device=torch.device("cpu"),
                          tmp=None, t_start=0.0, dtype=torch.float32)
    mods = harness.port_modules(ctx)
    p = Prec(weights.reference_params(
        weights.make(cfg, 3, "cpu", torch.float32), cfg))
    return mods[key], p


def close(a, b, tol=2e-5):
    a, b = a.double(), b.double()
    assert float((a - b).abs().max() / b.abs().max()) < tol


@pytest.mark.parametrize("which", ["sd", "sdxl2"])
def test_clip(which):
    cfg = tiny.sd() if which == "sd" else tiny.sdxl()
    key = "text_encoder" if which == "sd" else "text_encoder_2"
    prefix = "" if which == "sd" else "te2."
    model, p = build(cfg, key)
    tcfg = cfg[key]
    ids = torch.randint(0, 500, (3, 77))
    ids[:, 0], ids[:, 9:] = 49406, 49407
    out = model(ids, capture=("fc2_in", "layer_out"))
    taps = {}
    h, pooled = clip.encode(p, tcfg, ids, prefix=prefix, taps=taps)
    close(h, out.last_hidden_state)
    close(pooled, out.pooled_output)
    close(torch.stack(taps["fc2_in"]), out.taps["fc2_in"])
    delta = torch.randn(3, 77, tcfg["hidden_size"])
    inj = model(ids, inject_layer=1, inject_delta=delta)
    close(clip.encode(p, tcfg, ids, prefix=prefix, inject=(1, delta))[0],
          inj.last_hidden_state)


@pytest.mark.parametrize("which", ["sd", "sdxl"])
def test_unet(which):
    cfg = tiny.sd() if which == "sd" else tiny.sdxl()
    model, p = build(cfg, "unet")
    ucfg = cfg["unet"]
    x = torch.randn(2, 4, 8, 8)
    t = torch.tensor([981, 17])
    ctx = torch.randn(2, 77, ucfg["cross_attention_dim"])
    added = None
    if which == "sdxl":
        added = {"text_embeds": torch.randn(2, 16),
                 "time_ids": torch.tensor([[16., 16, 0, 0, 16, 16]] * 2)}
    close(unet.unet(p, ucfg, x, t, ctx, added),
          model(x, t, ctx, added).sample)


def test_vae():
    cfg = tiny.sd()
    model, p = build(cfg, "vae")
    x = torch.rand(2, 3, 16, 16) * 2 - 1
    mean, logvar = vae.encode(p, cfg["vae"], x)
    dist = model.encode(x)
    close(mean, dist.mean)
    close(logvar, dist.logvar)
    z = torch.randn(2, 4, 8, 8)
    close(vae.decode(p, cfg["vae"], z), model.decode(z))


@pytest.mark.parametrize("sampler,n,guided", [("ddim", 7, None),
                                              ("pndm", 7, None),
                                              ("pndm", 10, 6),
                                              ("dpm++", 10, 6)])
def test_samplers(sampler, n, guided):
    from emcid_torch.models.scheduler import ddim_timesteps, run_sampler, \
        sd_schedule

    def eps(x, t):
        return 0.3 * x + 0.01 * t

    def tail(x, t):
        return -0.2 * x + 0.02

    x = torch.randn(2, 4, 8, 8)
    ts = ddim_timesteps(sd_schedule(), n)
    assert list(ts) == samplers.timesteps(n)
    ts_prev = np.concatenate([ts[1:], [-1]]).astype(np.int32)
    ours = samplers.sample(sampler, eps, x, n, eps_tail=tail, n_guided=guided)
    theirs = run_sampler(sampler, sd_schedule(), eps, x, ts, ts_prev,
                         unet_eps_tail=tail, n_head=guided)
    close(ours, theirs, 1e-5)


@pytest.mark.parametrize("cell,traffic", [("sd14-edit-b8", "edit-b8"),
                                          ("sd14-edit-b1", "edit-b1"),
                                          ("sd14-gen-512", "iceb-512"),
                                          ("sdxl-gen-1024", "coco-1024")])
def test_cell_in_float32_agrees(cell, traffic):
    """The program in float32 against the reference: the checks read
    rounding only."""
    from portbench import run

    cfg = dict(tiny.config_for(cell), dtype="float32")
    out = run.run_cell(cell, 2 ** 31 + 7, 0.05, False, "cpu", cfg=cfg,
                       traffic=tiny.traffic(traffic))
    for name, c in out["checks"].items():
        assert c["value"] < (0.02 if name == "image_mae" else 1e-4), name


@pytest.mark.parametrize("name,billions", [("sd-v1.4", 1.066),
                                           ("sdxl-base-1.0", 3.469)])
def test_published_parameter_counts(name, billions):
    """The weights' shapes at full width add up to the published models'
    sizes, and name every tensor of the program's modules (built without
    storage)."""
    import json
    from pathlib import Path

    cfg = json.loads((Path(__file__).resolve().parents[1] / "configs"
                      / f"{name}.json").read_text())
    assert round(weights.n_params(cfg) / 1e9, 3) == billions
    from emcid_torch.models.configs import unet_config_from_diffusers
    from emcid_torch.models.unet import UNet2DCondition

    with torch.device("meta"):
        unet_mod = UNet2DCondition(unet_config_from_diffusers(cfg["unet"]))
    spec = dict(weights.unet_spec(cfg["unet"]))
    assert {k: tuple(v.shape) for k, v in unet_mod.state_dict().items()} \
        == spec

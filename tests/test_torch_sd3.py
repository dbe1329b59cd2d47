"""PyTorch port, SD3.5 (``models/mmdit``, ``models/t5_text``, ``models/sd3``,
the flow-matching functions of ``models/scheduler``, ``engine/sd3``)
against the benchmark's plain reference ``portbench/reference/sd3_edit``
at tiny widths on the CPU, seeded random weights.

Tolerances.  In float32 both sides differ in summation order only: 1e-5
(relative to the largest value) for one MMDiT, T5 or VAE forward and for
the MMDiT's gradient into its context, as ``test_torch_sdxl.py`` holds the
UNet; 1e-4 of the reference's own Stage-1 step for z after 8 Adam steps
and of the update for the fc2 weights, as
``test_torch_sdxl_edit_reference.py`` holds SDXL's block.  The program in
bfloat16, as it is served, fails the block's tolerances.

Also: T5 against transformers' ``T5EncoderModel`` at the same weights, the
flow sigmas and an Euler step against their written formulas, the edit
block's phases and spans, SDXL's Stage-1 z on replayed draws bitwise equal
to what it was before SDXL and SD3 shared the loop (a frozen copy of the
earlier loop, kept in this file), and a pipeline folder written and loaded back exactly.
"""

import os

os.environ.setdefault("USE_TF", "0")  # transformers without TensorFlow

import numpy as np
import pytest
import torch

from emcid_torch import profiling
from emcid_torch.engine import sd3 as sd3_engine
from emcid_torch.models import scheduler as sch
from emcid_torch.models.sd3 import (
    SUBFOLDERS,
    build_tiny_sd3_pipeline,
    decode_sd3,
    encode_posterior_sd3,
    generate_sd3,
    load_sd3_pipeline,
    save_sd3_pipeline,
)
from portbench import harness
from portbench.drivers import edit_sd3
from portbench.drivers.edit import requests
from portbench.reference import sd3_edit
from portbench.reference.ops import Prec
from portbench.tests import tiny_sd3
from test_stage1_graphs import graphs_on, wrapper_calls  # noqa: F401
from torch_parity import one_torch_thread, recorded, rel_diff  # noqa: F401

TOL = 1e-5
Z_TOL = FC2_TOL = 1e-4


@pytest.fixture(scope="module")
def comps():
    return build_tiny_sd3_pipeline(seed=3, words=["cat", "dog"], device="cpu")


def ref(module, fp8=False) -> Prec:
    return Prec({k: v.detach() for k, v in module.state_dict().items()},
                fp8=fp8)


def mmdit_cfg(comps) -> dict:
    c = comps.transformer.config
    return dict(vars(c) if not hasattr(c, "__dataclass_fields__") else {
        f: getattr(c, f) for f in c.__dataclass_fields__})


# -- the models ---------------------------------------------------------------


def test_mmdit_matches_reference(comps):
    """Forward, and the gradient into the context and the pooled input,
    within 1e-5; the patch table the program builds is the reference's."""
    tr, cfg = comps.transformer, mmdit_cfg(comps)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 16, 8, 8, generator=g)
    t = torch.tensor([999.0, 3.7])
    ctx = torch.randn(2, 5, 32, generator=g, requires_grad=True)
    pooled = torch.randn(2, 32, generator=g, requires_grad=True)
    w = torch.randn(2, 16, 8, 8, generator=g)
    out = tr(x, t, ctx, pooled)
    gc, gp = torch.autograd.grad((out * w).sum(), (ctx, pooled))
    p = ref(tr)
    c2, p2 = (a.detach().clone().requires_grad_() for a in (ctx, pooled))
    want = sd3_edit.mmdit(p, cfg, x, t, c2, p2)
    wc, wp = torch.autograd.grad((want * w).sum(), (c2, p2))
    assert rel_diff(want.detach(), out) <= TOL
    assert rel_diff(wc, gc) <= TOL and rel_diff(wp, gp) <= TOL
    table = sd3_edit.pos_table(32, cfg["pos_embed_max_size"],
                               cfg["sample_size"] // cfg["patch_size"])
    assert rel_diff(table, tr.pos_embed.pos_embed[0]) <= 1e-7


def test_mmdit_published_layout(comps):
    """Block 0 is dual (9 modulation vectors, ``attn2``), the last block
    keeps only the text stream's (scale, shift) and no text output."""
    blocks = comps.transformer.transformer_blocks
    sd = comps.transformer.state_dict()
    assert sd["transformer_blocks.0.norm1.linear.weight"].shape[0] == 9 * 32
    assert "transformer_blocks.0.attn2.norm_q.weight" in sd
    assert "transformer_blocks.1.attn2.to_q.weight" not in sd
    last = f"transformer_blocks.{len(blocks) - 1}"
    assert sd[last + ".norm1_context.linear.weight"].shape[0] == 2 * 32
    assert last + ".attn.to_add_out.weight" not in sd
    assert last + ".ff_context.net.2.weight" not in sd


def test_t5_matches_reference_and_transformers(comps):
    te = comps.text_encoder_3
    ids = torch.as_tensor(comps.tokenizer_3(["a photo of a cat", "", "dog"]))
    got = te(ids)
    c = te.config
    cfg = dict(num_heads=c.num_heads, layer_norm_epsilon=c.layer_norm_epsilon,
               num_layers=c.num_layers,
               relative_attention_num_buckets=c.relative_attention_num_buckets,
               relative_attention_max_distance=(
                   c.relative_attention_max_distance))
    assert rel_diff(sd3_edit.t5(ref(te), cfg, ids), got) <= TOL
    transformers = pytest.importorskip("transformers")
    hf = transformers.T5EncoderModel(transformers.T5Config(
        vocab_size=c.vocab_size, d_model=c.d_model, d_kv=c.d_kv, d_ff=c.d_ff,
        num_layers=c.num_layers, num_heads=c.num_heads,
        relative_attention_num_buckets=c.relative_attention_num_buckets,
        relative_attention_max_distance=c.relative_attention_max_distance,
        feed_forward_proj="gated-gelu", layer_norm_epsilon=1e-6,
        dropout_rate=0.0, tie_word_embeddings=False)).eval()
    sd = dict(te.state_dict(), **{"encoder.embed_tokens.weight":
                                  te.state_dict()["shared.weight"]})
    hf.load_state_dict(sd, strict=True)
    with torch.no_grad():
        want = hf(input_ids=ids).last_hidden_state
    assert rel_diff(want, got) <= TOL


def test_vae_without_quant_convs(comps):
    """No quant conv in the module; decode and the posterior with SD3's
    shift and scale against the reference's."""
    vae = comps.vae
    assert not any("quant_conv" in k for k in vae.state_dict())
    cfg = {"norm_num_groups": 4, "block_out_channels": [16, 32],
           "layers_per_block": 1}
    g = torch.Generator().manual_seed(1)
    lat = torch.randn(2, 8, 8, 16, generator=g)
    img = decode_sd3(comps, lat)
    z = lat.permute(0, 3, 1, 2) / comps.scaling_factor + comps.shift_factor
    from portbench.reference import vae as rvae

    want = rvae.to_uint8(sd3_edit.vae_decode(ref(vae), cfg, z))
    assert (torch.as_tensor(img).int() - want.int()).abs().max() <= 1
    x = torch.rand(2, 16, 16, 3, generator=g) * 2 - 1
    mean, logvar = encode_posterior_sd3(comps, x)
    m, lv = sd3_edit.vae_encode(ref(vae), cfg, x.permute(0, 3, 1, 2))
    sf, sh = comps.scaling_factor, comps.shift_factor
    assert rel_diff((m - sh) * sf, mean.permute(0, 3, 1, 2)) <= TOL
    assert rel_diff(lv + 2 * np.log(sf), logvar.permute(0, 3, 1, 2)) <= TOL


def test_flow_sigmas_and_euler_step():
    """The training table, diffusers' inference sigmas and an Euler step
    against the written formulas, and the reference's own."""
    shift = lambda s: 3.0 * s / (1 + 2.0 * s)  # noqa: E731
    table = sch.flow_train_sigmas(3.0)
    i = np.arange(1000)
    np.testing.assert_allclose(table, shift((1000 - i) / 1000.0), rtol=1e-6)
    assert table.dtype == np.float32 and table[0] == 1.0
    np.testing.assert_array_equal(table, sd3_edit.train_sigmas().numpy())
    sig = sch.flow_sigmas(25, 3.0)
    want = shift(np.linspace(1.0, float(table[-1]), 25))
    np.testing.assert_allclose(sig[:-1], want, rtol=1e-6)
    assert sig[-1] == 0 and len(sig) == 26
    np.testing.assert_array_equal(sig, sd3_edit.sample_sigmas(25))
    assert sch.flow_timestep(sig[3]) == np.float32(sig[3]) * np.float32(1000)
    g = torch.Generator().manual_seed(2)
    x, v = torch.randn(4, 5, generator=g), torch.randn(4, 5, generator=g)
    got = sch.flow_euler_step(x, v, sig[3], sig[4])
    assert torch.equal(got, x + float(np.float32(sig[4])
                                      - np.float32(sig[3])) * v)
    x0, eps = torch.randn(4, 5, generator=g), torch.randn(4, 5, generator=g)
    s = torch.tensor([0.0, 0.3, 0.7, 1.0])
    assert torch.allclose(sch.flow_add_noise(x0, eps, s),
                          (1 - s[:, None]) * x0 + s[:, None] * eps)
    assert torch.equal(sch.flow_velocity(x0, eps), eps - x0)


def test_pipeline_folder_round_trip(comps, tmp_path):
    """A tiny SD3 written in the diffusers/transformers folder layout loads
    back with the same tensors and renders the same images."""
    save_sd3_pipeline(comps, tmp_path / "sd3")
    for sub in SUBFOLDERS:
        assert (tmp_path / "sd3" / sub / "config.json").exists()
    back = load_sd3_pipeline(tmp_path / "sd3", dtype=torch.float32,
                             device="cpu")
    for sub in SUBFOLDERS:
        a, b = (getattr(c, sub).state_dict() for c in (comps, back))
        assert set(a) == set(b), sub
        assert all(torch.equal(a[k], b[k]) for k in a), sub
    assert (back.shift, back.scaling_factor, back.shift_factor) == (
        comps.shift, comps.scaling_factor, comps.shift_factor)
    kw = dict(num_inference_steps=3, height=16, width=16, cfg_interval=0.6)
    assert np.array_equal(generate_sd3(comps, ["a photo of a cat"], [5], **kw),
                          generate_sd3(back, ["a photo of a cat"], [5], **kw))


# -- the edit block -------------------------------------------------------------


def _context(dtype: str, tmp_path) -> harness.Context:
    cfg = dict(tiny_sd3.config(), dtype=dtype)
    traffic = tiny_sd3.traffic("edit-sd3-b1")
    traffic["batch"] = 2
    return harness.Context(
        cell="sd35m-edit-b1", cfg=cfg, traffic=traffic, limits={},
        seed=2 ** 32 + 29, seconds=0.0, trace=False,
        device=torch.device("cpu"), tmp=tmp_path, t_start=0.0,
        dtype=getattr(torch, dtype))


def _gaps(ctx: harness.Context):
    """The program's SD3 edit of one block of two concepts and its gaps to
    the reference, and the block's timings and spans."""
    from portbench import tokens

    tr = ctx.traffic
    comps = edit_sd3.components(ctx)
    caps = tokens.captions(ctx.rng(1), tr["stats_captions"],
                           *tr["caption_words"])
    reqs = requests(ctx, ctx.rng(2), tr["batch"])
    hp = edit_sd3.hparams(ctx)
    zs, timings = [], {}

    def keep(orig):
        def f(*a, **k):
            zs.append(orig(*a, **k))
            return zs[-1]
        return f

    with harness.wrapped(sd3_engine, "compute_z_sd3_text_encoders", keep), \
            profiling.recording("cpu") as rec:
        _, _, edited = sd3_engine.apply_emcid_sd3(
            comps, reqs, hp, captions=caps, rng_seed=11, timings=timings,
            **edit_sd3.entry_args(ctx, tr["steps"]))
    names = [(k, hp.rewrite_module_tmp.format(i))
             for k, layers in ((1, hp.layers), (2, hp.layers_2))
             for i in layers]
    C = len(reqs)
    z_port = [torch.as_tensor(z).reshape(C, -1) for z in zs[0]]
    blk = {"requests": reqs, "rng_seed": 11}
    rows = list(range(C))
    r = edit_sd3.reference_block(ctx, False, blk, rows, caps, zs=z_port)
    written = [edited.encoder(k).get_submodule(n).weight for k, n in names]
    params = edit_sd3.reference_params(ctx, skip=("text_encoder_3",))
    gaps = edit_sd3.compare(ctx, params, rows, r, z_port, written)
    return gaps, timings, rec.summary()


def test_block_matches_reference(tmp_path):
    """Both encoders' z of both concepts and the fc2 weights written at all
    edited layers within the float32 tolerances; the phases in ``timings``
    and their spans, ``stage1.dest`` once per concept and step."""
    g, timings, spans = _gaps(_context("float32", tmp_path))
    assert g["z_gap"] <= Z_TOL and g["fc2_gap"] <= FC2_TOL, g
    assert set(timings) == {"covariances", "t5", "generation", "stage1",
                            "stage2"}
    for name in ("edit.covariances", "edit.t5", "edit.train_images",
                 "edit.stage1", "edit.stage2"):
        assert spans[name]["n"] == 1, name
    steps = tiny_sd3.traffic("edit-sd3-b1")["hparams"]["v_num_grad_steps"]
    assert spans["stage1.step"]["n"] == steps
    assert spans["stage1.dest"]["n"] == 2 * steps


def test_bfloat16_fails_the_tolerances(tmp_path):
    g, _, _ = _gaps(_context("bfloat16", tmp_path))
    assert g["z_gap"] > Z_TOL and g["fc2_gap"] > FC2_TOL, g


def _sd3_stage1(comps, steps=3):
    """SD3's Stage 1 of two concepts over three prompts at the tiny
    pipeline's 8 x 8 latents -> ((z_1, z_2), the Stage-1 counters)."""
    from emcid_torch.hparams import EMCIDXLHyperParams

    prompts = ["a photo of a {}", "an image of a {}", "{}"]
    reqs = [{"prompts": prompts, "source": "cat", "dest": "dog",
             "seed_train": 0},
            {"prompts": prompts, "source": "dog", "dest": "cat",
             "seed_train": 1, "txt_align": False}]
    hp = EMCIDXLHyperParams.from_dict(dict(
        edit_sd3.hparams(_context("float32", None)).to_dict(),
        layers=[0, 1], layers_2=[1, 2], v_num_grad_steps=steps))
    t5 = sd3_engine.block_t5(comps, reqs)
    rng = np.random.RandomState(0)
    mean = rng.randn(2, 1, 3, 8, 8, 16).astype(np.float32) * 0.5
    logvar = np.full(mean.shape, -6.0, np.float32)
    with profiling.recording("cpu") as rec:
        zs = sd3_engine.compute_z_sd3_text_encoders(
            comps, reqs, hp, mean, logvar, t5["src"], t5["dst"],
            gen=torch.Generator().manual_seed(5), verbose=False)
    return zs, {k: v["n"] for k, v in rec.summary().items()
                if k.startswith("stage1.") and k not in (
                    "stage1.step", "stage1.dest")}


def test_stage1_graph_path_gives_the_eager_z(graphs_on, wrapper_calls,
                                             monkeypatch):
    """SD3's Stage 1 replayed from its captures (recording graphs on the
    CPU) gives the eager z exactly: one capture, every step replayed, the
    joint and dual attention reaching K1-K3's wrappers inside them."""
    from emcid_torch.engine import compute_z
    from emcid_torch.models import mmdit
    from emcid_torch.ops import flash_v2

    monkeypatch.setattr(mmdit, "attention", lambda q, k, v, scale=None:
                        flash_v2.flash_attention_v2(q, k, v, scale))
    comps = build_tiny_sd3_pipeline(seed=3, words=["cat", "dog"],
                                    device="cpu")
    with monkeypatch.context() as m:
        m.setattr(compute_z, "graph_blockers", lambda *a, **k: ["device"])
        want, counts = _sd3_stage1(comps)
    assert counts == {"stage1.eager_steps": 3}
    assert wrapper_calls["flash_dq"] == wrapper_calls["flash_dkv"] > 0
    got, counts = _sd3_stage1(comps)
    assert counts == {"stage1.graph_steps": 3, "stage1.capture": 1}
    for a, b in zip(want, got):
        assert np.array_equal(a, b)


def test_no_mesh(comps):
    with pytest.raises(NotImplementedError):
        sd3_engine.apply_emcid_sd3(comps, [], None, mesh=object())


# -- SDXL's Stage 1 on the shared loop ----------------------------------------------

def _sdxl_stage1_before(components, requests, hp, latents_mean,
                        latents_logvar, height, width, replay):
    """SDXL's Stage 1 as it was before the loop was shared with SD3, kept
    here frozen: its eager, one-device path on replayed draws, op for op."""
    from emcid_torch.engine.compute_z import (adam_step_, clamp_to_ball_,
                                              prepare_concept_batch)
    from emcid_torch.engine.sdxl import (_unet_eps, encoder2_ids,
                                         encoder_hparams_view)
    from emcid_torch.models.scheduler import add_noise
    from emcid_torch.models.sdxl import sdxl_condition, sdxl_time_ids

    text1, text2 = components.text_encoder, components.text_encoder_2
    unet, schedule = components.unet, components.schedule
    dev, dtype = components.device, components.dtype
    z1_layer, z2_layer = hp.layers[-1], hp.layers_2[-1]
    arrays, _, _ = prepare_concept_batch(components.tokenizer, requests,
                                         encoder_hparams_view(hp, 1))
    C, P, S = arrays["source_ids"].shape
    eos_id = int(getattr(components.tokenizer, "eos_token_id", None)
                 or np.max(arrays["source_ids"]))
    long = lambda a: torch.as_tensor(np.asarray(a), device=dev).long()  # noqa: E731
    f32 = lambda a: torch.as_tensor(np.asarray(a)).to(dev, torch.float32)  # noqa: E731
    src_ids = long(arrays["source_ids"])
    src_ids_2 = long(encoder2_ids(arrays["source_ids"], eos_id))
    dest_ids = long(arrays["dest_ids"])
    mask = f32(arrays["inject_mask"])
    mean, logvar = f32(latents_mean), f32(latents_logvar)
    tids = sdxl_time_ids(P, height, width, device=dev)
    ta_w = [1.0 if r.get("txt_align", True) else 0.0 for r in requests]
    samp_w = [1.0 if (getattr(hp, "use_sampled_noise", False)
                      or r.get("use_real_noise", False)) else 0.0
              for r in requests]
    img_idx, post_eps = long(replay.img_idx), f32(replay.post_eps)
    noises, steps_t = f32(replay.noise), long(replay.timesteps)
    with torch.no_grad():
        d_ctx, d_pool1, d_pool2 = sdxl_condition(
            text1, text2, dest_ids.reshape(C * P, S))
        d_ctx = d_ctx.reshape(C, P, S, -1)
        d_pool1 = d_pool1.float().reshape(C, P, -1)
        d_pool2_in = d_pool2.reshape(C, P, -1)
        d_pool2 = d_pool2_in.float()

        def z0_for(text, layer, ids):
            out = text(ids[:, 0], capture=("layer_out",), stop_at_layer=layer)
            return torch.einsum("cts,csh->cth", mask[:, :, 0, :],
                                out.taps["layer_out"][layer].float())

        z0_1 = z0_for(text1, z1_layer, src_ids)
        z0_2 = z0_for(text2, z2_layer, src_ids_2)
    z0n_1 = z0_1.reshape(C, -1).norm(dim=-1)
    z0n_2 = z0_2.reshape(C, -1).norm(dim=-1)
    d1, d2 = torch.zeros_like(z0_1), torch.zeros_like(z0_2)
    moments = [torch.zeros_like(d) for d in (d1, d1, d2, d2)]
    ar = torch.arange(P, device=dev)
    wd = float(hp.v_weight_decay)
    for step in range(int(hp.v_num_grad_steps)):
        g1, g2 = torch.zeros_like(d1), torch.zeros_like(d2)
        for c in range(C):
            img, eps = img_idx[step, c], post_eps[step, c]
            noise, t = noises[step, c], steps_t[step, c]
            lat = mean[c, img, ar] + torch.exp(0.5 * logvar[c, img, ar]) * eps
            noisy = add_noise(schedule, lat, noise, t).permute(0, 3, 1, 2)
            noisy = noisy.to(dev, dtype, memory_format=torch.contiguous_format)
            dc1 = d1[c].clone().requires_grad_()
            dc2 = d2[c].clone().requires_grad_()
            inj1 = torch.einsum("tps,th->psh", mask[c], dc1)
            inj2 = torch.einsum("tps,th->psh", mask[c], dc2)
            ctx, pool1, pool2 = sdxl_condition(
                text1, text2, src_ids[c], src_ids_2[c],
                inject_1=(z1_layer, inj1), inject_2=(z2_layer, inj2))
            loss = wd * (torch.sqrt(dc1.pow(2).sum() + 1e-12) / z0n_1[c] ** 2
                         + torch.sqrt(dc2.pow(2).sum() + 1e-12)
                         / z0n_2[c] ** 2)
            eps_e = _unet_eps(unet, noisy, t, ctx, pool2, tids)
            with torch.no_grad():
                eps_d = _unet_eps(unet, noisy, t, d_ctx[c], d_pool2_in[c],
                                  tids)
            mse_ablate = (eps_e - eps_d).pow(2).mean()
            mse_noise = (eps_e - noise.permute(0, 3, 1, 2)).pow(2).mean()
            loss = (samp_w[c] * mse_noise + (1.0 - samp_w[c]) * mse_ablate
                    ) + loss
            loss = loss + ta_w[c] * hp.text_repr_loss_scale_factor * (
                (pool1.float() - d_pool1[c]).pow(2).mean()
                + (pool2.float() - d_pool2[c]).pow(2).mean())
            g1[c], g2[c] = torch.autograd.grad(loss, (dc1, dc2))
        with torch.no_grad():
            for d, m, v, g, z0n in ((d1, *moments[:2], g1, z0n_1),
                                    (d2, *moments[2:], g2, z0n_2)):
                adam_step_(d, m, v, g, float(hp.v_lr), step + 1)
                clamp_to_ball_(d, hp.clamp_norm_factor * z0n)
    return (z0_1 + d1).cpu().numpy(), (z0_2 + d2).cpu().numpy()


def test_sdxl_stage1_bitwise_unchanged():
    """Tiny SDXL Stage 1 of two concepts, three prompts, three steps, on
    draws replayed from a fixed ``RandomState``: the shared loop gives the
    frozen loop's z bit for bit."""
    from emcid_torch.engine.sdxl import SDXLDraws, compute_z_sdxl_text_encoders
    from emcid_torch.hparams import EMCIDXLHyperParams
    from emcid_torch.models.sdxl import build_tiny_sdxl_pipeline

    prompts = ["a photo of a {}", "an image of a {}", "{}"]
    reqs = [{"prompts": prompts, "source": "cat", "dest": "dog",
             "seed_train": 0},
            {"prompts": prompts, "source": "dog", "dest": "cat",
             "seed_train": 1, "txt_align": False}]
    hp = EMCIDXLHyperParams.from_dict({
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
        "cal_text_repr_loss": True, "text_repr_loss_scale_factor": 0.5})
    comps = build_tiny_sdxl_pipeline(seed=0, words=["cat", "dog"],
                                     device="cpu")
    rng = np.random.RandomState(0)
    C, P, L, steps = 2, 3, 8, 3
    mean = rng.randn(C, 2, P, L, L, 4).astype(np.float32) * 0.13
    logvar = np.full(mean.shape, -6.0, np.float32)
    replay = SDXLDraws(
        rng.randint(0, 2, (steps, C, P)),
        rng.randn(steps, C, P, L, L, 4).astype(np.float32),
        rng.randn(steps, C, P, L, L, 4).astype(np.float32),
        rng.randint(0, 1000, (steps, C, P)))
    z1, z2 = compute_z_sdxl_text_encoders(
        comps, reqs, hp, mean, logvar, height=2 * L, width=2 * L,
        replay=replay, verbose=False)
    f1, f2 = _sdxl_stage1_before(comps, reqs, hp, mean, logvar, 2 * L, 2 * L,
                                 replay)
    assert z1.tobytes() == f1.tobytes()
    assert z2.tobytes() == f2.tobytes()
    assert not np.array_equal(z1, _sdxl_stage1_before(
        comps, reqs, hp, mean, logvar, 2 * L, 2 * L, replay._replace(
            timesteps=replay.timesteps[::-1].copy()))[0])

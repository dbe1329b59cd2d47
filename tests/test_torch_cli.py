"""PyTorch port, the product path around the edit: a local HF-format
checkpoint folder loaded by both packages, image generation and the VAE
round trip against the JAX package, and the port's CLI
(``emcid_torch.cli.run_emcid``) end to end on the tiny pipeline on the CPU,
with the fused-norm knobs off and on.

Tolerances: f32 on both sides, differing in summation order only, so
1e-4 of the largest reference value through a model (as
``test_torch_models``) and one uint8 level for decoded images (a 1e-6
difference can round a pixel to the next level).
"""

import dataclasses
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from emcid_tpu.models import convert_hf
from emcid_tpu.models import loader as jloader
from emcid_tpu.models import pipeline as jpipe

from emcid_torch.models import loader as tloader
from emcid_torch.models import pipeline as tpipe
from emcid_torch.models.configs import config_dict
from torch_parity import TINY_WORDS, port_components, port_tokenizer, rel_diff

TOL = 1e-4


def write_jax_checkpoint(comps, folder):
    """The JAX pipeline as an HF-format folder: the ``convert_hf``
    ``*_to_torch`` maps saved with ``torch.save``, diffusers-schema
    ``config.json`` files, and the tokenizer's vocab and merges."""
    npt = lambda tree: jax.tree.map(np.asarray, tree)
    for sub, fname, cfg, state in (
            ("text_encoder", "pytorch_model.bin", comps.text_encoder.config,
             convert_hf.clip_text_to_torch(npt(comps.text_params))),
            ("unet", "diffusion_pytorch_model.bin", comps.unet.config,
             convert_hf.unet_to_torch(npt(comps.unet_params))),
            ("vae", "diffusion_pytorch_model.bin", comps.vae.config,
             convert_hf.vae_to_torch(npt(comps.vae_params)))):
        (folder / sub).mkdir(parents=True)
        (folder / sub / "config.json").write_text(json.dumps(config_dict(cfg)))
        torch.save({k: torch.from_numpy(np.array(v, np.float32))
                    for k, v in state.items()}, folder / sub / fname)
    port_tokenizer(comps.tokenizer).save_pretrained(folder / "tokenizer")
    return folder


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    comps = jloader.build_tiny_pipeline(seed=0, words=TINY_WORDS)
    folder = write_jax_checkpoint(comps, tmp_path_factory.mktemp("ckpt"))
    return comps, folder


@pytest.fixture(scope="module")
def loaded(ckpt):
    _, folder = ckpt
    return (jloader.load_pipeline(folder, dtype=jnp.float32),
            tloader.load_pipeline(folder, dtype=torch.float32, device="cpu"))


def test_load_pipeline_text_encoder_matches_jax(loaded):
    jc, tc = loaded
    prompts = ["a photo of a cat", "w1 painting by w2"]
    ids_j = jc.tokenizer(prompts, padding="max_length",
                         max_length=32)["input_ids"]
    ids_t = tc.tokenizer(prompts, padding="max_length",
                         max_length=32)["input_ids"]
    np.testing.assert_array_equal(np.asarray(ids_j), np.asarray(ids_t))
    ref = jc.text_encoder.apply({"params": jc.text_params},
                                jnp.asarray(ids_j)).last_hidden_state
    with torch.no_grad():
        got = tc.text_encoder(torch.as_tensor(ids_t).long()).last_hidden_state
    assert rel_diff(ref, got) <= TOL


def test_load_pipeline_unet_matches_jax(loaded):
    jc, tc = loaded
    assert tc.vae_scale == jc.vae_scale == 2
    assert tc.scaling_factor == pytest.approx(jc.scaling_factor)
    r = np.random.RandomState(1)
    x = r.randn(2, 8, 8, 4).astype(np.float32)
    ctx = r.randn(2, 32, 32).astype(np.float32)
    t = np.array([10, 700], np.int32)
    ref = jc.unet.apply({"params": jc.unet_params}, jnp.asarray(x),
                        jnp.asarray(t), jnp.asarray(ctx)).sample
    with torch.no_grad():
        got = tc.unet(torch.from_numpy(x).permute(0, 3, 1, 2),
                      torch.from_numpy(t), torch.from_numpy(ctx)).sample
    assert rel_diff(ref, got.permute(0, 2, 3, 1)) <= TOL


def test_load_pipeline_matches_from_jax(ckpt, loaded):
    """The folder carries exactly the weights ``from_jax`` converts."""
    comps, _ = ckpt
    _, tc = loaded
    pc = port_components(comps)
    for a, b in ((pc.text_encoder, tc.text_encoder), (pc.unet, tc.unet),
                 (pc.vae, tc.vae)):
        sa, sb = a.state_dict(), b.state_dict()
        assert list(sa) == list(sb)
        assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_load_pipeline_needs_weights(tmp_path):
    (tmp_path / "tokenizer").mkdir()
    tloader.build_tiny_pipeline(device="cpu").tokenizer.save_pretrained(
        tmp_path / "tokenizer")
    (tmp_path / "text_encoder").mkdir()
    with pytest.raises(FileNotFoundError):
        tloader.load_pipeline(tmp_path, device="cpu")


def test_save_pipeline_round_trip(tmp_path):
    comps = tloader.build_tiny_pipeline(seed=3, words=["zebra"], device="cpu")
    back = tloader.load_pipeline(tloader.save_pipeline(comps, tmp_path),
                                 dtype=torch.float32, device="cpu")
    for a, b in ((comps.text_encoder, back.text_encoder),
                 (comps.unet, back.unet), (comps.vae, back.vae)):
        assert a.config == b.config
        sa, sb = a.state_dict(), b.state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    text = "a zebra painting by w3"
    assert comps.tokenizer.encode(text) == back.tokenizer.encode(text)


def test_build_tiny_pipeline_is_seeded():
    a = tloader.build_tiny_pipeline(seed=0, device="cpu")
    b = tloader.build_tiny_pipeline(seed=0, device="cpu")
    c = tloader.build_tiny_pipeline(seed=1, device="cpu")
    wa, wb, wc = (dict(x.unet.named_parameters())["conv_in.weight"]
                  for x in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    assert a.vae_scale == 2 and a.unet.config.sample_size == 8


@pytest.fixture(scope="module")
def pair():
    comps = jloader.build_tiny_pipeline(seed=0, words=TINY_WORDS)
    return comps, port_components(comps)


def test_decode_and_encode_match_jax(pair):
    comps, pc = pair
    r = np.random.RandomState(4)
    lat = r.randn(2, 8, 8, 4).astype(np.float32)
    ref = jpipe.decode_latents(comps, jnp.asarray(lat))
    got = tpipe.decode_latents(pc, torch.from_numpy(lat))
    assert got.dtype == np.uint8 and got.shape == ref.shape == (2, 16, 16, 3)
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    enc_ref = jpipe.encode_images(comps, ref)
    enc = tpipe.encode_images(pc, ref)
    assert rel_diff(enc_ref, enc) <= TOL
    drawn = tpipe.encode_images(pc, ref, generator=torch.Generator()
                                .manual_seed(0))
    assert drawn.shape == enc.shape and not torch.equal(drawn, enc)


def test_generate_matches_jax(pair, monkeypatch):
    comps, pc = pair
    prompts, seeds = ["a photo of a cat", "w1 painting by w2"], [0, 1]
    lat0 = np.random.RandomState(5).randn(2, 8, 8, 4).astype(np.float32)
    monkeypatch.setattr(jpipe, "initial_latents",
                        lambda *a, **k: jnp.asarray(lat0))
    kw = dict(num_inference_steps=3, height=16, width=16, sampler="dpm++")
    ref = jpipe.generate(comps, prompts, seeds, **kw)
    got = tpipe.generate(pc, prompts, seeds, latents=torch.from_numpy(lat0),
                         **kw)
    assert got.dtype == np.uint8 and got.shape == (2, 16, 16, 3)
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def test_generate_batch_cap_keeps_images(pair, monkeypatch):
    """EMCID_TPU_GEN_BATCH caps the chunk; per-image seeds keep the images."""
    _, pc = pair
    prompts, seeds = ["a cat", "a dog", "w1"], [3, 4, 5]
    kw = dict(num_inference_steps=2, height=16, width=16, sampler="ddim")
    whole = tpipe.generate(pc, prompts, seeds, **kw)
    monkeypatch.setenv("EMCID_TPU_GEN_BATCH", "2")
    capped = tpipe.generate(pc, prompts, seeds, **kw)
    assert np.abs(whole.astype(int) - capped.astype(int)).max() <= 1
    # a two-entry mesh pads each capped chunk to a multiple of 2
    from emcid_torch.parallel import get_mesh

    sharded = tpipe.generate(pc, prompts, seeds, mesh=get_mesh(["cpu"] * 2),
                             **kw)
    assert np.abs(whole.astype(int) - sharded.astype(int)).max() <= 1


REQUESTS = [
    {"prompts": ["a photo of a {}", "an image of a {}"], "source": "cat",
     "dest": "dog", "seed_train": 0},
    {"prompts": ["a photo of a {}", "an image of a {}"], "source": "w1",
     "dest": "w2", "seed_train": 1},
]


def _instruction(tmp_path, model_ckpt="sd-v1.4"):
    import emcid_torch.hparams as thp

    hp = thp.EMCIDHyperParams.from_dict({
        "layers": [1, 2], "clamp_norm_factor": 1.5,
        "layer_selection": "all", "fact_token": "subject_last",
        "v_num_grad_steps": 3, "v_lr": 0.2, "v_weight_decay": 5e-4,
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
    hp_dir = tmp_path / "hparams"
    hp_dir.mkdir()
    name = hp.to_json(hp_dir).stem
    path = tmp_path / "run.json"
    path.write_text(json.dumps({
        "requests": REQUESTS, "hparams": name, "model_ckpt": model_ckpt,
        "val_prompts": ["a photo of a cat", "w1 painting"],
        "out_dir": str(tmp_path / "out"), "sample_num": 1}))
    return path, hp_dir, hp


@pytest.mark.parametrize("knobs", [{}, {"EMCID_TPU_FUSED_GN": "1",
                                        "EMCID_TPU_FUSED_LN": "1"}])
def test_cli_tiny_cpu_end_to_end(tmp_path, monkeypatch, knobs):
    """``--tiny --platform cpu``: pre- and post-edit images written, and
    only the fc2 weights of the edited layers change."""
    from PIL import Image

    from emcid_torch.cli import run_emcid

    for k in ("EMCID_TPU_FUSED_GN", "EMCID_TPU_FUSED_LN"):
        monkeypatch.delenv(k, raising=False)
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    path, hp_dir, hp = _instruction(tmp_path)
    timings = {}
    edited, deltas = run_emcid.main(
        ["--instruction_path", str(path), "--tiny", "--platform", "cpu",
         "--steps", "2", "--sampler", "dpm++", "--hparams_dir", str(hp_dir),
         "--stats_dir", str(tmp_path / "stats"), "--seed", "7", "--no-mesh"],
        timings=timings)
    assert set(timings) == {"pre_edit_generation", "covariances",
                            "generation", "stage1", "stage2",
                            "post_edit_generation"}
    for phase in ("pre_edit", "post_edit"):
        files = sorted(p.name for p in (tmp_path / "out" / phase).iterdir())
        assert files == ["prompt0_seed7.png", "prompt1_seed7.png"]
        img = np.asarray(Image.open(tmp_path / "out" / phase / files[0]))
        assert img.dtype == np.uint8 and img.shape == (16, 16, 3)
    assert all(np.isfinite(a).all() and np.isfinite(r).all()
               for a, r in deltas.values())
    words = [w for r in REQUESTS for w in (r["source"], r["dest"])]
    before = dict(tloader.build_tiny_pipeline(seed=7, words=words,
                                              device="cpu")
                  .text_encoder.named_parameters())
    changed = {k for k, v in edited.text_encoder.named_parameters()
               if not torch.equal(v, before[k])}
    assert changed == {f"text_model.encoder.layers.{i}.mlp.fc2.weight"
                       for i in hp.layers}


def test_cli_refuses_what_it_cannot_run(tmp_path, monkeypatch):
    """Without --platform the CLI wants the card and raises when there is
    none (no silent CPU fallback), for the SD and the SDXL legs alike; an
    unknown model_ckpt exits.  (The SDXL leg's run on the CPU is
    ``tests/test_torch_sdxl.py::test_cli_sdxl_tiny``.)"""
    from emcid_torch.cli import run_emcid

    path, hp_dir, _ = _instruction(tmp_path, model_ckpt="sd-v2")
    with pytest.raises(SystemExit, match="unknown model_ckpt"):
        run_emcid.main(["--instruction_path", str(path), "--tiny",
                        "--platform", "cpu", "--hparams_dir", str(hp_dir)])
    if torch.cuda.is_available():
        return
    for model_ckpt in ("sd-v1.4", "sdxl-1.0"):
        sd = json.loads(path.read_text())
        sd["model_ckpt"] = model_ckpt
        path.write_text(json.dumps(sd))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_emcid.main(["--instruction_path", str(path), "--tiny",
                            "--hparams_dir", str(hp_dir)])

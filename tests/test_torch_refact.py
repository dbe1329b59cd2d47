"""PyTorch port, the RoAD/TIMED single-concept benchmark
(``evals/refact_benchmark``) against the JAX package: the per-request
edit -> generate -> restore loop ``emcid_test`` (its image layout, with
``generate`` replaced in both packages by one numpy function of the prompt
and the edit by a recorder), the oracle branch, ``eval_all``'s JSON
records and per-concept CSV from the same CLIP weights, the contrast
branch (the CLIP-joint edit) end to end in both packages on the same
covariance files, and the restore: the base text encoder unchanged bit for
bit after two real edits.

Tolerances: the records and CSVs exactly (each score is a share of 0/1
votes over softmax comparisons); the contrast edit's fc2 weights at 1e-4
(relative Frobenius; two Adam steps of ``compute_z_refact``, held at 1e-4
in ``test_torch_debias``).  Image seeds differ by design: the JAX package
takes Python's process-salted ``hash`` of the prompt, the port CRC-32
(``eval_seed``); the stub ignores seeds, and a test shows the port's seed
is the same in two processes with different ``PYTHONHASHSEED``.
"""

import json
import os
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import emcid_tpu.engine.editor as jeditor
import emcid_tpu.evals.refact_benchmark as jrb
from emcid_tpu.models.loader import build_tiny_pipeline

import emcid_torch.engine.editor as teditor
import emcid_torch.evals.refact_benchmark as trb

from test_torch_iceb import fake_generate
from test_torch_scorers import _clip_pair

from torch_parity import (  # noqa: F401
    one_torch_thread,
    port_components,
    rel_diff,
    write_eval_tree,
)

REPO = Path(__file__).resolve().parent.parent
WORDS = ["cat", "dog", "w12", "w13", "w14", "w15", "w16", "w17"]


def _hp(pkg, **over):
    return pkg.EMCIDHyperParams.from_dict({
        "layers": [2, 3], "clamp_norm_factor": 1.5,
        "layer_selection": "all", "fact_token": "subject_last",
        "v_num_grad_steps": 2, "v_lr": 0.1, "v_weight_decay": 5e-4,
        "mom2_adjustment": True, "mom2_update_weight": 100,
        "rewrite_module_tmp": "text_model.encoder.layers.{}.mlp.fc2",
        "layer_module_tmp": "text_model.encoder.layers.{}",
        "mlp_module_tmp": "text_model.encoder.layers.{}.mlp",
        "attn_module_tmp": "text_model.encoder.layers.{}.self_attn",
        "ln_f_module": "text_model.final_layer_norm",
        "mom2_dataset": "ccs_filtered", "mom2_n_samples": 30,
        "mom2_dtype": "float32", "objective": "ablate-dest",
        "esd_mu": "None", **over})


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    data = write_eval_tree(tmp_path_factory.mktemp("refact") / "data")
    comps = build_tiny_pipeline(seed=0, words=WORDS)
    tclip, jclip = _clip_pair()
    return data, comps, port_components(comps), tclip, jclip


def _requests(data, dataset):
    from emcid_tpu.dsets import TIMEDRoadRequestDataset as J

    from emcid_torch.dsets import TIMEDRoadRequestDataset as T

    reqs = T(dataset, data_dir=data).requests
    assert reqs == J(dataset, data_dir=data).requests
    return reqs


def _files(folder):
    return {str(p.relative_to(folder)): p.read_bytes()
            for p in sorted(Path(folder).rglob("*")) if p.is_file()}


@pytest.mark.parametrize("oracle", [False, True], ids=["emcid", "oracle"])
@pytest.mark.parametrize("dataset", ["timed", "road"])
def test_loop_and_eval_all_match_jax(world, tmp_path, monkeypatch, dataset,
                                     oracle):
    """``emcid_test`` with the edit recorded (one edit per request, none
    for the oracle), then ``eval_all``: the same image files (names and
    bytes), the same F1, JSON record (under ``weight{W}``) and CSV bytes
    in both packages."""
    data, comps, pc, tclip, jclip = world
    import emcid_tpu.hparams as jhp
    import emcid_torch.hparams as thp

    reqs = _requests(data, dataset)
    edits = {"jax": [], "torch": []}

    def gen(components, prompts, seeds, **kwargs):
        return fake_generate(components, prompts, [0] * len(prompts))

    for side, rb, ed in (("jax", jrb, jeditor), ("torch", trb, teditor)):
        monkeypatch.setattr(rb, "generate", gen)
        monkeypatch.setattr(
            ed, "apply_emcid",
            lambda c, r, h, _s=side, **k: edits[_s].append(
                [q["source"] for q in r]) or (c, {}))
    out = {}
    for side, rb, c, hp, clip in (
            ("jax", jrb, comps, _hp(jhp), jclip),
            ("torch", trb, pc, _hp(thp), tclip)):
        root = tmp_path / side
        rb.emcid_test(c, reqs, hp, "hp", dataset, mom2_weight=100,
                      edit_weight=0.5, oracle=oracle, results_dir=str(root),
                      verbose=False)
        f1 = rb.eval_all(clip, reqs, dataset, "hp", 100, oracle=oracle,
                         results_dir=str(root))
        suffix = "oracle" if oracle else "emcid"
        rdir = root / "emcid" / "hp"
        out[side] = (f1, _files(root / "images"),
                     json.loads((rdir / f"{dataset}_results_{suffix}.json")
                                .read_text()),
                     (rdir / f"{dataset}_results_{suffix}.csv").read_bytes())
    assert edits["jax"] == edits["torch"] == (
        [] if oracle else [[r["source"]] for r in reqs])
    assert out["jax"] == out["torch"]
    f1, images, record, _ = out["torch"]
    assert np.isfinite(f1) and set(record) == {"weight100"}
    assert len(images) == 11 * len(reqs)
    key = "old" if dataset == "timed" else "prompt"
    src = reqs[0]["row"]["new" if oracle else key]
    folder = ("oracle/" if oracle else "hp_w100/emcid/") + \
        f"source_{reqs[0]['row'][key]}_dest_{reqs[0]['row']['new']}"
    assert f"{dataset}/{folder}/{src}/seed_0.png" in images


def test_eval_seed_is_the_same_in_every_process():
    """The port's image seed repeats across processes (CRC-32 of the
    prompt): a process with ``PYTHONHASHSEED=1`` gives this one's; the JAX
    package's ``hash(prompt) % 997`` differs between two salts."""
    prompt = "a photo of a cat w1"

    def run(code, salt):
        env = dict(os.environ, PYTHONHASHSEED=salt)
        return int(subprocess.run([sys.executable, "-c", code], env=env,
                                  capture_output=True, text=True, cwd=REPO,
                                  check=True).stdout)

    port = ("from emcid_torch.evals.refact_benchmark import eval_seed; "
            f"print(eval_seed(3, {prompt!r}))")
    assert run(port, "1") == trb.eval_seed(3, prompt) == \
        3 * 1000003 + zlib.crc32(prompt.encode()) % 997
    salted = f"print(hash({prompt!r}) % 997)"
    assert run(salted, "1") != run(salted, "2")


def _fc2(text_params_or_module, layer):
    if isinstance(text_params_or_module, torch.nn.Module):
        return text_params_or_module.get_submodule(
            f"text_model.encoder.layers.{layer}.mlp.fc2").weight.numpy()
    return np.asarray(text_params_or_module[f"layers_{layer}"]["mlp"]["fc2"]
                      ["kernel"]).T


def test_contrast_branch_matches_jax(world, tmp_path, monkeypatch):
    """``method="contrast"`` (``execute_emcid_clip`` on the pipeline's text
    encoder) on two TIMED requests, both packages reading the same seeded
    covariance files: the text encoder each request's images come from has
    the same edit-layer fc2 weights in both (1e-4); the other layers and
    the base encoder unchanged."""
    import emcid_tpu.hparams as jhp
    from emcid_tpu.engine.layer_stats import COV_CACHE

    import emcid_torch.hparams as thp
    from emcid_torch.engine.layer_stats import stats_filename
    from emcid_torch.stats import CombinedStat, SecondMoment, save_cached_state

    data, comps, pc, _, _ = world
    reqs = _requests(data, "timed")
    r = np.random.RandomState(5)
    for layer in (2, 3):
        stat = CombinedStat(mom2=SecondMoment())
        stat.add(torch.from_numpy(r.randn(512, 64).astype(np.float32)))
        save_cached_state(stats_filename(
            tmp_path / "stats", "clip_text", "ccs_filtered",
            f"text_model.encoder.layers.{layer}.mlp.fc2", sample_size=30),
            stat, {"sample_size": 30})
    seen = {"jax": [], "torch": []}
    for side, rb in (("jax", jrb), ("torch", trb)):
        def gen(components, prompts, seeds, _s=side, **kwargs):
            text = (components.text_params if _s == "jax"
                    else components.text_encoder)
            seen[_s].append({i: _fc2(text, i) for i in range(4)})
            return fake_generate(components, prompts, seeds)

        monkeypatch.setattr(rb, "generate", gen)
    COV_CACHE.clear()
    before = {k: v.clone() for k, v in pc.text_encoder.state_dict().items()}
    for side, rb, c, hp in (("jax", jrb, comps, _hp(jhp)),
                            ("torch", trb, pc, _hp(thp))):
        rb.emcid_test(c, reqs, hp, "hp", "timed", method="contrast",
                      results_dir=str(tmp_path / side),
                      apply_kwargs=dict(stats_dir=tmp_path / "stats"),
                      verbose=False)
    COV_CACHE.clear()
    assert len(seen["jax"]) == len(seen["torch"]) == 2
    for j, t in zip(seen["jax"], seen["torch"]):
        for i in range(4):
            assert rel_diff(j[i], t[i], "fro") <= 1e-4, i
            base = before[f"text_model.encoder.layers.{i}.mlp.fc2.weight"]
            assert (i in (2, 3)) != np.array_equal(t[i], base.numpy()), i
    for k, v in pc.text_encoder.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_restore_leaves_the_base_encoder_bit_for_bit(world, tmp_path,
                                                     monkeypatch):
    """Two real EMCID edits on the port's tiny pipeline (2 Stage-1 steps,
    the synthetic-corpus covariances): each request's images come from an
    encoder whose edit-layer fc2 weights changed, and after the loop the
    shared components are the ones passed in, with every text-encoder
    tensor equal bit for bit."""
    import emcid_torch.hparams as thp

    data, _, pc, _, _ = world
    reqs = _requests(data, "timed")
    seen = []

    def gen(components, prompts, seeds, **kwargs):
        seen.append((components.text_encoder,
                     {i: _fc2(components.text_encoder, i) for i in (0, 2)}))
        return fake_generate(components, prompts, seeds)

    monkeypatch.setattr(trb, "generate", gen)
    before = {k: v.clone() for k, v in pc.text_encoder.state_dict().items()}
    unet, vae = pc.unet, pc.vae
    trb.emcid_test(pc, reqs, _hp(thp), "hp", "timed",
                   results_dir=str(tmp_path),
                   gen_kwargs=dict(num_inference_steps=2, height=16,
                                   width=16),
                   apply_kwargs=dict(stats_dir=tmp_path / "stats",
                                     num_inference_steps=2),
                   verbose=False)
    assert len(seen) == 2
    base0 = before["text_model.encoder.layers.0.mlp.fc2.weight"].numpy()
    base2 = before["text_model.encoder.layers.2.mlp.fc2.weight"].numpy()
    for text, w in seen:
        assert text is not pc.text_encoder
        assert np.array_equal(w[0], base0) and not np.array_equal(w[2], base2)
    assert pc.unet is unet and pc.vae is vae
    for k, v in pc.text_encoder.state_dict().items():
        assert torch.equal(v, before[k]), k

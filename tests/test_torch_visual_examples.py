"""PyTorch port, the qualitative figures (``emcid_torch/cli/visual_examples``)
against the JAX package.

Tolerances: ``image_grid`` equal to JAX's (exactly); each mode at
``--tiny`` (the port on ``--platform cpu``) with ``generate`` and the edits
stubbed in both packages: the same file names under ``--out_dir``, the
same request lists handed to the edits and the same prompts and seeds
handed to ``generate`` (exactly); ``nudity_uce`` without ``--tiny`` and
without the I2P file raises in both; ``--platform`` defaults to ``cuda``.
"""

import json

import numpy as np
import pytest

from emcid_tpu.cli import visual_examples as jve

from emcid_torch.cli import visual_examples as tve

from torch_parity import one_torch_thread  # noqa: F401

TINY_HP = {
    "layers": [2, 3], "clamp_norm_factor": 1.5, "layer_selection": "all",
    "fact_token": "subject_last", "v_num_grad_steps": 4, "v_lr": 0.1,
    "v_weight_decay": 5e-4, "mom2_adjustment": True,
    "mom2_update_weight": 100,
    "rewrite_module_tmp": "text_model.encoder.layers.{}.mlp.fc2",
    "layer_module_tmp": "text_model.encoder.layers.{}",
    "mlp_module_tmp": "text_model.encoder.layers.{}.mlp",
    "attn_module_tmp": "text_model.encoder.layers.{}.self_attn",
    "ln_f_module": "text_model.final_layer_norm",
    "mom2_dataset": "ccs_filtered", "mom2_n_samples": 30,
    "mom2_dtype": "float32", "objective": "ablate-dest", "esd_mu": "None",
}

MODES = {
    "single": ["--example", "van_gogh"],
    "artists_grid": ["--artists", "w3", "w5"],
    "artist_holdout": ["--artists", "w1", "w2", "w3", "--holdout_artist",
                       "w1", "--edit_nums", "1,2"],
    "debias_grid": ["--professions", "doctor", "--max_iter", "1"],
    "nudity_uce": ["--edit_part", "cross_attn"],
    "nudity_uce_text": ["--edit_part", "text_encoder"],
}


@pytest.mark.parametrize("shape", [(5, 4, 6, 3), (4, 3, 3, 1)])
@pytest.mark.parametrize("cols", [1, 2, 3])
def test_image_grid_matches_jax(shape, cols):
    imgs = np.random.RandomState(0).randint(0, 256, shape).astype(np.uint8)
    np.testing.assert_array_equal(tve.image_grid(imgs, cols),
                                  jve.image_grid(imgs, cols))


def _stubs(monkeypatch, pkg, calls):
    """Record what each mode hands to ``generate`` and to the edits."""
    import importlib

    pipe = importlib.import_module(f"{pkg}.models.pipeline")
    editor = importlib.import_module(f"{pkg}.engine.editor")
    debias = importlib.import_module(f"{pkg}.engine.debias")
    uce = importlib.import_module(f"{pkg}.engine.uce")
    workflows = importlib.import_module(f"{pkg}.cli.workflows")

    def generate(comps, prompts, seeds, **kw):
        calls.append(("generate", list(prompts), [int(s) for s in seeds]))
        return np.zeros((len(prompts), 16, 16, 3), np.uint8) + len(calls)

    def apply_emcid(comps, requests, hparams, **kw):
        calls.append(("apply_emcid", json.dumps(list(requests))))
        return comps, {}

    def debias_edit(comps, requests, hparams, scorer, **kw):
        calls.append(("debias", json.dumps(list(requests)),
                      kw["max_iter"], kw["num_samples"]))
        return comps, {}, [[0.5, 0.5] for _ in requests]

    def uce_edit(name):
        def edit(comps, old, new, *a, **kw):
            calls.append((name, list(old), list(new),
                          list(kw["retain_texts"]), kw["lamb"]))
            return comps
        return edit

    monkeypatch.setattr(pipe, "generate", generate)
    monkeypatch.setattr(editor, "apply_emcid", apply_emcid)
    monkeypatch.setattr(debias, "apply_emcid_to_text_encoder_debias",
                        debias_edit)
    monkeypatch.setattr(uce, "edit_model_uce", uce_edit("uce_unet"))
    monkeypatch.setattr(uce, "edit_text_encoder_uce", uce_edit("uce_text"))
    monkeypatch.setattr(workflows, "_clip_scorer", lambda args, comps: None)


@pytest.fixture(scope="module")
def hp_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("hp")
    (d / "tiny.json").write_text(json.dumps(TINY_HP))
    return d


@pytest.mark.parametrize("mode", sorted(MODES))
def test_modes_match_jax(tmp_path, monkeypatch, hp_dir, mode):
    files, calls = {}, {}
    for name, mod, extra in (("jax", jve, []),
                             ("port", tve, ["--platform", "cpu"])):
        calls[name] = []
        with monkeypatch.context() as m:
            _stubs(m, "emcid_tpu" if name == "jax" else "emcid_torch",
                   calls[name])
            out = tmp_path / name
            mod.main(["--mode", mode.replace("_text", ""), *MODES[mode],
                      "--tiny", "--hparam", "tiny", "--hparams_dir",
                      str(hp_dir), "--sample_num", "2", "--steps", "2",
                      "--out_dir", str(out), *extra])
        files[name] = sorted(str(p.relative_to(out))
                             for p in out.rglob("*") if p.is_file())
    assert files["port"] == files["jax"] and files["port"]
    assert calls["port"] == calls["jax"]


def test_nudity_uce_raises_without_i2p_files(tmp_path):
    """Without ``--tiny``, absent I2P files raise in both packages."""
    from emcid_tpu.cli.visual_examples import run_nudity_uce as jrun

    for run in (jrun, tve.run_nudity_uce):
        args = tve.build_parser().parse_args(["--mode", "nudity_uce"])
        args.data_dir = str(tmp_path)
        with pytest.raises((FileNotFoundError, OSError)):
            run(args, None, None, {})


def test_platform_defaults_to_cuda():
    args = tve.build_parser().parse_args(["--example", "van_gogh"])
    assert args.platform == "cuda"

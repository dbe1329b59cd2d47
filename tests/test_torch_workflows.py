"""PyTorch port, ``emcid_torch.cli.workflows``: the ``aice``, ``mend``,
``debias``, ``road``, ``timed``, ``artists``, ``coco``, ``i2p`` and
``layer_stats`` subcommands with ``--tiny --platform cpu`` on a synthetic
request tree write their outputs under the JAX CLI's paths (the summary
JSONs; the debias edits' factors and ratios; the benchmark images; the
FID; the nudity counts; the covariance caches); without ``--platform
cpu`` on a host with no card each raises; ``certify_levers`` stays in the
parser and raises ``NotImplementedError`` naming its ROADMAP item, and the
subcommands that waited with it before (``plots``, ``sequential``,
``validate``, ``validate_openclip``) reach their own code."""

import csv
import json

import numpy as np
import pytest
import torch

from emcid_torch.cli import workflows
from emcid_torch.evals.scorers import make_vit_scorer

from torch_parity import one_torch_thread, write_eval_tree  # noqa: F401

HP = "tiny-hp"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """ICEB edit/test files, the mend files, a 2-row TIMED gender CSV and
    an hparams JSON, in the parsers' formats."""
    from emcid_torch.hparams import EMCIDHyperParams

    root = tmp_path_factory.mktemp("wf")
    iceb = root / "data" / "iceb_data"
    iceb.mkdir(parents=True)
    rows, idx = [], 0
    for cls, cid, dest, did in [("cat", 0, "dog", 1), ("w3", 2, "w4", 3)]:
        for _ in range(5):
            rows.append({"class name": cls,
                         "text prompt": f"an image of a {{}} v{idx}",
                         "random seed": 100 + idx, "idx": idx,
                         "class id": cid, "checked": True, "dest": dest,
                         "dest id": did})
            idx += 1
    (iceb / "imgnet_aug_edit.json").write_text(json.dumps(rows))
    (iceb / "imgnet_aug_test.json").write_text(json.dumps(
        [{"class name": "w9", "text prompt": f"a photo of w9 n{i}",
          "random seed": 55 + i, "idx": i, "class id": 5} for i in range(3)]))
    (iceb / "vit_classifier_config.json").write_text(json.dumps(
        {"id2label": {"0": "cat, kitty", "2": "w3"}}))
    (iceb / "imgnet_prompts_cls.json").write_text(json.dumps(
        {"0": {"cat": {"mean": 0.8, "std": 0.1, "number": 8},
               "kitty": {"mean": 0.05, "std": 0.01, "number": 8}}}))
    (iceb / "imgnet_aug_full.json").write_text(json.dumps(
        [{"class name": "cat", "text prompt": f"an image of cat {i}",
          "random seed": 100 + i, "idx": i, "class id": 0}
         for i in range(3)]))
    deb = root / "data" / "debias"
    deb.mkdir()
    with open(deb / "TIMED_gender_test_set_processed.csv", "w",
              newline="") as f:
        w = csv.DictWriter(f, fieldnames=["female", "male", "old", "new",
                                          "validation", "ex1", "ex2", "ex3",
                                          "ex4", "ex5"])
        w.writeheader()
        for p in ("nurse", "doctor"):
            w.writerow({"female": f"a female {p}", "male": f"a male {p}",
                        "old": f"a {p}", "new": f"a female {p}",
                        "validation": f"A photo of a {p}",
                        **{f"ex{i}": f"a {p} {i}" for i in range(1, 6)}})
    hp = EMCIDHyperParams.from_dict({
        "layers": [9, 10], "clamp_norm_factor": 1.5,
        "layer_selection": "all", "fact_token": "subject_last",
        "v_num_grad_steps": 20, "v_lr": 0.1, "v_weight_decay": 5e-4,
        "mom2_adjustment": True, "mom2_update_weight": 100,
        "rewrite_module_tmp": "text_model.encoder.layers.{}.mlp.fc2",
        "layer_module_tmp": "text_model.encoder.layers.{}",
        "mlp_module_tmp": "text_model.encoder.layers.{}.mlp",
        "attn_module_tmp": "text_model.encoder.layers.{}.self_attn",
        "ln_f_module": "text_model.final_layer_norm",
        "mom2_dataset": "ccs_filtered", "mom2_n_samples": 30,
        "mom2_dtype": "float32", "objective": "ablate-dest",
        "esd_mu": "None"})
    (root / "hparams").mkdir()
    (root / "hparams" / f"{HP}.json").write_text(
        hp.to_json(root / "hparams").read_text())
    write_eval_tree(root / "data")
    return root


def _argv(tree, tmp_path, cmd, *extra, platform="cpu"):
    argv = [cmd, "--tiny", "--hparam", HP,
            "--hparams_dir", str(tree / "hparams"),
            "--data_dir", str(tree / "data"),
            "--cache_dir", str(tmp_path / "cache"),
            "--results_dir", str(tmp_path / "results"),
            "--stats_dir", str(tmp_path / "stats"), "--steps", "2", *extra]
    return argv + (["--platform", platform] if platform else [])


def test_aice_tiny_cpu_writes_summary(tree, tmp_path):
    """Edits remapped into the tiny encoder's depth (layers 2-3, 4 Stage-1
    steps at most), one record per --edit_nums entry under its key."""
    timings = {}
    records = workflows.main(_argv(tree, tmp_path, "aice", "--edit_nums",
                                   "2,1"), timings=timings)
    summary = json.loads((tmp_path / "results" / "emcid" / HP
                          / "imgnet_aug_summary.json").read_text())
    assert set(summary) == {"edit2_weight100", "edit1_weight100"}
    assert [summary["edit2_weight100"], summary["edit1_weight100"]] == records
    for rec in records:
        assert len([k for k in rec if k.startswith(("pre_", "post_"))]) == 20
        assert rec["edit_time_s"] > 0
    assert {"load", "pre_edit_eval", "edit", "post_edit_eval", "generation",
            "scoring"} <= set(timings)
    assert any(p.name.startswith("train_cat_pre_") for p in
               (tmp_path / "cache" / "images" / "imgnet_aug").glob("*.png"))


@pytest.mark.parametrize("method,folder,key", [
    ("emcid", f"emcid/{HP}", "edit2_weight100"),
    ("uce", "baselines/uce", "edit2")])
def test_mend_tiny_cpu_writes_summary(tree, tmp_path, method, folder, key):
    record = workflows.main(_argv(tree, tmp_path, "mend", "--method", method,
                                  "--num_edit", "2"))
    path = tmp_path / "results" / folder / "imgnet_mend_summary.json"
    assert json.loads(path.read_text())[key] == record
    assert len([k for k in record if k.startswith(("pre_", "post_"))]) == 10


def test_debias_emcid_tiny_cpu(tree, tmp_path, capsys):
    edited, deltas, factors = workflows.main(_argv(
        tree, tmp_path, "debias", "--method", "emcid", "--num_requests", "1",
        "--max_iter", "2", "--num_samples", "2"))
    assert len(factors) == 1 and abs(sum(factors[0]) - 1.0) <= 1e-9
    assert set(deltas) == {f"text_model.encoder.layers.{i}.mlp.fc2.weight"
                           for i in (2, 3)}
    assert "factors:" in capsys.readouterr().out
    assert list((tmp_path / "cache" / HP / "debias").glob("*.npz"))


def test_debias_uce_tiny_cpu(tree, tmp_path, capsys):
    edited, weights, init_ratios, ratios = workflows.main(_argv(
        tree, tmp_path, "debias", "--method", "uce", "--num_requests", "2",
        "--max_iter", "2", "--num_samples", "2"))
    assert len(init_ratios) == len(ratios) == 2
    for r in ratios:
        assert np.isclose(r.sum(), 1.0)
    out = capsys.readouterr().out
    assert "init ratios:" in out and "final ratios:" in out


@pytest.mark.parametrize("cmd", ["aice", "mend", "debias", "road", "timed",
                                 "artists", "coco", "i2p", "layer_stats"])
def test_default_platform_wants_the_card(tree, tmp_path, cmd):
    """``--tiny`` does not switch to the CPU: the default platform is the
    card, and with none present the subcommand raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default platform would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        workflows.main(_argv(tree, tmp_path, cmd, platform=None))


# the subcommands that waited for a later slice; none waits now
FORMERLY_WAITING = ["certify_levers", "plots", "sequential", "validate",
                    "validate_openclip"]


@pytest.mark.parametrize("cmd", FORMERLY_WAITING)
def test_other_subcommands_name_their_roadmap_item(tree, tmp_path, cmd):
    """Every formerly waiting subcommand reaches its own code (a figure
    written, or its own error for the missing input), and the module keeps
    no list of waiting subcommands."""
    argv = [cmd]
    if cmd == "plots":
        pytest.importorskip("matplotlib")
        argv += ["--figure", "coco", "--out", str(tmp_path / "f.png")]
    elif cmd == "validate_openclip":
        argv += ["--checkpoint", str(tmp_path / "c.pt"),
                 "--goldens", "g.npz", "--platform", "cpu"]
    elif cmd in ("certify_levers", "sequential", "validate"):  # no source
        argv += ["--hparam", HP, "--hparams_dir", str(tree / "hparams"),
                 "--platform", "cpu"]
    if cmd == "plots":
        assert workflows.main(argv) == tmp_path / "f.png"
        assert (tmp_path / "f.png").exists()
    elif cmd == "validate_openclip":
        with pytest.raises(FileNotFoundError):
            workflows.main(argv)
    else:
        with pytest.raises(SystemExit, match="--tiny"):
            workflows.main(argv)
    assert not hasattr(workflows, "WAITING")


def test_scorer_checkpoints_load(tmp_path, monkeypatch):
    """``--vit_checkpoint`` and ``--clip_checkpoint`` take HF state dicts
    saved with ``torch.save`` (here at tiny widths: the ViT-B/16 and
    ViT-L/14 configs are swapped for tiny ones): the loaded scorers give
    the saved towers' outputs."""
    import dataclasses
    from types import SimpleNamespace

    from emcid_torch.models import configs, vision
    from emcid_torch.models.clip_text import CLIPTextEncoder
    from emcid_torch.models.loader import build_tiny_pipeline

    comps = build_tiny_pipeline(seed=0, device="cpu")
    tiny_vit = dataclasses.replace(vision.TINY_VIT, num_labels=1000)
    tiny_clip = dataclasses.replace(vision.TINY_CLIP_VISION,
                                    projection_dim=768)
    monkeypatch.setattr(vision, "VIT_BASE_224", tiny_vit)
    monkeypatch.setattr(vision, "CLIP_VIT_L14_VISION", tiny_clip)
    monkeypatch.setattr(configs, "SD_V14_TEXT", comps.text_encoder.config)

    vit = vision.build_random_vit(tiny_vit, seed=1, device="cpu")
    torch.save(vit.state_dict(), tmp_path / "vit.pt")
    tower = vision.build_random_clip_vision(tiny_clip, seed=2, device="cpu")
    text = CLIPTextEncoder(dataclasses.replace(comps.text_encoder.config,
                                               projection_dim=768))
    torch.save({**tower.state_dict(), **text.state_dict()},
               tmp_path / "clip.pt")

    imgs = np.random.RandomState(0).randint(0, 256, (2, 40, 40, 3)
                                            ).astype(np.uint8)
    scorer = workflows._vit_scorer(
        SimpleNamespace(vit_checkpoint=str(tmp_path / "vit.pt")), "cpu")
    np.testing.assert_array_equal(
        scorer.probs(imgs), make_vit_scorer(
            tiny_vit, torch_state_dict=vit.state_dict(),
            device="cpu").probs(imgs))
    clip = workflows._clip_scorer(SimpleNamespace(
        clip_checkpoint=str(tmp_path / "clip.pt"), tiny=False), comps)
    ref = vision.CLIPScorer(text.eval(), tower, comps.tokenizer)
    texts = ["a photo of a cat", "dog"]
    torch.testing.assert_close(clip.logits_per_image(imgs, texts),
                               ref.logits_per_image(imgs, texts))


@pytest.mark.parametrize("dataset,method", [("timed", "emcid"),
                                            ("road", "contrast")])
def test_refact_tiny_cpu_writes_images(tree, tmp_path, dataset, method):
    """``road``/``timed``: one request edited (EMCID, or the CLIP-joint
    contrast edit), its 11 images at the JAX CLI's paths, then scored by
    ``eval_all`` with a tiny CLIP scorer: a finite F1 in the JSON."""
    from types import SimpleNamespace

    from emcid_torch.evals.refact_benchmark import eval_all
    from emcid_torch.models.loader import build_tiny_pipeline

    reqs = workflows.main(_argv(tree, tmp_path, dataset, "--num_requests",
                                "1", "--method", method))
    assert len(reqs) == 1
    row = reqs[0]["row"]
    key = "old" if dataset == "timed" else "prompt"
    out = (tmp_path / "results" / "images" / dataset / f"{HP}_w100"
           / "emcid" / f"source_{row[key]}_dest_{row['new']}")
    assert len(list(out.rglob("seed_0.png"))) == 11
    scorer = workflows._clip_scorer(
        SimpleNamespace(clip_checkpoint=None, tiny=True),
        build_tiny_pipeline(device="cpu"))
    f1 = eval_all(scorer, reqs, dataset, HP, 100,
                  results_dir=str(tmp_path / "results"))
    record = json.loads((tmp_path / "results" / "emcid" / HP
                         / f"{dataset}_results_emcid.json").read_text())
    assert record["weight100"]["f1_score"] == f1 and np.isfinite(f1)


def test_artists_tiny_cpu_writes_pre_and_post(tree, tmp_path):
    """``artists --num_artists 2``: the 4 eval prompts rendered before and
    after the erase edit, named ``{case}_{seed}.png``."""
    out = workflows.main(_argv(tree, tmp_path, "artists", "--num_artists",
                               "2"))
    assert out == tmp_path / "results" / "images" / "artists" / f"{HP}_n2"
    for phase in ("pre", "post"):
        assert sorted(p.name for p in (out / phase).glob("*.png")) == [
            "0_100.png", "1_101.png", "2_102.png", "3_103.png"]
    assert list((tmp_path / "cache" / HP / "artists").glob("*.npz"))


def test_coco_tiny_cpu_with_fid(tree, tmp_path, monkeypatch):
    """``coco --tag pre --fid_ref_dir``: 3 images at ``{case}.png`` and FID
    against the reference folder through ``make_fid_extractor`` (stubbed
    here with 8-d colour features: the 2048-d square roots are checked on
    the card)."""
    from PIL import Image

    import emcid_torch.models.inception as tinc

    ref = tmp_path / "ref"
    ref.mkdir()
    for i in range(3):
        Image.fromarray(np.full((16, 16, 3), 40 * i, np.uint8)).save(
            ref / f"{i}.png")
    made = []

    def extractor(weights, batch_size, device):
        made.append((weights, batch_size, str(device)))
        return lambda imgs: np.asarray(imgs, np.float64).reshape(
            len(imgs), -1)[:, :8]

    monkeypatch.setattr(tinc, "make_fid_extractor", extractor)
    fid = workflows.main(_argv(tree, tmp_path, "coco", "--tag", "pre",
                               "--batch_size", "2", "--fid_ref_dir",
                               str(ref)))
    out = tmp_path / "results" / "images" / "coco" / "pre"
    assert sorted(p.name for p in out.glob("*.png")) == [
        "0.png", "1.png", "2.png"]
    assert made == [(None, 2, "cpu")] and np.isfinite(fid)
    assert workflows.main(_argv(tree, tmp_path, "coco", "--tag",
                                "pre")) is None


def test_i2p_tiny_cpu_with_the_fake_detector(tree, tmp_path, capsys):
    """``i2p --detector_cmd '<python> scripts/fake_nudenet.py'``: 4 images,
    the detector's CSV and the count summary with the reference keys;
    without a detector the images only, and a hint."""
    import sys
    from pathlib import Path

    from emcid_torch.evals.scorers import NUDENET_EXPOSED_LABELS

    fake = Path(__file__).resolve().parent.parent / "scripts" / \
        "fake_nudenet.py"
    cnt = workflows.main(_argv(tree, tmp_path, "i2p", "--num_requests", "4",
                               "--tag", "t", "--detector_cmd",
                               f"{sys.executable} {fake}"))
    base = tmp_path / "results" / "images" / "i2p"
    assert len(list((base / "t").glob("*.png"))) == 4
    assert (base / "t_nudity.csv").exists()
    saved = json.loads((base / "i2p_nudity_t_cnt.json").read_text())
    assert set(saved) == {*NUDENET_EXPOSED_LABELS, "total"}
    assert cnt["total_images"] == 4 and saved["total"] == cnt["total"]
    assert workflows.main(_argv(tree, tmp_path, "i2p", "--num_requests",
                                "2", "--tag", "u")) is None
    assert "--detector_cmd" in capsys.readouterr().out


def test_layer_stats_tiny_cpu_caches(tree, tmp_path):
    """``layer_stats --layers 2-3 --sample_size 20``: one covariance cache
    per layer at the codec's path; a second call reads them."""
    from emcid_torch.engine.layer_stats import stats_filename

    argv = _argv(tree, tmp_path, "layer_stats", "--layers", "2-3",
                 "--sample_size", "20")
    timings = {}
    stats = workflows.main(argv, timings=timings)
    names = [f"text_model.encoder.layers.{i}.mlp.fc2" for i in (2, 3)]
    assert sorted(stats) == names and {"load", *names} <= set(timings)
    for n in names:
        assert stats_filename(tmp_path / "stats", "text_encoder",
                              "ccs_filtered", n, sample_size=20).exists()
        assert stats[n].mom2.count > 0
    again = workflows.main(argv)
    for n in names:
        assert torch.equal(again[n].mom2.moment(), stats[n].mom2.moment())

"""PyTorch port, the request parsers against the JAX package: every parser
of ``emcid_torch.dsets`` on one synthetic data tree (the reference's file
formats) gives the JAX parser's request lists, compared by equality (the
seed streams are Python's ``random`` and numpy's in both)."""

import csv
import json

import numpy as np
import pytest
import torch

import emcid_tpu.dsets as jd
import emcid_tpu.dsets.construction as jcon
import emcid_tpu.dsets.iceb as jiceb
import emcid_tpu.dsets.global_concepts as jglob
import emcid_tpu.dsets.timed_road as jtimed

import emcid_torch.dsets as td
import emcid_torch.dsets.construction as tcon
import emcid_torch.dsets.iceb as ticeb
import emcid_torch.dsets.global_concepts as tglob
import emcid_torch.dsets.timed_road as ttimed

from torch_parity import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """A synthetic data/ tree with the reference's file schemas."""
    root = tmp_path_factory.mktemp("data")
    iceb = root / "iceb_data"
    iceb.mkdir()
    rows = []
    for idx, (cls, cid, dest, did) in enumerate(
            [("tench", 0, "goldfish", 1)] * 5 + [("axolotl", 2, "newt", 3)] * 5
            + [("cat", 4, "dog", 5)] * 5):
        rows.append({
            "class name": cls, "text prompt": f"A fine image of a {cls} no {idx}",
            "random seed": 1000 + idx, "idx": idx, "class id": cid,
            "checked": idx != 7, "dest": dest, "dest id": did,
        })
    for name in ("imgnet_aug_edit.json", "imgnet_aug_full.json",
                 "imgnet_prompts_aug.json"):
        (iceb / name).write_text(json.dumps(rows))
    (iceb / "imgnet_prompts_cls.json").write_text(json.dumps({
        "0": {"tench": {"mean": 0.8, "std": 0.1, "number": 8},
              "Tinca tinca": {"mean": 0.01, "std": 0.01, "number": 8}},
        "2": {"axolotl": {"mean": 0.7, "std": 0.1, "number": 8},
              "mud puppy": {"mean": 0.05, "std": 0.01, "number": 8}},
        "4": {"cat": {"mean": 0.3, "std": 0.1, "number": 8},
              "kitty": {"mean": 0.02, "std": 0.01, "number": 8}},
    }))
    (iceb / "vit_classifier_config.json").write_text(json.dumps({"id2label": {
        "0": "tench, Tinca tinca", "1": "goldfish", "2": "axolotl",
        "3": "newt", "4": "cat, kitty, puss", "5": "dog"}}))
    (root / "ccs_filtered_sub.json").write_text(json.dumps(
        [{"caption": f"caption {i}", "path": ""} for i in range(6)]))

    dream = root / "dream_booth_dataset"
    for obj in ("dog2", "cat7"):
        (dream / obj).mkdir(parents=True)
        for i in range(4):
            (dream / obj / f"{i:02d}.jpg").write_bytes(b"")
    (dream / "prompts_and_classes.txt").write_text(
        "dog2, dog\ncat7, cat\n")

    art = root / "artists" / "info"
    art.mkdir(parents=True)
    (art / "erased-2artists-towards_art-preserve_true-sd_1_4-method_replace"
     ".txt").write_text(json.dumps(["Pablo Picasso", "Frank Stella"]))
    pd = root / "artists" / "prompts_dir"
    pd.mkdir()
    with open(pd / "erased-2artists-towards_art-preserve_true-sd_1_4-"
              "method_replace.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["", "case_number", "prompt", "evaluation_seed", "artist",
                    "type"])
        w.writerow([0, 0, "Image in the style of Pablo Picasso", 3241,
                    "Pablo Picasso", "erased"])
        w.writerow([1, 1, "Art inspired by Some Other", 4725, "Some Other",
                    "holdout"])

    deb = root / "debias"
    deb.mkdir()
    with open(deb / "TIMED_gender_test_set_processed.csv", "w",
              newline="") as f:
        w = csv.DictWriter(f, fieldnames=[
            "female", "male", "old", "new", "validation",
            "ex1", "ex2", "ex3", "ex4", "ex5"])
        w.writeheader()
        for p in ("nurse", "doctor", "pilot"):
            w.writerow({"female": f"a female {p}", "male": f"a male {p}",
                        "old": f"a {p}", "new": f"a female {p}",
                        "validation": f"A photo of a {p}",
                        **{f"ex{i}": f"a {p} {i}" for i in range(1, 6)}})

    timed = root / "timed"
    timed.mkdir()
    fields = ["old", "new"]
    for i in range(1, 6):
        fields += [f"positive{i}", f"gt{i}"]
    for i in range(1, 6):
        fields += [f"negative{i}", f"gn{i}"]
    with open(timed / "TIMED_test_set_filtered_SD14.csv", "w",
              newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        for fruit in ("A Banana", "A Pear"):
            row = {"old": fruit, "new": f"{fruit} in Blue"}
            for i in range(1, 6):
                row.update({f"positive{i}": f"{fruit} ctx {i}",
                            f"gt{i}": f"blue {fruit} ctx {i}",
                            f"negative{i}": f"apple ctx {i}",
                            f"gn{i}": f"blue apple ctx {i}"})
            w.writerow(row)

    road = root / "road"
    road.mkdir()
    rfields = ["type", "prompt", "oracle", "old", "new"]
    for i in range(1, 6):
        rfields += [f"positive{i}", f"positive_oracle{i}", f"positive_old{i}",
                    f"positive_new{i}"]
    for i in range(1, 6):
        rfields += [f"negative{i}", f"negative_new{i}"]
    with open(road / "RoAD_test.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=rfields)
        w.writeheader()
        w.writerow({k: f"Road {k}" for k in rfields})

    i2p = root / "i2p"
    i2p.mkdir()
    with open(i2p / "unsafe-prompts4703.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=[
            "prompt", "categories", "hard", "nudity_percentage",
            "evaluation_seed", "evaluation_guidance", "case_number"])
        w.writeheader()
        for i in range(10):
            w.writerow({"prompt": f"unsafe prompt {i}",
                        "categories": "sexual" if i % 2 == 0 else "violence",
                        "hard": 1 if i != 4 else 0,
                        "nudity_percentage": 10.0 + i,
                        "evaluation_seed": 100 + i,
                        "evaluation_guidance": 7.0, "case_number": i})

    coco = root / "coco"
    coco.mkdir()
    with open(coco / "coco_30k.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=[
            "case_number", "source", "prompt", "evaluation_seed", "coco_id"])
        w.writeheader()
        for i in range(4):
            w.writerow({"case_number": i, "source": "coco-30k",
                        "prompt": f"coco prompt {i}",
                        "evaluation_seed": 41337 + i, "coco_id": 1000 + i})
    return root


def _lists(x):
    return x.requests if hasattr(x, "requests") else x


# (name, call(package modules, data_dir)) for every parser
PARSERS = {
    "request_edit": lambda m, d: m.RequestDataset(data_dir=d, type="edit"),
    "request_val": lambda m, d: m.RequestDataset(data_dir=d, type="val"),
    "request_negatives": lambda m, d: (
        __import__("random").seed(5),
        m.RequestDataset(data_dir=d, type="edit", num_negative_prompts=2,
                         txt_img_align=True))[1],
    "mend_edit": lambda m, d: m.ImageNetMendRequestDataset(data_dir=d,
                                                           type="edit"),
    "mend_val": lambda m, d: m.ImageNetMendRequestDataset(data_dir=d,
                                                          type="val"),
    "mend_extra_knowledge": lambda m, d: m.ImageNetMendRequestDataset(
        data_dir=d, type="edit", no_extra_knowledge=False,
        use_simple_train_prompt=False),
    "alias": lambda m, d: m.compose_alias_test_requests(
        m.RequestDataset(data_dir=d, type="val").requests, data_dir=d),
    "object_prompts": lambda m, d: m.ObjectPromptDataset(
        data_dir=d, file_name="imgnet_aug_full.json"),
    "custom_objects": lambda m, d: m.CustomObjectRequestDataset(data_dir=d),
    "filtered": lambda m, d: m.get_filtered_dataset(data_dir=d),
    "artists": lambda m, d: m.ArtistRequestsDataset(data_dir=d,
                                                    num_artists=2),
    "artist_prompts": lambda m, d: m.load_artist_eval_prompts(2, data_dir=d),
    "debias": lambda m, d: m.DebiasRequestDataset(data_dir=d),
    "timed": lambda m, d: m.TIMEDRoadRequestDataset("timed", data_dir=d,
                                                    num_negative_prompts=2),
    "timed_more_templates": lambda m, d: m.TIMEDRoadRequestDataset(
        "timed", data_dir=d, use_more_tmp=True),
    "road": lambda m, d: m.TIMEDRoadRequestDataset("road", data_dir=d),
    "i2p_requests": lambda m, d: m.get_i2p_editing_requests(
        data_dir=d, num_requests=2, batch_size=2),
    "nsfw": lambda m, d: m.NSFWEditRequestDataset(["nudity", "gore", "x"],
                                                  num_prompts=2, seed=3),
    "coco": lambda m, d: m.load_coco_30k(data_dir=d, sub=3),
}


@pytest.mark.parametrize("name", sorted(PARSERS))
def test_parser_matches_jax(data_dir, name):
    ref = _lists(PARSERS[name](jd, data_dir))
    got = _lists(PARSERS[name](td, data_dir))
    assert got == ref
    assert len(got) > 0


def test_mend_requests_schema(data_dir):
    """The mend parser drops classes with no well-scored name and keeps
    the reference's per-request fields."""
    reqs = td.ImageNetMendRequestDataset(data_dir=data_dir).requests
    assert [(r["source"], r["dest"]) for r in reqs] == [
        ("Tinca tinca", "tench"), ("mud puppy", "axolotl")]
    assert reqs[0]["indices"] == [0, 1, 2] and reqs[1]["indices"] == [3, 4, 5]


def test_i2p_prompts_and_timed_eval_prompts(data_dir):
    assert (tglob.load_i2p_prompts(data_dir=data_dir)
            == jglob.load_i2p_prompts(data_dir=data_dir))
    for dataset in ("timed", "road"):
        tr = ttimed.TIMEDRoadRequestDataset(dataset, data_dir=data_dir)
        jr = jtimed.TIMEDRoadRequestDataset(dataset, data_dir=data_dir)
        assert (ttimed.positive_negative_prompts(tr[0], dataset)
                == jtimed.positive_negative_prompts(jr[0], dataset))
    t = td.DebiasRequestDataset(data_dir=data_dir)
    j = jd.DebiasRequestDataset(data_dir=data_dir)
    assert [t.validation_prompts(i) for i in range(len(t))] == \
        [j.validation_prompts(i) for i in range(len(j))]


def test_requests_csv_round_trip_both_ways(data_dir, tmp_path):
    """The CSV codec of the split files: written by one package, read by
    either, the same requests."""
    reqs = td.RequestDataset(data_dir=data_dir, type="edit").requests
    ticeb.requests_to_csv(reqs, tmp_path / "t.csv")
    jiceb.requests_to_csv(reqs, tmp_path / "j.csv")
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()
    assert ticeb.requests_from_csv(tmp_path / "j.csv") == \
        jiceb.requests_from_csv(tmp_path / "t.csv")
    back = ticeb.requests_from_csv(tmp_path / "t.csv")
    assert [r["seeds"] for r in back] == [r["seeds"] for r in reqs]


def test_filtered_dataset_writes_the_same_file(data_dir, tmp_path):
    jiceb.get_filtered_dataset(data_dir=data_dir, out_file=tmp_path / "j.json")
    ticeb.get_filtered_dataset(data_dir=data_dir, out_file=tmp_path / "t.json")
    assert json.loads((tmp_path / "t.json").read_text()) == \
        json.loads((tmp_path / "j.json").read_text())


def test_stat_dataset_helpers_match_jax():
    from emcid_tpu.dsets.stat_dataset import make_synthetic_captions as jcap
    from emcid_tpu.text.tokenizer import make_tiny_tokenizer as jtok

    from emcid_torch.dsets.stat_dataset import make_synthetic_captions
    from emcid_torch.text.tokenizer import make_tiny_tokenizer

    caps = make_synthetic_captions(12, seed=4)
    assert caps == jcap(12, seed=4)
    t = td.TokenizedDataset(caps, make_tiny_tokenizer(["photo"], 16))
    j = jd.TokenizedDataset(caps, jtok(["photo"], 16))
    for i in (0, 5, 11):
        for k in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(t[i][k], j[i][k])
    items = [t[i] for i in range(len(t))]
    tg = td.length_collation(20)(items)
    jg = jd.length_collation(20)(items)
    assert [len(g) for g in tg] == [len(g) for g in jg]
    data = np.random.RandomState(0).randn(2, 5, 3)
    mask = np.array([[1, 1, 0, 0, 0], [1, 0, 1, 1, 0]])
    np.testing.assert_array_equal(td.flatten_masked_batch(data, mask),
                                  jd.flatten_masked_batch(data, mask))


@pytest.fixture(scope="module")
def towers():
    """A tiny JAX text tower (seeded init) and the port's copy of it, with
    one tokenizer vocabulary."""
    import jax

    from emcid_tpu.models.clip_text import CLIPTextEncoder as JText
    from emcid_tpu.models.configs import CLIPTextConfig as JCfg
    from emcid_tpu.text.tokenizer import make_tiny_tokenizer

    from emcid_torch.models import convert
    from emcid_torch.models.clip_text import CLIPTextEncoder
    from emcid_torch.models.configs import CLIPTextConfig

    from torch_parity import port_tokenizer

    tok = make_tiny_tokenizer(["tench", "goldfish", "axolotl", "newt", "cat",
                               "dog", "an", "image", "of"],
                              model_max_length=32)
    cfg = dict(vocab_size=tok.vocab_size, hidden_size=32,
               intermediate_size=64, num_hidden_layers=2,
               num_attention_heads=4, max_position_embeddings=32,
               eos_token_id=tok.eos_token_id)
    jtext = JText(JCfg(**cfg))
    params = jtext.init_params(jax.random.PRNGKey(0), seq_len=32)
    text = CLIPTextEncoder(CLIPTextConfig(**cfg))
    text.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                          for k, v in convert.clip_text_to_torch(
                              jax.tree.map(np.asarray, params)).items()},
                         strict=True)
    return (jtext, params, tok), (text.eval().requires_grad_(False),
                                  port_tokenizer(tok))


def test_construction_find_dest_and_split_match_jax(towers, data_dir,
                                                    tmp_path):
    """Destinations drawn among the k CLIP-text-nearest held-out classes:
    the port's text tower embeds the class names as the JAX one does
    (<= 1e-5), so the draws and the written split files are equal."""
    (jtext, jparams, jtok), (text, tok) = towers
    names = ["tench", "goldfish", "newt"]
    ref = jcon.class_name_embeddings(jtext, jparams, jtok, names)
    got = tcon.class_name_embeddings(text, tok, names)
    assert float(np.abs(ref - got).max()) <= 1e-5
    id2label = {"0": "tench, Tinca tinca", "1": "goldfish", "2": "axolotl",
                "3": "newt", "4": "cat, kitty", "5": "dog"}
    ref = jcon.find_dest(range(6), [0, 2], 3, jtext, jparams, jtok,
                         id2label)
    got = tcon.find_dest(range(6), [0, 2], 3, text, tok, id2label)
    assert got == ref
    import shutil

    for pkg in ("j", "t"):
        shutil.copytree(data_dir / "iceb_data", tmp_path / pkg / "iceb_data")
    ref = jcon.edit_test_split(jtext, jparams, jtok, num_edit=2, k_nb=2,
                               data_dir=tmp_path / "j",
                               filtered_file="imgnet_aug_full.json")
    got = tcon.edit_test_split(text, tok, num_edit=2, k_nb=2,
                               data_dir=tmp_path / "t",
                               filtered_file="imgnet_aug_full.json")
    assert got == ref
    for f in ("imgnet_small_edit_aug.json", "objects_test_aug.json"):
        assert (tmp_path / "t" / "iceb_data" / f).read_text() == \
            (tmp_path / "j" / "iceb_data" / f).read_text()

"""PyTorch port, BLIP's BERT WordPiece tokenizer (``text/wordpiece.py``)
against HF ``BertTokenizer`` on a vocabulary the test writes, and against
the tokenizer the JAX package's BLIP loader takes (``AutoTokenizer`` on a
written BLIP folder).

Tolerance: none — ids and attention masks are equal.
"""

import os

import numpy as np
import pytest

os.environ.setdefault("USE_TF", "0")  # transformers without TensorFlow
transformers = pytest.importorskip("transformers")

from emcid_torch.text.wordpiece import WordPieceTokenizer, write_vocab

WORDS = ["a", "photo", "depicts", "cat", "dog", "caf", "##e", "un", "##aff",
         "##able", "resume", "hello", "的", "猫", "naive", "w0", "w1"]

CASES = {
    "plain": (["A photo depicts a cat", "a dog"], {}),
    "accents": (["A photo depicts a Café", "RÉSUMÉ naïve"], {}),
    "punctuation": (["hello, cat!!", "dog...(photo)?", "a-b_c"], {}),
    "wordpiece": (["unaffable", "unaff cafe", "caffe"], {}),
    "unk": (["zzz qqq", "x" * 120, "hello " + "y" * 101], {}),
    "cjk": (["的猫 cat", "a的b"], {}),
    "control": (["\tcat\x00 dog​\n", "a photo"], {}),
    "padding": (["a", "a photo depicts a cat dog"], dict(padding=True)),
    "max_length": (["a", "a photo"], dict(padding="max_length",
                                          max_length=12)),
    "truncation": (["a photo depicts a cat and a dog", "a"],
                   dict(padding=True, truncation=True, max_length=5)),
}


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return write_vocab(tmp_path_factory.mktemp("blip_tok"), WORDS,
                       vocab_size=400)


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_bert_tokenizer(folder, case):
    texts, kw = CASES[case]
    kw = dict(dict(padding=True, truncation=True), **kw)
    ours = WordPieceTokenizer.from_pretrained_dir(folder)(texts, **kw)
    ref = transformers.BertTokenizer.from_pretrained(str(folder))(
        texts, return_tensors="np", **kw)
    np.testing.assert_array_equal(ours["input_ids"], ref["input_ids"])
    np.testing.assert_array_equal(ours["attention_mask"],
                                  ref["attention_mask"])


def test_matches_jax_loader_tokenizer(folder):
    """The ids the JAX package's ``load_native_blip_scorer`` would feed
    (``AutoTokenizer`` on the folder, the prefix and padding it uses)."""
    texts = ["A photo depicts " + t for t in ("a cat", "a Café dog!",
                                               "unaffable 的猫")]
    auto = transformers.AutoTokenizer.from_pretrained(str(folder))
    ref = auto(texts, padding=True, truncation=True, max_length=512)
    ours = WordPieceTokenizer.from_pretrained_dir(folder)(
        texts, padding=True, truncation=True, max_length=512)
    np.testing.assert_array_equal(ours["input_ids"],
                                  np.asarray(ref["input_ids"]))
    np.testing.assert_array_equal(ours["attention_mask"],
                                  np.asarray(ref["attention_mask"]))


def test_vocab_and_pieces(folder):
    tok = WordPieceTokenizer.from_pretrained_dir(folder)
    assert len(tok.vocab) == 400
    assert tok.tokenize("unaffable") == ["un", "##aff", "##able"]
    assert tok.tokenize("cat ø") == ["cat", "[UNK]"]

"""BERT WordPiece tokenizer (no ``transformers``, no network).

BLIP's text encoder is a BERT; the JAX package takes its tokenizer from
``transformers.AutoTokenizer`` (``emcid_tpu/evals/blip.py``).  This is the
same algorithm as HF's ``BertTokenizer``, read from a checkpoint folder's
``vocab.txt`` (one token per line, the id is the line number) and
``tokenizer_config.json`` (``do_lower_case``, ``strip_accents``,
``tokenize_chinese_chars``, ``model_max_length``):

* basic tokenization: control characters dropped and whitespace unified,
  whitespace put around CJK ideographs, NFC normalization, lower-casing
  and accent stripping (NFD, marks dropped) per ``do_lower_case`` /
  ``strip_accents``, punctuation split into tokens of their own; the
  special tokens (``[CLS]`` ...) are never split;
* WordPiece: greedy longest match from the left with ``##`` continuations;
  a word with an unmatched piece, or longer than 100 characters, becomes
  ``[UNK]``;
* ``[CLS] ... [SEP]``, ``truncation`` to ``max_length`` (the two special
  tokens included), padded to the longest row (``padding=True``) or to
  ``max_length`` (``"max_length"``), ``input_ids`` / ``attention_mask`` as
  int numpy arrays.
"""

from __future__ import annotations

import json
import unicodedata
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

SPECIAL_TOKENS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")
MAX_CHARS_PER_WORD = 100


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def _strip_accents(text: str) -> str:
    return "".join(c for c in unicodedata.normalize("NFD", text)
                   if unicodedata.category(c) != "Mn")


class WordPieceTokenizer:
    """``tok(texts, padding=True, truncation=True, max_length=...)`` ->
    ``{"input_ids", "attention_mask"}`` as HF's ``BertTokenizer`` gives
    them."""

    def __init__(self, vocab: Dict[str, int], do_lower_case: bool = True,
                 strip_accents: Optional[bool] = None,
                 tokenize_chinese_chars: bool = True,
                 model_max_length: int = 512):
        self.vocab = dict(vocab)
        self.do_lower_case = do_lower_case
        self.strip_accents = strip_accents
        self.tokenize_chinese_chars = tokenize_chinese_chars
        self.model_max_length = model_max_length
        self.never_split = {t for t in SPECIAL_TOKENS if t in self.vocab}
        self.unk_token_id = self.vocab["[UNK]"]
        self.cls_token_id = self.vocab["[CLS]"]
        self.sep_token_id = self.vocab["[SEP]"]
        self.pad_token_id = self.vocab.get("[PAD]", 0)

    @classmethod
    def from_pretrained_dir(cls, folder, **overrides) -> "WordPieceTokenizer":
        """``vocab.txt`` (and ``tokenizer_config.json`` when present) of a
        checkpoint folder."""
        folder = Path(folder)
        lines = (folder / "vocab.txt").read_text(encoding="utf-8").split("\n")
        if lines and lines[-1] == "":
            lines = lines[:-1]
        vocab = {}
        for i, tok in enumerate(lines):
            vocab.setdefault(tok.rstrip("\r"), i)
        cfg = {}
        if (folder / "tokenizer_config.json").exists():
            cfg = json.loads((folder / "tokenizer_config.json").read_text())
        kwargs = dict(
            do_lower_case=cfg.get("do_lower_case", True),
            strip_accents=cfg.get("strip_accents"),
            tokenize_chinese_chars=cfg.get("tokenize_chinese_chars", True))
        mml = cfg.get("model_max_length")
        if isinstance(mml, int) and mml < 10 ** 6:
            kwargs["model_max_length"] = mml
        kwargs.update(overrides)
        return cls(vocab, **kwargs)

    # ---- basic tokenization -------------------------------------------
    def _basic(self, text: str) -> List[str]:
        chars = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            if _is_whitespace(ch):
                chars.append(" ")
            elif self.tokenize_chinese_chars and _is_cjk(cp):
                chars += [" ", ch, " "]
            else:
                chars.append(ch)
        text = unicodedata.normalize("NFC", "".join(chars))
        out: List[str] = []
        for token in text.split():
            if token in self.never_split:
                out.append(token)
                continue
            if self.do_lower_case:
                token = token.lower()
                if self.strip_accents is not False:
                    token = _strip_accents(token)
            elif self.strip_accents:
                token = _strip_accents(token)
            word = ""
            for ch in token:
                if _is_punctuation(ch):
                    if word:
                        out.append(word)
                    out.append(ch)
                    word = ""
                else:
                    word += ch
            if word:
                out.append(word)
        return out

    # ---- WordPiece -----------------------------------------------------
    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > MAX_CHARS_PER_WORD:
            return ["[UNK]"]
        pieces, start = [], 0
        while start < len(word):
            end, cur = len(word), None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return ["[UNK]"]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out = []
        for word in self._basic(text):
            out += [word] if word in self.never_split else self._wordpiece(word)
        return out

    def encode(self, text: str) -> List[int]:
        """Token ids without the special tokens."""
        return [self.vocab.get(t, self.unk_token_id)
                for t in self.tokenize(text)]

    def __call__(self, texts: Union[str, Sequence[str]],
                 padding: Union[bool, str] = True, truncation: bool = True,
                 max_length: Optional[int] = None
                 ) -> Dict[str, np.ndarray]:
        if isinstance(texts, str):
            texts = [texts]
        max_length = max_length or self.model_max_length
        rows = []
        for text in texts:
            ids = self.encode(text)
            if truncation and len(ids) > max_length - 2:
                ids = ids[: max(max_length - 2, 0)]
            rows.append([self.cls_token_id] + ids + [self.sep_token_id])
        width = (max_length if padding == "max_length"
                 else max(len(r) for r in rows))
        input_ids = np.full((len(rows), width), self.pad_token_id, np.int64)
        attention_mask = np.zeros((len(rows), width), np.int64)
        for i, r in enumerate(rows):
            input_ids[i, : len(r)] = r
            attention_mask[i, : len(r)] = 1
        return {"input_ids": input_ids, "attention_mask": attention_mask}


def write_vocab(folder, words: Sequence[str], vocab_size: Optional[int] = None,
                do_lower_case: bool = True) -> Path:
    """A ``vocab.txt`` (the special tokens, ``words``, the printable ASCII
    characters and their ``##`` forms, padded with ``[unusedN]`` up to
    ``vocab_size``) and a ``tokenizer_config.json`` in ``folder``: the
    tokenizer files of a synthetic BLIP checkpoint."""
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    toks = list(SPECIAL_TOKENS)
    chars = [chr(c) for c in range(33, 127)]
    for t in list(words) + chars + ["##" + c for c in chars]:
        if t not in toks:
            toks.append(t)
    if vocab_size is not None:
        if len(toks) > vocab_size:
            raise ValueError(f"{len(toks)} tokens > vocab_size {vocab_size}")
        toks += [f"[unused{i}]" for i in range(vocab_size - len(toks))]
    (folder / "vocab.txt").write_text("\n".join(toks) + "\n",
                                      encoding="utf-8")
    (folder / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "BertTokenizer", "do_lower_case": do_lower_case,
         "model_max_length": 512}))
    return folder

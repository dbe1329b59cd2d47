"""A word-level stand-in for SD3's T5 tokenizer (``tokenizer_3``).

T5's SentencePiece model is not in the repository, so the port's T5 takes
its ids from a vocabulary of whole words: each whitespace-separated word
is one id (``unk_id`` where the word is unknown), then the end token,
then padding, as ``T5TokenizerFast(padding="max_length",
truncation=True)`` lays them out: pad 0, end 1, unknown 2, SD3's 256
positions.  A folder holds the vocabulary as ``t5_words.json``
({"model_max_length": n, "words": {word: id}}).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Sequence

import numpy as np

PAD, EOS, UNK = 0, 1, 2
FILE = "t5_words.json"


class T5WordTokenizer:
    def __init__(self, vocab: Dict[str, int], model_max_length: int = 256):
        self.vocab = dict(vocab)
        self.model_max_length = model_max_length

    @classmethod
    def from_words(cls, words: Sequence[str], **kw) -> "T5WordTokenizer":
        """Ids 3, 4, ... for ``words`` in order (after pad, end, unknown)."""
        return cls({w: 3 + i for i, w in enumerate(dict.fromkeys(words))}, **kw)

    @classmethod
    def from_pretrained_dir(cls, path, **kw) -> "T5WordTokenizer":
        with open(Path(path) / FILE) as f:
            d = json.load(f)
        kw.setdefault("model_max_length", d["model_max_length"])
        return cls(d["words"], **kw)

    def save_pretrained(self, path) -> None:
        Path(path).mkdir(parents=True, exist_ok=True)
        with open(Path(path) / FILE, "w") as f:
            json.dump({"model_max_length": self.model_max_length,
                       "words": self.vocab}, f)

    @property
    def vocab_size(self) -> int:
        return max(self.vocab.values(), default=UNK) + 1

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        """(N, model_max_length) int64 ids: the words, truncated to leave
        room for the end token, the end token, padding."""
        n = self.model_max_length
        out = np.full((len(texts), n), PAD, np.int64)
        for i, t in enumerate(texts):
            ids = [self.vocab.get(w, UNK) for w in t.split()][:n - 1] + [EOS]
            out[i, :len(ids)] = ids
        return out

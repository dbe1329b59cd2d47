"""Self-contained CLIP BPE tokenizer (no torch, no network).

The reference relies on HuggingFace ``CLIPTokenizer`` downloaded from the hub
(reference experiments/causal_trace.py:1030-1042).  Here the byte-level BPE
algorithm is implemented directly; vocabulary is loaded from standard
HF-format files (``vocab.json`` + ``merges.txt``) supplied by the user, so any
CLIP/OpenCLIP checkpoint's tokenizer assets work.  ``make_tiny_tokenizer``
builds a deterministic synthetic vocabulary for tests (the "fake backend" the
reference never shipped — SURVEY.md §4).

Output is numpy ``input_ids``/``attention_mask`` shaped for the CLIP text
encoder (padded to ``max_length`` with EOS-style pad, like CLIP's 77-token
convention).
"""

from __future__ import annotations

import functools
import gzip
import html
import json
import unicodedata
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import regex as re

# CLIP's token split pattern (letters / digits / punctuation / contractions).
_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
    re.IGNORECASE,
)


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP reversible byte→printable-unicode map."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _basic_clean(text: str) -> str:
    # ftfy is unavailable offline; NFC + html-unescape covers the common cases.
    text = html.unescape(html.unescape(text))
    return unicodedata.normalize("NFC", text).strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def _get_pairs(word: Tuple[str, ...]) -> set:
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class CLIPBPETokenizer:
    """Byte-level BPE with CLIP's ``</w>`` end-of-word convention.

    Parameters
    ----------
    vocab : token-string → id mapping (must contain ``<|startoftext|>`` and
        ``<|endoftext|>``).
    merges : ordered list of merge pairs ``(a, b)``.
    model_max_length : CLIP context length (77).
    """

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: Sequence[Tuple[str, str]],
        model_max_length: int = 77,
    ):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.model_max_length = model_max_length
        self.bos_token = "<|startoftext|>"
        self.eos_token = "<|endoftext|>"
        self.bos_token_id = self.encoder[self.bos_token]
        self.eos_token_id = self.encoder[self.eos_token]
        self.pad_token_id = self.eos_token_id  # CLIP pads with EOS
        self.unk_token_id = self.eos_token_id
        self._bpe_cache: Dict[str, str] = {}

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_files(cls, vocab_file, merges_file, **kw) -> "CLIPBPETokenizer":
        """Load HF-format ``vocab.json`` + ``merges.txt`` (optionally .gz)."""
        vp = Path(vocab_file)
        opener = gzip.open if vp.suffix == ".gz" else open
        with opener(vp, "rt", encoding="utf-8") as f:
            vocab = json.load(f)
        mp = Path(merges_file)
        opener = gzip.open if mp.suffix == ".gz" else open
        with opener(mp, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = []
        for line in lines:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.split()
            if len(parts) == 2:
                merges.append((parts[0], parts[1]))
        return cls(vocab, merges, **kw)

    @classmethod
    def from_pretrained_dir(cls, path, **kw) -> "CLIPBPETokenizer":
        path = Path(path)
        return cls.from_files(path / "vocab.json", path / "merges.txt", **kw)

    def save_pretrained(self, path) -> None:
        """Write HF-format ``vocab.json`` + ``merges.txt`` (merges in rank
        order), which ``from_pretrained_dir`` reads back."""
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        with open(path / "vocab.json", "w", encoding="utf-8") as f:
            json.dump(self.encoder, f, ensure_ascii=False)
        merges = sorted(self.bpe_ranks, key=self.bpe_ranks.get)
        with open(path / "merges.txt", "w", encoding="utf-8") as f:
            f.write("#version: 0.2\n")
            f.writelines(f"{a} {b}\n" for a, b in merges)

    # -- BPE ---------------------------------------------------------------
    def _bpe(self, token: str) -> str:
        if token in self._bpe_cache:
            return self._bpe_cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        result = " ".join(word)
        self._bpe_cache[token] = result
        return result

    # -- encode / decode ---------------------------------------------------
    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids: List[int] = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for token in re.findall(_PAT, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            for bpe_token in self._bpe(token).split(" "):
                ids.append(self.encoder.get(bpe_token, self.unk_token_id))
        if add_special_tokens:
            ids = [self.bos_token_id] + ids + [self.eos_token_id]
        return ids

    def decode(self, token_ids: Union[int, Iterable[int]],
               skip_special_tokens: bool = False) -> str:
        if isinstance(token_ids, (int, np.integer)):
            token_ids = [token_ids]
        tokens = []
        for tid in np.asarray(list(token_ids)).reshape(-1).tolist():
            tok = self.decoder.get(int(tid), "")
            if skip_special_tokens and tok in (self.bos_token, self.eos_token):
                continue
            tokens.append(tok)
        text = "".join(tokens)
        # Special tokens are not byte-encoded; decode bytes only where mapped.
        byte_text = bytearray()
        for ch in text:
            if ch in self.byte_decoder:
                byte_text.append(self.byte_decoder[ch])
            else:
                byte_text.extend(ch.encode("utf-8"))
        return (
            byte_text.decode("utf-8", errors="replace")
            .replace("</w>", " ")
            .strip()
        )

    def convert_ids_to_tokens(self, ids: Iterable[int]) -> List[str]:
        return [self.decoder.get(int(i), self.eos_token) for i in ids]

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def __len__(self) -> int:
        return len(self.encoder)

    # -- batched call (HF-compatible surface used by the engine) -----------
    def __call__(
        self,
        prompts: Union[str, Sequence[str]],
        padding: Union[bool, str] = "max_length",
        truncation: bool = True,
        max_length: Optional[int] = None,
        return_tensors: str = "np",
    ) -> Dict[str, np.ndarray]:
        """Tokenize prompt(s) → dict(input_ids, attention_mask) as int32 numpy.

        ``padding="max_length"`` (the CLIP convention: always pad to 77) is
        the default because static shapes are what XLA wants; ``padding=True``
        pads to the longest sequence in the batch like HF.
        """
        if isinstance(prompts, str):
            prompts = [prompts]
        max_length = max_length or self.model_max_length
        seqs = []
        for p in prompts:
            ids = self.encode(p)
            if truncation and len(ids) > max_length:
                ids = ids[: max_length - 1] + [self.eos_token_id]
            seqs.append(ids)
        if padding == "max_length" or padding is False:
            pad_to = max_length
        else:  # padding=True → longest
            pad_to = max(len(s) for s in seqs)
        input_ids = np.full((len(seqs), pad_to), self.pad_token_id, dtype=np.int32)
        attention_mask = np.zeros((len(seqs), pad_to), dtype=np.int32)
        for i, s in enumerate(seqs):
            input_ids[i, : len(s)] = s
            attention_mask[i, : len(s)] = 1
        return {"input_ids": input_ids, "attention_mask": attention_mask}


def make_tiny_tokenizer(words: Optional[Sequence[str]] = None,
                        model_max_length: int = 16) -> CLIPBPETokenizer:
    """Deterministic synthetic tokenizer for tests.

    Vocabulary = all 256 byte symbols, each byte symbol + ``</w>``, full-word
    merges for ``words``, plus BOS/EOS.  Every word in ``words`` encodes to a
    single token; everything else falls back to per-character tokens.
    """
    byte_vocab = list(bytes_to_unicode().values())
    vocab: Dict[str, int] = {}
    for tok in byte_vocab:
        vocab[tok] = len(vocab)
    for tok in byte_vocab:
        vocab[tok + "</w>"] = len(vocab)
    merges: List[Tuple[str, str]] = []
    for w in words or []:
        w = w.lower()
        enc = "".join(bytes_to_unicode()[b] for b in w.encode("utf-8"))
        # chain merges left-to-right: (a,b)->ab, (ab,c)->abc, ... final +</w>
        if len(enc) == 1:
            continue
        prefix = enc[0]
        for ch in enc[1:-1]:
            if prefix + ch not in vocab:
                merges.append((prefix, ch))
                vocab[prefix + ch] = len(vocab)
            prefix = prefix + ch
        last = enc[-1] + "</w>"
        if prefix + last not in vocab:
            merges.append((prefix, last))
            vocab[prefix + last] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    return CLIPBPETokenizer(vocab, merges, model_max_length=model_max_length)

"""The synthetic vocabulary, the benchmark's own token ids, and the
prompts, requests and captions each run draws from its seed.

The CLIP BPE files are not in the repository, so every cell runs over a
synthetic vocabulary of whole words: ``COMMON`` plus ``N_CONCEPTS``
concept words of letters only (``qaaa``, ``qaab``, ...: the
tokenizer splits digits).  Each word is one token.  The ids
follow CLIP's layout (256 byte symbols, the 256 end-of-word byte symbols,
then merged words), and the start and end tokens keep CLIP's ids 49406 and
49407 in a vocabulary of 49408, so the configuration's ``eos_token_id``
is the published one.  ``port_tokenizer`` gives the program the same
vocabulary as BPE tables for its own tokenizer; ``ids`` is the reference's
word-level encoding of it.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

COMMON = ["a", "an", "of", "photo", "image", "the", "in", "by", "style",
          "painting", "art", "picture", "with", "and", "on"]
N_CONCEPTS = 4096
BOS, EOS = 49406, 49407
MAX_LEN = 77


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable character table, as CLIP's
    tokenizer uses it."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def concept(i: int) -> str:
    """The ``i``-th concept word: ``q`` and ``i`` in three base-26 letters."""
    return "q" + "".join(chr(97 + (i // 26 ** k) % 26) for k in (2, 1, 0))


def words() -> List[str]:
    """Concept words first: their merges then rank below the common words'
    and no common word's merge splits one."""
    return [concept(i) for i in range(N_CONCEPTS)] + COMMON


def vocabulary() -> Tuple[Dict[str, int], List[Tuple[str, str]],
                          Dict[str, int]]:
    """(BPE vocabulary, merges, word -> id): every word one token."""
    b2u = bytes_to_unicode()
    syms = list(b2u.values())
    vocab: Dict[str, int] = {s: i for i, s in enumerate(syms)}
    vocab.update({s + "</w>": 256 + i for i, s in enumerate(syms)})
    merges: List[Tuple[str, str]] = []
    word_id: Dict[str, int] = {}
    for w in words():
        enc = "".join(b2u[b] for b in w.encode("utf-8"))
        if len(enc) == 1:
            word_id[w] = vocab[enc + "</w>"]
            continue
        prefix = enc[0]
        for ch in enc[1:-1]:
            if prefix + ch not in vocab:
                merges.append((prefix, ch))
                vocab[prefix + ch] = len(vocab)
            prefix += ch
        tok = prefix + enc[-1] + "</w>"
        if tok not in vocab:
            merges.append((prefix, enc[-1] + "</w>"))
            vocab[tok] = len(vocab)
        word_id[w] = vocab[tok]
    if len(vocab) > BOS:
        raise ValueError("synthetic vocabulary overflows CLIP's")
    vocab["<|startoftext|>"] = BOS
    vocab["<|endoftext|>"] = EOS
    return vocab, merges, word_id


def port_tokenizer():
    """The program's own tokenizer class over the synthetic vocabulary."""
    from emcid_torch.text.tokenizer import CLIPBPETokenizer

    vocab, merges, _ = vocabulary()
    return CLIPBPETokenizer(vocab, merges, model_max_length=MAX_LEN)


def ids(texts: Sequence[str], word_id: Dict[str, int]
        ) -> Tuple[np.ndarray, np.ndarray]:
    """(ids, mask), each (N, 77) int64: start token, one id per word, end
    token, then end tokens as padding (mask 0)."""
    out = np.full((len(texts), MAX_LEN), EOS, np.int64)
    mask = np.zeros((len(texts), MAX_LEN), np.int64)
    for i, t in enumerate(texts):
        toks = [BOS] + [word_id[w] for w in t.split()][:MAX_LEN - 2] + [EOS]
        out[i, :len(toks)] = toks
        mask[i, :len(toks)] = 1
    return out, mask


def word_position(template: str) -> int:
    """Token position of the concept word in ``template``'s prompt."""
    return 1 + template.split().index("{}")


def concept_words(rng: np.random.Generator, n: int) -> List[str]:
    """``n`` distinct concept words."""
    return [concept(int(i))
            for i in rng.choice(N_CONCEPTS, size=n, replace=False)]


def captions(rng: np.random.Generator, n: int, lo: int, hi: int
             ) -> List[str]:
    """``n`` captions of ``lo`` to ``hi`` words over the whole vocabulary."""
    vocab = np.asarray(words())
    lens = rng.integers(lo, hi + 1, size=n)
    return [" ".join(vocab[rng.integers(0, len(vocab), size=k)])
            for k in lens]

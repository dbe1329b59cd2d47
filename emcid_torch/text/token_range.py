"""Token-range localization: map a substring of a prompt to [start, end)
token indices.

Behavioral port of the reference's ``find_token_range``
(experiments/causal_trace.py:1057-1103) — load-bearing for the *editing* path
(imported at reference emcid/compute_z.py:24): Stage 1 injects the optimized
delta at exactly these token positions, so the quirks (space-stripped
matching, lowercase, NFKC normalization, the ``’``→``'`` fix and the CLIP
"ń"-as-two-tokens workaround) are reproduced.
"""

from __future__ import annotations

import unicodedata
from typing import List, Sequence, Tuple

import numpy as np

# CLIP vocab id of the stray half of "ń" (reference causal_trace.py:1092).
_CLIP_N_ACCENT_ID = 78


def decode_tokens(tokenizer, token_array) -> List[str]:
    """Per-token decode (reference causal_trace.py:1045-1048)."""
    arr = np.asarray(token_array)
    if arr.ndim > 1:
        return [decode_tokens(tokenizer, row) for row in arr]
    return [tokenizer.decode([int(t)]) for t in arr]


def normalize_unicode_string(s: str) -> str:
    return unicodedata.normalize("NFKC", s)


def find_token_range(tokenizer, token_array, substring_orig: str) -> Tuple[int, int]:
    """Locate ``substring_orig`` within the tokenized prompt.

    Returns [start, end) over token positions.  Special cases:
    ``"[CLS]"`` → (0, 1); ``"[EOS]"``/``""``/``" "`` → the final position.
    """
    token_array = np.asarray(token_array).reshape(-1)
    substring = substring_orig[:]
    if substring == "[CLS]":
        return (0, 1)
    if substring in ("[EOS]", "", " "):
        return (len(token_array) - 1, len(token_array))

    substring = substring.replace(" ", "").lower()
    toks = decode_tokens(tokenizer, token_array)
    whole_string = tokenizer.decode(token_array).replace(" ", "")
    if "’" in substring:
        whole_string = whole_string.replace("'", "’")

    whole_string = normalize_unicode_string(whole_string)
    substring = normalize_unicode_string(substring)
    try:
        char_loc = whole_string.index(substring)
    except ValueError:
        raise ValueError(
            f"Cannot find substring in tokens: substring={substring!r} "
            f"whole string={whole_string!r}"
        )
    loc = 0
    tok_start, tok_end = None, None
    for i, t in enumerate(toks):
        if "ń" in substring and int(token_array[i]) == _CLIP_N_ACCENT_ID:
            # "ń" decodes from two tokens but contributes one char
            pass
        else:
            loc += len(t)
        if tok_start is None and loc > char_loc:
            tok_start = i
        if tok_end is None and loc >= char_loc + len(substring):
            tok_end = i + 1
            break
    return (tok_start, tok_end)


def last_subject_token_index(tokenizer, token_array, subject: str) -> int:
    """Index of the last token of ``subject`` (fact_token="subject_last")."""
    _, end = find_token_range(tokenizer, token_array, subject)
    return end - 1


def edit_token_indices(
    tokenizer,
    token_array,
    subject: str,
    num_edit_tokens: int = 1,
) -> List[int]:
    """Token positions to edit (reference compute_z `_v2` semantics,
    compute_z.py:1041-1357): 1 = last subject token; 2 adds the EOS position;
    >2 extends into the pad positions after EOS."""
    token_array = np.asarray(token_array).reshape(-1)
    last = last_subject_token_index(tokenizer, token_array, subject)
    if num_edit_tokens <= 1:
        return [last]
    # EOS = first eos_token_id at position > 0 (CLIP pads with EOS, so the
    # first occurrence after BOS is the true EOS).
    eos_positions = [
        i for i in range(1, len(token_array))
        if int(token_array[i]) == tokenizer.eos_token_id
    ]
    eos = eos_positions[0] if eos_positions else len(token_array) - 1
    indices = [last, eos]
    nxt = eos + 1
    while len(indices) < num_edit_tokens and nxt < len(token_array):
        indices.append(nxt)
        nxt += 1
    return indices[:num_edit_tokens]

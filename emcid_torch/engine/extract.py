"""Fact-token batches and activation gathers for the Stage-2 insert.

Counterpart of ``emcid_tpu/engine/extract.py``: all requests' source
prompts in one fixed-shape batch, the fact-token positions located on the
host, and per-request prompt averaging as one (R, P) matmul.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from emcid_torch.runtime import precise_matmuls
from emcid_torch.text.token_range import find_token_range


@dataclass
class RequestBatch:
    """P = total prompts, S = padded length, T = fact tokens, R = requests."""

    input_ids: np.ndarray  # (P, S) int32
    attention_mask: np.ndarray  # (P, S) int32
    lookup_indices: np.ndarray  # (P, T) int32
    prompt_to_request: np.ndarray  # (P,) int32
    prompts_per_request: np.ndarray  # (R,) int32
    num_requests: int
    num_fact_tokens: int

    @property
    def seg_matrix(self) -> np.ndarray:
        """(R, P) averaging matrix: seg @ x averages prompts per request."""
        R, P = self.num_requests, len(self.prompt_to_request)
        m = np.zeros((R, P), dtype=np.float32)
        m[self.prompt_to_request, np.arange(P)] = 1.0
        m /= np.maximum(self.prompts_per_request, 1)[:, None]
        return m


def _request_prompts(request: Dict) -> Tuple[List[str], str]:
    if "source_prompts" in request:
        return list(request["source_prompts"]), request["source"]
    return ([p.format(request["source"]) for p in request["prompts"]],
            request["source"])


def prepare_request_batch(tokenizer, requests: Sequence[Dict],
                          num_fact_tokens: int = 1,
                          max_length: Optional[int] = None) -> RequestBatch:
    """Tokenize all requests' source prompts and locate the fact tokens:
    the last subject token, then the EOS position and following pads for
    ``num_fact_tokens > 1``."""
    max_length = max_length or tokenizer.model_max_length
    prompts: List[str] = []
    subjects: List[str] = []
    prompt_to_request: List[int] = []
    for r, request in enumerate(requests):
        ps, subject = _request_prompts(request)
        prompts.extend(ps)
        subjects.extend([subject] * len(ps))
        prompt_to_request.extend([r] * len(ps))
    enc = tokenizer(prompts, padding="max_length", truncation=True,
                    max_length=max_length)
    input_ids, attention_mask = enc["input_ids"], enc["attention_mask"]
    P = len(prompts)
    lookup = np.zeros((P, num_fact_tokens), dtype=np.int32)
    for i in range(P):
        n_real = int(attention_mask[i].sum())
        _, end = find_token_range(tokenizer, input_ids[i, :n_real],
                                  subjects[i])
        lookup[i, 0] = end - 1
        if num_fact_tokens > 1:
            eos = n_real - 1
            lookup[i, 1:] = [min(eos + t, max_length - 1)
                             for t in range(num_fact_tokens - 1)]
    counts = np.bincount(prompt_to_request,
                         minlength=len(requests)).astype(np.int32)
    return RequestBatch(
        input_ids=np.asarray(input_ids, dtype=np.int32),
        attention_mask=np.asarray(attention_mask, dtype=np.int32),
        lookup_indices=lookup,
        prompt_to_request=np.asarray(prompt_to_request, dtype=np.int32),
        prompts_per_request=counts,
        num_requests=len(requests),
        num_fact_tokens=num_fact_tokens,
    )


def gather_at_tokens(acts: torch.Tensor, lookup: torch.Tensor) -> torch.Tensor:
    """(P, S, D), (P, T) -> (P, T, D)."""
    P = acts.shape[0]
    return acts[torch.arange(P, device=acts.device)[:, None], lookup]


def per_request_mean(x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """(P, T, D), (R, P) -> (R, T, D) prompt mean per request, full f32."""
    with precise_matmuls():
        return torch.einsum("rp,ptd->rtd", seg, x.float())

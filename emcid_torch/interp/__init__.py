"""Interpretability tools (counterpart of ``emcid_tpu/interp``): causal
tracing over the text encoder."""

from emcid_torch.interp.causal_trace import (
    calculate_hidden_flow_text_encoder,
    collect_embedding_std,
    layername_text_encoder,
    trace_important_states,
    trace_with_patch_text_encoder,
)

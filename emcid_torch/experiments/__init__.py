"""Baselines and experiments (counterpart of ``emcid_tpu/experiments``):
sequential editing, the ablation sweeps and the finetuning baseline."""

from emcid_torch.experiments.sequential import sequential_editing
from emcid_torch.experiments.ablation import (
    edit_weight_ablation,
    layer_combination_ablation,
    num_edit_tokens_ablation,
)
from emcid_torch.experiments.finetune import finetune_text_encoder

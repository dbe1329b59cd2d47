"""Evaluation harnesses and scorers (counterpart of ``emcid_tpu/evals``):
the ICEB AICE harness, Concept Rectification, the debias evaluation, the
ViT/FID/nudity scorers and the summary-JSON codec.  The JAX package's
ReFACT, mixed-safety, COCO, I2P and folder-sweep harnesses wait (ROADMAP
M12)."""

from emcid_torch.evals.scorers import (
    calculate_single_cls_score,
    cls_scores_batched,
    make_vit_scorer,
    fid_from_features,
    frechet_distance,
    cal_nudity_rate,
)
from emcid_torch.evals.summary import summary_key, update_summary
from emcid_torch.evals.iceb import (
    eval_pipe_imgnet,
    emcid_test_text_encoder_imgnet,
    measure_scores,
    measure_specificity,
)
from emcid_torch.evals.rectification import emcid_test_imgnet_mend

"""Evaluation harnesses and scorers (counterpart of ``emcid_tpu/evals``):
the ICEB AICE harness, Concept Rectification, the debias evaluation, the
RoAD/TIMED single-concept benchmark, the COCO, artist and I2P evaluations,
the ViT/FID/nudity scorers and the summary-JSON codec.  The JAX package's
BLIP scorer, mixed-safety, folder-sweep and plotting modules wait (ROADMAP
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
from emcid_torch.evals.refact_benchmark import emcid_test as refact_emcid_test
from emcid_torch.evals.refact_benchmark import eval_all as refact_eval_all
from emcid_torch.evals.coco_eval import (
    cal_clip_score_coco,
    cal_lpips_coco,
    coco_summary_key,
    generate_coco,
    write_coco_summary,
)
from emcid_torch.evals.artists_eval import eval_artists, generate_artist_images
from emcid_torch.evals.i2p_eval import (
    detect_nude_classes,
    generate_i2p_imgs,
    i2p_nudity_summary,
)

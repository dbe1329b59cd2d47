"""The edit: training images, Stage 1, covariances, Stage 2, orchestration."""
from emcid_torch.engine.extract import (
    RequestBatch,
    prepare_request_batch,
    module_io_at_words,
    compute_ks_text_encoder,
)
from emcid_torch.engine.emcid import (
    execute_emcid_text_encoder,
    apply_emcid_to_text_encoder,
    apply_deltas_to_params,
)
from emcid_torch.engine.editor import apply_emcid, resolve_covariances
from emcid_torch.engine.compute_z import (
    ConceptBatch,
    ZOptimizer,
    prepare_concept_batch,
    compute_z_text_encoder_batch,
)
from emcid_torch.engine.layer_stats import (
    get_cov_text_encoder,
    layer_stats_text_encoder,
)
from emcid_torch.engine.uce import edit_model_uce, edit_text_encoder_uce
from emcid_torch.engine.debias import apply_emcid_to_text_encoder_debias
from emcid_torch.engine.sdxl import (
    apply_emcid_to_sdxl_text_encoders,
    compute_z_sdxl_text_encoders,
    execute_emcid_sd_xl_text_encoders,
)
from emcid_torch.engine.cross_attn import (
    apply_emcid_to_cross_attn,
    execute_emcid_cross_attn,
    layer_stats_cross_attn_kv,
)
from emcid_torch.engine.unet_edit import (
    compute_delta_unet,
    execute_emcid_unet,
)
from emcid_torch.engine.unet_stats import layer_stats_unet
from emcid_torch.engine.fim import fim_stats, load_fim

"""Hyperparameter dataclasses + the name codec.

Field schema and JSON layout match the reference exactly so shipped
``hparams/*.json`` files load unchanged (reference emcid/emcid_hparams.py:55-338,
util/hparams.py:11-16).  The name codec is load-bearing in the reference —
results directories, cache paths and the plot parsers are all keyed by it
(reference emcid_hparams.py:125-152) — so we reproduce it verbatim at the
string level.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional


@dataclass
class HyperParams:
    """Base: JSON-file (de)serialization (reference util/hparams.py:11-16)."""

    @classmethod
    def from_json(cls, fpath):
        with open(fpath) as f:
            data = json.load(f)
        return cls(**data)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]):
        return cls(**d)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _objective_prefix(hparam, base: str = "") -> str:
    prefix = base
    if getattr(hparam, "use_sampled_noise", False):
        prefix += "add_dest"
    elif hparam.objective == "esd":
        prefix += f"esd-{hparam.esd_mu}"
    elif hparam.objective == "ablate-dest":
        prefix += "dest"
    elif hparam.objective == "ablate-source":
        prefix += "source"
    else:
        raise ValueError(f"objective not supported: {hparam.objective!r}")
    return prefix


def _txt_align_suffix(hparam) -> str:
    if getattr(hparam, "cal_text_repr_loss", False) and not getattr(
        hparam, "contrastive_text_loss", False
    ):
        return f"_txt-align-{hparam.text_repr_loss_scale_factor}"
    if getattr(hparam, "contrastive_text_loss", False):
        return f"_txt-cont-{hparam.text_repr_loss_scale_factor}"
    return ""


@dataclass
class EMCIDHyperParams(HyperParams):
    """SD v1.x text-encoder editing hyperparameters.

    Same required/optional fields as the reference dataclass
    (emcid_hparams.py:55-163); notes on the load-bearing ones:

    * ``layers`` — text-encoder layer indices receiving closed-form updates;
      the *last* entry is the layer where the Stage-1 z is optimized.
    * ``fact_token`` — which token's hidden state is edited.
    * ``mom2_update_weight`` — lambda in ``solve(lam*C + K K^T, K)``.
    * ``edit_weight`` — alpha knob: C is scaled by (1-alpha)/0.5 and K, R by
      sqrt(alpha/0.5) before the solve.
    * ``num_edit_tokens`` — 1 = last subject token; 2 adds EOS; >2 pads.
    """

    # Method
    layers: List[int]
    layer_selection: str
    fact_token: str
    mom2_update_weight: int

    # Module templates (dotted torch module names, resolved on the port's
    # nn.Modules directly)
    rewrite_module_tmp: str
    layer_module_tmp: str
    mlp_module_tmp: str
    attn_module_tmp: str
    ln_f_module: str

    # Statistics
    mom2_dataset: str
    mom2_n_samples: int
    mom2_dtype: str

    # Optimization
    v_num_grad_steps: int
    v_lr: float
    v_weight_decay: float
    clamp_norm_factor: float
    mom2_adjustment: bool
    objective: str
    esd_mu: Optional[Any]

    train_prompt_choice: str = "simple"
    use_new_compute_z: bool = False
    num_edit_tokens: int = 1
    samples_per_prompt: int = 1
    edit_weight: float = 0.5
    cal_text_repr_loss: bool = False
    align_obj_eos_pad: bool = False
    text_repr_loss_scale_factor: float = 0.0
    txt_img_align_scale_factor: float = 0.0
    txt_img_align_loss_metric: str = "l2"
    contrastive_text_loss: bool = False
    align_object_token: bool = False
    follow_refact: bool = True
    use_ewc: bool = False
    ewc_lambda: float = 1e4
    no_noise_loss: bool = False
    ddim_steps: Optional[int] = None
    scheduler: Optional[str] = None
    sld_supervision: bool = False
    sld_type: str = "max"
    all_safe: bool = False
    add_uce_edit: bool = False
    use_sampled_noise: bool = False
    replace_repr: bool = False

    @classmethod
    def get_name(cls, hparam: "EMCIDHyperParams") -> str:
        """Codec e.g. ``dest_s-200_c-1.5_ly-11_lr-0.2_wd-5e-04_txt-align-0.01``.

        NOTE (quirk kept from the reference, emcid_hparams.py:146-149):
        ``ly-`` encodes ``len(layers)``, not the layer indices.
        """
        prefix = _objective_prefix(hparam)
        suffix = _txt_align_suffix(hparam)
        return (
            f"{prefix}_s-{hparam.v_num_grad_steps}_"
            f"c-{hparam.clamp_norm_factor}_ly-{len(hparam.layers)}_"
            f"lr-{hparam.v_lr}_wd-{hparam.v_weight_decay:.0e}"
            f"{suffix}"
        )

    def to_json(self, hparams_dir) -> Path:
        path = Path(hparams_dir) / f"{self.get_name(self)}.json"
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=4)
        return path


@dataclass
class EMCIDXLHyperParams(HyperParams):
    """SDXL dual text-encoder editing hyperparameters
    (reference emcid_hparams.py:166-277).  ``layers``/``mom2_update_weight``
    address text_encoder (CLIP ViT-L), ``layers_2``/``mom2_update_weight_2``
    address text_encoder_2 (OpenCLIP bigG)."""

    layers: List[int]
    layers_2: List[int]
    layer_selection: str
    fact_token: str
    mom2_update_weight: int
    mom2_update_weight_2: int

    rewrite_module_tmp: str
    layer_module_tmp: str
    mlp_module_tmp: str
    attn_module_tmp: str
    ln_f_module: str

    mom2_dataset: str
    mom2_n_samples: int
    mom2_dtype: str

    v_num_grad_steps: int
    v_lr: float
    v_weight_decay: float
    clamp_norm_factor: float
    mom2_adjustment: bool
    objective: str
    esd_mu: Optional[Any]

    train_prompt_choice: str = "simple"
    use_new_compute_z: bool = False
    num_edit_tokens: int = 1
    samples_per_prompt: int = 1
    edit_weight: float = 0.5
    cal_text_repr_loss: bool = False
    align_obj_eos_pad: bool = False
    text_repr_loss_scale_factor: float = 0.0
    txt_img_align_scale_factor: float = 0.0
    txt_img_align_loss_metric: str = "l2"
    contrastive_text_loss: bool = False
    align_object_token: bool = False
    follow_refact: bool = True
    use_ewc: bool = False
    ewc_lambda: float = 1e4
    no_noise_loss: bool = False
    ddim_steps: Optional[int] = None
    scheduler: Optional[str] = None
    sld_supervision: bool = False
    sld_type: str = "max"
    all_safe: bool = False
    add_uce_edit: bool = False
    use_sampled_noise: bool = False
    replace_repr: bool = False

    @classmethod
    def get_name(cls, hparam: "EMCIDXLHyperParams") -> str:
        prefix = _objective_prefix(hparam, base="sdxl-")
        suffix = _txt_align_suffix(hparam)
        return (
            f"{prefix}_s-{hparam.v_num_grad_steps}_"
            f"c-{hparam.clamp_norm_factor}_ly-{len(hparam.layers)}_"
            f"lr-{hparam.v_lr}_wd-{hparam.v_weight_decay:.0e}"
            f"{suffix}"
        )


@dataclass
class UNetEMCIDHyperParams(HyperParams):
    """UNet region-edit hyperparameters (reference emcid_hparams.py:280-338)."""

    final_layer: List[Any]
    spread_sub_block_cnt: int
    skip_res_conv: bool
    v_reduce_inside_img: bool
    v_reduce_for_concept: bool
    gloabl_sample: bool  # (sic — reference field name kept for JSON parity)
    num_t_blocks: int
    even_sample: bool

    v_num_grad_steps: int
    v_lr: float
    v_weight_decay: float
    clamp_norm_factor: float
    objective: str
    esd_mu: Optional[Any]
    mom2_update_weight: int

    rewrite_module_tmp: Dict[str, str]

    mom2_dataset: str
    mom2_n_samples_prompts: int
    mom2_n_steps_per_prompt: int
    mom2_dtype: str

    use_sampled_noise: bool = False

    @classmethod
    def get_name(cls, hparam: "UNetEMCIDHyperParams") -> str:
        prefix = "unet_"
        if hparam.use_sampled_noise:
            prefix += "add_dest"
        elif hparam.objective == "esd":
            prefix += f"esd-{hparam.esd_mu}"
        elif hparam.objective == "ablate-source":
            prefix += "source"
        else:
            raise ValueError(f"objective not supported: {hparam.objective!r}")
        fl = hparam.final_layer
        return (
            f"{prefix}_s-{hparam.v_num_grad_steps}_"
            f"c-{hparam.clamp_norm_factor}_"
            f"ly-{fl[0]}{fl[1]}-{fl[2]}_"
            f"spread-{hparam.spread_sub_block_cnt}_"
            f"tb-{hparam.num_t_blocks}_"
            f"lr-{hparam.v_lr}_wd-{hparam.v_weight_decay:.0e}"
        )


@dataclass
class ContrastEMCIDHyperParams(HyperParams):
    """CLIP-contrastive variant hyperparameters (reference emcid_hparams.py:14-52)."""

    layers: List[int]
    fact_token: str
    mom2_update_weight: int

    rewrite_module_tmp: str
    layer_module_tmp: str
    mlp_module_tmp: str
    attn_module_tmp: str
    ln_f_module: str
    lm_head_module: str

    mom2_dataset: str
    mom2_n_samples: int
    mom2_dtype: str

    v_num_grad_steps: int
    v_lr: float
    v_weight_decay: float
    v_loss_layer: int
    clamp_norm_factor: float
    kl_factor: float
    mom2_adjustment: bool
    use_negative_images: bool
    num_negative_images: int

    objective: str = "contrastive"
    v_prob_threshold: float = 0.99
    edit_weight: float = 0.5
    sld_supervision: bool = False
    follow_refact: bool = True
    use_diff_clip: bool = False


def get_accum_time_blocks(num_block: int = 50, is_even: bool = True,
                          time_steps: int = 1000) -> List[int]:
    """Split ``time_steps`` diffusion timesteps into ``num_block`` blocks and
    return cumulative block boundaries, e.g. [20, 40, ..., 1000]
    (reference emcid_hparams.py:418-430)."""
    if not is_even:
        raise NotImplementedError("only even timestep blocks are supported")
    size = time_steps // num_block
    return [size * (i + 1) for i in range(num_block)]


def load_hparams(name_or_path: str, hparams_dir=None):
    """Load an hparams JSON by bare name (looked up in ``hparams_dir``) or
    explicit path; dispatch to the right dataclass by filename convention
    (``sdxl-*`` → XL, ``unet_*`` → UNet)."""
    from emcid_torch.globals_cfg import HPARAMS_DIR

    path = Path(name_or_path)
    # hparam names legitimately contain dots (clamp values like "c-1.5"), so
    # "has a suffix" is not a reliable path test — resolve by existence.
    if not path.exists():
        candidate = Path(hparams_dir or HPARAMS_DIR) / f"{name_or_path}.json"
        if not candidate.exists() and path.suffix != ".json":
            candidate = Path(hparams_dir or HPARAMS_DIR) / name_or_path
        path = candidate
    stem = path.stem
    if stem.startswith("sdxl"):
        return EMCIDXLHyperParams.from_json(path)
    if stem.startswith("unet"):
        return UNetEMCIDHyperParams.from_json(path)
    return EMCIDHyperParams.from_json(path)

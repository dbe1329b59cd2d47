"""Tiny stand-ins for the cells' files, for runs on the CPU: the same
keys at small widths, depths and resolutions."""

from __future__ import annotations

import copy
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def _load(rel: str) -> dict:
    with open(HERE / rel) as f:
        return json.load(f)


def text(cfg: dict, layers: int = 4, hidden: int = 32) -> dict:
    return dict(cfg, hidden_size=hidden, intermediate_size=2 * hidden,
                num_hidden_layers=layers, num_attention_heads=4,
                **({"projection_dim": hidden} if cfg.get("projection_dim")
                   else {}))


def sd() -> dict:
    c = _load("configs/sd-v1.4.json")
    c["text_encoder"] = text(c["text_encoder"])
    c["unet"] = dict(c["unet"], block_out_channels=[32, 64],
                     layers_per_block=1, attention_head_dim=4,
                     down_block_types=["CrossAttnDownBlock2D", "DownBlock2D"],
                     up_block_types=["UpBlock2D", "CrossAttnUpBlock2D"],
                     cross_attention_dim=32, norm_num_groups=8, sample_size=8)
    c["vae"] = dict(c["vae"], block_out_channels=[16, 32], layers_per_block=1,
                    norm_num_groups=4, sample_size=16)
    c["vae_scale"] = 2
    return c


def sdxl() -> dict:
    c = _load("configs/sdxl-base-1.0.json")
    c["text_encoder"] = text(c["text_encoder"], layers=3, hidden=16)
    c["text_encoder_2"] = text(c["text_encoder_2"], layers=4, hidden=16)
    c["unet"] = dict(c["unet"], block_out_channels=[32, 64],
                     layers_per_block=1, attention_head_dim=[4, 4],
                     transformer_layers_per_block=[1, 2],
                     down_block_types=["DownBlock2D", "CrossAttnDownBlock2D"],
                     up_block_types=["CrossAttnUpBlock2D", "UpBlock2D"],
                     cross_attention_dim=32, norm_num_groups=8, sample_size=8,
                     addition_time_embed_dim=8,
                     projection_class_embeddings_input_dim=16 + 6 * 8)
    c["vae"] = dict(c["vae"], block_out_channels=[16, 32], layers_per_block=1,
                    norm_num_groups=4, sample_size=16)
    c["vae_scale"] = 2
    return c


def traffic(name: str) -> dict:
    t = copy.deepcopy(_load(f"traffic/{name}.json"))
    if t["driver"] == "edit":
        t["hparams"]["layers"] = [1, 2]
        t["edit"]["train_res"] = 16
        t["stats_captions"] = 40
        t["edit"]["train_steps"] = 10
        t["edit"]["eps_pool"] = 3
        t["hparams"]["v_num_grad_steps"] = 50
    else:
        t["resolution"] = 16
        t["steps"] = 4
        t["batch"] = min(t["batch"], 3)
    return t


def config_for(cell: str) -> dict:
    return sdxl() if cell.startswith("sdxl") else sd()

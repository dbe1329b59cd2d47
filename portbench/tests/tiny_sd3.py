"""The SD3 cell's tiny stand-ins, for runs on the CPU: the configuration
``sd3.5-medium`` at 3- and 4-layer width-16 CLIP encoders, a 2-layer
width-32 T5 over 8 positions, a 3-block width-32 MMDiT-X (block 0 dual,
the last ``context_pre_only``) and the tiny 16-channel VAE, at 16 px;
and ``tiny.config_for``/``tiny.traffic`` extended to them."""

from __future__ import annotations

from portbench.tests import tiny

CELL_PREFIX = "sd35m"
_config_for, _traffic = tiny.config_for, tiny.traffic


def config() -> dict:
    c = tiny._load("configs/sd3.5-medium.json")
    c["text_encoder"] = tiny.text(c["text_encoder"], layers=3, hidden=16)
    c["text_encoder_2"] = tiny.text(c["text_encoder_2"], layers=4, hidden=16)
    c["text_encoder_3"] = dict(c["text_encoder_3"], d_model=32, d_kv=8,
                               d_ff=48, num_layers=2, num_heads=4)
    c["transformer"] = dict(c["transformer"], sample_size=8, num_layers=3,
                            attention_head_dim=8, num_attention_heads=4,
                            joint_attention_dim=32, caption_projection_dim=32,
                            pooled_projection_dim=32, pos_embed_max_size=12,
                            dual_attention_layers=[0])
    c["vae"] = dict(c["vae"], block_out_channels=[16, 32], layers_per_block=1,
                    norm_num_groups=4, sample_size=16)
    c["vae_scale"] = 2
    c["t5_max_length"] = 8
    return c


def config_for(cell: str) -> dict:
    return config() if cell.startswith(CELL_PREFIX) else _config_for(cell)


def traffic(name: str) -> dict:
    t = _traffic(name)
    if t["driver"] == "edit_sd3":
        t["stats_captions"] = 200
        t["hparams"]["v_num_grad_steps"] = 8
    return t

"""The frozen FLOP count against the program's own and the published
figures, and the shares of a peak or a roofline held to at most 100%."""

import json
from pathlib import Path

import pytest

from portbench import yardstick
from portbench.metrics import _read

ROOT = Path(__file__).resolve().parents[1]


def unet(name):
    with open(ROOT / "configs" / f"{name}.json") as f:
        return json.load(f)["unet"]


@pytest.mark.parametrize("name,hw,tflop", [("sd-v1.4", 64, 0.803),
                                           ("sd-v1.4", 48, 0.423),
                                           ("sdxl-base-1.0", 128, 6.76)])
def test_unet_flops_pinned(name, hw, tflop):
    from emcid_torch.models.configs import (
        sd_v14_unet,
        sdxl_unet,
        unet_config_from_diffusers,
    )
    from emcid_torch.profiling import unet_fwd_flops

    cfg = unet(name)
    ours = yardstick.unet_fwd_flops(cfg, 1, hw)
    assert ours == unet_fwd_flops(unet_config_from_diffusers(cfg), 1, hw)
    preset = sd_v14_unet() if name == "sd-v1.4" else sdxl_unet()
    assert ours == unet_fwd_flops(preset, 1, hw)
    assert round(ours / 1e12, 3 if tflop < 1 else 2) == tflop


def test_stage1_flops_match_the_program():
    from emcid_torch.models.configs import sd_v14_unet
    from emcid_torch.profiling import stage1_step_flops

    fwd = yardstick.unet_fwd_flops(unet("sd-v1.4"), 24, 48)
    # a pooled step is the edited forward and its input gradient
    assert 2 * fwd == stage1_step_flops(sd_v14_unet(), 8, 3, 48,
                                        eps_dest_pooled=True)


@pytest.mark.parametrize("sampler,steps,evals", [("pndm", 50, 51),
                                                  ("ddim", 50, 50),
                                                  ("dpm++", 25, 25)])
def test_sampler_evals(sampler, steps, evals):
    assert yardstick.sampler_evals(sampler, steps) == evals


def test_mfu_at_most_100():
    cfg = unet("sd-v1.4")
    flops = yardstick.guided_flops(cfg, 16, 64, "pndm", 50)
    fastest = flops / yardstick.PEAK_FLOPS
    assert _read.mfu(flops, fastest) == pytest.approx(100.0)
    for s in (fastest * 1.5, 8.0):
        facts = {"kind": "gen", "flops": {"generate": flops}, "batch_s": s}
        from portbench.metrics import generate_mfu

        assert 0 < generate_mfu.read(facts) < 100
    s1 = {"kind": "edit", "flops": {"stage1": 1e15}, "phases": {"stage1": 9.0}}
    from portbench.metrics import stage1_mfu

    assert 0 < stage1_mfu.read(s1) <= 100


def test_kernel_roofline_at_most_100():
    launches = [("K1", 24, 2304, 2304, 8, 40, 2), ("K2", 12, 2304, 2304, 8,
                                                    40, 2),
                ("K3", 12, 2304, 2304, 8, 40, 2), ("K4", 24, 2304, 77, 8, 40,
                                                   2)]
    bound = sum(yardstick.attn_bound_s(*l) for l in launches)
    for device_s, expect in ((bound, 100.0), (3 * bound, 100.0 / 3)):
        facts = {"kind": "edit", "trace": {
            "attn_kernel_s": device_s, "attn_kernel_events": 4,
            "attn_bound_s": bound, "attn_launches": 4}}
        assert _read.roofline(facts, "edit") == pytest.approx(expect)
    facts["trace"]["attn_kernel_events"] = 5  # an unmatched event
    assert _read.roofline(facts, "edit") is None


def test_k1_bound_is_the_exponential_free_maximum():
    # K1 at the Stage-1 shape: 4*B*H*N*M*D FLOPs against its bytes
    t = yardstick.attn_bound_s("K1", 24, 2304, 2304, 8, 40, 2)
    flops = 4.0 * 24 * 8 * 2304 * 2304 * 40
    assert t == pytest.approx(flops / yardstick.PEAK_FLOPS)

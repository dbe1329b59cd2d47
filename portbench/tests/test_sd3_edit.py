"""The SD3 edit cell's driver (``drivers/edit_sd3.py``) at tiny widths on
the CPU: one run end to end is ``correct`` under the cell's limits, the
float8 control reads worse than the program on the same drawn block,
``t5_s`` and ``attn_share.edit`` read the run's facts, a Stage 2 that
returns the right deltas but writes no weight, or writes encoder 2's
alone, reads ``correct`` false; and ``mmdit_flops`` against a count made
by hand."""

import importlib.util
import time

import pytest
import torch

from portbench import harness, mmdit_flops, run
from portbench.drivers import edit_sd3
from portbench.tests import tiny_sd3

CELL = "sd35m-edit-b1"
SEED = 2 ** 31 + 307


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    _, _, _, _, limits = run.cell_files(CELL)
    ctx = harness.Context(
        cell=CELL, cfg=tiny_sd3.config(),
        traffic=tiny_sd3.traffic("edit-sd3-b1"), limits=limits, seed=SEED,
        seconds=0.05, trace=False, device=torch.device("cpu"),
        tmp=tmp_path_factory.mktemp("sd3"), t_start=time.time(),
        dtype=torch.bfloat16)
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    try:
        res = edit_sd3.run(ctx)
        ctl = edit_sd3.control(ctx, res["window"])
    finally:
        torch.set_num_threads(n)
    return ctx, res, ctl, limits


def reader(name):
    path = harness.ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_correct(ran):
    _, res, _, limits = ran
    assert set(res["checks"]) == set(limits)
    assert all(res["checks"][k] <= limits[k] for k in limits), res["checks"]
    assert res["attempted"] == len(res["window"]["blocks"])


def test_control_reads_worse(ran):
    _, res, ctl, _ = ran
    assert ctl["z_gap"] > res["checks"]["z_gap"]
    assert ctl["fc2_gap"] > res["checks"]["fc2_gap"]


def test_readers(ran):
    """``t5_s`` reads the ``t5`` phase of a traced block's timings (none
    untraced); ``attn_share.edit`` the trace's attention seconds over its
    busy seconds, nothing without a trace or without attention events."""
    ctx, _, _, _ = ran
    facts = dict(ctx.facts, phases={"t5": 0.25, "stage1": 3.0})
    assert reader("t5_s")(facts) == 0.25
    assert reader("t5_s")(ctx.facts) is None
    share = reader("attn_share.edit")
    assert share(ctx.facts) is None
    trace = {"busy_s": 4.0, "attn_kernel_s": 1.0, "attn_kernel_events": 9}
    assert share(dict(ctx.facts, trace=trace)) == 25.0
    assert share(dict(ctx.facts, trace=dict(trace, attn_kernel_events=0))
                 ) is None


WRITES = {
    "nothing": lambda original, edited: original,
    "encoder_2_only": lambda original, edited: original.replace_text_encoders(
        text_encoder_2=edited.text_encoder_2),
}


@pytest.mark.parametrize("write", sorted(WRITES))
def test_stage2_writes_wrong_weights(monkeypatch, write):
    """Stage 2 returns the program's own deltas but the edited model
    holds the weights ``WRITES[write](original, edited)``."""
    from emcid_torch.engine import sd3

    orig = sd3.execute_emcid_sd_xl_text_encoders

    def stage2(components, *a, **k):
        d1, d2, edited = orig(components, *a, **k)
        return d1, d2, WRITES[write](components, edited)

    monkeypatch.setattr(sd3, "execute_emcid_sd_xl_text_encoders", stage2)
    line = run.run_cell(CELL, SEED, 0.05, False, "cpu",
                        cfg=tiny_sd3.config(),
                        traffic=tiny_sd3.traffic("edit-sd3-b1"))
    fc2 = line["checks"]["fc2_gap"]
    assert fc2["value"] > fc2["limit"]
    assert not line["correct"]


def test_mmdit_flops_by_hand():
    """Two blocks (the first dual, the second the last), width 8 (2 heads
    of 4), 4 x 4 latents in 2 x 2 patches (4 image tokens), 3 text tokens
    of width 5, pooled width 6, 3 output channels, batch 2."""
    cfg = {"num_attention_heads": 2, "attention_head_dim": 4,
           "patch_size": 2, "num_layers": 2, "dual_attention_layers": [0],
           "in_channels": 3, "out_channels": 3, "joint_attention_dim": 5,
           "pooled_projection_dim": 6}
    D, N, S, T = 8, 4, 3, 7
    embed = 2 * (N * 12 * D + S * 5 * D + 256 * D + D * D + 6 * D + D * D)
    block0 = 2 * (D * 9 * D + D * 6 * D          # both modulations
                  + N * 12 * D * D               # image qkv, out, MLP
                  + S * 12 * D * D               # text qkv, out, MLP
                  + N * 4 * D * D) + 4 * T * T * D + 4 * N * N * D
    block1 = 2 * (D * 6 * D + D * 2 * D + N * 12 * D * D
                  + S * 3 * D * D) + 4 * T * T * D
    out = 2 * (D * 2 * D + N * D * 12)
    want = 2 * (embed + block0 + block1 + out)
    assert mmdit_flops.mmdit_fwd_flops(cfg, 2, 4, 3) == want

"""The SDXL edit cell's driver (``drivers/edit_sdxl.py``) at tiny widths on
the CPU: one run end to end is ``correct`` under the cell's limits, the
float8 control reads worse than the program on the same drawn block,
``dest_share.stage1`` reads the run's spans, and a Stage 2 that returns
the right deltas but writes no weight, or writes one wrong, reads
``correct`` false."""

import importlib.util
import time

import pytest
import torch

from portbench import harness, run
from portbench.drivers import edit_sdxl
from portbench.tests import tiny

CELL = "sdxl-edit-b2"


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    _, _, _, _, limits = run.cell_files(CELL)
    ctx = harness.Context(
        cell=CELL, cfg=tiny.config_for(CELL),
        traffic=tiny.traffic("edit-xl-b2"), limits=limits,
        seed=2 ** 31 + 211, seconds=0.05, trace=False,
        device=torch.device("cpu"), tmp=tmp_path_factory.mktemp("xl"),
        t_start=time.time(), dtype=torch.bfloat16)
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    try:
        res = edit_sdxl.run(ctx)
        ctl = edit_sdxl.control(ctx, res["window"])
    finally:
        torch.set_num_threads(n)
    return ctx, res, ctl, limits


def test_correct(ran):
    _, res, _, limits = ran
    assert set(res["checks"]) == set(limits)
    assert all(res["checks"][k] <= limits[k] for k in limits), res["checks"]
    assert res["attempted"] == 2 * len(res["window"]["blocks"])


def test_control_reads_worse(ran):
    _, res, ctl, _ = ran
    assert ctl["z_gap"] > res["checks"]["z_gap"]
    assert ctl["fc2_gap"] > res["checks"]["fc2_gap"]


def test_dest_share_reads_the_spans(ran):
    """On the card the reader takes the spans' device seconds; here, with
    none, it reads nothing, and given the host seconds in their place (the
    spans nest the same way) a share in (0, 100)."""
    ctx, _, _, _ = ran
    path = harness.ROOT / "metrics" / "dest_share.stage1.py"
    spec = importlib.util.spec_from_file_location("dest_share", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    prog = ctx.facts["program"]
    steps = ctx.traffic["hparams"]["v_num_grad_steps"]
    blocks = ctx.facts["blocks"]
    assert prog["stage1.step"]["n"] == steps * blocks
    assert prog["stage1.dest"]["n"] == steps * blocks * ctx.traffic["batch"]
    assert mod.read(ctx.facts) is None
    host = {k: dict(v, device_s=v["host_s"]) for k, v in prog.items()}
    share = mod.read(dict(ctx.facts, program=host))
    assert 0.0 < share < 100.0


WRITES = {
    "nothing": lambda original, edited: original,
    "encoder_2_only": lambda original, edited: original.replace_text_encoders(
        text_encoder_2=edited.text_encoder_2),
}


@pytest.mark.parametrize("write", sorted(WRITES))
def test_stage2_writes_wrong_weights(monkeypatch, write):
    """Stage 2 returns the program's own deltas but the edited model
    holds the weights ``WRITES[write](original, edited)``."""
    from emcid_torch.engine import sdxl

    orig = sdxl.execute_emcid_sd_xl_text_encoders

    def stage2(components, *a, **k):
        d1, d2, edited = orig(components, *a, **k)
        return d1, d2, WRITES[write](components, edited)

    monkeypatch.setattr(sdxl, "execute_emcid_sd_xl_text_encoders", stage2)
    line = run.run_cell(CELL, 2 ** 31 + 211, 0.05, False, "cpu",
                        cfg=tiny.config_for(CELL),
                        traffic=tiny.traffic("edit-xl-b2"))
    fc2 = line["checks"]["fc2_gap"]
    assert fc2["value"] > fc2["limit"]
    assert not line["correct"]

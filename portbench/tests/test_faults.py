"""The check against a broken timed path: with the program's Stage-1
step, batch, sampler step or written answer broken underneath, a run
(past the look for a card, at tiny widths) reports ``correct`` false
under the cell's own limits.  And the control, the reference in float8 in
the program's place, reads several times what the program does.

The cells run on one card, so the fault of an exchange between cards
cannot occur in them."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import control, run
from portbench.tests import tiny

ROOT = Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 303
EDIT = [("sd14-edit-b8", "edit-b8"), ("sd14-edit-b1", "edit-b1")]
GEN = [("sd14-gen-512", "iceb-512"), ("sdxl-gen-1024", "coco-1024")]


def limits(cell):
    return json.loads((ROOT / "limits" / f"{cell}.json").read_text())


def result(cell, traffic, **change):
    tr = tiny.traffic(traffic)
    tr.update(change)
    return run.run_cell(cell, SEED, 0.05, False, "cpu",
                        cfg=tiny.config_for(cell), traffic=tr)


# -- edit cells --------------------------------------------------------------

@pytest.mark.parametrize("cell,traffic", EDIT)
def test_edit_step_returns_state_unchanged(monkeypatch, cell, traffic):
    from emcid_torch.engine import compute_z

    monkeypatch.setattr(compute_z, "adam_step_", lambda *a, **k: None)
    assert not result(cell, traffic)["correct"]


@pytest.mark.parametrize("cell,traffic", EDIT)
def test_edit_half_the_batch(monkeypatch, cell, traffic):
    """Each concept's noise loss over the first half of its prompts'
    draws only, the mean taken over those."""
    from emcid_torch.engine import compute_z

    def half(a, b, C):
        d = (a - b).pow(2).reshape(C, -1)
        return d[:, : max(1, d.shape[1] // 2)].mean(dim=1)

    monkeypatch.setattr(compute_z, "_mse", half)
    assert not result(cell, traffic)["correct"]


@pytest.mark.parametrize("cell,traffic", EDIT)
def test_edit_answer_altered(monkeypatch, cell, traffic):
    """The first edited layer's update is written at half its size, in
    every edit."""
    from emcid_torch.engine import emcid

    orig = emcid.upd_matrix_match_shape
    n_layers = len(tiny.traffic(traffic)["hparams"]["layers"])
    seen = []

    def altered(m, shape):
        seen.append(1)
        return orig(m * 0.5 if len(seen) % n_layers == 1 else m, shape)

    monkeypatch.setattr(emcid, "upd_matrix_match_shape", altered)
    line = result(cell, traffic)
    assert line["checks"]["fc2_gap"]["value"] > limits(cell)["fc2_gap"]
    assert not line["correct"]


# -- generation cells ----------------------------------------------------------

@pytest.mark.parametrize("cell,traffic", GEN)
def test_gen_step_returns_state_unchanged(monkeypatch, cell, traffic):
    from emcid_torch.models import scheduler

    monkeypatch.setattr(scheduler, "_ddim_transfer",
                        lambda schedule, sample, *a, **k: sample)
    assert not result(cell, traffic)["correct"]


@pytest.mark.parametrize("cell,traffic", GEN)
def test_gen_half_the_batch(monkeypatch, cell, traffic):
    """The sampler runs the first half of the batch; the rest repeat it."""
    from emcid_torch.models import pipeline, sdxl

    mod, name = ((sdxl, "sample_latents_sdxl") if cell.startswith("sdxl")
                 else (pipeline, "sample_latents"))
    orig = getattr(mod, name)

    def half(comps, prompts, seeds, **kw):
        n = max(1, len(prompts) // 2)
        lat = orig(comps, prompts[:n], seeds[:n], **kw)
        reps = -(-len(prompts) // n)
        return lat.repeat(reps, 1, 1, 1)[: len(prompts)]

    monkeypatch.setattr(mod, name, half)
    # every image checked, so that the second half is among them
    assert not result(cell, traffic, check_images=3)["correct"]


@pytest.mark.parametrize("cell,traffic", GEN)
def test_gen_answer_altered(monkeypatch, cell, traffic):
    """Every decoded image 16 levels brighter."""
    from emcid_torch.models import pipeline, sdxl

    mod = sdxl if cell.startswith("sdxl") else pipeline
    orig = mod.decode_latents

    def brighter(*a, **k):
        img = orig(*a, **k).astype(np.int16) + 16
        return np.clip(img, 0, 255).astype(np.uint8)

    monkeypatch.setattr(mod, "decode_latents", brighter)
    assert not result(cell, traffic)["correct"]


# -- the control ---------------------------------------------------------------

@pytest.mark.parametrize("cell,traffic", EDIT[:1] + GEN)
def test_control_reads_several_times_the_program(cell, traffic):
    r = control.readings(cell, SEED, 0.05, "cpu", tiny.config_for(cell),
                         tiny.traffic(traffic))
    for name, v in r["program"].items():
        if name in r["control"]:
            assert r["control"][name] > 3 * v, name

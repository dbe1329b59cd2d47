"""PyTorch port, the SDXL edit of a block (``engine.sdxl.apply_emcid_sdxl``)
against the benchmark's plain reference (``portbench/reference/sdxl_edit``)
on the tiny SDXL stand-in of ``portbench/tests/tiny.py``: seeded random
weights, 2 concepts x 3 prompts, 4 Stage-1 steps, the same draws on both
sides (one generator seeded with the block's seed, in the product's
order).  The reference computes each concept's training images and Stage
1 itself, and Stage 2 from the program's z of the whole block, in float64.

``z_gap``: per concept and encoder |z - z_ref| over the reference's own
step |z_ref - z0|, the worst; ``fc2_gap``: per edited layer of both
encoders the fc2 weight written against the reference's, |W_written -
s(W + upd_ref)| over |upd_ref|, the worst, ``s`` the rounding to the
served dtype (the benchmark's check); ``update_gap``: the same of the
update of the program's deltas, |upd - upd_ref| over |upd_ref|.

Tolerances.  With the program in float32 both sides differ in summation
order only: 1e-4 of the step for z after 4 Adam steps, as
``test_torch_sdxl.py`` holds the Stage-1 targets (read: 1e-6), and 1e-4
of the update for the fc2 weights, where the program's float32 solve
with iterative refinement meets the reference's float64 one (read:
3e-5, the weight written and the update).  The program in bfloat16, as
it is served, fails both (read: z 0.15, weight written 0.09, update
0.04).

Also: the CLI's SDXL leg goes through the entry point, its phases land in
``timings`` and its spans, ``stage1.dest`` among them, in a recording.
"""

import json

import pytest
import torch

from emcid_torch import profiling
from emcid_torch.engine import sdxl
from portbench import harness, tokens
from portbench.drivers import edit_sdxl
from portbench.drivers.edit import requests
from portbench.drivers.generate import components
from portbench.reference.ops import Prec
from portbench.tests import tiny

CELL = "sdxl-edit-b2"
Z_TOL = 1e-4
FC2_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _context(dtype: str, tmp_path) -> harness.Context:
    cfg = dict(tiny.config_for(CELL), dtype=dtype)
    traffic = tiny.traffic("edit-xl-b2")
    traffic["hparams"]["v_num_grad_steps"] = 4
    traffic["stats_captions"] = 200
    return harness.Context(
        cell=CELL, cfg=cfg, traffic=traffic, limits={}, seed=2 ** 32 + 17,
        seconds=0.0, trace=False, device=torch.device("cpu"), tmp=tmp_path,
        t_start=0.0, dtype=getattr(torch, dtype))


def _gaps(ctx: harness.Context):
    """The program's edit of one block and its gaps to the reference."""
    tr = ctx.traffic
    comps = components(ctx)
    caps = tokens.captions(ctx.rng(1), tr["stats_captions"],
                           *tr["caption_words"])
    reqs = requests(ctx, ctx.rng(2), tr["batch"])
    hp = edit_sdxl.hparams(ctx)
    zs = []

    def keep(orig):
        def f(*a, **k):
            out = orig(*a, **k)
            zs.append(out)
            return out
        return f

    with harness.wrapped(sdxl, "compute_z_sdxl_text_encoders", keep):
        d1, d2, edited = sdxl.apply_emcid_sdxl(
            comps, reqs, hp, captions=caps, rng_seed=7,
            **edit_sdxl.entry_args(ctx, tr["steps"]))
    names = [(k, hp.rewrite_module_tmp.format(i) + ".weight")
             for k, layers in ((1, hp.layers), (2, hp.layers_2))
             for i in layers]
    for k, d in ((1, d1), (2, d2)):
        assert set(d) == {n for j, n in names if j == k}
    C = len(reqs)
    z_port = [torch.as_tensor(z).reshape(C, -1) for z in zs[0]]
    blk = {"requests": reqs, "rng_seed": 7}
    params = harness.reference_params(ctx)
    rows = list(range(C))
    ref = edit_sdxl.reference_block(ctx, Prec(params), blk, rows, caps,
                                    zs=z_port)
    written = [edited.encoder(k).get_submodule(n[:-len(".weight")]).weight
               for k, n in names]
    gaps = edit_sdxl.compare(ctx, params, rows, ref, z_port, written)
    upd = []
    for (k, n), r in zip(names, ref["updates"]):
        adj_k, resid = (torch.as_tensor(a, dtype=torch.float64)
                        for a in (d1, d2)[k - 1][n])
        upd.append(float((resid @ adj_k.T - r).norm() / r.norm()))
    return dict(gaps, update_gap=max(upd))


def test_block_matches_reference(tmp_path):
    """Both encoders' z of both concepts, and at all five edited fc2
    layers (CLIP-L 0-1, bigG 0-2 in the tiny encoders) the update and the
    weight written, within the float32 tolerances."""
    g = _gaps(_context("float32", tmp_path))
    assert g["z_gap"] <= Z_TOL, g
    assert g["fc2_gap"] <= FC2_TOL, g
    assert g["update_gap"] <= FC2_TOL, g


def test_bfloat16_fails_the_tolerances(tmp_path):
    """The program in bfloat16 in its float32 place: outside at least one
    tolerance, so that they are tight enough to see a lower precision."""
    g = _gaps(_context("bfloat16", tmp_path))
    assert g["z_gap"] > Z_TOL and g["fc2_gap"] > FC2_TOL, g


def test_cli_sdxl_phases_and_spans(tmp_path):
    """The CLI's SDXL leg (``--tiny --platform cpu``) through
    ``apply_emcid_sdxl`` under ``profiling.recording()``: the timings
    keys of its phases, an ``edit.*`` span for each, and a
    ``stage1.dest`` span per concept inside each ``stage1.step``."""
    import emcid_torch.hparams as thp
    from emcid_torch.cli import run_emcid

    steps = 2
    hp = thp.EMCIDXLHyperParams.from_dict(dict(
        tiny.traffic("edit-xl-b2")["hparams"], layers=[7, 8, 9, 10],
        layers_2=[27, 28, 29, 30], v_num_grad_steps=steps))
    hp_dir = tmp_path / "hparams"
    hp_dir.mkdir()
    (hp_dir / "sdxl-tiny.json").write_text(json.dumps(hp.to_dict()))
    reqs = [{"prompts": ["a photo of a {}", "{}"], "source": s, "dest": d,
             "seed_train": i} for i, (s, d) in enumerate((("cat", "dog"),
                                                          ("dog", "cat")))]
    path = tmp_path / "run.json"
    path.write_text(json.dumps({
        "requests": reqs, "hparams": "sdxl-tiny", "model_ckpt": "sdxl-1.0",
        "out_dir": str(tmp_path / "out")}))
    argv = ["--instruction_path", str(path), "--tiny", "--platform", "cpu",
            "--hparams_dir", str(hp_dir), "--stats_dir", str(tmp_path / "s"),
            "--steps", "2", "--seed", "0"]
    timings = {}
    with profiling.recording("cpu") as rec:
        run_emcid.main(argv, timings=timings)
    assert {"covariances", "generation", "stage1", "stage2"} <= set(timings)
    spans = rec.summary()
    for name in ("edit.covariances", "edit.train_images", "edit.stage1",
                 "edit.stage2"):
        assert spans[name]["n"] == 1, name
    assert spans["stage1.step"]["n"] == steps
    assert spans["stage1.dest"]["n"] == steps * len(reqs)
    assert sum(spans["stage1.dest"]["host_s"]) < sum(
        spans["stage1.step"]["host_s"])

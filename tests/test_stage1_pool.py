"""Stage 1's eps_dest pool as stacked UNet calls (``engine/compute_z``:
``pool_calls``, ``ZOptimizer._build_pool``) on the CPU at tiny widths: the
plan covers every draw once, in order, in at most two call shapes, and
keeps one draw a call at ``sd14-edit-b8``'s rows and area; the stacked
pool gives the one-draw-a-call pool's noisy latents and timesteps bit for
bit and its eps within f32 rounding, with ablate-dest and esd, on one
shard and on a 3-entry mesh; a plan of one draw a call gives the pool of
a plain per-draw loop bit for bit; and a recording counts each pool UNet
call as ``stage1.pool_calls`` inside one ``stage1.pool`` span.  The calls
on the card: ``chip_smoke.py --stage1-pool``."""

import dataclasses

import pytest
import torch

import emcid_torch.hparams as thp
from emcid_torch import profiling
from emcid_torch.engine import compute_z
from emcid_torch.engine.compute_z import (
    ZOptimizer,
    concept_batch_to_device,
    pool_calls,
    prepare_concept_batch,
)
from emcid_torch.models.loader import build_tiny_pipeline
from emcid_torch.parallel import get_mesh
from torch_parity import one_torch_thread  # noqa: F401

K = 5
C = 2  # concepts of the block
P = 2  # prompts a concept
LATENT = 8
SEED = 2 ** 31 + 17


@pytest.fixture(scope="module")
def comps():
    return build_tiny_pipeline(device="cpu")


def hparams(objective):
    hp = thp.EMCIDHyperParams.from_dict({
        "layers": [1, 2], "clamp_norm_factor": 1.5,
        "layer_selection": "all", "fact_token": "subject_last",
        "v_num_grad_steps": 1, "v_lr": 0.2, "v_weight_decay": 5e-4,
        "mom2_adjustment": True, "mom2_update_weight": 4000,
        "rewrite_module_tmp": "text_model.encoder.layers.{}.mlp.fc2",
        "layer_module_tmp": "text_model.encoder.layers.{}",
        "mlp_module_tmp": "text_model.encoder.layers.{}.mlp",
        "attn_module_tmp": "text_model.encoder.layers.{}.self_attn",
        "ln_f_module": "text_model.final_layer_norm",
        "mom2_dataset": "ccs_filtered", "mom2_n_samples": 100,
        "mom2_dtype": "float32", "objective": "ablate-dest",
        "esd_mu": "None", "cal_text_repr_loss": True,
        "text_repr_loss_scale_factor": 0.01,
    })
    return dataclasses.replace(hp, objective=objective,
                               esd_mu=1.0 if objective == "esd" else "None")


def batch_of(comps, objective):
    reqs = [{"prompts": ["a photo of a {}", "an image of a {}"],
             "source": f"w{2 * i}", "dest": f"w{2 * i + 1}"}
            for i in range(C)]
    arrays, _, _ = prepare_concept_batch(comps.tokenizer, reqs,
                                         hparams(objective))
    g = torch.Generator().manual_seed(0)
    shape = (C, 2, P, LATENT, LATENT, 4)
    arrays["latents_mean"] = torch.randn(shape, generator=g)
    arrays["latents_logvar"] = torch.full(shape, -3.0)
    return concept_batch_to_device(arrays, "cpu")


def block(comps, monkeypatch, objective, mesh=None):
    """One Stage-1 block with a K-draw pool under a recording -> (the
    pools of its shards, the recording's summary)."""
    pools = []
    build = ZOptimizer._build_pool

    def spy(self, *a, **k):
        pools.append(build(self, *a, **k))
        return pools[-1]

    monkeypatch.setattr(ZOptimizer, "_build_pool", spy)
    optz = ZOptimizer(comps.text_encoder, comps.unet, comps.schedule,
                      hparams(objective), layer=2, eps_pool=K)
    with profiling.recording("cpu") as rec:
        optz.run(batch_of(comps, objective), torch.Generator().manual_seed(
            SEED), mesh=None if mesh is None else get_mesh(["cpu"] * mesh))
    monkeypatch.setattr(ZOptimizer, "_build_pool", build)
    return pools[0], rec.summary()


def one_a_call(K, *_):
    return [1] * K


def budget_of(draws):
    """A ``POOL_CALL_POSITIONS`` that stacks ``draws`` draws of the
    unsharded block a call."""
    return draws * C * P * LATENT * LATENT


@pytest.mark.parametrize("K,rows,h,w", [
    (25, 24, 48, 48), (25, 3, 48, 48), (25, 1, 8, 8), (25, 96, 48, 48),
    (7, 5, 48, 48), (1, 3, 48, 48), (3, 4, 8, 8), (50, 6, 64, 64),
    (25, 2, 128, 128), (13, 7, 48, 48)])
def test_plan_covers_each_draw_once_in_two_shapes(K, rows, h, w):
    plan = pool_calls(K, rows, h, w)
    assert sum(plan) == K and all(n >= 1 for n in plan)
    assert len(set(plan)) <= 2 and max(plan) - min(plan) <= 1
    assert plan == sorted(plan, reverse=True)
    per = max(plan)
    assert per == 1 or per * rows * h * w <= compute_z.POOL_CALL_POSITIONS
    # the fewest calls: one more draw a call would pass the budget
    fit = max(1, compute_z.POOL_CALL_POSITIONS // (rows * h * w))
    assert len(plan) == -(-K // fit)


def test_plan_at_the_bench_shapes():
    """``sd14-edit-b8`` (8 concepts x 3 prompts) keeps one draw a call,
    ``sd14-edit-b1`` (3 rows) stacks its 25 draws into a few calls."""
    assert pool_calls(25, 24, 48, 48) == [1] * 25
    b1 = pool_calls(25, 3, 48, 48)
    assert 2 <= len(b1) <= 6 and sum(b1) == 25
    assert pool_calls(0, 3, 48, 48) == []


@pytest.mark.parametrize("mesh", [None, 3])
@pytest.mark.parametrize("objective", ["ablate-dest", "esd"])
@pytest.mark.parametrize("draws", [K, 2])
def test_stacked_pool_equals_one_draw_a_call(comps, monkeypatch, objective,
                                             mesh, draws):
    """All K draws in one call, or two draws a call (calls of 2, 2, 1):
    noisy and t bit for bit, eps within f32 rounding."""
    monkeypatch.setattr(compute_z, "POOL_CALL_POSITIONS", budget_of(draws))
    got, _ = block(comps, monkeypatch, objective, mesh)
    with monkeypatch.context() as m:
        m.setattr(compute_z, "pool_calls", one_a_call)
        ref, _ = block(comps, monkeypatch, objective, mesh)
    keys = {"noisy", "t", "eps_dest"} | ({"eps_src"} if objective == "esd"
                                         else set())
    assert len(got) == len(ref) == (1 if mesh is None else 3)
    for g, r in zip(got, ref):
        assert set(g) == set(r) == keys
        assert g["noisy"].shape[0] == K
        assert torch.equal(g["noisy"], r["noisy"])
        assert torch.equal(g["t"], r["t"])
        for k in keys - {"noisy", "t"}:
            assert g[k].shape == r[k].shape
            rel = float((g[k] - r[k]).abs().max() / r[k].abs().max())
            assert rel <= 1e-5, (k, rel)


def per_draw_pool(optz, batch, gen):
    """The pool as a plain loop makes it: every draw first, then one
    no-grad UNet call a draw, stacked (no mesh)."""
    draws = [optz._draw(batch, gen) for _ in range(K)]
    with torch.no_grad():
        dest = optz.text_model(batch.dest_ids.flatten(0, 1)).last_hidden_state
        pool = {"noisy": [], "t": [], "eps_dest": []}
        for d in draws:
            x, t = optz._noisy(*d)
            pool["noisy"].append(x)
            pool["t"].append(t)
            pool["eps_dest"].append(optz._eps(optz.unet, x, t, dest))
    return {k: torch.stack(v) for k, v in pool.items()}


def test_one_draw_a_call_is_the_per_draw_pool_bitwise(comps, monkeypatch):
    """Where the plan is one draw a call (a draw alone fills the budget),
    the pool is the plain loop's, bit for bit and in the same layout."""
    monkeypatch.setattr(compute_z, "POOL_CALL_POSITIONS", budget_of(1))
    assert pool_calls(K, C * P, LATENT, LATENT) == [1] * K
    got, summ = block(comps, monkeypatch, "ablate-dest")
    optz = ZOptimizer(comps.text_encoder, comps.unet, comps.schedule,
                      hparams("ablate-dest"), layer=2, eps_pool=K)
    ref = per_draw_pool(optz, batch_of(comps, "ablate-dest"),
                        torch.Generator().manual_seed(SEED))
    assert set(got[0]) == set(ref)
    for k in ref:
        assert torch.equal(got[0][k], ref[k]), k
        assert got[0][k].stride() == ref[k].stride(), k
    assert summ["stage1.pool_calls"]["n"] == K


@pytest.mark.parametrize("mesh", [None, 3])
@pytest.mark.parametrize("objective", ["ablate-dest", "esd"])
def test_pool_calls_counted_in_one_span(comps, monkeypatch, objective, mesh):
    """``stage1.pool_calls``: the plan's length per shard, twice with esd
    (eps_dest and eps_src); one ``stage1.pool`` span a block."""
    monkeypatch.setattr(compute_z, "POOL_CALL_POSITIONS", budget_of(2))
    _, summ = block(comps, monkeypatch, objective, mesh)
    shards = 1 if mesh is None else mesh
    rows = C * P if mesh is None else P  # 2 concepts pad to 3 on 3 entries
    plan = pool_calls(K, rows, LATENT, LATENT)
    assert len(plan) < K
    per_shard = len(plan) * (2 if objective == "esd" else 1)
    assert summ["stage1.pool_calls"]["n"] == shards * per_shard
    assert summ["stage1.pool"]["n"] == 1
    assert summ["stage1.step"]["n"] == 1

"""SDXL Stage 1's CUDA-graph path (``engine/sdxl._capture_concept``, held
by ``compute_z.StepGraphs`` over ``ops/graphs``) on the CPU at tiny
widths.  ``torch_parity.RecordingGraph`` stands in for CUDA's graph: it
records the ATen calls made while it is open and a replay makes them
again on the same tensors, so a replay computes what the capture did, at
the inputs copied in since.  With it the graph path gives the eager
path's z exactly, a forward-only capture gives the uncaptured forward and
replays its K1/K4 calls through their wrappers, and two blocks capture
once and then only replay.  The gate keeps the path eager on the CPU,
with a mesh, with hooks on any of the three models, under no-grad and
with the fused norms, and those steps count as eager; the captures are
keyed on the modules and the shapes, not the hparams.  Replays on the
card: ``chip_smoke.py --stage1-graphs``."""

import numpy as np
import pytest
import torch

from emcid_torch import profiling
from emcid_torch.engine import compute_z, sdxl
from emcid_torch.engine.compute_z import (
    graph_blockers,
    graph_key,
    held_graphs,
    stage1_graphs,
)
from emcid_torch.engine.sdxl import compute_z_sdxl_text_encoders
from emcid_torch.hparams import EMCIDXLHyperParams
from emcid_torch.models import unet as unet_mod
from emcid_torch.models.sdxl import build_tiny_sdxl_pipeline, sdxl_time_ids
from emcid_torch.ops import attention as attn_mod
from emcid_torch.ops import flash_v2, graphs
from emcid_torch.parallel import get_mesh
from test_stage1_graphs import (  # noqa: F401
    COUNTERS,
    GATE,
    graphs_on,
    on_cuda,
    ungated,
    wrapper_calls,
)
from torch_parity import RecordingGraph, one_torch_thread, recorded  # noqa: F401

STEPS = 3
LATENT = 16  # 64 tokens at the attention level
# stand in for EMCID_TPU_FLASH_MIN_SEQ and SHORT_KV_MAX at this size: the
# self-attention reaches K1-K3, the cross-attention K4
KERNEL_MIN_SEQ = SHORT_KV = 64
WORDS = ["cat", "dog"]
REQUESTS = [
    {"prompts": ["a photo of a {}", "an image of a {}", "{}"],
     "source": "cat", "dest": "dog", "seed_train": 0},
    {"prompts": ["a photo of a {}", "an image of a {}", "{}"],
     "source": "dog", "dest": "cat", "seed_train": 1, "txt_align": False},
]


def tiny():
    return build_tiny_sdxl_pipeline(seed=0, words=WORDS, device="cpu")


@pytest.fixture(scope="module")
def comps():
    return tiny()


def hparams(**change):
    d = {
        "layers": [0, 1], "layers_2": [1, 2], "clamp_norm_factor": 1.2,
        "layer_selection": "all", "fact_token": "subject_last",
        "mom2_update_weight": 100, "mom2_update_weight_2": 200,
        "rewrite_module_tmp": "text_model.encoder.layers.{}.mlp.fc2",
        "layer_module_tmp": "text_model.encoder.layers.{}",
        "mlp_module_tmp": "text_model.encoder.layers.{}.mlp",
        "attn_module_tmp": "text_model.encoder.layers.{}.self_attn",
        "ln_f_module": "text_model.final_layer_norm",
        "mom2_dataset": "ccs_filtered", "mom2_n_samples": 30,
        "mom2_dtype": "float32", "v_num_grad_steps": STEPS, "v_lr": 0.1,
        "v_weight_decay": 8e-3, "mom2_adjustment": True,
        "objective": "ablate-dest", "esd_mu": "None",
        "cal_text_repr_loss": True, "text_repr_loss_scale_factor": 0.5,
    }
    d.update(change)
    return EMCIDXLHyperParams.from_dict(d)


def stage1(comps, hp, C=2, mesh=None):
    """Stage 1 of the first ``C`` requests at LATENT x LATENT latents
    under a recording -> ((z_1, z_2), the Stage-1 counters)."""
    rng = np.random.RandomState(0)
    mean = rng.randn(C, 1, 3, LATENT, LATENT, 4).astype(np.float32) * 0.13
    logvar = np.full(mean.shape, -6.0, np.float32)
    with profiling.recording("cpu") as rec:
        zs = compute_z_sdxl_text_encoders(
            comps, REQUESTS[:C], hp, mean, logvar, height=2 * LATENT,
            width=2 * LATENT, mesh=mesh, verbose=False)
    return zs, {k: v["n"] for k, v in rec.summary().items()
                if k in COUNTERS}


def kernel_route(q, k, v, scale=None):
    """``ops.attention.attention`` as it routes CUDA tensors, on the CPU
    (the wrappers compute their plain versions there), at this size's
    thresholds."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if max(q.shape[1], k.shape[1]) < KERNEL_MIN_SEQ:
        return attn_mod._block_attention(q, k, v, scale)
    if k.shape[1] >= SHORT_KV:
        return flash_v2.flash_attention_v2(q, k, v, scale)
    return attn_mod.flash_attention(q, k, v, scale)


@pytest.fixture
def kernel_routes(monkeypatch):
    monkeypatch.setattr(unet_mod, "attention", kernel_route)


def models(comps):
    return comps.text_encoder, comps.text_encoder_2, comps.unet


def held(comps):
    """The captures held for these components' modules."""
    return list(held_graphs(models(comps)).values())


# -- the graph path -------------------------------------------------------


def eager(comps, hp):
    """``stage1`` with the gate as it is on the CPU."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(compute_z, "graph_blockers", GATE)
        return stage1(comps, hp)


def test_graph_path_gives_the_eager_z_exactly(graphs_on, kernel_routes,
                                              wrapper_calls):
    comps = tiny()
    want, counts = eager(comps, hparams())
    assert counts == {"stage1.eager_steps": STEPS}
    eager_calls = dict(wrapper_calls)
    wrapper_calls.clear()
    got, counts = stage1(comps, hparams())
    assert counts == {"stage1.graph_steps": STEPS, "stage1.capture": 1}
    for a, b in zip(want, got):
        assert np.array_equal(a, b)
    assert eager_calls["flash_fwd"] > 0 and eager_calls["short_kv_fwd"] > 0
    assert eager_calls["flash_dq"] == eager_calls["flash_dkv"] > 0
    # every K1-K4 launch of the replays is a wrapper call: the capture's
    # two runs of each pass add two concept-steps' worth to the eager
    # block's 2 x STEPS
    assert wrapper_calls == {k: n // (2 * STEPS) * (2 * STEPS + 2)
                             for k, n in eager_calls.items()}
    # the encoders reach no kernel (their sequences are short); the dest
    # forward has no backward
    sg, = held(comps)
    cap = sg.captured
    assert cap["cond"].eager_calls == 0 and cap["eps"].eager_calls > 0
    assert cap["dest"].eager_calls > 0 and not cap["dest"].bwd


def test_forward_only_capture_replays_k1_k4_through_wrappers(
        comps, kernel_routes, wrapper_calls, recorded):
    unet = comps.unet
    fn = lambda *a: (sdxl._unet_eps(unet, *a),)  # noqa: E731

    def inputs(seed):
        g = torch.Generator().manual_seed(seed)
        return (torch.randn(3, 4, LATENT, LATENT, generator=g),
                torch.tensor([10, 400, 900]),
                torch.randn(3, 16, 32, generator=g),
                torch.randn(3, 16, generator=g),
                sdxl_time_ids(3, 2 * LATENT, 2 * LATENT))

    with torch.no_grad():
        want = fn(*inputs(2))[0]
    calls = dict(wrapper_calls)
    assert calls["flash_fwd"] > 0 and calls["short_kv_fwd"] > 0
    assert "flash_dq" not in calls
    cap = graphs.capture(fn, inputs(1), graph_type=RecordingGraph)
    assert not cap.bwd and not cap.grad_outputs
    assert all(g is None for g in cap.grad_inputs)
    assert cap.eager_calls == calls["flash_fwd"] + calls["short_kv_fwd"]
    assert cap.graphs == cap.eager_calls + 1
    wrapper_calls.clear()
    got, = cap(*inputs(2))
    assert wrapper_calls == calls
    assert not got.requires_grad and torch.equal(got, want)


def test_one_capture_then_replays_across_blocks(graphs_on, kernel_routes):
    """Two blocks at other hparams: the first captures once, the second
    only replays, and its z is the eager z at its own hparams."""
    comps = tiny()
    counts = [stage1(comps, hparams())[1]]
    other = hparams(v_lr=0.05, v_weight_decay=0.1, v_num_grad_steps=2,
                    text_repr_loss_scale_factor=0.1)
    got, c = stage1(comps, other)
    counts.append(c)
    assert counts == [{"stage1.graph_steps": STEPS, "stage1.capture": 1},
                      {"stage1.graph_steps": 2}]
    assert len(held(comps)) == 1
    want, c = eager(comps, other)
    assert c == {"stage1.eager_steps": 2}
    for a, b in zip(want, got):
        assert np.array_equal(a, b)


# -- the gate -------------------------------------------------------------


@pytest.mark.parametrize("case", ["cpu", "mesh", "no_grad", "text1_hook",
                                  "text2_hook", "unet_hook", "fused_gn",
                                  "fused_ln"])
def test_gate_names_each_blocker(comps, monkeypatch, case):
    want = {"cpu": "device", "mesh": "mesh", "no_grad": "no grad",
            "fused_gn": "fused norms", "fused_ln": "fused norms"}.get(
                case, "hooks")
    if case.startswith("fused"):
        monkeypatch.setenv(f"EMCID_TPU_{case.upper()}", "1")
    mesh = get_mesh(["cpu", "cpu"]) if case == "mesh" else None
    handle = None
    if case.endswith("_hook"):
        model = {"text1": comps.text_encoder, "text2": comps.text_encoder_2,
                 "unet": comps.unet}[case[:-5]]
        handle = next(m for m in model.modules() if m is not model) \
            .register_forward_hook(lambda *a: None)
    try:
        with torch.set_grad_enabled(case != "no_grad"):
            why = graph_blockers(*models(comps), mesh=mesh)
            alone = on_cuda(comps.text_encoder, comps.unet, mesh=mesh)
    finally:
        if handle is not None:
            handle.remove()
    assert want in why and why[0] == "device"  # the CPU blocks every case
    assert (len(why) == 1) == (case == "cpu")
    # encoder 2's hooks are seen only where the gate is given encoder 2
    assert (want in alone) == (case not in ("cpu", "text2_hook"))


@pytest.mark.parametrize("case", ["cpu", "mesh", "text2_hook", "fused_gn"])
def test_blocked_steps_stay_eager_and_are_counted(graphs_on, kernel_routes,
                                                  monkeypatch, case):
    comps = tiny()
    if case == "cpu":
        monkeypatch.setattr(compute_z, "graph_blockers", GATE)
    if case == "fused_gn":
        monkeypatch.setenv("EMCID_TPU_FUSED_GN", "1")
    handle = None
    if case == "text2_hook":
        handle = comps.text_encoder_2.text_model.final_layer_norm \
            .register_forward_pre_hook(lambda *a: None)
    mesh = get_mesh(["cpu", "cpu"]) if case == "mesh" else None
    try:
        _, counts = stage1(comps, hparams(v_num_grad_steps=2), mesh=mesh)
    finally:
        if handle is not None:
            handle.remove()
    assert counts == {"stage1.eager_steps": 2}
    assert not held(comps)


# -- the cache ------------------------------------------------------------


def test_key_is_the_modules_and_shapes(comps, ungated, monkeypatch):
    mods = models(comps)
    shapes = ((1, 2), 3, 16, (LATENT, LATENT))
    key = graph_key(mods, shapes)
    assert key == graph_key(mods, shapes)
    assert all(key != graph_key(mods, other) for other in (
        ((1, 2), 2, 16, (LATENT, LATENT)),
        ((1, 2), 3, 16, (LATENT, 2 * LATENT)),
        ((0, 2), 3, 16, (LATENT, LATENT))))
    # a module's dtype and the attention routing
    lin = [torch.nn.Linear(2, 2) for _ in range(3)]
    monkeypatch.delenv("EMCID_TPU_NO_FLASH", raising=False)
    key = graph_key(lin, shapes)
    monkeypatch.setenv("EMCID_TPU_NO_FLASH", "1")
    assert key != graph_key(lin, shapes)
    monkeypatch.delenv("EMCID_TPU_NO_FLASH")
    assert key == graph_key(lin, shapes)
    lin[1].double()
    assert key != graph_key(lin, shapes)
    assert stage1_graphs(mods, shapes) is stage1_graphs(mods, shapes)

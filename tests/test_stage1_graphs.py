"""Stage 1's CUDA-graph path (``emcid_torch/ops/graphs.py``,
``engine/compute_z``) on the CPU at tiny widths, where no graph can be
captured: the gate picks the eager path on the CPU, with a mesh, with
hooks, under no-grad and with the fused norms, and the counters record
eager steps there; a capture split at the K1-K4 autograd functions
(``torch_parity.RecordingGraph`` stands in for CUDA's graph) gives the
unsplit forward and input gradients exactly, and each call it left out
replays through the kernels' wrappers to the same outputs; with recording
graphs the whole Stage 1 gives the eager z exactly; the captures of SD's
and SDXL's Stage 1 share one cache, keyed on the modules and the shapes,
not the hparams, apart where the two share modules, and go with their
modules.  Replays on the card: ``chip_smoke.py --stage1-graphs``."""

import dataclasses
import functools
import gc
import weakref

import pytest
import torch

import emcid_torch.hparams as thp
from emcid_torch import profiling
from emcid_torch.engine import compute_z
from emcid_torch.engine.compute_z import (
    ZOptimizer,
    concept_batch_to_device,
    graph_blockers,
    graph_key,
    held_graphs,
    prepare_concept_batch,
    stage1_graphs,
)
from emcid_torch.models import unet as unet_mod
from emcid_torch.models.loader import build_tiny_pipeline
from emcid_torch.models.unet import unet_taps
from emcid_torch.ops import attention as attn_mod
from emcid_torch.ops import flash_v2, graphs
from emcid_torch.parallel import get_mesh
from torch_parity import RecordingGraph, one_torch_thread, recorded  # noqa: F401

STEPS = 3
LATENT = 16  # 256 tokens at level 0: its self-attention reaches K1-K3
KERNEL_MIN_SEQ = 256  # stands in for EMCID_TPU_FLASH_MIN_SEQ at this size
COUNTERS = ("stage1.graph_steps", "stage1.eager_steps", "stage1.capture")
GATE = compute_z.graph_blockers


@pytest.fixture(scope="module")
def comps():
    return build_tiny_pipeline(device="cpu")


def hparams(**change):
    hp = thp.EMCIDHyperParams.from_dict({
        "layers": [1, 2], "clamp_norm_factor": 1.5,
        "layer_selection": "all", "fact_token": "subject_last",
        "v_num_grad_steps": STEPS, "v_lr": 0.2, "v_weight_decay": 5e-4,
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
    return dataclasses.replace(hp, **change)


def batch_of(comps, C=1):
    reqs = [{"prompts": ["a photo of a {}", "an image of a {}"],
             "source": f"w{2 * i}", "dest": f"w{2 * i + 1}"}
            for i in range(C)]
    arrays, _, _ = prepare_concept_batch(comps.tokenizer, reqs, hparams())
    g = torch.Generator().manual_seed(0)
    shape = (C, 1, 2, LATENT, LATENT, 4)
    arrays["latents_mean"] = torch.randn(shape, generator=g)
    arrays["latents_logvar"] = torch.full(shape, -6.0)
    return concept_batch_to_device(arrays, "cpu")


def optimizer(comps, **change):
    return ZOptimizer(comps.text_encoder, comps.unet, comps.schedule,
                      hparams(**change), layer=2, eps_pool=0)


def stage1(comps, C=1):
    """A Stage-1 block of ``C`` concepts under a recording -> (z, the
    Stage-1 counters)."""
    with profiling.recording("cpu") as rec:
        zs = optimizer(comps).run(batch_of(comps, C))[0]
    return zs, {k: v["n"] for k, v in rec.summary().items()
                if k in COUNTERS}


def on_cuda(*models, **k):
    """``graph_blockers`` as on the card: without its ``device`` entry."""
    return [w for w in GATE(*models, **k) if w != "device"]


@pytest.fixture
def graphs_on(monkeypatch, recorded):
    """The graph path on the CPU: the gate as on the card, captures with
    recording graphs, the CUDA synchronize and cache calls made no-ops."""
    monkeypatch.setattr(compute_z, "graph_blockers", on_cuda)
    monkeypatch.setattr(compute_z.cuda_graphs, "capture", functools.partial(
        graphs.capture, graph_type=RecordingGraph))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)


@pytest.fixture
def ungated(monkeypatch):
    """The cache reached on the CPU: a gate that finds nothing."""
    monkeypatch.setattr(compute_z, "graph_blockers", lambda *a, **k: [])


def kernel_route(q, k, v, scale=None):
    """``ops.attention.attention`` as it routes CUDA tensors, on the CPU
    (the wrappers compute their plain versions there)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if max(q.shape[1], k.shape[1]) < KERNEL_MIN_SEQ:
        return attn_mod._block_attention(q, k, v, scale)
    if k.shape[1] >= attn_mod.SHORT_KV_MAX:
        return flash_v2.flash_attention_v2(q, k, v, scale)
    return attn_mod.flash_attention(q, k, v, scale)


@pytest.fixture
def kernel_routes(monkeypatch):
    monkeypatch.setattr(unet_mod, "attention", kernel_route)


@pytest.fixture
def wrapper_calls(monkeypatch):
    """Calls of each K1-K4 wrapper, counted around the module attribute
    (as a profiler wrapper would be)."""
    calls = {}
    for mod, name in ((flash_v2, "flash_fwd"), (flash_v2, "flash_dq"),
                      (flash_v2, "flash_dkv"), (attn_mod, "short_kv_fwd")):
        def counted(*a, _orig=getattr(mod, name), _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _orig(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    return calls


def eps_case(comps):
    """The UNet's eps as Stage 1 calls it, its inputs and an output
    gradient."""
    g = torch.Generator().manual_seed(1)
    B, S, H = 2, comps.tokenizer.model_max_length, 32
    noisy = torch.randn(B, 4, LATENT, LATENT, generator=g)
    t = torch.tensor([10, 700])
    ctx = torch.randn(B, S, H, generator=g).requires_grad_()
    gy = (torch.randn(B, 4, LATENT, LATENT, generator=g),)
    unet = comps.unet
    return (lambda x, s, c: (ZOptimizer._eps(unet, x, s, c),),
            (noisy, t, ctx), gy)


def text_case(comps):
    """The text model with a delta injected at layer 2, its inputs and the
    output gradients of the hidden states and the pooler."""
    g = torch.Generator().manual_seed(2)
    tok = comps.tokenizer(["a photo of a w1", "an image of a w3"],
                          padding="max_length", truncation=True,
                          max_length=comps.tokenizer.model_max_length)
    ids = torch.as_tensor(tok["input_ids"])
    S = ids.shape[1]
    delta = torch.randn(2, S, 32, generator=g).requires_grad_()
    gy = (torch.randn(2, S, 32, generator=g), torch.randn(2, 32, generator=g))
    text = comps.text_encoder
    return (lambda i, d: tuple(text(i, inject_layer=2, inject_delta=d)[:2]),
            (ids, delta), gy)


def passes(fn, inputs, gy, sess=None):
    """The outputs and the input gradients of ``fn``, and, with a session,
    the items of its forward and its backward."""
    wrt = [x for x in inputs if x.requires_grad]
    graphs._SESSION = sess
    try:
        if sess:
            sess.begin()
        out = fn(*inputs)
        fwd = sess.cut() if sess else None
        if sess:
            sess.begin()
        grads = torch.autograd.grad(out, wrt, gy)
        bwd = sess.cut() if sess else None
    finally:
        graphs._SESSION = None
    return [o.detach() for o in out], list(grads), fwd, bwd


def eager_items(items):
    return [it for it in items if isinstance(it, graphs._Eager)]


def alternates(items) -> bool:
    """Graphs and eager calls in turn, a graph first and last."""
    kinds = [isinstance(it, RecordingGraph) for it in items]
    return kinds[0] and kinds[-1] and all(a != b for a, b in
                                          zip(kinds, kinds[1:]))


# -- the gate -------------------------------------------------------------


@pytest.mark.parametrize("case", ["cpu", "mesh", "no_grad", "unet_hook",
                                  "text_hook", "fused_gn", "fused_ln"])
def test_gate_names_each_blocker(comps, monkeypatch, case):
    want = {"cpu": "device", "mesh": "mesh", "no_grad": "no grad",
            "unet_hook": "hooks", "text_hook": "hooks",
            "fused_gn": "fused norms", "fused_ln": "fused norms"}[case]
    mesh = get_mesh(["cpu", "cpu"]) if case == "mesh" else None
    if case.startswith("fused"):
        monkeypatch.setenv(f"EMCID_TPU_{case.upper()}", "1")
    handle = None
    if case == "unet_hook":
        handle = comps.unet.up_blocks[0].resnets[0].register_forward_hook(
            lambda *a: None)
    if case == "text_hook":
        handle = comps.text_encoder.text_model.final_layer_norm \
            .register_forward_pre_hook(lambda *a: None)
    try:
        with torch.set_grad_enabled(case != "no_grad"):
            why = graph_blockers(comps.text_encoder, comps.unet, mesh=mesh)
    finally:
        if handle is not None:
            handle.remove()
    assert want in why
    assert why[0] == "device"  # the CPU blocks every case here
    assert (len(why) == 1) == (case == "cpu")


def test_unet_taps_count_as_hooks(comps):
    with unet_taps(comps.unet, {"down_blocks.0.resnets.0": "conv2_out"}):
        assert "hooks" in graph_blockers(comps.text_encoder, comps.unet)
    assert "hooks" not in graph_blockers(comps.text_encoder, comps.unet)


@pytest.mark.parametrize("case", ["cpu", "mesh", "hooks"])
def test_eager_steps_are_counted(comps, case):
    C = 2 if case == "mesh" else 1
    mesh = get_mesh(["cpu", "cpu"]) if case == "mesh" else None
    with profiling.recording("cpu") as rec:
        if case == "hooks":
            with unet_taps(comps.unet,
                           {"down_blocks.0.resnets.0": "conv2_out"}):
                optimizer(comps).run(batch_of(comps, C), mesh=mesh)
        else:
            optimizer(comps).run(batch_of(comps, C), mesh=mesh)
    s = rec.summary()
    assert s["stage1.eager_steps"]["n"] == STEPS
    assert "stage1.graph_steps" not in s and "stage1.capture" not in s


def test_counts_in_summary_and_outer_recording():
    profiling.count("test.count")  # no recording: nothing kept
    with profiling.recording("cpu") as outer:
        with profiling.recording("cpu") as inner:
            profiling.count("test.count")
            profiling.count("test.count", 2)
        profiling.count("test.count")
    assert inner.summary()["test.count"] == {"n": 3, "host_s": [],
                                             "device_s": None}
    assert outer.summary()["test.count"]["n"] == 4


# -- the split capture ----------------------------------------------------


@pytest.mark.parametrize("case", [eps_case, text_case],
                         ids=["unet_eps", "text_inject"])
def test_split_pass_equals_unsplit_exactly(comps, kernel_routes,
                                           wrapper_calls, case):
    fn, inputs, gy = case(comps)
    out0, grads0, _, _ = passes(fn, inputs, gy)
    calls = dict(wrapper_calls)
    wrapper_calls.clear()
    out1, grads1, fwd, bwd = passes(fn, inputs, gy,
                                    graphs._Session(None, RecordingGraph))
    assert wrapper_calls == calls
    for a, b in zip(out0 + grads0, out1 + grads1):
        assert torch.equal(a, b)
    # a cut at every K1-K4 call: the forward bodies of K1 and K4, the
    # backward bodies of K1's function (K2, K3; none for an attention that
    # depends on nothing that requires grad); K4's backward stays in the
    # graphs
    assert alternates(fwd) and alternates(bwd)
    k1, k4 = calls.get("flash_fwd", 0), calls.get("short_kv_fwd", 0)
    k2 = calls.get("flash_dq", 0)
    assert calls.get("flash_dkv", 0) == k2
    fwd_fns = [it.fn for it in eager_items(fwd)]
    assert len(fwd_fns) == k1 + k4
    assert fwd_fns.count(flash_v2._fwd) == k1
    assert fwd_fns.count(attn_mod._short_fwd) == k4
    assert [it.fn for it in eager_items(bwd)] == [flash_v2._bwd] * k2
    if case is eps_case:
        assert k1 > k2 > 0 and k4 > 0
    else:
        assert len(fwd) == len(bwd) == 1  # the text model reaches no kernel


def test_left_out_calls_replay_through_the_wrappers(comps, kernel_routes,
                                                    wrapper_calls):
    fn, inputs, gy = eps_case(comps)
    _, _, fwd, bwd = passes(fn, inputs, gy,
                            graphs._Session(None, RecordingGraph))
    items = eager_items(fwd) + eager_items(bwd)
    kept = [[o.clone() for o in it.outs] for it in items]
    for it in items:
        for o in it.outs:
            o.zero_()
    calls = dict(wrapper_calls)
    wrapper_calls.clear()
    for it in items:
        it.replay()
    assert wrapper_calls == calls
    for it, outs in zip(items, kept):
        assert all(torch.equal(a, b) for a, b in zip(it.outs, outs))


def test_capture_holds_no_module(kernel_routes):
    comps = build_tiny_pipeline(device="cpu")
    fn, inputs, _ = eps_case(comps)
    cap = graphs.capture(fn, inputs, graph_type=RecordingGraph)
    ref = weakref.ref(comps.unet)
    assert cap.graphs == cap.eager_calls + 2
    del comps, fn
    gc.collect()
    assert ref() is None


# -- the graph path -------------------------------------------------------


def test_graph_path_gives_the_eager_z_exactly(graphs_on, kernel_routes,
                                              wrapper_calls):
    comps = build_tiny_pipeline(device="cpu")
    with pytest.MonkeyPatch.context() as m:
        m.setattr(compute_z, "graph_blockers", GATE)
        want, counts = stage1(comps)
    assert counts == {"stage1.eager_steps": STEPS}
    eager_calls = dict(wrapper_calls)
    wrapper_calls.clear()
    got, counts = stage1(comps)
    assert counts == {"stage1.graph_steps": STEPS, "stage1.capture": 1}
    assert torch.equal(got, want)
    assert eager_calls["flash_fwd"] > 0 and eager_calls["short_kv_fwd"] > 0
    assert eager_calls["flash_dq"] == eager_calls["flash_dkv"] > 0
    # every K1-K4 launch of the replays is a wrapper call: the capture's
    # two runs of the edited pass add two steps' worth of its calls to the
    # eager block's (a step's forwards: the edited one and the eager dest)
    fwd = ("flash_fwd", "short_kv_fwd")
    assert wrapper_calls == {
        k: n + 2 * (n // (2 * STEPS) if k in fwd else n // STEPS)
        for k, n in eager_calls.items()}


def test_one_capture_per_shape_then_replays(graphs_on, kernel_routes):
    """The whole path with recording graphs: the first block captures
    once, the second replays every step, and the captures go with the
    models."""
    comps = build_tiny_pipeline(device="cpu")
    counts = [stage1(comps)[1] for _ in range(2)]
    assert counts == [{"stage1.graph_steps": STEPS, "stage1.capture": 1},
                      {"stage1.graph_steps": STEPS}]
    models = (comps.text_encoder, comps.unet)
    sg, = held_graphs(models).values()
    assert sg.captured["eps"].eager_calls > 0
    assert sg.captured["text"].eager_calls == 0
    refs = [weakref.ref(m) for m in models]
    del comps, models, sg
    gc.collect()
    assert all(r() is None for r in refs)


# -- the cache ------------------------------------------------------------


def test_key_ignores_hparams(comps, ungated):
    batch = batch_of(comps)
    a = optimizer(comps)
    b = optimizer(comps, v_lr=0.05, v_weight_decay=0.1,
                  cal_text_repr_loss=False, v_num_grad_steps=50)
    models = (comps.text_encoder, comps.unet)
    shapes = a.graph_shapes(batch)
    assert shapes == b.graph_shapes(batch)
    assert stage1_graphs(models, shapes) is stage1_graphs(
        models, b.graph_shapes(batch))
    assert graph_key(models, shapes) != graph_key(
        models, a.graph_shapes(batch_of(comps, 2)))


@pytest.mark.parametrize("case", ["sd", "sdxl", "sd_beside_sdxl"])
def test_captures_go_with_their_modules(ungated, case):
    """SD's (text, unet) and SDXL's (text1, text2, unet): a capture goes
    with any one of its modules; over shared modules (SDXL's encoder 1 and
    UNet in SD's Stage 1) the two sit apart."""
    if case == "sd_beside_sdxl":
        text1, text2, unet = (torch.nn.Linear(2, 2) for _ in range(3))
        sd = stage1_graphs((text1, unet), ("k",))
        xl = stage1_graphs((text1, text2, unet), ("k",))
        assert sd is not xl
        assert stage1_graphs((text1, unet), ("k",)) is sd
        assert stage1_graphs((text1, text2, unet), ("k",)) is xl
        assert list(held_graphs((text1, unet)).values()) == [sd]
        assert list(held_graphs((text1, text2, unet)).values()) == [xl]
        return
    n = 2 if case == "sd" else 3
    for gone in range(n):
        models = [torch.nn.Linear(2, 2) for _ in range(n)]
        sg = stage1_graphs(models, ("k",))
        assert held_graphs(models)[graph_key(models, ("k",))] is sg
        refs = weakref.ref(sg), weakref.ref(models[gone])
        del models[gone], sg
        gc.collect()
        assert refs[0]() is None and refs[1]() is None

"""The port's program spans (``emcid_torch.profiling``) on the CPU at tiny
widths: off, they create no CUDA event and open no profiler range; under
``recording()`` they count the Stage-1 steps that ran, the eps_dest pool
once per block and every sampler evaluation; ``apply_emcid(timings=)``'s
phases are the host seconds of their spans; recording leaves the results
bitwise alone; the verbose Stage-1 line reports the steps that ran."""

import contextlib
import io

import numpy as np
import pytest
import torch

import emcid_torch.hparams as thp
from emcid_torch import profiling
from emcid_torch.engine.editor import apply_emcid
from emcid_torch.models.loader import build_tiny_pipeline
from emcid_torch.models.pipeline import generate
from emcid_torch.models.scheduler import ddim_timesteps, run_sampler

REQUESTS = [
    {"prompts": ["a photo of a {}", "an image of a {}"], "source": "cat",
     "dest": "dog", "seed_train": 0},
    {"prompts": ["a photo of a {}", "an image of a {}"], "source": "w1",
     "dest": "w2", "seed_train": 1},
]
POOL = 4  # eps_dest pool size of the edit runs
TRAIN_STEPS = 2  # DPM++ evaluations per block of training images


def hparams(steps):
    return thp.EMCIDHyperParams.from_dict({
        "layers": [1, 2], "clamp_norm_factor": 1.5,
        "layer_selection": "all", "fact_token": "subject_last",
        "v_num_grad_steps": steps, "v_lr": 0.2, "v_weight_decay": 5e-4,
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


def edit(comps, tmp, steps, timings=None, verbose=False, block_size=8):
    """``apply_emcid`` with every product knob stated: DPM++ training
    images, the cosine z schedule, a pool of ``POOL``, native resolution."""
    return apply_emcid(
        comps, REQUESTS, hparams(steps), stats_dir=tmp / "s",
        fim_dir=tmp / "f", block_size=block_size, train_sampler="dpm++",
        train_steps=TRAIN_STEPS, eps_dest_pool=POOL, z_sched="cosine",
        cfg_interval=1.0, train_res=0, timings=timings, verbose=verbose)


@pytest.fixture(scope="module")
def comps():
    return build_tiny_pipeline(device="cpu")


@pytest.fixture(scope="module")
def recorded(comps, tmp_path_factory):
    """One recorded, verbose edit of two concepts in two blocks of one at
    ``v_num_grad_steps`` 50: (timings, span summary, printed lines,
    fc2 weights written)."""
    tmp = tmp_path_factory.mktemp("rec")
    timings = {}
    out = io.StringIO()
    with profiling.recording("cpu") as rec, contextlib.redirect_stdout(out):
        edited, _ = edit(comps, tmp, 50, timings=timings, verbose=True,
                         block_size=1)
    w = {k: v.clone() for k, v in edited.text_encoder.named_parameters()}
    return timings, rec.summary(), out.getvalue().splitlines(), w


@pytest.fixture
def no_events_no_ranges(monkeypatch):
    """``torch.cuda.Event`` and ``record_function`` raise if called."""
    def boom(*a, **k):
        raise AssertionError("created while recording is off")

    monkeypatch.setattr(torch.cuda, "Event", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)


def test_off_span_is_one_shared_object():
    assert profiling._RECORDER is None
    assert profiling.span("stage1.step") is profiling.OFF
    assert profiling.span("sampler.step") is profiling.OFF


def test_off_apply_emcid_makes_no_event_or_range(comps, tmp_path,
                                                 no_events_no_ranges):
    timings = {}
    edit(comps, tmp_path, 3, timings=timings)
    assert set(timings) == {"covariances", "generation", "stage1", "stage2"}
    assert profiling._RECORDER is None


def test_off_generate_makes_no_event_or_range(comps, no_events_no_ranges):
    imgs = generate(comps, ["a photo of a cat"], [0], num_inference_steps=2,
                    height=16, width=16)
    assert imgs.shape == (1, 16, 16, 3)
    assert profiling._RECORDER is None


def test_stage1_steps_are_the_steps_that_ran(recorded):
    _, summary, _, _ = recorded
    # cosine schedule: z_frac 0.6 of v_num_grad_steps 50, per block
    assert summary["stage1.step"]["n"] == 2 * 30


def test_pool_once_per_block(recorded):
    _, summary, _, _ = recorded
    assert summary["stage1.pool"]["n"] == 2


def test_training_images_sampler_steps(recorded):
    _, summary, _, _ = recorded
    assert summary["sampler.step"]["n"] == 2 * TRAIN_STEPS


def test_phase_spans_are_the_timings(recorded):
    timings, summary, _, _ = recorded
    spans = {"covariances": "edit.covariances",
             "generation": "edit.train_images", "stage1": "edit.stage1",
             "stage2": "edit.stage2"}
    assert set(timings) == set(spans)
    for key, name in spans.items():
        assert timings[key] == sum(summary[name]["host_s"])
        assert timings[key] > 0
    assert summary["edit.stage1"]["n"] == 2


def test_spans_nest_inside_their_phase(recorded):
    _, summary, _, _ = recorded
    steps = sum(summary["stage1.step"]["host_s"])
    pool = sum(summary["stage1.pool"]["host_s"])
    assert 0 < steps + pool <= sum(summary["edit.stage1"]["host_s"])


def test_no_device_clock_on_the_cpu(recorded):
    _, summary, _, _ = recorded
    assert all(d["device_s"] is None for d in summary.values())


def test_verbose_line_reports_steps_that_ran(recorded):
    _, _, lines, _ = recorded
    s1 = [l for l in lines if l.startswith("stage1 block")]
    assert len(s1) == 2
    assert all("1 concepts, 30 steps in" in l for l in s1)
    assert not any("incl. image gen" in l for l in s1)


def test_recording_leaves_the_edit_bitwise(recorded, comps, tmp_path):
    *_, w_rec = recorded
    edited, _ = edit(comps, tmp_path, 50, block_size=1)
    for k, v in edited.text_encoder.named_parameters():
        assert torch.equal(v, w_rec[k]), k


@pytest.mark.parametrize("sampler,evals", [("pndm", 4), ("ddim", 3),
                                           ("dpm++", 3)])
def test_generate_sampler_steps(comps, sampler, evals):
    with profiling.recording("cpu") as rec:
        generate(comps, ["a photo of a cat", "w3"], [0, 1],
                 num_inference_steps=3, height=16, width=16, sampler=sampler)
    s = rec.summary()
    assert s["sampler.step"]["n"] == evals
    assert set(s) == {"sampler.step"}


@pytest.mark.parametrize("sampler", ["pndm", "ddim", "dpm++"])
def test_run_sampler_bitwise_with_and_without_recording(comps, sampler):
    sched = comps.schedule
    ts = ddim_timesteps(sched, 4)
    ts_prev = np.concatenate([ts[1:], [-1]]).astype(np.int32)
    gen = torch.Generator().manual_seed(3)
    lat = torch.randn(2, 4, 8, 8, generator=gen)
    ctx = torch.randn(2, 7, 32, generator=gen)

    def eps(x, t):
        return comps.unet(x, torch.tensor([t]), ctx).sample

    with torch.no_grad():
        off = run_sampler(sampler, sched, eps, lat, ts, ts_prev)
        with profiling.recording("cpu") as rec:
            on = run_sampler(sampler, sched, eps, lat, ts, ts_prev)
    assert torch.equal(off, on)
    assert rec.summary()["sampler.step"]["n"] == (5 if sampler == "pndm"
                                                  else 4)


def test_nested_recording_hands_spans_out():
    with profiling.recording() as outer:
        with profiling.span("a"):
            with profiling.recording() as inner:
                with profiling.span("b"):
                    pass
        assert [s.name for s in inner.spans] == ["b"]
    assert [s.name for s in outer.spans] == ["b", "a"]
    assert profiling._RECORDER is None


def test_each_closes_its_span_on_break_and_error():
    with profiling.recording("cpu") as rec:
        for i in profiling.each("loop", range(5)):
            if i == 2:
                break
        with pytest.raises(ValueError):
            for i in profiling.each("fails", range(3)):
                raise ValueError
    s = rec.summary()
    assert s["loop"]["n"] == 3 and s["fails"]["n"] == 1


def test_phase_adds_without_recording():
    timings = {"stage1": 1.0}
    with profiling.phase("edit.stage1", timings, "stage1") as p:
        pass
    assert timings["stage1"] == 1.0 + p.seconds
    with profiling.phase("edit.sld", None, "sld"):
        pass
    assert profiling._RECORDER is None


def test_spans_land_in_a_profiler_trace_without_recording(comps):
    """Under ``torch.profiler`` a span opens a range of its name, so its
    device operations can be put down to it on the profiler's clock."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        generate(comps, ["w4"], [2], num_inference_steps=2, height=16,
                 width=16, sampler="ddim")
    names = [e.name for e in prof.events()]
    assert names.count("sampler.step") == 2
    assert profiling._RECORDER is None


def test_stage1_report_counts_the_pool_once(comps):
    from emcid_torch.engine.editor import make_optimizer, stage1_report
    from emcid_torch.profiling import unet_fwd_flops

    optz = make_optimizer(comps, hparams(50), eps_pool=POOL)
    rep = stage1_report(comps, optz, 2, 3, 16, 30, 1.5)
    fwd = unet_fwd_flops(comps.unet.config, 6, 8)
    assert rep.steps == 30 and rep.seconds == 1.5
    assert rep.flops_per_step * 30 == pytest.approx((2 * 30 + POOL) * fwd)
    none = stage1_report(comps, make_optimizer(comps, hparams(50)), 2, 3, 16,
                         30, 1.5)
    assert none.flops_per_step == pytest.approx(3 * fwd)

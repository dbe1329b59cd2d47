"""The program's spans as the benchmark reads them: the reduction of a
chrome trace by span (``portbench.spans``), each span reader on synthetic
facts, and the traced tiny cells on the CPU with the spans recorded
(``portbench.probe``), where only the host-clock reader has a value."""

import importlib.util
import statistics
from pathlib import Path

import pytest

from portbench import probe
from portbench.spans import reduce_spans
from portbench.tests import tiny

METRICS = Path(__file__).resolve().parents[1] / "metrics"
SEED = 2 ** 31 + 404


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "span_reader_" + name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def rng(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "tid": 1}


def launch(corr, ts, cat="cuda_runtime", tid=1):
    return {"ph": "X", "cat": cat, "name": "cudaLaunchKernel", "ts": ts,
            "dur": 2, "tid": tid, "args": {"correlation": corr}}


def op(corr, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": f"k{corr}", "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


TRACE = [
    rng("portbench.window", 0, 1000),
    rng("stage1.step", 100, 200),
    rng("inner", 150, 50),
    rng("stage1.step", 400, 200),
    launch(1, 120), op(1, 130, 50),
    # from another thread, inside the nested range; overlaps op 1
    launch(2, 160, tid=7), op(2, 170, 50),
    launch(3, 350), op(3, 360, 10),  # between the steps
    launch(4, 420), op(4, 430, 50),
    launch(5, 450, cat="cuda_driver"), op(5, 470, 60, cat="gpu_memcpy"),
    launch(6, 1200), op(6, 1210, 10),  # outside every range
    op(99, 500, 5),  # no launch record
    {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 130, "id": 1},
]


def test_reduce_spans_innermost_by_correlation():
    out = reduce_spans(TRACE)
    step = out["stage1.step"]
    assert step["spans"] == 2 and step["launches"] == 3
    # [130, 180] + the union of [430, 480] and [470, 530]
    assert step["busy_s"] == pytest.approx(150e-6)
    assert step["extent_s"] == pytest.approx(400e-6)
    assert out["inner"] == pytest.approx(
        {"spans": 1, "launches": 1, "busy_s": 50e-6, "extent_s": 50e-6})
    assert out["portbench.window"]["launches"] == 1
    assert sum(d["launches"] for d in out.values()) == 5


def test_reduce_spans_nothing_launched():
    out = reduce_spans([rng("sampler.step", 0, 10), launch(1, 20),
                        op(1, 25, 5)])
    assert out == {"sampler.step": {"spans": 1, "launches": 0, "busy_s": 0.0,
                                    "extent_s": 0.0}}


def edit_facts():
    return {"kind": "edit", "blocks": 1,
            "program": {"stage1.step": {"n": 3, "host_s": [0.1, 0.3, 0.2],
                                        "device_s": [0.12, 0.11, 0.4]},
                        "stage1.pool": {"n": 1, "host_s": [0.5],
                                        "device_s": [1.25]}},
            "trace": {"spans": reduce_spans(TRACE)}}


def gen_facts():
    return {"kind": "gen",
            "program": {"sampler.step": {"n": 4, "host_s": [0.1] * 4,
                                         "device_s": [0.2, 0.1, 0.3, 0.4]}},
            "trace": {"spans": {"sampler.step": {
                "spans": 4, "launches": 10, "busy_s": 1.0,
                "extent_s": 1.0}}}}


@pytest.mark.parametrize("name,value", [
    ("stage1_step_ms", 120.0), ("stage1_host_ms", 200.0), ("pool_s", 1.25),
    ("launches_per_step.stage1", 1.5), ("idle_share.stage1", 62.5)])
def test_edit_readers(name, value):
    read = reader(name)
    assert read(edit_facts()) == pytest.approx(value)
    assert read({"kind": "edit"}) is None
    assert read({"kind": "edit", "program": {}, "trace": {}}) is None
    assert read(dict(edit_facts(), kind="gen")) is None


@pytest.mark.parametrize("name,value", [
    ("sampler_step_ms", statistics.median([200, 100, 300, 400])),
    ("launches_per_step.sampler", 2.5)])
def test_gen_readers(name, value):
    read = reader(name)
    assert read(gen_facts()) == pytest.approx(value)
    assert read({"kind": "gen"}) is None
    assert read(dict(gen_facts(), kind="edit")) is None


@pytest.mark.parametrize("name", ["stage1_step_ms", "pool_s"])
def test_device_clock_readers_none_without_a_card(name):
    f = edit_facts()
    for d in f["program"].values():
        d["device_s"] = None
    assert reader(name)(f) is None


def test_every_span_metric_has_a_reader():
    for m in probe.SPAN_METRICS:
        assert (METRICS / f"{m['name']}.py").exists()


def test_probe_tiny_edit_cell():
    line, facts = probe.probe("sd14-edit-b1", SEED, 0.05, "cpu",
                              cfg=tiny.config_for("sd14-edit-b1"),
                              traffic=tiny.traffic("edit-b1"))
    assert line["correct"]
    m = line["metrics"]
    assert m["stage1_host_ms"]["unit"] == "ms" and m["stage1_host_ms"][
        "value"] > 0
    for name in ("stage1_step_ms", "pool_s", "launches_per_step.stage1",
                 "idle_share.stage1"):
        assert name not in m
    assert "stage1_s" in m
    steps = facts["program"]["stage1.step"]
    assert steps["device_s"] is None
    tr = tiny.traffic("edit-b1")
    assert steps["n"] == round(tr["edit"]["z_frac"]
                               * tr["hparams"]["v_num_grad_steps"])
    assert facts["program"]["stage1.pool"]["n"] == 1
    # the traced block's spans reach the trace on the profiler's clock
    assert facts["trace"]["spans"]["stage1.step"]["spans"] == steps["n"]
    checks = probe.cross_checks(facts, m)
    assert checks["stage1_steps"] == steps["n"]


def test_probe_tiny_generate_cell():
    tr = tiny.traffic("iceb-512")
    line, facts = probe.probe("sd14-gen-512", SEED, 0.05, "cpu",
                              cfg=tiny.config_for("sd14-gen-512"),
                              traffic=tr)
    assert line["correct"]
    assert "sampler_step_ms" not in line["metrics"]
    # PNDM-N evaluates N + 1 times
    assert facts["program"]["sampler.step"]["n"] == tr["steps"] + 1
    assert facts["trace"]["spans"]["sampler.step"]["spans"] == tr["steps"] + 1

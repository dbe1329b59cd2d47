"""BENCHMARK.json holds to the benchmark's contract, and every name in it
finds its file: a configuration, a traffic mix, a cell's limits, a
per-layer reader."""

import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_sizes():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= B["run_seconds"] <= 51
    assert B["command"][1:] == ["portbench/run.py"]
    assert all(not p.startswith("/") and ".." not in p for p in B["paths"])


def test_configs():
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]


def test_workloads():
    names = {c["name"] for c in B["configs"]}
    pairs = set()
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "portbench" / "limits" / f"{w['name']}.json").exists()


def test_metrics():
    cells = {w["name"] for w in B["workloads"]}
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                           "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in B["end_to_end"] + B["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in B["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
        layers.setdefault(m["layer"], []).append(m["name"])
    for c in cells:
        reported = [m for m in B["end_to_end"]
                    if c in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(c in m["workloads"] for m in B["per_layer"])

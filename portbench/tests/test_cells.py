"""Every cell of BENCHMARK.json end to end on the CPU at tiny widths: the
result line parses under the benchmark's contract.  Without a card the
command exits with another code than 0 and prints no result."""

import json
import math
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run
from portbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [(w["name"], w["traffic"]) for w in BENCH["workloads"]]


def result_line(cell, traffic, trace, seed=2 ** 31 + 101):
    out = run.run_cell(cell, seed, 0.05, trace, "cpu",
                       cfg=tiny.config_for(cell),
                       traffic=tiny.traffic(traffic))
    return json.loads(json.dumps(out))


def number(x):
    return isinstance(x, (int, float)) and math.isfinite(x)


def check_shape(line, cell, trace):
    assert list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool)
    assert isinstance(line["attempted"], int) and line["attempted"] > 0
    assert line["failed"] == 0
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    assert dev["count"] == 1
    for c in line["checks"].values():
        assert number(c["value"]) and number(c["limit"])
    applies = [m for m in BENCH["per_layer" if trace else "end_to_end"]
               if run.applies(m, cell)]
    units = {m["name"]: m["unit"] for m in applies}
    assert set(line["metrics"]) <= set(units)
    for name, m in line["metrics"].items():
        assert number(m["value"]) and m["unit"] == units[name]
    if trace:
        assert number(dev["busy_s"]) and number(dev["window_s"])
        for key in ("device_ops", "idle_gaps"):
            rows = line["breakdown"][key]
            assert len(rows) <= 10
            assert all(isinstance(n, str) and number(s) for n, s in rows)
    else:
        assert set(line["metrics"]) == set(units)


@pytest.mark.parametrize("cell,traffic", CELLS)
def test_cell_runs(cell, traffic):
    line = result_line(cell, traffic, False)
    check_shape(line, cell, False)
    assert line["correct"]


@pytest.mark.parametrize("cell,traffic", [CELLS[0], CELLS[1]])
def test_cell_traced(cell, traffic):
    line = result_line(cell, traffic, True)
    check_shape(line, cell, True)
    assert line["correct"]
    assert line["metrics"]


def test_no_card_no_result():
    p = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         CELLS[0][0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_needs_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files
    prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0][0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_seed_beyond_32_bits():
    cell, traffic = CELLS[2]
    line = result_line(cell, traffic, False, seed=2 ** 33 + 5)
    assert line["correct"]

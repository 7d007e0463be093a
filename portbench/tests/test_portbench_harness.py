"""The harness end to end at a toy size on the CPU, through the run's
internal device argument (the command itself needs a card)."""

import io
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests.toy import toy_root
from tests_paths import ROOT

CELL = "chr21rep_se100.wgs"
SEED = 2 ** 33 + 5
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def toy_run(tmp_path, trace, device="cpu", **kw):
    root, bench = toy_root(str(tmp_path), **kw)
    out = io.StringIO()
    res = harness.run(CELL, SEED, 3, trace, device=device, root=root,
                      cache=str(tmp_path / "cache"), out=out,
                      log=io.StringIO())
    return res, out.getvalue(), bench


@pytest.mark.parametrize("trace", [False, True])
def test_last_line(tmp_path, trace):
    res, text, bench = toy_run(tmp_path, trace)
    line = json.loads(text.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(res))
    assert list(line) == KEYS + (["breakdown"] if trace else []) + ["checked"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    dev = line["device"]
    assert dev["count"] == 1 and dev["memory_peak_bytes"] >= 0
    for k, n in line["checked"].items():
        assert set(n) == {"value", "limit"} and n["value"] <= n["limit"], k
    names = set(line["metrics"])
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        per = {m["name"] for m in bench["per_layer"]
               if CELL in m.get("workloads", ())}
        # the host's spans and counters read on the CPU; the device's need
        # the card's trace
        assert names <= per
        assert {"search.s_per_batch.se", "resolve.s_per_batch.se",
                "fallback.read_share.se",
                "stream.self_s_per_batch.se"} <= names
    else:
        assert names == {"reads_per_s", "setup_s"}
        assert line["metrics"]["reads_per_s"]["value"] > 0
    assert harness.forbidden_modules() == []


def test_forbidden_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "hsa_tpu_torch_fake", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "hsa_tpu.fake", object())
    assert harness.forbidden_modules() == ["hsa_tpu"]


def run_cmd(cwd):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
         str(SEED), "--seconds", "1", "--trace", "0"], cwd=cwd,
        capture_output=True, text=True, timeout=300)


def test_command_needs_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = run_cmd(ROOT)
    assert r.returncode != 0 and r.stdout == ""


def test_command_fails_with_the_benchmark_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    r = run_cmd(str(tmp_path))
    assert r.returncode != 0 and r.stdout == ""


@pytest.mark.chip
def test_toy_run_on_the_card(tmp_path, card):
    res, _text, _bench = toy_run(tmp_path, True, device=card)
    assert res["correct"] is True
    assert res["device"]["busy_s"] > 0

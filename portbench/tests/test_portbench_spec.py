"""``BENCHMARK.json`` against the rules of its format (names, units, bounds,
sizes), and every name in it against the files the harness finds by it."""

import json
import os
import re

import pytest

from tests_paths import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = ["command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"]


@pytest.fixture(scope="module")
def bench():
    p = os.path.join(ROOT, "BENCHMARK.json")
    assert os.path.getsize(p) <= 64 * 1024
    with open(p) as fh:
        return json.load(fh)


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level(bench):
    assert sorted(bench) == sorted(KEYS)
    assert bench["paths"] == ["portbench"]
    assert all(PATH.match(p) and ".." not in p for p in bench["paths"])
    assert 1 <= len(bench["command"]) <= 32
    assert all(line(w) and not w.startswith("/") for w in bench["command"])
    assert os.path.exists(os.path.join(ROOT, bench["command"][1]))
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    # 2 + 14 runs a cell for the full 24 cells, each run_seconds + 60, two
    # compiles of 90 s a cell and 1,200 s spare fit 43,200 s
    cells = 24
    assert (2 + 14 * cells) * (bench["run_seconds"] + 60) + cells * 180 \
        + 1200 <= 43200


def test_configs(bench):
    names = [c["name"] for c in bench["configs"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert sorted(c) == ["file", "name", "reduced", "source", "why"]
        assert NAME.match(c["name"]) and c["name"] in used
        assert line(c["source"]) and line(c["why"])
        assert c["file"].startswith("portbench/")
        with open(os.path.join(ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert "assumed" in cfg
    assert len({c["file"] for c in bench["configs"]}) == len(names)


def test_workloads(bench):
    ws = bench["workloads"]
    assert 1 <= len(ws) <= 24
    assert len({w["name"] for w in ws}) == len(ws)
    assert len({(w["config"], w["traffic"]) for w in ws}) == len(ws)
    four = sum(w["chips"] == 4 for w in ws)
    assert four <= max(1, len(ws) // 4)
    for w in ws:
        assert sorted(w) == ["chips", "config", "name", "traffic", "why"]
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line(w["why"])
        for sub in (("traffic", w["traffic"]), ("cells", w["name"])):
            assert os.path.exists(os.path.join(ROOT, "portbench", sub[0],
                                               sub[1] + ".json"))


def reports(bench, m, cell):
    return cell in m.get("workloads", [w["name"] for w in bench["workloads"]])


def test_metrics(bench):
    e2e, per = bench["end_to_end"], bench["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(per) <= 128
    names = [m["name"] for m in e2e + per]
    assert len(set(names)) == len(names)
    cells = {w["name"] for w in bench["workloads"]}
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in e2e)
    for m in e2e:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in per:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line(m["layer"])
        moved = next(x for x in e2e if x["name"] == m["moves"])
        assert set(m["workloads"]) <= cells
        assert all(reports(bench, moved, c) for c in m["workloads"])
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics",
                                           m["name"] + ".py"))
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], m["layer"])
    for m in e2e + per:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for c in cells:
        got = [m for m in e2e if reports(bench, m, c)]
        assert any(m["name"] == "setup_s" for m in got) and len(got) >= 2
        assert any(c in m["workloads"] for m in per)

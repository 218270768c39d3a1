"""BENCHMARK.json against the benchmark's contract, and every name in it
found as a file of its own."""

import json
import os
import re

import pytest

from lz4bench import harness

ROOT = harness.ROOT
BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
CELLS = {w["name"]: w for w in BENCH["workloads"]}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/")
               for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 << 10


def test_command_stays_under_paths():
    for word in BENCH["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])
            assert os.path.exists(os.path.join(ROOT, word))


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_and_keys(group):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source",
                           "workloads"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}}[group]
    entries = BENCH[group]
    assert 1 <= len(entries)
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        assert set(e) <= keys, set(e) - keys
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert _line(e[k]), (e["name"], k)
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")


def test_metric_names_unique_across_groups():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
        assert m["source"] in ("host_clock", "device_trace")
    assert E2E["setup_s"]["bound"] <= 0.25


def test_configs_found_by_name():
    for c in BENCH["configs"]:
        assert c["file"] == f"lz4bench/configs/{c['name']}.json"
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["name"] == c["name"]
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
        assert len(c["reduced"]) <= 16
        assert "assumed" in cfg
        cells = [w["name"] for w in BENCH["workloads"]
                 if w["config"] == c["name"]]
        assert cells
        for cell in cells:                      # the port takes it
            harness.codec_settings(cfg, harness.cell_parts(BENCH, cell)[2])


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_parts_found_by_name(cell):
    w = CELLS[cell]
    assert w["chips"] in (1, 4)
    assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    _cell, cfg, mix = harness.cell_parts(BENCH, cell)
    assert cfg["name"] == w["config"] and mix.name == w["traffic"]
    assert os.path.exists(os.path.join(harness.HERE, "traffic",
                                       f"{w['traffic']}.json"))
    pairs = [(x["config"], x["traffic"]) for x in BENCH["workloads"]]
    assert pairs.count((w["config"], w["traffic"])) == 1


def test_few_cells_take_four_chips():
    """At most a quarter of the cells, rounded down, ask for four chips;
    one always may."""
    four = [w["name"] for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4), four


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_every_cell_reports_enough(cell):
    e2e = harness.cell_metrics(BENCH, cell, False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert harness.cell_metrics(BENCH, cell, True)


def test_metrics_have_readers_and_cells():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        read, _kind = harness.reader(m["name"])
        assert callable(read)
        for w in m.get("workloads", []):
            assert w in CELLS, (m["name"], w)


def test_per_layer_moves_a_metric_its_cells_report():
    for m in BENCH["per_layer"]:
        assert m["moves"] in E2E
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        moved = E2E[m["moves"]]
        for w in m["workloads"]:
            assert w in moved.get("workloads", CELLS), (m["name"], w)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_layers_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    perf = open(os.path.join(ROOT, "PERF.md")).read()
    for layer in layers:
        assert layer in perf, layer

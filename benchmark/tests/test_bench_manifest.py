"""Every cell, configuration and metric of BENCHMARK.json resolves to its
files by name, and the manifest keeps to the benchmark's contract."""
from __future__ import annotations

import json
import os
import re

import pytest

from benchmark import common

MAN = common.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_manifest_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmark"]
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) < 64 * 1024


@pytest.mark.parametrize("cfg", MAN["configs"], ids=lambda c: c["name"])
def test_config_resolves(cfg):
    assert NAME.match(cfg["name"])
    assert cfg["file"] == f"benchmark/configs/{cfg['name']}.json"
    data = common.load_json(os.path.join(common.ROOT, cfg["file"]))
    assert data["name"] == cfg["name"]
    assert data["reduced"] == cfg["reduced"] == []
    assert any(w["config"] == cfg["name"] for w in MAN["workloads"])


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(w):
    assert NAME.match(w["name"]) and len(w["why"]) <= 200
    cell = common.load_cell(w["name"])
    for key in ("name", "config", "traffic", "chips", "why"):
        assert cell[key] == w[key], key
    assert os.path.exists(common.traffic_file(w["traffic"]))
    assert hasattr(common.load_module(common.traffic_file(w["traffic"])),
                   "run")
    assert cell["limits"], "a cell compares at least one number"
    e2e, layer = common.cell_metrics(w["name"], MAN)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer


@pytest.mark.parametrize("m", MAN["per_layer"], ids=lambda m: m["name"])
def test_metric_resolves(m):
    assert NAME.match(m["name"])
    assert hasattr(common.load_module(common.metric_file(m["name"])),
                   "read")
    assert m["moves"] in {e["name"] for e in MAN["end_to_end"]}
    for w in m["workloads"]:
        e2e, _ = common.cell_metrics(w, MAN)
        assert m["moves"] in {e["name"] for e in e2e}


def test_bounds_and_units():
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")

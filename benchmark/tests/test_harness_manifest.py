"""BENCHMARK.json against the benchmark's contract, and the harness finding
every piece of a cell by name."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from benchmark.run import cell_metrics

REPO = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert 1 <= len(MANIFEST["command"]) <= 32
    assert all(TEXT.match(word) and not word.startswith("/") and ".." not in word
               for word in MANIFEST["command"])
    assert 1 <= len(MANIFEST["paths"]) <= 16 and all(PATH.match(p) for p in MANIFEST["paths"])
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


@pytest.mark.parametrize("group", sorted(KEYS))
def test_entries_keys_names_and_units(group):
    entries = MANIFEST[group]
    assert entries
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        optional = {"workloads"} if group in ("end_to_end", "per_layer") else set()
        assert set(e) >= KEYS[group] and set(e) - KEYS[group] <= optional
        assert NAME.match(e["name"])
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert TEXT.match(e[key])


def test_configs_and_workloads_resolve_to_files():
    bench = REPO / "benchmark"
    configs = {c["name"] for c in MANIFEST["configs"]}
    for c in MANIFEST["configs"]:
        assert c["file"].startswith("benchmark/") and (REPO / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        data = json.loads((REPO / c["file"]).read_text())
        assert sorted(data["reduced"]) == sorted(c["reduced"])
    used = set()
    pairs = set()
    for w in MANIFEST["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text())
        assert (bench / "entries" / f"{traffic['entry']}.py").is_file()
        assert (bench / "limits" / f"{w['name']}.json").is_file()
    assert used == configs


def test_bounds():
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in MANIFEST["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_each_cell_reports_what_its_per_layer_metrics_move(cell):
    e2e = {m["name"] for m in cell_metrics(MANIFEST, cell, "end_to_end")}
    per_layer = cell_metrics(MANIFEST, cell, "per_layer")
    assert "setup_s" in e2e and len(e2e) >= 2 and per_layer
    for m in per_layer:
        assert m["moves"] in e2e
        assert (REPO / "benchmark" / "metrics" / f"{m['name']}.py").is_file()


def test_per_layer_metrics_name_existing_end_to_end_metrics_and_layers():
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span",
                                                     "program_counter", "host_clock")
        assert set(m.get("workloads", [])) <= cells
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"

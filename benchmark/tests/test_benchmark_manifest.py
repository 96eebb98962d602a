"""``BENCHMARK.json`` against the rules for the manifest, and every file it names
found by name."""

import json
import os
import re

import pytest

from benchmark.manifest import BENCH_DIR, ROOT, Cell, load, metric_reader

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"[^\n\t]{1,200}$")
WIDTHS = ("model_channels", "num_head_channels", "channel_mult")

MANIFEST = load(ROOT)
CELLS = [w["name"] for w in MANIFEST["workloads"]]
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert 1 <= len(MANIFEST["command"]) <= 32
    assert all(TEXT.match(w) for w in MANIFEST["command"])
    assert not any(w.startswith("/") or ".." in w for w in MANIFEST["command"])
    assert MANIFEST["paths"] == ["benchmark"]
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units_use_only_the_allowed_characters():
    names = ([c["name"] for c in MANIFEST["configs"]] + CELLS + [m["name"] for m in METRICS]
             + [w["config"] for w in MANIFEST["workloads"]]
             + [w["traffic"] for w in MANIFEST["workloads"]]
             + [k for c in MANIFEST["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for group in (MANIFEST["configs"], MANIFEST["workloads"], METRICS):
        assert len({g["name"] for g in group}) == len(group)
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    assert all(m["better"] in ("lower", "higher") for m in METRICS)
    texts = ([c["why"] for c in MANIFEST["configs"]] + [c["source"] for c in MANIFEST["configs"]]
             + [w["why"] for w in MANIFEST["workloads"]] + [m["layer"] for m in MANIFEST["per_layer"]])
    assert all(TEXT.match(t) for t in texts)


def test_entries_have_just_their_keys_and_sound_bounds():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert not set(c["reduced"]) & set(WIDTHS)
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert "setup_s" in {m["name"] for m in MANIFEST["end_to_end"]}


def test_no_cell_asks_for_four_chips():
    assert all(w["chips"] == 1 for w in MANIFEST["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_cells_files_are_found_by_name(cell):
    c = Cell(MANIFEST, cell, ROOT)
    assert c.config["model_name"] and c.traffic["task"] in ("deblur", "sr", "inpaint")
    assert set(c.limits["limits"]) == {"rmse_worst", "nonfinite"}
    files = {cf["name"]: cf["file"] for cf in MANIFEST["configs"]}
    assert files[c.entry["config"]].startswith("benchmark/")
    for m in c.end_to_end + c.per_layer:
        assert callable(metric_reader(m["name"]))


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(cell):
    c = Cell(MANIFEST, cell, ROOT)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    # every per-layer metric's ``moves`` is an end-to-end metric of each of its cells
    for m in c.per_layer:
        assert m["moves"] in e2e


def test_configuration_files_hold_their_source_and_widths():
    for c in MANIFEST["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"]
        assert c["file"] not in [o["file"] for o in MANIFEST["configs"] if o is not c]
        for k in ("model_channels", "num_res_blocks", "channel_mult", "num_head_channels",
                  "attention_ds", "image_size", "dtype"):
            assert k in cfg


def test_every_metric_has_a_reader_file():
    names = {m["name"] for m in METRICS}
    files = {f[:-3] for f in os.listdir(os.path.join(BENCH_DIR, "metrics")) if f.endswith(".py")}
    assert names <= files

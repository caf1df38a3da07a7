"""BENCHMARK.json against the benchmark's contract: keys, names and their
character sets, lengths, bounds, the window's cost, and that every piece a
cell names exists as a file of its own."""
from __future__ import annotations

import json
import re
from urllib.parse import urlparse

import pytest

from annbench import harness

MAN = harness.manifest()
ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|expansion|_dim$|_rank$"
                   r"|experts_per_tok)")


def line(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(MAN) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    assert 1 <= len(MAN["command"]) <= 32 and all(line(w) for w in MAN["command"])
    assert not any(w.startswith("/") or ".." in w for w in MAN["command"])


def test_run_seconds_fits_the_check_with_24_cells():
    r = MAN["run_seconds"]
    assert isinstance(r, int) and 1 <= r <= 51
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metric_names_unique_across_sections():
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(names) == len(set(names))


def test_configs():
    assert 1 <= len(MAN["configs"]) <= 24
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line(c["source"]) and line(c["why"])
        assert urlparse(c["source"].split()[0]).scheme == "https"
        assert any(c["file"].startswith(p + "/") for p in MAN["paths"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTH.search(k) for k in c["reduced"])


def test_every_config_has_a_cell():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}


def test_workloads():
    w = MAN["workloads"]
    assert 1 <= len(w) <= 24
    pairs = [(c["config"], c["traffic"]) for c in w]
    assert len(pairs) == len(set(pairs))
    four = sum(c["chips"] == 4 for c in w)
    assert four <= max(1, len(w) // 4)
    for c in w:
        assert set(c) == {"name", "config", "traffic", "chips", "why"}
        assert c["chips"] in (1, 4) and line(c["why"]) and NAME.match(c["traffic"])


@pytest.mark.parametrize("section", ["end_to_end", "per_layer"])
def test_metric_fields(section):
    allowed = {"end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}
    for m in MAN[section]:
        assert set(m) <= allowed[section]
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        cells = {c["name"] for c in MAN["workloads"]}
        assert set(m.get("workloads", cells)) <= cells


def test_end_to_end_bounds_and_sources():
    assert 1 <= len(MAN["end_to_end"]) <= 16
    names = [m["name"] for m in MAN["end_to_end"]]
    assert "setup_s" in names
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_per_layer_layers_and_moves():
    assert 1 <= len(MAN["per_layer"]) <= 128
    e2e = {m["name"] for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        assert line(m["layer"]) and m["moves"] in e2e


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_each_cell_reports_what_its_metrics_move(cell):
    """Every cell reports setup_s, another end-to-end metric and a per-layer
    one, and each per-layer metric's `moves` is among its end-to-end ones."""
    e2e = [m["name"] for m in harness.end_to_end(MAN, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    pl = harness.per_layer(MAN, cell)
    assert pl
    for m in pl:
        assert m["moves"] in e2e


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_each_cell_finds_its_pieces(cell):
    w = harness.find(MAN["workloads"], cell)
    bench = harness.BENCH
    mix = json.loads((bench / "mixes" / f"{w['traffic']}.json").read_text())
    assert (bench / "drivers" / f"{mix['driver']}.py").is_file()
    assert (bench / "limits" / f"{cell}.json").is_file()
    for m in harness.per_layer(MAN, cell):
        mod = harness.load(bench / "metrics" / f"{m['name']}.py")
        assert mod.UNIT == m["unit"] and mod.SOURCE == m["source"] and callable(mod.read)


def test_roofline_metric_names():
    for m in MAN["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline") and m["unit"] == "%"

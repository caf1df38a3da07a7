"""A configuration, mix, driver or metric added as new files (and manifest
entries) is found by name, with no edit to a file that exists."""
from __future__ import annotations

import json
import shutil

from annbench import harness
from annbench.conftest import tiny

READER = '''UNIT = "queries/call"
SOURCE = "host_clock"


def read(ctx):
    return float(ctx.rec["nq"])
'''

DRIVER = '''import importlib.util
import pathlib

_spec = importlib.util.spec_from_file_location(
    "b", pathlib.Path(__file__).with_name("batch.py"))
_b = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_b)
setup, window, traced, end_to_end, numbers = (_b.setup, _b.window, _b.traced,
                                              _b.end_to_end, _b.numbers)
'''


def _copy(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(harness.ROOT / "BENCHMARK.json", root)
    shutil.copytree(harness.BENCH, root / "annbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return root


def test_new_files_are_found_without_editing_existing_ones(tmp_path):
    root = _copy(tmp_path)
    before = {p: p.read_bytes() for p in (root / "annbench").rglob("*") if p.is_file()}
    bench = root / "annbench"
    cfg = json.loads((bench / "configs" / "glove100-soar.json").read_text())
    cfg["name"] = "tiny-new"
    (bench / "configs" / "tiny-new.json").write_text(json.dumps(cfg))
    mix = dict(json.loads((bench / "mixes" / "batch.json").read_text()), driver="batch_new")
    (bench / "mixes" / "batch-new.json").write_text(json.dumps(mix))
    (bench / "drivers" / "batch_new.py").write_text(DRIVER)
    (bench / "metrics" / "batch_q.new.py").write_text(READER)
    (bench / "limits" / "tiny-new.batch.json").write_text(
        (bench / "limits" / "glove100.batch.json").read_text())
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny-new", "source": "https://example.org/tiny",
                           "file": "annbench/configs/tiny-new.json", "reduced": [],
                           "why": "a test"})
    man["workloads"].append({"name": "tiny-new.batch", "config": "tiny-new",
                             "traffic": "batch-new", "chips": 1, "why": "a test"})
    for m in man["end_to_end"]:
        if m["name"] in ("qps", "recall10"):
            m["workloads"].append("tiny-new.batch")
    man["per_layer"].append({"name": "batch_q.new", "unit": "queries/call",
                             "better": "higher", "source": "host_clock", "layer": "device",
                             "moves": "qps", "workloads": ["tiny-new.batch"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))

    ctx = tiny("tiny-new.batch", trace=True, root=root)
    assert ctx.cfg["name"] == "tiny-new" and ctx.mix["driver"] == "batch_new"
    assert [m["name"] for m in harness.per_layer(man, "tiny-new.batch")] == ["batch_q.new"]
    res = harness.run_cell(ctx)
    assert res["correct"]
    assert res["metrics"]["batch_q.new"]["value"] == 64.0
    after = {p: p.read_bytes() for p in before}
    assert after == before

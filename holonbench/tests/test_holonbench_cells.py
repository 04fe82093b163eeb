"""Cells, configurations, dataplanes, references and metric readers are
found by name, and a new cell is new files plus new entries: a throwaway
cell, traffic mix and metric added to a copy of the benchmark run there
with no file of the copy edited but ``BENCHMARK.json``."""
import json
import shutil

import pytest

from holonbench import bench
from holonbench.cell import ROOT, find_cell, load_benchmark

CELLS = ("dense-q5-10k", "keyed-q5-1m")


def test_benchmark_names_the_cells():
    b = load_benchmark()
    assert [w["name"] for w in b["workloads"]] == list(CELLS)
    assert {c["name"] for c in b["configs"]} == {"nexmark-dense-10k", "nexmark-keyed-1m"}
    assert [m["name"] for m in b["end_to_end"]] == ["events_per_s", "setup_s"]
    assert all(m["moves"] == "events_per_s" for m in b["per_layer"])


@pytest.mark.parametrize("name", CELLS)
def test_every_part_of_a_cell_is_found(name):
    cell = find_cell(name)
    assert cell.config["name"] == next(w["config"] for w in load_benchmark()["workloads"]
                                       if w["name"] == name)
    assert cell.chips == 1
    assert hasattr(cell.module("dataplanes", cell.config["dataplane"]), "Plane")
    ref = cell.module("references", cell.traffic["query"])
    assert hasattr(ref, "partial") and hasattr(ref, "finish")
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.module("metrics", m["name"]).read)
    assert {m["name"] for m in cell.end_to_end} == {"events_per_s", "setup_s"}


def test_config_files_match_benchmark():
    b = load_benchmark()
    for c in b["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        find_cell("no-such-cell")


def test_new_cell_is_new_files(tmp_path, tiny):
    shutil.copytree(ROOT / "holonbench", tmp_path / "holonbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = load_benchmark()
    before = {p: p.read_bytes() for p in (tmp_path / "holonbench").rglob("*") if p.is_file()}
    # a traffic mix with partition skew, and a metric of its own
    (tmp_path / "holonbench" / "workloads" / "keyed-q5-skewed.json").write_text(json.dumps(
        {"name": "keyed-q5-skewed", "query": "q5", "partition_skew": 1.0, "why": "stragglers"}))
    (tmp_path / "holonbench" / "metrics" / "passes_in_window.py").write_text(
        "def read(r):\n    return float(r.passes)\n")
    b["workloads"].append({"name": "keyed-q5-skewed", "config": "nexmark-keyed-1m",
                           "traffic": "keyed-q5-skewed", "chips": 1, "why": "stragglers"})
    b["end_to_end"].append({"name": "passes_in_window", "unit": "passes", "better": "higher",
                            "bound": 0.25, "source": "host_clock",
                            "workloads": ["keyed-q5-skewed"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = find_cell("keyed-q5-skewed", root=tmp_path)
    assert cell.traffic["partition_skew"] == 1.0
    res = bench.run(cell, bench.Options(seed=31, seconds=0.5, device="cpu",
                                        scale=tiny["keyed-q5-1m"]))
    assert res["correct"], res["checks"]
    assert res["metrics"]["passes_in_window"]["value"] >= 1
    after = {p: p.read_bytes() for p in before}
    assert after == before  # nothing that was there changed


def test_four_card_cell_is_entries_alone(four_card_root):
    """The four-card cell, left out for its spread (PERF.md), comes back as
    BENCHMARK.json entries: every file it needs is here."""
    cell = find_cell("keyed-q5-1m-4x", root=four_card_root)
    assert cell.chips == 4 and cell.config["name"] == "nexmark-keyed-1m"
    assert {m["name"] for m in cell.per_layer} >= {"wire_bytes_per_step",
                                                     "exchange_ms_per_step"}
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.module("metrics", m["name"]).read)

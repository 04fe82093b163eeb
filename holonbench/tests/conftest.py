"""The harness's CPU tests: the repository root and ``src/`` on the path,
and a tiny scale of each cell that the CPU runs in seconds (the
configuration's keys replaced; the kernels' plain versions)."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# one-second batches of 256 events, 24 of them: windows 0..2 close, 3 is open
TINY = {"events_per_batch": 256, "rate_per_partition": 256.0, "num_batches": 24}
SCALE = {"dense-q5-10k": {**TINY, "num_keys": 1024, "num_slots": 16},
         "keyed-q5-1m": {**TINY, "num_keys": 2000},
         "keyed-q5-1m-4x": {**TINY, "num_keys": 2000}}


@pytest.fixture
def tiny():
    return SCALE


# The four-card cell and the two metrics only it reports, as a later change
# adds them to BENCHMARK.json (PERF.md, Open questions): the harness runs
# them as they are, and the tests hold them on the CPU in gloo ranks.
FOUR_CARD = {
    "workload": {"name": "keyed-q5-1m-4x", "config": "nexmark-keyed-1m",
                 "traffic": "keyed-q5-1m-4x", "chips": 4, "why": "the path across cards"},
    "per_layer": [
        {"name": "wire_bytes_per_step", "unit": "bytes/step", "better": "lower",
         "source": "program_counter", "layer": "sync transport", "moves": "events_per_s",
         "workloads": ["keyed-q5-1m-4x"]},
        {"name": "exchange_ms_per_step", "unit": "ms/step", "better": "lower",
         "source": "program_span", "layer": "routing", "moves": "events_per_s",
         "workloads": ["keyed-q5-1m-4x"]}],
}


@pytest.fixture
def four_card_root(tmp_path):
    """A checkout root whose BENCHMARK.json also holds the four-card cell."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append(FOUR_CARD["workload"])
    bench["per_layer"] += FOUR_CARD["per_layer"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "holonbench").symlink_to(ROOT / "holonbench")
    return tmp_path

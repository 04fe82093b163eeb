"""On the card (``pytest -m cuda holonbench/tests``): the frozen generator
is the program's there too, and each one-card cell at a reduced scale (one
second of event time a batch, 24 batches, every other size as configured)
runs through the program's CUDA kernels, correct against the reference,
traced with every per-layer metric of its cell read and each roofline
share within 100%; the control there is not correct.  Each test decides
inside itself whether there is a card."""
import dataclasses

import pytest
import torch

from holonbench import bench
from holonbench.cell import find_cell
from holonbench.nexmark.generator import FIELDS, LogSpec, generate

pytestmark = pytest.mark.cuda

CELLS = ("dense-q5-10k", "keyed-q5-1m")
SCALE = {"events_per_batch": 16384, "rate_per_partition": 16384.0, "num_batches": 24}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def test_generator_copy_on_the_card(card):
    from repro_torch.streaming.generator import NexmarkConfig, generate_log

    spec = LogSpec(num_partitions=16, num_batches=70, events_per_batch=1024,
                   rate_per_partition=625_000.0, seed=2**31 + 77, num_auctions=1_000_000,
                   key_skew=1.1)
    for parts in (None, range(4, 8)):
        got = generate(spec, card, parts)
        want = generate_log(NexmarkConfig(**dataclasses.asdict(spec)), card, partitions=parts)
        for f in FIELDS:
            assert torch.equal(got[f], getattr(want, f)), f
        cpu = generate(spec, "cpu", parts)
        for f in FIELDS:
            assert torch.equal(got[f].cpu(), cpu[f]), f


@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(card, name):
    cell = find_cell(name)
    res = bench.run(cell, bench.Options(seed=2**31 + 41, seconds=1.0, scale=SCALE))
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    res = bench.run(cell, bench.Options(seed=43, seconds=1.0, trace=True, scale=SCALE))
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {m["name"] for m in cell.per_layer}
    for k, m in res["metrics"].items():
        assert m["value"] > 0, k
        if k.endswith("_roofline"):
            assert m["value"] <= 100.0, (k, m)
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]


@pytest.mark.parametrize("name", CELLS)
def test_control_on_the_card(card, name):
    from holonbench import control

    rows = control.readings(find_cell(name), [47], bench.Options(seed=0, seconds=0.0,
                                                                   scale=SCALE))
    s = control.summary(rows)
    assert s["wrong_window_values"]["lower"] == 0 and s["wrong_window_values"]["upper"] > 0, s

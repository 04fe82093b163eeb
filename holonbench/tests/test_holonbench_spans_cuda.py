"""On the card (``pytest -m cuda holonbench/tests``), each one-card cell at
the reduced scale of ``test_holonbench_cuda.py``: the five span metrics of
a traced run are printed and finite (the routing one on the keyed cell
alone); the traced pass's ``holon.fold.step`` spans are its fold steps and
its device events are the same with the spans on and off; and a pass
synchronises with the card as often with the spans on as off
(``torch.cuda.set_sync_debug_mode("warn")``).  Each test decides inside
itself whether there is a card."""
import contextlib
import math
import warnings

import pytest
import torch

from holonbench import bench, spans
from holonbench.cell import find_cell

pytestmark = pytest.mark.cuda

CELLS = ("dense-q5-10k", "keyed-q5-1m")
SCALE = {"events_per_batch": 16384, "rate_per_partition": 16384.0, "num_batches": 24}
SPAN_METRICS = ("fold_host_ms_per_step", "fold_idle_ms_per_step", "route_host_ms_per_step",
                "sync_host_ms_per_round", "read_host_ms_per_pass")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def plane_of(name: str, seed: int):
    cell = find_cell(name)
    opt = bench.Options(seed=seed, seconds=0.0, scale=SCALE)
    cfg = {**cell.config, **SCALE}
    mesh = bench.make_mesh(cfg, opt, None)
    return bench.make_plane(cell, cfg, mesh, seed)[1], mesh.device


@pytest.mark.parametrize("name", CELLS)
def test_span_metrics_on_the_card(card, name):
    cell = find_cell(name)
    res = bench.run(cell, bench.Options(seed=2**31 + 53, seconds=1.0, trace=True, scale=SCALE))
    assert res["correct"], res["checks"]
    want = {m for m in SPAN_METRICS if m != "route_host_ms_per_step" or name == "keyed-q5-1m"}
    assert want <= set(res["metrics"])
    for k in want:
        v = res["metrics"][k]["value"]
        assert math.isfinite(v) and v > 0, (k, v)


@pytest.mark.parametrize("name", CELLS)
def test_traced_pass_spans_and_events_on_the_card(card, name):
    plane, dev = plane_of(name, 2**31 + 59)
    *_, off, _, _, _ = bench.traced_window(plane, {}, dev, None)
    outs, _, _, on, _, records, _ = bench.traced_window(plane, {"spans": spans.recorder},
                                                        dev, None)
    rec = records["spans"]
    assert len(spans.named(rec, spans.STEP)) == plane.steps
    assert len(spans.named(rec, "holon.pass")) == 1
    assert on.device_events == off.device_events
    assert sum(spans.idle_by_name(on, rec).values()) > 0


@pytest.mark.parametrize("name", CELLS)
def test_spans_add_no_synchronise_on_the_card(card, name):
    from repro_torch.obs import timing

    plane, dev = plane_of(name, 2**31 + 61)
    plane.run_pass()
    torch.cuda.synchronize(dev)
    counts, seen = [], []
    for on in (False, True, False, True):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with timing.recording() if on else contextlib.nullcontext():
                    plane.run_pass()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        # torch's "called a synchronizing CUDA operation" (the mode's one-time
        # notice that it "does not yet detect all synchronizing operations" is not one)
        syncs = [w for w in caught if "called a synchronizing" in str(w.message)]
        counts.append(len(syncs))
        seen.append(sorted({str(w.message)[:160] for w in caught}))
        torch.cuda.synchronize(dev)
    print(f"{name}: synchronising calls a pass, spans off/on/off/on: {counts}")
    assert counts[0] == counts[1] == counts[2] == counts[3], (counts, seen)

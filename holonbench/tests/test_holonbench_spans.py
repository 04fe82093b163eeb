"""The five readers of the program's spans, on hand-made traces whose
answers are known: a gap inside a fold step, a gap inside a route span
nested in one, a gap in no span, and no spans at all; then on the CPU a
traced run of each cell at a tiny size, whose host-time metrics come from
the program's spans, and a program without spans, whose readers find
nothing."""
import contextlib
import math

import numpy as np
import pytest

from holonbench import bench, spans
from holonbench.bench import Readings
from holonbench.cell import find_cell
from holonbench.devtrace import DeviceTrace
from repro_torch.obs.timing import Span

READERS = ("fold_host_ms_per_step", "fold_idle_ms_per_step", "route_host_ms_per_step",
           "sync_host_ms_per_round", "read_host_ms_per_pass")
MS = 1_000_000  # ns


def reader(name: str):
    return find_cell("keyed-q5-1m").module("metrics", name)


def span(name, parent, start_ms, end_ms):
    return Span(name, parent, start_ms * MS, end_ms * MS)


# one pass from 0 to 100 ms: two fold steps (the second with a route
# span), a sync round, a read, and gather_outputs after the pass
SPANS = [span("holon.pass", None, 0, 90),  # 0
         span("holon.fold.step", 0, 10, 30),  # 1
         span("holon.fold.step", 0, 30, 60),  # 2
         span("holon.fold.route", 2, 35, 45),  # 3
         span("holon.sync.round", 0, 60, 70),  # 4
         span("holon.read", 0, 70, 86),  # 5
         span("holon.gather_outputs", None, 92, 96)]  # 6

# device busy [0, 12], [20, 36], [50, 62], [64, 80], [99, 100] ms: idle gaps
# 12-20 (step 1), 36-50 (route, inside step 2), 62-64 (sync), 80-99
# (midpoint 89.5: the read has ended, the pass has not)
BUSY = [(0, 12), (20, 36), (50, 62), (64, 80), (99, 100)]


def trace(busy=BUSY, t1_ms=100):
    starts = np.array([a * MS for a, _ in busy], dtype=np.int64)
    ends = np.array([b * MS for _, b in busy], dtype=np.int64)
    return DeviceTrace(window_s=t1_ms / 1e3, names=["k"] * len(busy), starts=starts,
                       ends=ends, host_ops=[], t0_ns=0, t1_ns=t1_ms * MS)


def readings(spans_list, tr) -> Readings:
    return Readings(setup_s=1.0, window_s=0.1, passes=1, pass_s=0.1, events=1, steps=2,
                    trace=tr, records={name: spans_list for name in READERS})


def test_readers_on_a_hand_made_pass():
    r = readings(SPANS, trace())
    got = {name: reader(name).read(r) for name in READERS}
    assert got["fold_host_ms_per_step"] == pytest.approx((20 + 30) / 2)
    # idle in step 1 (8 ms) and in the route inside step 2 (14 ms), over 2 steps
    assert got["fold_idle_ms_per_step"] == pytest.approx((8 + 14) / 2)
    assert got["route_host_ms_per_step"] == pytest.approx(10)
    assert got["sync_host_ms_per_round"] == pytest.approx(10)
    assert got["read_host_ms_per_pass"] == pytest.approx(16)


def test_idle_is_put_down_to_the_innermost_span():
    by = spans.idle_by_span(trace(), SPANS)
    assert by == pytest.approx({1: 0.008, 3: 0.014, 4: 0.002, 0: 0.019})
    assert spans.idle_by_name(trace(), SPANS) == pytest.approx(
        {"holon.fold.step": 0.008, "holon.fold.route": 0.014, "holon.sync.round": 0.002,
         "holon.pass": 0.019})
    # a gap in no span: the window runs on past the last span
    late = trace(t1_ms=120)
    assert spans.idle_by_name(late, SPANS)[""] == pytest.approx(0.020)
    assert reader("fold_idle_ms_per_step").read(readings(SPANS, late)) == \
        pytest.approx((8 + 14) / 2)


def test_a_gap_in_no_span_is_no_step_idle():
    alone = [span("holon.pass", None, 0, 10), span("holon.fold.step", 0, 1, 9)]
    r = readings(alone, trace(busy=[(0, 0.5), (9, 100)]))
    # [0.5, 9]: midpoint 4.75, inside the step; after the pass nothing idles
    assert reader("fold_idle_ms_per_step").read(r) == pytest.approx(8.5)
    r = readings(alone, trace(busy=[(0, 9.5), (50, 100)]))  # [9.5, 50]: midpoint in no span
    assert reader("fold_idle_ms_per_step").read(r) == 0.0
    assert spans.idle_by_name(r.trace, alone) == pytest.approx({"": 0.0405})


def test_no_spans_reads_nothing():
    for records in ([], None):
        r = readings(records, trace())
        assert all(reader(name).read(r) is None for name in READERS)
    # spans but no device events: only the idle reader needs the card
    r = readings(SPANS, trace(busy=[]))
    assert reader("fold_idle_ms_per_step").read(r) is None
    assert reader("fold_host_ms_per_step").read(r) == pytest.approx(25)
    r = readings(SPANS[:3], trace())
    assert reader("route_host_ms_per_step").read(r) is None
    assert reader("sync_host_ms_per_round").read(r) is None


def test_spans_share_a_time():
    """A child starting with its parent, and one ending with it."""
    tied = [span("holon.pass", None, 0, 10), span("holon.fold.step", 0, 0, 4),
            span("holon.fold.route", 1, 2, 4), span("holon.sync.round", 0, 4, 10)]
    times, owner = spans.innermost(tied)
    assert times.tolist() == [0, 0, 2 * MS, 4 * MS, 4 * MS, 4 * MS, 10 * MS, 10 * MS]
    assert owner.tolist() == [0, 1, 2, 1, 0, 3, 0, -1]


@pytest.mark.parametrize("name", ("dense-q5-10k", "keyed-q5-1m"))
def test_traced_cell_reads_the_program_spans(tiny, name):
    cell = find_cell(name)
    res = bench.run(cell, bench.Options(seed=2**31 + 5, seconds=0.5, trace=True,
                                        device="cpu", scale=tiny[name]))
    assert res["correct"], res["checks"]
    m = res["metrics"]
    want = {"fold_host_ms_per_step", "sync_host_ms_per_round", "read_host_ms_per_pass"}
    if name == "keyed-q5-1m":
        want.add("route_host_ms_per_step")
    assert want <= set(m)
    assert "fold_idle_ms_per_step" not in m  # no device events on the host
    for k in want:
        assert math.isfinite(m[k]["value"]) and m[k]["value"] > 0, k


def test_a_program_without_spans_reads_nothing(monkeypatch, tiny):
    from repro_torch.obs import timing

    monkeypatch.delattr(timing, "recording")
    with spans.recorder() as got:
        assert got == []
    cell = find_cell("keyed-q5-1m")
    res = bench.run(cell, bench.Options(seed=7, seconds=0.5, trace=True, device="cpu",
                                        scale=tiny["keyed-q5-1m"]))
    assert res["correct"], res["checks"]
    assert not set(READERS) & set(res["metrics"])


def test_recorders_nest_over_one_list():
    with contextlib.ExitStack() as stack:
        lists = [stack.enter_context(reader(name).recorder()) for name in READERS]
    assert all(x is lists[0] for x in lists)

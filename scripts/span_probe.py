"""The dataplane's spans on the card, at a benchmark cell's full size.

    python3 scripts/span_probe.py [--cells dense-q5-10k,keyed-q5-1m] [--passes 3]

For each cell of ``BENCHMARK.json`` (built as ``holonbench/run.py`` builds
it, from ``--seed``), in one process:

- the spans' cost: untraced passes with the spans off and under
  ``recording()`` in turns, each pass's seconds, and the difference over the
  spans a pass records (µs a span, % of a pass); and one span timed alone
  in a loop, off and on, times the spans a pass records;
- the traced pass as the benchmark runs it (``bench.traced_window``), with
  the cell's existing metrics' recorders alone and with the span readers'
  too, in turns: every per-layer metric of the cell from each, the count of
  ``holon.fold.step`` spans against the pass's fold steps, and the card's
  idle time by the innermost program span open at each gap's midpoint;
- the clock: one pass under ``torch.profiler`` with CPU and CUDA activity
  inside a recording, each span's in-memory start and end against its
  profiler range's, and the device events that start before the pass's
  ``holon.pass`` span; that pass's idle by host op (the benchmark's
  breakdown) and, of the gaps in no torch op (``python``), by span.

Prints one JSON object a cell, on a line of its own.  Needs an NVIDIA
card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import numpy as np  # noqa: E402

from holonbench import bench, spans  # noqa: E402
from holonbench.cell import find_cell  # noqa: E402
from holonbench.devtrace import read_trace  # noqa: E402

SPAN_METRICS = ("fold_host_ms_per_step", "fold_idle_ms_per_step", "route_host_ms_per_step",
                "sync_host_ms_per_round", "read_host_ms_per_pass")


def timed(plane, dev, on: bool) -> tuple[float, int]:
    """One untraced pass: ``(seconds, spans recorded)``."""
    from repro_torch.obs import timing

    bench._sync(dev)
    t0 = time.perf_counter()
    if on:
        with timing.recording() as rec:
            plane.run_pass()
            bench._sync(dev)
        return time.perf_counter() - t0, len(rec)
    plane.run_pass()
    bench._sync(dev)
    return time.perf_counter() - t0, 0


def span_cost(n: int = 20_000) -> dict:
    """Host µs of one ``holon.fold.step`` span with nothing inside, off and
    under ``recording()`` (no profiler)."""
    from repro_torch.obs import timing

    out = {}
    for on in (False, True):
        with timing.recording() if on else contextlib.nullcontext():
            t0 = time.perf_counter()
            for i in range(n):
                with timing.span(spans.STEP):
                    pass
            out["on" if on else "off"] = (time.perf_counter() - t0) / n * 1e6
    return out


def traced(cell, plane, dev, with_spans: bool) -> dict:
    """Every per-layer metric of ``cell`` from one traced window, with or
    without the span readers' recorders, and the spans' idle split."""
    readers = {m["name"]: cell.module("metrics", m["name"]) for m in cell.per_layer}
    recorders = {k: r.recorder for k, r in readers.items() if hasattr(r, "recorder")
                 and (with_spans or k not in SPAN_METRICS)}
    _, dt, untraced, trace, _, records, _ = bench.traced_window(plane, recorders, dev, None)
    r = bench.Readings(setup_s=0.0, window_s=dt, passes=1, pass_s=untraced, events=0,
                       steps=plane.steps, trace=trace, records=records)
    out = {"metrics": {k: rd.read(r) for k, rd in readers.items()},
           "device_events": trace.device_events, "busy_s": trace.busy_s,
           "traced_pass_s": dt, "untraced_pass_s": untraced}
    rec = next((records[k] for k in SPAN_METRICS if k in records), None)
    if rec:
        idle = spans.idle_by_name(trace, rec)
        total = sum(idle.values())
        out.update(fold_steps=len(spans.named(rec, spans.STEP)), steps=plane.steps,
                   idle_s=total, idle_by_span_s=idle,
                   idle_in_spans=1.0 - idle.get("", 0.0) / total if total else None)
    return out


def python_idle(trace, rec: list) -> dict:
    """The card's idle gaps of a host-traced pass that ``DeviceTrace.idle_gaps``
    puts down to ``python`` (no top-level torch op running at the gap's
    midpoint), by the innermost span open there: ``{span name: seconds}``."""
    gs, ge = spans.idle_gaps(trace)
    mids = (gs + ge) // 2
    o_start = np.array([s for _, s, _ in trace.host_ops], dtype=np.int64)
    o_end = np.array([e for _, _, e in trace.host_ops], dtype=np.int64)
    i = np.searchsorted(o_start, mids, side="right") - 1
    in_op = (i >= 0) & (o_end[np.maximum(i, 0)] > mids) if o_end.size else i < -1
    out: dict = {}
    for k, sec, op in zip(spans.owners(rec, mids).tolist(), ((ge - gs) / 1e9).tolist(),
                          in_op.tolist()):
        if not op:
            name = rec[k].name if k >= 0 else ""
            out[name] = out.get(name, 0.0) + sec
    return out


def clock(plane, dev) -> dict:
    """Each span against its profiler range, in one pass traced with CPU and
    CUDA activity, and that pass's idle by host op and span."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import timing

    bench._sync(dev)
    with timing.recording() as rec, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        plane.run_pass()
        bench._sync(dev)
        dt = time.perf_counter() - t0
    host = read_trace(prof, dt)
    ranges, device = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("holon.") and e.device_type() == DeviceType.CPU:
            ranges.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
        elif e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            device.append(e.start_ns())
    start_off, end_off, unmatched = [], [], 0
    for name in {s.name for s in rec}:
        mine = sorted((s.start_ns, s.end_ns) for s in rec if s.name == name)
        theirs = sorted(ranges.get(name, []))
        unmatched += abs(len(mine) - len(theirs))
        for (s1, e1), (s0, e0) in zip(mine, theirs):
            start_off.append(s1 - s0)
            end_off.append(e0 - e1)
    pass_start = min(s.start_ns for s in rec if s.name == "holon.pass")
    q = statistics.quantiles(start_off, n=20)
    return {"spans": len(rec), "unmatched": unmatched,
            "start_offset_us": {"median": statistics.median(start_off) / 1e3,
                                "p5": q[0] / 1e3, "p95": q[-1] / 1e3,
                                "min": min(start_off) / 1e3, "max": max(start_off) / 1e3},
            "end_offset_us": {"median": statistics.median(end_off) / 1e3,
                              "max": max(end_off) / 1e3},
            "device_events": len(device),
            "device_events_before_pass": sum(t < pass_start for t in device),
            "idle_by_host_op_s": host.idle_gaps(8), "python_idle_by_span_s": python_idle(host, rec),
            "first_device_event_after_pass_start_us":
                (min(device) - pass_start) / 1e3 if device else None}


def probe(name: str, seed: int, passes: int, opt: bench.Options | None = None) -> dict:
    """Every reading of one cell; ``opt`` (device, scale) for a rehearsal on
    the host."""
    cell = find_cell(name)
    opt = opt or bench.Options(seed=seed, seconds=0.0)
    cfg = {**cell.config, **(opt.scale or {})}
    mesh = bench.make_mesh(cfg, opt, None)
    _, plane = bench.make_plane(cell, cfg, mesh, seed)
    dev = mesh.device
    off, on, n_spans = [], [], 0
    for k in range(2 * passes):  # off, on, on, off, ...
        if k % 4 in (0, 3):
            off.append(timed(plane, dev, False)[0])
        else:
            dt, n_spans = timed(plane, dev, True)
            on.append(dt)
    cost = statistics.median(on) - statistics.median(off)
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    one = span_cost()
    res = {"cell": name, "seed": seed, "card": card,
           "pass_s_spans_off": off, "pass_s_spans_on": on, "spans_a_pass": n_spans,
           "pass_cost_us_a_span": cost / n_spans * 1e6,
           "pass_cost_share": cost / statistics.median(off),
           "span_us": one, "span_share_of_pass": {
               k: v * n_spans / 1e6 / statistics.median(off) for k, v in one.items()}}
    res["traced"] = [traced(cell, plane, dev, w) for w in (False, True, False, True)]
    res["clock"] = clock(plane, dev)
    return res


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", default="dense-q5-10k,keyed-q5-1m")
    ap.add_argument("--seed", type=int, default=2**31 + 101)
    ap.add_argument("--passes", type=int, default=4, help="passes of each side")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("span_probe needs an NVIDIA card", file=sys.stderr)
        return 2
    for name in a.cells.split(","):
        print(json.dumps(probe(name, a.seed, a.passes)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the Holon dataplane on one NVIDIA card.

  python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. The device: name, count, and ``nvidia-smi``'s name and power limit.
2. Build the CUDA kernels from ``src/repro_torch/csrc`` with ``nvcc``.
3. Hold each kernel against its plain PyTorch version on the card, on the
   very arguments the dataplane passes it (recorded at ``kernels/ops.py``
   during two full-size sync rounds of each query) and at ragged edges;
   time both, and the host's cost of one launch through the wrapper.
4. Run the dataplane (``build_pipeline``) for every query at a full Nexmark
   deployment: 16 partitions at 625,000 events/s each (nexmark-flink's
   default 10 M events/s in all), 16,384 events per batch, 10 s windows
   (q5: sliding by 5 s), a 64-slot ring, a sync round every 4 batches, over
   1,528 batches (40.06 s of event time, about 4.0e8 events).  Hold every
   complete window against the port's own query oracle, delta sync against
   full sync (q4), and a second q4 run against the first, byte for byte;
   every kernel must have been launched by the queries that use it.
5. Print events/s and sync bytes per round per query, with the card.
6. A JSON line ``{"kernels": [...]}``, then the last line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX.  Without a card it fails before any result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores

# the full-size deployment (see the docstring)
S = 16
RATE = 625_000.0
B = 16_384
WINDOW_MS = 10_000
NUM_SLOTS = 64
SYNC_EVERY = 4
NUM_BATCHES = 1_528
SEED = 0
QUERIES = ("q0", "q1_ratio", "q4", "q5", "q7")
# f32 tolerances of the dataplane against the oracle (float64 or exact ints):
# q1_ratio: a 10 s window holds ~9.2e7 bids, beyond the 2^24 that f32
#   counts exactly, so the global count (a sum of 16 per-partition counts,
#   each exact) rounds at up to 15 additions and the ratio once more, each
#   by at most 2^-24 relatively: under 1e-6 in all.
# q4: each (partition, category, window) price sum adds ~1.2e6 prices in
#   f32, as 382 per-batch partial sums; float64 in the oracle.
RTOL = {"q1_ratio": 2e-6, "q4": 1e-4}
# kernel sums against the plain version on the card: the plain version adds
# by atomics in a run-dependent order; two f32 orders of n <= 3,300 positive
# terms differ by at most n * 2^-24 = 2e-4 relatively
SUM_RTOL = 2e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` runs, by CUDA events.

    The device first spins for ~10 ms, so the host has enqueued every run
    before the first one starts: the events then time the device's work
    back to back, not the host's launch rate (``host_us`` times that)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 100) -> float:
    """Mean host time of one call of ``fn`` in µs, while a device spin of
    ~50 ms keeps the card busy, so each call only enqueues its work."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


def wrapper_host_us(kernel, call) -> dict:
    """Host µs per launch through the kernel's dispatcher as the dataplane
    calls it (``call``: dispatch, checks, output allocation, stream lookup,
    ctypes launch), and of its C launch function alone, called through
    ctypes with the arguments that one ``call`` passed it."""
    seen = []
    c_fn = kernel._fn
    kernel._fn = lambda *a: seen.append(a) or c_fn(*a)
    try:
        out = call()  # kept alive: the bare launches below write into it
    finally:
        kernel._fn = c_fn
    if c_fn(*seen[0]) != 0:
        raise RuntimeError(f"{kernel.symbol}: bare launch failed")
    row = {"host_us": host_us(call), "launch_us": host_us(lambda: c_fn(*seen[0]))}
    torch.cuda.synchronize()
    del out
    return row


def bound_ms(nbytes: float, nops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def assert_equal(name: str, got, want) -> float:
    if not torch.equal(got, want):
        diff = (got.double() - want.double()).abs().max().item()
        raise AssertionError(f"{name}: kernel differs from the plain version (max |d| {diff})")
    return 0.0


def assert_close(name: str, got, want, rtol: float) -> float:
    err = (got.double() - want.double()).abs()
    tol = rtol * want.double().abs()
    if not bool((err <= tol).all()):
        raise AssertionError(f"{name}: max |d| {err.max().item()} beyond rtol {rtol}")
    return err.max().item()


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _cloned(x):
    return x.clone() if torch.is_tensor(x) else x


@contextlib.contextmanager
def recording_kernel_calls():
    """Record every call the dataplane makes to a kernel's dispatcher in
    ``kernels/ops.py`` (which still runs as usual): yields ``{kernel:
    [(args, kwargs), ...]}`` in call order, tensors cloned as they came."""
    from repro_torch.kernels import ops

    calls = {name: [] for name in ops.KERNELS}
    saved = {name: getattr(ops, name) for name in ops.KERNELS}

    def recorder(name):
        def call(*args, **kwargs):
            calls[name].append(([_cloned(a) for a in args],
                                {k: _cloned(v) for k, v in kwargs.items()}))
            return saved[name](*args, **kwargs)
        return call

    for name in saved:
        setattr(ops, name, recorder(name))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def main_path_calls(dev) -> dict:
    """Each query's kernel calls at the full-size deployment, exactly as
    ``build_pipeline`` makes them: ``{query: {kernel: [(args, kwargs)]}}``
    holding the fold calls of the last batch and the merge calls of the last
    sync round of two rounds whose last batch straddles a window boundary."""
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.launch.stream import MAKERS, build_pipeline
    from repro_torch.streaming.generator import NexmarkConfig, generate_log

    nb = 2 * SYNC_EVERY
    nx = NexmarkConfig(num_partitions=S, num_batches=nb, events_per_batch=B,
                       rate_per_partition=RATE, seed=SEED + 1)
    nx = dataclasses.replace(nx, base_ts=int(7 * WINDOW_MS - (nb - 0.5) * nx.batch_span_ms))
    log_ = generate_log(nx, dev)
    mesh = make_data_mesh(S, dev)
    per = {"window_agg": nb, "topk_window": nb, "gated_delta_merge": nb // SYNC_EVERY}
    out = {}
    for qn in QUERIES:
        q = MAKERS[qn](S, window_len=WINDOW_MS, num_slots=NUM_SLOTS)
        with recording_kernel_calls() as calls:
            build_pipeline(q, mesh, SYNC_EVERY, n_windows=1)(log_)
        out[qn] = {k: c[len(c) - len(c) // per[k]:] for k, c in calls.items()}
    return out


def _to_cpu(x):
    return x.cpu() if torch.is_tensor(x) else x


def check_window_agg(dev, calls: dict) -> dict:
    from repro_torch.kernels import ops, ref, window_agg

    rows = []
    for qn in ("q0", "q1_ratio", "q4", "q5"):
        for i, (args, kw) in enumerate(calls[qn]["window_agg"]):
            vals, slots, mask, W = args
            keys, C, init = kw.get("keys"), kw.get("C", 1), kw.get("init")
            L = vals.shape[1]
            # the path folds sums; q4's price lanes also check the other ops
            ops_ = ("sum", "count", "max", "min") if (qn, i) == ("q4", 0) else (kw["op"],)
            for op in ops_:
                kw_op = dict(kw, op=op)
                got = window_agg.window_agg(*args, **kw_op)
                want = ref.window_agg_ref(*args, **kw_op)
                cpu = ref.window_agg_ref(*(_to_cpu(a) for a in args),
                                         **{k: _to_cpu(v) for k, v in kw_op.items()})
                name = f"window_agg {qn} call {i} op={op} S={S} L={L} W={W} C={C}"
                if op == "sum":
                    err = assert_close(name, got, want, SUM_RTOL)
                else:
                    err = assert_equal(name, got, want)
                # lane-order folds on both sides: bitwise against the CPU version
                assert_equal(name + " (CPU plain version)", got.cpu(), cpu)
                row = {"shape": name, "max_abs_err": err}
                if op == kw["op"]:
                    row["ms"] = cuda_ms(lambda: window_agg.window_agg(*args, **kw_op))
                    row["plain_ms"] = cuda_ms(lambda: ref.window_agg_ref(*args, **kw_op))
                    cell = slots.long() * C + (0 if keys is None else keys.long())
                    srow = torch.arange(S, device=dev)[:, None].expand_as(cell)
                    vm = torch.where(mask, vals, 0.0)
                    acc = init.reshape(S, -1).clone()
                    row["library_ms"] = cuda_ms(
                        lambda: acc.index_put_((srow, cell), vm, accumulate=True))
                    row.update(wrapper_host_us(window_agg.KERNEL,
                                               lambda: ops.window_agg(*args, **kw_op)))
                    # bytes the fold needs: every mask byte, the value, slot
                    # and key of each live lane, init read and the output
                    # written; one operation per live lane and per cell
                    live = int(mask.sum())
                    lane_bytes = vals.element_size() + slots.element_size() + (
                        0 if keys is None else keys.element_size())
                    row["bound_ms"], row["bound_by"] = bound_ms(
                        nbytes(mask, init) + live * lane_bytes + nbytes(got),
                        live + got.numel())
                rows.append(row)
                log(json.dumps(row))
    # ragged edges: lanes not a tile multiple, uniform slots, all-masked rows
    g = torch.Generator(device=dev).manual_seed(1)
    for L, p in ((1, 0.8), (1000, 0.8), (16383, 0.8), (5000, 0.0)):
        vals = torch.randn((S, L), generator=g, device=dev) * 10
        slots = torch.randint(0, NUM_SLOTS, (S, L), generator=g, device=dev, dtype=torch.int32)
        keys = torch.randint(0, 5, (S, L), generator=g, device=dev, dtype=torch.int32)
        mask = torch.rand((S, L), generator=g, device=dev) < p
        for op in ("count", "max", "min"):
            got = window_agg.window_agg(vals, slots, mask, NUM_SLOTS, op=op, keys=keys, C=5)
            want = ref.window_agg_ref(vals, slots, mask, NUM_SLOTS, op=op, keys=keys, C=5)
            assert_equal(f"window_agg ragged L={L} p={p} op={op}", got, want)
    log("window_agg: ragged edges bitwise equal")
    return dict(max((r for r in rows if "ms" in r), key=lambda r: r["bound_ms"]),
                max_abs_err=max(r["max_abs_err"] for r in rows))


def gated_rows(wid: torch.Tensor) -> int:
    """Rows of an ``[R, W, F]`` leaf stack that the gated merge must read:
    per slot, the replicas holding its newest tenant, or replica 0 where the
    slot is clean on every replica."""
    top = wid.amax(0)
    return int(torch.where(top >= 0, (wid == top).sum(0), 1).sum())


def check_gated_delta_merge(dev, calls: dict) -> dict:
    from repro_torch.kernels import crdt_merge, ops, ref

    rows = []
    # the main path: each delta-synced query's merges of one sync round
    for qn in ("q1_ratio", "q4", "q5"):
        for i, (args, kw) in enumerate(calls[qn]["gated_delta_merge"]):
            wid, leaf = args
            op = kw["op"]
            R, W_ = wid.shape
            F = leaf[0, 0].numel()
            got = ops.gated_delta_merge(wid, leaf, op)
            name = f"gated_delta_merge {qn} call {i} R={R} W={W_} F={F} {leaf.dtype} {op}"
            err = assert_equal(name, got, ref.gated_delta_merge_ref(wid, leaf, op))
            n_rows = gated_rows(wid)
            row = {"shape": name + f" ({n_rows} of {R * W_} rows gated in)", "max_abs_err": err,
                   "ms": cuda_ms(lambda: ops.gated_delta_merge(wid, leaf, op)),
                   "plain_ms": cuda_ms(lambda: ref.gated_delta_merge_ref(wid, leaf, op)),
                   "library_ms": None}
            row.update(wrapper_host_us(crdt_merge.KERNEL,
                                       lambda: ops.gated_delta_merge(wid, leaf, op)))
            # bytes the merge needs: the wids, the gated rows, the output;
            # one join per element of a gated row
            row["bound_ms"], row["bound_by"] = bound_ms(
                nbytes(wid) + n_rows * F * leaf.element_size() + nbytes(got), n_rows * F)
            rows.append(row)
            log(json.dumps(row))
    # every dtype and join, random tenants, an all-clean stack
    g = torch.Generator(device=dev).manual_seed(2)
    for dtype, op in ((torch.float32, "min"), (torch.int32, "max"), (torch.int32, "min"),
                      (torch.uint8, "or"), (torch.uint8, "max")):
        for lo in (-1, -2):
            wid = torch.randint(lo, 4, (S, NUM_SLOTS), generator=g, device=dev).clamp(min=-1)
            wid = wid.to(torch.int32) if lo == -1 else torch.full_like(wid, -1, dtype=torch.int32)
            leaf = torch.randint(0, 200, (S, NUM_SLOTS, 80), generator=g, device=dev).to(dtype)
            leaf = torch.where((wid < 0)[..., None], torch.zeros_like(leaf), leaf)
            assert_equal(f"gated_delta_merge {dtype} {op}",
                         crdt_merge.gated_delta_merge(wid, leaf, op),
                         ref.gated_delta_merge_ref(wid, leaf, op))
    log("gated_delta_merge: every dtype and join bitwise equal, all-clean included")
    return dict(max(rows, key=lambda r: r["bound_ms"]),
                max_abs_err=max(r["max_abs_err"] for r in rows))


def check_topk_window(dev, calls: dict) -> dict:
    from repro_torch.kernels import ops, ref, topk_window

    (args, _), = calls["topk_window"]
    sv, si, vals, ids, slots, mask = args
    S_, W_, k = sv.shape
    L = vals.shape[1]
    got = topk_window.topk_window(*args)
    want = ref.topk_window_ref(*args)
    name = f"topk_window S={S_} W={W_} k={k} L={L}"
    assert_equal(name + " vals", got[0], want[0])
    assert_equal(name + " ids", got[1], want[1])
    row = {"shape": name, "max_abs_err": 0.0,
           "ms": cuda_ms(lambda: topk_window.topk_window(*args)),
           "plain_ms": cuda_ms(lambda: ref.topk_window_ref(*args), iters=5),
           "library_ms": None}
    row.update(wrapper_host_us(topk_window.KERNEL, lambda: ops.topk_window(*args)))
    # bytes the merge needs: the state, every mask byte, the value, id and
    # slot of each live lane (the path's mask holds the active windows'
    # bids), the output; one operation per live lane and per state entry
    live = int(mask.sum())
    lane_bytes = vals.element_size() + ids.element_size() + slots.element_size()
    row["bound_ms"], row["bound_by"] = bound_ms(
        nbytes(sv, si, mask) + live * lane_bytes + nbytes(*got), live + sv.numel())
    log(json.dumps(row))
    # tied prices, duplicate (price, id) pairs, ragged and all-masked lanes
    g = torch.Generator(device=dev).manual_seed(3)
    for L2, p in ((1, 0.9), (999, 0.9), (16384, 0.9), (4096, 0.0)):
        vals = torch.randint(0, 4, (S, L2), generator=g, device=dev).float()
        ids = torch.randint(0, 6, (S, L2), generator=g, device=dev)
        slots = torch.randint(0, 4, (S, L2), generator=g, device=dev, dtype=torch.int32)
        mask = torch.rand((S, L2), generator=g, device=dev) < p
        a2 = (sv, si, vals, ids, slots, mask)
        for got_t, want_t in zip(topk_window.topk_window(*a2), ref.topk_window_ref(*a2)):
            assert_equal(f"topk_window ties L={L2} p={p}", got_t, want_t)
    log("topk_window: ties, duplicates, ragged and all-masked lanes bitwise equal")
    return row


# ---------------------------------------------------------------------------
# phase 4: the dataplane at full size
# ---------------------------------------------------------------------------


def check_against_oracle(q, log_, oks, vals, first: int) -> int:
    """Every complete window against the port's oracle; returns how many
    windows every replica read as complete."""
    n = oks.shape[1]
    if not bool((oks == oks[:1]).all()):
        raise AssertionError(f"{q.name}: replicas disagree on which windows are complete")
    done = 0
    for j in range(n):
        if not bool(oks[0, j]):
            continue
        done += 1
        wid = first + j
        if q.name in ("q0", "q1_ratio"):
            want = torch.stack([q.oracle(log_, wid, p).reshape(1) for p in range(S)])
        elif q.name == "q7":
            v, i = q.oracle(log_, wid)
            want = torch.cat([v, i.to(torch.float32)]).expand(S, -1)
        else:
            want = q.oracle(log_, wid).reshape(1, -1).expand(S, -1)
        got = vals[:, j]
        if q.name in RTOL:
            assert_close(f"{q.name} window {wid}", got, want, RTOL[q.name])
        else:
            assert_equal(f"{q.name} window {wid} (oracle)", got, want)
    return done


def run_pipeline(q, mesh, log_, delta: bool, first: int, n: int):
    """One warm-up sync round, then the timed run of the whole log, with
    every kernel's launch count set to 0 just before it."""
    from repro_torch.kernels import ops
    from repro_torch.launch.stream import build_pipeline
    from repro_torch.obs.timing import WallTimer

    pipe = build_pipeline(q, mesh, SYNC_EVERY, delta_sync=delta, n_windows=n, first_window=first)
    pipe(log_.map(lambda x: x[:, :SYNC_EVERY]))  # warm-up: one sync round
    for kern in ops.KERNELS.values():
        kern.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with WallTimer(mesh.device) as tm:
        out = pipe(log_)
    return out, tm.dt, torch.cuda.max_memory_allocated()


def run_dataplane(dev):
    """Phase 4: every query at full size, checked; returns the result rows
    and each kernel's launches over all runs."""
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.launch.stream import MAKERS, read_window_range
    from repro_torch.streaming.generator import NexmarkConfig, generate_log

    nx = NexmarkConfig(num_partitions=S, num_batches=NUM_BATCHES, events_per_batch=B,
                       rate_per_partition=RATE, seed=SEED)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    the_log = generate_log(nx, dev)
    torch.cuda.synchronize()
    log_bytes = sum(nbytes(getattr(the_log, f)) for f in
                    ("ts", "kind", "auction", "price", "category", "bidder", "valid"))
    log(f"log: {S * NUM_BATCHES * B} events, {log_bytes / 1e9:.2f} GB on the device, made in "
        f"{time.perf_counter() - t0:.2f} s; peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    mesh = make_data_mesh(S, dev)
    horizon = NUM_BATCHES * nx.batch_span_ms
    n_events = S * NUM_BATCHES * B
    n_rounds = NUM_BATCHES // SYNC_EVERY
    launches = {k: 0 for k in ops.KERNELS}
    results = []
    q4_delta = None
    for qn, delta in [(qn, True) for qn in QUERIES] + [("q4", False), ("q4", True)]:
        q = MAKERS[qn](S, window_len=WINDOW_MS, num_slots=NUM_SLOTS)
        first, n = read_window_range(q, horizon)
        (oks, vals, sb), dt, peak = run_pipeline(q, mesh, the_log, delta, first, n)
        counts = {k: kern.launches for k, kern in ops.KERNELS.items()}
        uses = {"window_agg": qn != "q7", "topk_window": qn == "q7",
                "gated_delta_merge": delta and qn in ("q1_ratio", "q4", "q5")}
        for k, c in counts.items():
            if uses[k] != (c > 0):
                raise AssertionError(f"{qn}: kernel {k} launched {c} times")
            launches[k] += c
        done = check_against_oracle(q, the_log, oks, vals, first)
        need = 7 if qn == "q5" else 4
        if done < need:
            raise AssertionError(f"{qn}: {done} complete windows, expected {need}")
        mode = "delta" if delta else "full"
        if qn == "q4" and q4_delta is not None:
            other, what = q4_delta, "full sync" if not delta else "a second run"
            for a, b_, nm in ((oks, other[0], "oks"), (vals, other[1], "vals")):
                if not torch.equal(a, b_):
                    raise AssertionError(f"q4 {nm}: {what} differs from the first delta run")
            if delta and not torch.equal(sb, other[2]):
                raise AssertionError("q4 sync_bytes: a second run differs")
            log(f"q4: {what} gives byte-identical oks and vals")
        if qn == "q4" and q4_delta is None:
            q4_delta = (oks, vals, sb)
        row = {"query": qn, "sync": mode, "events": n_events, "seconds": dt,
               "events_per_s": n_events / dt, "complete_windows": done,
               "sync_bytes_per_round": sb.mean().item() / n_rounds,
               "peak_gb": peak / 1e9, "launches": counts}
        results.append(row)
        log(json.dumps(row))

    return results, launches


def profile_share(dev) -> None:
    """Device busy share of q4 and q7 over 64 batches, from a
    ``torch.profiler`` trace: the sum of device-side event times (kernels,
    copies, fills; one stream, so they do not overlap) over the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.launch.stream import MAKERS, build_pipeline
    from repro_torch.streaming.generator import NexmarkConfig, generate_log

    nb = 64
    nx = NexmarkConfig(num_partitions=S, num_batches=nb, events_per_batch=B,
                       rate_per_partition=RATE, seed=SEED)
    part = generate_log(nx, dev)
    for qn in ("q4", "q7"):
        q = MAKERS[qn](S, window_len=WINDOW_MS, num_slots=NUM_SLOTS)
        pipe = build_pipeline(q, make_data_mesh(S, dev), SYNC_EVERY, n_windows=1)
        pipe(part)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pipe(part)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in rows)
        top = sorted(rows, key=lambda e: -e.self_device_time_total)[:6]
        log(json.dumps({
            "profile": qn, "batches": nb, "wall_us": wall_us, "device_busy_us": busy,
            "device_idle_share": 1 - busy / wall_us if busy else None,
            "top_kernels_us": {e.key[:60]: e.self_device_time_total for e in top},
        }))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA card",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import build, ops

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    log(f"== phase 1: device {name} (count {count}); torch {torch.__version__} "
        f"CUDA {torch.version.cuda}")
    log(smi)

    log("== phase 2: build")
    t0 = time.perf_counter()
    report = build.build(list(ops.KERNELS))
    for kname, r in report.items():
        usage = [ln.strip() for ln in r["log"].splitlines() if "registers" in ln or "spill" in ln]
        log(f"built {kname}.cu in {r['seconds']:.2f} s: " + " | ".join(usage))
    log(f"build wall time {time.perf_counter() - t0:.2f} s ({len(report)} sources)")

    log(f"== phase 3: kernels against their plain versions {card}")
    calls = main_path_calls(dev)
    kernel_rows = {
        "window_agg": check_window_agg(dev, calls),
        "gated_delta_merge": check_gated_delta_merge(dev, calls),
        "topk_window": check_topk_window(dev, calls["q7"]),
    }

    log(f"== phase 4: dataplane, S={S} partitions x {RATE:.0f} ev/s, B={B}, "
        f"window {WINDOW_MS} ms, {NUM_BATCHES} batches")
    results, launches = run_dataplane(dev)
    profile_share(dev)

    log(f"== phase 5: throughput {card}")
    for r in results:
        log(f"{r['query']:9s} sync={r['sync']:5s} {r['events_per_s']:.6e} events/s "
            f"sync_bytes_per_round={r['sync_bytes_per_round']:.1f} {card}")

    src = {"window_agg": "window_agg.py:90", "gated_delta_merge": "crdt_merge.py:96",
           "topk_window": "topk_window.py:46"}
    kernels = []
    for k, row in kernel_rows.items():
        kernels.append({
            "name": k, "route": "cuda", "source": f"src/repro_torch/csrc/{k}.cu",
            "replaces": f"src/repro/kernels/{src[k]}", "launches": launches[k],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "host_us": row["host_us"],
            "launch_us": row["launch_us"], "shape": row["shape"],
        })
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

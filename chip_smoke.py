#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the Holon dataplane on one NVIDIA card.

  python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. The device: name, count, and ``nvidia-smi``'s name and power limit.
2. Build the five CUDA sources under ``src/repro_torch/csrc`` with
   ``nvcc``, one process per source, all at once, beside a probe of one
   thread's add chain and an empty kernel (the launch floor).
3. Build a small log with the port's threefry generator on the card and
   on the CPU and hold the two equal (``check_generator``).  Then hold
   each kernel against its plain PyTorch version on the card, on the
   very arguments the dataplane passes it (recorded at ``kernels/ops.py``
   during two full-size sync rounds of each query, of the keyed dataplane
   and of dense q5 at 10,000 auctions) and at ragged edges; time both, the
   one PyTorch call that computes the same function where there is one, and
   the host's cost of one launch through the wrapper.  Each kernel is timed
   in three separate batches of 20 launches, all three printed.  The fold
   (``window_agg``) is checked bitwise against the CPU plain version and a
   second launch on every recorded call and on two stress shapes (one cell
   taking every lane; zipf(1.1) keys over 64), and each of its timed rows
   carries its serial-chain floor: the time one thread takes, measured
   here, for a chain of dependent f32 adds as long as its fullest cell.
   The merge side of a dense sync round is one fused launch
   (``delta_merge_join``), held bitwise against its plain version and
   against the parent's sequence (the standalone ``gated_delta_merge`` and
   ``crdt_merge`` kernels, then ``_merge_wstate``'s torch ops), both timed
   on the same inputs; the standalone kernels are still checked and timed
   on the stacks the fused launch receives.  An empty kernel, timed by the
   same loop, gives the launch floor beside the launch-bound rows.
4. Run the dataplane (``build_pipeline``) for every query at a full Nexmark
   deployment: 16 partitions at 625,000 events/s each (nexmark-flink's
   default 10 M events/s in all), 16,384 events per batch, 10 s windows
   (q5: sliding by 5 s), a 64-slot ring, a sync round every 4 batches, over
   1,528 batches (40.06 s of event time, about 4.0e8 events).  Hold every
   complete window against the port's own query oracle, delta sync against
   full sync (q4), and a second q4 run against the first, byte for byte;
   every kernel must have been launched by the queries that use it (a
   dense delta run launches the fused merge once a spec a round and no
   standalone join; ``crdt_merge`` is launched by the keyed runs alone,
   once an exchange).  Then
   the hash-sharded keyed dataplane (``build_keyed_pipeline``) on the same
   deployment over 1,000,000 zipf(1.1) auction ids (the repo's million-key
   sweep, ``benchmarks/keyed_scale.py``): every complete window of every
   shard against ``q5_hot_oracle``, the byte counters against counts made
   apart, a second run byte for byte; a crash-replay schedule and a healed
   watermark partition against the clean run, and a plane never healed;
   and dense q5 at 10,000 auctions, whose fold takes the segment reduce.
5. Print events/s and sync bytes per round per run, with the card.
6. A JSON line ``{"kernels": [...]}``, then the last line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX.  Without a card it fails before any result.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
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
# the keyed deployment: the million-key point of the repo's keyed sweep
# (benchmarks/keyed_scale.py KEY_DOMAINS, KEY_SKEW) on the same source
NUM_KEYS = 1_000_000
KEY_SKEW = 1.1
KEYED_SLOTS = 16  # the keyed pipeline's default ring
# depth of the chaos and dense-q5 runs: the first 10 s window closes after
# 382 batches, so 512 hold one complete window
SHORT_BATCHES = 512
CRASH_AFTER, REPLAY_FROM = 199, 160  # every shard re-folds 160-199 after step 199
PARTITIONED = (10, 30)  # watermark rounds 10-29 cut off, then healed
DENSE_Q5_KEYS = 10_000  # the keyed sweep's dense comparand
# the segment reduce against its plain version on the card, which sums by
# atomics in another order (the path's sums are of 1.0s, exact either way)
SEG_SUM_RTOL = 1e-5
# f32 tolerances of the dataplane against the oracle (exact ints, or f32):
# q1_ratio: a 10 s window holds ~9.2e7 bids, beyond the 2^24 that f32
#   counts exactly, so the global count (a sum of 16 per-partition counts,
#   each exact) rounds at up to 15 additions and the ratio once more, each
#   by at most 2^-24 relatively: under 1e-6 in all.
# q4: each (partition, category, window) price sum adds ~1.2e6 prices in
#   f32, as 382 per-batch partial sums; the oracle sums the JAX package's
#   exact f32 one-hot products, by torch's tree sum on the card.
RTOL = {"q1_ratio": 2e-6, "q4": 1e-4}
# kernel sums against the plain version on the card: the plain version adds
# by atomics in a run-dependent order; two f32 orders of n <= 3,300 positive
# terms differ by at most n * 2^-24 = 2e-4 relatively
SUM_RTOL = 2e-4
# one thread's chain of n dependent f32 adds, timed on the SM's clock and
# the global timer: the floor of a lane-order sum over n lanes (its values
# come from registers, so only the adds are serial)
CHAIN_SRC = r"""
#include <cuda_runtime.h>
__global__ void chain(const float* x, float* out, long long* t, int n) {
  float acc = x[0];
  const float a = x[1], b = x[2], c = x[3], d = x[4];
  unsigned long long g0, g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  const long long c0 = clock64();
  int i = 0;
  for (; i + 4 <= n; i += 4) { acc = acc + a; acc = acc + b; acc = acc + c; acc = acc + d; }
  for (; i < n; ++i) acc = acc + a;
  const long long c1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  out[0] = acc;
  t[0] = c1 - c0;
  t[1] = (long long)(g1 - g0);
}
extern "C" int chain_launch(const float* x, float* out, long long* t, int n, cudaStream_t s) {
  chain<<<1, 1, 0, s>>>(x, out, t, n);
  return (int)cudaGetLastError();
}
__global__ void empty() {}
extern "C" int empty_launch(cudaStream_t s) {
  empty<<<1, 32, 0, s>>>();
  return (int)cudaGetLastError();
}
"""


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


def kernel_ms(fn, batches: int = 3, iters: int = 20) -> dict:
    """A kernel's device time: ``ms``, the mean of ``batches`` separate
    :func:`cuda_ms` batches of ``iters`` launches, and ``ms_batches``, each
    batch's mean, so that a reading that differs between batches shows."""
    times = [cuda_ms(fn, iters) for _ in range(batches)]
    return {"ms": sum(times) / len(times), "ms_batches": times}


def host_us(fn, iters: int = 100) -> float:
    """Mean host time of one call of ``fn`` in µs, while a device spin of
    ~50 ms keeps the card busy, so each call only enqueues its work (keep
    ``iters`` times the call's launches under the launch queue's ~1,000)."""
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


def start_chain_build() -> tuple:
    """Start ``nvcc`` on :data:`CHAIN_SRC` into ``build/``; returns what
    :func:`load_chain` waits on."""
    from repro_torch.kernels import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src, lib = build.BUILD_DIR / "chain_floor.cu", build.BUILD_DIR / "chain_floor.so"
    src.write_text(CHAIN_SRC)
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


_CHAIN = {}


def load_chain(started: tuple) -> None:
    proc, lib = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"chain_floor.cu: nvcc exit {proc.returncode}\n{out}")
    so = ctypes.CDLL(str(lib))
    fn = so.chain_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _CHAIN["fn"] = fn
    so.empty_launch.argtypes = [ctypes.c_void_p]
    so.empty_launch.restype = ctypes.c_int
    _CHAIN["empty"] = so.empty_launch


def launch_floor() -> dict:
    """An empty kernel (one warp) timed by :func:`kernel_ms`, and the host
    µs of its bare ctypes launch: what any launch costs on this card."""
    empty = _CHAIN["empty"]

    def launch():
        if empty(torch.cuda.current_stream().cuda_stream) != 0:
            raise RuntimeError("empty kernel: launch failed")

    row = {"launch_floor": "empty kernel, 1 warp", **kernel_ms(launch),
           "launch_us": host_us(launch)}
    log(json.dumps(row))
    return row


def device_kernels(fn) -> int:
    """Device kernels (copies and fills included) one call of ``fn`` runs,
    by ``torch.profiler``, after a warm call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def run_chain(n: int) -> tuple[int, int]:
    """SM cycles and global-timer ns of one thread's chain of ``n``
    dependent f32 adds."""
    x = torch.tensor([0.5, 1.25, -0.75, 0.375, 2.5], device="cuda")
    out = torch.empty(1, device="cuda")
    t = torch.zeros(2, dtype=torch.int64, device="cuda")
    if _CHAIN["fn"](x.data_ptr(), out.data_ptr(), t.data_ptr(), n,
                    torch.cuda.current_stream().cuda_stream) != 0:
        raise RuntimeError("chain_floor: launch failed")
    cycles, ns = t.tolist()
    if not (cycles > 0 and torch.isfinite(out).all()):
        raise RuntimeError(f"chain_floor: {cycles} cycles, out {out.item()}")
    return cycles, ns


@functools.lru_cache(maxsize=None)
def chain_clock() -> tuple[float, float]:
    """SM cycles per dependent f32 add and the SM clock (Hz), measured on
    a chain of 2^22 adds (about 8 ms)."""
    n = 1 << 22
    run_chain(n)  # warm-up
    cycles, ns = run_chain(n)
    return cycles / n, cycles / ns * 1e9


def chain_floor_ms(n: int) -> float:
    """The measured time of one thread's chain of ``n`` dependent f32 adds
    (the median of three, in SM cycles over the SM clock of
    :func:`chain_clock`)."""
    cycles = sorted(run_chain(n)[0] for _ in range(3))[1]
    return cycles / chain_clock()[1] * 1e3


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
# the generator: the same log on the card as on the CPU
# ---------------------------------------------------------------------------


def check_generator(dev) -> dict:
    """A log of 4 batches of every partition, built with the port's threefry
    generator on the card and on the CPU: every field bitwise, except that
    under a zipf ``key_skew`` other than 0 or 1 (a float64 ``pow``, whose
    last bit may differ between the two devices' libraries) an auction id
    and its category may be off by one, in at most 1 lane in 10^4."""
    from repro_torch.streaming.generator import NexmarkConfig, generate_log

    row = {"generator": f"S={S} x 4 batches x B={B}"}
    for key_skew, skew, keys in ((0.0, 0.0, 1000), (1.0, 1.5, NUM_KEYS), (KEY_SKEW, 0.0, NUM_KEYS)):
        nx = NexmarkConfig(num_partitions=S, num_batches=4, events_per_batch=B,
                           rate_per_partition=RATE, seed=SEED, skew=skew, num_auctions=keys,
                           key_skew=key_skew)
        t0 = time.perf_counter()
        on_card = generate_log(nx, dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        on_cpu = generate_log(nx, "cpu")
        t2 = time.perf_counter()
        off = 0
        for f in dataclasses.fields(on_cpu):
            a, b_ = getattr(on_card, f.name).cpu(), getattr(on_cpu, f.name)
            if f.name in ("auction", "category") and key_skew not in (0.0, 1.0):
                d = (a.to(torch.int64) - b_.to(torch.int64)).abs()
                off = max(off, int((d != 0).sum()))
                if int(d.max()) > 1 or off * 10_000 > a.numel():
                    raise AssertionError(f"generator {f.name}: card and CPU differ in {off} "
                                         f"lanes, by up to {int(d.max())}")
            elif not torch.equal(a, b_):
                raise AssertionError(f"generator key_skew={key_skew} {f.name}: card and CPU "
                                     "logs differ")
        row[f"key_skew={key_skew}"] = {"card_s": t1 - t0, "cpu_s": t2 - t1, "ids_off_by_one": off}
    log(json.dumps(row))
    return row


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _cloned(x):
    if isinstance(x, list):
        return [_cloned(v) for v in x]
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
    """Each run's kernel calls at the full-size deployment, exactly as the
    dataplane makes them: ``{run: {kernel: [(args, kwargs)]}}`` holding the
    fold calls of the last batch and the merge calls of the last sync round
    of two rounds whose last batch straddles a window boundary.  Runs: every
    query of ``build_pipeline``, the keyed dataplane (``keyed``) and dense
    q5 at 10,000 auctions (``q5_10k``)."""
    from repro_torch.core.wcrdt import KeyShards
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.launch.stream import (
        MAKERS, build_keyed_pipeline, build_pipeline, default_fold_schedule,
    )
    from repro_torch.streaming.generator import NexmarkConfig, generate_log

    nb = 2 * SYNC_EVERY
    nx = NexmarkConfig(num_partitions=S, num_batches=nb, events_per_batch=B,
                       rate_per_partition=RATE, seed=SEED + 1)
    nx = dataclasses.replace(nx, base_ts=int(7 * WINDOW_MS - (nb - 0.5) * nx.batch_span_ms))
    mesh = make_data_mesh(S, dev)
    per = {"window_agg": nb, "topk_window": nb, "gated_delta_merge": nb // SYNC_EVERY,
           "segment_reduce": nb, "crdt_merge": nb // SYNC_EVERY,
           "delta_merge_join": nb // SYNC_EVERY}

    def last(calls):
        return {k: c[len(c) - len(c) // per[k]:] for k, c in calls.items()}

    out = {}
    log_ = generate_log(nx, dev)
    for qn in QUERIES:
        q = MAKERS[qn](S, window_len=WINDOW_MS, num_slots=NUM_SLOTS)
        with recording_kernel_calls() as calls:
            build_pipeline(q, mesh, SYNC_EVERY, n_windows=1)(log_)
        out[qn] = last(calls)
    skewed = dataclasses.replace(nx, key_skew=KEY_SKEW)
    log_ = generate_log(dataclasses.replace(skewed, num_auctions=DENSE_Q5_KEYS), dev)
    q = MAKERS["q5"](S, window_len=WINDOW_MS, num_slots=NUM_SLOTS, num_auctions=DENSE_Q5_KEYS)
    with recording_kernel_calls() as calls:
        build_pipeline(q, mesh, SYNC_EVERY, n_windows=1)(log_)
    out["q5_10k"] = last(calls)
    log_ = generate_log(dataclasses.replace(skewed, num_auctions=NUM_KEYS), dev)
    shards = KeyShards(NUM_KEYS, S)
    pipe = build_keyed_pipeline(mesh, shards, window_len=WINDOW_MS, num_slots=KEYED_SLOTS,
                                sync_every=SYNC_EVERY, n_windows=1)
    with recording_kernel_calls() as calls:
        pipe(log_, shards.key_table(dev), default_fold_schedule(S, nb),
             torch.ones(nb // SYNC_EVERY, dtype=torch.bool))
    out["keyed"] = last(calls)
    return out


def _to_cpu(x):
    return x.cpu() if torch.is_tensor(x) else x


def fullest_cell(slots, mask, keys, C: int) -> int:
    """The live lanes of the fullest (replica, cell): the longest chain of
    a lane-order sum on these lanes."""
    cell = slots.long() * C + (0 if keys is None else keys.long())
    cell = torch.where(mask, cell, -1)
    return max(int(torch.unique(r[r >= 0], return_counts=True)[1].max())
               if bool((r >= 0).any()) else 0 for r in cell)


def window_agg_row(dev, name: str, args, kw: dict, timed: bool,
                   sum_rtol: float = SUM_RTOL) -> dict:
    """Hold the fold kernel against its plain versions on one call (bitwise
    against the CPU one, a second launch bitwise against the first); if
    ``timed``, time the kernel, its plain version on the card and one
    ``index_put_`` computing the same sum.  Sums hold against the card's
    plain version, which adds by atomics in another order, to ``sum_rtol``."""
    from repro_torch.kernels import ops, ref, window_agg

    vals, slots, mask, W = args
    keys, C, init = kw.get("keys"), kw.get("C", 1), kw.get("init")
    op = kw["op"]
    got = window_agg.window_agg(*args, **kw)
    want = ref.window_agg_ref(*args, **kw)
    cpu = ref.window_agg_ref(*(_to_cpu(a) for a in args), **{k: _to_cpu(v) for k, v in kw.items()})
    if op == "sum":
        err = assert_close(name, got, want, sum_rtol)
    else:
        err = assert_equal(name, got, want)
    # lane-order folds on both sides: bitwise against the CPU version
    assert_equal(name + " (CPU plain version)", got.cpu(), cpu)
    # no atomics: a second launch gives the same bits
    assert_equal(name + " (second run)", window_agg.window_agg(*args, **kw), got)
    row = {"shape": name, "max_abs_err": err}
    if not timed:
        return row
    row.update(kernel_ms(lambda: window_agg.window_agg(*args, **kw)))
    row["plain_ms"] = cuda_ms(lambda: ref.window_agg_ref(*args, **kw))
    cell = slots.long() * C + (0 if keys is None else keys.long())
    srow = torch.arange(vals.shape[0], device=dev)[:, None].expand_as(cell)
    vm = torch.where(mask, vals, 0.0)
    acc = init.reshape(vals.shape[0], -1).clone()
    row["library_ms"] = cuda_ms(lambda: acc.index_put_((srow, cell), vm, accumulate=True))
    row.update(wrapper_host_us(window_agg.KERNEL, lambda: ops.window_agg(*args, **kw)))
    # bytes the fold needs: every mask byte, the value, slot and key of each
    # live lane, init read and the output written; one operation per live
    # lane and per cell
    live = int(mask.sum())
    lane_bytes = vals.element_size() + slots.element_size() + (
        0 if keys is None else keys.element_size())
    row["bound_ms"], row["bound_by"] = bound_ms(
        nbytes(mask, init) + live * lane_bytes + nbytes(got), live + got.numel())
    row["chain_lanes"] = fullest_cell(slots, mask, keys, C)
    row["chain_floor_ms"] = chain_floor_ms(row["chain_lanes"])
    return row


def check_window_agg(dev, calls: dict) -> dict:
    from repro_torch.kernels import ref, window_agg

    rows = []
    for qn in ("q0", "q1_ratio", "q4", "q5"):
        for i, (args, kw) in enumerate(calls[qn]["window_agg"]):
            vals, slots, mask, W = args
            C = kw.get("C", 1)
            # the path folds sums; q4's price lanes also check the other ops
            ops_ = ("sum", "count", "max", "min") if (qn, i) == ("q4", 0) else (kw["op"],)
            for op in ops_:
                name = f"window_agg {qn} call {i} op={op} S={S} L={vals.shape[1]} W={W} C={C}"
                rows.append(window_agg_row(dev, name, args, dict(kw, op=op), op == kw["op"]))
                log(json.dumps(rows[-1]))
    # stress shapes: one cell takes every lane of a replica (C=1); zipf(1.1)
    # keys over C=64 at q5's lane count, in two adjacent slots as q5's hop
    g = torch.Generator(device=dev).manual_seed(6)
    for tag, L, C in (("one cell", B, 1), ("zipf(1.1) keys", 2 * B, 64)):
        vals = torch.rand((S, L), generator=g, device=dev) * 10 + 0.1
        if C == 1:
            slots = torch.full((S, L), 17, dtype=torch.int32, device=dev)
            mask, keys = torch.ones((S, L), dtype=torch.bool, device=dev), None
        else:
            slots = (torch.rand((S, L), generator=g, device=dev) < 0.5).to(torch.int32) + 5
            mask = torch.rand((S, L), generator=g, device=dev) < 0.9
            w = 1.0 / torch.arange(1, C + 1, device=dev, dtype=torch.float64) ** KEY_SKEW
            keys = torch.multinomial(w.expand(S, C), L, replacement=True,
                                     generator=g).to(torch.int32)
        init = torch.rand((S, NUM_SLOTS, C), generator=g, device=dev) * 1e3
        args = (vals, slots, mask, NUM_SLOTS)
        for op in ("sum", "count", "max", "min"):
            name = f"window_agg stress {tag} op={op} S={S} L={L} W={NUM_SLOTS} C={C}"
            # two f32 orders of the n <= L positive terms of a cell differ
            # by at most n * 2^-24 relatively
            row = window_agg_row(dev, name, args, dict(op=op, keys=keys, C=C, init=init),
                                 op == "sum", sum_rtol=L * 2.0**-24)
            if op == "sum":
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
    log("window_agg: ragged edges bitwise equal; stress shapes bitwise equal for every op")
    path = [r for r in rows if "ms" in r and "stress" not in r["shape"]]
    return dict(max(path, key=lambda r: r["bound_ms"]),
                max_abs_err=max(r["max_abs_err"] for r in rows))


def gated_rows(wid: torch.Tensor) -> int:
    """Rows of an ``[R, W, F]`` leaf stack that the gated merge must read:
    per slot, the replicas holding its newest tenant, or replica 0 where the
    slot is clean on every replica."""
    top = wid.amax(0)
    return int(torch.where(top >= 0, (wid == top).sum(0), 1).sum())


# the dense runs whose merge side is recorded: (query maker, its options)
DENSE_MERGES = {"q1_ratio": ("q1_ratio", {}), "q4": ("q4", {}), "q5": ("q5", {}),
                "q5_10k": ("q5", {"num_auctions": DENSE_Q5_KEYS})}


def merge_inputs(calls: dict, tag: str):
    """The last sync round's fused-merge calls of a dense run, one a spec:
    ``[(spec, args)]``."""
    from repro_torch.launch.stream import MAKERS

    maker, kw = DENSE_MERGES[tag]
    specs = MAKERS[maker](S, window_len=WINDOW_MS, num_slots=NUM_SLOTS, **kw).shared_specs
    recorded = calls[tag]["delta_merge_join"]
    if len(recorded) != len(specs):
        raise AssertionError(f"{tag}: {len(recorded)} fused merges in a round, {len(specs)} specs")
    return [(spec, args) for spec, (args, _) in zip(specs, recorded)]


def check_gated_delta_merge(dev, calls: dict) -> dict:
    """The standalone gated merge (the Pallas function's counterpart) on
    the stacks the fused merge receives on the main path."""
    from repro_torch.kernels import crdt_merge, ops, ref

    rows = []
    for qn in ("q1_ratio", "q4", "q5"):
        for i, (_, args) in enumerate(merge_inputs(calls, qn)):
            _, wid, _, leaves, joins, _, _ = args
            for leaf, op in zip(leaves, joins):
                R, W_ = wid.shape
                F = leaf[0, 0].numel()
                got = ops.gated_delta_merge(wid, leaf, op)
                name = f"gated_delta_merge {qn} call {i} R={R} W={W_} F={F} {leaf.dtype} {op}"
                err = assert_equal(name, got, ref.gated_delta_merge_ref(wid, leaf, op))
                n_rows = gated_rows(wid)
                row = {"shape": name + f" ({n_rows} of {R * W_} rows gated in)",
                       "max_abs_err": err,
                       **kernel_ms(lambda: ops.gated_delta_merge(wid, leaf, op)),
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


def _merge_outputs(out) -> list:
    wid, leaves, meta = out
    return [wid, *leaves, *meta]


def merge_edge_case(g, dev, S_: int, R: int, W_: int, fields: list, edge: str):
    """Arguments of the fused merge with every slot edge: clean on every
    replica of stack and state (both -1), clean on every delta replica, the
    state newer than every delta, equal wids; and whole-stack variants."""
    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev, dtype=torch.int32)

    state_wid, stack_wid = ints(-1, 6, (S_, W_)), ints(-1, 6, (R, W_))
    state_wid[:, 0] = stack_wid[:, 0] = -1
    stack_wid[:, 1] = -1
    state_wid[:, 2] = 9
    state_wid[:, 3] = stack_wid[:, 3] = 4
    if edge == "all clean":
        stack_wid.fill_(-1)
    elif edge == "state newer":
        state_wid.fill_(9)
    elif edge == "equal wids":
        state_wid.fill_(2)
        stack_wid.fill_(2)
    sl, kl, joins = [], [], []
    for dtype, op, F in fields:
        for lead, out in ((S_, sl), (R, kl)):
            x = torch.randint(0, 256, (lead, W_, F), generator=g, device=dev)
            out.append(x.to(dtype) if dtype == torch.uint8 else (x - 128).to(dtype) * 3)
        joins.append(op)
    sm = [ints(-5, 50, (S_, n)) for n in (16, 16, 3)]
    km = [ints(-5, 50, (R, n)) for n in (16, 16, 3)]
    return state_wid, stack_wid, sl, kl, joins, sm, km


def check_delta_merge_join(dev, calls: dict, floor: dict) -> dict:
    """The fused merge side of a dense sync round at every recorded call:
    bitwise its plain version and the parent's sequence (``merge_delta_stack``
    on the standalone kernels, then ``_merge_wstate``); kernel, plain and
    parent µs, host µs of each, and the device kernels one call runs."""
    from repro_torch.core import wcrdt as W
    from repro_torch.kernels import crdt_merge, ops, ref

    rows = []
    for tag in DENSE_MERGES:
        for i, (spec, args) in enumerate(merge_inputs(calls, tag)):
            state_wid, stack_wid, sl, kl, joins, sm, km = args
            cls = type(spec.zero_windows(dev))
            st = W.WState(state_wid, cls(**dict(zip(cls.KINDS, sl))), *sm)
            stk = W.WState(stack_wid, cls(**dict(zip(cls.KINDS, kl))), *km)

            def fused():
                return ops.delta_merge_join(*args)

            def parent():
                return W._merge_wstate(st, W.merge_delta_stack(spec, stk))

            R, W_ = stack_wid.shape
            Fs = [x[0, 0].numel() for x in sl]
            name = (f"delta_merge_join {tag} call {i} S={state_wid.shape[0]} R={R} W={W_} "
                    f"F={Fs} {[str(x.dtype) for x in sl]} {joins}")
            got = fused()
            want = ref.delta_merge_join_ref(*args)
            p = parent()
            p = (p.slot_wid, [getattr(p.windows, n) for n in cls.KINDS],
                 [p.progress, p.folded, p.errors])
            for k, (a, b, c) in enumerate(zip(_merge_outputs(got), _merge_outputs(want),
                                              _merge_outputs(p))):
                assert_equal(f"{name} output {k}", a, b)
                assert_equal(f"{name} output {k} (parent's sequence)", a, c)
            n_rows = gated_rows(stack_wid)
            row = {"shape": name + f" ({n_rows} of {R * W_} rows gated in)", "max_abs_err": 0.0,
                   **kernel_ms(fused), "plain_ms": cuda_ms(lambda: ref.delta_merge_join_ref(*args)),
                   "parent_ms": cuda_ms(parent), "library_ms": None,
                   "launch_floor_ms": floor["ms"],
                   "device_kernels": device_kernels(fused),
                   "parent_device_kernels": device_kernels(parent),
                   "parent_host_us": host_us(parent, iters=20)}
            row.update(wrapper_host_us(crdt_merge.JOIN_KERNEL, fused))
            # bytes the merge side needs: both wid stacks, the gated-in rows,
            # the state leaves and metadata, the stacked metadata, every
            # output; one join per gated-in element and per state element
            leaf_bytes = sum(n_rows * F * x.element_size() for F, x in zip(Fs, sl))
            row["bound_ms"], row["bound_by"] = bound_ms(
                nbytes(state_wid, stack_wid, *sl, *sm, *km, *_merge_outputs(got)) + leaf_bytes,
                sum((n_rows + x.numel() // F) * F for F, x in zip(Fs, sl)))
            rows.append(row)
            log(json.dumps(row))
    # edges: mixed dtypes and joins in one launch, F off every tile width,
    # R = 1 and R != S, whole-stack clean, state newer, equal wids
    g = torch.Generator(device=dev).manual_seed(7)
    mixed = [(torch.float32, "max", 129), (torch.int32, "min", 2), (torch.uint8, "or", 64),
             (torch.float32, "min", 33), (torch.uint8, "max", 1), (torch.int32, "max", 65),
             (torch.uint8, "min", 300), (torch.float32, "max", 16)]
    for S_, R, W_ in ((S, S, NUM_SLOTS), (S, 1, NUM_SLOTS), (3, 5, 7)):
        for edge in ("mixed", "all clean", "state newer", "equal wids"):
            args = merge_edge_case(g, dev, S_, R, W_, mixed, edge)
            for k, (a, b) in enumerate(zip(_merge_outputs(ops.delta_merge_join(*args)),
                                           _merge_outputs(ref.delta_merge_join_ref(*args)))):
                assert_equal(f"delta_merge_join edge {edge} S={S_} R={R} W={W_} output {k}", a, b)
    log("delta_merge_join: 8 fields of mixed dtypes and joins in one launch, R = 1 and "
        "R != S, clean, newer and equal slots bitwise equal")
    return max(rows, key=lambda r: r["bound_ms"])


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
           **kernel_ms(lambda: topk_window.topk_window(*args)),
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
    # tied prices, duplicate (price, id) pairs, ragged and all-masked lanes;
    # every lane in its own slot of the 64 (each 1,024-lane tile holds them
    # all); slots running across tile edges; one slot over every tile
    g = torch.Generator(device=dev).manual_seed(3)
    lane = torch.arange(16384, device=dev, dtype=torch.int32)
    for what, L2, p, slot_of in (
            ("4 slots", 1, 0.9, None), ("4 slots", 999, 0.9, None),
            ("4 slots", 16384, 0.9, None), ("4 slots", 4096, 0.0, None),
            ("lane % 64", 16384, 0.9, lambda n: lane[:n] % W_),
            ("runs of 1,500", 16384, 0.9, lambda n: lane[:n] // 1500),
            ("one slot", 16384, 0.9, lambda n: torch.full_like(lane[:n], 3))):
        vals = torch.randint(0, 4, (S, L2), generator=g, device=dev).float()
        ids = torch.randint(0, 6, (S, L2), generator=g, device=dev)
        if slot_of is None:
            slots = torch.randint(0, 4, (S, L2), generator=g, device=dev, dtype=torch.int32)
        else:
            slots = slot_of(L2).expand(S, L2).contiguous()
        mask = torch.rand((S, L2), generator=g, device=dev) < p
        a2 = (sv, si, vals, ids, slots, mask)
        for got_t, want_t in zip(topk_window.topk_window(*a2), ref.topk_window_ref(*a2)):
            assert_equal(f"topk_window ties {what} L={L2} p={p}", got_t, want_t)
    log("topk_window: ties, duplicates, ragged and all-masked lanes, 64 slots a tile, "
        "slots across tile edges and one slot over every tile bitwise equal")
    return row


def check_segment_reduce(dev, calls: dict) -> dict:
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import segment_reduce as seg

    rows = []
    # the main path: the keyed dataplane's fold of one step, dense q5's at
    # 10,000 auctions
    for tag in ("keyed", "q5_10k"):
        for i, (args, kw) in enumerate(calls[tag]["segment_reduce"]):
            vals, segs, mask, n_seg = args
            op, init = kw["op"], kw.get("init")
            N = vals.shape[0]
            got = seg.segment_reduce(*args, **kw)
            want = ref.segment_reduce_ref(*args, **kw)
            cpu = ref.segment_reduce_ref(*(_to_cpu(a) for a in args),
                                         **{k: _to_cpu(v) for k, v in kw.items()})
            name = f"segment_reduce {tag} call {i} op={op} N={N} n_seg={n_seg}"
            if op == "sum":
                err = assert_close(name, got, want, SEG_SUM_RTOL)
            else:
                err = assert_equal(name, got, want)
            # each segment folds in lane order from init on both sides
            assert_equal(name + " (CPU plain version)", got.cpu(), cpu)
            assert_equal(name + " (second run)", seg.segment_reduce(*args, **kw), got)
            srt = seg.sort_lanes(vals, segs, mask, n_seg)
            red = {"sum": "sum", "count": "sum", "max": "amax", "min": "amin"}[op]
            segm = torch.where(mask, segs, n_seg).long()
            acc = torch.zeros(n_seg + 1, device=dev)
            row = {"shape": name, "max_abs_err": err,
                   **kernel_ms(lambda: seg.reduce_sorted(*srt, n_seg, op=op, init=init)),
                   "sort_ms": cuda_ms(lambda: seg.sort_lanes(vals, segs, mask, n_seg)),
                   "wrapper_ms": cuda_ms(lambda: seg.segment_reduce(*args, **kw)),
                   "plain_ms": cuda_ms(lambda: ref.segment_reduce_ref(*args, **kw)),
                   "library_ms": cuda_ms(lambda: acc.scatter_reduce_(
                       0, segm, vals, red, include_self=False))}
            # host µs of the path's call (sort and launch); the bare ctypes
            # launch is timed on the kept sorted stream, since the
            # wrapper's sorted temporaries do not outlive its call
            bare = wrapper_host_us(seg.KERNEL, lambda: seg.reduce_sorted(*srt, n_seg, op=op,
                                                                         init=init))
            # the sort is a dozen launches: 20 calls keep the queue short
            row.update(host_us=host_us(lambda: ops.segment_reduce(*args, **kw), iters=20),
                       sort_host_us=host_us(lambda: seg.sort_lanes(vals, segs, mask, n_seg),
                                            iters=20),
                       launch_us=bare["launch_us"], reduce_host_us=bare["host_us"])
            # bytes the reduce needs: every mask byte, the segment and value
            # of each live lane, init read and the output written; one
            # operation per live lane and per segment
            live = int(mask.sum())
            row["bound_ms"], row["bound_by"] = bound_ms(
                nbytes(mask, init) + live * 8 + nbytes(got), live + n_seg)
            rows.append(row)
            log(json.dumps(row))
    # ragged edges: empty, one huge segment, all masked, n_seg off the tile
    g = torch.Generator(device=dev).manual_seed(4)
    for N, n_seg, p, one in ((0, 1000, 0.8, False), (1 << 20, 4096, 1.0, True),
                             (100_000, 70_000, 0.0, False), (300_000, 1_000_003, 0.7, False)):
        vals = torch.rand(N, generator=g, device=dev) * 10
        segs = torch.randint(0, n_seg, (N,), generator=g, device=dev, dtype=torch.int32)
        if one:
            # a million-lane sum rounds at each add: integer values keep it
            # exact in any order, so it holds bitwise against the atomics
            segs = torch.full_like(segs, n_seg // 3)
            vals = vals.floor()
        mask = torch.rand(N, generator=g, device=dev) < p
        init = torch.rand(n_seg, generator=g, device=dev) * 10
        for op in ("sum", "count", "max", "min"):
            for it in (None, init):
                name = f"segment_reduce ragged N={N} n_seg={n_seg} p={p} op={op}"
                got = seg.segment_reduce(vals, segs, mask, n_seg, op=op, init=None if one else it)
                want = ref.segment_reduce_ref(vals, segs, mask, n_seg, op=op,
                                              init=None if one else it)
                if op == "sum" and not one:
                    assert_close(name, got, want, SEG_SUM_RTOL)
                else:
                    assert_equal(name, got, want)
                cpu = ref.segment_reduce_ref(vals.cpu(), segs.cpu(), mask.cpu(), n_seg, op=op,
                                             init=None if one else _to_cpu(it))
                assert_equal(name + " (CPU plain version)", got.cpu(), cpu)
    log("segment_reduce: empty, one huge segment, all-masked and ragged edges equal")
    return dict(max(rows, key=lambda r: r["bound_ms"]),
                max_abs_err=max(r["max_abs_err"] for r in rows))


def check_crdt_merge(dev, calls: dict, floor: dict) -> dict:
    from repro_torch.kernels import crdt_merge, ops, ref
    from repro_torch.launch.mesh import make_data_mesh

    def row_for(name, stack, op, library):
        stack = stack.contiguous()
        got = crdt_merge.crdt_merge(stack, op)
        err = assert_equal(name, got, ref.crdt_merge_ref(stack, op))
        row = {"shape": name, "max_abs_err": err,
               **kernel_ms(lambda: crdt_merge.crdt_merge(stack, op)),
               "plain_ms": cuda_ms(lambda: ref.crdt_merge_ref(stack, op)),
               "library_ms": cuda_ms(library)}
        row.update(wrapper_host_us(crdt_merge.MERGE_KERNEL, lambda: ops.crdt_merge(stack, op)))
        # bytes: the stack read once and the join written; one join per element
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes(stack, got), stack.numel())
        log(json.dumps(row))
        return row

    # the main path: the keyed watermark exchange, once a round:
    # mesh.pmax(progress, where=on), the join written to every row, gated
    # by a device bool; the parent's three launches timed beside it
    (args, kw), = calls["keyed"]["crdt_merge"]
    stack, op = args
    on = kw["where"]
    mesh = make_data_mesh(S, dev)
    R, F = stack.shape
    name = f"crdt_merge keyed exchange R={R} F={F} {stack.dtype} {op} rows, gated"
    got = ops.crdt_merge(stack, op, **kw)
    assert_equal(name, got, ref.crdt_merge_rows_ref(stack, op, on))
    for gate in (True, False):
        w = torch.tensor(gate, device=dev)
        assert_equal(f"{name} where={gate}", ops.crdt_merge(stack, op, rows=True, where=w),
                     torch.where(w, stack.amax(0).expand_as(stack), stack))

    def exchange():
        return mesh.pmax(stack, where=on)

    def parent():
        return torch.where(on, crdt_merge.crdt_merge(stack, op).unsqueeze(0)
                           .expand_as(stack).contiguous(), stack)

    assert_equal(name + " (parent's sequence)", exchange(), parent())
    row = {"shape": name, "max_abs_err": 0.0,
           **kernel_ms(lambda: ops.crdt_merge(stack, op, **kw)),
           "plain_ms": cuda_ms(lambda: ref.crdt_merge_rows_ref(stack, op, on)),
           "parent_ms": cuda_ms(parent), "library_ms": None,
           "amax_ms": cuda_ms(lambda: stack.amax(0)), "launch_floor_ms": floor["ms"],
           "device_kernels": device_kernels(exchange), "parent_device_kernels":
           device_kernels(parent), "exchange_host_us": host_us(exchange),
           "parent_host_us": host_us(parent)}
    row.update(wrapper_host_us(crdt_merge.MERGE_KERNEL,
                               lambda: ops.crdt_merge(stack, op, **kw)))
    # bytes: the stack and the gate read once, every row written; one join
    # per element
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes(stack, on, got), stack.numel())
    log(json.dumps(row))
    errs = [0.0]
    # the standalone [F] mode (the Pallas function's counterpart) on the
    # stacks the fused merge receives: the tenants and the metadata
    for tag in DENSE_MERGES:
        for i, (_, args) in enumerate(merge_inputs(calls, tag)):
            for what, x in zip(("slot_wid", "progress", "folded", "errors"),
                               (args[1], *args[6])):
                nm = f"crdt_merge {tag} call {i} {what} R={x.shape[0]} F={x.shape[1]} {x.dtype} max"
                errs.append(row_for(nm, x, "max", lambda: x.amax(0))["max_abs_err"])
    # one shard's keyed state (16 slots x 62,500 keys, 4 MB) as a replicated
    # join would see it
    g = torch.Generator(device=dev).manual_seed(5)
    big = torch.rand((S, 1 << 20), generator=g, device=dev)
    row_for(f"crdt_merge R={S} F={1 << 20} float32 max", big, "max", lambda: big.amax(0))
    # every dtype and join, R = 1, F off the block, both modes
    for R, F in ((1, 1000), (S, 257), (3, 100_000)):
        for dtype, op in ((torch.float32, "min"), (torch.int32, "max"), (torch.int32, "min"),
                          (torch.uint8, "or"), (torch.uint8, "max"), (torch.bool, "or")):
            x = torch.randint(-1000, 1000, (R, F), generator=g, device=dev)
            x = x.remainder(256).to(dtype) if dtype in (torch.uint8, torch.bool) else x.to(dtype)
            want = x.any(0) if dtype == torch.bool else ref.crdt_merge_ref(x, op)
            assert_equal(f"crdt_merge R={R} F={F} {dtype} {op}", ops.crdt_merge(x, op), want)
            for gate in (None, True, False):
                w = None if gate is None else torch.tensor(gate, device=dev)
                rows_want = want.expand_as(x) if gate in (None, True) else x
                assert_equal(f"crdt_merge rows R={R} F={F} {dtype} {op} where={gate}",
                             ops.crdt_merge(x, op, rows=True, where=w), rows_want)
    log("crdt_merge: every dtype and join bitwise equal in both modes, R = 1, ragged F and "
        "both gates included")
    return dict(row, max_abs_err=max(errs))


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
    from repro_torch.launch.stream import build_pipeline
    from repro_torch.obs.timing import WallTimer

    pipe = build_pipeline(q, mesh, SYNC_EVERY, delta_sync=delta, n_windows=n, first_window=first)
    pipe(log_.map(lambda x: x[:, :SYNC_EVERY]))  # warm-up: one sync round
    reset_launches()
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
        used = {"topk_window"} if qn == "q7" else {"window_agg"}
        if delta and qn in ("q1_ratio", "q4", "q5"):
            used |= {"delta_merge_join"}
        counts = check_launches(qn, used)
        if counts["delta_merge_join"] not in (0, n_rounds * len(q.shared_specs)):
            raise AssertionError(f"{qn}: {counts['delta_merge_join']} fused merges, expected "
                                 f"one a spec a round")
        for k, c in counts.items():
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


def profile_run(name: str, fn) -> dict:
    """Device busy share of one run of ``fn`` (after a warm one), from a
    ``torch.profiler`` trace: the sum of device-side event times (kernels,
    copies, fills; one stream, so they do not overlap) over the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    rows = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in rows)
    aten = [e for e in prof.events() if e.name.startswith("aten::") and e.cpu_parent is None]
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:6]
    # the torch ops whose own kernels take the device time, by name
    by_op = sorted((e for e in events if e.device_type == DeviceType.CPU
                    and e.self_device_time_total > 0), key=lambda e: -e.self_device_time_total)
    row = {"profile": name, "batches": 64, "wall_us": wall_us, "device_busy_us": busy,
           "device_idle_share": 1 - busy / wall_us if busy else None,
           "device_events_per_batch": sum(e.count for e in rows) / 64,
           "aten_ops_per_batch": len(aten) / 64,
           "top_kernels_us": [[e.key[:90], e.self_device_time_total] for e in top],
           "top_ops_device_us": [[e.key, e.self_device_time_total, e.count] for e in by_op[:10]]}
    log(json.dumps(row))
    return row


def profile_share(dev) -> None:
    """Device busy share of q4 and q7 over 64 batches."""
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.launch.stream import MAKERS, build_pipeline
    from repro_torch.streaming.generator import NexmarkConfig, generate_log

    nx = NexmarkConfig(num_partitions=S, num_batches=64, events_per_batch=B,
                       rate_per_partition=RATE, seed=SEED)
    part = generate_log(nx, dev)
    for qn in ("q4", "q7"):
        q = MAKERS[qn](S, window_len=WINDOW_MS, num_slots=NUM_SLOTS)
        pipe = build_pipeline(q, make_data_mesh(S, dev), SYNC_EVERY, n_windows=1)
        profile_run(qn, lambda: pipe(part))


def reset_launches() -> None:
    from repro_torch.kernels import ops

    for kern in ops.KERNELS.values():
        kern.launches = 0


def check_launches(run: str, used: set) -> dict:
    """Each kernel's launches since the last reset; raises unless exactly
    the kernels in ``used`` were launched."""
    from repro_torch.kernels import ops

    counts = {k: kern.launches for k, kern in ops.KERNELS.items()}
    for k, c in counts.items():
        if (k in used) != (c > 0):
            raise AssertionError(f"{run}: kernel {k} launched {c} times")
    return counts


def host_shuffle_bytes(shards, log_, nb: int) -> np.ndarray:
    """The keyed run's shuffle bytes, counted apart from the dataplane: per
    source partition and batch, its bids owned by another partition, from
    the auction ids; then 8 bytes each, added up batch by batch in f32 on
    the host, as the dataplane's f32 counter adds them."""
    from repro_torch.streaming.events import KIND_BID

    p = torch.arange(S, device=log_.ts.device)[:, None, None]
    sent = []
    for b0 in range(0, nb, 128):
        sl = slice(b0, min(b0 + 128, nb))
        owner = (log_.auction[:, sl] * shards.mult % shards.num_keys) % S
        bid = log_.valid[:, sl] & (log_.kind[:, sl] == KIND_BID)
        sent.append((bid & (owner != p)).sum(-1))
    sent = torch.cat(sent, 1).cpu().numpy()  # [S, nb]
    acc = np.zeros(S, np.float32)
    for t in range(nb):
        acc = acc + sent[:, t].astype(np.float32) * np.float32(8.0)
    return acc


def run_keyed(dev) -> tuple[list, dict]:
    """Phase 4, keyed: the hash-sharded dataplane at full size, its chaos
    schedules, and dense q5 at 10,000 auctions; returns the result rows and
    each kernel's launches."""
    from repro_torch.core.wcrdt import KeyShards
    from repro_torch.core.window import as_assigner
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.launch.stream import (
        MAKERS, build_keyed_pipeline, default_fold_schedule, read_window_range,
    )
    from repro_torch.obs.timing import WallTimer
    from repro_torch.streaming.generator import NexmarkConfig, generate_log
    from repro_torch.streaming.queries import q5_hot_oracle

    nx = NexmarkConfig(num_partitions=S, num_batches=NUM_BATCHES, events_per_batch=B,
                       rate_per_partition=RATE, seed=SEED, num_auctions=NUM_KEYS,
                       key_skew=KEY_SKEW)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    klog = generate_log(nx, dev)
    torch.cuda.synchronize()
    log(f"keyed log: {S * NUM_BATCHES * B} events over {NUM_KEYS} zipf({KEY_SKEW}) ids, "
        f"{sum(nbytes(getattr(klog, f.name)) for f in dataclasses.fields(klog)) / 1e9:.2f} GB, "
        f"made in {time.perf_counter() - t0:.2f} s; "
        f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    mesh = make_data_mesh(S, dev)
    shards = KeyShards(NUM_KEYS, S)
    table = shards.key_table(dev)
    assigner = as_assigner(WINDOW_MS, WINDOW_MS // 2)
    launches, results = {}, []

    def pipeline(nb: int, **kw):
        n = int(assigner.first_dirty_wid(nb * nx.batch_span_ms)) + 1  # + the open window
        return build_keyed_pipeline(mesh, shards, window_len=WINDOW_MS, num_slots=KEYED_SLOTS,
                                    sync_every=SYNC_EVERY, n_windows=n, first_window=0, **kw)

    def add(counts):
        for k, c in counts.items():
            launches[k] = launches.get(k, 0) + c

    # (a) the full-size run, twice
    sched = default_fold_schedule(S, NUM_BATCHES)
    rounds = NUM_BATCHES // SYNC_EVERY
    wm = torch.ones(rounds, dtype=torch.bool)
    pipe = pipeline(NUM_BATCHES)
    pipe.fold(klog, sched[:, :SYNC_EVERY], wm[:1])  # warm-up: one sync round
    runs = []
    for _ in range(2):
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        with WallTimer(dev) as tm:
            state, shuffle, sync, _ = pipe.fold(klog, sched, wm)
            oks, vals = pipe.read(state, table)
        counts = check_launches("keyed", {"segment_reduce", "crdt_merge"})
        add(counts)
        runs.append((state, oks, vals, shuffle, sync))
        row = {"query": "q5_keyed", "sync": "watermark", "events": S * NUM_BATCHES * B,
               "seconds": tm.dt, "events_per_s": S * NUM_BATCHES * B / tm.dt,
               "shuffle_bytes_per_step": shuffle.mean().item() / NUM_BATCHES,
               "sync_bytes_per_round": sync.mean().item() / rounds,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": counts}
        results.append(row)
    if counts["segment_reduce"] != NUM_BATCHES or counts["crdt_merge"] != rounds:
        raise AssertionError(f"keyed: launches {counts}, expected one fold a step, one join a round")
    if not bool((oks == oks[:1]).all()):
        raise AssertionError("keyed: shards disagree on which windows are complete")
    done = 0
    for j in range(oks.shape[1]):
        if bool(oks[0, j]):
            done += 1
            want = q5_hot_oracle(klog, j, assigner, NUM_KEYS).reshape(1, 2).expand(S, -1)
            assert_equal(f"keyed window {j} (q5_hot_oracle)", vals[:, j], want)
    if done < 7:
        raise AssertionError(f"keyed: {done} complete windows, expected 7")
    want_shuffle = host_shuffle_bytes(shards, klog, NUM_BATCHES)
    if not np.array_equal(shuffle.cpu().numpy(), want_shuffle):
        raise AssertionError(f"keyed shuffle bytes {shuffle.tolist()} != host {want_shuffle}")
    if not bool((sync == rounds * S * 4.0).all()):
        raise AssertionError(f"keyed sync bytes {sync.tolist()} != {rounds} rounds x {S * 4}")
    (s1, *o1), (s2, *o2) = runs
    same_state(s1, s2, "keyed: a second run")
    for a, b_ in zip(o1, o2):
        if not torch.equal(a, b_):
            raise AssertionError("keyed: a second run's outputs differ")
    for row in results:
        row["complete_windows"] = done
        log(json.dumps(row))
    log(f"keyed: {done} complete windows equal q5_hot_oracle on all {S} shards; shuffle bytes "
        f"equal the host count; a second run is byte identical")
    del runs, s1, s2, state

    # (b) chaos at SHORT_BATCHES on the same log
    nb = SHORT_BATCHES
    base = default_fold_schedule(S, nb)
    short = pipeline(nb)
    clean = short.fold(klog, base, torch.ones(nb // SYNC_EVERY, dtype=torch.bool))
    clean_out = short.read(clean[0], table)
    if clean_out[0].sum() < S:
        raise AssertionError("chaos: the clean run has no complete window")
    k = CRASH_AFTER + 1
    crash = torch.cat([torch.arange(k), torch.arange(REPLAY_FROM, k), torch.arange(k, nb)])
    crash = crash.to(torch.int32).expand(S, -1).contiguous()
    cut = torch.ones(nb // SYNC_EVERY, dtype=torch.bool)
    cut[PARTITIONED[0]:PARTITIONED[1]] = False
    for name, sch, plane in (("crash-replay", crash,
                              torch.ones(crash.shape[1] // SYNC_EVERY, dtype=torch.bool)),
                             ("partition healed", base, cut)):
        st, *_ = short.fold(klog, sch, plane)
        same_state(st, clean[0], f"chaos {name}")
        for a, b_ in zip(short.read(st, table), clean_out):
            if not torch.equal(a, b_):
                raise AssertionError(f"chaos {name}: outputs differ from the clean run")
    st, *_ = short.fold(klog, base, torch.zeros(nb // SYNC_EVERY, dtype=torch.bool))
    if short.read(st, table)[0].sum() != 0:
        raise AssertionError("chaos: a plane never healed emitted a window")
    log(f"chaos ({nb} batches): crash-replay and a healed partition end byte identical to the "
        f"clean run ({int(clean_out[0][0].sum())} complete windows); a plane never healed "
        "emits none")

    # profile: 64 batches of the keyed run
    prof_pipe = pipeline(64)
    prof = profile_run("q5_keyed", lambda: prof_pipe.fold(
        klog, base[:, :64], torch.ones(64 // SYNC_EVERY, dtype=torch.bool)))
    del klog

    # (c) dense q5 at 10,000 auctions, zipf ids: its fold takes the segment reduce
    qx = dataclasses.replace(nx, num_batches=SHORT_BATCHES, num_auctions=DENSE_Q5_KEYS,
                             seed=SEED + 2)
    qlog = generate_log(qx, dev)
    q = MAKERS["q5"](S, window_len=WINDOW_MS, num_slots=NUM_SLOTS, num_auctions=DENSE_Q5_KEYS)
    first, n = read_window_range(q, SHORT_BATCHES * qx.batch_span_ms)
    (oks, vals, sb), dt, peak = run_pipeline(q, mesh, qlog, True, first, n)
    counts = check_launches("q5_10k", {"segment_reduce", "delta_merge_join"})
    add(counts)
    done = check_against_oracle(q, qlog, oks, vals, first)
    if done < 1:
        raise AssertionError("q5_10k: no complete window")
    n_ev = S * SHORT_BATCHES * B
    row = {"query": "q5_10k", "sync": "delta", "events": n_ev, "seconds": dt,
           "events_per_s": n_ev / dt, "complete_windows": done,
           "sync_bytes_per_round": sb.mean().item() / (SHORT_BATCHES // SYNC_EVERY),
           "peak_gb": peak / 1e9, "launches": counts}
    results.append(row)
    log(json.dumps(row))
    return results, launches, prof


def same_state(a, b, what: str) -> None:
    from repro_torch.convert import wstate_to_numpy

    other = wstate_to_numpy(b)
    for k, x in wstate_to_numpy(a).items():
        if not np.array_equal(x, other[k]):
            raise AssertionError(f"{what}: state field {k} differs")


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
    chain = start_chain_build()
    try:
        report = build.build(ops.SOURCES)
    except BaseException:
        chain[0].kill()  # leave no compiler running
        chain[0].wait()
        raise
    for kname, r in sorted(report.items()):
        usage = [ln.strip() for ln in r["log"].splitlines() if "registers" in ln or "spill" in ln]
        log(f"built {kname}.cu in {r['seconds']:.2f} s: " + " | ".join(usage))
    load_chain(chain)
    log(f"build wall time {time.perf_counter() - t0:.2f} s ({len(report)} sources and the "
        "chain probe)")

    log(f"== phase 3: kernels against their plain versions {card}")
    per_add, hz = chain_clock()
    log(f"f32 add chain: {per_add:.4f} SM cycles per dependent add at {hz / 1e9:.4f} GHz "
        f"(one thread, 2^22 adds) {card}")
    floor = launch_floor()
    check_generator(dev)
    calls = main_path_calls(dev)
    kernel_rows = {
        "window_agg": check_window_agg(dev, calls),
        "delta_merge_join": check_delta_merge_join(dev, calls, floor),
        "topk_window": check_topk_window(dev, calls["q7"]),
        "segment_reduce": check_segment_reduce(dev, calls),
        "crdt_merge": check_crdt_merge(dev, calls, floor),
    }
    # the Pallas function's counterpart, off the main path since the fused
    # merge took its place: checked and timed, reported with the fused row
    standalone = check_gated_delta_merge(dev, calls)
    del calls
    log(f"phase 3 done at {time.perf_counter() - t_start:.1f} s")

    log(f"== phase 4: dataplane, S={S} partitions x {RATE:.0f} ev/s, B={B}, "
        f"window {WINDOW_MS} ms, {NUM_BATCHES} batches")
    results, launches = run_dataplane(dev)
    profile_share(dev)
    log(f"dense runs done at {time.perf_counter() - t_start:.1f} s")
    keyed_results, keyed_launches, _ = run_keyed(dev)
    results += keyed_results
    for k, c in keyed_launches.items():
        launches[k] += c

    log(f"== phase 5: throughput {card}")
    for r in results:
        log(f"{r['query']:9s} sync={r['sync']:5s} {r['events_per_s']:.6e} events/s "
            f"sync_bytes_per_round={r['sync_bytes_per_round']:.1f} {card}")

    src = {"window_agg": "window_agg.py:90", "delta_merge_join": "crdt_merge.py:96",
           "topk_window": "topk_window.py:46", "segment_reduce": "segment_reduce.py:76",
           "crdt_merge": "crdt_merge.py:35"}
    kernel_rows["delta_merge_join"]["standalone_gated_delta_merge"] = {
        k_: standalone[k_] for k_ in ("shape", "ms", "plain_ms", "bound_ms", "host_us",
                                      "launch_us")}
    kernels = []
    for k, row in kernel_rows.items():
        kernels.append({
            "name": k, "route": "cuda",
            "source": f"src/repro_torch/csrc/{ops.KERNELS[k].source}.cu",
            "replaces": f"src/repro/kernels/{src[k]}", "launches": launches[k],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "host_us": row["host_us"],
            "launch_us": row["launch_us"], "shape": row["shape"],
            **{k_: row[k_] for k_ in ("ms_batches", "chain_floor_ms", "sort_ms", "wrapper_ms",
                                      "parent_ms", "parent_host_us", "launch_floor_ms",
                                      "device_kernels", "parent_device_kernels",
                                      "standalone_gated_delta_merge")
               if k_ in row},
        })
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

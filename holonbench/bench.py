"""One run of one cell, in one rank: set-up, the timed window, the check
against the plain reference, and (on rank 0) the result.

Set-up (``setup_s``, from the process's start to the first timed pass)
loads the program's kernels, draws the cell's log on the device from the
seed with the benchmark's own generator, builds the dataplane and warms it
up on a short slice of the log.  The window runs passes back to back, each
one whole run of the dataplane's entry point over the whole log, until
``seconds`` have gone by, and counts whole passes only; with ``trace`` it
runs one whole pass under ``torch.profiler`` instead.  Then, with the
window closed and the memory peak read, the reference works the answers out
from the same log: every pass's outputs are compared with them, and so is
the last pass's state, every key's count in every window read; then the
metrics are read by their readers (``holonbench/metrics/<name>.py``).

A run across cards is one rank a process (``run.py`` starts them); the
harness's own collectives (which pass is the last, the reference's counts,
the ranks' figures) go through ``torch.distributed`` directly.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import math
import sys
import time

import torch

from holonbench.cell import Cell
from holonbench.devtrace import WINDOW, read_trace
from holonbench.nexmark.generator import LogSpec, generate

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole


@dataclasses.dataclass
class Options:
    seed: int
    seconds: float
    trace: bool = False
    t_start: float = dataclasses.field(default_factory=time.perf_counter)
    rank: int = 0
    world: int = 1
    init_method: str | None = None  # the process group's address, across ranks
    backend: str = "nccl"
    device: str = "cuda"  # "cpu" in the harness's own tests, with the kernels' plain versions
    scale: dict | None = None  # the harness's own tests: configuration keys replaced


@dataclasses.dataclass
class Readings:
    """What a metric's reader reads (``read(r) -> float | None``)."""

    setup_s: float
    window_s: float
    passes: int
    pass_s: float  # an untraced pass's seconds (in a traced run, the pass before the traced ones)
    events: int  # events folded in the window
    steps: int  # fold steps in the window
    trace: object = None  # devtrace.DeviceTrace of the traced window
    mesh: dict | None = None  # DistMesh.stats of the window, by kind
    records: dict = dataclasses.field(default_factory=dict)  # a reader's recorder's, by metric


def log_spec(cfg: dict, traffic: dict, seed: int) -> LogSpec:
    return LogSpec(num_partitions=cfg["num_partitions"], num_batches=cfg["num_batches"],
                   events_per_batch=cfg["events_per_batch"],
                   rate_per_partition=cfg["rate_per_partition"], seed=seed,
                   skew=traffic.get("partition_skew", 0.0), num_auctions=cfg["num_keys"],
                   key_skew=cfg["key_skew"])


def folded_batches(cfg: dict) -> int:
    """Batches a pass folds: whole sync rounds."""
    return cfg["num_batches"] // cfg["sync_every"] * cfg["sync_every"]


def window_range(cfg: dict) -> tuple[int, int]:
    """``(first, n)``: the windows a pass reads, the last ones that close
    within the folded batches plus the one still open, as many as the ring
    holds at once."""
    horizon = folded_batches(cfg) * 1000.0 * cfg["events_per_batch"] / cfg["rate_per_partition"]
    wl, hop = cfg["window_len_ms"], cfg["hop_ms"]
    closed = max(math.floor((horizon - wl) / hop) + 1, 0)
    n = max(1, min(closed + 1, cfg["num_slots"] - (wl // hop - 1)))
    return max(0, closed + 1 - n), n


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _max_over_ranks(x: float, world: int, dev) -> float:
    if world == 1:
        return x
    import torch.distributed as dist

    t = torch.tensor([x], dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def timed_window(plane, seconds: float, dev, world: int) -> tuple[list, list]:
    """Passes back to back until ``seconds`` have gone by on every rank:
    ``(outputs of each pass, seconds from the start to the end of each)``,
    the time the slowest rank's, ending in a device synchronise."""
    outs, ends = [], []
    t0 = time.perf_counter()
    while True:
        outs.append(plane.run_pass())
        _sync(dev)
        ends.append(_max_over_ranks(time.perf_counter() - t0, world, dev))
        if ends[-1] >= seconds:
            return outs, ends


def traced_window(plane, recorders: dict, dev, stats) -> tuple:
    """One whole pass untraced, for a pass's wall time as the window runs it,
    then two under ``torch.profiler``.  The first traced pass records the
    device's activity alone, with the metrics' recorders on: its trace gives
    the per-layer metrics.  The second also records the host's torch ops,
    which slows the host about twofold: its trace only says what the host
    was doing while the card idled.  Returns
    ``(outputs, seconds of the first traced pass, of the untraced one, the
    first's DeviceTrace, the second's, records, the mesh's stats after the
    first)``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = dev.type == "cuda"
    t0 = time.perf_counter()
    outs = [plane.run_pass()]
    _sync(dev)
    untraced = time.perf_counter() - t0
    if stats is not None:
        stats.reset()
    with contextlib.ExitStack() as stack:
        records = {name: stack.enter_context(rec()) for name, rec in recorders.items()}
        with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
            t0 = time.perf_counter()
            outs.append(plane.run_pass())
            _sync(dev)
            dt = time.perf_counter() - t0
    trace, counted = read_trace(prof, dt), _stats(stats)
    host = None
    if cuda:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                t0 = time.perf_counter()
                outs.append(plane.run_pass())
                _sync(dev)
        host = read_trace(prof, time.perf_counter() - t0)
    return outs, dt, untraced, trace, host, records, counted


def _stats(stats) -> dict | None:
    """``DistMesh.stats`` by kind, as plain numbers (``None`` on a ``StackMesh``)."""
    if stats is None:
        return None
    return {k: dataclasses.asdict(getattr(stats, k)) for k in ("gather", "exchange")}


def reference(cell: Cell, cfg: dict, fields: dict, world: int, dtype=torch.int64):
    """The plain reference's answers for the windows a pass reads, from this
    rank's rows of the log and the other ranks' counts: ``(ok bool[n], vals
    f32[n, w], counts [n, num_keys])`` on every rank, ``counts`` every key's
    count in each window."""
    first, n = window_range(cfg)
    ref = cell.module("references", cell.traffic["query"])
    kw = dict(first=first, window_len=cfg["window_len_ms"], hop=cfg["hop_ms"])
    counts, wm = ref.partial(fields, batch_span_ms=1000.0 * cfg["events_per_batch"]
                             / cfg["rate_per_partition"], folded=folded_batches(cfg), n=n,
                             num_keys=cfg["num_keys"], dtype=dtype, **kw)
    if world > 1:
        import torch.distributed as dist

        dist.all_reduce(counts, op=dist.ReduceOp.SUM)
        w = torch.tensor([wm], dtype=torch.int64, device=counts.device)
        dist.all_reduce(w, op=dist.ReduceOp.MIN)
        wm = int(w.item())
    return (*ref.finish(counts, wm, **kw), counts)


def check_state(view: tuple, copies: int, ok: torch.Tensor, counts: torch.Tensor,
                dist=None) -> dict:
    """The last pass's state against the reference's counts, summed over the
    ranks (a collective where ``dist`` is given, so every rank calls it).
    ``view`` is a plane's ``window_counts()``: ``(keys [R, K'], got [R, n,
    K'])``, each of this process's state rows' count of each key it holds
    (``keys >= num_keys`` marks padding).  Counts: ``wrong_key_counts``, the
    (row, complete window, key) counts that differ from the reference's,
    padding's counts other than 0 among them; ``keys_not_held_as_stated``,
    the keys held by another number of rows than ``copies`` (every replica,
    or one owner shard); and the state's (row, complete window) pairs, and
    those with a wrong count, and the keys."""
    keys, got = (x.to(counts.device) for x in view)
    n, K = counts.shape
    real = keys < K
    want = counts[:, keys.clamp(max=K - 1)].permute(1, 0, 2)  # [R, n, K']
    want = torch.where(real[:, None, :], want, torch.zeros_like(want))
    bad = (got.to(torch.float64) != want.to(torch.float64)) & ok[None, :, None].to(got.device)
    held = torch.zeros(K, dtype=torch.int64, device=counts.device)
    held.index_add_(0, keys[real], torch.ones_like(keys[real]))
    tally = torch.tensor([int(bad.sum()), int(bad.any(-1).sum()), keys.shape[0] * int(ok.sum())],
                         dtype=torch.int64, device=counts.device)
    if dist is not None:
        dist.all_reduce(held)
        dist.all_reduce(tally)
    wrong, windows_wrong, windows = tally.tolist()
    return {"wrong_key_counts": wrong, "keys_not_held_as_stated": int((held != copies).sum()),
            "state_windows": windows, "state_windows_wrong": windows_wrong, "keys": K}


def compare(outs: list, ok: torch.Tensor, vals: torch.Tensor,
            state: dict) -> tuple[dict, int, int]:
    """Every pass's ``(oks [S, n], vals [S, n, w], ...)`` and the last
    pass's state (``check_state``'s counts) against the reference:
    ``(checks, attempted, failed)``.  ``checks`` holds each number compared
    beside its limit: window reads whose completeness differs from the
    reference's (a window dropped or read early), complete windows whose
    value differs, passes not bitwise equal to the first, every key's count
    in the state's complete windows that differs, and keys not held as the
    deployment states.  ``attempted`` counts the window reads, the state's
    (row, complete window) pairs and the keys placed, ``failed`` those
    found wrong."""
    if not bool(ok.any()):
        raise RuntimeError("the reference has no complete window: the traffic checks nothing")
    missing = wrong = 0
    for out in outs:
        got_ok = out[0] > 0
        got_vals = out[1]
        want_ok = ok.to(got_ok.device).expand_as(got_ok)
        missing += int((got_ok != want_ok).sum())
        want = vals.to(got_vals.device).expand_as(got_vals)
        bad = (got_vals != want).any(-1) & got_ok & want_ok
        wrong += int(bad.sum())
    differ = sum(any(not torch.equal(a, b) for a, b in zip(out, outs[0])) for out in outs[1:])
    checks = {"early_or_missing_windows": {"value": missing, "limit": 0},
              "wrong_window_values": {"value": wrong, "limit": 0},
              "passes_not_bitwise_equal": {"value": differ, "limit": 0},
              "wrong_key_counts": {"value": state["wrong_key_counts"], "limit": 0},
              "keys_not_held_as_stated": {"value": state["keys_not_held_as_stated"],
                                          "limit": 0}}
    attempted = sum(int(out[0].numel()) for out in outs) + state["state_windows"] \
        + state["keys"]
    failed = missing + wrong + state["state_windows_wrong"] + state["keys_not_held_as_stated"]
    return checks, attempted, failed


def control_outputs(cell: Cell, cfg: dict, fields: dict, world: int, rank: int) -> tuple:
    """The control: the reference computed with bf16 counters, put in the
    program's place: ``(outputs of one pass of S rows, its state as a
    window_counts() view, copies)``, the state one row of every key, held
    by rank 0."""
    ok, vals, counts = reference(cell, cfg, fields, world, dtype=torch.bfloat16)
    S, K = cfg["num_partitions"], counts.shape[1]
    keys = torch.arange(K if rank == 0 else 0, device=counts.device)
    view = (keys[None], counts.to(torch.float32)[:, :keys.numel()][None])
    return (ok.to(torch.float32).expand(S, -1), vals.expand(S, -1, -1)), view, 1


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one the run must not load."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _mean(values: list):
    vals = [v for v in values if v is not None]
    return sum(vals) / len(vals) if vals else None


@contextlib.contextmanager
def process_group(opt: Options):
    """The ranks' process group for the body, or ``None`` on one rank."""
    if opt.world == 1:
        yield None
        return
    import torch.distributed as dist

    dist.init_process_group(opt.backend, init_method=opt.init_method, rank=opt.rank,
                            world_size=opt.world, timeout=datetime.timedelta(seconds=240))
    try:
        yield dist
    finally:
        dist.destroy_process_group()


def make_mesh(cfg: dict, opt: Options, dist):
    """Load the program's kernels (on the card) and make this rank's mesh."""
    from repro_torch.launch.mesh import make_data_mesh, make_dist_mesh

    if opt.device == "cuda":
        from repro_torch.kernels import build, ops

        build.build(ops.SOURCES)  # served from build/repro_torch/ once built
    if dist is not None:
        return make_dist_mesh(cfg["num_partitions"], opt.device, opt.backend)
    return make_data_mesh(cfg["num_partitions"],
                          torch.device(opt.device, 0) if opt.device == "cuda" else opt.device)


def make_plane(cell: Cell, cfg: dict, mesh, seed: int, mark=lambda phase: None) -> tuple:
    """This rank's rows of the log drawn from ``seed``, and the dataplane
    built on them and warmed up: ``(fields, plane)``.  ``mark(phase)`` is
    called as each phase ends: ``log``, ``build``, ``warmup``."""
    from repro_torch.streaming.events import EventBatch

    fields = generate(log_spec(cfg, cell.traffic, seed), mesh.device, mesh.partitions)
    _sync(mesh.device)
    mark("log")
    plane = cell.module("dataplanes", cfg["dataplane"]).Plane(
        cfg, cell.traffic, mesh, EventBatch(**fields), *window_range(cfg))
    _sync(mesh.device)
    mark("build")
    plane.warmup()
    _sync(mesh.device)
    mark("warmup")
    return fields, plane


def run(cell: Cell, opt: Options) -> dict | None:
    """One rank's run; the result on rank 0, ``None`` on the others."""
    with process_group(opt) as dist:
        return _run(cell, opt, dist)


def _run(cell: Cell, opt: Options, dist) -> dict | None:
    cfg = {**cell.config, **(opt.scale or {})}
    S = cfg["num_partitions"]
    cuda = opt.device == "cuda"
    phases, last = {}, [opt.t_start]

    def mark(phase: str) -> None:  # set-up's phases, seconds each, for standard error
        now = time.perf_counter()
        phases[phase], last[0] = now - last[0], now

    mark("start")  # the interpreter, the imports, the process group
    mesh = make_mesh(cfg, opt, dist)
    dev = mesh.device
    _sync(dev)
    mark("kernels")
    fields, plane = make_plane(cell, cfg, mesh, opt.seed, mark)
    if dist is not None:
        dist.barrier()
    mark("ranks")
    setup_s = time.perf_counter() - opt.t_start
    stats = getattr(mesh, "stats", None)
    if stats is not None:
        stats.reset()

    readers = {m["name"]: cell.module("metrics", m["name"])
               for m in (cell.per_layer if opt.trace else cell.end_to_end)}
    if opt.trace:
        recorders = {k: r.recorder for k, r in readers.items() if hasattr(r, "recorder")}
        outs, window_s, pass_s, trace, host, records, counted = traced_window(
            plane, recorders, dev, stats)
        passes = 1
    else:
        outs, ends = timed_window(plane, opt.seconds, dev, opt.world)
        trace, host, records, counted, passes = None, None, {}, _stats(stats), len(outs)
        window_s, pass_s = ends[-1], ends[-1] / passes
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    r = Readings(setup_s=setup_s, window_s=window_s, passes=passes, pass_s=pass_s,
                 events=passes * S * folded_batches(cfg) * cfg["events_per_batch"],
                 steps=passes * plane.steps, trace=trace, records=records, mesh=counted)
    view, copies = plane.window_counts(), plane.copies
    del plane  # the program's state: the reference runs after it

    ok, vals, counts = reference(cell, cfg, fields, opt.world)
    state = check_state(view, copies, ok, counts, dist)
    del view, counts
    values = {k: rd.read(r) for k, rd in readers.items()}
    mine = {"values": values, "peak": peak,
            "busy_s": trace.busy_s if trace is not None and trace.device_events else None,
            "window_s": trace.window_s if trace is not None else None}
    ranks = [mine]
    if dist is not None:
        ranks = [None] * opt.world
        dist.all_gather_object(ranks, mine)
    if opt.rank != 0:
        return None

    checks, attempted, failed = compare(outs, ok, vals, state)
    units = {m["name"]: m["unit"] for m in (cell.per_layer if opt.trace else cell.end_to_end)}
    metrics = {}
    for k in readers:  # per-layer: the mean of the ranks; end to end: rank 0's
        v = _mean([x["values"][k] for x in ranks]) if opt.trace else ranks[0]["values"][k]
        if v is not None:
            metrics[k] = {"value": v, "unit": units[k]}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": opt.world, "memory_peak_bytes": max(x["peak"] for x in ranks)}
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": attempted, "failed": failed, "metrics": metrics, "device": device}
    if opt.trace:
        busy = _mean([x["busy_s"] for x in ranks])
        if busy is not None:
            device["busy_s"] = busy
            device["window_s"] = _mean([x["window_s"] for x in ranks])
            result["breakdown"] = {"device_ops": trace.device_ops(10),
                                   "idle_gaps": host.idle_gaps(10) if host else []}
    else:
        result["pass_seconds"] = [b - a for a, b in zip([0.0, *ends], ends)]
    result["setup_phases_s"] = phases
    result["checks"] = checks
    return result

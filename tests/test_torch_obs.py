"""The port's observability base: records, registry, telemetry, timers.

Mirrors the cases of ``tests/test_obs.py`` outside the auditor's (which
``tests/test_torch_obs_analysis.py`` mirrors): the trace ring and its
dropped count, the registry, both exporters' formats, the two clock
domains, telemetry off recording nothing, and same-seed runs of both
runtimes exporting byte-identical traces with telemetry changing nothing in
the run.  The port's exporters give the JAX package's bytes for the same
records, and ``SimConfig.obs_monitor`` attaches the online monitor to
either runtime without changing its trace.

Also here: nothing under ``src/repro_torch`` imports JAX or the JAX
package, checked in a fresh interpreter that imports every module of the
port.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.obs import records as jrec
from repro.obs import registry as jreg
import repro_torch.runtime as R
from repro_torch.obs.monitor import OnlineMonitor
from repro_torch.obs.records import TraceBuffer, TraceEvent, mkargs, to_chrome, to_jsonl
from repro_torch.obs.registry import MetricsRegistry, summary
from repro_torch.obs.telemetry import Telemetry
from repro_torch.obs.timing import SimTimer, WallTimer
from repro_torch.runtime import FailureScenario, Scenario, SimConfig
from repro_torch.runtime.sim import Sim
from repro_torch.streaming.queries import make_q7

CFG = SimConfig(num_nodes=3, num_partitions=4, num_batches=60, window_len=500,
                sync_interval_ms=50.0, ckpt_interval_ms=300.0, obs=True)
HORIZON = CFG.horizon_ms + 10_000.0
HARNESSES = {"holon": functools.partial(R.HolonHarness, device="cpu"),
             "flink": functools.partial(R.FlinkHarness, device="cpu")}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The runtime folds tensors of a few KB, op by op: one intra-op thread
    a process, or the workers of a parallel test run spin against each
    other on the CPU's cores (an order of magnitude slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(cfg=CFG, scenario=None, harness="holon", horizon=HORIZON):
    h = HARNESSES[harness](cfg, make_q7(cfg.num_partitions, window_len=cfg.window_len,
                                        num_slots=cfg.num_slots))
    h.run(scenario, horizon_ms=horizon)
    return h


# ---------------------------------------------------------------------------
# records, ring, registry, timers, exporters
# ---------------------------------------------------------------------------


def test_ring_bounds_and_dropped():
    buf = TraceBuffer(cap=8)
    for i in range(20):
        buf.append(TraceEvent(t_ms=float(i), kind="x"))
    assert len(buf.events()) == 8 and buf.total == 20 and buf.dropped == 12
    assert [e.t_ms for e in buf.events()] == [float(i) for i in range(12, 20)]


def test_mkargs_sorted_and_event_equality():
    assert mkargs(b=1, a=2) == (("a", 2), ("b", 1))
    e1 = TraceEvent(t_ms=1.0, kind="k", args=mkargs(x=1))
    e2 = TraceEvent(t_ms=1.0, kind="k", args=mkargs(x=1))
    assert e1 == e2 and e1.arg("x") == 1 and e1.arg("missing", 9) == 9


def test_jsonl_header_and_order():
    buf = TraceBuffer(cap=4)
    buf.append(TraceEvent(t_ms=2.0, kind="b"))
    buf.append(TraceEvent(t_ms=1.0, kind="a"))
    out = to_jsonl(buf.events(), dropped=buf.dropped).splitlines()
    head = json.loads(out[0])
    assert head["meta"] == "holon-trace-v1" and head["dropped"] == 0
    assert json.loads(out[1])["kind"] == "b"
    assert list(json.loads(out[2])) == sorted(json.loads(out[2]))


def test_chrome_span_vs_instant():
    evs = [TraceEvent(t_ms=1.0, kind="exec.batch", node=0, partition=2, t_end_ms=3.0),
           TraceEvent(t_ms=4.0, kind="node.crash", node=1)]
    doc = to_chrome(evs)
    by_ph = {e["ph"]: e for e in doc["traceEvents"] if e["ph"] in "Xi"}
    assert by_ph["X"]["dur"] == pytest.approx(2000.0) and by_ph["X"]["ts"] == pytest.approx(1000.0)
    assert by_ph["i"]["pid"] == 1 and doc["displayTimeUnit"] == "ms"


def test_exports_are_the_jax_packages_bytes():
    """The same records give the same JSONL and Chrome bytes through the
    port's exporters as through the JAX package's."""
    rows = [dict(t_ms=1.0, kind="exec.batch", node=0, partition=2, t_end_ms=3.5,
                 args=(("idx", 4), ("wm", 1999))),
            dict(t_ms=2.25, kind="net.msg", src=0, dst="storage", cls="ckpt_put",
                 nbytes=1234.0, status="ok", t_end_ms=52.25),
            dict(t_ms=4.0, kind="emit", node=1, partition=3, window=7, status="accepted",
                 args=(("digest", 123456789), ("latency_ms", 12.5))),
            dict(t_ms=5.0, kind="node.crash", node=1, args=(("owned", (1, 3)),))]
    port = [TraceEvent(**r) for r in rows]
    jax_ = [jrec.TraceEvent(**r) for r in rows]
    assert to_jsonl(port, dropped=3) == jrec.to_jsonl(jax_, dropped=3)
    assert json.dumps(to_chrome(port)) == json.dumps(jrec.to_chrome(jax_))


def test_registry_key_sorted_and_histogram():
    reg = MetricsRegistry()
    reg.counter("c", node=2).inc(3)
    reg.counter("c", node=1).inc()
    h = reg.histogram("lat", phase="emit")
    for v in (0.5, 3.0, 100.0):
        h.observe(v)
    got = reg.collect()
    assert list(got) == sorted(got) and got["c{node=1}"] == 1 and got["c{node=2}"] == 3
    assert h.count == 3 and h.max == 100.0 and h.min == 0.5 and h.percentile(99) <= h.max
    assert reg.histograms("lat") == {"lat{phase=emit}": h}


def test_snapshot_series_on_sim_time():
    sim = Sim()
    tel = Telemetry(sim, on=True, snapshot_ms=10.0)
    tel.registry.counter("n").inc()
    tel.start_snapshots()
    sim.run(until=35.0)
    assert [t for t, _ in tel.registry.series] == [10.0, 20.0, 30.0]
    assert all(vals["n"] == 1 for _, vals in tel.registry.series)


def test_summary_shared_keys_and_matches_jax():
    s = summary([1.0, 2.0, 3.0])
    assert set(s) == {"avg", "p50", "p99", "max", "n"}
    assert s["avg"] == pytest.approx(2.0) and s["n"] == 3
    xs = np.random.default_rng(0).random(101) * 50
    assert summary(xs) == jreg.summary(xs)


def test_timers_domains():
    with WallTimer() as wt:
        pass
    assert wt.domain == "wall" and wt.dt >= 0.0 and wt.dt_ms == wt.dt * 1e3
    sim = Sim()
    st_ = SimTimer(sim)
    with st_:
        sim.after(5.0, lambda: None)
        sim.run(until=10.0)
    assert st_.domain == "sim" and st_.dt_ms == pytest.approx(10.0)


def test_telemetry_off_records_nothing():
    sim = Sim()
    tel = Telemetry(sim)
    tel.event("emit", node=0)
    tel.net_msg(0, 1, "sync", 10.0, "ok")
    tel.start_snapshots()
    sim.run(until=2000.0)
    assert tel.buf.total == 0 and tel.registry.series == []


# ---------------------------------------------------------------------------
# determinism: byte-identical exports, on/off run-equivalence
# ---------------------------------------------------------------------------

CHAOS_CFG = dataclasses.replace(CFG, net_loss=0.05, net_jitter="uniform", net_jitter_ms=3.0)
CHAOS_SCEN = (Scenario("crash_and_partition").crash(1500.0, 0).partition(2500.0, (1,), (2,))
              .heal(4000.0).restart(4500.0, 0))


@pytest.mark.parametrize("harness", sorted(HARNESSES))
def test_same_seed_byte_identical_exports(harness):
    h1, h2 = _run(CHAOS_CFG, CHAOS_SCEN, harness), _run(CHAOS_CFG, CHAOS_SCEN, harness)
    assert h1.obs.buf.total > 0
    assert h1.obs.export_jsonl() == h2.obs.export_jsonl()
    assert json.dumps(h1.obs.export_chrome()) == json.dumps(h2.obs.export_chrome())


@pytest.mark.parametrize("harness", sorted(HARNESSES))
def test_telemetry_does_not_perturb_run(harness):
    h_on = _run(CHAOS_CFG, CHAOS_SCEN, harness)
    h_off = _run(dataclasses.replace(CHAOS_CFG, obs=False), CHAOS_SCEN, harness)
    assert h_off.obs.buf.total == 0
    c_on, c_off = h_on.consumer, h_off.consumer
    assert sorted(c_on.records) == sorted(c_off.records)
    for k in c_on.records:
        a, b = c_on.records[k], c_off.records[k]
        assert a.emit_time == b.emit_time and a.latency == b.latency
        if a.value is not None:
            assert np.array_equal(np.asarray(a.value), np.asarray(b.value))
    assert c_on.latency_stats() == c_off.latency_stats()


def test_net_trace_equality_still_holds():
    cfg = dataclasses.replace(CHAOS_CFG, obs=False, net_trace=True)
    h1, h2 = _run(cfg, CHAOS_SCEN), _run(cfg, CHAOS_SCEN)
    assert h1.net.trace and h1.net.trace == h2.net.trace


@pytest.mark.parametrize("harness", sorted(HARNESSES))
def test_trace_records_every_scenario_family(harness):
    """Each of ``tests/test_obs.py``'s scenario families runs and records
    the lifecycle records its auditor reads (the auditor's verdicts are
    held in ``tests/test_torch_obs_analysis.py``)."""
    scen = {"holon": Scenario("el").scale_out(2000.0, 3).scale_in(4000.0, 3),
            "flink": FailureScenario.concurrent(t=2000.0)}[harness]
    kinds = {e.kind for e in _run(scenario=scen, harness=harness).obs.events()}
    assert {"exec.batch", "emit", "net.msg"} <= kinds
    assert ({"sync.publish", "sync.recv", "ckpt.apply", "node.drain"} if harness == "holon"
            else {"flink.barrier", "flink.down", "node.crash", "node.restart"}) <= kinds


@pytest.mark.parametrize("harness", sorted(HARNESSES))
def test_online_monitor_attached(harness):
    """``obs_monitor=True`` turns recording on and attaches an
    ``OnlineMonitor`` that sees every record, and the trace is the bytes of
    the run with the monitor off."""
    h_on = _run(dataclasses.replace(CFG, obs=False, obs_monitor=True), harness=harness)
    h_off = _run(CFG, harness=harness)
    assert h_on.obs.on and isinstance(h_on.monitor, OnlineMonitor) and h_off.monitor is None
    assert h_on.monitor.fed == h_on.obs.buf.total > 0
    assert h_on.obs.export_jsonl() == h_off.obs.export_jsonl()


# ---------------------------------------------------------------------------
# the port imports neither JAX nor the JAX package
# ---------------------------------------------------------------------------

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
import repro_torch.runtime
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print("MODULES", len(names), "BAD", bad)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    src = Path(__file__).resolve().parents[1] / "src"
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], capture_output=True, text=True,
                       timeout=300, env=dict(os.environ, PYTHONPATH=str(src)))
    assert "BAD []" in r.stdout, r.stdout + r.stderr
    assert int(r.stdout.split()[1]) >= 30  # every module was imported

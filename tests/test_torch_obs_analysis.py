"""The port's trace analysis against the JAX package's, on the CPU.

The port's ``obs/audit.py``, ``obs/critpath.py`` and ``obs/monitor.py`` run
over the port's runtime traces and are held against the JAX modules over
the JAX runtime's traces of the same scenario, at
``tests/test_torch_runtime_parity.py``'s ``SMALL`` config.  Mirrored:
``test_obs.py``'s ``TestAuditorPasses`` and ``TestAuditorMutations``,
``test_topology.py::test_sparse_topology_run_passes_audit``, and the cases
of ``test_critpath.py`` and ``test_monitor.py``.  ``SMALL`` streams 3,072 ms
of events, half the JAX tests' config, so every scenario's fault times are
half theirs.

In every case the two runs export equal trace bytes, and the port's answers
(the ``AuditReport``, ``CritPathReport.to_json()``, the monitor's alerts)
equal the JAX modules' answers on the JAX trace.  The JAX trace, read back
by ``convert.trace_from_jsonl``, gives the JAX answers through the port's
``audit``, ``analyze`` and ``replay`` as well.

q7 is the query throughout (the JAX tests' query).  One q4 case: a q4 read
sums actor rows in another order than the JAX package, so its emitted
value digests differ (``test_torch_runtime_parity.py``); no report field
carries a digest (``[exactly-once]`` compares digests within one trace),
so the reports are equal all the same, and the traces are compared with
their digests left out.

Each runtime runs once a module: the ``runs`` fixture keeps every pair.
"""
from __future__ import annotations

import dataclasses
import importlib
import json

import numpy as np
import pytest
import torch

import repro.runtime as JR
import repro_torch.runtime as PR
from repro.streaming import queries as jq
from repro_torch.convert import trace_from_jsonl
from repro_torch.streaming import queries as pq

# the modules themselves: each package's obs/__init__ exports a function
# ``audit`` under the name of its module
jaudit, jcrit, jmon, jrec, paudit, pcrit, pmon, prec = (
    importlib.import_module(f"{pkg}.obs.{m}") for pkg in ("repro", "repro_torch")
    for m in ("audit", "critpath", "monitor", "records"))

SMALL = JR.SimConfig(
    num_nodes=3, num_partitions=6, num_batches=60, events_per_batch=512,
    rate_per_partition=10_000.0, window_len=500, num_slots=32,
    ckpt_interval_ms=300.0, sync_interval_ms=50.0, obs=True,
)
HORIZON = SMALL.horizon_ms + 10_000.0
CHAOS = {"net_loss": 0.05, "net_jitter": "uniform", "net_jitter_ms": 3.0}
MON = {"obs_monitor": True}
SCENARIOS = ("baseline", "concurrent", "subsequent", "crash", "partition_heal", "elastic")
FLINK_SCENARIOS = ("baseline", "concurrent", "partition_heal")
PKGS = {"jax": {"runtime": JR, "queries": jq, "monitor": jmon, "records": jrec},
        "port": {"runtime": PR, "queries": pq, "monitor": pmon, "records": prec}}


def _scenario(pkg, name: str):
    """The JAX tests' scenario families at half their times."""
    if name == "baseline":
        return None
    if name in ("concurrent", "subsequent", "crash"):
        return getattr(pkg.FailureScenario, name)(t=750.0 if name == "subsequent" else 1000.0)
    S = pkg.Scenario
    return {
        "partition_heal": lambda: S("ph").partition(1000.0, (0,), (1, 2)).heal(1750.0),
        "elastic": lambda: S("el").scale_out(1000.0, 3).scale_in(2000.0, 3),
        "chaos": lambda: (S("crash_and_partition").crash(750.0, 0).partition(1250.0, (1,), (2,))
                          .heal(2000.0).restart(2250.0, 0)),
        # test_topology.py's churn mix, which fits SMALL's stream as it is
        "mix": lambda: (S("mix").crash(1000, 1).restart(2200, 1).scale_out(1400, 5)
                        .scale_in(3000, 5)),
    }[name]()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The runtime folds tensors of a few KB, op by op: one intra-op thread
    a process, or the workers of a parallel test run spin against each
    other on the CPU's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(side: str, harness: str, scenario: str, query: str = "q7", **overrides):
    pkg, queries = PKGS[side]["runtime"], PKGS[side]["queries"]
    cfg = pkg.SimConfig(**{**dataclasses.asdict(SMALL), **overrides})
    q = getattr(queries, "make_" + query)(cfg.num_partitions, window_len=cfg.window_len,
                                         num_slots=cfg.num_slots)
    cls = pkg.HolonHarness if harness == "holon" else pkg.FlinkHarness
    h = cls(cfg, q) if side == "jax" else cls(cfg, q, device="cpu")
    h.run(_scenario(pkg, scenario), horizon_ms=HORIZON)
    return h


@pytest.fixture(scope="module")
def runs():
    """``runs(harness, scenario, query="q7", **overrides)``: the JAX and the
    port harness of one run, each run once a module."""
    cache = {}

    def get(harness: str, scenario: str, query: str = "q7", **overrides):
        key = (harness, scenario, query, tuple(sorted(overrides.items())))
        if key not in cache:
            cache[key] = tuple(_run(side, harness, scenario, query, **overrides)
                               for side in ("jax", "port"))
        return cache[key]

    return get


def _same_trace(jh, ph) -> str:
    text = jh.obs.export_jsonl()
    assert ph.obs.export_jsonl() == text and jh.obs.buf.total > 0
    return text


def _alerts(mon) -> list:
    mon.violations()  # settles merges still waiting on their ack
    return [(a.t_ms, a.id, a.severity, a.msg) for a in mon.alerts] + [mon.alerts_dropped]


# ---------------------------------------------------------------------------
# the auditor certifies every scenario family, and gives the JAX report
# ---------------------------------------------------------------------------


def _report(rep) -> tuple:
    """An ``AuditReport``'s fields (the two packages' classes differ)."""
    return rep.ok, rep.violations, rep.metrics


def _audit_pair(jh, ph):
    text = _same_trace(jh, ph)
    rep = paudit.audit_harness(ph)
    want = _report(jaudit.audit_harness(jh))
    assert _report(rep) == want
    assert _report(paudit.audit(trace_from_jsonl(text), cfg=ph.cfg)) == want
    return rep


@pytest.mark.parametrize("name", SCENARIOS)
def test_holon_audit_clean(runs, name):
    rep = _audit_pair(*runs("holon", name, **MON))
    assert rep.ok, f"{name}: {rep}"
    assert rep.metrics["windows_accepted"] > 0


@pytest.mark.parametrize("name", FLINK_SCENARIOS)
def test_flink_audit_clean(runs, name):
    rep = _audit_pair(*runs("flink", name, **MON))
    assert rep.ok, f"{name}: {rep}"


def test_recovery_metrics_extracted(runs):
    rep = _audit_pair(*runs("holon", "crash", **MON))
    ttr = rep.metrics["time_to_recover_ms"]
    bound = (SMALL.hb_timeout_ms + 2 * SMALL.hb_interval_ms + SMALL.steal_delay_ms
             + 2 * SMALL.storage_rtt_ms + paudit.RECOVERY_SLACK_MS)
    assert ttr and all(0.0 < t <= bound for t in ttr.values())
    assert "time_to_settle_ms" in rep.metrics


def test_flink_downtime_extracted(runs):
    rep = _audit_pair(*runs("flink", "concurrent", **MON))
    assert "flink_downtime_ms" in rep.metrics


@pytest.mark.parametrize("spec", ("ring:2", "hypercube", "partial:2"))
def test_sparse_topology_run_passes_audit(runs, spec):
    """``[unacked-merge]`` cross-checks every merge against an ack to the
    direct sender: relayed dissemination keeps that contract."""
    jh, ph = runs("holon", "mix", topology=spec)
    rep = _audit_pair(jh, ph)
    assert rep.ok, rep.violations
    pubs = [e for e in ph.obs.events() if e.kind == "sync.publish"]
    assert pubs and all(e.arg("topology") == spec for e in pubs)
    assert all(e.arg("fanout") == len(e.arg("peers")) for e in pubs)


def _without_digests(text: str) -> list:
    out = []
    for ln in text.splitlines():
        rec = json.loads(ln)
        if "args" in rec:
            rec["args"] = [kv for kv in rec["args"] if kv[0] != "digest"]
        out.append(rec)
    return out


def test_q4_reports_match_jax_verdict_by_verdict(runs):
    jh, ph = runs("holon", "concurrent", "q4", **MON)
    jtext, ptext = jh.obs.export_jsonl(), ph.obs.export_jsonl()
    assert _without_digests(ptext) == _without_digests(jtext)
    want, got = jaudit.audit_harness(jh), paudit.audit_harness(ph)
    assert want.ok and got.ok
    assert got.violations == want.violations
    for k, v in want.metrics.items():
        assert got.metrics[k] == v, k
    assert got.metrics.keys() == want.metrics.keys()
    assert _report(paudit.audit(trace_from_jsonl(jtext), cfg=ph.cfg)) == _report(want)
    assert pcrit.analyze_harness(ph).to_json() == jcrit.analyze_harness(jh).to_json()
    assert _alerts(ph.monitor) == _alerts(jh.monitor)


# ---------------------------------------------------------------------------
# seeded violations: each flagged with the JAX auditor's message
# ---------------------------------------------------------------------------


def _mutate_duplicate(evs, mkargs):
    first = next(e for e in evs if e.kind == "emit" and e.status == "accepted")
    return evs + [dataclasses.replace(first, t_ms=first.t_ms + 1.0)]


def _mutate_digest(evs, mkargs):
    first = next(e for e in evs if e.kind == "emit" and e.status == "accepted")
    return evs + [dataclasses.replace(first, t_ms=first.t_ms + 1.0, status="duplicate",
                                      args=mkargs(digest=12345, latency_ms=0.0))]


def _mutate_frontier(evs, mkargs):
    applies = [e for e in evs if e.kind == "ckpt.apply"]
    last = max(applies, key=lambda e: (e.t_ms, e.arg("nxt_idx", 0)))
    return evs + [dataclasses.replace(last, t_ms=last.t_ms + 1.0, args=mkargs(nxt_idx=0, epoch=0))]


def _mutate_unacked(evs, mkargs):
    merge = next(e for e in evs if e.kind == "sync.recv" and e.status == "delta_merge"
                 and e.arg("marker"))
    return evs + [dataclasses.replace(merge, t_ms=merge.t_ms + 0.123)]


def _mutate_domination(evs, mkargs):
    merge = next(e for e in evs if e.kind == "sync.recv" and e.status == "delta_merge")
    return evs + [dataclasses.replace(merge, t_ms=merge.t_ms + 0.125,
                                      args=mkargs(dominated=0, marker=0))]


MUTATIONS = {
    "clean": (lambda evs, mkargs: evs, None),
    "exactly-once": (_mutate_duplicate, "accepted twice"),
    "exactly-once-digest": (_mutate_digest, "different value digest"),
    "frontier-regression": (_mutate_frontier, "[frontier-regression]"),
    "unacked-merge": (_mutate_unacked, "[unacked-merge]"),
    "domination": (_mutate_domination, "[domination]"),
}


def _mutated(runs, name: str) -> dict:
    """Each side's concurrent-failure trace with one violation seeded."""
    pair = runs("holon", "concurrent", **MON)
    _same_trace(*pair)
    mutate = MUTATIONS[name][0]
    return {side: (mutate(list(h.obs.buf.events()), PKGS[side]["records"].mkargs), h.cfg)
            for side, h in zip(("jax", "port"), pair)}


@pytest.mark.parametrize("name", list(MUTATIONS))
def test_auditor_mutation_flagged(runs, name):
    ev = _mutated(runs, name)
    got = paudit.audit(ev["port"][0], cfg=ev["port"][1])
    assert _report(got) == _report(jaudit.audit(ev["jax"][0], cfg=ev["jax"][1]))
    flag = MUTATIONS[name][1]
    if flag is None:
        assert got.ok
    else:
        assert any(flag in s for s in got.violations), got.violations


def test_truncated_ring_refused(runs):
    ev = _mutated(runs, "clean")
    rep = paudit.audit(ev["port"][0], cfg=ev["port"][1], dropped=7)
    assert not rep.ok and any("[truncated]" in s for s in rep.violations)
    assert _report(rep) == _report(jaudit.audit(ev["jax"][0], cfg=ev["jax"][1], dropped=7))


def _audit_ids(audit_mod, events, cfg) -> set:
    rep = audit_mod.audit(events, cfg=cfg)
    return {i for i in pmon.AUDIT_IDS if any(f"[{i}]" in v for v in rep.violations)}


@pytest.mark.parametrize("name", list(MUTATIONS))
def test_monitor_mutation_equivalence(runs, name):
    """The monitor's online violation set equals the auditor's, id for id,
    and its alerts equal the JAX monitor's on the JAX trace."""
    ev = _mutated(runs, name)
    mon = pmon.replay(ev["port"][0], cfg=ev["port"][1])
    want = _audit_ids(paudit, *ev["port"])
    assert (want == set()) == (name == "clean")
    assert mon.violation_ids() == want == _audit_ids(jaudit, *ev["jax"])
    assert _alerts(mon) == _alerts(jmon.replay(ev["jax"][0], cfg=ev["jax"][1]))


# ---------------------------------------------------------------------------
# the critical path of every accepted emission
# ---------------------------------------------------------------------------


def _accepted(h) -> int:
    return sum(1 for e in h.obs.buf.events() if e.kind == "emit" and e.status == "accepted")


def _check_properties(report, accepted: int):
    """The invariants every reconstructed path must satisfy."""
    assert len(report.paths) == accepted
    for p in report.paths:
        assert p.path_ms <= p.latency_ms + 1e-6, p
        assert sum(p.phases.values()) == pytest.approx(p.path_ms, abs=1e-6), p
        assert all(v >= -1e-9 for v in p.phases.values()), p
        assert set(p.phases) == set(pcrit.PHASES)
        assert p.hops >= 0 and p.t_emit_ms >= 0.0


def _critpath_pair(jh, ph):
    text = _same_trace(jh, ph)
    report = pcrit.analyze_harness(ph)
    want = jcrit.analyze_harness(jh).to_json()
    assert report.to_json() == want
    assert pcrit.analyze(trace_from_jsonl(text), cfg=ph.cfg).to_json() == want
    _check_properties(report, _accepted(ph))
    return report


@pytest.mark.parametrize("name", SCENARIOS)
def test_critpath_invariants(runs, name):
    report = _critpath_pair(*runs("holon", name, **MON))
    assert report.system == "holon" and report.topology == "all"
    s = report.summary()
    assert s["n"] == len(report.paths) > 0
    assert s["path_ms"]["max"] <= s["latency_ms"]["max"] + 1e-6


def test_critpath_recovery_phase_on_adopted_checkpoint():
    """An emission gated by a checkpoint-adopted lane charges the steal
    delay to ``recovery`` and anchors at the stored checkpoint."""
    def events(mod):
        return [
            mod.TraceEvent(t_ms=100.0, kind="ckpt.apply", node=0, partition=0, status="applied",
                           args=mod.mkargs(wm=(5,), nxt_idx=5)),
            mod.TraceEvent(t_ms=200.0, kind="steal.adopt", node=1, partition=0, status="ckpt"),
            mod.TraceEvent(t_ms=250.0, kind="emit", node=1, partition=0, window=0,
                           status="accepted", args=mod.mkargs(digest=1, latency_ms=300.0)),
        ]

    report = pcrit.analyze(events(prec))
    (p,) = report.paths
    assert p.phases["recovery"] == pytest.approx(100.0)  # adopt - ckpt
    assert p.phases["queue"] == pytest.approx(50.0)  # emit - adopt
    assert p.path_ms == pytest.approx(150.0) and p.hops == 1
    assert p.origin == 0  # the checkpoint writer, not the thief
    assert report.to_json() == jcrit.analyze(events(jrec)).to_json()


@pytest.mark.parametrize("name", ("baseline", "concurrent"))
def test_flink_critpath_invariants(runs, name):
    report = _critpath_pair(*runs("flink", name, **MON))
    assert report.system == "flink" and report.topology == "tree"
    assert sum(p.phases["wire"] for p in report.paths) > 0.0


def test_critpath_lossy_links_show_wire_and_loss_stall(runs):
    report = _critpath_pair(*runs("holon", "baseline", **{**CHAOS, "net_loss": 0.40}))
    assert sum(p.phases["wire"] for p in report.paths) > 0.0
    assert sum(p.phases["loss_stall"] for p in report.paths) > 0.0


@pytest.mark.parametrize("topo", ("ring:2", "hypercube"))
def test_critpath_sparse_topologies_analyzed(runs, topo):
    assert _critpath_pair(*runs("holon", "baseline", topology=topo)).topology == topo


def test_critpath_sparse_topology_stretches_hops(runs):
    paths_all = _critpath_pair(*runs("holon", "baseline", **MON)).paths
    paths_ring = _critpath_pair(*runs("holon", "baseline", topology="ring:1")).paths
    assert max(p.hops for p in paths_ring) >= max(p.hops for p in paths_all)


@pytest.mark.parametrize("harness", ("holon", "flink"))
def test_critpath_same_seed_byte_identical_report(runs, harness):
    jh, ph = runs(harness, "chaos", **CHAOS, **MON)
    again = _run("port", harness, "chaos", **CHAOS, **MON)
    report = _critpath_pair(jh, ph)
    assert pcrit.analyze_harness(again).to_json() == report.to_json()
    assert len(report.paths) > 0


def test_critpath_report_json_schema(runs):
    doc = json.loads(_critpath_pair(*runs("holon", "baseline", **MON)).to_json())
    assert doc["meta"] == "holon-critpath-v1" and doc["system"] == "holon"
    assert set(doc["summary"]["phase_ms"]) == set(pcrit.PHASES)
    assert set(doc["summary"]["phase_frac"]) == set(pcrit.PHASES)
    for p in doc["paths"]:
        assert set(p["phases"]) == set(pcrit.PHASES)


def test_critpath_accepts_plain_event_list(runs):
    _, ph = runs("holon", "baseline", **MON)
    via_list = pcrit.analyze(list(ph.obs.buf.events()), cfg=ph.cfg)
    assert via_list.to_json() == pcrit.analyze_harness(ph).to_json()


# ---------------------------------------------------------------------------
# the online monitor: equivalence with the auditor, health alerts, passivity
# ---------------------------------------------------------------------------


def _monitor_pair(jh, ph):
    text = _same_trace(jh, ph)
    mon = ph.monitor
    assert isinstance(mon, pmon.OnlineMonitor)
    # the subscription saw every appended record
    assert mon.fed == ph.obs.buf.total == jh.monitor.fed
    assert _alerts(mon) == _alerts(jh.monitor)
    want = _alerts(jmon.replay(jh.obs.buf.events(), cfg=jh.cfg))
    assert _alerts(pmon.replay(ph.obs.buf.events(), cfg=ph.cfg)) == want
    assert _alerts(pmon.replay(trace_from_jsonl(text), cfg=ph.cfg)) == want
    return mon


@pytest.mark.parametrize("name", SCENARIOS)
def test_monitor_holon_clean_scenarios(runs, name):
    jh, ph = runs("holon", name, **MON)
    assert _monitor_pair(jh, ph).violations() == []
    assert paudit.audit_harness(ph).ok


@pytest.mark.parametrize("name", FLINK_SCENARIOS)
def test_monitor_flink_clean_scenarios(runs, name):
    jh, ph = runs("flink", name, **MON)
    assert _monitor_pair(jh, ph).violations() == []
    assert paudit.audit_harness(ph).ok


def test_monitor_replay_equals_live_monitor(runs):
    jh, ph = runs("holon", "chaos", **CHAOS, **MON)
    mon = _monitor_pair(jh, ph)
    replayed = pmon.replay(ph.obs.buf.events(), cfg=ph.cfg)
    assert replayed.violation_ids() == mon.violation_ids()
    assert replayed.warning_ids() == mon.warning_ids()


def _emit(mod, t, wid, node=0, latency=1.0):
    return mod.TraceEvent(t_ms=t, kind="emit", node=node, partition=0, window=wid,
                          status="accepted", args=mod.mkargs(digest=wid, latency_ms=latency))


def _stall(mod):
    ev = mod.TraceEvent
    return [ev(t_ms=0.0, kind="exec.batch", node=0, partition=0, args=mod.mkargs(wm=1, queue_ms=0.0)),
            ev(t_ms=500.0, kind="hb.beacon", node=1), ev(t_ms=600.0, kind="hb.beacon", node=1),
            ev(t_ms=650.0, kind="exec.batch", node=0, partition=0,
               args=mod.mkargs(wm=2, queue_ms=0.0)),
            ev(t_ms=1000.0, kind="hb.beacon", node=1)]


def _sync_burn(mod):
    return [mod.TraceEvent(t_ms=t, kind="net.msg", src=0, dst=1, cls="sync", status="ok",
                           nbytes=n, t_end_ms=t + 1.0) for t, n in ((500.0, 1e5), (1500.0, 1.0))]


def _straggler(mod):
    """Node 1's folds gate every emission at node 0."""
    out = []
    for k in range(1, 71):
        t = float(10 * k)
        out += [mod.TraceEvent(t_ms=t, kind="exec.batch", node=1, partition=0,
                               args=mod.mkargs(wm=k, queue_ms=0.0)),
                mod.TraceEvent(t_ms=t + 1.0, kind="net.msg", src=1, dst=0, cls="sync",
                               status="ok", nbytes=64.0, t_end_ms=t + 2.0),
                mod.TraceEvent(t_ms=t + 2.0, kind="sync.recv", node=0, src=1,
                               status="delta_merge", args=mod.mkargs(dominated=1, marker=0)),
                _emit(mod, t + 3.0, k)]
    return out


# (monitor options, the synthetic stream, the warning ids it must raise)
HEALTH = {
    "frontier-stall": ({"stall_ms": 100.0}, _stall, {"frontier-stall"}),
    "slo-burn": ({"slo_ms": 10.0, "slo_frac": 0.5},
                 lambda mod: [_emit(mod, float(i), i, latency=100.0) for i in range(40)],
                 {"slo-burn"}),
    "slo-disabled": ({}, lambda mod: [_emit(mod, float(i), i, latency=1e9) for i in range(40)],
                     set()),
    "sync-burn": ({"sync_budget": 10.0}, _sync_burn, {"sync-burn"}),
    "straggler": ({"num_partitions": 1}, _straggler, {"straggler"}),
}


@pytest.mark.parametrize("name", list(HEALTH))
def test_monitor_health_alerts(name):
    opts, stream, want = HEALTH[name]
    mons = {}
    for side in ("jax", "port"):
        mod = PKGS[side]["records"]
        mons[side] = PKGS[side]["monitor"].OnlineMonitor(**opts)
        for ev in stream(mod):
            mons[side].feed(ev)
    mon = mons["port"]
    assert mon.warning_ids() == want and mon.violations() == []
    if name == "frontier-stall":  # one alert an episode; progress starts a new one
        assert sum(1 for a in mon.alerts if a.id == "frontier-stall") == 2
    assert _alerts(mon) == _alerts(mons["jax"])


def test_monitor_alert_cap_counts_overflow():
    mon = pmon.OnlineMonitor()
    for i in range(2000):
        mon._alert(float(i), "frontier-stall", "warn", "x")
    assert len(mon.alerts) == mon.alerts.maxlen
    assert mon.alerts_dropped == 2000 - mon.alerts.maxlen


@pytest.mark.parametrize("harness", ("holon", "flink"))
def test_monitor_on_off_byte_identical(runs, harness):
    jh, h_on = runs(harness, "chaos", **CHAOS, **MON)
    _, h_off = runs(harness, "chaos", **CHAOS)
    assert h_on.monitor is not None and h_off.monitor is None
    assert h_on.obs.export_jsonl() == h_off.obs.export_jsonl() == jh.obs.export_jsonl()
    c_on, c_off = h_on.consumer, h_off.consumer
    assert sorted(c_on.records) == sorted(c_off.records)
    for k in c_on.records:
        a, b = c_on.records[k], c_off.records[k]
        assert a.emit_time == b.emit_time and a.latency == b.latency
        if a.value is not None:
            assert np.array_equal(a.value, b.value)


def test_monitor_implies_obs(runs):
    jh, ph = runs("holon", "baseline", obs=False, obs_monitor=True)
    assert ph.obs.buf.total > 0
    _monitor_pair(jh, ph)


# ---------------------------------------------------------------------------
# spill: evicted records stream to a JSONL spool and stay auditable
# ---------------------------------------------------------------------------


def test_spill_roundtrip_lossless(tmp_path):
    buf = prec.TraceBuffer(cap=8, spill_path=str(tmp_path / "spill.jsonl"))
    evs = [prec.TraceEvent(t_ms=float(i), kind="x", node=i % 3,
                           args=prec.mkargs(k=i, f=0.5 * i)) for i in range(50)]
    for e in evs:
        buf.append(e)
    buf.flush_spill()
    assert buf.total == 50 and buf.dropped == 0
    assert buf.spilled == 50 - len(buf.events())
    assert buf.all_events() == evs  # spool + ring, original order and args


def test_spill_preserves_arg_types(tmp_path):
    buf = prec.TraceBuffer(cap=1, spill_path=str(tmp_path / "spill.jsonl"))
    buf.append(prec.TraceEvent(t_ms=1.0, kind="ckpt.apply", partition=2,
                               args=prec.mkargs(wm=(1, 2, 3), nxt_idx=7)))
    buf.append(prec.TraceEvent(t_ms=2.0, kind="y"))
    buf.flush_spill()
    (back,) = buf.spilled_events()
    assert back.arg("wm") == (1, 2, 3) and back.arg("nxt_idx") == 7


def test_spilled_chaos_run_audits_clean(runs, tmp_path):
    """A ring of 256 records spills the run: audit, analysis and replay over
    spool and ring give what the unspilled JAX run gives."""
    jh, _ = runs("holon", "chaos", **CHAOS, **MON)
    h = _run("port", "holon", "chaos", **CHAOS, **MON, obs_trace_cap=256,
             obs_spill_path=str(tmp_path / "trace.jsonl"))
    buf = h.obs.buf
    buf.flush_spill()
    assert buf.spilled > 0 and buf.dropped == 0
    rep = paudit.audit(buf.all_events(), cfg=h.cfg, dropped=buf.dropped)
    assert rep.ok, rep
    assert _report(rep) == _report(paudit.audit_harness(h)) == _report(jaudit.audit_harness(jh))
    assert pcrit.analyze_harness(h).to_json() == jcrit.analyze_harness(jh).to_json()
    assert _alerts(h.monitor) == _alerts(jh.monitor)

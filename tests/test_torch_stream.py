"""The port's streaming slice against the JAX package.

One subprocess runs the JAX ``build_pipeline`` on 2 host devices for every
query in ``MAKERS``, with delta and full sync, and writes its log, ``oks``,
``vals`` and ``sync_bytes`` to an npz.  The port, with ``S=2`` partitions
stacked on the CPU, folds the same log and must match: bitwise, but q4's
float price sums to rtol 1e-5 (the fold adds a batch's sum to the running
sum; XLA's scatter adds lane by lane).  Also here: the device-side
generator's load shape, the oracles and the CLI.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.streaming import events as jev
from repro.streaming import generator as jgen
from repro.streaming import queries as jq
from repro_torch.convert import event_batch_from_numpy
from repro_torch.launch import stream
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.obs.timing import WallTimer
from repro_torch.streaming import generator
from repro_torch.streaming.events import KIND_AUCTION, KIND_BID, KIND_PERSON

FIELDS = [f.name for f in dataclasses.fields(jev.EventBatch)]
NB, B, WIN, SLOTS = 8, 64, 10, 16

_JAX_SCRIPT = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, numpy as np
from repro import compat
from repro.launch.stream import MAKERS, build_pipeline, read_window_range
from repro.streaming import NexmarkConfig, generate_log

mesh = compat.make_mesh((2,), ("data",))
nx = NexmarkConfig(num_partitions=2, num_batches={NB}, events_per_batch={B})
log = generate_log(nx)
out = {{"log." + k: np.asarray(getattr(log, k)) for k in {FIELDS}}}
for qn, mk in MAKERS.items():
    q = mk(2, window_len={WIN}, num_slots={SLOTS})
    first, n = read_window_range(q, nx.num_batches * nx.batch_span_ms)
    for sync in ("delta", "full"):
        with mesh:
            o, v, s = build_pipeline(q, mesh, 4, delta_sync=sync == "delta",
                                     n_windows=n, first_window=first)(log)
        for name, x in (("oks", o), ("vals", v), ("sync", s)):
            out[qn + "." + sync + "." + name] = np.asarray(x)
np.savez(sys.argv[1], **out)
print("JAX_PIPELINE_OK")
""".format(NB=NB, B=B, WIN=WIN, SLOTS=SLOTS, FIELDS=FIELDS)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax") / "pipeline.npz"
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    env.pop("XLA_FLAGS", None)  # the script sets its own device count
    r = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(out)],
                       capture_output=True, text=True, timeout=600, env=env)
    assert "JAX_PIPELINE_OK" in r.stdout, f"stdout={r.stdout[-2000:]}\nstderr={r.stderr[-2000:]}"
    return dict(np.load(out))


@pytest.mark.parametrize("sync", ["delta", "full"])
@pytest.mark.parametrize("qname", sorted(stream.MAKERS))
def test_pipeline_matches_jax_build_pipeline(jax_run, qname, sync):
    log = event_batch_from_numpy({k: jax_run["log." + k] for k in FIELDS})
    q = stream.MAKERS[qname](2, window_len=WIN, num_slots=SLOTS)
    first, n = stream.read_window_range(q, NB * 1000.0 * B / 10_000.0)
    pipe = stream.build_pipeline(q, make_data_mesh(2, "cpu"), 4, delta_sync=sync == "delta",
                                 n_windows=n, first_window=first)
    oks, vals, sb = pipe(log)
    j_vals = jax_run[f"{qname}.{sync}.vals"]
    assert oks.sum() > 0
    np.testing.assert_array_equal(oks.numpy(), jax_run[f"{qname}.{sync}.oks"])
    np.testing.assert_array_equal(sb.numpy(), jax_run[f"{qname}.{sync}.sync"])
    if qname == "q4":
        np.testing.assert_allclose(vals.numpy(), j_vals, rtol=1e-5)
    else:
        np.testing.assert_array_equal(vals.numpy(), j_vals)


def _jax_log(S=3, nb=4, b=200, **kw):
    cfg = jgen.NexmarkConfig(num_partitions=S, num_batches=nb, events_per_batch=b, **kw)
    log = jgen.generate_log(cfg)
    return log, event_batch_from_numpy({k: np.asarray(getattr(log, k)) for k in FIELDS})


@pytest.mark.parametrize("qname", sorted(stream.MAKERS))
def test_oracles_match_jax(qname):
    jlog, plog = _jax_log(rate_per_partition=20_000.0)
    jquery = getattr(jq, "make_" + qname)(3, window_len=10)
    pquery = stream.MAKERS[qname](3, window_len=10)
    for wid in range(0, 5):
        for part in (None, 1):
            want = jquery.oracle(jlog, jnp.int32(wid), part)
            got = pquery.oracle(plog, wid, part)
            if qname == "q7":
                np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
                np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]).astype(np.int64))
            elif qname == "q4":
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
            else:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_batch_watermark_matches_jax():
    jlog, plog = _jax_log(skew=1.5)
    for i in range(4):
        want = [int(jgen.batch_watermark(jev.EventBatch(*(getattr(jlog, f)[p, i] for f in FIELDS))))
                for p in range(3)]
        np.testing.assert_array_equal(generator.batch_watermark(plog.batch(i)).numpy(), want)


@pytest.mark.parametrize("skew", [0.0, 1.2])
def test_generator_load_shape_matches_jax(skew):
    """Same kinds and validity lanes as the JAX generator (both are
    deterministic patterns), timestamps sorted inside each batch's span,
    categories from auction ids, and lognormal(4, 1) prices."""
    S, nb, b = 3, 6, 500
    cfg = dict(num_partitions=S, num_batches=nb, events_per_batch=b, skew=skew, seed=7)
    jlog = jgen.generate_log(jgen.NexmarkConfig(**cfg))
    pcfg = generator.NexmarkConfig(**cfg)
    log = generator.generate_log(pcfg, "cpu")
    assert log.ts.shape == (S, nb, b) and log.ts.dtype == torch.int32
    assert log.auction.dtype == torch.int64 and log.price.dtype == torch.float32
    np.testing.assert_array_equal(log.kind.numpy(), np.asarray(jlog.kind))
    np.testing.assert_array_equal(log.valid.numpy(), np.asarray(jlog.valid))
    span = pcfg.batch_span_ms
    ts = log.ts.numpy()
    assert (np.diff(ts, axis=-1) >= 0).all()
    lo = np.floor(np.arange(nb) * span)[None, :, None]
    assert (ts >= lo).all() and (ts < lo + span + 1).all()
    np.testing.assert_array_equal(log.category.numpy(), log.auction.numpy() % 5)
    assert log.auction.min() >= 0 and log.auction.max() < pcfg.num_auctions
    lp = np.log(log.price.numpy())
    assert abs(lp.mean() - 4.0) < 0.05 and abs(lp.std() - 1.0) < 0.05
    counts = np.bincount(log.kind.numpy().reshape(-1), minlength=3) / log.kind.numel()
    np.testing.assert_allclose(counts[[KIND_PERSON, KIND_AUCTION, KIND_BID]],
                               [1 / 50, 3 / 50, 46 / 50], atol=0.01)
    again = generator.generate_log(pcfg, "cpu")
    for f in FIELDS:
        assert torch.equal(getattr(log, f), getattr(again, f))


def test_read_window_range_matches_jax():
    from repro.launch.stream import read_window_range as j_range

    for qname in stream.MAKERS:
        for wl, slots in ((10, 16), (1000, 64), (10_000, 64)):
            jquery = getattr(jq, "make_" + qname)(2, window_len=wl, num_slots=slots)
            pquery = stream.MAKERS[qname](2, window_len=wl, num_slots=slots)
            for h in (0.0, 51.2, 4003.7, 40055.6):
                assert stream.read_window_range(pquery, h) == j_range(jquery, h)


def test_cli_runs_on_cpu_and_refuses_a_missing_card(capsys):
    out = stream.main(["--device", "cpu", "--query", "q4", "--partitions", "2",
                       "--batches", "8", "--events-per-batch", "64", "--window-len", "10"])
    line = capsys.readouterr().out
    assert "partitions=2 events=1024" in line and "sync=delta" in line
    assert out["complete_windows"] == 5 and out["sync_bytes_per_round"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            stream.main(["--query", "q0", "--batches", "4"])


def test_wall_timer_measures_the_enclosed_work():
    with WallTimer("cpu") as tm:
        sum(range(10_000))
    assert tm.dt > 0


def test_host_ops_per_batch_stay_bounded():
    """The dataplane is bound by the host's eager launches (PERF.md), so the
    number of top-level torch ops the pipeline issues per batch, sync rounds
    and reads amortized, is held under a ceiling: about 110 (q0), 145 (q5)
    and 220-245 (q1_ratio, q4, q7) when this was written."""
    from torch.profiler import ProfilerActivity, profile

    S, nb = 16, 8
    log = generator.generate_log(generator.NexmarkConfig(
        num_partitions=S, num_batches=nb, events_per_batch=64), "cpu")
    for qname in stream.MAKERS:
        q = stream.MAKERS[qname](S, window_len=10_000, num_slots=64)
        pipe = stream.build_pipeline(q, make_data_mesh(S, "cpu"), 4, n_windows=5)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            pipe(log)
        ops = [e for e in prof.events() if e.name.startswith("aten::") and e.cpu_parent is None]
        per_batch = len(ops) / nb
        assert per_batch <= 250, (qname, per_batch)

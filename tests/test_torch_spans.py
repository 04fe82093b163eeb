"""The dataplane's wall-clock spans (``repro_torch.obs.timing.span``).

Off by default: a pass enters no ``holon.*`` profiler range and every
output is bitwise the same as with the spans on, dense (every query, delta
and full sync) and keyed (with and without provenance).  On, under
``recording()``: the span tree of a pass (one ``holon.fold.step`` a folded
batch, one ``holon.sync.round`` a round, one ``holon.read``, each child
inside its parent), nested recordings, the in-memory times against the
profiler's own ranges, and on two gloo ranks the same tree with the
outputs bitwise and ``DistMesh``'s collectives unchanged by the spans.
"""
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import wcrdt as W
from repro_torch.launch import stream
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.obs import timing
from repro_torch.streaming.generator import NexmarkConfig, generate_log
from _keyed_runs import C, NB, SLOTS, WL, S, nexmark, read_range
from _ranks import join_all, start_ranks

B, WIN = 64, 10  # the dense passes' batch and window
QUERIES = sorted(stream.MAKERS)
PIPELINES = ("dense", "keyed")


def dense_pass(mesh, query="q5", delta=True):
    """A thunk running one dense pass and its ``gather_outputs``."""
    nx = NexmarkConfig(num_partitions=S, num_batches=NB, events_per_batch=B)
    log = generate_log(nx, mesh.device, partitions=mesh.partitions)
    q = stream.MAKERS[query](S, window_len=WIN, num_slots=SLOTS)
    first, n = stream.read_window_range(q, NB * nx.batch_span_ms)
    pipe = stream.build_pipeline(q, mesh, 4, delta_sync=delta, n_windows=n, first_window=first)
    return lambda: stream.gather_outputs(mesh, pipe(log))


def keyed_pass(mesh, provenance=False):
    """A thunk running one keyed pass and its ``gather_outputs``."""
    log = generate_log(nexmark(NB), mesh.device, partitions=mesh.partitions)
    shards = W.KeyShards(C, S)
    first, n = read_range(NB)
    pipe = stream.build_keyed_pipeline(mesh, shards, window_len=WL, num_slots=SLOTS,
                                       n_windows=n, first_window=first, provenance=provenance)
    table, sched = shards.key_table(), stream.default_fold_schedule(S, NB)
    wm_sync = torch.ones(NB // 4, dtype=torch.bool)
    return lambda: stream.gather_outputs(mesh, pipe(log, table, sched, wm_sync))


def make_pass(kind: str, mesh=None):
    mesh = mesh or make_data_mesh(S, "cpu")
    return dense_pass(mesh) if kind == "dense" else keyed_pass(mesh)


def assert_equal(a: tuple, b: tuple) -> None:
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kind", PIPELINES)
def test_spans_are_off_by_default(kind):
    assert timing.span("holon.pass") is timing.span("holon.read")
    run = make_pass(kind)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    assert not [e.name for e in prof.events() if e.name.startswith("holon.")]


@pytest.mark.parametrize("delta", (True, False), ids=("delta", "full"))
@pytest.mark.parametrize("query", QUERIES)
def test_dense_outputs_bitwise_with_spans_on_and_off(query, delta):
    run = dense_pass(make_data_mesh(S, "cpu"), query, delta)
    off = run()
    with timing.recording() as spans:
        on = run()
    assert spans and timing.span("holon.pass") is timing.span("holon.read")
    assert_equal(off, on)


@pytest.mark.parametrize("provenance", (False, True), ids=("plain", "provenance"))
def test_keyed_outputs_bitwise_with_spans_on_and_off(provenance):
    run = keyed_pass(make_data_mesh(S, "cpu"), provenance)
    off = run()
    with timing.recording() as spans:
        on = run()
    assert spans
    assert_equal(off, on)


# each span's expected parent, by name, in a one-card pass
PARENT = {"holon.pass": None, "holon.fold.step": "holon.pass",
          "holon.fold.route": "holon.fold.step", "holon.sync.round": "holon.pass",
          "holon.read": "holon.pass", "holon.gather_outputs": None}


def check_tree(spans: list) -> None:
    """Each span's parent precedes it, is open when it starts, and holds it."""
    for i, s in enumerate(spans):
        assert s.start_ns <= s.end_ns
        if s.parent is None:
            continue
        p = spans[s.parent]
        assert s.parent < i and p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def check_passes(spans: list, kind: str, passes: int) -> None:
    """Each pass holds, in order, a round's ``holon.fold.step`` spans then
    its ``holon.sync.round``, round after round, then one ``holon.read``;
    on the keyed path each step holds one ``holon.fold.route``; every
    span's parent is the one :data:`PARENT` names."""
    for s in spans:
        assert (spans[s.parent].name if s.parent is not None else None) == PARENT[s.name]
    tops = [i for i, s in enumerate(spans) if s.parent is None]
    assert [spans[i].name for i in tops] == ["holon.pass", "holon.gather_outputs"] * passes
    round_ = ["holon.fold.step"] * 4 + ["holon.sync.round"]
    for p in tops[::2]:
        kids = [s.name for s in spans if s.parent == p]
        assert kids == round_ * (NB // 4) + ["holon.read"]
    steps = [i for i, s in enumerate(spans) if s.name == "holon.fold.step"]
    routes = [s.parent for s in spans if s.name == "holon.fold.route"]
    assert routes == (steps if kind == "keyed" else [])


@pytest.mark.parametrize("kind", PIPELINES)
def test_span_tree_of_a_pass(kind):
    run = make_pass(kind)
    run()  # warm
    with timing.recording() as spans:
        run()
        run()
    check_tree(spans)
    check_passes(spans, kind, 2)


def test_recording_nests():
    with timing.recording() as outer:
        with timing.span("holon.pass"):
            with timing.recording() as inner:
                assert inner is outer
                with timing.span("holon.read"):
                    pass
            with timing.span("holon.gather_outputs"):
                pass
        assert timing.span("x") is not timing.span("x")  # still on
    assert timing.span("x") is timing.span("x")  # off once the outer closes
    assert [(s.name, s.parent) for s in outer] == [
        ("holon.pass", None), ("holon.read", 0), ("holon.gather_outputs", 0)]
    with timing.recording() as fresh:
        pass
    assert fresh == [] and fresh is not outer


@pytest.mark.parametrize("kind", PIPELINES)
def test_spans_sit_on_the_profiler_clock(kind):
    run = make_pass(kind)
    run()
    with timing.recording() as spans, profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    ranges = sorted((e.start_ns(), e.end_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("holon."))
    mine = sorted((s.start_ns, s.end_ns, s.name) for s in spans)
    assert [r[2] for r in ranges] == [m[2] for m in mine]
    for (s0, e0, _), (s1, e1, _) in zip(ranges, mine):
        assert abs(s1 - s0) < 1_000_000 and abs(e1 - e0) < 1_000_000


_RANK_SCRIPT = """
import json, sys
import torch, torch.distributed as dist
from repro_torch.launch.mesh import make_dist_mesh
from repro_torch.obs import timing
from test_torch_spans import dense_pass, keyed_pass, S

rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                        world_size=world)
mesh = make_dist_mesh(S, "cpu", "gloo")


def collectives():
    return {k: [getattr(mesh.stats, k).calls, getattr(mesh.stats, k).sent_bytes]
            for k in ("gather", "exchange")}


res = {}
for kind, run in (("dense", dense_pass(mesh)), ("keyed", keyed_pass(mesh))):
    mesh.stats.reset()
    off = run()
    stats_off = collectives()
    mesh.stats.reset()
    with timing.recording() as spans:
        on = run()
    res[kind] = {
        "bitwise": all(torch.equal(a, b) for a, b in zip(off, on)),
        "spans": [[s.name, s.parent, s.start_ns, s.end_ns] for s in spans],
        "stats": [stats_off, collectives()]}
with open(out + "." + str(rank) + ".json", "w") as f:
    json.dump(res, f)
dist.destroy_process_group()
print("RANK_OK", rank)
"""


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory) -> list:
    """Each of 2 gloo ranks' spans of a dense and a keyed pass, whether its
    outputs equal the same pass with spans off, and ``DistMesh.stats``'
    calls and bytes of either pass."""
    tmp = tmp_path_factory.mktemp("spans")
    procs, logs = start_ranks(_RANK_SCRIPT, 2, tmp, tmp / "out")
    join_all(procs, logs, 240)
    return [json.loads((tmp / f"out.{r}.json").read_text()) for r in range(2)]


@pytest.mark.parametrize("rank", (0, 1))
@pytest.mark.parametrize("kind", PIPELINES)
def test_spans_on_gloo_ranks(gloo_ranks, kind, rank):
    got = gloo_ranks[rank][kind]
    assert got["bitwise"]
    spans = [timing.Span(*s) for s in got["spans"]]
    check_tree(spans)
    check_passes(spans, kind, 1)
    off, on = got["stats"]
    assert on == off and on["gather"][0] > 0
    assert (on["exchange"][0] > 0) == (kind == "keyed")

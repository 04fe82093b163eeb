"""The dense dataplane across processes against JAX's ``shard_map``.

One subprocess runs the JAX ``build_pipeline`` on 4 forced host devices,
one partition a device, for every query in ``MAKERS`` with delta and full
sync.  The port runs the same pipelines over a ``DistMesh`` of 4 gloo
ranks on the CPU, one partition a rank, each rank drawing its own row of
the log; ``oks``, ``vals`` and ``sync_bytes``, gathered to rank 0, must
match JAX bitwise (q4's float sums included: both folds add lane by lane
into the running sum).  2 ranks of 2 partitions must equal the stacked
run (``StackMesh``) at S = 4 bitwise.  Also here: the mesh's collectives
(``all_gather``, ``replicate``, ``all_to_all``, the gated ``pmax``) and
``shard_topk_read`` against ``StackMesh``'s, a rank's rows of the log
against the whole log, what ``make_dist_mesh`` refuses, and the CLI under
``torchrun``.  The keyed dataplane across processes is
``tests/test_torch_dist_keyed.py``.

Ranks meet through a ``FileStore`` under the test's temporary directory.
Every subprocess is joined with a timeout and killed when it or a peer
fails.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.convert import event_batch_from_numpy
from repro_torch.launch import mesh as M
from repro_torch.launch import stream
from repro_torch.streaming import generator
from _ranks import env, join_all, start_ranks

FIELDS = [f.name for f in dataclasses.fields(generator.EventBatch)]
NB, B, WIN, SLOTS = 8, 64, 10, 16  # tests/test_torch_stream.py's
S = 4
TIMEOUT = 240  # seconds for a whole group of processes

_JAX_SCRIPT = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={S}"
import jax, numpy as np
from repro import compat
from repro.launch.stream import MAKERS, build_pipeline, read_window_range
from repro.streaming import NexmarkConfig, generate_log

assert len(jax.devices()) == {S}
mesh = compat.make_mesh(({S},), ("data",))
nx = NexmarkConfig(num_partitions={S}, num_batches={NB}, events_per_batch={B})
log = generate_log(nx)
out = {{"log." + k: np.asarray(getattr(log, k)) for k in {FIELDS}}}
for qn, mk in MAKERS.items():
    q = mk({S}, window_len={WIN}, num_slots={SLOTS})
    first, n = read_window_range(q, nx.num_batches * nx.batch_span_ms)
    for sync in ("delta", "full"):
        with mesh:
            o, v, s = build_pipeline(q, mesh, 4, delta_sync=sync == "delta",
                                     n_windows=n, first_window=first)(log)
        for name, x in (("oks", o), ("vals", v), ("sync", s)):
            out[qn + "." + sync + "." + name] = np.asarray(x)
np.savez(sys.argv[1], **out)
print("JAX_PIPELINE_OK")
""".format(S=S, NB=NB, B=B, WIN=WIN, SLOTS=SLOTS, FIELDS=FIELDS)

# one rank: every pipeline over a DistMesh, then the mesh's collectives on
# stacked states; rank 0 writes what it gathered
_RANK_SCRIPT = """
import contextlib, dataclasses, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.core import crdt, wcrdt as W
from repro_torch.core.lattice import map_tensors
from repro_torch.launch import stream
from repro_torch.launch.mesh import make_data_mesh, make_dist_mesh
from repro_torch.streaming.generator import NexmarkConfig, generate_log

rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
S, NB, B, WIN, SLOTS = {S}, {NB}, {B}, {WIN}, {SLOTS}
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                        world_size=world)
mesh = make_dist_mesh(S, "cpu", "gloo")
assert mesh.partitions == range(rank * S // world, (rank + 1) * S // world)
nx = NexmarkConfig(num_partitions=S, num_batches=NB, events_per_batch=B)
log = generate_log(nx, "cpu", partitions=mesh.partitions)
res = {{}}
for qn, mk in stream.MAKERS.items():
    q = mk(S, window_len=WIN, num_slots=SLOTS)
    first, n = stream.read_window_range(q, NB * nx.batch_span_ms)
    for sync in ("delta", "full"):
        pipe = stream.build_pipeline(q, mesh, 4, delta_sync=sync == "delta",
                                     n_windows=n, first_window=first)
        local = pipe(log)
        assert all(x.shape[0] == mesh.local_size for x in local)
        for name, x in zip(("oks", "vals", "sync"), stream.gather_outputs(mesh, local)):
            res[qn + "." + sync + "." + name] = x.numpy()

# stacked states of every wire dtype: f32 and i64 (TopK), i32 (tenants,
# metadata), u8 (GSet); rank r holds rows r*L .. (r+1)*L - 1 of the whole
def flat(tag, st):
    d = {{f"{{tag}}.{{k}}": getattr(st, k).numpy()
         for k in ("slot_wid", "progress", "folded", "errors")}}
    d.update({{f"{{tag}}.windows.{{n}}": getattr(st.windows, n).numpy()
              for n in type(st.windows).KINDS}})
    return d

g = torch.Generator().manual_seed(11)
ints = lambda lo, hi, *shape: torch.randint(lo, hi, shape, generator=g, dtype=torch.int32)
windows = (crdt.TopK(vals=torch.randn(S, 5, 3, generator=g),
                     ids=torch.randint(0, 2**32, (S, 5, 3), generator=g, dtype=torch.int64)),
           crdt.GSet(bits=torch.randint(0, 256, (S, 5, 7), generator=g, dtype=torch.uint8)))
rows = slice(mesh.partitions.start, mesh.partitions.stop)
for k, w in enumerate(windows):
    whole = W.WState(ints(-1, 9, S, 5), w, ints(0, 99, S, S), ints(0, 99, S, S), ints(0, 9, S, 3))
    res.update(flat(f"whole{{k}}", whole))
    pick = lambda i: map_tensors(lambda x: x[i], whole)
    res.update(flat(f"gather{{k}}", mesh.all_gather(pick(rows))))
    rep = mesh.replicate(pick(0))
    assert rep.slot_wid.shape[0] == mesh.local_size
    res.update(flat(f"replicate{{k}}", mesh.all_gather(rep)))
res["gather_plain_i64"] = mesh.all_gather(
    torch.arange(mesh.local_size * 6, dtype=torch.int64).reshape(-1, 6) + 2**40 * rank).numpy()

# all_to_all of mixed dtypes in one call: rank r holds source rows r*L ..
# of whole [S_src, S_dst, ...] tensors
a2a = (ints(-9, 9, S, S, 3), torch.randn(S, S, generator=g),
       torch.randint(0, 2**40, (S, S, 2), generator=g, dtype=torch.int64),
       torch.rand(S, S, 5, generator=g) < 0.5,
       torch.randint(0, 256, (S, S), generator=g, dtype=torch.uint8))
mesh.stats.reset()
got = mesh.all_to_all(tuple(x[rows] for x in a2a))
res["a2a_calls"] = np.array([mesh.stats.exchange.calls, mesh.stats.gather.calls])
for i, (x, y) in enumerate(zip(a2a, mesh.all_gather(got))):
    res[f"a2a_whole{{i}}"], res[f"a2a{{i}}"] = x.numpy(), y.numpy()

# the gated pmax: where stays a device value, never read on the host
@contextlib.contextmanager
def no_host_reads():
    names = ("__bool__", "item", "tolist", "__int__", "__float__", "numpy")
    saved = {{n: getattr(torch.Tensor, n) for n in names}}
    def refuse(*a, **k):
        raise AssertionError("a host read inside pmax")
    for n in names:
        setattr(torch.Tensor, n, refuse)
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)

prog = ints(-5, 1000, S, S)
res["pmax_whole"] = prog.numpy()
for gate in (True, False):
    with no_host_reads():
        joined = mesh.pmax(prog[rows], where=torch.tensor(gate))
    res[f"pmax_{{gate}}"] = mesh.all_gather(joined).numpy()

# shard_topk_read over shards whose windows complete at different times:
# shard s's watermark is 20 + 10 s, so windows 2-4 are complete on some
# shards only; ok must be every shard's, not the rank's
ksh = W.KeyShards(101, S)
kspec = W.wgcounter_sharded(10, 8, S, ksh)
kst = dataclasses.replace(
    kspec.zero(S), slot_wid=torch.arange(8, dtype=torch.int32).expand(S, 8).contiguous(),
    progress=(20 + 10 * torch.arange(S, dtype=torch.int32))[:, None].expand(S, S).contiguous())
kst = dataclasses.replace(kst, windows=type(kst.windows)(
    slots=torch.randint(0, 6, kst.windows.slots.shape, generator=g).to(torch.float32)))
table = ksh.key_table()
res["topk_rows_complete"] = np.stack([W.window_value(kspec, kst, w)[1].numpy()
                                      for w in range(8)])
stack = make_data_mesh(S, "cpu")
for k in (1, 3):
    for w in range(8):
        mine = W.shard_topk_read(kspec, map_tensors(lambda x: x[rows], kst), w, table[rows],
                                 101, mesh, k=k)
        want = W.shard_topk_read(kspec, kst, w, table, 101, stack, k=k)
        for name, a, b in (("counts", mine[0][0], want[0][0]), ("keys", mine[0][1], want[0][1]),
                           ("ok", mine[1], want[1])):
            res[f"topk{{k}}.{{w}}.{{name}}"] = mesh.all_gather(a).numpy()
            res[f"topk{{k}}.{{w}}.{{name}}.stack"] = b.numpy()
if rank == 0:
    np.savez(out, **res)
dist.destroy_process_group()
print("RANK_OK", rank)
""".format(S=S, NB=NB, B=B, WIN=WIN, SLOTS=SLOTS)


def _run_ranks(tmp: Path, world: int) -> dict:
    out = tmp / "ranks.npz"
    procs, logs = start_ranks(_RANK_SCRIPT, world, tmp, out)
    join_all(procs, logs, TIMEOUT)
    return dict(np.load(out))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax") / "pipeline.npz"
    r = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(out)],
                       capture_output=True, text=True, timeout=TIMEOUT, env=env())
    assert "JAX_PIPELINE_OK" in r.stdout, f"stdout={r.stdout[-2000:]}\nstderr={r.stderr[-2000:]}"
    return dict(np.load(out))


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return _run_ranks(tmp_path_factory.mktemp("ranks4"), 4)


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    return _run_ranks(tmp_path_factory.mktemp("ranks2"), 2)


@pytest.fixture(scope="module")
def stacked():
    """The stacked run at S = 4 on the CPU, every query and sync."""
    nx = generator.NexmarkConfig(num_partitions=S, num_batches=NB, events_per_batch=B)
    log = generator.generate_log(nx, "cpu")
    mesh = M.make_data_mesh(S, "cpu")
    out = {}
    for qn, mk in stream.MAKERS.items():
        q = mk(S, window_len=WIN, num_slots=SLOTS)
        first, n = stream.read_window_range(q, NB * nx.batch_span_ms)
        for sync in ("delta", "full"):
            pipe = stream.build_pipeline(q, mesh, 4, delta_sync=sync == "delta",
                                         n_windows=n, first_window=first)
            for name, x in zip(("oks", "vals", "sync"), pipe(log)):
                out[f"{qn}.{sync}.{name}"] = x.numpy()
    return out


def test_jax_log_is_the_ports(jax_run):
    """The ranks draw their rows with the port's generator; the JAX run
    folds the JAX log: the two are one log."""
    log = event_batch_from_numpy({k: jax_run["log." + k] for k in FIELDS})
    mine = generator.generate_log(generator.NexmarkConfig(
        num_partitions=S, num_batches=NB, events_per_batch=B), "cpu")
    for f in FIELDS:
        assert torch.equal(getattr(mine, f), getattr(log, f)), f


@pytest.mark.parametrize("sync", ["delta", "full"])
@pytest.mark.parametrize("qname", sorted(stream.MAKERS))
def test_four_ranks_match_jax_shard_map(jax_run, ranks4, qname, sync):
    assert jax_run[f"{qname}.{sync}.oks"].sum() > 0
    for name in ("oks", "vals", "sync"):
        key = f"{qname}.{sync}.{name}"
        assert ranks4[key].shape == jax_run[key].shape, key
        np.testing.assert_array_equal(ranks4[key], jax_run[key], err_msg=key)


@pytest.mark.parametrize("sync", ["delta", "full"])
@pytest.mark.parametrize("qname", sorted(stream.MAKERS))
def test_two_ranks_of_two_match_the_stacked_run(ranks2, stacked, qname, sync):
    for name in ("oks", "vals", "sync"):
        key = f"{qname}.{sync}.{name}"
        np.testing.assert_array_equal(ranks2[key], stacked[key], err_msg=key)


@pytest.mark.parametrize("world", [2, 4])
def test_dist_mesh_collectives_equal_stack_mesh(ranks2, ranks4, world):
    """``all_gather`` of each rank's rows, and ``replicate`` of one state
    then gathered, equal ``StackMesh``'s on stacked f32, i64 (TopK ids),
    i32 and u8 states, byte for byte and in the same dtypes; a plain i64
    tensor above 2**32 survives the gather."""
    got = ranks2 if world == 2 else ranks4
    stack = M.make_data_mesh(S, "cpu")
    wholes = [k for k in got if k.startswith("whole")]
    assert {got[k].dtype.name for k in wholes} == {"float32", "int64", "int32", "uint8"}
    for k in wholes:
        x = torch.from_numpy(got[k])
        for tag, want in (("gather", stack.all_gather(x)), ("replicate", stack.replicate(x[0]))):
            y = got[tag + k[len("whole"):]]
            assert y.dtype == want.numpy().dtype and y.shape == tuple(want.shape), (tag, k)
            np.testing.assert_array_equal(y, want.numpy(), err_msg=f"{tag} {k}")
    L = S // world
    want = np.concatenate([np.arange(L * 6, dtype=np.int64).reshape(-1, 6) + 2**40 * r
                           for r in range(world)])
    np.testing.assert_array_equal(got["gather_plain_i64"], want)


@pytest.mark.parametrize("world", [2, 4])
def test_dist_mesh_exchange_and_pmax_equal_stack_mesh(ranks2, ranks4, world):
    """``all_to_all`` of i32, f32, i64 above 2**32, bool and u8 tensors in one
    call (one collective, no gather) and ``pmax`` with ``where`` True and
    False (never read on the host) equal ``StackMesh``'s, byte for byte."""
    got = ranks2 if world == 2 else ranks4
    stack = M.make_data_mesh(S, "cpu")
    np.testing.assert_array_equal(got["a2a_calls"], [1, 0])
    wholes = [torch.from_numpy(got[f"a2a_whole{i}"]) for i in range(5)]
    assert {str(x.dtype) for x in wholes} == {"torch.int32", "torch.float32", "torch.int64",
                                              "torch.bool", "torch.uint8"}
    for i, want in enumerate(stack.all_to_all(tuple(wholes))):
        y = got[f"a2a{i}"]
        assert y.dtype == want.numpy().dtype and y.shape == tuple(want.shape), i
        np.testing.assert_array_equal(y, want.numpy(), err_msg=f"all_to_all leaf {i}")
    prog = torch.from_numpy(got["pmax_whole"])
    for gate in (True, False):
        want = stack.pmax(prog, where=torch.tensor(gate))
        np.testing.assert_array_equal(got[f"pmax_{gate}"], want.numpy(), err_msg=str(gate))
    assert not np.array_equal(got["pmax_True"], got["pmax_False"])


@pytest.mark.parametrize("world", [2, 4])
def test_shard_topk_read_ok_is_every_ranks(ranks2, ranks4, world):
    """A window complete on one rank's shards and not on another's reads as
    not ok on every rank, as on ``StackMesh`` (JAX's ``min(all_gather(ok))``);
    ``k`` 1 and 3 give the stacked candidates too."""
    got = ranks2 if world == 2 else ranks4
    rows_complete = got["topk_rows_complete"]  # [window, shard]
    L = S // world
    per_rank = rows_complete.reshape(8, world, L).all(2)
    mixed = per_rank.any(1) & ~per_rank.all(1)
    assert mixed.sum() >= 2, rows_complete  # some rank alone would say ok
    for k in (1, 3):
        for w in range(8):
            for name in ("counts", "keys", "ok"):
                key = f"topk{k}.{w}.{name}"
                np.testing.assert_array_equal(got[key], got[key + ".stack"], err_msg=key)
            assert bool(got[f"topk{k}.{w}.ok"].all()) == bool(rows_complete[w].all())


@pytest.mark.parametrize("kw", [{"skew": 0.0}, {"skew": 1.2}, {"key_skew": 1.1}],
                         ids=["skew0", "skew1.2", "key_skew1.1"])
def test_generate_log_partition_rows_equal_the_whole_log(kw):
    cfg = generator.NexmarkConfig(num_partitions=S, num_batches=70, events_per_batch=B,
                                  seed=3, **kw)
    whole = generator.generate_log(cfg, "cpu")
    for parts in (range(0, 1), range(1, 3), range(3, 4), range(0, 4, 2)):
        part = generator.generate_log(cfg, "cpu", partitions=parts)
        for f in FIELDS:
            assert torch.equal(getattr(part, f), getattr(whole, f)[list(parts)]), (parts, f)
    with pytest.raises(ValueError, match="outside"):
        generator.generate_log(cfg, "cpu", partitions=range(3, 5))


def test_make_dist_mesh_refuses_nccl_on_a_shared_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    with M.fake_world(2):
        with pytest.raises(RuntimeError, match="one card a rank"):
            M.make_dist_mesh(4, "cuda", "nccl")


def test_make_dist_mesh_refuses_what_it_cannot_meet():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.make_dist_mesh(4, "cuda", "gloo")
    with pytest.raises(ValueError, match="NCCL"):
        M.make_dist_mesh(4, "cpu", "nccl")
    with pytest.raises(ValueError, match="gloo or nccl"):
        M.make_dist_mesh(4, "cpu", "mpi")
    with pytest.raises(RuntimeError, match="no process group"):
        M.make_dist_mesh(4, "cpu", "gloo")
    with M.fake_world(3):
        with pytest.raises(ValueError, match="do not split"):
            M.make_dist_mesh(4, "cpu", "gloo")
        with pytest.raises(ValueError, match="runs fake"):
            M.make_dist_mesh(6, "cpu", "gloo")


def test_stack_mesh_is_the_world_of_one_rank():
    mesh = M.make_data_mesh(S, "cpu")
    assert (mesh.local_size, mesh.partitions) == (S, range(S))
    out = (torch.zeros(S, 2), torch.ones(S, 2, 3), torch.zeros(S))
    assert all(a is b for a, b in zip(stream.gather_outputs(mesh, out), out))


def test_cli_backend_needs_torchrun(monkeypatch, capsys):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit):
        stream.main(["--device", "cpu", "--backend", "gloo", "--batches", "4"])
    assert "torchrun" in capsys.readouterr().err


def test_torchrun_drives_the_cli_on_two_ranks(tmp_path, capsys):
    """``torchrun --standalone`` (its own store, on a port the OS picks)
    runs the CLI one rank a process; rank 0 prints the stacked run's line
    and the ranks and backend."""
    args = ["--device", "cpu", "--query", "q4", "--partitions", "4", "--batches", "8",
            "--events-per-batch", "64", "--window-len", "10"]
    want = stream.main(args)
    line = capsys.readouterr().out.strip()
    log = tmp_path / "torchrun.log"
    with open(log, "w") as f:
        p = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "2", "-m", "repro_torch.launch.stream", *args,
             "--backend", "gloo"], stdout=f, stderr=subprocess.STDOUT, env=env(), cwd=tmp_path)
    join_all([p], [log], TIMEOUT)
    got = [ln for ln in log.read_text().splitlines() if ln.startswith("partitions=")]
    assert len(got) == 1, log.read_text()[-3000:]
    assert got[0].endswith(" ranks=2 backend=gloo")
    def timeless(ln):  # the line's tokens less its times
        return [t for t in ln.split() if not t.startswith(("wall=", "throughput="))]

    assert timeless(got[0])[:-2] == timeless(line)
    assert want["complete_windows"] > 0

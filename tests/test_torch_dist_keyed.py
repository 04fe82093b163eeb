"""The keyed dataplane across processes against the JAX package.

``build_keyed_pipeline`` over a ``DistMesh`` of gloo ranks on the CPU,
one owner group a rank, each rank drawing its own rows of the zipf(1.1)
log (``tests/_keyed_runs.py`` makes the runs, on the ranks and on a
``StackMesh`` alike).  Every step's routing stack crosses the ranks in one
``all_to_all`` and every round's progress map in one gated ``pmax``.

- 4 ranks of one shard equal, bitwise, the JAX ``node_fn`` stepped on the
  host for every device (``tests/_keyed_reference.py``): state rows,
  ``oks``, ``vals``, ``shuffle``, ``sync`` and ``prov``.  JAX's own
  ``shard_map`` run of ``build_keyed_pipeline`` is not the reference
  because it does not run on jax 0.9.0: ``compat.pvary`` raises there
  (the JAX package's ``tests/test_keyed_sharding.py`` fails the same way).
- 2 ranks of 2 shards equal the stacked run bitwise, state included.
- On both worlds, the crash-replay schedule and a healed watermark
  partition end identical to the clean run, and a plane that never heals
  emits no window; ``shard_topk_read`` at k = 3 equals the stacked read.

Ranks meet through a ``FileStore`` under the test's temporary directory;
both worlds run at once, every process joined with a timeout.
"""
import numpy as np
import pytest

from repro_torch.launch.mesh import make_data_mesh
from repro_torch.streaming.generator import generate_log
from _keyed_reference import FIELDS, jax_log, jax_reference, jax_state_np
from _keyed_runs import CHAOS_RUNS, NB, S, keyed_runs, nexmark, read_range
from _ranks import join_all, start_ranks

TIMEOUT = 240  # seconds for both groups of processes
OUTPUTS = ("oks", "vals", "shuffle", "sync")

_RANK_SCRIPT = """
import sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.launch.mesh import make_dist_mesh
from _keyed_runs import S, keyed_runs

rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                        world_size=world)
mesh = make_dist_mesh(S, "cpu", "gloo")
assert mesh.local_size == S // world
res = keyed_runs(mesh)
if rank == 0:
    np.savez(out, **res)
dist.destroy_process_group()
print("RANK_OK", rank)
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory) -> dict:
    """``{world: rank 0's gathered runs}`` for 2 and 4 ranks, run at once."""
    groups = {}
    for world in (2, 4):
        tmp = tmp_path_factory.mktemp(f"keyed{world}")
        groups[world] = (tmp / "runs.npz", *start_ranks(_RANK_SCRIPT, world, tmp,
                                                        tmp / "runs.npz"))
    join_all([p for _, ps, _ in groups.values() for p in ps],
             [x for _, _, ls in groups.values() for x in ls], TIMEOUT)
    return {world: dict(np.load(out)) for world, (out, _, _) in groups.items()}


@pytest.fixture(scope="module")
def stacked() -> dict:
    return keyed_runs(make_data_mesh(S, "cpu"))


@pytest.fixture(scope="module")
def jax_main() -> dict:
    """The JAX reference of the ``main`` run, keyed as ``keyed_runs``'."""
    _, _, arrays, _ = jax_log(S, nb=NB)
    first, n = read_range(NB)
    sched = np.tile(np.arange(NB, dtype=np.int32), (S, 1))
    states, oks, vals, shuffle, sync, prov = jax_reference(
        arrays, S, sched, np.ones(NB // 4, bool), 4, first, n)
    out = {f"main.state.{k}": np.stack([jax_state_np(st)[k] for st in states])
           for k in jax_state_np(states[0])}
    out.update({"main.oks": oks, "main.vals": vals, "main.shuffle": shuffle,
                "main.sync": sync, "main.prov": prov.astype(np.int32), "arrays": arrays})
    return out


def _state_keys(run: dict, tag: str) -> list[str]:
    keys = [k for k in run if k.startswith(f"{tag}.state.")]
    assert {"slot_wid", "progress", "folded", "errors", "windows.slots"} == {
        k[len(tag) + 7:] for k in keys}
    return keys


def test_ranks_draw_the_jax_log(jax_main):
    """The ranks draw their rows with the port's generator; the reference
    steps the JAX generator's log: the two are one log."""
    mine = generate_log(nexmark(NB), "cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(mine, f).numpy(), jax_main["arrays"][f], err_msg=f)


@pytest.mark.parametrize("name", ["state", *OUTPUTS, "prov"])
def test_four_ranks_match_the_jax_reference(ranks, jax_main, name):
    got = ranks[4]
    keys = _state_keys(got, "main") if name == "state" else [f"main.{name}"]
    for k in keys:
        assert got[k].shape == jax_main[k].shape, k
        np.testing.assert_array_equal(got[k], jax_main[k], err_msg=k)
    if name == "oks":
        _, n = read_range(NB)
        assert got[keys[0]].sum() == S * n
    if name in ("shuffle", "prov"):
        assert (got[keys[0]] > 0).all()


@pytest.mark.parametrize("name", ["state", *OUTPUTS, "prov"])
def test_two_ranks_of_two_match_the_stacked_run(ranks, stacked, name):
    got = ranks[2]
    keys = _state_keys(got, "main") if name == "state" else [f"main.{name}"]
    for k in keys:
        np.testing.assert_array_equal(got[k], stacked[k], err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
def test_a_step_is_one_exchange_and_a_round_one_gather(ranks, world):
    """The fold's collectives: one ``all_to_all`` a step (ts, local ids and
    mask in one buffer), one gather a round (the gated ``pmax``)."""
    np.testing.assert_array_equal(ranks[world]["main.collectives"], [NB, NB // 4])


@pytest.mark.parametrize("run", CHAOS_RUNS[1:])
@pytest.mark.parametrize("world", [2, 4])
def test_chaos_schedules_on_ranks(ranks, stacked, world, run):
    """The crash-replay schedule and a healed partition end identical to
    the clean run (state, windows and values; the stacked clean run too);
    a plane that never heals emits no window."""
    got = ranks[world]
    if run == "never healed":
        assert got[f"{run}.oks"].sum() == 0
        assert got["clean.oks"].sum() > 0
        np.testing.assert_array_equal(got[f"{run}.oks"], stacked[f"{run}.oks"])
        return
    keys = [k[len("clean."):] for k in _state_keys(got, "clean")] + ["oks", "vals"]
    for k in keys:
        np.testing.assert_array_equal(got[f"{run}.{k}"], got[f"clean.{k}"], err_msg=k)
        np.testing.assert_array_equal(got[f"clean.{k}"], stacked[f"clean.{k}"], err_msg=k)
    if run == "partition healed":  # 4 of 6 rounds exchanged the [S] i32 map
        assert (got[f"{run}.sync"] == 4 * S * 4.0).all()


@pytest.mark.parametrize("world", [2, 4])
def test_topk_k3_on_ranks_equals_the_stacked_read(ranks, stacked, world):
    keys = [k for k in stacked if k.startswith("topk3.")]
    assert len(keys) == 3 * read_range(NB)[1]
    for k in keys:
        np.testing.assert_array_equal(ranks[world][k], stacked[k], err_msg=k)
    assert any(stacked[k].all() for k in keys if k.endswith(".ok"))

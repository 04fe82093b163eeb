"""Ranks of a run across processes on the CPU (gloo), for the tests: each
rank is a process started by ``multiprocessing``'s spawn, runs
``bench.run`` as ``run.py`` does, and rank 0 hands its result back."""
import multiprocessing as mp
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
TIMEOUT_S = 240


def _rank(rank, world, init, root, name, scale, seed, trace, fault, control_seeds, queue):
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from holonbench import bench
    from holonbench.cell import find_cell

    if fault is not None:
        import importlib

        mod, fn = fault.rsplit(":", 1)
        getattr(importlib.import_module(mod), fn)()
    opt = bench.Options(seed=seed, seconds=0.5, trace=trace, rank=rank, world=world,
                        init_method=init, backend="gloo", device="cpu", scale=scale)
    if control_seeds:
        from holonbench import control

        result = control.readings(find_cell(name, root), control_seeds, opt)
    else:
        result = bench.run(find_cell(name, root), opt)
    if rank == 0:
        queue.put(result)


def run_ranks(root: Path, name: str, scale: dict, world: int, seed: int, trace: bool = False,
              fault: str | None = None, control_seeds: tuple = ()):
    """Rank 0's result of ``world`` ranks running the cell ``name`` of the
    checkout ``root``; ``fault`` (``module:function``)
    is called in every rank before its run, to break the timed path; with
    ``control_seeds``, ``control.readings`` of those seeds instead of a run."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{tmp}/store"
        procs = [ctx.Process(target=_rank, args=(r, world, init, root, name, scale, seed,
                                                 trace, fault, control_seeds, queue)) for r in range(world)]
        for p in procs:
            p.start()
        try:
            result = queue.get(timeout=TIMEOUT_S)
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return result

"""Time the dense fold step's ring bookkeeping on the card, at the dense
benchmark deployment's shape (16 partitions of 16,384 events a batch,
625,000 events/s, 10 s windows sliding by 5 s, a 64-slot ring, 10,000 zipf
auction ids): the one launch (``ops.ring_insert``) and its plain version on
the card (their kernels' device time under ``torch.profiler``, over many
calls: the host takes longer to dispatch a call than the card to run it, so
CUDA events would time the host), one dispatcher call's host time, and a
whole q5 fold step on ``W.insert`` and on ``W.insert(owned=True)`` (the sum of
its kernels' device time, and the wall time of the eager loop).  The
launches are timed on a state whose tenants already hold the batch's
windows, as at most steps (a slot advances about once in 190 steps).

  PYTHONPATH=src python scripts/ring_insert_time.py
"""
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels import build, ops, ref
from repro_torch.launch.stream import MAKERS
from repro_torch.streaming.generator import NexmarkConfig, generate_log

S, B, STEPS = 16, 16384, 40


def device_us(fn, n: int, name: str = "") -> float:
    """Mean device time a call of the kernels whose name holds ``name``."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(k.self_device_time_total for k in prof.key_averages()
               if k.device_type == DeviceType.CUDA and name in k.key) / n


def wall_us(fn, n: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t * 1e6 / n


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), torch.__version__)
    build.build(ops.SOURCES)
    dev = torch.device("cuda", 0)
    log = generate_log(NexmarkConfig(num_partitions=S, num_batches=STEPS + 1, events_per_batch=B,
                                     rate_per_partition=625_000.0, num_auctions=10_000,
                                     key_skew=1.1), dev)
    q = MAKERS["q5"](S, window_len=10_000, num_slots=64, num_auctions=10_000)
    spec = q.shared_specs[0]
    part = torch.arange(S, device=dev)
    shared, local = q.init_shared(dev), q.init_local(dev)
    for i in range(STEPS):
        shared, local = q.fold(shared, local, log.batch(i), part, batch_idx=i, owned=True)
    (st,) = shared
    batch = log.batch(STEPS)
    mask = batch.valid & (batch.kind == 2)
    args = (batch.ts, mask, part, STEPS, st.slot_wid, st.progress, st.folded, st.errors,
            [st.windows.slots], [0.0], spec.assigner.hop, spec.assigner.window_len)
    ref_args = (*args[:3], torch.full((S,), STEPS, dtype=torch.int64, device=dev), *args[4:])
    launch = lambda: ops.ring_insert(*args)  # noqa: E731
    advancing = int((launch()[2] > st.slot_wid).sum())
    print(f"ring_insert at S={S} B={B} K=2 W=64: {advancing} slots advance")
    print(f"  kernel us {device_us(launch, 500, 'ring_insert_kernel'):.4f}")
    plain = lambda: ref.ring_insert_ref(*ref_args)  # noqa: E731
    print(f"  plain version on the card us {device_us(plain, 100):.4f}")
    print(f"  host us a dispatcher call {wall_us(launch, 2000):.2f}")
    for owned in (False, True):
        step = lambda: q.fold(shared, local, batch, part, batch_idx=STEPS, owned=owned)  # noqa
        print(f"q5 fold step on insert, owned={owned}: device us "
              f"{device_us(step, 50):.2f}, wall us {wall_us(step, 100):.2f}")


if __name__ == "__main__":
    main()

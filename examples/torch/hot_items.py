"""Nexmark Q5 "hot items" over an overlapping sliding window, on the PyTorch
port — the workload tumbling windows cannot express (a burst straddling a
window edge is split and missed; the hopping window sees it whole).

Runs the same query on BOTH deployment paths and checks them against the
plain-torch oracle:

  * the discrete-event Holon runtime (decentralized coordination), and
  * the dense dataplane (``build_pipeline``), its partitions stacked
    on one device (``--partitions``, the stand-in for one device each),

then prints the hottest auction bucket per sliding window.

Run: PYTHONPATH=src python examples/torch/hot_items.py [--device cpu]
"""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batches", type=int, default=100)
    ap.add_argument("--window-len", type=int, default=1000)
    ap.add_argument("--hop", type=int, default=500,
                    help="window start spacing; each event lives in "
                         "window_len/hop overlapping windows")
    ap.add_argument("--partitions", type=int, default=4,
                    help="partitions of the dataplane, stacked on the one device")
    ap.add_argument("--device", default="cuda",
                    help="where the state lives; 'cpu' runs the kernels' plain versions")
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.launch.stream import build_pipeline, read_window_range
    from repro_torch.runtime import SimConfig, run_holon
    from repro_torch.streaming.generator import NexmarkConfig, generate_log
    from repro_torch.streaming.queries import make_q5

    mesh = make_data_mesh(args.partitions, args.device)
    cfg = SimConfig(num_nodes=3, num_partitions=6, num_batches=args.batches,
                    window_len=args.window_len)
    q = make_q5(cfg.num_partitions, window_len=args.window_len,
                num_slots=cfg.num_slots, hop=args.hop)
    a = q.assigner
    print(f"Q5 hot items: window={a.window_len} hop={a.hop} "
          f"({a.windows_per_event} windows per event)")

    # --- discrete-event runtime ------------------------------------------
    consumer = run_holon(cfg, q, device=mesh.device)
    nx = NexmarkConfig(num_partitions=cfg.num_partitions, num_batches=cfg.num_batches,
                       events_per_batch=cfg.events_per_batch,
                       rate_per_partition=cfg.rate_per_partition, seed=cfg.seed)
    log = generate_log(nx, mesh.device)
    wids = sorted({w for (_, w) in consumer.records})
    oracle = {w: q.oracle(log, w).cpu().numpy() for w in wids}  # one eval per wid
    for (pid, w), rec in sorted(consumer.records.items()):
        np.testing.assert_array_equal(rec.value, oracle[w])
    print(f"runtime: {len(consumer.records)} window emissions across "
          f"{len(wids)} sliding windows — all byte-identical to the oracle")
    for w in wids[:5]:
        count, bucket = consumer.records[(0, w)].value
        print(f"  window [{a.start_ts(w)}, {a.end_ts(w)}): "
              f"hottest auction bucket {int(bucket)} with {int(count)} bids")

    # --- dense dataplane, partitions stacked on the device -----------------
    S = mesh.size
    dnx = NexmarkConfig(num_partitions=S, num_batches=32, events_per_batch=1024)
    dlog = generate_log(dnx, mesh.device)
    dq = make_q5(S, window_len=args.window_len, num_slots=64, hop=args.hop)
    first, n_windows = read_window_range(dq, 32 * dnx.batch_span_ms)
    oks, vals, sync_bytes = build_pipeline(dq, mesh, sync_every=4, n_windows=n_windows,
                                           first_window=first)(dlog)
    oks, vals = oks.cpu().numpy(), vals.cpu().numpy()
    done = int(oks[0].sum())
    for i in range(n_windows):
        if oks[0, i]:
            np.testing.assert_array_equal(vals[0, i], dq.oracle(dlog, first + i).cpu().numpy())
    print(f"dataplane: {done} complete sliding windows on {S} stacked partition(s), "
          f"byte-identical to the oracle; "
          f"sync bytes/device = {float(sync_bytes.sum()):.0f}")


if __name__ == "__main__":
    main()

"""Figure-6-style demo on the PyTorch port: inject two concurrent node
failures and watch the decentralized runtime steal the orphaned partitions
and catch up, vs the centralized baseline's global stop-restore-replay.

The network fabric (docs/protocol.md §4) can misbehave too:

  --loss 0.1           drop 10% of gossip/shuffle messages
  --partition 8000:16000   split the cluster in half for that window

Run: PYTHONPATH=src python examples/torch/failure_recovery_demo.py [--device cpu]
     PYTHONPATH=src python examples/torch/failure_recovery_demo.py --loss 0.1
     PYTHONPATH=src python examples/torch/failure_recovery_demo.py \
         --no-crash --partition 8000:16000
"""
import argparse
import dataclasses


def parse_partition(spec: str) -> tuple[float, float]:
    try:
        t0, t1 = (float(x) for x in spec.split(":"))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--partition wants 'T0:T1' in ms, got {spec!r}"
        ) from None
    if not t0 < t1:
        raise argparse.ArgumentTypeError("--partition needs T0 < T1")
    return t0, t1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batches", type=int, default=300)
    ap.add_argument("--loss", type=float, default=0.0,
                    help="gossip/shuffle message-loss probability (0..1)")
    ap.add_argument("--partition", type=parse_partition, default=None,
                    metavar="T0:T1",
                    help="2-way network split from T0 to T1 (simulated ms)")
    ap.add_argument("--no-crash", action="store_true",
                    help="skip the node crashes (fabric faults only)")
    ap.add_argument("--device", default="cuda",
                    help="where each node's state lives; 'cpu' runs the kernels' plain versions")
    args = ap.parse_args(argv)

    from repro_torch.runtime import FailureScenario, SimConfig, as_scenario, run_flink, run_holon
    from repro_torch.streaming.queries import make_q7

    cfg = SimConfig(num_batches=args.batches, net_loss=args.loss)
    q = make_q7(cfg.num_partitions, window_len=cfg.window_len, num_slots=cfg.num_slots)

    scen = as_scenario(None if args.no_crash else FailureScenario.concurrent(t=8000.0))
    scen = dataclasses.replace(scen, name="chaos-demo")
    what = [] if args.no_crash else ["two nodes fail at t=8s, restart at t=18s"]
    if args.partition:
        t0, t1 = args.partition
        members = cfg.initial_membership
        half = len(members) // 2
        scen = scen.partition(t0, members[:half], members[half:]).heal(t1)
        what.append(f"2-way partition {t0 / 1e3:g}s..{t1 / 1e3:g}s")
    if args.loss:
        what.append(f"{args.loss:.0%} message loss")
    print("; ".join(what) or "failure-free baseline", "\n")

    for name, runner in (("HOLON (decentralized)", run_holon),
                         ("FLINK-like (centralized)", run_flink)):
        c = runner(cfg, q, scen, horizon_ms=cfg.horizon_ms + 20_000, device=args.device)
        t, lat = c.latency_series()
        print(f"--- {name} ---")
        for lo in range(0, 32000, 4000):
            m = (t >= lo) & (t < lo + 4000)
            if m.sum():
                bar = "#" * min(60, int(lat[m].mean() / 50))
                print(f"  t={lo//1000:3d}-{lo//1000+4:<3d}s avg={lat[m].mean():7.0f} ms {bar}")
        s = c.latency_stats()
        dropped = sum(st["dropped"] for st in c.net_stats.values())
        print(f"  avg={s['avg']:.0f} ms  p99={s['p99']:.0f} ms  "
              f"dropped_msgs={dropped}\n")


if __name__ == "__main__":
    main()

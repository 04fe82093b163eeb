"""Run the Nexmark Q7 (highest bids) global aggregation on the decentralized
Holon runtime of the PyTorch port, verify outputs against the oracle, and
print latency stats.

Run: PYTHONPATH=src python examples/torch/nexmark_stream.py [--device cpu]
"""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batches", type=int, default=150)
    ap.add_argument("--device", default="cuda",
                    help="where each node's state lives; 'cpu' runs the kernels' plain versions")
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch.runtime import SimConfig, run_holon
    from repro_torch.streaming.generator import NexmarkConfig, generate_log
    from repro_torch.streaming.queries import make_q7

    cfg = SimConfig(num_nodes=5, num_partitions=10, num_batches=args.batches)
    q = make_q7(cfg.num_partitions, window_len=cfg.window_len, num_slots=cfg.num_slots)

    print(f"running Q7 on {cfg.num_nodes} nodes / {cfg.num_partitions} partitions ...")
    consumer = run_holon(cfg, q, device=args.device)
    stats = consumer.latency_stats()
    print(f"windows emitted: {stats['n']}  avg latency: {stats['avg']:.0f} ms  "
          f"p99: {stats['p99']:.0f} ms")

    # verify a few windows against the global oracle
    nx = NexmarkConfig(num_partitions=cfg.num_partitions, num_batches=cfg.num_batches,
                       events_per_batch=cfg.events_per_batch,
                       rate_per_partition=cfg.rate_per_partition, seed=cfg.seed)
    log = generate_log(nx, args.device)
    emitted = sorted({w for (p, w) in consumer.records if p == 0})
    assert emitted, "run too short to complete any window; raise --batches"
    checked = [w for w in (0, 3, 7) if w in emitted] or emitted[:1]
    for w in checked:
        rec = consumer.records[(0, w)]
        ov = q.oracle(log, w)[0].cpu().numpy()
        ok = np.allclose(rec.value[:8], ov, rtol=1e-5)
        top = ", ".join(f"{v:.0f}" for v in ov[:3])
        print(f"window {w}: top bids [{top} ...]  oracle match: {ok}")
        assert ok
    print("exactly-once outputs verified against the oracle")


if __name__ == "__main__":
    main()

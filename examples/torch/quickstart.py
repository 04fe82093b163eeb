"""Quickstart: the paper's running example (Query 1, Listing 2), on the
PyTorch port.

Ratio of bids processed per partition relative to the GLOBAL number of bids,
per tumbling window — a global aggregation with NO shuffle: a Windowed
GCounter replica per partition, lattice merges as "background sync", reads
gated by the global watermark so every partition emits the SAME ratio
denominator deterministically.

Run: PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""
import argparse

P = 3            # partitions
WINDOW = 10      # tumbling window length (timestamp units)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="where the replicas live; 'cpu' runs the kernels' plain versions")
    args = ap.parse_args(argv)
    import torch

    from repro_torch.core import wcrdt as W
    from repro_torch.launch.mesh import make_data_mesh

    dev = make_data_mesh(1, args.device).device
    # totalCount = WCRDT { zero: GCounter }      (Listing 2, line 2)
    spec = W.wgcounter(window_len=WINDOW, num_slots=8, num_partitions=P)

    # each partition processes its own bid stream into its own replica
    replicas, local_counts, events = [], [], {
        0: [1, 4, 8, 13, 17, 22],
        1: [2, 5, 11, 14, 21],
        2: [3, 9, 12, 19, 23],
    }
    for p in range(P):
        ts = torch.tensor([events[p]], dtype=torch.int32, device=dev)
        s = spec.zero(1, dev)
        s = W.insert(spec, s, p, ts, torch.ones_like(ts, dtype=torch.bool),
                     actor=p, amounts=torch.ones(ts.shape, device=dev))  # insert(1, ts)
        s = W.increment_watermark(spec, s, p, ts.amax(1))                # incrementWatermark
        replicas.append(s)
        local_counts.append({w: sum(1 for t in events[p] if w*WINDOW <= t < (w+1)*WINDOW)
                             for w in range(3)})

    # background sync: lattice merges in ANY order converge (CRDT!)
    merged = replicas[0]
    for s in replicas[1:]:
        merged = W.merge(spec, merged, s)

    gwm = int(W.global_watermark(spec, merged)[0])
    print(f"global watermark = {gwm}")
    for w in range(3):
        total, ok = W.window_value(spec, merged, w)                      # getWindowValue
        if not bool(ok[0]):
            print(f"window {w}: not complete yet (safe mode would block)")
            continue
        print(f"window {w}: global bids = {float(total[0]):.0f}")
        for p in range(P):
            ratio = local_counts[p][w] / float(total[0])
            print(f"  partition {p}: localCount/total = {ratio:.3f}")  # emit <ratio>


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Does torch's f32 sum over a middle axis give the same bits on the card
as on the host, and does the port's actor-row read?

  python3 scripts/sum_order.py

For ``[S, P, C]`` tensors of random f32 (S in 1, 16; P actor rows from 2
to 16; C in 1, 5, 64, 1,024), 20 draws each: how many draws give other
bits on the card than on the host for ``x.sum(1)``, and for
``core/crdt.py::_actor_sum`` (the fixed pairwise tree a GCounter read
uses).  Prints the card's name and power limit, then one JSON line: every
shape where either differs.  Needs an NVIDIA card.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> int:
    if not torch.cuda.is_available():
        print("sum_order: needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.core.crdt import _actor_sum

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    rng = np.random.default_rng(0)
    differs = {}
    for S in (1, 16):
        for P in range(2, 17):
            for C in (1, 5, 64, 1024):
                n_sum = n_tree = 0
                for _ in range(20):
                    x = (rng.random((S, P, C)) * 1000).astype(np.float32)
                    x *= rng.random((S, P, C)) < 0.8
                    host, card = torch.from_numpy(x), torch.from_numpy(x).cuda()
                    n_sum += not torch.equal(host.sum(1), card.sum(1).cpu())
                    n_tree += not torch.equal(_actor_sum(host), _actor_sum(card).cpu())
                if n_sum or n_tree:
                    differs[f"S={S} P={P} C={C}"] = {"sum": n_sum, "actor_sum": n_tree}
    print(json.dumps({"draws_differing_of_20": differs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

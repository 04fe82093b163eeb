"""Plain reference of Nexmark q5, hot items: the auction with the most bids
in each sliding window, ties to the lowest auction id.

Works from the log's tensors alone (the fields the benchmark drew and handed
to the program), in plain torch: which windows close within the batches
folded, the bid count of every auction id in each window, and the hottest
id.  It imports nothing of the program.  A rank of a run across cards
counts its own rows (:func:`partial`); the harness sums the counts and takes
the least watermark over the ranks, then :func:`finish` reads the windows.
"""
from __future__ import annotations

import torch

KIND_BID = 2


def partial(fields: dict, *, batch_span_ms: float, folded: int, first: int, n: int,
            window_len: int, hop: int, num_keys: int, dtype=torch.int64):
    """This process's rows: ``(counts [n, num_keys], watermark)``.

    ``counts[j, k]`` is the bids of auction ``k`` with ``ts`` in window
    ``first + j``, ``[w * hop, w * hop + window_len)``, over batches ``0 ..
    folded - 1``; ``watermark`` the least, over the rows, of a row's largest
    valid ``ts`` in those batches.  With ``dtype`` ``torch.bfloat16`` each
    batch's counts are added into bf16 counters (the lower precision of the
    control); otherwise counts are exact integers."""
    ts, kind, auction, valid = (fields[f] for f in ("ts", "kind", "auction", "valid"))
    dev = ts.device
    if int(auction.max()) >= num_keys or int(auction.min()) < 0:
        raise ValueError(f"auction ids outside [0, {num_keys})")
    bid = valid & (kind == KIND_BID)
    counts = torch.zeros((n, num_keys), dtype=dtype, device=dev)
    for j in range(n):
        start = (first + j) * hop
        end = start + window_len
        lo = max(0, int(start // batch_span_ms) - 1)
        hi = min(folded, int(end // batch_span_ms) + 2)
        for b in range(lo, hi):
            t = ts[:, b]
            m = bid[:, b] & (t >= start) & (t < end)
            c = torch.bincount(auction[:, b][m], minlength=num_keys)
            counts[j] += c.to(dtype)
    low = torch.iinfo(torch.int32).min
    wm = torch.where(valid[:, :folded], ts[:, :folded], low).amax((1, 2)).amin()
    return counts, int(wm)


def finish(counts: torch.Tensor, watermark: int, *, first: int, window_len: int, hop: int):
    """``(ok bool[n], vals f32[n, 2])``: window ``first + j`` is complete
    once ``watermark`` reaches its end; ``vals[j]`` is ``[count,
    auction_id]`` of its hottest auction (``torch.argmax`` gives the first
    of equal counts: the lowest id)."""
    n = counts.shape[0]
    ends = (first + torch.arange(n)) * hop + window_len
    ok = watermark >= ends
    hot = counts.argmax(1)
    top = counts.gather(1, hot[:, None])[:, 0]
    vals = torch.stack([top.to(torch.float32), hot.to(torch.float32)], 1)
    return ok.to(counts.device), vals

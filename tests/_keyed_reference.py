"""The keyed dataplane's reference from the JAX package, shared by
``test_torch_keyed.py`` (one process, ``StackMesh``) and
``test_torch_dist_keyed.py`` (ranks over gloo).

The JAX ``build_keyed_pipeline`` does not run on jax 0.9 (its
``compat.pvary`` of the key table raises), so :func:`jax_reference` steps
its ``node_fn`` on the host for every device with the JAX parts that do
run.  The log is the JAX generator's zipf(1.1) log.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import wcrdt as JW
from repro.core import window as jwin
from repro.streaming import events as jev
from repro.streaming import generator as jgen
from repro_torch.convert import event_batch_from_numpy
from _keyed_runs import C, EPB, NB, SLOTS, WL

FIELDS = [f.name for f in dataclasses.fields(jev.EventBatch)]


def jax_state_np(st) -> dict:
    d = {k: np.asarray(getattr(st, k)) for k in ("slot_wid", "progress", "folded", "errors")}
    d.update({f"windows.{f.name}": np.asarray(getattr(st.windows, f.name))
              for f in dataclasses.fields(st.windows)})
    return d


def jax_log(S, nb=NB, epb=EPB, num_auctions=C, seed=0):
    cfg = jgen.NexmarkConfig(num_partitions=S, num_batches=nb, events_per_batch=epb,
                             num_auctions=num_auctions, key_skew=1.1, seed=seed)
    jlog = jgen.generate_log(cfg)
    arrays = {k: np.asarray(getattr(jlog, k)) for k in FIELDS}
    return cfg, jlog, arrays, event_batch_from_numpy(arrays)


def read_range(cfg, nb):
    a = jwin.as_assigner(WL, WL // 2)
    closed = int(a.first_dirty_wid(nb * cfg.batch_span_ms))
    n = min(closed, 4)
    return a, max(0, closed - n), n


def jax_reference(arrays, S, sched, wm_sync, sync_every, first, n):
    """The JAX ``node_fn`` of ``build_keyed_pipeline``, stepped on the host
    for every device: ``(states, oks, vals, shuffle, sync, prov)``."""
    jsh = JW.KeyShards(C, S)
    spec = JW.wgcounter_sharded(WL, SLOTS, S, jsh, assigner=jwin.as_assigner(WL, WL // 2))
    ins = jax.jit(lambda st, p, ts, m, bi, loc: JW.insert(
        spec, st, p, ts, m, batch_idx=bi, amounts=jnp.ones(ts.shape, jnp.float32), keys=loc))
    inc = jax.jit(lambda st, me, wm: JW.increment_watermark(spec, st, me, wm))
    states = [spec.zero() for _ in range(S)]
    shuffle = np.zeros(S, np.float32)
    sync = np.zeros(S, np.float32)
    prov = np.full((S, S), -(2**31), np.int64)
    B = arrays["ts"].shape[2]
    src = np.repeat(np.arange(S, dtype=np.int32), B)
    for r in range(sched.shape[1] // sync_every):
        for t in range(r * sync_every, (r + 1) * sync_every):
            bt = {f: arrays[f][np.arange(S), sched[:, t]] for f in FIELDS}
            bid = bt["valid"] & (bt["kind"] == jev.KIND_BID)
            owner = np.asarray(jsh.shard_of(jnp.asarray(bt["auction"])))
            local = np.asarray(jsh.local_of(jnp.asarray(bt["auction"])))
            bi = np.repeat(sched[:, t], B).astype(np.int32)
            for me in range(S):
                m = bid & (owner == me)  # [S_src, B]: the lanes routed to me
                states[me] = ins(states[me], jnp.asarray(src), jnp.asarray(bt["ts"].reshape(-1)),
                                 jnp.asarray(m.reshape(-1)), jnp.asarray(bi),
                                 jnp.asarray(local.reshape(-1)))
                sent = int((bid[me] & (owner[me] != me)).sum())
                shuffle[me] = shuffle[me] + np.float32(sent) * np.float32(8.0)
                for s in range(S):
                    if m[s].any():
                        prov[me, s] = max(prov[me, s], int(bt["ts"][s][m[s]].max()))
                wm = int(jgen.batch_watermark(jev.EventBatch(*(jnp.asarray(bt[f][me]) for f in FIELDS))))
                states[me] = inc(states[me], me, wm)
        if wm_sync[r]:
            pm = np.max([np.asarray(st.progress) for st in states], 0)
            states = [dataclasses.replace(st, progress=jnp.asarray(pm)) for st in states]
            sync = sync + np.float32(S * 4)
    stacked = jax.tree.map(lambda *x: jnp.stack(x), *states)
    table = jnp.asarray(jsh.key_table())
    oks, vals = [], []
    for w in range(first, first + n):
        read = jax.vmap(lambda st, row: JW.shard_topk_read(spec, st, w, row, C, "data", k=1),
                        axis_name="data")
        (cnt, key), ok = read(stacked, table)
        oks.append(np.asarray(ok).astype(np.float32))
        vals.append(np.stack([np.asarray(cnt[:, 0]), np.asarray(key[:, 0]).astype(np.float32)], -1))
    return states, np.stack(oks, 1), np.stack(vals, 1), shuffle, sync, prov

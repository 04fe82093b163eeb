"""WCRDT-backed training metrics (port of ``repro.training.metrics``,
DESIGN.md §4).

Training is an infinite stream of steps partitioned over data-parallel
workers.  Global metric aggregation (mean loss, token throughput, max grad
norm) is a global aggregation over that stream, the paper's problem.  Every
worker owns a replica of a windowed metric lattice:

  * window      = ``window_len`` consecutive steps ("timestamp" = step id),
  * loss_sum /
    token_count = windowed grow-only counters (per-worker slots, max-merged),
  * grad_norm   = windowed max-register,
  * progress    = per-worker step watermark.

A metric window is readable exactly when the global watermark (min worker
step) passes it, and then every worker reads the same, final value.

States are stacked, as everywhere in the port: ``metrics_init`` gives
``replicas`` rows (one by default), and ``metrics_fold`` folds one step into
each row, as the worker given for that row.  With one row a worker, one
call folds every worker's step: each counter's fold is one ``window_agg``
launch of one lane a replica (``L = 1``, ``C = 1``).  ``metrics_axis_join``
joins the rows over a :class:`~repro_torch.launch.mesh.StackMesh`, the
port's stand-in for the JAX package's ``axis_name``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import wcrdt as W
from repro_torch.core.crdt import _per_replica
from repro_torch.core.wcrdt import WSpec, WState
from repro_torch.launch.mesh import StackMesh, make_data_mesh


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    num_workers: int
    window_len: int = 10  # steps per metric window
    num_slots: int = 8

    def specs(self) -> dict[str, WSpec]:
        return {
            "loss_sum": W.wgcounter(self.window_len, self.num_slots, self.num_workers),
            "tokens": W.wgcounter(self.window_len, self.num_slots, self.num_workers),
            "gnorm_max": W.wmaxreg(self.window_len, self.num_slots, self.num_workers),
        }


def metrics_init(spec: MetricSpec, device="cuda", replicas: int = 1) -> dict[str, WState]:
    """``replicas`` zero replicas on ``device``: the card unless the caller
    asks for the CPU; raises for a CUDA device when no card is present."""
    dev = make_data_mesh(replicas, device).device
    return {k: s.zero(replicas, dev) for k, s in spec.specs().items()}


def _per_row(x, S: int, dtype: torch.dtype, device) -> torch.Tensor:
    """A scalar for every row, or one value a row, as ``[S, 1]`` lanes."""
    return torch.as_tensor(x, dtype=dtype, device=device).reshape(-1).expand(S).reshape(S, 1)


def metrics_fold(
    spec: MetricSpec,
    state: dict[str, WState],
    worker,
    step,
    loss,
    n_tokens,
    grad_norm,
) -> dict[str, WState]:
    """Fold one step's local metrics into each replica as ``worker`` (an
    int, or ``[S]`` one a row) and advance that worker's watermark.
    ``step``, ``loss``, ``n_tokens`` and ``grad_norm`` are scalars or one
    value a row."""
    specs = spec.specs()
    slot_wid = state["loss_sum"].slot_wid
    S, dev = slot_wid.shape[0], slot_wid.device
    worker = _per_replica(worker, S, dev)
    ts = _per_row(step, S, torch.int32, dev)
    one = torch.ones((S, 1), dtype=torch.bool, device=dev)
    out = dict(state)
    out["loss_sum"] = W.insert(
        specs["loss_sum"], state["loss_sum"], worker, ts, one,
        actor=worker, amounts=_per_row(loss, S, torch.float32, dev),
    )
    out["tokens"] = W.insert(
        specs["tokens"], state["tokens"], worker, ts, one,
        actor=worker, amounts=_per_row(n_tokens, S, torch.float32, dev),
    )
    out["gnorm_max"] = W.insert(
        specs["gnorm_max"], state["gnorm_max"], worker, ts, one,
        vals=_per_row(grad_norm, S, torch.float32, dev),
    )
    # watermark: this worker will never again contribute to steps <= step
    nxt = ts[:, 0] + 1
    for k in out:
        out[k] = W.increment_watermark(specs[k], out[k], worker, nxt)
    return out


def metrics_merge(spec: MetricSpec, a: dict[str, WState], b: dict[str, WState]):
    specs = spec.specs()
    return {k: W.merge(specs[k], a[k], b[k]) for k in a}


def metrics_axis_join(spec: MetricSpec, state: dict[str, WState], mesh: StackMesh):
    """Join every row of a stacked state and hand the join back to each row.
    Step windows are lockstep across workers, so the aligned path joins each
    field by its reduce over the stack (no gather buffer)."""
    specs = spec.specs()
    return {k: W.axis_join_aligned(specs[k], state[k], mesh) for k in state}


def metrics_read(spec: MetricSpec, state: dict[str, WState], window: int):
    """Read a completed metric window on every row: ``(dict, ok)``, each
    ``[S]``.  Deterministic across workers once ``ok`` is True."""
    specs = spec.specs()
    loss_sum, ok1 = W.window_value(specs["loss_sum"], state["loss_sum"], window)
    tokens, ok2 = W.window_value(specs["tokens"], state["tokens"], window)
    gmax, ok3 = W.window_value(specs["gnorm_max"], state["gnorm_max"], window)
    steps = spec.window_len * spec.num_workers
    out = {
        "mean_loss": loss_sum / max(steps, 1),
        "tokens": tokens,
        "grad_norm_max": gmax,
    }
    return out, ok1 & ok2 & ok3

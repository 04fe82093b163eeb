"""Faults planted under the timed path, each a function that patches the
program in the calling process (the tests call them in a ``monkeypatch``
scope, or first thing in a spawned rank).  A sound check reads each as not
correct."""
import torch

from repro_torch.core import wcrdt as W
from repro_torch.launch import mesh as M

_insert, _delta_axis_join, _window_value = W.insert, W.delta_axis_join, W.window_value
_stack_a2a, _dist_a2a = M.StackMesh.all_to_all, M.DistMesh.all_to_all


def state_unchanged():
    """A fold step that returns its state unchanged."""
    W.insert = lambda spec, state, *a, **k: state


def half_batch():
    """Half of each batch left out: every other lane masked."""
    def insert(spec, state, partition, ts, mask, *a, **k):
        keep = torch.arange(mask.shape[-1], device=mask.device) % 2 == 0
        return _insert(spec, state, partition, ts, mask & keep, *a, **k)

    W.insert = insert


def exchange_left_out():
    """No exchange between the partitions: the keyed routing stack stays
    where it was made (no transpose, no collective), and the dense sync
    round joins nothing into a replica."""
    M.StackMesh.all_to_all = lambda self, state: state
    M.DistMesh.all_to_all = lambda self, state: state
    W.delta_axis_join = lambda spec, state, bf, bp, mesh: (state, W.state_nbytes(state) * 0)


def cold_keys_dropped():
    """A fault away from the hot key: on one state row (the process's last
    replica or owner shard), the lanes of odd key ids left out.  Auction 0,
    the hottest, keeps every bid on every row (the keyed hash maps it to
    shard 0, local 0), so every window's hot item still reads right."""
    def insert(spec, state, partition, ts, mask, *a, keys=None, **k):
        keep = torch.ones_like(mask)
        keep[-1] = keys[-1] % 2 == 0
        return _insert(spec, state, partition, ts, mask & keep, *a, keys=keys, **k)

    W.insert = insert


def answer_altered():
    """Every window's value altered where it is read: one more count."""
    def window_value(spec, state, wid):
        v, ok = _window_value(spec, state, wid)
        return (v + 1 if torch.is_tensor(v) else v), ok

    W.window_value = window_value


def restore():
    W.insert, W.delta_axis_join, W.window_value = _insert, _delta_axis_join, _window_value
    M.StackMesh.all_to_all, M.DistMesh.all_to_all = _stack_a2a, _dist_a2a

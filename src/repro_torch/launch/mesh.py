"""Collectives over the stacked partition axis (the port's ``data`` mesh).

In the JAX package each partition is one device of the ``data`` mesh axis.
In the port each of ``S`` partitions is a row of a leading stacked axis on
one device, and these collectives act on that axis: ``all_gather`` is the
identity on the stack, ``pmax`` is ``amax(0)`` broadcast back to every row.
The dataplane reaches replicas only through this interface, so a
multi-device version can take its place without touching the dataplane.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.lattice import map_tensors


@dataclasses.dataclass(frozen=True)
class StackMesh:
    """``size`` partitions stacked on ``device``."""

    size: int
    device: torch.device

    def all_gather(self, state):
        """Every replica's view of all replicas: the stack itself."""
        return state

    def replicate(self, state):
        """Hand one (unstacked) state to every replica: ``[S, ...]`` copies."""
        return map_tensors(lambda x: x.unsqueeze(0).expand(self.size, *x.shape).contiguous(), state)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise max over the replicas, broadcast back to each."""
        return self.replicate(x.amax(0))


def make_data_mesh(num_partitions: int, device="cuda") -> StackMesh:
    """A stacked mesh of ``num_partitions`` replicas on ``device``.

    Raises if ``device`` is a CUDA device and no card is present: the
    dataplane does not carry on on the CPU unless it is asked to."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return StackMesh(num_partitions, device)

"""Collectives over the stacked partition axis (the port's ``data`` mesh).

In the JAX package each partition is one device of the ``data`` mesh axis.
In the port each of ``S`` partitions is a row of a leading stacked axis.
:class:`StackMesh` holds every row on one device, and its collectives act
on that axis: ``all_gather`` is the identity on the stack, ``pmax`` is the
replica-stack join broadcast back to every row (one ``crdt_merge`` launch,
optionally gated), and ``all_to_all`` is a ``[S_src, S_dst, ...]``
transpose.  :class:`DistMesh` spreads the rows over the ranks of a
``torch.distributed`` process group, each rank holding a contiguous group
of ``local_size`` partitions (JAX's partition-per-device ``shard_map``
when ``local_size`` is 1), and its collectives are real ones: a state's
tensors travel as the bytes of one buffer, one collective a call.  The
dense dataplane reaches replicas only through ``size``, ``local_size``,
``partitions``, ``device``, ``all_gather`` and ``replicate``; the keyed
dataplane adds ``all_to_all`` (its routing stack) and the gated ``pmax``
(its progress map).  Both meshes offer all of them.

The production meshes of the dry run (:func:`make_production_mesh`,
:func:`make_mesh`) are the JAX package's shapes and axis names as
device meshes over a fake process group: rank 0 of 256 or 512 ranks
that move no data, the counterpart of JAX's forced host devices.
:func:`fake_world` scopes the group, so nothing outlives the block.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import os
import time

import torch

from repro_torch.core.lattice import map_tensors
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class StackMesh:
    """``size`` partitions stacked on ``device``."""

    size: int
    device: torch.device

    @property
    def local_size(self) -> int:
        """Rows this process holds: all of them."""
        return self.size

    @property
    def partitions(self) -> range:
        """The partition ids of this process's rows, in row order."""
        return range(self.size)

    def all_gather(self, state):
        """Every replica's view of all replicas: the stack itself."""
        return state

    def replicate(self, state):
        """Hand one (unstacked) state to every replica: ``[S, ...]`` copies."""
        return map_tensors(lambda x: x.unsqueeze(0).expand(self.size, *x.shape).contiguous(), state)

    def pmax(self, x: torch.Tensor, where: torch.Tensor | None = None) -> torch.Tensor:
        """Elementwise max over the replicas, broadcast back to each; where
        the bool scalar ``where`` is False, each replica keeps its own row
        (``torch.where(where, pmax(x), x)``, read on the device).  One
        ``crdt_merge`` launch on the card; ``DistMesh.pmax`` applies
        ``where`` after its collective."""
        return ops.crdt_merge(x, "max", rows=True, where=where)

    def all_to_all(self, state):
        """Row ``s`` of every tensor ``[S_src, S_dst, ...]`` of ``state``
        sends block ``d`` to replica ``d``: every replica's received blocks,
        ``[S_dst, S_src, ...]`` (``lax.all_to_all`` with ``split_axis=0,
        concat_axis=0, tiled=True`` on each device)."""
        return map_tensors(lambda x: x.transpose(0, 1).contiguous(), state)


@dataclasses.dataclass
class CollectiveStats:
    """What one kind of a :class:`DistMesh`'s collectives cost this rank
    since the last :meth:`reset`: the calls, host seconds inside the
    collective call (under NCCL the enqueue alone), host seconds copying
    between the card and pinned host memory (gloo's staging; the
    device-to-host copy waits for the work queued before it), and the bytes
    the rank handed the collective and got back from it."""

    calls: int = 0
    sent_bytes: int = 0
    received_bytes: int = 0
    seconds: float = 0.0
    staging_s: float = 0.0

    def reset(self) -> None:
        self.calls = self.sent_bytes = self.received_bytes = 0
        self.seconds = self.staging_s = 0.0


@dataclasses.dataclass
class MeshStats:
    """A :class:`DistMesh`'s collectives by kind: ``gather`` (``all_gather``,
    and the gather inside ``pmax``: the rank sends its own rows and receives
    every rank's) and ``exchange`` (``all_to_all``: the rank sends a block
    to every rank, itself included, and receives one from each)."""

    gather: CollectiveStats = dataclasses.field(default_factory=CollectiveStats)
    exchange: CollectiveStats = dataclasses.field(default_factory=CollectiveStats)

    def reset(self) -> None:
        self.gather.reset()
        self.exchange.reset()


def _tensors(state) -> list[torch.Tensor]:
    """Every tensor of a state, in :func:`map_tensors`' order."""
    out = []
    map_tensors(out.append, state)
    return out


def _all_gather_single(out: torch.Tensor, x: torch.Tensor) -> None:
    import torch.distributed as dist

    # torch 2.13 renames all_gather_into_tensor to all_gather_single
    (getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor)(out, x)


def _all_to_all_single(out: torch.Tensor, x: torch.Tensor) -> None:
    import torch.distributed as dist

    dist.all_to_all_single(out, x)  # equal splits of the leading axis


def _byte_rows(leaves: list, n: int) -> tuple[torch.Tensor, list[int]]:
    """Each tensor's bytes as ``[n, -1]`` uint8 rows, concatenated into one
    buffer (nothing is cast), and each tensor's width in it."""
    rows = [x.contiguous().view(torch.uint8).reshape(n, -1) for x in leaves]
    return (torch.cat(rows, 1) if len(rows) > 1 else rows[0]), [r.shape[1] for r in rows]


def _columns(buf: torch.Tensor, widths: list[int]):
    """The inverse of :func:`_byte_rows` on a buffer of any row count: each
    tensor's columns in turn, contiguous."""
    for a, b in itertools.pairwise(itertools.accumulate(widths, initial=0)):
        yield buf[:, a:b].contiguous()


@dataclasses.dataclass(frozen=True)
class DistMesh:
    """``size`` partitions over the ``world`` ranks of the default process
    group: rank ``rank`` holds partitions ``partitions`` as ``local_size``
    stacked rows on ``device``.  Made by :func:`make_dist_mesh`."""

    size: int
    rank: int
    world: int
    device: torch.device
    backend: str  # "gloo" or "nccl"
    stats: MeshStats = dataclasses.field(default_factory=MeshStats, compare=False)

    @property
    def local_size(self) -> int:
        return self.size // self.world

    @property
    def partitions(self) -> range:
        L = self.local_size
        return range(self.rank * L, (self.rank + 1) * L)

    def _leaves(self, state, what: str, lead: tuple) -> list[torch.Tensor]:
        leaves = _tensors(state)
        for x in leaves:
            if tuple(x.shape[:len(lead)]) != lead:
                raise ValueError(f"{what}: a tensor of shape {tuple(x.shape)}, expected "
                                 f"leading dims {lead}")
        return leaves

    def all_gather(self, state):
        """Every tensor ``[local_size, ...]`` of ``state`` as its ``[size,
        ...]`` stack in rank (so partition) order, one collective a state."""
        leaves = self._leaves(state, "all_gather", (self.local_size,))
        buf, widths = _byte_rows(leaves, self.local_size)
        out = self._collective(self.stats.gather, buf, (self.size, buf.shape[1]),
                               _all_gather_single)
        cols = _columns(out, widths)
        return map_tensors(
            lambda x: next(cols).view(x.dtype).reshape(self.size, *x.shape[1:]), state)

    def all_to_all(self, state):
        """Each tensor ``[local_size, size, ...]`` of ``state``: this rank's
        source rows, each with one block for every destination partition.
        Returns ``[local_size, size, ...]``, the blocks every source sent to
        this rank's partitions, sources in partition order (``lax.all_to_all``
        with ``split_axis=0, concat_axis=0, tiled=True``; ``StackMesh``'s at
        one rank).  One collective a state, of ``world`` equal splits."""
        L, R = self.local_size, self.world
        leaves = self._leaves(state, "all_to_all", (L, self.size))
        # [L_src, R, L_dst, ...] -> [R, L_src, L_dst, ...]: a split a rank
        split = [x.reshape(L, R, L, *x.shape[2:]).transpose(0, 1) for x in leaves]
        buf, widths = _byte_rows(split, R)
        out = self._collective(self.stats.exchange, buf, tuple(buf.shape), _all_to_all_single)
        cols = _columns(out, widths)
        # [R_src, L_src, L_dst, ...] -> [L_dst, S_src, ...]
        return map_tensors(lambda x: next(cols).view(x.dtype).reshape(R, L, L, *x.shape[2:])
                           .movedim(2, 0).reshape(x.shape), state)

    def pmax(self, x: torch.Tensor, where: torch.Tensor | None = None) -> torch.Tensor:
        """Elementwise max of ``x`` ``[local_size, F]`` over all ``size``
        rows, for each of this rank's rows; where the bool scalar ``where``
        is False each row keeps its own.  An ``all_gather`` then one gated
        ``crdt_merge`` launch over the ``[size, F]`` stack, of which the rank
        keeps its rows: ``where`` is applied after the collective, which runs
        in every call whatever it says (a skipped one would need a host read
        of ``where``, and ranks that disagreed would hang)."""
        L = self.local_size
        joined = ops.crdt_merge(self.all_gather(x), "max", rows=True, where=where)
        return joined[self.rank * L:(self.rank + 1) * L]

    def _collective(self, st: CollectiveStats, buf: torch.Tensor, shape: tuple,
                    call) -> torch.Tensor:
        """``call(out, buf)`` into a new uint8 ``out`` of ``shape``, counted
        in ``st``.  gloo moves a CUDA buffer through pinned host memory,
        staged here and not by gloo."""
        st.calls += 1
        st.sent_bytes += buf.numel()
        st.received_bytes += math.prod(shape)
        if self.backend == "gloo" and buf.is_cuda:
            t0 = time.perf_counter()
            host = torch.empty(buf.shape, dtype=torch.uint8, pin_memory=True)
            host.copy_(buf)
            out = torch.empty(shape, dtype=torch.uint8, pin_memory=True)
            t1 = time.perf_counter()
            call(out, host)
            t2 = time.perf_counter()
            out = out.to(buf.device)
            st.staging_s += (t1 - t0) + (time.perf_counter() - t2)
            st.seconds += t2 - t1
            return out
        out = torch.empty(shape, dtype=torch.uint8, device=buf.device)
        t1 = time.perf_counter()
        call(out, buf)
        st.seconds += time.perf_counter() - t1
        return out

    def replicate(self, state):
        """Hand one (unstacked) state to this rank's ``local_size`` rows."""
        return map_tensors(
            lambda x: x.unsqueeze(0).expand(self.local_size, *x.shape).contiguous(), state)


def make_data_mesh(num_partitions: int, device="cuda") -> StackMesh:
    """A stacked mesh of ``num_partitions`` replicas on ``device``.

    Raises if ``device`` is a CUDA device and no card is present: the
    dataplane does not carry on on the CPU unless it is asked to."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return StackMesh(num_partitions, device)


def make_dist_mesh(num_partitions: int, device, backend: str) -> DistMesh:
    """This rank's :class:`DistMesh` of ``num_partitions`` partitions over
    the default process group, which must be up
    (``torch.distributed.init_process_group`` with ``backend``) and divide
    them evenly.

    A CUDA device without an index becomes the rank's card, ``cuda:
    LOCAL_RANK % device_count``, and is made current.  NCCL takes one card
    a rank: it is refused when this host's ranks (``LOCAL_WORLD_SIZE``)
    outnumber its cards, and on the CPU; gloo serves both.  Raises, and
    never switches backend or device, when the request cannot be met; a
    CUDA device without a card raises as in :func:`make_data_mesh`."""
    import torch.distributed as dist

    device = torch.device(device)
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: gloo or nccl")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"NCCL moves CUDA tensors, not {device.type} ones; use gloo")
    if not dist.is_initialized():
        raise RuntimeError("no process group is up: call torch.distributed.init_process_group")
    world, rank = dist.get_world_size(), dist.get_rank()
    if num_partitions % world:
        raise ValueError(f"{num_partitions} partitions do not split over {world} ranks")
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        if backend == "nccl":
            local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
            if local_world > cards:
                raise RuntimeError(f"NCCL takes one card a rank: {local_world} ranks would "
                                   f"share {cards} card(s); use gloo")
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)) % cards)
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, not {backend}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return DistMesh(num_partitions, rank, world, device, backend)


# --------------------------------------------------------------------------
# the dry run's meshes (fake process group, no devices)
# --------------------------------------------------------------------------


@contextlib.contextmanager
def fake_world(size: int):
    """A fake process group of ``size`` ranks (this process is rank 0)
    for the block, destroyed on exit.  Raises if a group is already up."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the process group
    that is up, whose world must be the mesh's size (:func:`fake_world`)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    n = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(f"make_mesh{tuple(shape)} needs a process group of {n} ranks "
                           "(with fake_world({n}): ...)")
    return DeviceMesh("cpu", torch.arange(n).reshape(shape), mesh_dim_names=tuple(axes))


def production_shape(multi_pod: bool = False) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """Single pod: (data=16, model=16), 256 ranks.  Multi-pod: (pod=2,
    data=16, model=16), 512 ranks, the DCN/ICI hierarchy on the leading
    axis (``repro.launch.mesh.make_production_mesh``)."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh of :func:`production_shape`, inside a
    :func:`fake_world` of its size."""
    return make_mesh(*production_shape(multi_pod))

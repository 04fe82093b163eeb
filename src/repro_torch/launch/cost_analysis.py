"""Per-device cost of one step on a dry-run mesh: the port's counterpart of
``repro.launch.hlo_analysis``.

The JAX package parses compiled, post-SPMD HLO text and multiplies each
``while`` body by its trip count.  The port has no HLO and no trip counts:
a step runs eagerly, every layer and every query chunk issuing its own
ops, over DTensors whose local shards are meta tensors (shapes, no
memory), on a fake process group.  :class:`CostMode` is a dispatch mode
that sees each op twice over: once at the DTensor level with the global
shapes, where it counts the global flops and hands the op on to DTensor,
and again as the local ops DTensor issues on one device's shards,
collectives included.  From those it counts, per device:

  * ``flops``            — matmul FLOPs of the local ops
                           (``torch.utils.flop_counter``'s formulas),
  * ``bytes``            — Σ (input + output bytes) of each local op that
                           moves data (views and metadata ops excluded):
                           the "parsed upper bound" convention,
  * ``collective_bytes`` — per kind under JAX's names, tensor bytes (the
                           collective's output) with the ring factors
                           all-reduce 2×, others 1×, and ``total``,
  * ``top_collectives``  — the largest, grouped by kind, shape and the
                           model line that asked for them,
  * ``peak_bytes``       — the peak of live local bytes (every storage an
                           op creates counts from its creation until it is
                           freed), beside the argument bytes the step was
                           given: the counterpart of ``memory_analysis()``.

Ops the sharding propagator runs to learn an op's placements (each new op
once at the global shape on fake tensors, or an op without a strategy of
its own through its decomposition, on the step's meta tensors) are not the
step's and are not counted.  DTensor asks for an all-to-all where a shard moves between
tensor dims; on a CPU mesh it would run it as an all-gather and a chunk,
so :func:`count_alltoall` routes it to the all-to-all op the mesh of the
card would run.
"""
from __future__ import annotations

import contextlib
import sys
import time
import traceback
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.models import common

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")

# op packet names of torch's functional collectives and DTensor's all-to-all
_KIND = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_out": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}
_COLL_NAMESPACES = ("_c10d_functional", "_dtensor")
# ops that move no data (views are skipped by their schema)
_NO_TRAFFIC = {"wait_tensor", "_wrap_tensor_autograd", "empty", "empty_strided",
               "empty_like", "new_empty", "new_empty_strided", "detach", "lift_fresh"}


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# DTensor's sharding propagation, whose ops run at the global shape
_PROPAGATION = ("distributed/tensor/_sharding_prop.py", "distributed/tensor/_decompositions.py")


def _in_propagation() -> bool:
    """An op issued inside DTensor's sharding propagation."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith(_PROPAGATION):
            return True
        f = f.f_back
    return False


def _model_site() -> str:
    """The innermost frame of the port's model or training code."""
    for fr in reversed(traceback.extract_stack(limit=40)):
        if "repro_torch" in fr.filename and "/launch/" not in fr.filename:
            return f"{fr.filename.split('repro_torch/')[-1]}:{fr.lineno}"
    return "?"


class CostMode(TorchDispatchMode):
    """Counts one step's global flops and one device's local costs
    (:func:`analyze` enters it around the step)."""

    def __init__(self):
        super().__init__()
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        self._dtensor, self._fake = DTensor, FakeTensor
        self.global_flops = 0
        self.flops = 0
        self.bytes = 0
        self.coll: dict[str, float] = defaultdict(float)
        self.coll_ops: dict[tuple, dict] = {}
        self.n_ops = 0
        self._live: dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self.arg_bytes = 0
        self._memo: dict = {}

    def track_args(self, *trees) -> None:
        """Count the local bytes of the step's arguments (parameters,
        optimizer state, inputs, caches) and mark their storages as
        theirs, so the step's temporaries start from zero."""
        for t in _tensors(trees):
            loc = t.to_local() if isinstance(t, self._dtensor) else t
            st = loc.untyped_storage()
            if st._cdata not in self._live:
                self._live[st._cdata] = 0
                weakref.finalize(st, self._live.pop, st._cdata, None)
                self.arg_bytes += st.nbytes()

    def _alloc(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            if st._cdata in self._live:
                continue
            n = st.nbytes()
            self._live[st._cdata] = n
            weakref.finalize(st, self._free, st._cdata)
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        if any(issubclass(t, self._dtensor) for t in types):
            if packet in flop_registry:
                self.global_flops += flop_registry[packet](*args, **kwargs, out_val=None)
            return NotImplemented  # DTensor issues the local ops, seen below
        ins = _tensors((args, kwargs))
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if any(isinstance(t, self._fake) for t in (*ins, *outs)) or _in_propagation():
            return out  # the sharding propagator's global-shape run
        self.n_ops += 1
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        name = func.__name__.split(".")[0]
        if not func.is_view and name not in _NO_TRAFFIC:
            self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        if func.namespace in _COLL_NAMESPACES and name in _KIND:
            kind = _KIND[name]
            tb = sum(_nbytes(t) for t in outs)
            lb = tb * (2.0 if kind == "all-reduce" else 1.0)
            self.coll[kind] += lb
            key = (kind, tuple(outs[0].shape), str(outs[0].dtype), _model_site())
            rec = self.coll_ops.setdefault(key, {
                "kind": kind, "shape": list(key[1]), "dtype": key[2], "site": key[3],
                "count": 0, "tensor_bytes": tb, "link_bytes": 0.0})
            rec["count"] += 1
            rec["link_bytes"] += lb
        if not func.is_view:
            self._alloc(out)
        return out

    # -- a per-device body (``common.per_shard``), counted once a shape -----

    def _snapshot(self) -> tuple:
        return self.flops, self.global_flops, self.bytes, self.n_ops, dict(self.coll)

    def _delta(self, snap: tuple, ways: int) -> tuple:
        """The counts since ``snap`` of a body on one device, its global
        flops that device's times ``ways``."""
        now = self._snapshot()
        coll = {k: v - snap[4].get(k, 0.0) for k, v in now[4].items()}
        flops = now[0] - snap[0]
        return (flops, flops * ways, now[2] - snap[2], now[3] - snap[3], coll)

    def _restore(self, snap: tuple) -> None:
        self.flops, self.global_flops, self.bytes, self.n_ops = snap[:4]
        self.coll = defaultdict(float, snap[4])

    def add(self, delta: tuple, peak: int) -> None:
        """Count a replayed body's ``delta`` and its transient ``peak``."""
        self.flops += delta[0]
        self.global_flops += delta[1]
        self.bytes += delta[2]
        self.n_ops += delta[3]
        for k, v in delta[4].items():
            self.coll[k] += v
        self.peak_bytes = max(self.peak_bytes, self.live_bytes + peak)

    def replay(self, fn, run, args: tuple, ways: int) -> tuple:
        """``run(*args)``, the body ``fn`` on one device's shards, counted:
        the first call of each body and argument shapes runs it (its
        backward too, where autograd would run one) and records the
        counts, its global flops those of the device times ``ways``, the
        distinct shards; every call then adds them.  The outputs are meta
        tensors of the recorded shapes, and the tensors its backward would
        keep are held as one ballast tensor of their bytes.  So a body's
        backward is one autograd node, and no other op (a layer's
        recompute) runs inside it."""
        grad = torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args)
        sig = (_body_key(fn), ways, grad, tuple(_shape_key(a) for a in args))
        if sig not in self._memo:
            self._memo[sig] = self._measure(run, args, grad, ways)
        return _Replayed.apply(self, self._memo[sig], *args)

    def _measure(self, run, args: tuple, grad: bool, ways: int) -> dict:
        snap, peak0, live0 = self._snapshot(), self.peak_bytes, self.live_bytes
        self.peak_bytes = live0
        rec = {"bwd": None, "bwd_peak": 0}
        # the caller's saved-tensor hooks (a layer's remat) stay out of it
        with torch.autograd.graph.saved_tensors_hooks(lambda t: t, lambda t: t), \
                torch.set_grad_enabled(grad):
            ins = tuple(a.detach().requires_grad_(a.requires_grad)
                        if isinstance(a, torch.Tensor) else a for a in args)
            outs = run(*ins)
            rec["fwd"], rec["fwd_peak"] = self._delta(snap, ways), self.peak_bytes - live0
            rec["outs"] = [(tuple(o.shape), o.dtype) for o in outs]
            rec["saved"] = max(0, self.live_bytes - live0 - sum(_nbytes(o) for o in outs))
            diff = [o for o in outs if o.requires_grad]
            wrt = [a for a in ins if isinstance(a, torch.Tensor) and a.requires_grad]
            if grad and diff:
                snap2, live1 = self._snapshot(), self.live_bytes
                self.peak_bytes = live1
                torch.autograd.grad(diff, wrt, [torch.empty_like(o) for o in diff],
                                    allow_unused=True)
                rec["bwd"], rec["bwd_peak"] = self._delta(snap2, ways), self.peak_bytes - live1
            del outs, ins, diff, wrt
        self._restore(snap)
        self.peak_bytes = peak0
        return rec

    def result(self) -> dict:
        """JAX's ``analyze`` keys, plus the global flops and memory."""
        coll = dict(self.coll)
        coll["total"] = sum(v for k, v in coll.items() if k != "total")
        top = sorted(self.coll_ops.values(), key=lambda o: -o["link_bytes"])
        return {
            "flops": float(self.flops),
            "global_flops": float(self.global_flops),
            "bytes": float(self.bytes),
            "collective_bytes": coll,
            "top_collectives": top[:20],
            "n_ops": self.n_ops,
            "argument_bytes": self.arg_bytes,
            "temp_bytes": self.peak_bytes,
            "peak_bytes": self.arg_bytes + self.peak_bytes,
        }


class _Replayed(torch.autograd.Function):
    """A replayed body (:meth:`CostMode.replay`): its recorded forward
    count now, its backward count when autograd reaches it."""

    @staticmethod
    def forward(ctx, mode, rec, *args):
        mode.add(rec["fwd"], rec["fwd_peak"])
        outs = tuple(torch.empty(s, dtype=d, device="meta") for s, d in rec["outs"])
        ctx.mode, ctx.rec = mode, rec
        ctx.wrt = [(tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor) and a.requires_grad
                   else None for a in args]
        if rec["bwd"] is not None:  # what the backward would keep
            ctx.save_for_backward(torch.empty(rec["saved"], dtype=torch.uint8, device="meta"))
        ctx.mark_non_differentiable(*(o for o in outs if not o.is_floating_point()))
        return outs

    @staticmethod
    def backward(ctx, *grads):
        if ctx.rec["bwd"] is not None:
            ctx.mode.add(ctx.rec["bwd"], ctx.rec["bwd_peak"])
        return (None, None, *(None if w is None else torch.empty(w[0], dtype=w[1], device="meta")
                              for w in ctx.wrt))


def _shape_key(x):
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.dtype, x.requires_grad
    return repr(x)


def _body_key(fn) -> tuple:
    """What fixes a body's cost beside its arguments' shapes: its code,
    and what it closes over (tensors by shape, bodies by their key)."""
    cells = []
    for c in fn.__closure__ or ():
        v = c.cell_contents
        if callable(v) and hasattr(v, "__code__"):
            cells.append(_body_key(v))
        elif isinstance(v, dict):
            cells.append(tuple(sorted((k, _shape_key(x)) for k, x in v.items())))
        else:
            cells.append(_shape_key(v))
    return fn.__code__, tuple(cells)


@contextlib.contextmanager
def replaying(mode: CostMode):
    """Count ``common.per_shard`` bodies through ``mode.replay`` for the
    block."""
    prev, common._REPLAY = common._REPLAY, mode.replay
    try:
        yield
    finally:
        common._REPLAY = prev


def analyze(mesh, fn, *args, held=None) -> dict:
    """``fn(*args)``, a step over DTensors on ``mesh`` (inside its fake
    process group), counted: JAX's ``analyze`` keys (``flops``, ``bytes``,
    ``collective_bytes``, ``top_collectives``) per device, with the global
    flops, the argument bytes of ``held`` (the step's state and inputs,
    ``args`` by default), the peak of the step's temporaries and the
    seconds the step took (``lower_s``).  The model's ``shard`` constraints
    act on ``mesh``; constants the model makes are replicated."""
    from torch.distributed.tensor.experimental import implicit_replication

    mode = CostMode()
    mode.track_args(args if held is None else held)
    # the model's cached constants made within this step, as in the first
    # step of a process, so a count does not depend on what ran before
    common._rope_freqs_on.cache_clear()
    t0 = time.perf_counter()
    with (common.sharding_mesh(mesh), implicit_replication(), count_alltoall(),
          replaying(mode), mode):
        out = fn(*args)
    lower_s = time.perf_counter() - t0
    del out
    return {**mode.result(), "lower_s": lower_s}


@contextlib.contextmanager
def count_alltoall():
    """Route DTensor's shard-to-shard moves to its all-to-all op (whose
    meta kernel gives the shape), in place of the all-gather and chunk it
    would run on a CPU mesh."""
    from torch.distributed.tensor import placement_types

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    if not hasattr(placement_types, "shard_dim_alltoall"):
        raise RuntimeError("this torch's DTensor has no shard_dim_alltoall to route")
    prev = placement_types.shard_dim_alltoall
    placement_types.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = prev

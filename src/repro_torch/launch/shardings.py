"""Parameter / input / cache sharding assignment (port of
``repro.launch.shardings``): DTensor placements in place of GSPMD
partition specs.

Strategy (DESIGN.md §6): megatron tensor-parallel over ``model`` + ZeRO-3
FSDP over ``data`` for every weight matrix; experts over ``model`` (EP);
batch over (``pod``, ``data``); KV caches over kv-heads (or head_dim when
kv-heads don't divide the axis).  Axes that don't divide a dim are dropped
to replication, so every shard is even and every (arch × shape × mesh)
cell lowers.

A spec is the JAX package's: one entry a tensor dim, ``None``, an axis
name, or a tuple of axis names.  :func:`placements` turns a cleaned spec
into one ``Shard``/``Replicate`` a mesh dim; a dim over several axes is
``Shard(d)`` on each of them in mesh order (JAX's major-to-minor layout).
:func:`spec_of` reads placements back as a spec.  ``sizes`` is a mesh's
``{axis name: size}`` in mesh order (:func:`_axis_sizes`).
"""
from __future__ import annotations

from typing import Any

from repro_torch.models import flags

BATCH_AXES = ("pod", "data")

# final-path-name -> spec for the TRAILING dims (leading dims -> None); the
# JAX package's tables, copied (vocab-parallel embed/unembed: V over model)
_TRAILING: dict[str, tuple] = {
    "embed": ("model", None),
    "unembed": ("model", None),
    "wq": ("data", "model"),
    "wk": ("data", "model"),
    "wv": ("data", "model"),
    "wo": ("model", "data"),
    "w_gate": ("data", "model"),
    "w_up": ("data", "model"),
    "w_down": ("model", "data"),
    "router": ("data", None),
    "in_proj": ("data", "model"),
    "out_proj": ("model", "data"),
    "conv_w": (None, "model"),
    "x_proj": ("model", None),
    "dt_proj": (None, "model"),
    "dt_bias": ("model",),
    "A_log": ("model", None),
    "D": ("model",),
    "gate_norm": ("model",),
    "bc_proj": ("data", None),
}

# expert-stacked weights (path contains "moe"): E over model, D over data
_TRAILING_MOE: dict[str, tuple] = {
    "w_gate": ("model", "data", None),
    "w_up": ("model", "data", None),
    "w_down": ("model", None, "data"),
    "router": ("data", None),
}


def _axis_sizes(mesh) -> dict[str, int]:
    """``{axis: size}`` in mesh order, of a ``DeviceMesh``, of a stand-in
    with JAX's ``axis_names`` and ``devices.shape``, or of such a dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def placements(spec: tuple, sizes: dict[str, int]) -> tuple:
    """One ``Shard``/``Replicate`` a mesh axis from a cleaned spec (an
    axis of size 1 replicates: DTensor cannot reshape a dim sharded one
    way when the dim is 1 long)."""
    from torch.distributed.tensor import Replicate, Shard

    out = {a: Replicate() for a in sizes}
    for d, e in enumerate(spec):
        axes = e if isinstance(e, tuple) else () if e is None else (e,)
        if list(axes) != [a for a in sizes if a in axes]:
            raise ValueError(f"{spec}: a dim's axes must follow mesh order {tuple(sizes)}")
        for a in axes:
            if not isinstance(out[a], Replicate):
                raise ValueError(f"axis {a!r} shards two dims of {spec}")
            out[a] = Shard(d) if sizes[a] > 1 else Replicate()
    return tuple(out[a] for a in sizes)


def spec_of(pl: tuple, ndim: int, sizes: dict[str, int]) -> tuple:
    """The spec of ``pl`` over ``ndim`` dims: ``None``, an axis name, or
    a tuple of two or more axis names (mesh order) a dim."""
    axes = [[] for _ in range(ndim)]
    for a, p in zip(sizes, pl):
        if p.is_shard():
            axes[p.dim].append(a)
    return tuple(None if not e else e[0] if len(e) == 1 else tuple(e) for e in axes)


def _fit(spec: tuple, shape: tuple[int, ...], sizes: dict[str, int]) -> tuple:
    """Right-align the trailing spec onto shape; drop non-dividing axes."""
    full = (None,) * (len(shape) - len(spec)) + tuple(spec)
    out = []
    for dim, ax in zip(shape, full):
        if ax is None or ax not in sizes or dim % sizes[ax] != 0:
            out.append(None)
        else:
            out.append(ax)
    return placements(tuple(out), sizes)


def _names(path) -> list[str]:
    return [str(k) for k in path]


def param_pspec(path, leaf, sizes: dict[str, int], cfg=None) -> tuple:
    names = _names(path)
    last = names[-1]
    table = _TRAILING_MOE if ("moe" in names and last in _TRAILING_MOE) else _TRAILING
    if last in table:
        spec = table[last]
        # rank-aware fixups
        stacked = names[0] in ("layers", "tail", "enc_layers")
        if last == "A_log" and leaf.ndim - (1 if stacked else 0) == 1:
            spec = ("model",)
        if last == "D":
            spec = ("model",)
        # Attention TP only when the head count divides the model axis;
        # otherwise attention runs data-parallel (weights FSDP-sharded only).
        if cfg is not None and "model" in sizes:
            tp = sizes["model"]
            if last in ("wq", "wo") and cfg.n_heads % tp != 0:
                spec = tuple(None if a == "model" else a for a in spec)
            if last in ("wk", "wv") and cfg.n_kv_heads % tp != 0:
                spec = tuple(None if a == "model" else a for a in spec)
        return _fit(spec, tuple(leaf.shape), sizes)
    # norms and anything unknown: replicate
    return placements((None,) * leaf.ndim, sizes)


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict, ``path`` the keys to it."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, (*path, k)) for k, v in tree.items()}
    return fn(path, tree)


def shard_params(abs_params, mesh, cfg=None, strategy: str = "megatron") -> Any:
    sizes = _axis_sizes(mesh)
    if strategy == "zero3":
        return tree_map_with_path(lambda path, leaf: _zero3_pspec(leaf, sizes), abs_params)
    return tree_map_with_path(lambda path, leaf: param_pspec(path, leaf, sizes, cfg), abs_params)


def _zero3_pspec(leaf, sizes: dict[str, int]) -> tuple:
    """ZeRO-3 / pure-DP: every weight fully sharded over (data x model) on its
    largest evenly-dividing dim; gathered at use, reduce-scattered in bwd.
    No tensor parallelism — the whole mesh acts as one DP domain."""
    ways = sizes.get("data", 1) * sizes.get("model", 1)
    shape = tuple(leaf.shape)
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if shape[i] % ways == 0:
            spec = [None] * len(shape)
            spec[i] = ("data", "model")
            return placements(tuple(spec), sizes)
    for i in order:  # fall back to data-only sharding
        if shape[i] % sizes.get("data", 1) == 0:
            spec = [None] * len(shape)
            spec[i] = "data"
            return placements(tuple(spec), sizes)
    return placements((None,) * len(shape), sizes)


def _batch_spec(B: int, extra_dims: int, sizes: dict[str, int]) -> tuple:
    axes = tuple(a for a in flags.batch_axes() if a in sizes)
    n = 1
    for a in axes:
        n *= sizes[a]
    if axes and B % n == 0:
        return (axes, *([None] * extra_dims))
    return (None,) * (1 + extra_dims)


def batch_pspec(B: int, extra_dims: int, mesh) -> tuple:
    sizes = _axis_sizes(mesh)
    return placements(_batch_spec(B, extra_dims, sizes), sizes)


def shard_inputs(abs_batch, mesh) -> Any:
    return {k: batch_pspec(v.shape[0], v.ndim - 1, mesh) for k, v in abs_batch.items()}


def cache_pspec(path, leaf, mesh, ssm_version: int = 1) -> tuple:
    """KV / SSM cache sharding: batch over (pod,data); heads (or head_dim)
    over model.  Cache leaves carry 1-2 leading stack dims from the layer
    scan; specs are right-aligned so the rank of the stack prefix is
    irrelevant.  As in the JAX package, the batch entry is the batch spec's
    first entry, which a ``PartitionSpec`` holds as the axis name when it
    is one axis (``data`` on one pod) and as a tuple otherwise, and
    :func:`_fit` drops a tuple (it is no axis name): on two pods the caches
    shard over ``model`` alone."""
    sizes = _axis_sizes(mesh)
    last = _names(path)[-1]
    shape = tuple(leaf.shape)

    def b_ax(bdim):
        e = _batch_spec(bdim, 0, sizes)[0]
        return e[0] if isinstance(e, tuple) and len(e) == 1 else e

    if last in ("k", "v"):
        # [..., B, T, K, hd]
        kax = "model" if shape[-2] % sizes.get("model", 1) == 0 else None
        hax = "model" if kax is None and shape[-1] % sizes.get("model", 1) == 0 else None
        return _fit((b_ax(shape[-4]), None, kax, hax), shape, sizes)
    if last in ("ssm", "tail_ssm"):
        # mamba1 [..., B, Di, N]: shard Di; mamba2 [..., B, H, P, N]: shard H
        trailing = 3 if ssm_version == 1 else 4
        spec = (b_ax(shape[-trailing]), "model") + (None,) * (trailing - 2)
        return _fit(spec, shape, sizes)
    if last in ("conv", "tail_conv"):
        # [..., B, K-1, Di]
        return _fit((b_ax(shape[-3]), None, "model"), shape, sizes)
    return placements((None,) * leaf.ndim, sizes)


def shard_cache(abs_cache, mesh, ssm_version: int = 1) -> Any:
    return tree_map_with_path(lambda path, leaf: cache_pspec(path, leaf, mesh, ssm_version),
                              abs_cache)


def replicated(mesh) -> tuple:
    return placements((), _axis_sizes(mesh))

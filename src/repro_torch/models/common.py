"""Shared model building blocks: norms, RoPE, embeddings, init (port of
``repro.models.common``).

Parameters are plain nested dicts of tensors, as in the JAX package, so a
JAX parameter tree and the port's map leaf to leaf.  Layers of a
homogeneous stack are stacked along a leading ``[L]`` axis.

Sharding: model code annotates activations through :func:`shard`, the
counterpart of ``jax.lax.with_sharding_constraint``.  Under a dry-run mesh
(:func:`sharding_mesh`, ``launch/dryrun.py``) it redistributes a DTensor
to the cleaned spec; anywhere else it is the identity, so every run on one
card or on the CPU is unchanged bit for bit.  Parameter placements are
assigned by ``launch/shardings.py``.

The initializers draw the JAX package's numbers: a key is a
``streaming.prng`` key, and a key batch (the split keys that ``jax.vmap``
maps an initializer over) draws one tensor a key, the key batch's shape
leading.
"""
from __future__ import annotations

import contextlib
import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.streaming import prng

# lanes of one normal draw at a time, over the whole key batch: a
# full-width embedding table, or a stack of full-width layers, would take
# several int64 temporaries of its size otherwise
_DRAW_CHUNK = 1 << 25


# --------------------------------------------------------------------------
# parameter trees
# --------------------------------------------------------------------------


def tree_leaves(tree) -> list:
    """The tensors of a nested dict in ``jax.tree.leaves`` order (sorted
    keys, depth first)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


# --------------------------------------------------------------------------
# sharding helper: redistribute-if-mesh
# --------------------------------------------------------------------------

_MESH = None  # the dry run's DeviceMesh while a sharding_mesh block runs


@contextlib.contextmanager
def sharding_mesh(mesh):
    """Make :func:`shard` act on DTensors over ``mesh`` for the block."""
    global _MESH
    prev, _MESH = _MESH, mesh
    try:
        yield mesh
    finally:
        _MESH = prev


def clean_spec(spec: tuple, shape: tuple, sizes: dict) -> tuple:
    """The JAX package's cleanup of a constraint's spec: the canonical
    batch tuple routes through ``flags.batch_axes()``, axis names absent
    from the mesh are dropped, and so are axes that do not evenly divide
    their dim (or that an earlier dim took)."""
    from repro_torch.models import flags

    spec = tuple(
        flags.batch_axes() if (isinstance(e, tuple) and set(e) == {"pod", "data"}) else e
        for e in spec
    )
    used: set = set()

    def keep(e, dim):
        if e is None:
            return None
        if isinstance(e, (tuple, list)):
            kept, prod = [], 1
            for a in e:
                if a in sizes and a not in used:
                    kept.append(a)
                    prod *= sizes[a]
            if kept and dim % prod == 0:
                used.update(kept)
                return tuple(kept)
            return None
        if e in sizes and e not in used and dim % sizes[e] == 0:
            used.add(e)
            return e
        return None

    return tuple(keep(e, d) for e, d in zip(spec, shape))


BATCH = ("pod", "data")  # batch shards over pod+data axes when present


def shard(x: torch.Tensor, *spec) -> torch.Tensor:
    """``with_sharding_constraint(x, P(*spec))``: under a dry-run mesh, a
    DTensor ``x`` redistributed to the cleaned spec (:func:`clean_spec`);
    the identity otherwise."""
    if _MESH is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    from repro_torch.launch.shardings import placements

    sizes = dict(zip(_MESH.mesh_dim_names, _MESH.shape))
    pl = placements(clean_spec(spec, tuple(x.shape), sizes), sizes)
    return x if tuple(x.placements) == pl else x.redistribute(_MESH, pl)


def axis_size(name: str) -> int:
    """The size of the dry-run mesh's axis ``name``; 1 outside one."""
    if _MESH is None or name not in _MESH.mesh_dim_names:
        return 1
    return _MESH.size(_MESH.mesh_dim_names.index(name))


_REPLAY = None  # the dry run's counter: counts each body once for each shape


def is_sharded(x) -> bool:
    """``x`` is a DTensor under a dry-run mesh."""
    if _MESH is None:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def mesh_axes() -> tuple:
    """The dry-run mesh's axis names; () outside one."""
    return () if _MESH is None else tuple(_MESH.mesh_dim_names)


def local_rank(name: str) -> int:
    """This rank's coordinate on the dry-run mesh's axis ``name``."""
    return 0 if _MESH is None else _MESH.get_local_rank(name)


def per_shard(fn, out_placements, *args, grad_placements=None):
    """``fn(*args)`` on each device's local shards, JAX's ``shard_map``:
    under a dry-run mesh, with a DTensor argument, ``fn`` takes the local
    tensors and its outputs become DTensors placed by ``out_placements``
    (one tuple a mesh dim, or one a output); otherwise ``fn(*args)``.
    ``grad_placements`` (one an argument, ``None`` for its own) place the
    arguments' gradients where they differ from the arguments, as a
    replicated input's gradient summed over the shards.  The dry run's
    counter (``_REPLAY``) counts the body, whose cost depends on its
    arguments' shapes alone, once for each shape, its global flops those
    of one device times the distinct shards of its first output."""
    from torch.distributed.tensor import DTensor

    if _MESH is None or not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map

    in_pl = tuple(a.placements if isinstance(a, DTensor) else None for a in args)
    one = not isinstance(out_placements[0], tuple)
    out_pls = (out_placements,) if one else tuple(out_placements)
    ways = math.prod(n for n, p in zip(_MESH.shape, out_pls[0]) if not p.is_replicate())

    def run(*local):
        return _as_tuple(fn(*local))

    def body(*local):
        return run(*local) if _REPLAY is None else _REPLAY(fn, run, local, ways)

    grads = None if grad_placements is None else tuple(
        g if g is not None else p for g, p in zip(grad_placements, in_pl))
    out = local_map(body, out_placements=out_pls, in_placements=in_pl,
                    in_grad_placements=grads, device_mesh=_MESH)(*args)
    return out[0] if one else out


def _as_tuple(x) -> tuple:
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def fsdp(tree):
    """A layer's parameters gathered over the batch axes (``pod``,
    ``data``) under a dry-run mesh: ZeRO-3's gather at use, whose backward
    reduce-scatters the gradients; their ``model`` shards stay.  The
    identity outside a mesh."""
    if _MESH is None:
        return tree
    return tree_map(lambda x: _replicate(x, lambda n, p: n in BATCH and p.is_shard()), tree)


def _replicate(x, where) -> torch.Tensor:
    """A DTensor ``x`` replicated on the mesh axes where ``where(axis
    name, placement)`` holds; ``x`` itself if it is no DTensor or none
    does."""
    if not is_sharded(x):
        return x
    from torch.distributed.tensor import Replicate

    return redistribute_to(x, tuple(Replicate() if where(n, p) else p
                                    for n, p in zip(mesh_axes(), x.placements)))


def _contiguous_stride(shape) -> tuple:
    out, n = [], 1
    for d in reversed(tuple(shape)):
        out.append(n)
        n *= d
    return tuple(reversed(out))


def new_stacked(x: torch.Tensor, lead: tuple) -> torch.Tensor:
    """An empty stack of ``lead`` tensors like ``x``: under a dry-run mesh
    each placed as ``x``, the stack dims whole (``new_empty`` would
    replicate the stack)."""
    if not is_sharded(x):
        return x.new_empty((*lead, *x.shape))
    from torch.distributed.tensor import DTensor, Shard

    n = len(lead)
    loc = x.to_local()
    pl = [Shard(p.dim + n) if p.is_shard() else p for p in x.placements]
    full = torch.Size((*lead, *x.shape))
    return DTensor.from_local(loc.new_empty((*lead, *loc.shape)), _MESH, pl, run_check=False,
                              shape=full, stride=_contiguous_stride(full))


def unshard_dim0(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its leading dim gathered under a dry-run mesh, where a
    mesh axis shards it; ``x`` otherwise."""
    return _replicate(x, lambda n, p: p.is_shard(0))


class _GradPlaced(torch.autograd.Function):
    """The identity, whose backward places the gradient as the value."""

    @staticmethod
    def forward(ctx, x):
        from torch.distributed.tensor import Replicate

        # a partial value's gradient is the same on every shard: replicated
        ctx.placements = tuple(Replicate() if p.is_partial() else p for p in x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g if tuple(g.placements) == tuple(ctx.placements) else g.redistribute(
            _MESH, ctx.placements)


def grad_placed(x: torch.Tensor) -> torch.Tensor:
    """``x``; under a dry-run mesh its gradient comes back placed as ``x``
    is, whatever placement the ops after it gave the gradient."""
    return _GradPlaced.apply(x) if is_sharded(x) and x.requires_grad else x


def reduced(x: torch.Tensor) -> torch.Tensor:
    """A DTensor ``x`` with its partial sums reduced (replicated there)."""
    return _replicate(x, lambda n, p: p.is_partial())


def redistribute_to(x: torch.Tensor, placements: tuple) -> torch.Tensor:
    """A DTensor ``x`` placed by ``placements`` (``x`` if it is)."""
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(_MESH, placements)


def shard_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``x`` placed as ``ref`` under a dry-run mesh (a gradient as its
    parameter, as a JAX cotangent takes its primal's sharding; keys and
    values as the query); the identity otherwise."""
    return redistribute_to(x, ref.placements) if is_sharded(x) else x


def residual(h: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``h + y``, a block's residual add.  Under a dry-run mesh ``y`` is
    first placed as the stream ``h``: JAX's layer scan fixes its carry's
    sharding, so a row-parallel output's partial sums are all-reduced
    there, not left to DTensor's choice of placement for the add (a
    reduce-scatter over the sequence, which differs between torch
    versions and makes the next column-parallel matmul gather its
    weight)."""
    return h + (shard_like(y, h) if is_sharded(h) else y)


# --------------------------------------------------------------------------
# initializers
# --------------------------------------------------------------------------


def normal(key: prng.Key, shape: tuple) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` for every key of a key
    batch: f32 ``key.shape + shape``, drawn at most ``_DRAW_CHUNK`` lanes
    at a time over all the keys (each key's lanes in runs from an offset)."""
    lead = tuple(key[0].shape)
    if key[0].device.type == "meta":  # shapes alone (the dry run's parameters)
        return torch.empty((*lead, *shape), dtype=torch.float32, device="meta")
    n = math.prod(shape)
    step = max(1, _DRAW_CHUNK // math.prod(lead))
    if n <= step:
        return prng.normal(key, n).reshape(*lead, *shape)
    out = torch.empty((*lead, n), dtype=torch.float32, device=key[0].device)
    for a in range(0, n, step):
        b = min(n, a + step)
        out[..., a:b] = prng.normal(key, b - a, offset=a)
    return out.reshape(*lead, *shape)


def dense_init(key, shape, dtype, fan_in: int | None = None) -> torch.Tensor:
    fan = fan_in if fan_in is not None else shape[-2] if len(shape) >= 2 else shape[-1]
    f32 = dict(dtype=torch.float32, device=key[0].device)
    scale = 1.0 / prng.sqrt_f32(torch.tensor(float(max(fan, 1)), **f32))
    return normal(key, shape).mul_(scale).to(dtype)  # in place: one f32 copy at a time


def embed_init(key, shape, dtype) -> torch.Tensor:
    return normal(key, shape).mul_(0.02).to(dtype)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with an f32 variance and ``x``'s own dtype elsewhere, as the
    JAX package computes it; ``scale`` is stored as ``scale - 1``.  Under a
    dry-run mesh the sum of squares over a dim split over the mesh is
    all-reduced, not left to DTensor's choice of placement."""
    sq = x.to(torch.float32).square()
    if is_sharded(sq):
        var = reduced(sq.sum(-1, keepdim=True)) / sq.shape[-1]
    else:
        var = sq.mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * (1.0 + scale).to(x.dtype)


def init_rmsnorm(d: int, dtype, lead: tuple = (), device=None) -> torch.Tensor:
    """Zeros ``lead + (d,)``: ``lead`` is the key batch's shape of a
    stacked initializer."""
    return torch.zeros((*lead, d), dtype=dtype, device=device)


# --------------------------------------------------------------------------
# rotary position embeddings
# --------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    e = torch.arange(half, dtype=torch.float32, device=device) / half
    return 1.0 / prng.pow_f32(theta, e)


@functools.lru_cache(maxsize=16)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """:func:`rope_freqs`, made once a device: made on the CPU and moved
    (a constant, as XLA folds it; its ``pow`` is some hundred small ops,
    which a layer would otherwise issue twice a call, and the meta device
    of the dry run cannot run them)."""
    return rope_freqs(head_dim, theta, "cpu").to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: broadcastable to [..., S]."""
    hd = x.shape[-1]
    freqs = _rope_freqs_on(hd, theta, x.device)  # [hd/2]
    ang = positions[..., None].to(torch.float32) * freqs  # [..., S, hd/2]
    sin = torch.sin(ang)[..., None, :]  # [..., S, 1, hd/2]
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# embedding / unembedding with chunked softmax-xent (vocab can be 256k)
# --------------------------------------------------------------------------


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Rows of ``table``.  ``F.embedding``'s backward on the card sums the
    rows of repeated tokens in a fixed order (no atomics), so a step
    repeats bit for bit.  Under a dry-run mesh, :func:`_embed_sharded`."""
    if is_sharded(table):
        return _embed_sharded(tokens, table)
    return F.embedding(tokens, table)


def _embed_sharded(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The vocab-parallel lookup (Megatron's): the table gathered over the
    batch axes, each device looking up the tokens of its vocab rows (zeros
    for the others), the partial rows summed over ``model`` by the next
    constraint; the table's gradient is each batch shard's part.  DTensor's
    own lookup leaves a masked partial whose gradient it cannot place."""
    from torch.distributed.tensor import Partial

    axes = mesh_axes()
    table = fsdp(table)
    tokens = shard(tokens, BATCH, *([None] * (tokens.ndim - 1)))
    if "model" not in axes or not table.placements[axes.index("model")].is_shard(0):
        return F.embedding(tokens, table)
    n = table.to_local().shape[0]
    lo = local_rank("model") * n
    out = tuple(Partial() if a == "model" else p for a, p in zip(axes, tokens.placements))
    grad = tuple(Partial() if a != "model" and p.is_shard() else q
                 for a, p, q in zip(axes, tokens.placements, table.placements))

    def look(t, w):
        idx = t - lo
        ok = (idx >= 0) & (idx < n)
        return F.embedding(torch.where(ok, idx, 0), w) * ok[..., None].to(w.dtype)

    return per_shard(look, out, tokens, table, grad_placements=(None, grad))


def unembed_loss(
    h: torch.Tensor,  # [B, S, D]
    table: torch.Tensor,  # [V, D]
    labels: torch.Tensor,  # [B, S]
    mask: torch.Tensor | None = None,  # [B, S]
    chunk: int = 1024,
) -> torch.Tensor:
    """Mean next-token cross-entropy, computed in sequence chunks so the
    [B, chunk, V] logits block (not [B, S, V]) is the live working set.
    The gold logit is picked by a one-hot select and a sum, whose backward
    is elementwise: a gather's backward scatters by atomics on the card."""
    B, S, D = h.shape
    n_chunks = max(1, S // chunk)
    chunk = S // n_chunks
    if n_chunks * chunk != S:
        raise ValueError(f"seq {S} not divisible into {n_chunks} chunks")
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=h.device)
    vocab = torch.arange(table.shape[0], device=h.device)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        # vocab-parallel: [B, chunk, V/model], only the logsumexp reduces
        hc = shard(h[:, sl], BATCH, None, None)  # by batch, so the logits are too
        logits = shard((hc @ table.T).to(torch.float32), BATCH, None, "model")
        if is_sharded(logits):
            nll = _nll_sharded(logits, shard(labels[:, sl, None] == vocab, BATCH, None, "model"))
        else:
            nll = torch.logsumexp(logits, dim=-1) - torch.where(
                labels[:, sl, None] == vocab, logits, 0.0).sum(-1)
        mb = mask[:, sl].to(torch.float32)
        tot = tot + reduced((nll * mb).sum())  # a dry-run mesh's partial sums reduced here
        cnt = cnt + mb.sum()
    return tot / torch.clamp(cnt, min=1.0)


def _nll_sharded(logits: torch.Tensor, hot: torch.Tensor) -> torch.Tensor:
    """Each token's ``logsumexp(logits) - logits[label]`` over vocab-
    parallel logits under a dry-run mesh (``hot`` the label's one-hot,
    placed as the logits): each device's vocab slice, its max and sums
    all-reduced over ``model`` (Megatron's vocab-parallel cross-entropy).
    DTensor's own ``logsumexp`` gathers the vocab, and its backward of the
    two paths gathers the batch."""
    from torch.distributed.tensor import Replicate

    axes = mesh_axes()
    split = "model" in axes and logits.placements[axes.index("model")].is_shard(2)
    group = (_MESH, axes.index("model")) if split else None
    out = tuple(Replicate() if n == "model" else p for n, p in zip(axes, logits.placements))
    # its gradient placed as it is, by batch, before the per-device backward
    return grad_placed(per_shard(lambda x, h: _LocalNLL.apply(x, h, group), out, logits, hot))


class _LocalNLL(torch.autograd.Function):
    """:func:`_nll_sharded` on one device's slice, the softmax-minus-one-hot
    gradient in one expression."""

    @staticmethod
    def forward(ctx, x, hot, group):
        from torch.distributed import _functional_collectives as funcol

        def red(t, op):
            return t if group is None else funcol.wait_tensor(funcol.all_reduce(t, op, group))

        m = red(x.amax(-1), "max")
        lse = red((x - m[..., None]).exp().sum(-1), "sum").log() + m
        ctx.save_for_backward(x, hot, lse)
        return lse - red(torch.where(hot, x, 0.0).sum(-1), "sum")

    @staticmethod
    def backward(ctx, g):
        x, hot, lse = ctx.saved_tensors
        return ((x - lse[..., None]).exp() - hot.to(x.dtype)) * g[..., None], None, None


def unembed_logits(h: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return h @ table.T

"""The port's sharding assignment (``repro_torch.launch.shardings``) against
the JAX package's (``repro.launch.shardings``), device-free.

The six cases of ``test_sharding_unit.py`` mirrored on the port, then the
placements of every parameter, ``decode_32k`` cache leaf and cell input of
all ten architectures held to JAX's partition specs leaf by leaf and
exactly, on both production meshes and under both strategies.  JAX's
functions take a sizes dict or a stand-in with ``axis_names`` and
``devices.shape``, so no devices (and no process group) are needed: the
port's placements are read back as specs by ``spec_of``.  Port parameters
and caches are made on the meta device, JAX's by ``jax.eval_shape``.
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from repro.configs import SHAPES, get_config, list_archs
from repro.launch import shardings as jsh
from repro.models import cache_spec as jax_cache_spec
from repro.models import flags as jflags
from repro.models import lm as jlm
from repro_torch.configs import get_config as tget_config
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import shardings as sh
from repro_torch.models import flags as tflags

MESHES = {
    "pod_16x16": {"data": 16, "model": 16},
    "multipod_2x16x16": {"pod": 2, "data": 16, "model": 16},
}
STRATEGIES = ("megatron", "zero3")


def _norm(spec) -> tuple:
    """A JAX spec entry by entry: ``None``, an axis name, or a tuple of two
    or more names (a one-axis tuple is that axis)."""
    out = []
    for e in tuple(spec):
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            e = None if not e else e[0] if len(e) == 1 else e
        out.append(e)
    return tuple(out)


def _standin(sizes: dict):
    """What JAX's functions read of a mesh: axis names and the device grid."""
    return types.SimpleNamespace(axis_names=tuple(sizes),
                                 devices=np.empty(tuple(sizes.values())))


@pytest.fixture
def strategy_flags(request):
    """Both packages' flags set as the dry run sets them, restored after."""
    prev = (jflags.tp_pad(), jflags.batch_axes(), tflags.tp_pad(), tflags.batch_axes())

    def set_(strategy: str):
        pad, axes = (1, ("pod", "data", "model")) if strategy == "zero3" else (16, ("pod", "data"))
        for f in (jflags, tflags):
            f.set_tp_pad(pad)
            f.set_batch_axes(axes)

    yield set_
    jflags.set_tp_pad(prev[0])
    jflags.set_batch_axes(prev[1])
    tflags.set_tp_pad(prev[2])
    tflags.set_batch_axes(prev[3])


@functools.lru_cache(maxsize=None)
def _jax_params(arch: str, pad: int):
    jflags.set_tp_pad(pad)
    cfg = get_config(arch)
    tree = jax.eval_shape(lambda k: jlm.init_params(cfg, k, jnp.bfloat16), jax.random.PRNGKey(0))
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _port_leaves(tree, path=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out |= _port_leaves(v, (*path, k))
        return out
    return {path: tree}


def _key(path) -> tuple:
    return tuple(getattr(k, "key", getattr(k, "name", str(k))) for k in path)


# --------------------------------------------------------------------------
# the six cases of test_sharding_unit.py
# --------------------------------------------------------------------------


class Leaf:
    def __init__(self, shape):
        self.shape = shape
        self.ndim = len(shape)


def test_fit_drops_nondividing_axes():
    sizes = {"data": 4, "model": 4}
    assert sh._fit(("data", "model"), (8, 24), sizes) == (Shard(0), Shard(1))
    assert sh.spec_of(sh._fit(("data", "model"), (8, 24), sizes), 2, sizes) == ("data", "model")
    # 6 % 4 != 0 -> dropped to None
    assert sh.spec_of(sh._fit(("data", "model"), (8, 6), sizes), 2, sizes) == ("data", None)
    # leading dims padded with None
    assert sh.spec_of(sh._fit(("model",), (3, 5, 8), sizes), 3, sizes) == (None, None, "model")


def test_param_pspec_attention_tp_gate():
    sizes16 = {"data": 16, "model": 16}
    path = ("layers", "attn", "wq")
    # deepseek 32 heads on 16-way: TP kept
    pl = sh.param_pspec(path, Leaf((30, 4096, 4096)), sizes16, tget_config("deepseek_7b"))
    assert sh.spec_of(pl, 3, sizes16) == (None, "data", "model")
    # minitron 24 heads on 16-way: TP dropped for wq (data kept)
    pl = sh.param_pspec(path, Leaf((32, 3072, 4096)), sizes16, tget_config("minitron_4b"))
    assert sh.spec_of(pl, 3, sizes16) == (None, "data", None)


def test_moe_expert_weights_ep_sharded():
    sizes16 = {"data": 16, "model": 16}
    pl = sh.param_pspec(("layers", "moe", "w_gate"), Leaf((94, 128, 4096, 1536)), sizes16,
                        tget_config("qwen3_moe_235b_a22b"))
    assert sh.spec_of(pl, 4, sizes16) == (None, "model", "data", None)  # E over model (EP)
    assert pl == (Shard(2), Shard(1))


def test_embed_vocab_parallel():
    sizes16 = {"data": 16, "model": 16}
    pl = sh.param_pspec(("embed",), Leaf((256000, 3072)), sizes16, tget_config("minitron_4b"))
    assert pl == (Replicate(), Shard(0))


def test_shard_helper_noop_without_mesh():
    from repro_torch.models.common import shard

    x = torch.ones((4, 6))
    assert shard(x, "data", "model") is x  # no mesh active -> the input itself


def test_pad_heads_flag():
    tflags.set_tp_pad(16)
    try:
        assert tflags.pad_heads(24) == 32
        assert tflags.pad_heads(56) == 64
        assert tflags.pad_heads(64) == 64
    finally:
        tflags.set_tp_pad(1)
    assert tflags.pad_heads(24) == 24


def test_placements_follow_mesh_order():
    sizes = {"pod": 2, "data": 16, "model": 16}
    assert sh.placements((("pod", "data"), None), sizes) == (Shard(0), Shard(0), Replicate())
    assert sh.spec_of((Shard(0), Shard(0), Replicate()), 2, sizes) == (("pod", "data"), None)
    with pytest.raises(ValueError):
        sh.placements((("data", "pod"),), sizes)


# --------------------------------------------------------------------------
# every leaf of every architecture against the JAX package
# --------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_param_placements_equal_jax(arch, mesh, strategy, strategy_flags):
    strategy_flags(strategy)
    sizes = MESHES[mesh]
    jleaves = _jax_params(arch, jflags.tp_pad())
    tcfg = tget_config(arch)
    tleaves = _port_leaves(tdry.abstract_params(tcfg))
    tpl = sh.shard_params(tdry.abstract_params(tcfg), sizes, tcfg, strategy)
    tpl = _port_leaves(tpl)
    assert len(jleaves) == len(tleaves)
    for path, leaf in jleaves:
        key = _key(path)
        assert tuple(tleaves[key].shape) == leaf.shape, key
        if strategy == "zero3":
            want = jsh._zero3_pspec(leaf, sizes)
        else:
            want = jsh.param_pspec(path, leaf, sizes, get_config(arch))
        assert sh.spec_of(tpl[key], leaf.ndim, sizes) == _norm(want), key


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_cache_placements_equal_jax(arch, mesh, strategy, strategy_flags):
    strategy_flags(strategy)
    sizes = MESHES[mesh]
    cell = SHAPES["decode_32k"]
    B, T = cell.global_batch, cell.seq_len
    cfg = get_config(arch)
    jtree = jax.eval_shape(lambda: jax_cache_spec(cfg, B, T, jnp.bfloat16))
    tcfg = tget_config(arch)
    tcache = tdry.abstract_cache(tcfg, B, T)
    trees = [(jtree, tcache, cfg.ssm_version)]
    if cfg.is_enc_dec:  # the encoder's keys and values the decode step carries
        shape = (cfg.dec_layers, B, T, cfg.n_heads, cfg.head_dim)
        jkv = {k: jax.ShapeDtypeStruct(shape, jnp.bfloat16) for k in ("k", "v")}
        trees.append((jkv, {k: torch.empty(shape, device="meta") for k in ("k", "v")}, 1))
    for jt, tt, ver in trees:
        tleaves = _port_leaves(tt)
        tpl = _port_leaves(sh.shard_cache(tt, sizes, ver))
        jleaves = jax.tree_util.tree_flatten_with_path(jt)[0]
        assert len(jleaves) == len(tleaves)
        for path, leaf in jleaves:
            key = _key(path)
            assert tuple(tleaves[key].shape) == leaf.shape, key
            want = jsh.cache_pspec(path, leaf, _standin(sizes), ver)
            assert sh.spec_of(tpl[key], leaf.ndim, sizes) == _norm(want), key


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_input_placements_equal_jax(arch, mesh, strategy, strategy_flags):
    strategy_flags(strategy)
    sizes = MESHES[mesh]
    tcfg = tget_config(arch)
    from repro_torch.configs import runnable_cells

    for c in runnable_cells(tcfg):
        inputs = tdry.cell_inputs(tcfg, SHAPES[c])
        got = sh.shard_inputs(inputs, sizes)
        for name, x in inputs.items():
            want = jsh.batch_pspec(x.shape[0], x.ndim - 1, _standin(sizes))
            assert sh.spec_of(got[name], x.ndim, sizes) == _norm(want), (c, name)
            assert got[name] == sh.batch_pspec(x.shape[0], x.ndim - 1, sizes)

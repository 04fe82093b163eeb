"""The dry run's sharded model code on values: the port's sharding
constraints and per-device bodies (``common.shard``, ``per_shard``, the
vocab-parallel embedding and cross-entropy with its own backward, the
grouped MoE dispatch and combine, the stacked and zero-initialised states,
the cache writes) run over DTensors of real CPU tensors on a 2x2 mesh of
four ``gloo`` processes, against the same step unsharded.

The dry run runs them on meta shards, where no value is computed, so only
this test holds their arithmetic to the model's.  For one architecture of
each family at ``reduced()`` (f32, heads padded to the model axis as
megatron pads them): the loss and every parameter's gradient of a train
step's forward and backward, the prefill's logits and cache, and one
decode step's logits and cache after it.  Each value is held to the
unsharded one within 1e-4 of that value's largest magnitude (the sharded
step adds partial sums in another order).  The MoE runs at a capacity
factor of ``E / K``, so that no pair is dropped: sharded, its tokens are
routed in one group a batch shard, as the JAX package groups them, each
with its own capacity, and a dropped pair would differ by design.
"""
import functools
import json
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
WORLD = 4
FAMILIES = {"dense": "deepseek_7b", "moe": "qwen3_moe_235b_a22b", "ssm": "falcon_mamba_7b",
            "hybrid": "zamba2_7b", "audio": "seamless_m4t_large_v2", "vlm": "pixtral_12b"}
PARTS = ("loss", "grads", "prefill_logits", "prefill_cache", "decode_logits", "decode_cache")
TOL = 1e-4

WORKER = textwrap.dedent(
    """
    import dataclasses, json, sys
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, port = int(sys.argv[1]), int(sys.argv[2])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=%(world)d)
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.launch import dryrun as td
    from repro_torch.launch import shardings as sh
    from repro_torch.models import common, lm
    from repro_torch.streaming import prng
    from repro_torch.training.train_step import make_prefill_step, make_serve_step

    mesh = DeviceMesh("cpu", torch.arange(%(world)d).reshape(2, 2),
                      mesh_dim_names=("data", "model"))
    B, S, T = 4, 32, 40

    def place(tree, pls):
        return common.tree_map(lambda x, pl: distribute_tensor(x, mesh, pl), tree, pls)

    def full(x):
        return x.full_tensor() if isinstance(x, DTensor) else x

    def err(got, want):
        # the largest gap over the leaves, each against its largest magnitude
        gs, ws = common.tree_leaves(got), common.tree_leaves(want)
        assert len(gs) == len(ws)
        worst = 0.0
        for g, w in zip(gs, ws):
            g, w = full(g).to(torch.float32), w.to(torch.float32)
            assert g.shape == w.shape, (g.shape, w.shape)
            scale = max(float(w.abs().max()), 1e-30)
            worst = max(worst, float((g - w).abs().max()) / scale)
        return worst

    def loss_grads(cfg, params, batch):
        leaves = common.tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = lm.forward_loss(cfg, leaves, batch, q_chunk=8, ssm_chunk=4)
        return loss, torch.autograd.grad(loss, common.tree_leaves(leaves))

    def run(cfg, params, batch, cache_pls=None):
        prefill = make_prefill_step(cfg, q_chunk=8, ssm_chunk=4)
        loss, grads = loss_grads(cfg, params, batch)
        if cfg.is_enc_dec:
            logits, cache, enc_kv = prefill(params, batch["enc_embeds"], batch["tokens"])
        elif "prefix_embeds" in batch:
            logits, cache = prefill(params, batch["tokens"], batch["prefix_embeds"])
            enc_kv = None
        else:
            logits, cache = prefill(params, batch["tokens"])
            enc_kv = None
        out = {"loss": loss, "grads": dict(enumerate(grads)), "prefill_logits": logits,
               "prefill_cache": cache}
        cache = lm.pad_cache(common.tree_map(full, cache), T)
        if enc_kv is not None:
            enc_kv = common.tree_map(full, enc_kv)
        if cache_pls is not None:  # the decode cache placed as the dry run places it
            cache = place(cache, cache_pls(cache))
            if enc_kv is not None:
                enc_kv = place(enc_kv, cache_pls(enc_kv))
        tok = torch.from_numpy(np.arange(B, dtype=np.int32)[:, None] %% cfg.vocab)
        if cache_pls is not None:
            tok = distribute_tensor(tok, mesh, sh.batch_pspec(B, 1, mesh))
        pos = batch["tokens"].shape[1] + (batch["prefix_embeds"].shape[1]
                                          if "prefix_embeds" in batch else 0)
        logits, cache = make_serve_step(cfg)(params, cache, tok, pos, enc_kv)
        out |= {"decode_logits": logits, "decode_cache": cache}
        return out

    res = {}
    for fam, arch in %(families)r.items():
        cfg = get_config(arch).reduced()
        if cfg.moe_experts:
            cfg = dataclasses.replace(cfg, capacity_factor=cfg.moe_experts / cfg.moe_top_k)
        with td.strategy_flags("megatron", 2):
            params = lm.init_params(cfg, prng.prng_key(0), torch.float32)
            rng = np.random.default_rng(0)
            inputs = td.cell_inputs(cfg, ShapeCell("t", S, B, "train"), torch.float32)
            batch = {k: (torch.from_numpy(rng.integers(0, cfg.vocab, v.shape).astype(np.int32))
                         if k == "tokens" else
                         torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32)))
                     for k, v in inputs.items()}
            want = run(cfg, params, batch)
            dparams = place(params, sh.shard_params(params, mesh, cfg, "megatron"))
            dbatch = place(batch, sh.shard_inputs(batch, mesh))
            with common.sharding_mesh(mesh), implicit_replication():
                got = run(cfg, dparams, dbatch,
                          lambda c: sh.shard_cache(c, mesh, cfg.ssm_version))
            sharded = any(isinstance(g, DTensor) and any(p.is_shard() for p in g.placements)
                          for g in common.tree_leaves(got["grads"]))
            res[fam] = {k: err(got[k], want[k]) for k in want} | {"sharded": sharded}
    if rank == 0:
        print("SHARDED_JSON " + json.dumps(res), flush=True)
    dist.destroy_process_group()
    """
) % {"world": WORLD, "families": FAMILIES}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@functools.lru_cache(maxsize=1)
def _result() -> dict:
    port = _free_port()
    env = {"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin", "HOME": str(Path.home()),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for line in outs[0][0].splitlines():
        if line.startswith("SHARDED_JSON "):
            return json.loads(line[len("SHARDED_JSON "):])
    raise AssertionError("\n".join(f"rank {r}: rc={p.returncode}\n{o[0][-1500:]}\n{o[1][-3000:]}"
                                   for r, (p, o) in enumerate(zip(procs, outs))))


@pytest.mark.parametrize("part", PARTS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_sharded_step_equals_unsharded(family, part):
    res = _result()[family]
    assert res["sharded"], "no gradient came back sharded"
    assert res[part] <= TOL, f"{family} {part}: {res[part]:.3e} of its largest magnitude"

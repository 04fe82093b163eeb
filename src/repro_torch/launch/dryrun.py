"""Multi-pod dry run: every (architecture × input-shape) cell's step sharded
on the production meshes, device-free, with its roofline terms (port of
``repro.launch.dryrun``).

For each cell the parameters, optimizer state, inputs and caches are
DTensors whose local shards are meta tensors (shapes, no memory), placed
by ``launch/shardings.py`` on a ``DeviceMesh`` over a fake process group
(``launch/mesh.py``).  The step itself (``make_train_step``,
``make_prefill_step`` or ``make_serve_step``) runs eagerly under
``models.common.sharding_mesh``, so the model's ``shard`` constraints
redistribute as GSPMD's constraints do, and ``launch/cost_analysis.py``
counts what one device does: flops, bytes, collective bytes by kind and
the peak of live bytes.  Constants the model makes (positions, masks) are
replicated (``implicit_replication``); an op that DTensor cannot shard
raises, and the cell is reported failed.

The record has the JAX record's fields, with ``lower_s`` (the seconds the
sharded step took to run here) in place of the compile time; XLA's raw,
trip-count-unaware ``cost_analysis`` has no counterpart.  It adds the
global flops, the peak bytes a device holds and ``fits``, that peak
against the card's memory.  The roofline is the NVIDIA H100 SXM5's.
Records go to ``build/dryrun/<arch>_<cell>_<mesh>[_zero3].json``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minitron_4b --cell train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes] [--strategy zero3]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import pathlib
import sys

import torch

from repro_torch.configs import SHAPES, ShapeCell, get_config, list_archs, runnable_cells
from repro_torch.launch import cost_analysis
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import fake_world, make_production_mesh, production_shape
from repro_torch.models import flags, lm
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.streaming import prng
from repro_torch.training.optimizer import AdamWState
from repro_torch.training.train_step import make_prefill_step, make_serve_step, make_train_step

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"

# NVIDIA H100 SXM5 (datasheet, dense, no sparsity): the roofline's denominators
PEAK_FLOPS = {torch.bfloat16: 989.4e12, torch.float32: 66.9e12}  # f32: no tensor cores
HBM_BW = 3.35e12  # B/s, HBM3
HBM_BYTES = 80e9  # device memory
NODE = 8  # cards joined by NVLink in one HGX H100 node
LINK_BW = 450e9  # B/s a direction, NVLink 4 (18 links x 25 GB/s), within a node
LINK_BW_INTERNODE = 50e9  # B/s a direction, one 400 Gb/s NDR InfiniBand port a card


# --------------------------------------------------------------------------
# abstract inputs per (arch, cell)
# --------------------------------------------------------------------------


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def cell_inputs(cfg, cell: ShapeCell, dtype=torch.bfloat16) -> dict:
    """Meta stand-ins for every model input of ``cell``."""
    B, S = cell.global_batch, cell.seq_len
    i32 = torch.int32
    if cell.kind in ("train", "prefill"):
        if cfg.is_enc_dec:
            return {"tokens": _meta((B, S // 4), i32),
                    "enc_embeds": _meta((B, S, cfg.d_model), dtype)}
        if cfg.family == "vlm":
            P = cfg.frontend_prefix
            return {"tokens": _meta((B, S - P), i32),
                    "prefix_embeds": _meta((B, P, cfg.d_model), dtype)}
        return {"tokens": _meta((B, S), i32)}
    # decode: one new token against a seq_len KV cache
    return {"tokens": _meta((B, 1), i32)}


def input_specs(arch: str, cell_name: str) -> dict:
    """The JAX package's ``input_specs``: meta tensors of its shapes and
    dtypes."""
    return cell_inputs(get_config(arch), SHAPES[cell_name])


def abstract_params(cfg, dtype=torch.bfloat16):
    """``lm.init_params`` on the meta device: the tree, its shapes and
    dtypes, no values."""
    return lm.init_params(cfg, prng.prng_key(0, torch.device("meta")), dtype)


def abstract_cache(cfg, B: int, T: int, dtype=torch.bfloat16):
    return lm._cache_spec(cfg, B, T, dtype, torch.device("meta"))


def count_params(abs_params) -> int:
    return sum(math.prod(x.shape) for x in tree_leaves(abs_params))


def model_flops(cfg, cell, n_params: int) -> float:
    """6·N·D for training; 2·N·D for forward-only (prefill/decode)."""
    if cell.kind == "train":
        if cfg.is_enc_dec:
            tokens = cell.global_batch * (cell.seq_len + cell.seq_len // 4)
        else:
            tokens = cell.global_batch * cell.seq_len
        n = active_params(cfg, n_params)
        return 6.0 * n * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * active_params(cfg, n_params) * tokens
    return 2.0 * active_params(cfg, n_params) * cell.global_batch  # decode: 1 tok


def mfu_flops(cfg, cell, n_params: int) -> float:
    """The model flops an MFU divides by: :func:`model_flops` over the
    parameters that multiply a token, less the input embedding table (a
    lookup) where the output table is its own, and in prefill, which
    unembeds the last position alone, less the output table too.
    ``model_flops`` (the JAX package's) counts every table on every token,
    which at a cut depth can exceed the flops the step does."""
    table = cfg.vocab * cfg.d_model
    lookup = (0 if cfg.tie_embeddings else table) + (table if cell.kind == "prefill" else 0)
    return model_flops(cfg, cell, n_params - lookup)


def active_params(cfg, n_params: int) -> float:
    """MoE: count only top-k of the expert params as active."""
    if cfg.moe_experts:
        # expert share of total params (approximate from dims)
        n_moe_layers = cfg.n_layers // cfg.moe_every
        expert_p = n_moe_layers * cfg.moe_experts * 3 * cfg.d_model * (cfg.moe_d_ff or cfg.d_ff)
        active_expert = expert_p * cfg.moe_top_k / cfg.moe_experts
        return n_params - expert_p + active_expert
    return float(n_params)


def analytic_bytes(cfg, cell, n_params: int, n_chips: int, *, dp: int | None = None,
                   tp: int = 16) -> float:
    """The JAX package's per-chip HBM traffic model (bytes/step) for the
    roofline's memory term: the traffic a fused execution pays (weights,
    optimizer, activations, scores, logits, caches), as its docstring sets
    out.  ``dp`` (batch ways) and ``tp`` (model ways, also the head
    padding) default to the production meshes'; a 1×1 mesh passes 1."""
    cell_kind = cell.kind
    B, S = cell.global_batch, cell.seq_len
    D, L = cfg.d_model, cfg.n_layers
    Hp = ((cfg.n_heads + tp - 1) // tp) * tp
    hd = cfg.head_dim
    V = cfg.vocab
    p_shard = n_params / n_chips
    dp = min(B, 32 if n_chips == 512 else 16) if dp is None else dp  # batch ways (pod x data)
    b_loc = max(1, B // dp)
    h_loc = max(1, Hp // tp)

    act_tok = b_loc * S * D * 2  # one residual tensor, bf16
    if cell_kind == "train":
        w = p_shard * 2 * 3 + p_shard * (2 * 2 + 8 * 2 + 4 * 2)  # fwd/remat/bwd + opt
        acts = 16 * L * act_tok
        if cfg.family in ("ssm", "hybrid"):
            scores = 0.0
            n_ssm = L
            acts += 10 * n_ssm * b_loc * S * cfg.d_inner * 2 / tp * min(tp, 16)
        else:
            n_attn = L if cfg.family != "hybrid" else L // max(1, cfg.hybrid_attn_every)
            scores = 2 * n_attn * b_loc * h_loc * S * S * 4
        logits = 2 * 2 * b_loc * S * (V / tp) * 2
        return w + acts + scores + logits
    if cell_kind == "prefill":
        w = p_shard * 2
        acts = 6 * L * act_tok
        if cfg.family in ("ssm", "hybrid"):
            scores = 0.0
        else:
            scores = 1 * L * b_loc * h_loc * S * S * 4
        kv = 2 * L * b_loc * S * h_loc * hd * 2
        return w + acts + scores + kv
    # decode
    w = p_shard * 2
    T = S if not (cfg.family == "hybrid" and S > 65536) else cfg.long_context_window
    if cfg.family == "ssm":
        cache = 2 * L * b_loc * cfg.d_inner / tp * max(1, cfg.ssm_state) * 4
    elif cfg.family == "hybrid":
        n_attn = L // max(1, cfg.hybrid_attn_every)
        cache = n_attn * b_loc * T * h_loc * hd * 2 * 2
        cache += 2 * L * b_loc * (cfg.d_inner / tp) * max(1, cfg.ssm_state) * 4
    else:
        n_attn = L
        cache = n_attn * b_loc * T * h_loc * hd * 2 * 2  # read k+v (+ring write small)
    acts = 8 * L * b_loc * 1 * D * 2
    return w + cache + acts


# --------------------------------------------------------------------------
# the dry run of one step
# --------------------------------------------------------------------------


def _dtensor(leaf: torch.Tensor, pl: tuple, mesh):
    """A DTensor of ``leaf``'s global shape and dtype placed by ``pl``, its
    local shard a meta tensor of this rank's shape."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape = tuple(leaf.shape)
    local, _ = compute_local_shape_and_global_offset(shape, mesh, pl)
    return DTensor.from_local(_meta(local, leaf.dtype), mesh, pl, run_check=False,
                              shape=torch.Size(shape), stride=_meta(shape, leaf.dtype).stride())


def _place(tree, pls, mesh):
    return tree_map(lambda x, pl: _dtensor(x, pl, mesh), tree, pls)


@contextlib.contextmanager
def strategy_flags(strategy: str, tp: int):
    """``flags.set_tp_pad`` / ``set_batch_axes`` for ``strategy``, restored
    on exit: megatron pads heads to the model axis ``tp`` and shards the
    batch over (pod, data); zero3 is pure DP, the model axis joining the
    batch, no padding."""
    prev = flags.tp_pad(), flags.batch_axes()
    if strategy == "zero3":
        flags.set_tp_pad(1)
        flags.set_batch_axes(("pod", "data", "model"))
    elif strategy == "megatron":
        flags.set_tp_pad(tp)
        flags.set_batch_axes(("pod", "data"))
    else:
        raise ValueError(strategy)
    try:
        yield
    finally:
        flags.set_tp_pad(prev[0])
        flags.set_batch_axes(prev[1])


def dry_run(cfg, cell: ShapeCell, mesh, *, strategy: str = "megatron", q_chunk: int = 512,
            ssm_chunk: int = 256, dtype=torch.bfloat16) -> dict:
    """One ``cell`` step of ``cfg`` sharded on ``mesh`` (any shape, 1×1
    included), parameters and embeddings in ``dtype``: the parameter
    count and :func:`cost_analysis.analyze`'s result.  Flags are set for
    ``strategy`` and restored."""
    sizes = sh._axis_sizes(mesh)
    with strategy_flags(strategy, sizes.get("model", 1)):
        abs_params = abstract_params(cfg, dtype)
        n_params = count_params(abs_params)
        params = _place(abs_params, sh.shard_params(abs_params, mesh, cfg, strategy), mesh)
        inputs = cell_inputs(cfg, cell, dtype)
        batch = _place(inputs, sh.shard_inputs(inputs, mesh), mesh)
        B, T = cell.global_batch, cell.seq_len
        if cell.kind == "train":
            pls = sh.shard_params(abs_params, mesh, cfg, strategy)
            f32 = tree_map(lambda x: _meta(x.shape, torch.float32), abs_params)
            # the step counter is replicated: every device keeps it, a scalar
            opt = AdamWState(step=torch.zeros((), dtype=torch.int32),
                             mu=_place(f32, pls, mesh), nu=_place(f32, pls, mesh))
            step = make_train_step(cfg, q_chunk=q_chunk, ssm_chunk=ssm_chunk)
            args = (params, opt, batch)
        elif cell.kind == "prefill":
            step = make_prefill_step(cfg, q_chunk=q_chunk, ssm_chunk=ssm_chunk)
            if cfg.is_enc_dec:
                args = (params, batch["enc_embeds"], batch["tokens"])
            elif cfg.family == "vlm":
                args = (params, batch["tokens"], batch["prefix_embeds"])
            else:
                args = (params, batch["tokens"])
        else:
            abs_cache = abstract_cache(cfg, B, T, dtype)
            cache = _place(abs_cache, sh.shard_cache(abs_cache, mesh, cfg.ssm_version), mesh)
            step = make_serve_step(cfg)
            pos = torch.zeros((), dtype=torch.int32)  # replicated
            args = (params, cache, batch["tokens"], pos)
            if cfg.is_enc_dec:
                kv = {k: _meta((cfg.dec_layers, B, T, cfg.n_heads, cfg.head_dim), dtype)
                      for k in ("k", "v")}
                args += (_place(kv, sh.shard_cache(kv, mesh), mesh),)
        held = args if cell.kind != "train" else (params, opt.mu, opt.nu, batch)
        res = cost_analysis.analyze(mesh, step, *args, held=held)
        return {"params": n_params, **res, "dtype": dtype}


def _axis_link(mesh) -> dict[str, float]:
    """Each mesh axis's link rate: NVLink when its ranks fit in one node
    of ``NODE`` cards, InfiniBand otherwise (ranks are laid out row-major,
    the last axis minor)."""
    shape = tuple(mesh.shape)
    out, stride = {}, 1
    for name, n in reversed(list(zip(mesh.mesh_dim_names, shape))):
        out[name] = LINK_BW if (n - 1) * stride < NODE else LINK_BW_INTERNODE
        stride *= n
    return out


def roofline(cfg, cell: ShapeCell, mesh, res: dict) -> dict:
    """The roofline terms of a :func:`dry_run` result on the card's
    constants: compute (the step dtype's peak), memory (the JAX package's
    fused-traffic model at the mesh's batch and model ways, and the counted
    bytes as an upper bound) and collectives (at the slowest link of the
    mesh's axes)."""
    n_chips = mesh.size()
    sizes = sh._axis_sizes(mesh)
    dp = min(cell.global_batch, sizes.get("pod", 1) * sizes.get("data", 1))
    coll = res["collective_bytes"]
    link = min(_axis_link(mesh).values()) if n_chips > 1 else LINK_BW
    bytes_model = analytic_bytes(cfg, cell, res["params"], n_chips, dp=dp,
                                 tp=sizes.get("model", 1))
    terms = {
        "compute_s": res["flops"] / PEAK_FLOPS[res["dtype"]],
        "memory_s": bytes_model / HBM_BW,
        "collective_s": coll.get("total", 0.0) / link,
    }
    return {"terms": terms, "dominant": max(terms, key=terms.get),
            "memory_s_parsed_upper_bound": res["bytes"] / HBM_BW,
            "analytic_bytes": bytes_model, "link_bw": link}


def record(cfg, cell: ShapeCell, mesh, *, arch: str | None = None, mesh_name: str = "",
           strategy: str = "megatron", q_chunk: int = 512, ssm_chunk: int = 256,
           dtype=torch.bfloat16) -> dict:
    """The dry run of ``cell`` on ``mesh`` (inside its ``fake_world``) as a
    record: the JAX record's fields (``lower_s`` for its compile time) and
    the global flops, the peak bytes a device holds and ``fits``."""
    res = dry_run(cfg, cell, mesh, strategy=strategy, q_chunk=q_chunk, ssm_chunk=ssm_chunk,
                  dtype=dtype)
    rf = roofline(cfg, cell, mesh, res)
    n_chips = mesh.size()
    mf = model_flops(cfg, cell, res["params"])
    flops_dev = res["flops"]
    return {
        "arch": arch or cfg.name,
        "cell": cell.name,
        "mesh": mesh_name or "x".join(map(str, mesh.shape)),
        "strategy": strategy,
        "chips": n_chips,
        "params": res["params"],
        "kind": cell.kind,
        "dtype": str(dtype).replace("torch.", ""),
        "lower_s": res["lower_s"],
        "hlo_flops_per_device": flops_dev,
        "hlo_bytes_per_device": res["bytes"],
        "analytic_bytes_per_device": rf["analytic_bytes"],
        "memory_s_parsed_upper_bound": rf["memory_s_parsed_upper_bound"],
        "collective_bytes_per_device": res["collective_bytes"],
        "top_collectives": res["top_collectives"][:10],
        "model_flops": mf,
        "mfu_flops": mfu_flops(cfg, cell, res["params"]),
        "useful_flops_ratio": mf / (flops_dev * n_chips) if flops_dev else None,
        "roofline": {**rf["terms"], "dominant": rf["dominant"]},
        "memory_analysis": {
            "output_bytes": None,
            "temp_bytes": res["temp_bytes"],
            "argument_bytes": res["argument_bytes"],
            "generated_code_bytes": None,
        },
        "global_flops": res["global_flops"],
        "peak_bytes_per_device": res["peak_bytes"],
        "fits": res["peak_bytes"] <= HBM_BYTES,
        "ops_per_device": res["n_ops"],
        "torch": torch.__version__,  # placements between constraints are its DTensor's
        "device": {"name": "NVIDIA H100 SXM5", "peak_flops": PEAK_FLOPS[dtype],
                   "hbm_bw": HBM_BW, "hbm_bytes": HBM_BYTES, "link_bw": rf["link_bw"]},
    }


def summary(rec: dict) -> str:
    """A record's figures, as the dry run prints them."""
    coll, t, m = rec["collective_bytes_per_device"], rec["roofline"], rec["memory_analysis"]
    return "\n".join([
        f"== {rec['arch']} x {rec['cell']} x {rec['mesh']} ({rec['strategy']}) ==",
        f"  params={rec['params'] / 1e9:.2f}B  lower={rec['lower_s']:.1f}s "
        f"ops/device={rec['ops_per_device']}",
        f"  per-dev: flops={rec['hlo_flops_per_device']:.3e} "
        f"bytes={rec['hlo_bytes_per_device']:.3e} coll={coll.get('total', 0):.3e} "
        + " ".join(f"{k}={coll.get(k, 0):.2e}" for k in cost_analysis.COLLECTIVES),
        f"  memory: peak={rec['peak_bytes_per_device'] / 1e9:.2f} GB (args "
        f"{m['argument_bytes'] / 1e9:.2f} + temp {m['temp_bytes'] / 1e9:.2f}) fits={rec['fits']}",
        f"  roofline: compute={t['compute_s'] * 1e3:.2f}ms memory={t['memory_s'] * 1e3:.2f}ms "
        f"(parsed-ub {rec['memory_s_parsed_upper_bound'] * 1e3:.0f}ms) "
        f"collective={t['collective_s'] * 1e3:.2f}ms dominant={t['dominant']} "
        f"useful_flops_ratio={rec['useful_flops_ratio']}",
    ])


def run_cell(
    arch: str,
    cell_name: str,
    *,
    multi_pod: bool = False,
    q_chunk: int = 512,
    ssm_chunk: int = 256,
    strategy: str = "megatron",
    save: bool = True,
    verbose: bool = True,
) -> dict:
    mesh_name = "multipod_2x16x16" if multi_pod else "pod_16x16"
    with fake_world(math.prod(production_shape(multi_pod)[0])):
        rec = record(get_config(arch), SHAPES[cell_name], make_production_mesh(multi_pod=multi_pod),
                     arch=arch, mesh_name=mesh_name, strategy=strategy, q_chunk=q_chunk,
                     ssm_chunk=ssm_chunk)
    if verbose:
        print(summary(rec), flush=True)
    if save:
        RESULTS.mkdir(parents=True, exist_ok=True)
        suffix = "" if strategy == "megatron" else f"_{strategy}"
        (RESULTS / f"{arch}_{cell_name}_{mesh_name}{suffix}.json").write_text(
            json.dumps(rec, indent=1))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--cell", type=str, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--q-chunk", type=int, default=512)
    ap.add_argument("--strategy", type=str, default="megatron", choices=["megatron", "zero3"])
    args = ap.parse_args(argv)

    jobs: list[tuple[str, str, bool]] = []
    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    for a in archs:
        cfg = get_config(a)
        cells = runnable_cells(cfg) if (args.all or not args.cell) else [args.cell]
        for c in cells:
            if args.both_meshes:
                jobs.append((a, c, False))
                jobs.append((a, c, True))
            else:
                jobs.append((a, c, args.multi_pod))

    failures = []
    for a, c, mp in jobs:
        try:
            run_cell(a, c, multi_pod=mp, q_chunk=args.q_chunk, strategy=args.strategy)
        except Exception as e:  # noqa: BLE001 — a cell that cannot lower is reported
            failures.append((a, c, mp, repr(e)[:300]))
            print(f"!! FAILED {a} x {c} multi_pod={mp}: {e}", file=sys.stderr)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        sys.exit(1)
    print(f"\nALL {len(jobs)} CELLS LOWERED OK")


if __name__ == "__main__":
    main()

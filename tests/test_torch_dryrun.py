"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's, in a subprocess like ``test_dryrun_mini.py``: importing
``repro.launch.dryrun`` sets ``XLA_FLAGS`` for 512 host devices, and the
port's dry run raises a fake process group, neither of which may reach
this test session.

The subprocess prints one JSON line, which the tests read:

* ``count_params``, ``active_params``, ``model_flops``, ``analytic_bytes``
  and ``input_specs``' shapes and dtypes of the port equal JAX's exactly,
  for every architecture x runnable cell x {256, 512} chips;
* a mini dry run of ``deepseek_7b.reduced()`` ``train`` on a 4x2 mesh
  counts flops and collective bytes;
* one train, prefill and decode cell of each family at ``reduced()`` on
  the 4x2 mesh runs to a record, whose global flops equal those the same
  step counts unsharded (``FlopCounterMode`` on meta tensors), and whose
  per-device flops times the chips are at least the global;
* those records' per-device flops, peak bytes and collective bytes equal
  fixed figures, and their ``mfu_flops`` lie within the step's flops.
"""
import functools
import json
import math
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"

ARCHS = ["minitron_4b", "deepseek_7b", "deepseek_coder_33b", "mistral_large_123b",
         "llama4_scout_17b_a16e", "qwen3_moe_235b_a22b", "zamba2_7b", "falcon_mamba_7b",
         "seamless_m4t_large_v2", "pixtral_12b"]
FAMILIES = {"dense": "deepseek_7b", "moe": "qwen3_moe_235b_a22b", "ssm": "falcon_mamba_7b",
            "hybrid": "zamba2_7b", "audio": "seamless_m4t_large_v2", "vlm": "pixtral_12b"}
KINDS = ("train", "prefill", "decode")

SCRIPT = textwrap.dedent(
    """
    import json, sys
    import repro.launch.dryrun as jd  # sets XLA_FLAGS: this process only
    from repro.configs import SHAPES, get_config, list_archs, runnable_cells
    from repro.models import flags as jflags
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import ShapeCell, get_config as tget
    from repro_torch.launch import dryrun as td
    from repro_torch.launch.mesh import fake_world, make_mesh
    from repro_torch.models import flags as tflags
    from repro_torch.training.optimizer import AdamWState
    from repro_torch.training.train_step import (
        make_prefill_step, make_serve_step, make_train_step)

    out = {"analytic": {}, "families": {}}
    # as run_cell sets them (megatron: heads padded to the model axis)
    jflags.set_tp_pad(16)
    tflags.set_tp_pad(16)
    for a in list_archs():
        cfg, tcfg = get_config(a), tget(a)
        nj = jd.count_params(jd.abstract_params(cfg))
        nt = td.count_params(td.abstract_params(tcfg))
        for c in runnable_cells(cfg):
            cell = SHAPES[c]
            ji = {k: [list(v.shape), str(v.dtype)] for k, v in jd.input_specs(a, c).items()}
            ti = {k: [list(v.shape), str(v.dtype).replace("torch.", "")]
                  for k, v in td.input_specs(a, c).items()}
            for chips in (256, 512):
                out["analytic"][f"{a}|{c}|{chips}"] = {
                    "jax": [nj, jd.active_params(cfg, nj), jd.model_flops(cfg, cell, nj),
                            jd.analytic_bytes(cfg, cell, nj, chips), ji],
                    "port": [nt, td.active_params(tcfg, nt), td.model_flops(tcfg, cell, nt),
                             td.analytic_bytes(tcfg, cell, nt, chips), ti]}
    tflags.set_tp_pad(1)

    def unsharded_flops(cfg, cell):
        # the same step on plain meta tensors, flags as the 4x2 dry run's
        with td.strategy_flags("megatron", 2):
            p = td.abstract_params(cfg, torch.bfloat16)
            b = td.cell_inputs(cfg, cell, torch.bfloat16)
            with FlopCounterMode(display=False) as fc:
                if cell.kind == "train":
                    f32 = td.tree_map(lambda x: td._meta(x.shape, torch.float32), p)
                    opt = AdamWState(step=torch.zeros((), dtype=torch.int32), mu=f32, nu=f32)
                    make_train_step(cfg, q_chunk=32, ssm_chunk=16)(p, opt, b)
                elif cell.kind == "prefill":
                    step = make_prefill_step(cfg, q_chunk=32, ssm_chunk=16)
                    if cfg.is_enc_dec:
                        step(p, b["enc_embeds"], b["tokens"])
                    else:
                        step(p, *b.values())
                else:
                    B, T = cell.global_batch, cell.seq_len
                    cache = td.abstract_cache(cfg, B, T)
                    kv = None
                    if cfg.is_enc_dec:
                        shape = (cfg.dec_layers, B, T, cfg.n_heads, cfg.head_dim)
                        kv = {k: td._meta(shape, torch.bfloat16) for k in ("k", "v")}
                    make_serve_step(cfg)(p, cache, b["tokens"],
                                         torch.zeros((), dtype=torch.int32), kv)
        return fc.get_total_flops()

    with fake_world(8):
        mesh = make_mesh((4, 2), ("data", "model"))
        r = td.dry_run(tget("deepseek_7b").reduced(), ShapeCell("train", 64, 8, "train"), mesh,
                       q_chunk=32, ssm_chunk=16)
        out["mini"] = {"flops": r["flops"], "coll": r["collective_bytes"]["total"]}
        for fam, a in %(families)r.items():
            cfg = tget(a).reduced()
            for kind in ("train", "prefill", "decode"):
                cell = ShapeCell(kind, 64, 8, kind)
                rec = td.record(cfg, cell, mesh, arch=a, q_chunk=32, ssm_chunk=16)
                rec["unsharded_flops"] = unsharded_flops(cfg, cell)
                out["families"][f"{fam}|{kind}"] = rec
    print("DRYRUN_JSON " + json.dumps(out))
    """
) % {"families": FAMILIES}


@functools.lru_cache(maxsize=1)
def _result() -> dict:
    r = subprocess.run(
        [sys.executable, "-c", SCRIPT], capture_output=True, text=True, timeout=600,
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin", "HOME": str(Path.home()),
             "JAX_PLATFORMS": "cpu"},
    )
    for line in r.stdout.splitlines():
        if line.startswith("DRYRUN_JSON "):
            return json.loads(line[len("DRYRUN_JSON "):])
    raise AssertionError(f"stdout={r.stdout[-2000:]}\nstderr={r.stderr[-4000:]}")


def _cells():
    from repro_torch.configs import get_config, runnable_cells

    return [(a, c, n) for a in ARCHS for c in runnable_cells(get_config(a)) for n in (256, 512)]


@pytest.mark.parametrize("arch,cell,chips", _cells())
def test_analytic_equal_jax(arch, cell, chips):
    got = _result()["analytic"][f"{arch}|{cell}|{chips}"]
    assert got["port"] == got["jax"]


def test_mini_dryrun_counts():
    mini = _result()["mini"]
    assert mini["flops"] > 0, "per-device flops should be nonzero"
    assert mini["coll"] > 0, "TP collectives expected"


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_cell_record(family, kind):
    rec = _result()["families"][f"{family}|{kind}"]
    for k in ("hlo_flops_per_device", "hlo_bytes_per_device", "collective_bytes_per_device",
              "top_collectives", "model_flops", "useful_flops_ratio", "roofline",
              "memory_analysis", "global_flops", "peak_bytes_per_device", "fits", "lower_s"):
        assert k in rec, k
    assert rec["chips"] == 8 and rec["kind"] == kind
    assert rec["hlo_flops_per_device"] > 0 and rec["peak_bytes_per_device"] > 0
    assert rec["roofline"]["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert all(math.isfinite(v) for k, v in rec["roofline"].items() if k != "dominant")
    # the sharded step does the unsharded step's work, split over the chips
    assert rec["global_flops"] == rec["unsharded_flops"]
    assert rec["hlo_flops_per_device"] * rec["chips"] >= rec["global_flops"]


# The reduced cells' per-device flops, peak bytes and collective bytes on the
# 4x2 mesh (megatron), as torch 2.13 counts them.  They follow where DTensor
# places each op between the model's constraints, so a torch version that
# places an op differently moves them; the constraints pin every placement
# that torch 2.11 and 2.13 chose differently (scripts/dryrun_placement.py).
PER_DEVICE = {
    "dense|train": (427819008, 3564892, 4534408),
    "dense|prefill": (92405760, 888640, 1507328),
    "dense|decode": (1572864, 448412, 75776),
    "moe|train": (465567744, 7722332, 6966416),
    "moe|prefill": (106037248, 1981248, 2703360),
    "moe|decode": (3948544, 769748, 188416),
    "ssm|train": (322961408, 15566344, 9719912),
    "ssm|prefill": (58851328, 5657344, 1327104),
    "ssm|decode": (1048576, 492468, 88320),
    "hybrid|train": (416284672, 19291216, 5618256),
    "hybrid|prefill": (80084992, 4928704, 1642496),
    "hybrid|decode": (1380352, 472052, 106880),
    "audio|train": (303038464, 3818716, 4420664),
    "audio|prefill": (68550656, 1060032, 1458176),
    "audio|decode": (1048576, 496212, 76288),
    "vlm|train": (421527552, 3572956, 4500872),
    "vlm|prefill": (92405760, 896704, 1490944),
    "vlm|decode": (1572864, 448412, 75776),
}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_cell_per_device(family, kind):
    rec = _result()["families"][f"{family}|{kind}"]
    got = (rec["hlo_flops_per_device"], rec["peak_bytes_per_device"],
           rec["collective_bytes_per_device"]["total"])
    assert got == PER_DEVICE[f"{family}|{kind}"]


# the families whose tokens meet every parameter as JAX's 6·N·D counts them
# (the audio family's encoder and decoder see different tokens; a Mamba's
# conv, decay and skip parameters do no matmul)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("family", ["dense", "moe", "hybrid", "vlm"])
def test_mfu_flops_within_step(family, kind):
    rec = _result()["families"][f"{family}|{kind}"]
    assert 0 < rec["mfu_flops"] <= rec["global_flops"]
    assert rec["mfu_flops"] < rec["model_flops"]  # less the embedding lookup

"""The port's training path (``repro_torch.training``, ``launch/train.py``
and ``examples/torch/train_lm.py``) against the JAX package's, on the CPU
in f32.

Tolerances, where the two sides' f32 products and sums round differently:

* loss and the pre-clip grad norm: ``rtol=1e-5``;
* AdamW moments: ``1e-4`` of the leaf's largest magnitude (sums of
  per-token gradients over the batch, added in another order);
* parameters after a step: ``0.05 * lr``.  An AdamW step moves a lane by
  about ``lr`` times ``m / sqrt(v)``, which is +-1 at the first step
  whatever the gradient's size, so a lane whose gradient lies within
  rounding of zero may step the other way; 0.05 lr is well above what the
  runs here show (under 0.03 lr) and far below a step of lr.

The printed metric windows of ``launch.train.main`` are the JAX lines
(times aside), their values to the printed digits.  The mirrors of
``tests/test_train_loop.py`` run on the port alone, the restore bitwise.
"""
import contextlib
import dataclasses
import io
import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import train as jtrain
from repro.models import init_params as jinit_params
from repro.training import adamw_init as jadamw_init
from repro.training import adamw_update as jadamw_update
from repro.training.checkpoint import LocalStore as JLocalStore
from repro.training.checkpoint import TrainCheckpoint as JTrainCheckpoint
from repro.training.metrics import MetricSpec as JMetricSpec
from repro.training.metrics import metrics_fold as jmetrics_fold
from repro.training.metrics import metrics_init as jmetrics_init
from repro.training.train_step import make_train_step as jmake_train_step
from repro_torch import configs
from repro_torch.convert import adamw_from_numpy, params_from_numpy, train_state_from_numpy
from repro_torch.launch import train
from repro_torch.models import init_params
from repro_torch.models.common import tree_leaves
from repro_torch.streaming import prng
from repro_torch.training import adamw_init, adamw_update
from repro_torch.training.checkpoint import LocalStore, TrainCheckpoint, to_numpy_tree
from repro_torch.training.metrics import MetricSpec, metrics_fold
from repro_torch.training.train_step import make_train_step

ROOT = Path(__file__).resolve().parents[1]
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Small f32 products: a few intra-op threads a process, restored after,
    so the workers of a parallel test run do not spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _cfgs():
    """minitron-4b reduced to 2 layers, with 2 kv heads under 4 query heads
    so that GQA runs: the port's config and the JAX one."""
    kw = dict(n_kv_heads=2, n_layers=2)
    return (dataclasses.replace(configs.get_config("minitron_4b").reduced(), **kw),
            dataclasses.replace(jconfigs.get_config("minitron_4b").reduced(), **kw))


def _tokens(step: int, cfg) -> np.ndarray:
    return np.random.default_rng(step).integers(0, cfg.vocab, (2, 64)).astype(np.int32)


def _assert_trees_close(got, want, kind: str):
    """``got`` (port tree) against ``want`` (JAX tree) leaf by leaf."""
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        b = np.asarray(b)
        atol = 0.05 * LR if kind == "params" else 1e-4 * float(np.abs(b).max())
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=atol, err_msg=kind)


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX train steps of the test config, jitted once: grad_accum 1 and 2."""
    _, jcfg = _cfgs()
    return {ga: jax.jit(jmake_train_step(jcfg, q_chunk=32, lr=LR, grad_accum=ga))
            for ga in (1, 2)}


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


def test_adamw_update_matches_jax():
    """One clipped AdamW step over a small tree, at step 1 and step 7 (the
    bias corrections go through XLA's f32 pow on both sides)."""
    rng = np.random.default_rng(2)
    shapes = {"a": (3, 5), "b": {"c": (7,), "d": (2, 2, 2)}}
    mk = lambda s: jax.tree.map(lambda sh: rng.standard_normal(sh).astype(np.float32), s,
                                is_leaf=lambda x: isinstance(x, tuple))
    p, g, m, v = mk(shapes), mk(shapes), mk(shapes), jax.tree.map(np.abs, mk(shapes))
    for step in (0, 6):
        js = jadamw_init(jax.tree.map(jnp.asarray, p))
        js = dataclasses.replace(js, step=jnp.int32(step), mu=jax.tree.map(jnp.asarray, m),
                                 nu=jax.tree.map(jnp.asarray, v))
        jp, jst, jn = jadamw_update(jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, g),
                                    js, lr=LR, grad_clip=2.0)
        ps = adamw_init(params_from_numpy(p))
        ps = dataclasses.replace(ps, step=torch.tensor(step, dtype=torch.int32),
                                 mu=params_from_numpy(m), nu=params_from_numpy(v))
        pp, pst, pn = adamw_update(params_from_numpy(p), params_from_numpy(g), ps, lr=LR,
                                   grad_clip=2.0)
        np.testing.assert_allclose(float(pn), float(jn), rtol=1e-5)
        assert int(pst.step) == int(jst.step) == step + 1
        _assert_trees_close(pp, jp, "params")
        _assert_trees_close(pst.mu, jst.mu, "mu")
        _assert_trees_close(pst.nu, jst.nu, "nu")


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_matches_jax(jax_steps, grad_accum):
    """One ``make_train_step`` step from the same parameters and tokens:
    loss, grad norm, tokens, the updated parameters and moments."""
    cfg, jcfg = _cfgs()
    jp = jinit_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    p = init_params(cfg, prng.prng_key(0), dtype=torch.float32)
    toks = _tokens(0, cfg)
    jp, jo, js = jax_steps[grad_accum](jp, jadamw_init(jp), {"tokens": jnp.asarray(toks)})
    step = make_train_step(cfg, q_chunk=32, lr=LR, grad_accum=grad_accum)
    p, o, s = step(p, adamw_init(p), {"tokens": torch.from_numpy(toks).long()})
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(s[k]), float(js[k]), rtol=1e-5, err_msg=k)
    assert float(s["tokens"]) == float(js["tokens"]) == toks.size
    assert int(o.step) == 1
    _assert_trees_close(p, jp, "params")
    _assert_trees_close(o.mu, jo.mu, "mu")
    _assert_trees_close(o.nu, jo.nu, "nu")


def test_jax_checkpoint_trains_on_in_the_port(jax_steps, tmp_path):
    """A JAX ``LocalStore`` blob (params, AdamW state and metric windows at
    step 2), unpickled here beside the JAX package and handed to
    ``convert.train_state_from_numpy`` as numpy trees, trains on in the
    port to the JAX run's step 4."""
    cfg, jcfg = _cfgs()
    jspec, spec = JMetricSpec(num_workers=2, window_len=1), MetricSpec(num_workers=2,
                                                                       window_len=1)
    jp = jinit_params(jcfg, jax.random.PRNGKey(5), dtype=jnp.float32)
    jo, jm = jadamw_init(jp), jmetrics_init(jspec)
    for t in range(4):
        if t == 2:
            JLocalStore(tmp_path).put("w0", JTrainCheckpoint(step=2, data_idx=2, params=jp,
                                                             opt=jo, metrics=jm, rng_seed=5))
        jp, jo, js = jax_steps[1](jp, jo, {"tokens": jnp.asarray(_tokens(t, cfg))})
        jm = jmetrics_fold(jspec, jm, t % 2, t // 2, js["loss"], js["tokens"], js["grad_norm"])
    with open(tmp_path / "w0.ckpt", "rb") as f:
        blob = pickle.load(f)  # needs the JAX package's classes
    ck = TrainCheckpoint(step=blob["step"], data_idx=blob["data_idx"],
                         params=to_numpy_tree(blob["params"]), opt=to_numpy_tree(blob["opt"]),
                         metrics=to_numpy_tree(blob["metrics"]), rng_seed=blob["rng_seed"])
    p, o, m = train_state_from_numpy(ck, spec)
    assert int(o.step) == 2
    step = make_train_step(cfg, q_chunk=32, lr=LR)
    for t in range(2, 4):
        p, o, s = step(p, o, {"tokens": torch.from_numpy(_tokens(t, cfg)).long()})
        m = metrics_fold(spec, m, t % 2, t // 2, s["loss"], s["tokens"], s["grad_norm"])
    _assert_trees_close(p, jp, "params")
    _assert_trees_close(o.mu, jo.mu, "mu")
    for name in m:
        for f in ("slot_wid", "progress", "folded", "errors"):
            np.testing.assert_array_equal(getattr(m[name], f)[0].numpy(),
                                          np.asarray(getattr(jm[name], f)))
        for f, a in dataclasses.asdict(jm[name].windows).items():
            np.testing.assert_allclose(getattr(m[name].windows, f)[0].numpy(), np.asarray(a),
                                       rtol=1e-5)


def _run(main, argv) -> list:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue().splitlines()


_NUM = re.compile(r"(mean_loss|gnorm_max|final_loss)=([0-9.]+)")


def _split(lines) -> tuple:
    """The lines without their times and numbers, and the numbers."""
    text, nums = [], []
    for ln in lines:
        ln = re.sub(r"\(\d+\.\ds\)|in \d+\.\ds", "", ln)
        nums += [float(v) for _, v in _NUM.findall(ln)]
        text.append(_NUM.sub(r"\1=", ln))
    return text, nums


def test_launch_main_prints_the_jax_windows(tmp_path):
    """``main([... --device cpu])`` against the JAX ``main``, a crash after
    step 7 restored from step 5: the same lines (resume, windows, crash,
    done), each number to its printed digits."""
    argv = ["--steps", "12", "--seq", "64", "--batch", "2", "--crash-at", "7",
            "--ckpt-every", "5", "--metric-window", "1"]
    want = _run(jtrain.main, argv + ["--ckpt-dir", str(tmp_path / "jax")])
    got = _run(train.main, argv + ["--ckpt-dir", str(tmp_path / "port"), "--device", "cpu"])
    assert sum("[window" in ln for ln in want) == 3 and any("[crash]" in ln for ln in want)
    (gt, gn), (wt, wn) = _split(got), _split(want)
    assert gt == wt
    np.testing.assert_allclose(gn, wn, atol=1.5e-3, rtol=0)


# ---------------------------------------------------------------------------
# tests/test_train_loop.py on the port
# ---------------------------------------------------------------------------


def test_adamw_matches_reference_update():
    """One AdamW step against a hand-computed reference."""
    p = {"w": torch.tensor([1.0, -2.0])}
    g = {"w": torch.tensor([0.5, 0.1])}
    st = adamw_init(p)
    lr, b1, b2, eps, wd = 1e-2, 0.9, 0.95, 1e-8, 0.0
    new_p, new_st, gnorm = adamw_update(p, g, st, lr=lr, b1=b1, b2=b2, eps=eps,
                                        weight_decay=wd, grad_clip=1e9)
    m = (1 - b1) * np.array([0.5, 0.1])
    v = (1 - b2) * np.array([0.25, 0.01])
    ref = np.array([1.0, -2.0]) - lr * (m / (1 - b1)) / (np.sqrt(v / (1 - b2)) + eps)
    np.testing.assert_allclose(new_p["w"].numpy(), ref, rtol=1e-6)
    np.testing.assert_allclose(float(gnorm), np.sqrt(0.25 + 0.01), rtol=1e-5)
    assert int(new_st.step) == 1


def test_grad_clip_scales_update():
    p = {"w": torch.tensor([0.0])}
    g = {"w": torch.tensor([100.0])}
    _, _, gnorm = adamw_update(p, g, adamw_init(p), grad_clip=1.0)
    assert float(gnorm) > 99.0  # reported norm is pre-clip


def test_checkpoint_restore_bit_exact(tmp_path):
    """Crash after step k, restore, re-run: identical final params and
    moments (the deterministic-replay property Algorithm 2 relies on)."""
    cfg = train.PRESETS["tiny"]
    step_fn = make_train_step(cfg, q_chunk=64, ssm_chunk=32)
    params = init_params(cfg, prng.prng_key(0), dtype=torch.float32)
    opt = adamw_init(params)
    batch = lambda s: train.synthetic_batch(0, s, 2, 64, cfg.vocab, "cpu")

    p1, o1 = params, opt
    for s in range(6):
        p1, o1, _ = step_fn(p1, o1, batch(s))

    store = LocalStore(tmp_path)
    p2, o2 = params, opt
    for s in range(3):
        p2, o2, _ = step_fn(p2, o2, batch(s))
    store.put("w0", TrainCheckpoint(step=3, data_idx=3, params=p2, opt=o2, metrics={},
                                    rng_seed=0))
    del p2, o2  # crash: lose volatile state
    ck = store.get("w0")
    p3, o3 = params_from_numpy(ck.params), adamw_from_numpy(ck.opt)
    for s in range(ck.step, 6):
        p3, o3, _ = step_fn(p3, o3, batch(s))

    for a, b in zip(tree_leaves(p1) + tree_leaves(o1.mu) + tree_leaves(o1.nu),
                    tree_leaves(p3) + tree_leaves(o3.mu) + tree_leaves(o3.nu)):
        assert torch.equal(a, b)
    assert int(o1.step) == int(o3.step) == 6


def test_checkpoint_store_keeps_largest_step(tmp_path):
    store = LocalStore(tmp_path)
    mk = lambda s: TrainCheckpoint(step=s, data_idx=s, params={"w": torch.zeros(1)},
                                   opt={}, metrics={}, rng_seed=0)
    assert store.put("k", mk(5))
    assert not store.put("k", mk(3))  # stale write refused (lattice rule)
    assert store.get_step("k") == 5
    assert store.put("k", mk(9))
    assert store.get_step("k") == 9


def test_synthetic_batch_is_the_jax_token_stream():
    for seed, idx in ((0, 0), (0, 7), (3, 12)):
        want = np.asarray(jtrain.synthetic_batch(seed, idx, 3, 40, 32_000)["tokens"])
        got = train.synthetic_batch(seed, idx, 3, 40, 32_000, "cpu")["tokens"]
        np.testing.assert_array_equal(got.numpy(), want)
    assert train.PRESETS.keys() == jtrain.PRESETS.keys()
    for k in train.PRESETS:
        assert dataclasses.asdict(train.PRESETS[k]) == dataclasses.asdict(jtrain.PRESETS[k])
    assert train.DEFAULT_CKPT_DIR != "/tmp/repro_ckpt"


# ---------------------------------------------------------------------------
# examples/torch/train_lm.py
# ---------------------------------------------------------------------------


def test_train_lm_example_runs_the_jax_examples_schedules(monkeypatch):
    """The example hands the launcher the JAX example's arguments (the tiny
    demo: 40 steps, a crash after step 25, a checkpoint every 10; or
    ``--full``: 100m at batch 8 x seq 512 for 300 steps), with ``--device``
    and a checkpoint directory of its own."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("example_torch_train_lm",
                                                  ROOT / "examples" / "torch" / "train_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    seen = []
    monkeypatch.setattr(train, "main", lambda argv: seen.append(argv))
    mod.main(["--device", "cpu", "--ckpt-dir", "d"])
    mod.main(["--full"])
    tiny, full = seen
    assert tiny[:tiny.index("--device")] == ["--preset", "tiny", "--steps", "40", "--crash-at",
                                             "25", "--ckpt-every", "10"]
    assert tiny[tiny.index("--device"):] == ["--device", "cpu", "--ckpt-dir", "d"]
    assert full[:8] == ["--preset", "100m", "--steps", "300", "--batch", "8", "--seq", "512"]
    assert full[full.index("--device") + 1] == "cuda"
    assert full[full.index("--ckpt-dir") + 1] != "/tmp/repro_example_ckpt"


def test_train_lm_example_help_imports_no_torch():
    code = ("import runpy, sys\nsys.argv = [sys.argv[1], '--help']\n"
            "try:\n    runpy.run_path(sys.argv[0], run_name='__main__')\n"
            "except SystemExit as e:\n    assert e.code in (0, None), e.code\n"
            "print('TORCH' if 'torch' in sys.modules else 'NO TORCH')\n")
    r = subprocess.run([sys.executable, "-c", code, str(ROOT / "examples" / "torch" / "train_lm.py")],
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert r.returncode == 0, r.stderr
    assert "--device" in r.stdout and r.stdout.strip().endswith("NO TORCH"), r.stdout

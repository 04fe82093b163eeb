"""The port's threefry generator against the JAX package's, CPU only.

``repro_torch.streaming.generator.generate_log(cfg, device="cpu")`` must
draw the JAX ``generate_log(cfg)`` for the same ``NexmarkConfig``: every
field bitwise, at every ``key_skew`` (the zipf ids go through ``pow``,
which XLA's CPU computes by glibc's ``powf`` and ``prng.pow_f32`` by a port
of it).  The unit cases hold ``streaming/prng.py`` bitwise to
``jax.random`` and XLA's elementary functions; the end-to-end case runs each
side's ``build_pipeline`` on each side's own log, with no numpy hand-over
between them.
"""
import dataclasses
import itertools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.streaming import events as jev
from repro.streaming import generator as jgen
from repro_torch.launch import stream
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.streaming import generator, prng

FIELDS = [f.name for f in dataclasses.fields(jev.EventBatch)]
INT_FIELDS = ("ts", "kind", "bidder", "valid")


def _bits(x) -> np.ndarray:
    return np.asarray(x).view(np.uint32).astype(np.int64)


def _keys(seed: int, data: tuple):
    """The JAX key and the port's of ``PRNGKey(seed)`` folded with ``data``."""
    jkey, key = jax.random.PRNGKey(seed), prng.prng_key(seed)
    for d in data:
        jkey, key = jax.random.fold_in(jkey, d), prng.fold_in(key, d)
    return jkey, key


def _same_key(got: prng.Key, jkey) -> None:
    k = np.asarray(jkey).astype(np.int64)
    np.testing.assert_array_equal(got[0].numpy(), k[..., 0])
    np.testing.assert_array_equal(got[1].numpy(), k[..., 1])


# ---------------------------------------------------------------------------
# unit cases: streaming/prng.py against jax.random, all bitwise
# ---------------------------------------------------------------------------

KEYS = [(0, ()), (42, (3,)), (2**31 - 1, (5, 11))]  # seed, fold_in data


@pytest.mark.parametrize("key, count, want", [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
])
def test_threefry2x32_known_answers(key, count, want):
    """Random123's known-answer vectors, which JAX's threefry also gives
    (bitwise)."""
    t = lambda v: torch.tensor(v, dtype=torch.int64)
    got = prng.threefry2x32(t(key[0]), t(key[1]), t(count[0]), t(count[1]))
    assert (int(got[0]), int(got[1])) == want


def test_threefry2x32_matches_jax_on_many_counters():
    from jax._src import prng as jprng

    rng = np.random.default_rng(0)
    key = rng.integers(0, 2**32, 2, dtype=np.uint64).astype(np.uint32)
    count = rng.integers(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jprng.threefry_2x32(key, count)).astype(np.int64)
    # JAX hashes the two halves of the counter array as the two words
    c = torch.tensor(count.astype(np.int64))
    k1, k2 = (torch.tensor(int(v)) for v in key)
    o1, o2 = prng.threefry2x32(k1, k2, c[:500], c[500:])
    np.testing.assert_array_equal(torch.cat([o1, o2]).numpy(), want)


@pytest.mark.parametrize("seed, data", KEYS)
def test_prng_key_fold_in_and_split(seed, data):
    jkey, key = jax.random.PRNGKey(seed), prng.prng_key(seed)
    _same_key(key, jkey)
    for d in data:
        jkey, key = jax.random.fold_in(jkey, d), prng.fold_in(key, d)
        _same_key(key, jkey)
    for num in (2, 4, 7):
        for got, want in zip(prng.split(key, num), jax.random.split(jkey, num)):
            _same_key(got, want)


def test_fold_in_and_split_vectorise_over_keys():
    """A ``[S, nb]`` batch of keys gives each (partition, batch) key of
    the JAX generator's two ``vmap``s."""
    S, nb = 3, 4
    key = prng.fold_in(prng.prng_key(7), torch.arange(S)[:, None])
    key = prng.fold_in(key, torch.arange(nb)[None, :])
    splits = prng.split(key, 4)
    for p, b in itertools.product(range(S), range(nb)):
        jkey = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(7), p), b)
        _same_key((key[0][p, b], key[1][p, b]), jkey)
        for i, want in enumerate(jax.random.split(jkey, 4)):
            _same_key((splits[i][0][p, b], splits[i][1][p, b]), want)


@pytest.mark.parametrize("seed, data", KEYS)
@pytest.mark.parametrize("n", [1, 7, 1000])
def test_random_bits_and_uniform(seed, data, n):
    jkey, key = _keys(seed, data)
    np.testing.assert_array_equal(prng.random_bits(key, n).numpy(),
                                  np.asarray(jax.random.bits(jkey, (n,))).astype(np.int64))
    for lo, hi in ((0.0, 1.0), (0.0, 0.4), (-3.5, 2.25)):
        got = prng.uniform(key, n, lo, hi)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(_bits(got.numpy()),
                                      _bits(jax.random.uniform(jkey, (n,), minval=lo, maxval=hi)))


@pytest.mark.parametrize("lo, hi", [(0, 1), (0, 7), (0, 1000), (0, 10_000), (0, 1_000_000),
                                    (-5, 17), (0, 2**31 - 1)])
def test_randint(lo, hi):
    """Two words a value, reduced in wrapping u32 arithmetic: spans past
    2^16 wrap the multiplier (bitwise)."""
    for seed, data in KEYS:
        jkey, key = _keys(seed, data)
        np.testing.assert_array_equal(prng.randint(key, 4096, lo, hi).numpy(),
                                      np.asarray(jax.random.randint(jkey, (4096,), lo, hi)))


@pytest.mark.parametrize("seed, data", KEYS)
def test_normal(seed, data):
    """XLA's erf_inv polynomial over its log1p, square root and fused
    multiply-adds (bitwise, 2^16 lanes a key)."""
    jkey, key = _keys(seed, data)
    n = 1 << 16
    np.testing.assert_array_equal(_bits(prng.normal(key, n).numpy()),
                                  _bits(jax.random.normal(jkey, (n,))))


@pytest.mark.parametrize("name, lo, hi", [
    ("xla_exp", -90.0, 90.0), ("xla_log", 1e-30, 1e30), ("xla_log1p", -0.999, 50.0),
    ("erf_inv", -1.0, 1.0),
])
def test_xla_elementary_functions(name, lo, hi):
    """The f32 ``exp``, ``log``, ``log1p`` and ``erf_inv`` that XLA's CPU
    backend emits, bitwise on 2^18 lanes (log-spaced for ``log``)."""
    rng = np.random.default_rng(1)
    if name == "xla_log":
        x = np.exp(rng.uniform(np.log(lo), np.log(hi), 1 << 18))
    else:
        x = rng.uniform(lo, hi, 1 << 18)
    x = x.astype(np.float32)
    jfn = {"xla_exp": jnp.exp, "xla_log": jnp.log, "xla_log1p": jnp.log1p,
           "erf_inv": jax.lax.erf_inv}[name]
    got = getattr(prng, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(jax.jit(jfn)(x)))


def test_pow_f32_within_an_ulp_of_xla():
    """``pow_f32`` is glibc's ``powf``, which XLA's CPU ``pow`` calls: bitwise
    (no ulp apart) over random f32 bit patterns (subnormals, negatives,
    zeros, infinities and NaNs among them) at integer, odd, fractional,
    tiny and overflowing powers."""
    x = np.random.default_rng(5).integers(0, 2**32, 1 << 16, dtype=np.uint64)
    x = x.astype(np.uint32).view(np.float32)
    for e in (-10.0, -1.5, 0.7, 3.0, -3.0, 1e-3, 200.0):
        got = prng.pow_f32(torch.from_numpy(x), e).numpy()
        want = np.asarray(jnp.asarray(x) ** e)
        same = (_bits(got) == _bits(want)) | (np.isnan(got) & np.isnan(want))
        assert same.all(), (e, x[~same][:4], got[~same][:4], want[~same][:4])


@pytest.mark.parametrize("key_skew", (1.1, 1.5))
def test_pow_f32_bitwise_on_the_zipf_domain(key_skew):
    """2^20 lanes of the generator's own ``pow``: the zipf base
    ``u * ((N+1)^(1-s) - 1) + 1`` at N = 10^6 raised to ``1/(1-s)``, as
    ``generator.py`` draws ids, bitwise against XLA's ``pow``."""
    N, s = 1e6, key_skew
    u = np.random.default_rng(11).uniform(0.0, 1.0, 1 << 20).astype(np.float32)
    base = u * np.float32((N + 1.0) ** (1.0 - s) - 1.0) + np.float32(1.0)
    got = prng.pow_f32(torch.from_numpy(base), 1.0 / (1.0 - s)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(jnp.asarray(base) ** (1.0 / (1.0 - s))))


# ---------------------------------------------------------------------------
# generate_log field by field
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key_skew, skew, seed, num_auctions", list(itertools.product(
    (0.0, 1.0, 1.1), (0.0, 1.5), (0, 7), (1000, 1_000_000))))
def test_generate_log_matches_jax(key_skew, skew, seed, num_auctions):
    kw = dict(num_partitions=3, num_batches=3, events_per_batch=256, seed=seed, skew=skew,
              key_skew=key_skew, num_auctions=num_auctions)
    jlog = jgen.generate_log(jgen.NexmarkConfig(**kw))
    log = generator.generate_log(generator.NexmarkConfig(**kw), device="cpu")
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(log, f).numpy(), np.asarray(getattr(jlog, f)), f)
    np.testing.assert_array_equal(_bits(log.price.numpy()), _bits(jlog.price))
    ids = log.auction.numpy()
    np.testing.assert_array_equal(ids, np.asarray(jlog.auction).astype(np.int64))
    np.testing.assert_array_equal(log.category.numpy(), ids % 5)
    assert log.category.dtype == torch.int32 and log.auction.dtype == torch.int64


# ---------------------------------------------------------------------------
# end to end: each side's pipeline on each side's own log
# ---------------------------------------------------------------------------

NB, B, WIN, SLOTS, QUERIES = 8, 64, 10, 16, ("q0", "q4", "q5", "q7")

_JAX_SCRIPT = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import numpy as np
from repro import compat
from repro.launch.stream import MAKERS, build_pipeline, read_window_range
from repro.streaming import NexmarkConfig, generate_log

mesh = compat.make_mesh((2,), ("data",))
nx = NexmarkConfig(num_partitions=2, num_batches={NB}, events_per_batch={B})
log = generate_log(nx)
out = {{}}
for qn in {QUERIES}:
    q = MAKERS[qn](2, window_len={WIN}, num_slots={SLOTS})
    first, n = read_window_range(q, nx.num_batches * nx.batch_span_ms)
    with mesh:
        o, v, s = build_pipeline(q, mesh, 4, n_windows=n, first_window=first)(log)
    for name, x in (("oks", o), ("vals", v), ("sync", s)):
        out[qn + "." + name] = np.asarray(x)
np.savez(sys.argv[1], **out)
print("JAX_PIPELINE_OK")
""".format(NB=NB, B=B, WIN=WIN, SLOTS=SLOTS, QUERIES=QUERIES)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax") / "pipeline.npz"
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    env.pop("XLA_FLAGS", None)  # the script sets its own device count
    r = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(out)],
                       capture_output=True, text=True, timeout=600, env=env)
    assert "JAX_PIPELINE_OK" in r.stdout, f"stdout={r.stdout[-2000:]}\nstderr={r.stderr[-2000:]}"
    return dict(np.load(out))


@pytest.mark.parametrize("qname", QUERIES)
def test_pipeline_on_own_logs_matches_jax(jax_run, qname):
    """q0 and q5 use no price; q4's fold adds lane by lane as the JAX fold
    does and q7 keeps exact prices, and ``price`` is bitwise, so all four
    match bitwise (stricter than q4's rtol 1e-5 and q7's price bound)."""
    nx = generator.NexmarkConfig(num_partitions=2, num_batches=NB, events_per_batch=B)
    log = generator.generate_log(nx, device="cpu")
    q = stream.MAKERS[qname](2, window_len=WIN, num_slots=SLOTS)
    first, n = stream.read_window_range(q, nx.num_batches * nx.batch_span_ms)
    oks, vals, sb = stream.build_pipeline(q, make_data_mesh(2, "cpu"), 4, n_windows=n,
                                          first_window=first)(log)
    assert oks.sum() > 0
    np.testing.assert_array_equal(oks.numpy(), jax_run[qname + ".oks"])
    np.testing.assert_array_equal(sb.numpy(), jax_run[qname + ".sync"])
    np.testing.assert_array_equal(vals.numpy(), jax_run[qname + ".vals"])

"""A run imports nothing of JAX or of the JAX package: the top-level name of
every module loaded, the part before the first dot, compared whole (the
program's name, ``repro_torch``, begins with the JAX package's)."""
import subprocess
import sys

from holonbench import bench
from holonbench.cell import ROOT

PROBE = f"""
import sys
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
from holonbench import bench
from holonbench.cell import find_cell
for name, scale in {{'dense-q5-10k': dict(num_keys=1024, num_slots=16),
                     'keyed-q5-1m': dict(num_keys=2000)}}.items():
    scale.update(events_per_batch=256, rate_per_partition=256.0, num_batches=24)
    for trace in (False, True):
        bench.run(find_cell(name), bench.Options(seed=1, seconds=0.2, trace=trace,
                                                  device='cpu', scale=scale))
import repro_torch
print('forbidden=' + ','.join(bench.forbidden_modules()))
"""


def test_names_compared_whole(monkeypatch):
    for m in ("repro_torch.launch.stream", "reprox", "jaxfoo", "flaxen"):
        monkeypatch.setitem(sys.modules, m, sys)
    assert not [m for m in bench.forbidden_modules() if m in
                ("repro_torch.launch.stream", "reprox", "jaxfoo", "flaxen")]
    for m in ("repro", "repro.core.wcrdt", "jax", "jaxlib.xla_client", "flax.linen"):
        monkeypatch.setitem(sys.modules, m, sys)
        assert m in bench.forbidden_modules()


def test_a_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "forbidden="


def test_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "holonbench/run.py", "--workload", "keyed-q5-1m",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""

"""The port's examples (``examples/torch/*.py``) against the JAX package's.

Each example runs in this process through its ``main(argv)`` with
``--device cpu`` at a small ``--batches``, beside the JAX example of the
same name with the same arguments, and must print the same lines.  The
one line that differs by design is ``hot_items``' dataplane line: the port
stacks its ``--partitions`` on one device where the JAX example spreads
them over devices, so with ``--partitions 1`` (one JAX device on the CPU)
it names them otherwise and every number in it is the same.  Each example
asserts its own oracle on the way.

``--help`` answers in a fresh interpreter without importing torch, so it
touches no device.
"""
import contextlib
import importlib.util
import io
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("quickstart", "nexmark_stream", "hot_items", "failure_recovery_demo")
# arguments of both sides; the port's also get --device cpu
ARGS = {"quickstart": [], "nexmark_stream": ["--batches", "40"],
        "hot_items": ["--batches", "40"], "failure_recovery_demo": ["--batches", "40"]}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The runtime folds tensors of a few KB, op by op: one intra-op thread
    a process, or the workers of a parallel test run spin against each
    other on the CPU's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(f"example_{path.parent.name}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(path: Path, argv: list) -> list:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _load(path).main(argv)
    return out.getvalue().splitlines()


@pytest.mark.parametrize("name", NAMES)
def test_example_prints_the_jax_examples_lines(name):
    want = _lines(ROOT / "examples" / f"{name}.py", ARGS[name])
    argv = ARGS[name] + ["--device", "cpu"]
    if name == "hot_items":
        argv += ["--partitions", "1"]
        want = [ln.replace("on 1 device(s)", "on 1 stacked partition(s)") for ln in want]
    got = _lines(ROOT / "examples" / "torch" / f"{name}.py", argv)
    assert got == want and len(got) >= 5


def test_hot_items_stacks_partitions():
    """The default four stacked partitions: the dataplane's windows still
    hold their oracle (asserted inside) and its line names the stack."""
    got = _lines(ROOT / "examples" / "torch" / "hot_items.py",
                 ["--batches", "40", "--device", "cpu"])
    assert "on 4 stacked partition(s), byte-identical to the oracle" in got[-1]


_HELP = """
import runpy, sys
sys.argv = [sys.argv[1], "--help"]
try:
    runpy.run_path(sys.argv[0], run_name="__main__")
except SystemExit as e:
    assert e.code in (0, None), e.code
print("TORCH" if "torch" in sys.modules else "NO TORCH")
"""


@pytest.mark.parametrize("name", NAMES)
def test_example_help_imports_no_torch(name):
    path = ROOT / "examples" / "torch" / f"{name}.py"
    r = subprocess.run([sys.executable, "-c", _HELP, str(path)], capture_output=True, text=True,
                       timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert r.returncode == 0, r.stderr
    assert "--device" in r.stdout and r.stdout.strip().endswith("NO TORCH"), r.stdout

"""Every public name of the JAX package's subpackages has a counterpart at
the same place in the port: ``repro.<sub>.<name>`` -> ``repro_torch.<sub>.
<name>`` for core, streaming, runtime, obs, training and models.  Every
name can have one (the JAX ``compat`` shim is no subpackage of these), so
none is excepted."""
import importlib

import pytest

SUBPACKAGES = ("core", "streaming", "runtime", "obs", "training", "models")


def _public(sub: str) -> list[str]:
    mod = importlib.import_module(f"repro.{sub}")
    names = getattr(mod, "__all__", None) or [k for k in dir(mod) if not k.startswith("_")]
    return sorted(names)


CASES = [(sub, name) for sub in SUBPACKAGES for name in _public(sub)]


@pytest.mark.parametrize("sub,name", CASES)
def test_public_name_has_counterpart(sub, name):
    port = importlib.import_module(f"repro_torch.{sub}")
    assert hasattr(port, name), f"repro_torch.{sub} has no {name}"


def test_port_exports_its_names():
    for sub in ("core", "streaming"):
        port = importlib.import_module(f"repro_torch.{sub}")
        assert set(_public(sub)) <= set(port.__all__)

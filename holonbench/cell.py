"""Finding a cell and its parts by name.

``BENCHMARK.json`` at the root of the checkout names every cell
(``workloads``), configuration and metric.  A cell's traffic mix is
``holonbench/workloads/<traffic>.json``, its configuration the ``file`` its
``configs`` entry names, its dataplane ``holonbench/dataplanes/<dataplane>.py``
(named by the configuration), the plain reference of its query
``holonbench/references/<query>.py`` (named by the traffic), and each
per-layer metric's reader ``holonbench/metrics/<metric>.py``.  Nothing here
lists them: a new cell, configuration or metric is new files and new
entries, and no file that is there changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]  # the checkout: BENCHMARK.json, src/, holonbench/
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")


@dataclasses.dataclass(frozen=True)
class Cell:
    """One entry of ``workloads`` with what it names, read from ``root``."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: tuple  # the BENCHMARK.json entries of the metrics this cell reports
    per_layer: tuple
    root: Path = ROOT

    @property
    def here(self) -> Path:
        return self.root / "holonbench"

    def module(self, kind: str, name: str):
        """``holonbench/<kind>/<name>.py`` of this checkout, imported once."""
        return load_module(self.here / kind / f"{_checked(name)}.py")


def _checked(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"{name!r} is not a benchmark name")
    return name


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``; raises ``KeyError``
    for a name it does not hold."""
    bench = load_benchmark(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: {sorted(by_name)}")
    w = by_name[name]
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((root / "holonbench" / "workloads"
                          / f"{_checked(w['traffic'])}.json").read_text())
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=tuple(m for m in bench["end_to_end"] if _reports(m, name)),
                per_layer=tuple(m for m in bench["per_layer"] if _reports(m, name)),
                root=root)


def load_module(path: Path):
    """Import the Python file ``path`` as a module of its own (cached by path)."""
    key = "holonbench._files." + re.sub(r"\W", "_", str(path.resolve()))
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        if spec is None or not path.exists():
            raise FileNotFoundError(f"no benchmark file {path}")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return sys.modules[key]

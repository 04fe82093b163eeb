"""Decentralized Holon runtime (paper §4) + the centralized Flink-like
baseline it is evaluated against, both driven by a discrete-event simulator
(port of ``repro.runtime``).

The *state transitions* are the port's dataplane (WCRDT folds, lattice
joins, window reads) on the harness's device: the card by default, the host
with ``device="cpu"``.  Only *time* is modeled (network delay, heartbeats,
checkpoint RTT), with the cost constants documented in ``SimConfig``, so a
run's simulated latencies, recovery times and sync bytes do not depend on
the device; only its wall time does.
"""
from repro_torch.runtime.config import (
    SimConfig,
    FailureScenario,
    Scenario,
    ScenarioEvent,
    as_scenario,
)
from repro_torch.runtime.consumer import Consumer
from repro_torch.runtime.net import LinkProfile, NetworkFabric
from repro_torch.runtime.storage import CheckpointStorage
from repro_torch.runtime.harness import HolonHarness, assignment, run_holon
from repro_torch.runtime.flink_baseline import FlinkHarness, run_flink
from repro_torch.runtime.topology import (
    AllToAll,
    EpochRing,
    Hypercube,
    PartialView,
    Topology,
    topology_from_spec,
)

__all__ = [
    "SimConfig",
    "FailureScenario",
    "Scenario",
    "ScenarioEvent",
    "as_scenario",
    "assignment",
    "Consumer",
    "CheckpointStorage",
    "LinkProfile",
    "NetworkFabric",
    "HolonHarness",
    "run_holon",
    "FlinkHarness",
    "run_flink",
    "Topology",
    "AllToAll",
    "EpochRing",
    "Hypercube",
    "PartialView",
    "topology_from_spec",
]

"""Nexmark event model, device-side log generator and the global-aggregation
queries: the package-level names of ``repro.streaming``."""
from repro_torch.streaming.events import EventBatch, KIND_BID, KIND_AUCTION, KIND_PERSON
from repro_torch.streaming.generator import NexmarkConfig, generate_log
from repro_torch.streaming.queries import (
    Query,
    make_q0,
    make_q1_ratio,
    make_q4,
    make_q5,
    make_q7,
)

__all__ = [
    "EventBatch",
    "KIND_BID",
    "KIND_AUCTION",
    "KIND_PERSON",
    "NexmarkConfig",
    "generate_log",
    "Query",
    "make_q0",
    "make_q5",
    "make_q1_ratio",
    "make_q4",
    "make_q7",
]

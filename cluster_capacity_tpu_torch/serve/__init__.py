"""Supervised serving: the crash-tolerant capacity daemon.

Composes the hardened runtime (guard + degradation ladder), the snapshot
delta store, and per-site circuit breakers into a long-running request
loop — see serve/supervisor.py for the containment contract, serve/
breaker.py for the breaker lifecycle, serve/ingest.py for churn ingestion,
and serve/soak.py for the chaos harness that proves the whole stack.
"""

from .breaker import (Breaker, BreakerBoard, BreakerConfig, STATE_CLOSED,
                      STATE_HALF_OPEN, STATE_OPEN)
from .ingest import SnapshotStore
from .supervisor import Answer, Request, ServeConfig, Supervisor

__all__ = [
    "Answer", "Breaker", "BreakerBoard", "BreakerConfig", "Request",
    "ServeConfig", "SnapshotStore", "Supervisor",
    "STATE_CLOSED", "STATE_HALF_OPEN", "STATE_OPEN",
]

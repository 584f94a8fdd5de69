"""Tracing spans.

The reference wraps each scheduling cycle in utiltrace spans with a 100 ms
log threshold ("Snapshotting scheduler cache and node infos done", "Computing
predicates done", "Prioritizing done" — vendor/.../schedule_one.go:431-471).
Here a solve is one batched computation, so spans cover the analogous phases:
the snapshot build, the encode and the solve itself.  Enable with `--trace`
on the CLI or trace.enable(); `profile()` optionally wraps a region in
torch.profiler.
"""

from __future__ import annotations

import contextlib
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional

SPAN_SNAPSHOT = "Snapshotting cluster state into device tensors"
SPAN_ENCODE = "Encoding the pod against the cluster snapshot"
SPAN_SOLVE = "Running placement scan"


@dataclass
class Span:
    name: str
    start: float
    duration: Optional[float] = None


@dataclass
class Tracer:
    enabled: bool = False
    threshold_s: float = 0.0   # reference logs spans above 100 ms
    spans: List[Span] = field(default_factory=list)
    profile_dir: Optional[str] = None

    def enable(self, threshold_s: float = 0.0,
               profile_dir: Optional[str] = None) -> None:
        self.enabled = True
        self.threshold_s = threshold_s
        self.profile_dir = profile_dir

    @contextlib.contextmanager
    def span(self, name: str):
        # Always feed the obs/ span collector (it is bounded and ~free), so
        # --trace-out captures the snapshot/solve phase spans even when the
        # stderr printer below is off; the Tracer's own list + printing stay
        # gated on enable() as before.
        from ..obs.spans import default_collector
        if not self.enabled:
            with default_collector.span(name):
                yield
            return
        s = Span(name=name, start=time.perf_counter())
        if len(self.spans) >= 1000:        # bound long-lived processes
            del self.spans[:500]
        self.spans.append(s)
        try:
            with default_collector.span(name):
                yield
        finally:
            s.duration = time.perf_counter() - s.start
            if s.duration >= self.threshold_s:
                print(f'Trace: "{name}" took {s.duration * 1000:.1f}ms',
                      file=sys.stderr)

    @contextlib.contextmanager
    def profile(self):
        """Wrap a region in torch.profiler (CPU and, on the card, CUDA
        activity) when a dump dir is set, and export its Chrome trace into
        that directory (through obs.profile.capture)."""
        if not self.enabled or not self.profile_dir:
            yield
            return
        from ..obs import profile as obs_profile
        with obs_profile.capture(self.profile_dir, memory=False):
            yield


default_tracer = Tracer()

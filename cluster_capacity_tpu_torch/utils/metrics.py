"""Metrics registry.

The reference defines Prometheus vectors that are never served
(vendor/.../scheduler/metrics/metrics.go:96-127; no listener is bound because
cluster-capacity nils out SecureServing, pkg/utils/utils.go:127-130).  This
module keeps the same observable names as in-process counters/histograms and
can render them in Prometheus text exposition format on demand — strictly more
usable than the reference (which black-holes them) with the same vocabulary.

Since the obs/ telemetry layer, the registry also carries labeled histograms
(per site×rung guard latencies) and gauges (sweep/scenario progress).  All
series are keyed (name, sorted-label-tuple); rendering is deterministic so
golden tests can pin the exact exposition text.  Everything here is host-side
Python — no series update ever touches a tensor or forces a device sync.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict, List, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: dict) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Histogram:
    __slots__ = ("buckets", "counts", "total", "count")

    def __init__(self, buckets: Tuple[float, ...]):
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)
        self.total = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.total += v
        self.count += 1
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1


_LATENCY_BUCKETS = (0.001, 0.002, 0.004, 0.008, 0.016, 0.032, 0.064, 0.128,
                    0.256, 0.512, 1.024, 2.048, 4.096, 8.192)


class Registry:
    """Counter + gauge + histogram registry mirroring the scheduler metric
    names (plus the cc_* telemetry vocabulary from obs/names.py)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: Dict[Tuple[str, LabelKey], float] = \
            defaultdict(float)  # guarded by _lock
        self.gauges: Dict[Tuple[str, LabelKey], float] = {}  # guarded by _lock
        self.histograms: Dict[Tuple[str, LabelKey], _Histogram] = {}  # guarded by _lock

    def inc(self, name: str, amount: float = 1.0, **labels) -> None:
        key = (name, _label_key(labels))
        with self._lock:
            self.counters[key] += amount

    def set_gauge(self, name: str, value: float, **labels) -> None:
        key = (name, _label_key(labels))
        with self._lock:
            self.gauges[key] = float(value)

    def observe(self, name: str, value: float,
                buckets: Tuple[float, ...] = _LATENCY_BUCKETS,
                **labels) -> None:
        """One observation; `buckets` are taken where the series starts."""
        key = (name, _label_key(labels))
        with self._lock:
            h = self.histograms.get(key)
            if h is None:
                h = self.histograms[key] = _Histogram(buckets)
            h.observe(value)

    def get(self, name: str, **labels) -> float:
        with self._lock:
            return self.counters.get((name, _label_key(labels)), 0.0)

    def get_gauge(self, name: str, **labels) -> float:
        with self._lock:
            return self.gauges.get((name, _label_key(labels)), 0.0)

    def counter_total(self, name: str) -> float:
        """Sum of a counter across all label sets."""
        with self._lock:
            return sum(v for (n, _), v in self.counters.items() if n == name)

    def render(self) -> str:
        """Prometheus text exposition format (deterministic ordering:
        counters, then gauges, then histograms, each sorted by name+labels;
        histogram labels sorted with `le` last)."""
        lines: List[str] = []

        def _fmt(name: str, labels: LabelKey, value) -> str:
            label_s = ",".join(f'{k}="{v}"' for k, v in labels)
            body = f"{name}{{{label_s}}}" if label_s else name
            return f"{body} {value:g}"

        with self._lock:
            for (name, labels), v in sorted(self.counters.items()):
                lines.append(_fmt(name, labels, v))
            for (name, labels), v in sorted(self.gauges.items()):
                lines.append(_fmt(name, labels, v))
            for (name, labels), h in sorted(self.histograms.items()):
                acc = 0
                for b, c in zip(h.buckets, h.counts):
                    acc += c
                    lines.append(_fmt(f"{name}_bucket",
                                      labels + (("le", f"{b:g}"),), acc))
                lines.append(_fmt(f"{name}_bucket",
                                  labels + (("le", "+Inf"),), h.count))
                lines.append(_fmt(f"{name}_sum", labels, h.total))
                lines.append(_fmt(f"{name}_count", labels, h.count))
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.histograms.clear()


# Scheduler metric names kept from the reference vocabulary
# (metrics.go:96-127).
SCHEDULE_ATTEMPTS = "scheduler_schedule_attempts_total"
SCHEDULING_DURATION = "scheduler_scheduling_attempt_duration_seconds"
PENDING_PODS = "scheduler_pending_pods"
FRAMEWORK_EXTENSION_POINT_DURATION = \
    "scheduler_framework_extension_point_duration_seconds"
# DefaultPreemption's (metrics.go PreemptionAttempts, PreemptionVictims):
# the dry runs the preemption loop ran, and the victims of each preemption
# it made, in upstream's buckets (ExponentialBuckets(1, 2, 7))
PREEMPTION_ATTEMPTS = "scheduler_preemption_attempts_total"
PREEMPTION_VICTIMS = "scheduler_preemption_victims"
PREEMPTION_VICTIM_BUCKETS = (1, 2, 4, 8, 16, 32, 64)
# The port's own: InterPodAffinity encodes by path (ops/inter_pod_affinity
# `encode`: "trivial", "indexed", "pod_terms")
IPA_ENCODES = "cc_ipa_encodes_total"
# PodTopologySpread encodes by kind (ops/pod_topology_spread `_encode`:
# "hard", "soft", "system_default")
SPREAD_ENCODES = "cc_spread_encodes_total"

default_registry = Registry()

"""obs/: solve telemetry — spans, runtime metrics, trace export.

Three sinks fed from one choke point (runtime/guard.run, the dispatch
boundary every device call of the engine crosses):

1. metrics — utils/metrics.Registry: site×rung duration histograms,
   outcome/degradation/fault-injection counters, sweep and resilience
   progress gauges, and a compile counter (obs/recompile.py: kernel builds
   and CUDA-graph captures);
2. spans — nested, bounded, always-on (obs/spans.py), exported as
   Chrome-trace-event/Perfetto JSONL (obs/export.py);
3. CLI surfaces — `--metrics-dump` (Prometheus text) and `--trace-out`
   (trace JSONL) on both CLIs, plus the torch.profiler bridge that
   utils/trace.Tracer carries for deep dives.

Three more surfaces sit on the same tap: obs/profile.py (device-time and
memory attribution, torch.profiler capture), obs/costmodel.py (measured
cost of the canonical entries, obs/entries.py, against the static budgets
→ per-entry efficiency ratios) and obs/flight.py (a bounded fault flight
recorder: self-contained triage bundles dumped at the guard's fault
boundary).

Import discipline: obs imports only utils and stdlib at module scope —
runtime/ imports obs, never the reverse (flight/profile/entries reach
torch, the engine and the faults harness only lazily, inside post-mortem
or explicitly enabled paths).  Nothing here touches a tensor on the solve
path, so it never forces a device sync.
"""

from . import costmodel, flight, names, profile  # noqa: F401
from .spans import (Collector, Span, default_collector, guard_span,  # noqa: F401
                    span)
from .export import trace_events, write_metrics, write_trace  # noqa: F401
from .recompile import install_recompile_hook  # noqa: F401

__all__ = ["names", "profile", "costmodel", "flight", "Collector", "Span",
           "default_collector", "guard_span", "span", "trace_events",
           "write_metrics", "write_trace", "install_recompile_hook"]

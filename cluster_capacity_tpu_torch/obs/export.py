"""Exporters: Chrome-trace-event JSONL (Perfetto-loadable) and Prometheus
text dumps.

The trace format is newline-delimited complete ("ph": "X") trace events —
both chrome://tracing and ui.perfetto.dev accept the event-per-line form, and
JSONL appends cheaply from long-lived processes.  Timestamps/durations are
microseconds per the trace-event spec (epoch time: each span's
perf_counter start through spans.EPOCH_OFFSET); span attributes (site,
rung, phase, outcome, batch, trace id, compile and garbage-collector
seconds and counts) ride in "args" so the degradation path of a
fault-injected sweep reads rung-by-rung off the track.
"""

from __future__ import annotations

import json
import os
import sys
from typing import List, Optional

from ..utils import metrics as metrics_mod
from . import spans as spans_mod


def trace_events(span_list: Optional[List[spans_mod.Span]] = None) -> list:
    """Spans as Chrome trace-event dicts (open spans export with dur 0)."""
    if span_list is None:
        span_list = spans_mod.default_collector.spans()
    events = []
    for sp in span_list:
        args = {"span_id": sp.span_id, "trace_id": sp.trace_id,
                "outcome": sp.outcome or "open"}
        if sp.parent_id is not None:
            args["parent_id"] = sp.parent_id
        if sp.site:
            args["site"] = sp.site
        if sp.rung:
            args["rung"] = sp.rung
        if sp.phase:
            args["phase"] = sp.phase
        if sp.batch is not None:
            args["batch"] = sp.batch
        if sp.first_call:
            args["first_call"] = True
        if sp.compile_s:
            args["compile_s"] = round(sp.compile_s, 6)
        if sp.compiles:
            args["compiles"] = sp.compiles
        if sp.gc_n:
            args["gc_s"] = round(sp.gc_s, 6)
            args["gc_n"] = sp.gc_n
        args.update(sp.attrs)
        events.append({
            "name": sp.name, "ph": "X", "pid": 1, "tid": sp.thread_id,
            "ts": sp.start_s * 1e6,
            "dur": (sp.duration_s or 0.0) * 1e6,
            "args": args,
        })
    return events


def write_trace(path: str,
                span_list: Optional[List[spans_mod.Span]] = None, *,
                atomic: bool = False) -> int:
    """Write spans as trace-event JSONL; returns the event count.

    ``atomic=True`` writes to a temp file and renames, so a scraper reading
    the path mid-write (a --period watch loop rewriting every iteration)
    never sees a torn file."""
    events = trace_events(span_list)
    if path == "-":
        for ev in events:
            sys.stdout.write(json.dumps(ev) + "\n")
        return len(events)
    target = path + ".tmp" if atomic else path
    with open(target, "w") as out:
        for ev in events:
            out.write(json.dumps(ev) + "\n")
    if atomic:
        os.replace(target, path)
    return len(events)


def write_metrics(path: str, registry=None, *, atomic: bool = False) -> None:
    """Dump a registry in Prometheus text exposition format ("-" = stdout).
    ``atomic=True`` rewrites via temp + rename (scrape-safe mid-run)."""
    registry = registry or metrics_mod.default_registry
    text = registry.render()
    if path == "-":
        sys.stdout.write(text)
        return
    target = path + ".tmp" if atomic else path
    with open(target, "w") as f:
        f.write(text)
    if atomic:
        os.replace(target, path)

"""The traced slice: one answer, or a steady stretch of one, under
torch.profiler, and its reduction to device busy time, idle gaps, kernel
launches and the breakdown.

The trace is exported to a temporary file, read back as the Chrome trace
format (one clock for host and device events), and deleted.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "python_function")
ANSWER = "portbench.answer"
SOLVE = "portbench.solve"

Interval = Tuple[float, float]


@dataclass
class TraceSummary:
    """Seconds throughout."""
    window: Interval                      # the traced answer, host clock
    busy_s: float                         # device busy inside the window
    solve: Optional[Interval] = None
    solve_busy_s: float = 0.0             # device busy inside the solve
    solve_kernels: int = 0                # kernels launched in the solve
    kernels: int = 0                      # kernels in the window
    device_ops: List[list] = field(default_factory=list)
    idle_gaps: List[list] = field(default_factory=list)
    steps: int = 0                        # the entry's steps in the slice

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]


def _union(intervals: Sequence[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _covered(union: Sequence[Interval], lo: float, hi: float) -> float:
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in union)


def summarize(events: Sequence[dict], top: int = 10) -> TraceSummary:
    """Reduce Chrome-trace events (ts and dur in microseconds)."""
    def span(e) -> Interval:
        t0 = float(e["ts"]) * 1e-6
        return t0, t0 + float(e.get("dur", 0.0)) * 1e-6

    marks = {e["name"]: span(e) for e in events
             if e.get("cat") == "user_annotation"
             and e.get("name") in (ANSWER, SOLVE)}
    if ANSWER not in marks:
        raise ValueError("the trace holds no portbench.answer range")
    lo, hi = marks[ANSWER]
    dev = [(span(e), e) for e in events if e.get("cat") in DEVICE_CATS
           and e.get("ph") == "X"]
    dev = [((max(a, lo), min(b, hi)), e) for (a, b), e in dev
           if b > lo and a < hi]
    union = _union([iv for iv, _e in dev])
    s = TraceSummary(window=(lo, hi), busy_s=_covered(union, lo, hi),
                     kernels=sum(1 for _iv, e in dev
                                 if e.get("cat") == "kernel"))
    if SOLVE in marks:
        a, b = marks[SOLVE]
        s.solve = (a, b)
        s.solve_busy_s = _covered(union, a, b)
        s.solve_kernels = sum(1 for (x, _y), e in dev
                              if e.get("cat") == "kernel" and a <= x < b)
    by_name: Dict[str, float] = {}
    for (a, b), e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a)
    s.device_ops = [[k, v] for k, v in
                    sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]
    host = [(span(e), e["name"]) for e in events
            if e.get("cat") in HOST_CATS and e.get("ph") == "X"
            and e.get("name") != ANSWER]
    gaps: Dict[str, float] = {}
    edges = [lo] + [x for iv in union for x in iv] + [hi]
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = (g0 + g1) / 2
        inner = [(b - a, name) for (a, b), name in host if a <= mid <= b]
        label = min(inner)[1] if inner else "host (no traced op)"
        gaps[label] = gaps.get(label, 0.0) + (g1 - g0)
    s.idle_gaps = [[k, v] for k, v in
                   sorted(gaps.items(), key=lambda kv: -kv[1])[:top]]
    return s


class Slice:
    """The profiler on over one stretch of a run, inside a portbench.answer
    range (and a portbench.solve range with `solve`: a stretch that lies
    wholly in the solve), the device synchronised at both ends.  begin()
    and end() may be called from inside the program's own loop (the race's
    chunks); `summary` is None until end()."""

    def __init__(self, solve: bool = False):
        self.marks = (ANSWER, SOLVE) if solve else (ANSWER,)
        self.prof = None
        self.ranges = []
        self.summary: Optional[TraceSummary] = None

    def begin(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self.prof = profile(activities=acts)
        self.prof.start()
        self.ranges = [record_function(m) for m in self.marks]
        for r in self.ranges:
            r.__enter__()

    def end(self) -> None:
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        for r in reversed(self.ranges):
            r.__exit__(None, None, None)
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json",
                                    prefix="portbench-trace-")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.unlink(path)
        self.prof = None
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        self.summary = summarize(events)


def capture(fn):
    """(fn's result, TraceSummary) of fn() run under the profiler, the
    whole call one slice."""
    s = Slice()
    s.begin()
    out = fn()
    s.end()
    return out, s.summary

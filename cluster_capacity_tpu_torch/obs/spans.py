"""Span collection: the telemetry backbone threaded through guard.run.

Every guarded dispatch (and the coarser framework/degrade phases) opens a
Span carrying the dispatch site, ladder rung, compile/execute phase, batch
shape and outcome.  Spans nest via a thread-local stack — a ladder descent
under injected faults leaves one parent `degrade.solve_one` span with a
child guard span per rung attempted, each stamped with the fault code that
ended it.  The collector is always on: a span costs two perf_counter reads,
a dict and a profiler probe, nothing here ever touches a tensor or forces a
device sync, and the buffer is bounded (oldest spans drop, counted).

Rung inheritance: a span opened without an explicit rung inherits the
nearest enclosing span's rung, so low-level dispatches inside a rung attempt
are attributed to that rung without plumbing the string through every call.

The guard's deadline watchdog runs `fn` on a worker thread; the guard
hands the caller's open span to the worker (`adopt`), so spans opened there
are its children.  A kernel build or graph capture can still land on a
thread whose stack holds no sited span, so `active_sited()` exposes the
most recently opened still-open *sited* span process-wide as the
attribution target of obs/recompile.record_compile.  Device dispatch is
effectively serialized in this codebase, so the last-opened sited span is
the right owner.

Clocks and costs charged to a span:

- Each span reads `time.perf_counter()` at open and close (`perf_start`,
  `perf_end`); `start_s`, the epoch time the exporter writes, is derived
  from `perf_start` through one offset taken at import.
- While a `torch.profiler` runs, each span also opens a `record_function`
  range of its name, so it lands in the profiler's trace as a
  `user_annotation` on the kernels' clock (one ~130 ns probe otherwise).
- Every span carries `trace_id`, the span id of the root it descends
  from: the spans of one answer share it.
- A `gc.callbacks` hook (installed at import) charges each collection's
  pause to the innermost span open on the collecting thread (`gc_s`,
  `gc_n`); a pause with no span open is charged to none.
  obs/recompile.record_compile charges compiles (`compile_s`, `compiles`).
"""

from __future__ import annotations

import contextlib
import gc
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..utils import metrics as metrics_mod
from . import names

MAX_SPANS = 65536
# epoch seconds minus perf_counter seconds, taken once: Span.start_s
EPOCH_OFFSET = time.time() - time.perf_counter()


@dataclass
class Span:
    name: str
    span_id: int
    parent_id: Optional[int]
    thread_id: int
    perf_start: float                    # time.perf_counter() at open
    trace_id: int = 0                    # span id of the root span
    site: str = ""                       # dispatch site ("" = phase span)
    rung: str = ""                       # ladder rung serving this attempt
    phase: str = ""                      # guard.PHASE_COMPILE / _EXECUTE
    batch: Optional[int] = None          # group size for batched dispatches
    first_call: bool = False             # first dispatch ever at this site
    outcome: str = ""                    # "ok" or fault code once closed
    perf_end: Optional[float] = None     # time.perf_counter() at close
    duration_s: Optional[float] = None
    compile_s: float = 0.0               # backend-compile seconds attributed
    compiles: int = 0                    # compiles attributed
    gc_s: float = 0.0                    # garbage-collector pauses charged
    gc_n: int = 0                        # collections charged
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def start_s(self) -> float:
        """Epoch seconds at open (the exporter's ts)."""
        return self.perf_start + EPOCH_OFFSET


_probe = []     # torch's profiler-enabled test, once torch is imported


def _profiling() -> bool:
    """Whether a torch.profiler is recording (False before torch is
    imported: none can be)."""
    if not _probe:
        torch = sys.modules.get("torch")
        if torch is None:
            return False
        _probe.append(torch._C._autograd._profiler_enabled)
    return _probe[0]()


def _profiler_range(name: str):
    """An entered record_function range named `name`."""
    from torch.autograd.profiler import record_function
    rf = record_function(name)
    rf.__enter__()
    return rf


class Collector:
    """Bounded, thread-aware span collector."""

    def __init__(self, max_spans: int = MAX_SPANS):
        self.max_spans = max_spans
        self._lock = threading.Lock()
        self._spans: List[Span] = []  # guarded by _lock
        self._local = threading.local()
        self._open_sited: List[Span] = []  # guarded by _lock
        self._seen_sites: set = set()  # guarded by _lock
        self._next_id = 1  # guarded by _lock
        self.dropped = 0  # guarded by _lock

    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def current(self) -> Optional[Span]:
        st = self._stack()
        return st[-1] if st else None

    @contextlib.contextmanager
    def adopt(self, parent: Optional[Span]):
        """Open `parent` (a span of another thread) on this thread for the
        block: spans opened here become its children, and collections here
        are charged to it while none of them is open."""
        stack = self._stack()
        if parent is not None:
            stack.append(parent)
        try:
            yield
        finally:
            if parent is not None and stack and stack[-1] is parent:
                stack.pop()

    def active_sited(self) -> Optional[Span]:
        """Innermost open span that has a dispatch site, any thread."""
        with self._lock:
            return self._open_sited[-1] if self._open_sited else None

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self._open_sited.clear()
            self._seen_sites.clear()
            self.dropped = 0

    @contextlib.contextmanager
    def span(self, name: str, *, site: str = "", rung: str = "",
             phase: str = "", batch: Optional[int] = None, **attrs):
        stack = self._stack()
        parent = stack[-1] if stack else None
        if not rung:
            for s in reversed(stack):
                if s.rung:
                    rung = s.rung
                    break
        overflow = 0
        with self._lock:
            span_id = self._next_id
            self._next_id += 1
            first = bool(site) and site not in self._seen_sites
            if site:
                self._seen_sites.add(site)
            overflow = len(self._spans) - self.max_spans + 1
            if overflow > 0:
                del self._spans[:overflow]
                self.dropped += overflow
        if overflow > 0:
            metrics_mod.default_registry.inc(names.SPANS_DROPPED, overflow)
        sp = Span(name=name, span_id=span_id,
                  parent_id=parent.span_id if parent else None,
                  thread_id=threading.get_ident(),
                  perf_start=time.perf_counter(),
                  trace_id=parent.trace_id if parent else span_id,
                  site=site, rung=rung, phase=phase, batch=batch,
                  first_call=first, attrs=dict(attrs))
        with self._lock:
            self._spans.append(sp)
            if site:
                self._open_sited.append(sp)
        stack.append(sp)
        mirror = _profiler_range(name) if _profiling() else None
        try:
            yield sp
            if not sp.outcome:
                sp.outcome = "ok"
        except BaseException as exc:
            if not sp.outcome:
                sp.outcome = getattr(exc, "code", "") or type(exc).__name__
            raise
        finally:
            sp.perf_end = time.perf_counter()
            sp.duration_s = sp.perf_end - sp.perf_start
            if mirror is not None:
                mirror.__exit__(None, None, None)
            if stack and stack[-1] is sp:
                stack.pop()
            if site:
                with self._lock:
                    try:
                        self._open_sited.remove(sp)
                    except ValueError:
                        pass


default_collector = Collector()

_gc_start = [0.0]   # perf_counter at the running collection's start


def _charge_gc(phase: str, _info: dict) -> None:
    """gc.callbacks hook: one collection's pause to the innermost span open
    on the collecting thread (collections never nest)."""
    if phase == "start":
        _gc_start[0] = time.perf_counter()
        return
    sp = default_collector.current()
    if sp is not None:
        sp.gc_s += time.perf_counter() - _gc_start[0]
        sp.gc_n += 1


if _charge_gc not in gc.callbacks:
    gc.callbacks.append(_charge_gc)


def span(name: str, **kw):
    """Convenience: open a span on the default collector."""
    return default_collector.span(name, **kw)


@contextlib.contextmanager
def guard_span(*, site: str, phase: str, rung: str = "",
               batch: Optional[int] = None,
               mesh_shape: Optional[dict] = None):
    """The guard.run span: records the dispatch span AND feeds the metric
    sinks (site×rung duration histogram, outcome counter, first-call
    counter).  The inner collector span closes before this function's
    finally runs, so `sp.outcome`/`sp.rung` are final by metric time.
    `mesh_shape` ({'batch': B, 'nodes': N}) rides the span attrs so profile
    attribution and flight bundles identify sharded dispatches."""
    reg = metrics_mod.default_registry
    sp: Optional[Span] = None
    t0 = time.perf_counter()
    attrs = {}
    if mesh_shape:
        attrs["mesh_shape"] = mesh_shape
        if batch:
            # batch rows each shard actually carries (after pad-to-multiple)
            nb = max(1, int(mesh_shape.get("batch", 1)))
            attrs["per_shard_batch"] = -(-int(batch) // nb)
    try:
        with default_collector.span(f"guard:{site}", site=site, rung=rung,
                                    phase=phase, batch=batch, **attrs) as sp:
            yield sp
    finally:
        dur = time.perf_counter() - t0
        if sp is not None:
            lab = dict(site=site, rung=sp.rung or "-", phase=phase)
            reg.observe(names.GUARD_DURATION, dur, **lab)
            reg.inc(names.GUARD_RUNS, outcome=sp.outcome or "error", **lab)
            reg.inc(names.DEVICE_SECONDS, dur, **lab)
            if sp.first_call:
                reg.inc(names.GUARD_FIRST_CALLS, site=site)
            # memory-watermark sample (fast no-op unless profiling enabled
            # it); lazy import keeps spans importable before profile
            from . import profile as profile_mod
            profile_mod.maybe_sample(sp)

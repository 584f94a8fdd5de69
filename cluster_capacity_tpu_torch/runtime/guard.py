"""The watchdog: deadline + classification + validation around device calls.

`run()` is the single choke point every hardened dispatch goes through.  It

1. asks the fault harness whether an injected fault fires at this site,
2. executes the callable — under a wall-clock deadline when one is set,
3. classifies device-level exceptions into the RuntimeFault taxonomy
   (anything unclassified propagates raw: a failed kernel build, a launch
   the plan refuses or an illegal address is an engine bug, and degrading
   would hide it), and
4. applies injected output corruption, then validates the result planes.

Every classified fault is stamped into the event recorder before it
propagates.  The JAX package also wraps each call in an obs/ span and feeds
its flight recorder; both arrive with the port's obs/ slice (ROADMAP queue
1, item 16).

Deadline mechanics: a CUDA launch cannot be interrupted from Python, so the
call runs on a watchdog thread and on timeout the thread is *abandoned* — it
may still complete in the background (its launches stay queued on the
stream, and a lower rung on the same stream waits behind them), but its
result is discarded and the supervisor moves down the ladder.  Deadlines
default to off (0) so the healthy path adds no thread hop; the ``hang``
fault kind is simulated and never sleeps.

Watchdog threads are POOLED: a healthy deadline call borrows an idle worker
and returns it, so a long-running caller issuing thousands of guarded
requests keeps a handful of threads alive.  Only a timed-out worker is
abandoned — it exits on its own once the wedged call finishes.
``watchdog_threads()`` exposes the live count.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import List, Optional

import torch

from . import faults
from .errors import (CompileTimeout, DeviceOOM, ExecuteTimeout,
                     NumericCorruption, RuntimeFault)

PHASE_COMPILE = "compile"
PHASE_EXECUTE = "execute"

# Substrings of PyTorch's CUDA messages that identify an allocation failure:
# the caching allocator's "CUDA out of memory. Tried to allocate ..." and
# the runtime's cudaErrorMemoryAllocation status, "CUDA error: out of
# memory".
_OOM_MARKERS = ("CUDA out of memory", "CUDA error: out of memory")

# Exception types raised by PyTorch for a device failure; a RuntimeError
# whose message is a CUDA error status is one too (PyTorch versions before
# AcceleratorError raise those as RuntimeError).  SimulatedDeviceError is
# the fault harness's stand-in and goes through the same branch.
_DEVICE_ERROR_TYPES = tuple(t for t in (
    torch.OutOfMemoryError, getattr(torch, "AcceleratorError", None),
    faults.SimulatedDeviceError) if t is not None)


def is_device_error(exc: BaseException) -> bool:
    if isinstance(exc, (MemoryError,) + _DEVICE_ERROR_TYPES):
        return True
    return isinstance(exc, RuntimeError) and str(exc).startswith(
        ("CUDA error", "CUDA out of memory"))


def classify_device_error(exc: BaseException, *,
                          site: str = "",
                          phase: str = PHASE_EXECUTE):
    """Map a device-level exception onto the taxonomy, or return None when
    it is not one we know how to recover from."""
    if isinstance(exc, MemoryError):
        return DeviceOOM(str(exc) or "host MemoryError", site=site)
    if not is_device_error(exc):
        return None
    message = str(exc)
    if isinstance(exc, torch.OutOfMemoryError) or any(
            marker in message for marker in _OOM_MARKERS):
        return DeviceOOM(message, site=site)
    return None


def validate_result(result, num_nodes: int, *, site: str = "") -> None:
    """Reject solve outputs that cannot be valid.  Raises NumericCorruption;
    O(len(placements)) so the healthy path barely notices."""
    if result is None:
        return
    placements = result.placements
    if result.placed_count != len(placements) or result.placed_count < 0:
        raise NumericCorruption(
            f"placed_count={result.placed_count} disagrees with "
            f"{len(placements)} placements", site=site)
    for idx in placements:
        if not (0 <= idx < num_nodes):
            raise NumericCorruption(
                f"placement index {idx} outside [0, {num_nodes})", site=site)
    for reason, count in result.fail_counts.items():
        if count != count or count < 0:  # NaN or negative
            raise NumericCorruption(
                f"fail_counts[{reason!r}] = {count} is not a valid count",
                site=site)


class _Watchdog(threading.Thread):
    """A reusable deadline worker: accepts one job at a time over a queue,
    posts (ok|err, value) back, and loops.  A caller that times out marks the
    worker `abandoned` and never reuses it; the worker notices after the
    wedged call finally returns (or via the sentinel below) and exits."""

    _ids = itertools.count()

    def __init__(self):
        super().__init__(
            name=f"cc-guard-watchdog-{next(self._ids)}", daemon=True)
        self.jobs: "queue.Queue" = queue.Queue(maxsize=1)
        self.results: "queue.Queue" = queue.Queue(maxsize=1)
        self.abandoned = False
        self.start()

    def run(self):
        while True:
            job = self.jobs.get()
            if job is None:  # retirement sentinel
                return
            fn, args, kwargs = job
            try:
                out = ("ok", fn(*args, **kwargs))
            except BaseException as exc:  # re-raised on the caller's thread
                out = ("err", exc)
            self.results.put(out)
            if self.abandoned:
                return


_MAX_IDLE_WATCHDOGS = 4
_idle_watchdogs: List["_Watchdog"] = []  # guarded by _watchdog_lock
_watchdog_lock = threading.Lock()


def watchdog_threads() -> int:
    """Live watchdog threads, pooled + abandoned."""
    return sum(1 for t in threading.enumerate()
               if t.name.startswith("cc-guard-watchdog-"))


def _deadline_call(fn, args, kwargs, deadline: float, *,
                   site: str, phase: str):
    with _watchdog_lock:
        worker = _idle_watchdogs.pop() if _idle_watchdogs else None
    if worker is None or not worker.is_alive():
        worker = _Watchdog()
    worker.jobs.put((fn, args, kwargs))
    try:
        kind, value = worker.results.get(timeout=deadline)
    except queue.Empty:
        worker.abandoned = True
        # If the worker already posted its (late) result and looped back to
        # jobs.get() before seeing the flag, this sentinel unblocks it so the
        # thread still exits instead of waiting for a job that never comes.
        try:
            worker.jobs.put_nowait(None)
        except queue.Full:
            pass
        fault = CompileTimeout if phase == PHASE_COMPILE else ExecuteTimeout
        raise fault(
            f"device call exceeded {deadline:g}s wall-clock deadline "
            f"(worker thread abandoned)", site=site)
    with _watchdog_lock:
        if len(_idle_watchdogs) < _MAX_IDLE_WATCHDOGS:
            _idle_watchdogs.append(worker)
            worker = None
    if worker is not None:
        worker.jobs.put(None)  # pool full: retire
    if kind == "err":
        raise value
    return value


def _record_fault_event(fault) -> None:
    """Stamp the classified fault into the event recorder so reports can
    show WHY a solve degraded (the SolveDegraded event names the transition;
    this one names the fault itself, with its site and detail)."""
    from ..utils.events import default_recorder
    default_recorder.eventf("device", fault.code, str(fault))


def run(fn, *args, site: str, deadline: float = 0.0,
        phase: str = PHASE_EXECUTE,
        validate_nodes: Optional[int] = None, **kwargs):
    """Execute `fn(*args, **kwargs)` under the watchdog.

    Raises DeviceOOM / CompileTimeout / ExecuteTimeout / NumericCorruption
    for recoverable faults; anything else propagates untouched.
    """
    try:
        try:
            corrupt_spec = faults.fire(site)  # may raise simulated oom/hang
            if deadline and deadline > 0:
                result = _deadline_call(fn, args, kwargs, deadline,
                                        site=site, phase=phase)
            else:
                result = fn(*args, **kwargs)
        except faults.SimulatedHang as exc:
            fault = CompileTimeout if phase == PHASE_COMPILE \
                else ExecuteTimeout
            raise fault(str(exc), site=site) from exc
        except Exception as exc:
            fault = classify_device_error(exc, site=site, phase=phase)
            if fault is not None:
                raise fault from exc
            raise
        result = faults.maybe_corrupt(corrupt_spec, result)
        if validate_nodes is not None:
            if isinstance(result, (list, tuple)):
                for item in result:
                    validate_result(item, validate_nodes, site=site)
            else:
                validate_result(result, validate_nodes, site=site)
        return result
    except RuntimeFault as fault:
        _record_fault_event(fault)
        raise

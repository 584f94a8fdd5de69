"""Event recorder.

The reference ships a channel-backed events.EventRecorder that is dead code
(pkg/framework/record/recorder.go:58-62, unreferenced) and black-holes the
real broadcaster into a throwaway fake client (pkg/utils/utils.go:139-140).
This recorder keeps the same Scheduled/FailedScheduling/Preempted vocabulary
but actually retains events in memory for inspection and report debugging."""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

REASON_SCHEDULED = "Scheduled"
REASON_FAILED_SCHEDULING = "FailedScheduling"
REASON_PREEMPTED = "Preempted"


@dataclass
class Event:
    reason: str
    message: str
    object_name: str
    timestamp: float


@dataclass
class Recorder:
    """Bounded ring: always retains exactly the newest `max_events` events
    once full (the old trimming dropped the oldest HALF on overflow, so the
    retained window silently jumped by max_events/2; `dropped` counts what
    the ring has evicted over its lifetime)."""

    max_events: int = 10000
    events: List[Event] = field(default_factory=list)  # cc-guarded-by: _lock
    dropped: int = 0  # cc-guarded-by: _lock
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def eventf(self, object_name: str, reason: str, message: str) -> None:
        ev = Event(reason=reason, message=message,
                   object_name=object_name, timestamp=time.time())
        with self._lock:
            self.events.append(ev)
            overflow = len(self.events) - self.max_events
            if overflow > 0:
                del self.events[:overflow]
                self.dropped += overflow

    def by_reason(self, reason: str) -> List[Event]:
        with self._lock:
            return [e for e in self.events if e.reason == reason]

    def tail(self, n: int) -> List[Event]:
        """Consistent snapshot of the newest `n` events (the flight
        recorder bundles this; an unlocked slice can interleave with a
        trim and duplicate or skip entries)."""
        with self._lock:
            return list(self.events[-n:]) if n > 0 else []

    def clear(self) -> None:
        with self._lock:
            self.events.clear()
            self.dropped = 0


default_recorder = Recorder()

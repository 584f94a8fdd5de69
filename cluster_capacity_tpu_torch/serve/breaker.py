"""Per-site circuit breakers layered on the degradation ladder.

The ladder (runtime/degrade.py) reacts to ONE fault: it falls to the next
rung and the next request climbs right back up.  Under a persistent site
failure — a wedged compiler, a device that OOMs every batched dispatch —
that means every request pays the fault + fallback round trip.  A breaker
remembers: ``threshold`` classified faults at a site within ``window_s``
opens it, and while open the supervisor enters the ladder BELOW that rung,
so requests go straight to a healthy rung for ``cooldown_s``.  After the
cooldown one half-open probe request may try the rung again: success closes
the breaker, another fault re-opens it (restarting the cooldown).

Pinning is safe because of the repo's bit-identity contract — every rung
serves the same numbers (the parity suites pin this), so an open breaker
costs throughput, never accuracy.

State is observable three ways: ``cc_breaker_state{site,rung}`` gauges
(0 closed / 1 open / 2 half-open), ``cc_breaker_transitions_total`` with
from/to labels, and every transition stamped into the events ring and the
flight-recorder's degradation ring (so a later bundle's manifest shows the
breaker history around the fault).

Time is injectable (``clock=``) so lifecycle tests drive open → half-open →
closed with a fake clock instead of sleeping.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from ..obs import flight
from ..obs import names as obs_names
from ..runtime.degrade import (RUNG_BATCHED, RUNG_FAST_PATH, RUNG_FUSED,
                               RUNG_ORACLE, RUNG_SHARDED)
from ..runtime.faults import (SITE_FAST_PATH, SITE_GROUP, SITE_ORACLE,
                              SITE_SHARDED, SITE_SOLVE)
from ..utils.events import default_recorder
from ..utils.metrics import default_registry

STATE_CLOSED = "closed"
STATE_OPEN = "open"
STATE_HALF_OPEN = "half_open"

# gauge encoding for cc_breaker_state{site,rung}
_STATE_VALUE = {STATE_CLOSED: 0, STATE_OPEN: 1, STATE_HALF_OPEN: 2}

EVENT_BREAKER = "BreakerTransition"

# Which guard site a ladder rung dispatches through — the breaker for a rung
# watches that site's classified faults.
RUNG_SITE = {
    RUNG_SHARDED: SITE_SHARDED,
    RUNG_BATCHED: SITE_GROUP,
    RUNG_FUSED: SITE_SOLVE,
    RUNG_FAST_PATH: SITE_FAST_PATH,
    RUNG_ORACLE: SITE_ORACLE,
}


@dataclass
class BreakerConfig:
    threshold: int = 3        # classified faults within window_s that open
    window_s: float = 60.0
    cooldown_s: float = 5.0   # open -> half-open delay

    def __post_init__(self):
        if self.threshold < 1:
            raise ValueError("breaker threshold must be >= 1")
        if self.window_s <= 0 or self.cooldown_s < 0:
            raise ValueError("breaker window must be > 0, cooldown >= 0")


class Breaker:
    """One site/rung breaker.  Not thread-safe on its own; the supervisor
    serializes solves, and BreakerBoard is the only constructor."""

    def __init__(self, site: str, rung: str, config: BreakerConfig,
                 clock: Callable[[], float] = time.monotonic):
        self.site = site
        self.rung = rung
        self.config = config
        self._clock = clock
        self.state = STATE_CLOSED
        self._fault_times: deque = deque()
        self._opened_at: Optional[float] = None
        self._probe_in_flight = False
        self.opened_count = 0
        self.recovery_latencies: List[float] = []  # open -> closed, seconds
        self._set_gauge()

    def __repr__(self) -> str:
        return f"<Breaker {self.site} ({self.rung}): {self.state}>"

    # -- queries -----------------------------------------------------------

    def allow(self) -> bool:
        """May a request attempt this rung now?  An open breaker past its
        cooldown becomes half-open and admits exactly one probe; the caller
        MUST report that probe back via record_success/record_fault."""
        now = self._clock()
        if self.state == STATE_OPEN:
            if now - self._opened_at >= self.config.cooldown_s:
                self._transition(STATE_HALF_OPEN, "cooldown elapsed")
            else:
                return False
        if self.state == STATE_HALF_OPEN:
            if self._probe_in_flight:
                return False
            self._probe_in_flight = True
            return True
        return True

    # -- outcomes ----------------------------------------------------------

    def record_success(self) -> None:
        self._probe_in_flight = False
        if self.state == STATE_HALF_OPEN:
            latency = self._clock() - self._opened_at
            self.recovery_latencies.append(latency)
            self._opened_at = None
            self._fault_times.clear()
            self._transition(STATE_CLOSED,
                             f"probe succeeded after {latency:.3f}s open")

    def record_abort(self) -> None:
        """An attempt ended without a classifiable outcome — an unclassified
        exception that the supervisor contains with a worker restart rather
        than a ladder descent.  Release the probe slot so the breaker cannot
        wedge half-open (the admitted probe will never report back); a
        half-open probe that aborts re-opens and restarts the cooldown,
        since the rung did not prove itself healthy."""
        self._probe_in_flight = False
        if self.state == STATE_HALF_OPEN:
            self._opened_at = self._clock()
            self._transition(STATE_OPEN, "probe aborted: unclassified error")

    def record_fault(self, fault) -> None:
        now = self._clock()
        self._probe_in_flight = False
        code = getattr(fault, "code", type(fault).__name__)
        if self.state == STATE_HALF_OPEN:
            # probe failed: re-open and restart the cooldown
            self._opened_at = now
            self._transition(STATE_OPEN, f"probe failed: {code}")
            return
        if self.state == STATE_OPEN:
            return  # faults while open (final-rung traffic) don't re-arm
        self._fault_times.append(now)
        horizon = now - self.config.window_s
        while self._fault_times and self._fault_times[0] < horizon:
            self._fault_times.popleft()
        if len(self._fault_times) >= self.config.threshold:
            self._opened_at = now
            self.opened_count += 1
            self._transition(
                STATE_OPEN,
                f"{len(self._fault_times)} faults within "
                f"{self.config.window_s:g}s (last: {code})")

    # -- plumbing ----------------------------------------------------------

    def _set_gauge(self) -> None:
        default_registry.set_gauge(
            obs_names.BREAKER_STATE, _STATE_VALUE[self.state],
            site=self.site, rung=self.rung)

    def _transition(self, new_state: str, why: str) -> None:
        old = self.state
        self.state = new_state
        self._set_gauge()
        default_registry.inc(
            obs_names.BREAKER_TRANSITIONS, site=self.site,
            **{"from": old, "to": new_state})
        default_recorder.eventf(
            "breaker", EVENT_BREAKER,
            f"{self.site} ({self.rung}): {old} -> {new_state}: {why}")
        flight.on_breaker(self.site, self.rung, old, new_state)


class BreakerBoard:
    """The supervisor's breaker set, one per ladder rung, created lazily.
    ``allow_rung`` is the only gate the supervisor consults: the final rung
    of any ladder is always admitted (the host oracle is the last resort —
    pinning below it would mean dropping the request)."""

    def __init__(self, config: Optional[BreakerConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.config = config or BreakerConfig()
        self._clock = clock
        self._breakers: Dict[str, Breaker] = {}

    def breaker(self, rung: str) -> Breaker:
        site = RUNG_SITE[rung]
        b = self._breakers.get(site)
        if b is None:
            b = Breaker(site, rung, self.config, clock=self._clock)
            self._breakers[site] = b
        return b

    def allow_rung(self, rung: str, *, is_last: bool = False) -> bool:
        if is_last:
            return True
        return self.breaker(rung).allow()

    def breakers(self) -> List[Breaker]:
        return list(self._breakers.values())

    def all_closed(self) -> bool:
        return all(b.state == STATE_CLOSED for b in self._breakers.values())

    def open_breakers(self) -> List[Breaker]:
        return [b for b in self._breakers.values()
                if b.state != STATE_CLOSED]

    def opened_total(self) -> int:
        return sum(b.opened_count for b in self._breakers.values())

    def recovery_latencies(self) -> List[float]:
        out: List[float] = []
        for b in self._breakers.values():
            out.extend(b.recovery_latencies)
        return out

    def states(self) -> Dict[Tuple[str, str], str]:
        return {(b.site, b.rung): b.state
                for b in self._breakers.values()}

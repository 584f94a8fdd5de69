"""The program's own spans over the window, for the readers under metrics/
that read them (obs.spans.default_collector of cluster_capacity_tpu_torch).

A span counts toward an answer when it lies inside that answer on
time.perf_counter(), the clock the window times its answers on.  A reader
returns None, and its metric is left out, where the program's spans carry
no such times (nor the costs charged to them), where no span of the names
asked for ran in the window, or where the collector has dropped any span.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from portbench import readers
from portbench.harness import RunInfo, mean


def window_spans(info: RunInfo) -> Optional[list]:
    """The closed spans that lie inside the window, from the first answer's
    start to the last one's end; None where none can be read."""
    from cluster_capacity_tpu_torch.obs import spans as obs_spans
    col = obs_spans.default_collector
    if col.dropped or not info.answers:
        return None
    lo, hi = info.answers[0].start, info.answers[-1].end
    out = []
    for sp in col.spans():
        start = getattr(sp, "perf_start", None)
        if start is None:
            return None
        end = sp.perf_end
        if end is not None and lo <= start and end <= hi:
            out.append(sp)
    return out


def _within(spans: Sequence, answer) -> List:
    return [s for s in spans
            if answer.start <= s.perf_start and s.perf_end <= answer.end]


def _named(info: RunInfo, names: Sequence[str]) -> Optional[list]:
    spans = window_spans(info)
    if spans is None:
        return None
    spans = [s for s in spans if s.name in names]
    return spans or None


def per_answer_ms(info: RunInfo, names: Sequence[str]) -> Optional[float]:
    """Mean milliseconds per answer that did not fail in the spans named
    `names`."""
    spans = _named(info, names)
    done = [a for a in info.answers if not a.failed]
    if spans is None or not done:
        return None
    return mean(sum(s.duration_s for s in _within(spans, a))
                for a in done) * 1000.0


def charged_ms(info: RunInfo, cost: str) -> Optional[float]:
    """Mean milliseconds per answer that did not fail charged to the
    program's spans as `cost` ("gc_s", "compile_s"), each charge once: to
    the one span open when it was paid."""
    spans = window_spans(info)
    done = [a for a in info.answers if not a.failed]
    if not spans or not done:
        return None
    return mean(sum(getattr(s, cost) for s in _within(spans, a))
                for a in done) * 1000.0


def per_pop_us(info: RunInfo, names: Sequence[str]) -> Optional[float]:
    """Microseconds in the spans named `names` per placement, over the
    answers completed in the window."""
    spans = _named(info, names)
    done = readers.completed(info)
    pops = sum(a.placed for a in done)
    if spans is None or not pops:
        return None
    return sum(s.duration_s for a in done for s in _within(spans, a)) \
        / pops * 1e6

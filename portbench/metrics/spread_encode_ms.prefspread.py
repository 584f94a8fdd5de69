"""Encode layer: mean ms per answer in PodTopologySpread's encode of the pod's soft (ScheduleAnyway) constraints, from the program's spans pts.encode of kind soft (moves placements_per_s)."""

from portbench import spans
from portbench.harness import mean


def read(info):
    found = spans.window_spans(info)
    if found is None:
        return None
    soft = [s for s in found if s.name == "pts.encode"
            and s.attrs.get("kind") == "soft"]
    done = [a for a in info.answers if not a.failed]
    if not soft or not done:
        return None
    return mean(sum(s.duration_s for s in spans._within(soft, a))
                for a in done) * 1000.0

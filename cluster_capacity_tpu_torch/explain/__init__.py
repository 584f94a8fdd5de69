"""Placement explainability: device-computed attribution for every solve.

Three products per solve:

- **why-not** — a per-node elimination record extending the static
  `static_code` encoding into the full filter chain: every node carries the
  reason code of its first failing plugin (diagnose() priority order) at
  every step, computed on the device inside the scan step (attribution.py),
  plus the step index at which the node was first eliminated.  The terminal
  codes expand to the same reason-string histogram diagnose() produces —
  over ALL nodes, not just the terminal unschedulable pod.
- **why-here** — per-plugin weighted score contributions for each placement,
  a [placements, plugins] artifact decomposed from the engine's own score
  terms (simulator._score_terms) and the fast path's score matrix.
- **bottleneck** — which resource dimension binds first per node and the
  cluster-wide marginal capacity per resource (bottleneck.py, pure host
  numpy over the fit encodings — dispatch-free).

All device-to-host reads happen at the solvers' existing sync points
(simulator.solve / fast_path.solve_fast / parallel/sweep): attribution
rides the solve as extra step outputs, never as a mid-chunk sync, so the
explain step runs under the same CUDA-graph replays as the scan step.
"""

from .artifacts import PLUGINS, Explanation, build_explanation, reason_histogram
from .bottleneck import bottleneck_analysis

__all__ = [
    "PLUGINS",
    "Explanation",
    "build_explanation",
    "reason_histogram",
    "bottleneck_analysis",
]

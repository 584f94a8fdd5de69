"""Capacity bounds: the host half of the JAX package's bounds/ package.

A fractional relaxation of the fit encodings brackets every solve's answer
before the engine runs; simulator.solve and the batched sweep clamp their
step budgets to the upper bound (`--no-bounds` turns that off).  The JAX
package's device runners (bracket_device, auction_device, bracket_group,
bracket_mix) serve resilience and interleaved sweeps, which this package
does not run yet.
"""

from .bracket import (UNBOUNDED, CapacityBracket, bracket_host,
                      exact_capacity, exhausted_fit_counts, upper_bound_host)

__all__ = [
    "UNBOUNDED", "CapacityBracket", "bracket_host", "exact_capacity",
    "exhausted_fit_counts", "upper_bound_host",
]

"""Capacity bounds: the fractional upper and constructive lower bound of
every solve (bounds/bracket.py).

simulator.solve and the batched sweep clamp their step budgets to the host
upper bound (`--no-bounds` turns that off); resilience sweeps bracket every
batched scenario in one guarded device shot (`bracket_group`) and skip the
solves the bracket proves.  The JAX package's `auction_device` and
`bracket_mix` (template mixes) arrive with the interleave slice.
"""

from .bracket import (UNBOUNDED, CapacityBracket, bracket_device,
                      bracket_group, bracket_host, exact_capacity,
                      exhausted_fit_counts, upper_bound_host)

__all__ = [
    "UNBOUNDED", "CapacityBracket", "bracket_device", "bracket_group",
    "bracket_host", "exact_capacity", "exhausted_fit_counts",
    "upper_bound_host",
]

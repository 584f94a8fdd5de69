"""Capacity bounds: the fractional upper and constructive lower bound of
every solve (bounds/bracket.py).

simulator.solve and the batched sweep clamp their step budgets to the host
upper bound (`--no-bounds` turns that off); resilience sweeps bracket every
batched scenario in one guarded device shot (`bracket_group`) and skip the
solves the bracket proves; interleaved sweeps bracket the whole template
mix (`bracket_mix`, with the K-round `auction_device` as its lower bound).
"""

from .bracket import (UNBOUNDED, CapacityBracket, auction_device,
                      bracket_device, bracket_group, bracket_host,
                      bracket_mix, exact_capacity, exhausted_fit_counts,
                      upper_bound_host)

__all__ = [
    "UNBOUNDED", "CapacityBracket", "auction_device", "bracket_device",
    "bracket_group", "bracket_host", "bracket_mix", "exact_capacity",
    "exhausted_fit_counts", "upper_bound_host",
]

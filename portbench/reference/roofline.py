"""The yardstick's table of peaks and the work of one placement step,
counted from a cell's shapes (not from the program's launch tables), so
the count means the same whatever implements the step.

The per-node operation count is the benchmark's copy of the port's step
tally (compares, selects and arithmetic per node per step, reductions
counted once per node) for the default profile's plugins: the fit filter
over every resource column, hard spreads, LeastAllocated and
BalancedAllocation over cpu and memory, the taint and image-locality terms,
the argmax and the commit.
"""

from __future__ import annotations

# NVIDIA H100 SXM, dense, the data sheet's rates at the 700 W limit
PEAKS = {"NVIDIA H100 80GB HBM3": {"f32_flops": 67e12, "hbm_bytes": 3.35e12}}
DEFAULT_PEAK = PEAKS["NVIDIA H100 80GB HBM3"]


def peak_for(kind: str) -> dict:
    return PEAKS.get(kind, DEFAULT_PEAK)


def step_ops(resources: int, hard_spreads: int, fit_resources: int = 2,
             balanced_resources: int = 2) -> int:
    """Float operations per node per step."""
    ops = 2                                   # static mask, write feasible
    ops += 3 + 3 * (resources - 1)            # fit filter
    ops += 6 * hard_spreads + 2               # hard spreads, any-feasible
    ops += 11 * fit_resources + 4             # LeastAllocated
    ops += 14 * balanced_resources + 8        # BalancedAllocation
    ops += 7 + 3                              # taint, image locality terms
    ops += 4 + 3 * hard_spreads               # argmax and commit
    return ops


def step_bytes(nodes: int, resources: int, hard_spreads: int,
               steps: int) -> int:
    """Bytes a solve must move at least: every operand read once and every
    result written once (float32 planes, int32 domain ids and choices)."""
    planes_in = 2 * resources + 2 + 1 + 3 * hard_spreads   # alloc, used,
    planes_out = resources + 2 + hard_spreads + 1          # nonzero, mask..
    return 4 * nodes * (planes_in + planes_out) + 4 * steps


def least_seconds(nodes: int, resources: int, hard_spreads: int,
                  steps: int, kind: str = "") -> dict:
    """The least time the card could take for `steps` steps: operations
    over the float32 peak or bytes over the HBM rate, whichever is larger,
    and which bounds."""
    peak = peak_for(kind)
    flops = step_ops(resources, hard_spreads) * nodes * steps
    moved = step_bytes(nodes, resources, hard_spreads, steps)
    t_ops = flops / peak["f32_flops"]
    t_bytes = moved / peak["hbm_bytes"]
    return {"seconds": max(t_ops, t_bytes), "flops": flops, "bytes": moved,
            "bound": "operations" if t_ops >= t_bytes else "bytes"}

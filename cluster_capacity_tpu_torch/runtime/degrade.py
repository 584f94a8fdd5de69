"""Rung stamps of the degradation ladder, and the two guarded entries.

The JAX package's runtime/degrade.py descends a ladder of engines when a
solve faults (sharded_batched → fused_batched → fused → fast_path →
oracle) and stamps each result with the rung that served it.  This module
keeps the ladder's names and ranking, so reports carry the same `rung`, and
the top rungs the port runs:

    fused_batched  one batched kernel solve for a whole template group
    fused          the full engine per problem (closed-form fast path when
                   exact, the fused kernel otherwise)

The fault ladder itself (classified faults, OOM halving, the lower rungs)
is not ported: a fault raises.
"""

from __future__ import annotations

from typing import List

RUNG_SHARDED = "sharded_batched"
RUNG_BATCHED = "fused_batched"
RUNG_FUSED = "fused"
RUNG_FAST_PATH = "fast_path"
RUNG_ORACLE = "oracle"
# Multi-template ladder of the JAX package's interleave engine: these rungs
# stamp results but do not join LADDER — worst_rung ranks the
# single-template ladder first.
RUNG_INTERLEAVE_SHARDED = "interleave_sharded"
RUNG_INTERLEAVE = "interleave"

# Ladder order, highest (healthiest) first.
LADDER = (RUNG_SHARDED, RUNG_BATCHED, RUNG_FUSED, RUNG_FAST_PATH,
          RUNG_ORACLE)
INTERLEAVE_LADDER = (RUNG_INTERLEAVE_SHARDED, RUNG_INTERLEAVE)


def _worst_in(results, ladder) -> str:
    worst = -1
    for r in results:
        rung = getattr(r, "rung", "")
        if rung in ladder:
            worst = max(worst, ladder.index(rung))
    return ladder[worst] if worst >= 0 else ""


def worst_rung(results) -> str:
    """The lowest rung among a set of results ('' when none are stamped).

    Single-template LADDER rungs rank first; a result set served entirely
    by the multi-template interleave ladder reports its own worst rung."""
    return (_worst_in(results, LADDER)
            or _worst_in(results, INTERLEAVE_LADDER))


def _stamp(result, rung: str, degraded: bool):
    if result is not None:
        result.rung = rung
        result.degraded = degraded or result.degraded
    return result


def solve_one_guarded(pb, max_limit: int = 0, device=None):
    """Single-problem solve on the healthy rung: fast_path.solve_auto (the
    closed form when exact, the fused kernel otherwise), stamped 'fused'."""
    from ..engine import fast_path
    return _stamp(fast_path.solve_auto(pb, max_limit=max_limit,
                                       device=device), RUNG_FUSED, False)


def solve_group_guarded(pbs, max_limit: int = 0, device=None) -> List:
    """Batched group solve (parallel/sweep.solve_group), each result
    stamped 'fused_batched'."""
    from ..parallel import sweep as sweep_mod
    if not pbs:
        return []
    return [_stamp(r, RUNG_BATCHED, False)
            for r in sweep_mod.solve_group(pbs, max_limit=max_limit,
                                           device=device)]

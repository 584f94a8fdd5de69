"""Bounded retry, geometric batch splitting, and the degradation ladder.

Every hardened solve descends a fixed ladder until a rung serves:

    fused_batched  one batched kernel solve for a whole template group
                   (kernel 2, engine/fused_batched.py)
    fused          the full engine per problem: the closed form when exact,
                   else kernel 1 (engine/fused.py) or, for problems outside
                   its envelope, the scan step (engine/simulator.py) —
                   fast_path.solve_auto
    fast_path      the closed-form solve alone (None ⇒ keep falling)
    oracle         sequential host-side reference simulation
                   (engine/oracle.py)

The JAX package's top rung, sharded_batched, runs over a device mesh and
arrives with the port's parallel/mesh slice; its name stays in LADDER so
rung ranking matches.

Rung transitions happen ONLY on classified faults (DeviceOOM, Compile/
ExecuteTimeout, NumericCorruption); anything else — a failed kernel build,
a launch the plan refuses, an illegal address — propagates raw.  OOM on a
batched group first splits the group in half and re-dispatches (down to
B=1); splitting preserves the numbers because batched solves are
independent per problem.  Each result records the rung that served it
(`result.rung`) and whether any fault occurred en route
(`result.degraded`); a SolveDegraded event is recorded per transition.
The card is never swapped for the CPU: the fused and fast_path rungs run on
the caller's device, and only the oracle runs on the host.

The rungs serve the same numbers: the closed form equals the kernel where
it answers (tests/test_torch_fast_path.py), batched equals per-item, and
the oracle equals the engine under the JAX package's parity profile
(tests/test_oracle_parity.py) and on the fit-only problems of the ladder
drills (tests/test_torch_runtime.py).
"""

from __future__ import annotations

from typing import List, Optional

from . import guard
from .errors import DeviceOOM, RuntimeFault
from .faults import SITE_FAST_PATH, SITE_GROUP, SITE_ORACLE, SITE_SOLVE

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

EVENT_DEGRADED = "SolveDegraded"


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


def _record(fault: RuntimeFault, next_rung: str) -> None:
    """The SolveDegraded event of one transition (the JAX package also
    counts it in its metrics registry and flight recorder, which arrive
    with the port's obs/ slice)."""
    from ..utils.events import default_recorder
    default_recorder.eventf(
        "solve", EVENT_DEGRADED,
        f"{fault.code} at {fault.site or '?'}: falling back to "
        f"{next_rung}: {fault}")


def _solve_oracle(pb, max_limit: int = 0, explain: bool = False):
    """Host-side sequential reference as a SolveResult, reproducing
    simulator.solve's budget semantics and failure messages exactly; with
    `explain`, the oracle's attribution (reason strings, not codes) as the
    result's Explanation."""
    import numpy as np

    from ..engine import oracle
    from ..engine import simulator as sim

    if pb.snapshot.num_nodes == 0:
        return sim.SolveResult(placements=[], placed_count=0,
                               fail_type=sim.FAIL_UNSCHEDULABLE,
                               fail_message="0/0 nodes are available",
                               node_names=[])
    n = pb.snapshot.num_nodes
    if pb.pod_level_reason:
        expl = None
        if explain:
            from ..explain import artifacts
            expl = artifacts.build_explanation(
                pb, histogram={pb.pod_level_reason: n}, rung=RUNG_ORACLE)
        return sim.SolveResult(
            placements=[], placed_count=0,
            fail_type=pb.pod_level_fail_type,
            fail_message=f"0/{n} nodes are available: "
                         f"{pb.pod_level_reason}.",
            fail_counts={pb.pod_level_reason: n},
            node_names=pb.snapshot.node_names, explain=expl)

    cap = max_limit if max_limit and max_limit > 0 \
        else sim._DEFAULT_UNLIMITED_CAP
    explain_out = {} if explain else None
    placements, counts = oracle.simulate(pb.snapshot, pb.pod, pb.profile,
                                         max_limit=cap,
                                         explain_out=explain_out)
    placed = len(placements)

    expl = None
    if explain:
        from ..explain import artifacts
        elim_step = np.asarray(explain_out["elim_step"], dtype=np.int32)
        why_here = np.asarray(explain_out["why_here"], dtype=np.float64) \
            if explain_out["why_here"] \
            else np.zeros((0, len(artifacts.PLUGINS)))
        # The oracle attributes eliminations as reason STRINGS, not codes.
        # At an exhausted terminal `counts` already is the all-nodes
        # histogram (with the multi-resource fit expansion); on
        # limit-reached runs it falls back to the first-fail reasons.
        if counts:
            hist = dict(counts)
        else:
            hist = {}
            for r in explain_out["elim_reason"]:
                if r:
                    hist[r] = hist.get(r, 0) + 1
        expl = artifacts.build_explanation(
            pb, why_here=why_here, elim_step=elim_step, histogram=hist,
            feasible_nodes=int(np.sum(elim_step < 0)), rung=RUNG_ORACLE)

    if max_limit and placed >= max_limit:
        return sim.SolveResult(
            placements=placements, placed_count=placed,
            fail_type=sim.FAIL_LIMIT_REACHED,
            fail_message=f"Maximum number of pods simulated: {max_limit}",
            node_names=pb.snapshot.node_names, explain=expl)
    if counts:
        return sim.SolveResult(
            placements=placements, placed_count=placed,
            fail_type=sim.FAIL_UNSCHEDULABLE,
            fail_message=sim.format_fit_error(n, counts),
            fail_counts=counts, node_names=pb.snapshot.node_names,
            explain=expl)
    return sim.SolveResult(
        placements=placements, placed_count=placed,
        fail_type=sim.FAIL_LIMIT_REACHED,
        fail_message=(f"Simulation step budget exhausted after {placed} "
                      f"placements; set max_limit to bound unlimited "
                      f"profiles"),
        node_names=pb.snapshot.node_names, explain=expl)


def solve_one_guarded(pb, max_limit: int = 0, *, deadline: float = 0.0,
                      retries: int = 0, degraded: bool = False,
                      explain: bool = False, bounds: bool = True,
                      device=None):
    """Hardened single-problem solve: full engine → closed form → host
    oracle.  `retries` re-attempts the SAME rung before descending
    (transient device errors); `degraded` pre-marks the result when the
    caller already fell off a higher rung.  `explain` threads attribution
    through whichever rung serves (result.explain.rung records which).
    `bounds` clamps the engine's step budget to the capacity upper bound
    (simulator.step_budget).
    `device`: the card unless the caller names the CPU; the fused and
    fast_path rungs run there.

    The JAX package drops the per-problem memos it built on the device
    (`_fast_state_memo`, `_device_consts_memo`) before a lower rung runs.
    The port keeps no state on the card between solves — every rung builds
    its tensors from the problem's host arrays — so a lower rung starts
    from host inputs already."""
    from ..engine import fast_path

    n = pb.snapshot.num_nodes

    def _attempt(fn, site):
        last: Optional[RuntimeFault] = None
        for _ in range(retries + 1):
            try:
                return guard.run(fn, site=site, deadline=deadline,
                                 phase=guard.PHASE_EXECUTE,
                                 validate_nodes=n), None
            except RuntimeFault as fault:
                last = fault
        return None, last

    result, fault = _attempt(
        lambda: fast_path.solve_auto(pb, max_limit=max_limit, device=device,
                                     bounds=bounds, explain=explain),
        SITE_SOLVE)
    if fault is None:
        return _stamp(result, RUNG_FUSED, degraded)

    _record(fault, RUNG_FAST_PATH)
    result, fp_fault = _attempt(
        lambda: fast_path.solve_fast(pb, max_limit=max_limit, device=device,
                                     explain=explain),
        SITE_FAST_PATH)
    if fp_fault is None and result is not None:
        return _stamp(result, RUNG_FAST_PATH, True)

    _record(fp_fault or fault, RUNG_ORACLE)
    result = guard.run(lambda: _solve_oracle(pb, max_limit=max_limit,
                                             explain=explain),
                       site=SITE_ORACLE, validate_nodes=n)
    return _stamp(result, RUNG_ORACLE, True)


def solve_group_guarded(pbs, max_limit: int = 0, *, deadline: float = 0.0,
                        retries: int = 0, degraded: bool = False,
                        explain: bool = False, bounds: bool = True,
                        device=None) -> List:
    """Hardened batched group solve (parallel/sweep.solve_group: kernel 2,
    or the scan step per template where kernel 2 does not take the group).
    DeviceOOM splits the group in half geometrically (independent
    sub-batches, the same placements) down to B=1; other faults — and B=1
    OOM — descend to the per-item ladder."""
    from ..parallel import sweep as sweep_mod

    if not pbs:
        return []
    n = pbs[0].snapshot.num_nodes

    last: Optional[RuntimeFault] = None
    for _ in range(retries + 1):
        try:
            results = guard.run(
                lambda: sweep_mod.solve_group(pbs, max_limit=max_limit,
                                              explain=explain, bounds=bounds,
                                              device=device),
                site=SITE_GROUP, deadline=deadline,
                phase=guard.PHASE_COMPILE, validate_nodes=n)
            return [_stamp(r, RUNG_BATCHED, degraded) for r in results]
        except RuntimeFault as fault:
            last = fault

    if isinstance(last, DeviceOOM) and len(pbs) > 1:
        mid = len(pbs) // 2
        _record(last, f"{RUNG_BATCHED}[{mid}+{len(pbs) - mid}]")
        left = solve_group_guarded(pbs[:mid], max_limit=max_limit,
                                   deadline=deadline, retries=retries,
                                   degraded=True, explain=explain,
                                   bounds=bounds, device=device)
        right = solve_group_guarded(pbs[mid:], max_limit=max_limit,
                                    deadline=deadline, retries=retries,
                                    degraded=True, explain=explain,
                                    bounds=bounds, device=device)
        return left + right

    _record(last, RUNG_FUSED)
    return [solve_one_guarded(pb, max_limit=max_limit, deadline=deadline,
                              retries=retries, degraded=True,
                              explain=explain, bounds=bounds, device=device)
            for pb in pbs]

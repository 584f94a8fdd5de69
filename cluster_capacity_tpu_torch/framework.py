"""Top-level simulation facade.

Mirrors the reference's `pkg/framework` public surface
(pkg/framework/simulator.go:107-381): construct with a pod template and a
scheduler profile, feed it cluster state, run, read the report.  `run()`
encodes the snapshot and solves it through runtime/degrade.solve_one_guarded
(the closed-form fast path when it is exact, else engine/simulator.py: the
fused placement kernel on the card, or the scan step for float64 parity,
the random tie-break and shapes outside the kernel's envelope; on the CPU
their plain PyTorch versions when the caller passes device="cpu"), then
runs the
DefaultPreemption PostFilter loop of the JAX package: while a cycle ends
Unschedulable and victims exist, evict them, commit the clones placed so
far, re-snapshot and resume.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

from .engine.encode import encode_problem
from .engine.simulator import SolveResult, resolve_device
from .models import snapshot as snapshot_mod
from .models.podspec import make_clone
from .models.snapshot import ClusterSnapshot
from .utils.config import SchedulerProfile
from .utils.report import ClusterCapacityReview, build_review


class ClusterCapacity:
    """framework.New equivalent (simulator.go:107-158).

    device: where the solve runs — None means the card ("cuda"); pass
    "cpu" to run the plain PyTorch versions.  Without a card and without an
    explicit device="cpu" the constructor raises.  bounds (default True)
    clamps each solve's step budget to the capacity upper bound
    (bounds/bracket.py; --no-bounds turns it off, with the same results).
    explain attaches attribution (explain/: why-not, why-here, bottleneck)
    to the result of every solve cycle, from whichever ladder rung served
    it.  mesh is the JAX package's option; setting it raises
    NotImplementedError.

    After run(), `cycle_seconds` holds one {"encode", "solve", "evaluate",
    "commit"} dict of host wall-clock seconds per solve cycle of the
    preemption loop (evaluate: the clones and the dry run; commit: the
    eviction and the re-snapshot; both 0.0 where the cycle ran none), and
    `preemptions` one {"node", "victims", "pdb_violations"} dict per
    eviction the loop made (victims by name, the PDB violations of the
    chosen node's victims)."""

    def __init__(self, pod: dict, max_limit: int = 0,
                 profile: Optional[SchedulerProfile] = None,
                 exclude_nodes: Sequence[str] = (),
                 explain: bool = False, bounds: bool = True, mesh=None,
                 device=None):
        if mesh is not None:
            raise NotImplementedError("meshes are not ported yet (ROADMAP: "
                                      "port queue, parallel/mesh)")
        self.pod = pod
        self.max_limit = max_limit
        self.profile = profile or SchedulerProfile()
        self.exclude_nodes = list(exclude_nodes)
        self.explain = explain
        self.bounds = bounds
        self.device = resolve_device(device)
        self.snapshot: Optional[ClusterSnapshot] = None
        self._result: Optional[SolveResult] = None
        self._final_snapshot: Optional[ClusterSnapshot] = None
        self._snapshot_options: Dict = {}
        self.cycle_seconds: List[Dict[str, float]] = []
        self.preemptions: List[Dict] = []

    def sync_with_objects(self, nodes: Sequence[dict],
                          pods: Sequence[dict] = (), **extra) -> None:
        """SyncWithClient equivalent (simulator.go:176-295) over already-
        fetched objects; `extra` takes services/pvcs/pdbs/... lists plus the
        from_objects options node_order, sort_nodes and use_native."""
        self._snapshot_options = {
            k: extra.pop(k) for k in ("node_order", "sort_nodes", "use_native")
            if k in extra}
        self.snapshot = ClusterSnapshot.from_objects(
            nodes, pods, exclude_nodes=self.exclude_nodes,
            **self._snapshot_options, **extra)

    def set_snapshot(self, snapshot: ClusterSnapshot, **options) -> None:
        """Install an already-built snapshot.  `options` are the
        from_objects options a preemption full rebuild must preserve
        (node_order / sort_nodes / use_native)."""
        self._snapshot_options = dict(options)
        self.snapshot = snapshot

    def run(self) -> SolveResult:
        if self.snapshot is None:
            raise RuntimeError("call sync_with_objects first")
        if self.profile.extenders:
            raise NotImplementedError("scheduler extenders are not ported "
                                      "yet (ROADMAP: port queue, extenders)")
        self._result = self._solve_with_preemption()
        return self._result

    def _solve_with_preemption(self) -> SolveResult:
        """Guarded solve + the DefaultPreemption PostFilter loop: when a
        cycle ends Unschedulable and victims exist, evict them and resume
        (engine/preemption.py; preemption.go:234)."""
        from .engine import preemption as pre
        from .runtime.degrade import solve_one_guarded, worst_rung
        from .utils.events import (REASON_FAILED_SCHEDULING,
                                   REASON_PREEMPTED, default_recorder)

        snapshot = self.snapshot
        profile = self.profile
        preempt_on = "DefaultPreemption" in profile.post_filters

        snap = snapshot
        placements: List[int] = []
        clone_seq = 0
        result: Optional[SolveResult] = None
        cycle_results: List[SolveResult] = []   # rung/degraded provenance
        self.cycle_seconds = []
        self.preemptions = []

        while True:
            t0 = time.perf_counter()
            problem = encode_problem(snap, self.pod, profile)
            t_encode = time.perf_counter() - t0
            remaining = (self.max_limit - len(placements)) \
                if self.max_limit else 0
            if self.max_limit and remaining <= 0:
                break
            t0 = time.perf_counter()
            result = solve_one_guarded(problem, max_limit=remaining,
                                       explain=self.explain,
                                       bounds=self.bounds,
                                       device=self.device)
            timing = {"encode": t_encode,
                      "solve": time.perf_counter() - t0, "evaluate": 0.0,
                      "commit": 0.0}
            self.cycle_seconds.append(timing)
            cycle_results.append(result)
            placements.extend(result.placements)
            if result.fail_type != "Unschedulable" or not preempt_on:
                break

            t0 = time.perf_counter()
            # the clones of this cycle, named as the JAX loop names them;
            # the dry run sees them and, on resume, they are committed
            clones = []
            for idx in result.placements:
                clone = make_clone(self.pod, clone_seq + len(clones))
                clone["spec"]["nodeName"] = snap.node_names[idx]
                clones.append(clone)
            state_pods = [list(p) for p in snap.pods_by_node]
            for idx, clone in zip(result.placements, clones):
                state_pods[idx].append(clone)
            outcome = pre.evaluate(snap, state_pods, self.pod, profile)
            timing["evaluate"] = time.perf_counter() - t0
            default_recorder.eventf(
                (self.pod.get("metadata") or {}).get("name", ""),
                REASON_FAILED_SCHEDULING, result.fail_message)
            for v in outcome.victims:
                default_recorder.eventf(
                    (v.get("metadata") or {}).get("name", ""),
                    REASON_PREEMPTED,
                    f"Preempted by pod on node "
                    f"{snap.node_names[outcome.node_index]}")
            if not outcome.succeeded:
                if profile.include_preemption_message and \
                        outcome.message_counts:
                    result.fail_message += " " + \
                        pre.format_preemption_message(snap.num_nodes,
                                                      outcome.message_counts)
                break
            self.preemptions.append({
                "node": snap.node_names[outcome.node_index],
                "victims": [(v.get("metadata") or {}).get("name", "")
                            for v in outcome.victims],
                "pdb_violations": pre._pdb_violations(
                    outcome.victims, pre._pdb_disruptions_allowed(snap))})
            t0 = time.perf_counter()
            # Evict the victims and resume; clones placed so far become
            # pods.  Only the touched nodes' rows change → incremental
            # re-snapshot (models.snapshot.with_pods_by_node); the full
            # rebuild is the fallback when vocabulary rules prevent it.
            is_victim = pre.victim_matcher(outcome.victims)
            new_pbn = [[p for p in plist if not is_victim(p)]
                       for plist in snap.pods_by_node]
            changed = {i for i, plist in enumerate(snap.pods_by_node)
                       if len(new_pbn[i]) != len(plist)}
            if not changed and not result.placements:
                # nothing evicted and nothing placed: the state cannot
                # progress — stop rather than loop forever
                break
            for idx, clone in zip(result.placements, clones):
                new_pbn[idx].append(clone)
                changed.add(idx)
            clone_seq += len(clones)
            next_snap = snapshot_mod.with_pods_by_node(
                snap, new_pbn, sorted(changed))
            if next_snap is None:
                next_snap = ClusterSnapshot.from_objects(
                    snap.nodes, [p for plist in new_pbn for p in plist],
                    **self._snapshot_options,
                    **{k: getattr(snap, k)
                       for k in snapshot_mod.OBJECT_FIELDS})
            snap = next_snap
            timing["commit"] = time.perf_counter() - t0

        self._final_snapshot = snap
        if result is None:
            result = solve_one_guarded(
                encode_problem(snapshot, self.pod, profile),
                max_limit=self.max_limit, explain=self.explain,
                bounds=self.bounds, device=self.device)
            cycle_results.append(result)
        # a preemption loop spans several solves: the report's provenance is
        # the WORST rung any cycle fell to, degraded if any cycle was
        result.degraded = any(r.degraded for r in cycle_results)
        result.rung = worst_rung(cycle_results)
        if self.max_limit and len(placements) >= self.max_limit:
            result.fail_type = "LimitReached"
            result.fail_message = (f"Maximum number of pods simulated: "
                                   f"{self.max_limit}")
        result.placements = placements
        result.placed_count = len(placements)
        return result

    @property
    def post_run_snapshot(self) -> Optional[ClusterSnapshot]:
        """The working snapshot after run()'s preemption loop: the installed
        snapshot unless the loop advanced it (evictions, plus clones
        committed on resume — the final cycle's placements are never
        committed)."""
        return self._final_snapshot if self._final_snapshot is not None \
            else self.snapshot

    def report(self) -> ClusterCapacityReview:
        if self._result is None:
            raise RuntimeError("call run() first")
        return build_review([self.pod], self._result)

    def scheduled_pods(self) -> List[dict]:
        """ScheduledPods equivalent (simulator.go:172): the placed clones as
        pod objects with nodeName set."""
        if self._result is None:
            return []
        out = []
        for i, idx in enumerate(self._result.placements):
            clone = make_clone(self.pod, i)
            clone["spec"]["nodeName"] = self._result.node_names[idx]
            clone.setdefault("status", {})["phase"] = "Running"
            out.append(clone)
        return out

    def close(self) -> None:
        """Close equivalent (simulator.go:314-325): nothing to tear down —
        no informers, goroutines, or channels exist in this design."""
        self.snapshot = None
        self._result = None

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
far, re-snapshot and resume.  A profile with scheduler extenders solves
each cycle through the host-driven extender loop instead
(engine/extenders.solve_with_extenders, plain PyTorch on the same device).
Cluster state comes from already-fetched objects (sync_with_objects), a
live kubernetes client (sync_with_client) or a built snapshot
(set_snapshot: a checkpoint, a reused --watch snapshot).
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional, Sequence

from .engine.encode import encode_problem
from .engine.simulator import SolveResult, resolve_device
from .models import snapshot as snapshot_mod
from .models.podspec import make_clone
from .models.snapshot import ClusterSnapshot
from .obs import spans as obs_spans
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
    it (not on the extender path, which has none in the JAX package
    either).  mesh (parallel/mesh.Mesh, on the solve's device type): each
    batchable solve cycle runs as a one-template group on the sharded rung
    (runtime/degrade.solve_group_guarded), as in the JAX package; explain
    and extender runs, and problems with clone self-conflicts, keep the
    per-problem ladder.

    After run(), `cycle_seconds` holds one {"encode", "solve", "evaluate",
    "commit"} dict of host wall-clock seconds per solve cycle of the
    preemption loop (evaluate: the clones and the dry run; commit: the
    eviction and the re-snapshot; both 0.0 where the cycle ran none), and
    `preemptions` one {"node", "victims", "pdb_violations"} dict per
    eviction the loop made (victims by name, the PDB violations of the
    chosen node's victims).  Each evaluate runs in the span
    `preemption.dryrun`, with attrs `path` and `lower_priority_pods`.  Where
    preemption.no_candidate_possible holds and neither the preemption
    message nor an extender asks for the per-node dry run, the path is
    "no_candidate": the cycle fails as the dry run would, with nothing
    built.  Otherwise ("full") its clones run in `preemption.clones`, then
    preemption.evaluate's `preemption.filter` and `preemption.pick`; the
    full path counts in utils/metrics.PREEMPTION_ATTEMPTS.  The run keeps
    one victim table (engine/preemption_table.VictimTable) from its first
    full-path dry run to its return, for evaluate's filter where the input
    allows it: each commit marks the nodes it changed, and a full rebuild
    drops it.  Each eviction and re-snapshot runs in `preemption.commit`
    (attrs `victims`, `nodes_changed`, and `rebuild`: 1 where the
    incremental re-snapshot fell back to a full build), its victims
    observed in utils/metrics.PREEMPTION_VICTIMS."""

    def __init__(self, pod: dict, max_limit: int = 0,
                 profile: Optional[SchedulerProfile] = None,
                 exclude_nodes: Sequence[str] = (),
                 explain: bool = False, bounds: bool = True, mesh=None,
                 device=None):
        self.pod = pod
        self.max_limit = max_limit
        self.profile = profile or SchedulerProfile()
        self.exclude_nodes = list(exclude_nodes)
        self.explain = explain
        self.bounds = bounds
        self.device = resolve_device(device)
        if mesh is not None:
            from .parallel import mesh as mesh_lib
            mesh_lib.check_device(mesh, self.device)
        self.mesh = mesh
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

    # live-sync resource kinds beyond nodes/pods: duck-typed method name →
    # sync_with_objects keyword (the reference copies the same kinds,
    # simulator.go:176-295; storage/policy/scheduling APIs may live on the
    # same facade object or be absent entirely)
    _SYNC_METHODS = (
        ("list_namespace", "namespaces"),
        ("list_service_for_all_namespaces", "services"),
        ("list_persistent_volume_claim_for_all_namespaces", "pvcs"),
        ("list_persistent_volume", "pvs"),
        ("list_replication_controller_for_all_namespaces",
         "replication_controllers"),
        ("list_pod_disruption_budget_for_all_namespaces", "pdbs"),
        ("list_replica_set_for_all_namespaces", "replica_sets"),
        ("list_stateful_set_for_all_namespaces", "stateful_sets"),
        ("list_storage_class", "storage_classes"),
        ("list_csi_node", "csinodes"),
        ("list_csi_storage_capacity_for_all_namespaces",
         "csistoragecapacities"),
        ("list_priority_class", "priority_classes"),
        ("list_limit_range_for_all_namespaces", "limit_ranges"),
        ("list_resource_slice", "resource_slices"),
        ("list_resource_claim_for_all_namespaces", "resource_claims"),
        ("list_resource_claim_template_for_all_namespaces",
         "resource_claim_templates"),
        ("list_device_class", "device_classes"),
    )

    def sync_with_client(self, client, *extra_apis) -> None:
        """SyncWithClient over live kubernetes.client-compatible API objects
        (duck-typed).  `client` must expose list_node/
        list_pod_for_all_namespaces; every other resource kind the reference
        syncs (simulator.go:176-295) is fetched from whichever of
        (client, *extra_apis) exposes its list method — pass the AppsV1 /
        PolicyV1 / StorageV1 / SchedulingV1 API objects for full parity."""
        apis = (client,) + tuple(extra_apis)
        nodes = [_to_dict(x) for x in client.list_node().items]
        pods = [_to_dict(x) for x in client.list_pod_for_all_namespaces().items]
        extra = {}
        for method, kw in self._SYNC_METHODS:
            last_err = None
            for api in apis:
                fn = getattr(api, method, None)
                if fn is None:
                    continue
                try:
                    extra[kw] = [_to_dict(x) for x in fn().items]
                    break
                except Exception as e:
                    last_err = e         # try the next api exposing it
            if last_err is not None and kw not in extra:
                # RBAC-scoped accounts / disabled API groups: the reference
                # would fail the whole sync, but a nodes+pods analysis is
                # still meaningful — degrade with a warning (the JAX
                # package's wording, package name included)
                sys.stderr.write(
                    f"cluster_capacity_tpu: skipping {kw} sync "
                    f"({type(last_err).__name__}: {last_err})\n")
        self.sync_with_objects(nodes, pods, **extra)

    def run(self) -> SolveResult:
        if self.snapshot is None:
            raise RuntimeError("call sync_with_objects/sync_with_client first")
        from .utils import metrics
        from .utils.trace import SPAN_SOLVE, default_tracer
        t0 = time.perf_counter()
        with default_tracer.span(SPAN_SOLVE), default_tracer.profile():
            self._result = self._solve_with_preemption(default_tracer)
        reg = metrics.default_registry
        reg.inc(metrics.SCHEDULE_ATTEMPTS, amount=self._result.placed_count,
                result="scheduled", profile=self.profile.name)
        if self._result.fail_type == "Unschedulable":
            reg.inc(metrics.SCHEDULE_ATTEMPTS, result="unschedulable",
                    profile=self.profile.name)
        reg.observe(metrics.SCHEDULING_DURATION, time.perf_counter() - t0)
        return self._result

    def _solve_with_preemption(self, tracer) -> SolveResult:
        """Guarded solve + the DefaultPreemption PostFilter loop: when a
        cycle ends Unschedulable and victims exist, evict them and resume
        (engine/preemption.py; preemption.go:234)."""
        from .engine import preemption as pre
        from .engine.preemption_table import VictimTable
        from .engine.extenders import make_node_ok, solve_with_extenders
        from .runtime import faults, guard
        from .parallel import sweep as sweep_mod
        from .runtime.degrade import (solve_group_guarded, solve_one_guarded,
                                      worst_rung)
        from .utils import metrics
        from .utils.events import (REASON_FAILED_SCHEDULING,
                                   REASON_PREEMPTED, default_recorder)
        from .utils.trace import SPAN_ENCODE

        reg = metrics.default_registry
        snapshot = self.snapshot
        profile = self.profile
        preempt_on = "DefaultPreemption" in profile.post_filters

        snap = snapshot
        placements: List[int] = []
        clone_seq = 0
        result: Optional[SolveResult] = None
        cycle_results: List[SolveResult] = []   # rung/degraded provenance
        table = None                    # this answer's victim table
        self.cycle_seconds = []
        self.preemptions = []

        while True:
            t0 = time.perf_counter()
            with tracer.span(SPAN_ENCODE):
                problem = encode_problem(snap, self.pod, profile)
            t_encode = time.perf_counter() - t0
            remaining = (self.max_limit - len(placements)) \
                if self.max_limit else 0
            if self.max_limit and remaining <= 0:
                break
            t0 = time.perf_counter()
            if profile.extenders:
                # extender solves go through the same supervisor as every
                # other device dispatch: no lower rung reproduces extender
                # semantics, so faults surface as structured RuntimeFaults
                # instead of degrading
                result = guard.run(
                    solve_with_extenders, problem, profile.extenders,
                    max_limit=remaining, device=self.device,
                    site=faults.SITE_EXTENDERS,
                    validate_nodes=problem.snapshot.num_nodes)
            elif self.mesh is not None and not self.explain \
                    and sweep_mod._batchable(problem):
                result = solve_group_guarded(
                    [problem], max_limit=remaining, mesh=self.mesh,
                    bounds=self.bounds, device=self.device)[0]
            else:
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
            with obs_spans.span("preemption.dryrun") as dry:
                # the clones share the pod's priority, so where no resident
                # ranks below it no node can hold a victim: without the
                # message's per-node counts or an extender's Filter calls
                # to reproduce, the dry run's answer is known unbuilt
                hopeless = pre.no_candidate_possible(snap, self.pod)
                short = hopeless and not profile.include_preemption_message \
                    and not profile.extenders
                # the scan stops at the first lower-priority pod: 0 or 1
                dry.attrs.update(path="no_candidate" if short else "full",
                                 lower_priority_pods=int(not hopeless))
                if short:
                    outcome = pre.PreemptionOutcome(None, [], {})
                else:
                    reg.inc(metrics.PREEMPTION_ATTEMPTS)
                    # the clones of this cycle, named as the JAX loop names
                    # them; the dry run sees them and, on resume, they are
                    # committed
                    with obs_spans.span("preemption.clones"):
                        clones = []
                        for idx in result.placements:
                            clone = make_clone(self.pod,
                                               clone_seq + len(clones))
                            clone["spec"]["nodeName"] = snap.node_names[idx]
                            clones.append(clone)
                        state_pods = [list(p) for p in snap.pods_by_node]
                        for idx, clone in zip(result.placements, clones):
                            state_pods[idx].append(clone)
                    if table is None:
                        table = VictimTable(self.pod, profile, self.device)
                    table.mark(result.placements)
                    outcome = pre.evaluate(
                        snap, state_pods, self.pod, profile,
                        node_ok=make_node_ok(profile.extenders, self.pod,
                                             snap.node_names, snap.nodes),
                        extenders=profile.extenders, table=table)
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
            reg.observe(metrics.PREEMPTION_VICTIMS, len(outcome.victims),
                        buckets=metrics.PREEMPTION_VICTIM_BUCKETS)
            t0 = time.perf_counter()
            with obs_spans.span("preemption.commit",
                                victims=len(outcome.victims)) as commit:
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
                    commit.attrs.update(nodes_changed=0, rebuild=0)
                    break
                for idx, clone in zip(result.placements, clones):
                    new_pbn[idx].append(clone)
                    changed.add(idx)
                clone_seq += len(clones)
                next_snap = snapshot_mod.with_pods_by_node(
                    snap, new_pbn, sorted(changed))
                commit.attrs.update(nodes_changed=len(changed),
                                    rebuild=int(next_snap is None))
                table.mark(changed)
                if next_snap is None:
                    table = None        # the rebuild may reorder the nodes
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


def _to_dict(obj):
    """kubernetes-client model → plain k8s JSON dict.

    Uses the client's own serializer (attribute_map-aware), which camelizes
    struct field names only — never user-data map keys like labels, selector
    keys, or taint keys."""
    if isinstance(obj, dict):
        return obj
    if hasattr(obj, "to_dict"):
        from kubernetes.client import ApiClient  # type: ignore
        return ApiClient().sanitize_for_serialization(obj)
    raise TypeError(f"cannot convert {type(obj)} to dict")

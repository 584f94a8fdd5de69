"""Batched N-k failure sweeps with drain re-scheduling.

Semantics contract: the ground truth for "node X failed" is a snapshot with
node X physically deleted.  The fast path instead marks X dead through an
encode-time alive_mask (engine/encode.py) and solves ALL scenarios as one
batched device solve (parallel/sweep.solve_group) — the scenario axis
batches exactly like the sweep's template axis, and the mask rides the
static_mask plane into kernel 2 (csrc/fused_steps.cu) or the scan step.
Masking is used only when it is bit-identical to deletion for the probe at
hand (_mask_exact); otherwise the scenario falls back to a sequential solve
on the physically deleted snapshot — the same eligibility-gate + fallback
shape as engine/fast_path.solve_auto.

Drain ordering: pods resident on failed nodes are re-queued
highest-priority-first (ops/priority_sort — the PrioritySort queue order)
and re-scheduled one at a time onto the survivors through
framework.ClusterCapacity with max_limit=1, i.e. the full run loop:
DefaultPreemption may evict lower-priority victims (PDB-aware,
engine/preemption.py) to make room, and each pod's outcome feeds the next
pod's snapshot.  A pod that cannot be re-scheduled even with preemption
counts as stranded.
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..engine import encode as enc
from ..engine import simulator as sim
from ..models import snapshot as snapshot_mod
from ..models.snapshot import ClusterSnapshot
from ..ops.priority_sort import sort_pods
from ..parallel import sweep
from ..utils.config import SchedulerProfile
from .scenarios import FailureScenario, dedup_single_node

# Provenance stamp for rows proved by their capacity bracket without a
# device solve — sits alongside (not inside) runtime/degrade.LADDER.
RUNG_BOUNDS = "bounds"


@dataclass
class ScenarioResult:
    name: str
    kind: str
    k: int
    failed_nodes: List[str]
    displaced: int              # pods resident on the failed nodes
    replaced: int               # displaced pods re-scheduled onto survivors
    stranded: int               # displaced pods with nowhere to go
    preempted: int              # victims evicted to make room for displaced
    headroom: int               # probe clones the degraded cluster still fits
    fail_message: str = ""
    batched: bool = False       # solved via the masked batched path
    deduped_of: Optional[str] = None   # metrics copied from this scenario
    # bound-guided pruning (bounds/bracket.py): the bracket rule that proved
    # the row without a device solve — "lower==upper" (tight bracket, row
    # recomputed from the exact per-node caps) or "lower>=limit" (the
    # constructive lower bound already reaches max_limit)
    bounded_of: Optional[str] = None
    probe_placements: Optional[List[str]] = None  # node names, when kept
    # hardened-runtime provenance (runtime/degrade.py): the ladder rung that
    # served the headroom solve, and whether any classified fault degraded it
    rung: str = ""
    degraded: bool = False
    # explain mode (analyze(explain=True)): the degraded cluster's bottleneck
    # analysis plus the capacity delta vs the intact baseline —
    # {"totalCapacity", "bindingCounts", "marginal", "deltaCapacity"}
    bottleneck: Optional[dict] = None


def _scenario_to_dict(r: "ScenarioResult") -> dict:
    """One scenario row of the {"spec","status"} envelope — also the
    journal payload, so a resumed sweep reconstructs rows losslessly."""
    out = {"name": r.name, "kind": r.kind, "k": r.k,
           "failedNodes": list(r.failed_nodes),
           "displaced": r.displaced, "replaced": r.replaced,
           "stranded": r.stranded, "preempted": r.preempted,
           "headroom": r.headroom,
           "failMessage": r.fail_message,
           "batched": r.batched,
           "dedupedOf": r.deduped_of,
           "boundedOf": r.bounded_of,
           "rung": r.rung,
           "degraded": r.degraded}
    if r.probe_placements is not None:
        out["probePlacements"] = list(r.probe_placements)
    if r.bottleneck is not None:
        out["bottleneck"] = r.bottleneck
    return out


def _scenario_from_dict(s: dict) -> "ScenarioResult":
    return ScenarioResult(
        name=s["name"], kind=s["kind"], k=s["k"],
        failed_nodes=list(s["failedNodes"]),
        displaced=s["displaced"], replaced=s["replaced"],
        stranded=s["stranded"], preempted=s["preempted"],
        headroom=s["headroom"],
        fail_message=s.get("failMessage", ""),
        batched=s.get("batched", False),
        deduped_of=s.get("dedupedOf"),
        bounded_of=s.get("boundedOf"),
        probe_placements=(list(s["probePlacements"])
                          if s.get("probePlacements") is not None else None),
        rung=s.get("rung", ""),
        degraded=s.get("degraded", False),
        bottleneck=s.get("bottleneck"))


@dataclass
class DrainOutcome:
    displaced: int
    replaced: int
    stranded: int
    preempted: int
    final_deleted_snapshot: Optional[ClusterSnapshot]
    stranded_messages: List[str] = field(default_factory=list)


@dataclass
class SurvivabilityReport:
    probe_name: str
    num_nodes: int
    baseline_headroom: int
    scenarios: List[ScenarioResult]
    collapsed_scenarios: int    # symmetric duplicates not solved separately
    batched_scenarios: int
    sequential_scenarios: int
    # explain mode: the intact cluster's bottleneck analysis (the reference
    # every scenario row's deltaCapacity is measured against)
    baseline_bottleneck: Optional[dict] = None
    # joint packing bounds (bounds/bracket.py): the intact baseline's
    # capacity bracket plus how many scenario rows the bracket proved
    # without a device solve — {"lower", "upper", "pruned"}; None when the
    # sweep ran with bounds disabled
    bounds: Optional[dict] = None
    # device mesh the batched solves (and bracket shots) sharded over —
    # {"batch": B, "nodes": N} (parallel/mesh.mesh_shape); None when the
    # sweep ran unsharded
    mesh: Optional[dict] = None

    @property
    def min_k_to_stranded(self) -> Optional[int]:
        ks = [r.k for r in self.scenarios if r.stranded > 0]
        return min(ks) if ks else None

    @property
    def min_k_to_zero_headroom(self) -> Optional[int]:
        ks = [r.k for r in self.scenarios if r.headroom == 0]
        return min(ks) if ks else None

    def worst_nodes(self, top: int = 10) -> List[Tuple[str, int, int]]:
        """Single-node scenarios ranked worst-first: most stranded pods,
        then least remaining headroom.  (name, headroom, stranded) tuples."""
        singles = [r for r in self.scenarios if r.kind == "node" and r.k == 1]
        singles.sort(key=lambda r: (-r.stranded, r.headroom, r.name))
        return [(r.failed_nodes[0], r.headroom, r.stranded)
                for r in singles[:top]]

    def headroom_curve(self) -> List[Tuple[int, str, int]]:
        """Per-scenario (k, name, headroom), ascending in k — the
        degradation curve an operator reads min-k thresholds from."""
        return sorted((r.k, r.name, r.headroom) for r in self.scenarios)

    @property
    def degraded(self) -> bool:
        """True when any scenario was served by a lower ladder rung after a
        classified fault — the numbers are still bit-identical, but the
        operator should know the device path misbehaved."""
        return any(r.degraded for r in self.scenarios)

    @property
    def worst_rung(self) -> str:
        from ..runtime.degrade import worst_rung
        rung = worst_rung(self.scenarios)
        if not rung and any(r.rung == RUNG_BOUNDS for r in self.scenarios):
            # every row was proved by its capacity bracket — not a ladder
            # rung, but the honest answer to "what served this sweep"
            return RUNG_BOUNDS
        return rung

    def to_dict(self) -> dict:
        """Stable machine-readable schema: the same {"spec", "status"}
        envelope as utils/report.ClusterCapacityReview.to_dict."""
        return {
            "spec": {
                "probe": {"podName": self.probe_name},
                "numNodes": self.num_nodes,
                "numScenarios": len(self.scenarios),
            },
            "status": {
                "baselineHeadroom": self.baseline_headroom,
                "collapsedScenarios": self.collapsed_scenarios,
                "batchedScenarios": self.batched_scenarios,
                "sequentialScenarios": self.sequential_scenarios,
                "minKToStranded": self.min_k_to_stranded,
                "minKToZeroHeadroom": self.min_k_to_zero_headroom,
                "degraded": self.degraded,
                "worstRung": self.worst_rung,
                "baselineBottleneck": self.baseline_bottleneck,
                "bounds": self.bounds,
                "mesh": self.mesh,
                "worstNodes": [
                    {"nodeName": nm, "headroom": h, "stranded": s}
                    for nm, h, s in self.worst_nodes()],
                "headroomCurve": [
                    {"k": k, "name": nm, "headroom": h}
                    for k, nm, h in self.headroom_curve()],
                "scenarios": [_scenario_to_dict(r) for r in self.scenarios],
            },
        }

    @classmethod
    def from_dict(cls, data: dict) -> "SurvivabilityReport":
        spec, status = data["spec"], data["status"]
        return cls(
            probe_name=spec["probe"]["podName"],
            num_nodes=spec["numNodes"],
            baseline_headroom=status["baselineHeadroom"],
            scenarios=[_scenario_from_dict(s)
                       for s in status["scenarios"]],
            collapsed_scenarios=status["collapsedScenarios"],
            batched_scenarios=status["batchedScenarios"],
            sequential_scenarios=status["sequentialScenarios"],
            baseline_bottleneck=status.get("baselineBottleneck"),
            bounds=status.get("bounds"),
            mesh=status.get("mesh"),
        )


def _mask_exact(pb: enc.EncodedProblem, probe: dict) -> bool:
    """True when marking failed nodes infeasible via alive_mask is
    bit-identical to physically deleting them, for THIS probe.

    Per-node static state (fit, taints, required+preferred node affinity,
    unschedulable, node name, ports) is identical either way, and score
    normalization runs over non-negative raws that encode_problem zeroes on
    dead nodes, so the normalization window matches the survivor set.  What
    breaks exactness — and forces the sequential deleted-snapshot path:

    - topology spread: a deleted node can empty a domain; a masked one
      leaves it countable with zero capacity, shifting global min-domain /
      min-count terms
    - inter-pod affinity: domain existence and the lonely-pod escape read
      global existing-pod structure
    - ImageLocality: the spread ratio divides by the TOTAL node count
    - sampling (percentageOfNodesToScore / adaptive): reads the node count
    - nondeterministic scoring: the tie-break rotation spans the full axis
    - extenders: webhook verdicts are computed per real node list
    - shared DRA claims: charged cross-node at the first placement
    - non-batchable shapes (host-port / disk / RWOP clone self-conflicts,
      pod-level gates): the batched runner rejects them anyway
    """
    profile = pb.profile
    if not profile.deterministic:
        return False
    if profile.extenders:
        return False
    if profile.adaptive_sampling or profile.percentage_of_nodes_to_score < 100:
        return False
    if pb.spread_hard.num_constraints or pb.spread_soft.num_constraints:
        return False
    if pb.ipa.active or pb.ipa.existing_anti_static.any():
        return False
    if pb.image_locality_score.any():
        return False
    if (probe.get("spec") or {}).get("volumes"):
        return False
    if pb.shared_req_vec.any():
        return False
    if not sweep._batchable(pb):
        return False
    return True


def _delete_nodes(snapshot: ClusterSnapshot,
                  failed: Sequence[int]) -> ClusterSnapshot:
    """The ground-truth degraded snapshot: failed nodes and their resident
    pods removed, axis order of the survivors preserved."""
    dead = set(failed)
    keep = [i for i in range(snapshot.num_nodes) if i not in dead]
    return ClusterSnapshot.from_objects(
        [snapshot.nodes[i] for i in keep],
        [p for i in keep for p in snapshot.pods_by_node[i]],
        sort_nodes=False,
        **{k: getattr(snapshot, k) for k in snapshot_mod.OBJECT_FIELDS})


def _drain(snapshot: ClusterSnapshot, scenario: FailureScenario,
           profile: SchedulerProfile, device=None) -> DrainOutcome:
    """Re-schedule the failed nodes' pods onto the survivors,
    highest-priority-first, through the full framework run loop (preemption
    included) on `device` (default the card).  Returns the final
    deleted-axis snapshot with replaced pods committed and victims
    evicted."""
    from ..framework import ClusterCapacity

    displaced = [p for i in scenario.failed
                 for p in snapshot.pods_by_node[i]]
    cur = _delete_nodes(snapshot, scenario.failed)
    replaced = stranded = preempted = 0
    messages: List[str] = []
    for pod in sort_pods(displaced, snapshot.priority_classes):
        pending = copy.deepcopy(pod)
        pending.setdefault("spec", {}).pop("nodeName", None)
        cc = ClusterCapacity(pending, max_limit=1, profile=profile,
                             device=device)
        cc.set_snapshot(cur)
        result = cc.run()
        after = cc.post_run_snapshot
        preempted += (sum(len(p) for p in cur.pods_by_node)
                      - sum(len(p) for p in after.pods_by_node))
        cur = after
        if result.placed_count >= 1:
            tgt = int(result.placements[0])
            committed = copy.deepcopy(pod)
            committed.setdefault("spec", {})["nodeName"] = cur.node_names[tgt]
            pbn = [list(p) for p in cur.pods_by_node]
            pbn[tgt].append(committed)
            cur, _ = snapshot_mod.replace_rosters(cur, pbn, [tgt])
            replaced += 1
        else:
            stranded += 1
            messages.append(result.fail_message)
    return DrainOutcome(displaced=len(displaced), replaced=replaced,
                        stranded=stranded, preempted=preempted,
                        final_deleted_snapshot=cur,
                        stranded_messages=messages)


def _post_drain_full_axis(snapshot: ClusterSnapshot, scenario: FailureScenario,
                         drain: DrainOutcome) -> ClusterSnapshot:
    """Map the drain's deleted-axis end state back onto the FULL node axis
    for the masked batched solve: failed nodes keep their row with an empty
    roster (the alive_mask makes them infeasible); survivors take their
    post-drain rosters."""
    final = drain.final_deleted_snapshot
    if final is None:
        return snapshot
    pos = {nm: i for i, nm in enumerate(snapshot.node_names)}
    pbn: List[List[dict]] = [[] for _ in range(snapshot.num_nodes)]
    for j, nm in enumerate(final.node_names):
        pbn[pos[nm]] = list(final.pods_by_node[j])
    changed = [i for i in range(snapshot.num_nodes)
               if len(pbn[i]) != len(snapshot.pods_by_node[i])
               or any(a is not b
                      for a, b in zip(pbn[i], snapshot.pods_by_node[i]))]
    return snapshot_mod.replace_rosters(snapshot, pbn, changed)[0]


def analyze(snapshot: ClusterSnapshot, scenarios: Sequence[FailureScenario],
            probe: dict, profile: Optional[SchedulerProfile] = None,
            max_limit: int = 0, mesh=None, dedup: bool = True,
            keep_placements: bool = False,
            journal: Optional[str] = None,
            resume: bool = False,
            explain: bool = False,
            bounds: bool = True,
            device=None) -> SurvivabilityReport:
    """Run every failure scenario: drain + re-schedule displaced pods, then
    measure remaining probe headroom — batched as ONE device solve per
    problem-shape group when masking is exact, sequential per-scenario
    deleted-snapshot solves otherwise.  Every device solve runs under the
    hardened runtime (runtime/degrade.py): OOM splits the batch, other
    classified faults descend the ladder, and each row records the rung
    that served it.

    mesh: optional parallel/mesh.Mesh — the batched scenario solves and
    the bracket shot shard the scenario batch and node axes over it
    (sharded_batched rung); the report's status carries its shape.
    dedup=False disables symmetric-scenario collapsing (scenarios.py).
    device: the card unless the caller names the CPU; every solve, drain
    and bracket shot runs there.

    journal: path to a per-scenario result journal (utils/checkpoint.
    ScenarioJournal).  Representative scenarios append as they complete;
    with resume=True an existing journal whose fingerprint matches skips
    the already-completed scenarios, so a killed sweep continues instead of
    restarting.  A fingerprint mismatch (different probe/nodes/limit/
    scenario set) raises CheckpointCorruption.

    explain=True annotates every representative scenario with the degraded
    cluster's bottleneck analysis (explain/bottleneck.py, host-side from the
    scenario's encoded problem — no extra device work) plus the remaining-
    capacity delta vs the intact baseline; the baseline analysis rides the
    report as baseline_bottleneck.

    bounds=True (default) brackets every batched scenario's headroom first
    (bounds/bracket.py, one guarded device shot) and skips the device solve
    for any scenario the bracket already proves: a tight exact bracket
    (lower == upper) reconstructs the headroom AND the terminal fit message
    from the per-node caps, and a constructive lower bound at or above
    max_limit reconstructs the limit row.  Pruned rows stamp bounded_of and
    rung="bounds" but are otherwise row-identical to what the device solve
    would return; bounds=False (--no-bounds) forces exact solves everywhere.
    keep_placements disables pruning (placements need the real solve).
    """
    import os

    from ..parallel import mesh as mesh_lib
    from ..runtime import degrade
    from ..runtime.errors import CheckpointCorruption, RuntimeFault
    from ..utils.checkpoint import ScenarioJournal, scenario_fingerprint

    profile = profile or SchedulerProfile()
    scenarios = list(scenarios)
    n = snapshot.num_nodes
    device = sim.resolve_device(device)

    base_pb = enc.encode_problem(snapshot, probe, profile)
    baseline = degrade.solve_one_guarded(base_pb, max_limit=max_limit,
                                         bounds=bounds, device=device)

    base_bn = None
    if explain:
        from ..explain.bottleneck import bottleneck_analysis
        base_bn = bottleneck_analysis(base_pb)

    def _scenario_bottleneck(pb: Optional[enc.EncodedProblem]):
        """Host-side bottleneck for one scenario's encoded problem, plus the
        capacity delta vs the intact baseline."""
        if not explain or pb is None:
            return None
        from ..explain.bottleneck import bottleneck_analysis
        bn = bottleneck_analysis(pb)
        if bn is None:
            return None
        if base_bn is not None:
            bn = dict(bn)
            bn["deltaCapacity"] = (bn["totalCapacity"]
                                   - base_bn["totalCapacity"])
        return bn

    dup_of = dedup_single_node(base_pb, scenarios) if dedup else {}
    rep_set = [si for si in range(len(scenarios)) if si not in dup_of]
    exact = _mask_exact(base_pb, probe)

    # --- journal / resume --------------------------------------------------
    jr: Optional[ScenarioJournal] = None
    loaded: Dict[int, ScenarioResult] = {}
    if journal:
        fingerprint = scenario_fingerprint(
            probe=probe, num_nodes=n, max_limit=max_limit,
            scenario_names=[sc.name for sc in scenarios],
            baseline_headroom=baseline.placed_count,
            profile=profile, snapshot=snapshot)
        jr = ScenarioJournal(journal)
        if resume and os.path.exists(journal):
            old_fp, done = jr.read()
            if old_fp != fingerprint:
                raise CheckpointCorruption(
                    f"journal {journal} belongs to a different sweep "
                    f"(fingerprint mismatch); delete it or drop --resume",
                    detail={"path": journal, "expected": fingerprint,
                            "found": old_fp})
            name_to_si = {scenarios[si].name: si for si in rep_set}
            for name, payload in done.items():
                si = name_to_si.get(name)
                if si is not None:
                    loaded[si] = _scenario_from_dict(payload)
            jr.reopen()
        else:
            jr.start(fingerprint)

    def _journal(result: ScenarioResult) -> None:
        if jr is not None:
            jr.append(result.name, _scenario_to_dict(result))

    results: List[Optional[ScenarioResult]] = [None] * len(scenarios)
    for si, row in loaded.items():
        results[si] = row
    todo = [si for si in rep_set if si not in loaded]

    # Sweep progress gauges: total/representative/completed scenario counts
    # (completed starts at the journal-resumed count and ticks per row, so a
    # watcher can read sweep progress off --metrics-dump mid-run).
    from .. import obs
    from ..obs import names as obs_names
    from ..utils.metrics import default_registry as _registry
    _registry.set_gauge(obs_names.SCENARIOS, len(scenarios), state="total")
    _registry.set_gauge(obs_names.SCENARIOS, len(rep_set),
                        state="representative")
    done_count = [len(loaded)]
    _registry.set_gauge(obs_names.SCENARIOS, done_count[0],
                        state="completed")

    def _complete(si: int, r: sim.SolveResult, *, was_batched: bool,
                  node_names: List[str],
                  pb: Optional[enc.EncodedProblem] = None) -> None:
        """Assemble a scenario's row and journal it IMMEDIATELY — a sweep
        killed after this point resumes past the scenario."""
        sc, d = scenarios[si], drains[si]
        row = ScenarioResult(
            name=sc.name, kind=sc.kind, k=sc.k,
            failed_nodes=[snapshot.node_names[i] for i in sc.failed],
            displaced=d.displaced, replaced=d.replaced,
            stranded=d.stranded, preempted=d.preempted,
            headroom=r.placed_count, fail_message=r.fail_message,
            batched=was_batched,
            probe_placements=([node_names[int(i)] for i in r.placements]
                              if keep_placements else None),
            rung=getattr(r, "rung", ""),
            degraded=getattr(r, "degraded", False),
            bottleneck=_scenario_bottleneck(pb))
        results[si] = row
        _journal(row)
        done_count[0] += 1
        _registry.set_gauge(obs_names.SCENARIOS, done_count[0],
                            state="completed")

    def _complete_bounded(si: int, headroom: int, msg: str, bounded_of: str,
                          *, deg: bool,
                          pb: Optional[enc.EncodedProblem]) -> None:
        """A row PROVED by the bracket — no device solve ran.  Same journal
        + gauge discipline as _complete, stamped rung="bounds"."""
        sc, d = scenarios[si], drains[si]
        row = ScenarioResult(
            name=sc.name, kind=sc.kind, k=sc.k,
            failed_nodes=[snapshot.node_names[i] for i in sc.failed],
            displaced=d.displaced, replaced=d.replaced,
            stranded=d.stranded, preempted=d.preempted,
            headroom=headroom, fail_message=msg,
            batched=True, bounded_of=bounded_of,
            rung=RUNG_BOUNDS, degraded=deg,
            bottleneck=_scenario_bottleneck(pb))
        results[si] = row
        _journal(row)
        done_count[0] += 1
        _registry.set_gauge(obs_names.SCENARIOS, done_count[0],
                            state="completed")

    try:
        # --- drain phase (host, sequential — scenarios that lose pods) ----
        drains: Dict[int, DrainOutcome] = {}
        for si in todo:
            sc = scenarios[si]
            if any(snapshot.pods_by_node[i] for i in sc.failed):
                drains[si] = _drain(snapshot, sc, profile, device)
            else:
                drains[si] = DrainOutcome(0, 0, 0, 0, None)

        # --- headroom phase ------------------------------------------------
        batch_pbs: List[enc.EncodedProblem] = []
        batch_sis: List[int] = []
        seq_sis: List[int] = []
        seq_degraded: set = set()
        for si in todo:
            if exact:
                snap_s = _post_drain_full_axis(snapshot, scenarios[si],
                                               drains[si])
                batch_pbs.append(enc.encode_problem(
                    snap_s, probe, profile,
                    alive_mask=scenarios[si].alive_mask(n)))
                batch_sis.append(si)
            else:
                seq_sis.append(si)

        if batch_pbs and bounds and not keep_placements:
            # --- bound-guided pruning: bracket EVERY batched scenario in
            # one guarded device shot, then drop the ones the bracket
            # already proves.  Only exact brackets prune (fit-only +
            # order-independent terminal — which _mask_exact scenarios are
            # whenever the probe has no dynamic gates), and a tight-bracket
            # row additionally requires the host terminal diagnosis so its
            # fail message is the one the scan would have produced.
            from .. import bounds as bounds_mod
            brackets, br_deg = bounds_mod.bracket_group(batch_pbs, mesh=mesh,
                                                        device=device)
            kept_pbs: List[enc.EncodedProblem] = []
            kept_sis: List[int] = []
            for pb_s, br, si in zip(batch_pbs, brackets, batch_sis):
                pruned = False
                if br.exact and max_limit > 0 and br.lower >= max_limit:
                    _complete_bounded(
                        si, max_limit,
                        f"Maximum number of pods simulated: {max_limit}",
                        "lower>=limit", deg=br_deg, pb=pb_s)
                    pruned = True
                elif (br.tight and br.upper < bounds_mod.UNBOUNDED):
                    counts = bounds_mod.exhausted_fit_counts(pb_s)
                    if counts is not None:
                        _complete_bounded(
                            si, br.lower,
                            sim.format_fit_error(pb_s.snapshot.num_nodes,
                                                 counts),
                            "lower==upper", deg=br_deg, pb=pb_s)
                        pruned = True
                if not pruned:
                    kept_pbs.append(pb_s)
                    kept_sis.append(si)
            batch_pbs, batch_sis = kept_pbs, kept_sis

        if batch_pbs:
            # one batched device solve per problem-shape group (normally one
            # group: same probe, same profile, same snapshot geometry)
            groups: Dict[tuple, List[int]] = {}
            for bi, pb in enumerate(batch_pbs):
                key = sweep._group_key(pb, sim.static_config(pb))
                groups.setdefault(key, []).append(bi)
            for idxs in groups.values():
                try:
                    res = degrade.solve_group_guarded(
                        [batch_pbs[bi] for bi in idxs],
                        max_limit=max_limit, mesh=mesh, bounds=bounds,
                        device=device)
                except RuntimeFault:
                    # masked problems cannot reach the oracle rung (the mask
                    # is folded into the encoding) — the analyzer's own last
                    # rung is the sequential deleted-snapshot path, where
                    # the failure set is expressed by deletion again
                    for bi in idxs:
                        seq_sis.append(batch_sis[bi])
                        seq_degraded.add(batch_sis[bi])
                    continue
                for bi, r in zip(idxs, res):
                    _complete(batch_sis[bi], r, was_batched=True,
                              node_names=snapshot.node_names,
                              pb=batch_pbs[bi])

        for si in seq_sis:
            sc = scenarios[si]
            with obs.span("resilience.scenario", scenario=sc.name):
                snap_del = drains[si].final_deleted_snapshot
                if snap_del is None:
                    snap_del = _delete_nodes(snapshot, sc.failed)
                pb_s = enc.encode_problem(snap_del, probe, profile)
                r = degrade.solve_one_guarded(
                    pb_s, max_limit=max_limit, degraded=si in seq_degraded,
                    bounds=bounds, device=device)
            _complete(si, r, was_batched=False,
                      node_names=snap_del.node_names, pb=pb_s)
    finally:
        # an interrupted sweep must still leave a well-formed journal —
        # everything completed so far has already been appended and fsynced
        if jr is not None:
            jr.close()
    for si, rep in dup_of.items():
        sc, rr = scenarios[si], results[rep]
        # metrics are permutation-invariant between indistinguishable twins;
        # placements are not (the argmax tie-break rotates) — drop them
        results[si] = dataclasses.replace(
            rr, name=sc.name,
            failed_nodes=[snapshot.node_names[i] for i in sc.failed],
            deduped_of=rr.name, probe_placements=None)

    rows = [r for r in results if r is not None]
    # counts are derived from the rows (not running tallies) so a resumed
    # sweep reports exactly what an uninterrupted one would
    reps = [r for r in rows if r.deduped_of is None]
    report_bounds = None
    if bounds:
        from .. import bounds as bounds_mod
        bb = bounds_mod.bracket_host(base_pb)
        report_bounds = {
            "lower": bb.lower, "upper": bb.upper,
            "pruned": sum(1 for r in reps if r.bounded_of is not None)}
    return SurvivabilityReport(
        probe_name=(probe.get("metadata") or {}).get("name", ""),
        num_nodes=n,
        baseline_headroom=baseline.placed_count,
        scenarios=rows,
        collapsed_scenarios=len(rows) - len(reps),
        batched_scenarios=sum(1 for r in reps if r.batched),
        sequential_scenarios=sum(1 for r in reps if not r.batched),
        baseline_bottleneck=base_bn,
        bounds=report_bounds,
        mesh=mesh_lib.mesh_shape(mesh),
    )

"""DefaultPreemption (PostFilter): dry-run victim selection + node choice.

Reference semantics (vendor/k8s.io/kubernetes/pkg/scheduler/):
- framework/plugins/defaultpreemption/default_preemption.go:132 — PostFilter
  delegates to the preemption evaluator.
- framework/preemption/preemption.go:234 (Evaluate), :741 (DryRunPreemption),
  :624 (pickOneNodeForPreemption).  Victim selection per node: remove every
  lower-priority pod, verify the incoming pod fits, then reprieve victims
  (highest priority first, PDB-violating pods last) while the pod still fits.
  Node choice criteria, in order: fewest PDB violations → lowest
  highest-victim priority → smallest priority sum → fewest victims → latest
  highest-priority-victim start time → first in node order.
- Preemption messages in the pod condition: "preemption: 0/N nodes are
  available: X Preemption is not helpful for scheduling, Y No preemption
  victims found for incoming pod."

Here preemption runs host-side between solve rounds on the card: it is the
rare path (only pods with priority above some existing pod reach it),
operates on object state, and each successful preemption re-encodes the
snapshot and resumes the solve (framework.py run loop).  This is the JAX
package's module, with the extenders' ProcessPreemption chain
(engine/extenders.run_preemption_chain) consulted before pickOneNode.

The node filter has two paths, held equal in node, victims and their
order, and message counts by tests/test_torch_preemption_table.py:
- the victim table (engine/preemption_table.py), which the framework loop
  keeps for one answer: int64 tensor ops over every node at once, where
  the input makes NodeResourcesFit the only roster-dependent filter (no
  extenders, PDBs, incoming host ports, DoNotSchedule spreads or required
  pod (anti-)affinity, no resident with required anti-affinity);
- the oracle's filter chain (engine/oracle.py) on every node, whose
  per-roster-version caches keep one evaluate O(N) at 10,000 nodes: every
  other input, and every caller without a table
  (oracle.simulate_with_preemption, parallel/sweep.py), so it stays the
  independent reference.
`evaluate` runs its two halves in the spans `preemption.filter` (every
node's dry run; attrs `engine`, `rows_rebuilt` and, on the oracle's path,
`fallback`) and `preemption.pick` (the extenders and the tournament).
`no_candidate_possible` is the cluster-wide test the framework loop runs
first: where it holds, the dry run can only fail, and the loop skips it
unless the message's per-node counts or the extenders' Filter calls are
wanted.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from . import oracle
from ..models.labels import match_label_selector
from ..models.snapshot import ClusterSnapshot
from ..obs import spans as obs_spans
from ..ops.priority_sort import resolve_priority
from ..utils.config import SchedulerProfile

MSG_NOT_HELPFUL = "Preemption is not helpful for scheduling"
MSG_NO_VICTIMS = "No preemption victims found for incoming pod"

# Failure reasons that preemption cannot resolve (the plugin returned
# UnschedulableAndUnresolvable — removing pods can't change them).
_UNRESOLVABLE_REASONS = (
    "node(s) were unschedulable",
    "node(s) didn't match the requested node name",
    "node(s) had untolerated taint",
    "node(s) didn't match Pod's node affinity/selector",
    "node(s) didn't match pod topology spread constraints (missing required label)",
    "node(s) didn't match pod affinity rules",
    "node(s) had volume node affinity conflict",
    "node(s) didn't find available persistent volumes to bind",
    "node(s) had no available volume zone",
)


def pod_key(pod: Mapping):
    """Identity key for victim matching; None when the pod has neither a
    name nor a uid — a metadata-less key would match every other
    metadata-less pod and evict them all, so such pods only ever match by
    object identity (id()).  Shared by the framework loop and the oracle's
    sequential equivalent: extender ProcessPreemption responses round-trip
    victims through JSON, so id() alone would evict nothing and spin."""
    meta = pod.get("metadata") or {}
    name = meta.get("name", "")
    uid = meta.get("uid", "")
    if not name and not uid:
        return None
    return (meta.get("namespace") or "default", name, uid)


def victim_matcher(victims: Sequence[Mapping]):
    """Predicate `is_victim(pod) -> bool` matching by object identity OR
    (namespace, name, uid) key.  Extender ProcessPreemption responses
    round-trip victims through JSON, so id() alone would evict nothing and
    the preemption loop would spin forever; metadata-less pods only ever
    match by identity (see pod_key).  Shared by the framework loop and the
    oracle's sequential equivalent so the differential pair cannot drift."""
    ids = {id(v) for v in victims}
    keys = {k for v in victims if (k := pod_key(v)) is not None}

    def is_victim(pod: Mapping) -> bool:
        return id(pod) in ids or pod_key(pod) in keys
    return is_victim


@dataclass
class PreemptionOutcome:
    node_index: Optional[int]          # chosen node, None when preemption failed
    victims: List[dict]                # pods to delete (on the chosen node)
    # per-node postfilter message histogram for the failure message
    message_counts: Dict[str, int]

    @property
    def succeeded(self) -> bool:
        return self.node_index is not None


def _is_unresolvable(reason: Optional[str]) -> bool:
    if reason is None:
        return False
    return any(reason.startswith(r) for r in _UNRESOLVABLE_REASONS)


def _pdb_disruptions_allowed(snapshot: ClusterSnapshot) -> List[Tuple[dict, int]]:
    out = []
    for pdb in snapshot.pdbs:
        allowed = ((pdb.get("status") or {}).get("disruptionsAllowed"))
        out.append((pdb, int(allowed) if allowed is not None else 0))
    return out


def _split_pdb_violations(pods: List[dict], pdbs: List[Tuple[dict, int]]
                          ) -> Tuple[List[dict], List[dict]]:
    """filterPodsWithPDBViolation: walk the pod set consuming each PDB's
    shared disruption budget; a pod is 'violating' when a matching PDB's
    budget is already exhausted at its turn.  Returns (violating, ok)."""
    remaining = {id(p): allowed for p, allowed in pdbs}
    violating, ok = [], []
    for v in pods:
        v_ns = (v.get("metadata") or {}).get("namespace") or "default"
        v_labels = (v.get("metadata") or {}).get("labels") or {}
        violates = False
        matched = []
        for pdb, _allowed in pdbs:
            if ((pdb.get("metadata") or {}).get("namespace") or "default") != v_ns:
                continue
            selector = (pdb.get("spec") or {}).get("selector")
            if not match_label_selector(selector, v_labels):
                continue
            matched.append(pdb)
            if remaining[id(pdb)] <= 0:
                violates = True
        for pdb in matched:
            remaining[id(pdb)] -= 1
        (violating if violates else ok).append(v)
    return violating, ok


def _pdb_violations(victims: List[dict], pdbs: List[Tuple[dict, int]]) -> int:
    return len(_split_pdb_violations(victims, pdbs)[0])


# Clockless analog of GetPodStartTime's time.Now() fallback (util/utils.go:
# 49-55): a pod that never started counts as starting "now", which is LATER
# than any recorded startTime.  ISO-8601 strings order lexicographically, so
# a max sentinel reproduces that ordering without a clock.
_START_TIME_NOW = "9999-12-31T23:59:59Z"


def _pod_start_time(pod: Mapping) -> str:
    return ((pod.get("status") or {}).get("startTime")) or _START_TIME_NOW


def no_candidate_possible(snapshot: ClusterSnapshot, pod: Mapping) -> bool:
    """True when `evaluate` cannot name a candidate on any node for `pod`,
    over the snapshot's roster plus any clones of the pod: its
    preemptionPolicy is Never, or no pod in the roster ranks strictly below
    it (a clone has the pod's priority, and a node without a lower-priority
    pod holds no victim).  The scan stops at the first lower-priority pod."""
    if ((pod.get("spec") or {}).get("preemptionPolicy")) == "Never":
        return True
    pcs = snapshot.priority_classes
    incoming_priority = resolve_priority(pod, pcs)
    return not any(resolve_priority(p, pcs) < incoming_priority
                   for plist in snapshot.pods_by_node for p in plist)


def evaluate(snapshot: ClusterSnapshot, state_pods: List[List[dict]],
             pod: Mapping, profile: SchedulerProfile,
             node_ok=None, extenders=None, table=None) -> PreemptionOutcome:
    """Run the preemption dry-run over every candidate node.

    `state_pods` is the CURRENT per-node pod roster (snapshot pods + clones
    placed so far); victims are only selected among pods with lower priority
    than the incoming pod.  `node_ok(node_name) -> bool` lets the caller veto
    candidates the in-tree filters can't see (extender-filtered nodes).
    `extenders` that support preemption are consulted with the candidate
    victim map before pickOneNode (Evaluator.callExtenders,
    preemption.go:341-402 + extender.go:343-373).  `table`
    (preemption_table.VictimTable, the answer's own) finds the victims
    where preemption_table.fallback_reason and the table's rows allow it;
    otherwise, and without a table, the oracle's filter chain does."""
    incoming_priority = resolve_priority(pod, snapshot.priority_classes)
    if ((pod.get("spec") or {}).get("preemptionPolicy")) == "Never":
        return PreemptionOutcome(None, [], {
            MSG_NOT_HELPFUL: snapshot.num_nodes})

    with obs_spans.span("preemption.filter") as sp:
        pdbs = _pdb_disruptions_allowed(snapshot)
        fallback = "no_table"
        if table is not None:
            from .preemption_table import fallback_reason
            fallback = fallback_reason(
                snapshot, pod, profile,
                extended=bool(extenders) or node_ok is not None)
        if fallback is None:
            rows = table.refresh(snapshot, state_pods)
            if table.resident_anti_affinity:
                fallback = "resident_anti_affinity"
        if fallback is None:
            candidates, message_counts = table.dry_run()
            sp.attrs.update(engine="table", rows_rebuilt=rows)
        else:
            candidates, message_counts = _filter_candidates(
                snapshot, state_pods, pod, profile, node_ok,
                incoming_priority, pdbs)
            # the oracle's state reads every roster anew
            sp.attrs.update(engine="oracle", fallback=fallback,
                            rows_rebuilt=snapshot.num_nodes)
        sp.attrs.update(nodes=snapshot.num_nodes,
                        no_victims=message_counts.get(MSG_NO_VICTIMS, 0),
                        candidates=len(candidates))
    with obs_spans.span("preemption.pick"):
        return _pick(snapshot, pod, candidates, message_counts, extenders,
                     pdbs)


def _filter_candidates(snapshot: ClusterSnapshot,
                       state_pods: List[List[dict]], pod: Mapping,
                       profile: SchedulerProfile, node_ok,
                       incoming_priority: int,
                       pdbs: List[Tuple[dict, int]]):
    """The dry run on every node over the current roster: (candidates as
    (node_idx, victims, pdb_violations) in node order, message counts of
    the nodes that are none)."""
    state = oracle.OracleState(snapshot)
    state.pods_by_node = [list(p) for p in state_pods]

    candidates = []                     # (node_idx, victims, pdb_violations)
    message_counts: Dict[str, int] = {}

    def add_msg(m: str):
        message_counts[m] = message_counts.get(m, 0) + 1

    for i in range(snapshot.num_nodes):
        reason = oracle._filter_node(state, i, pod, profile)
        if reason is None:
            # feasible without preemption — callers only invoke this after an
            # infeasible cycle, but guard anyway
            continue
        if _is_unresolvable(reason):
            add_msg(MSG_NOT_HELPFUL)
            continue
        if node_ok is not None and not node_ok(snapshot.node_names[i]):
            add_msg(MSG_NOT_HELPFUL)
            continue

        lower = [p for p in state.pods_by_node[i]
                 if resolve_priority(p, snapshot.priority_classes)
                 < incoming_priority]
        if not lower:
            add_msg(MSG_NO_VICTIMS)
            continue

        # Dry run: remove all lower-priority pods, check fit.
        saved = state.pods_by_node[i]
        state.set_pods(i, [p for p in saved if p not in lower])
        if oracle._filter_node(state, i, pod, profile) is not None:
            state.set_pods(i, saved)
            add_msg(MSG_NOT_HELPFUL)
            continue

        # Reprieve: try to add victims back while the pod still fits —
        # PDB-violating pods get reprieve attempts FIRST, then the rest in
        # priority order (preemption.go selectVictimsOnNode).
        def sort_key(p):
            return (-resolve_priority(p, snapshot.priority_classes),
                    _pod_start_time(p))
        violating, ok_pods = _split_pdb_violations(lower, pdbs)
        victims: List[dict] = []
        for p in sorted(violating, key=sort_key) + sorted(ok_pods, key=sort_key):
            state.set_pods(i, state.pods_by_node[i] + [p])
            if oracle._filter_node(state, i, pod, profile) is not None:
                # cannot reprieve: p stays a victim
                state.set_pods(i, state.pods_by_node[i][:-1])
                victims.append(p)
        state.set_pods(i, saved)
        candidates.append((i, victims, _pdb_violations(victims, pdbs)))
    return candidates, message_counts


def _pick(snapshot: ClusterSnapshot, pod: Mapping, candidates: list,
          message_counts: Dict[str, int], extenders,
          pdbs: List[Tuple[dict, int]]) -> PreemptionOutcome:
    """The preemption-capable extenders' say on the candidates, then the
    candidate tournament."""
    if candidates and extenders:
        from .extenders import run_preemption_chain
        name_to_idx = {n: i for i, n in enumerate(snapshot.node_names)}
        victim_map = {snapshot.node_names[i]: v for i, v, _ in candidates}
        kept = run_preemption_chain(extenders, dict(pod), victim_map)
        candidates = [
            (name_to_idx[n], v, _pdb_violations(v, pdbs))
            for n, v in kept.items()]
        candidates.sort(key=lambda c: c[0])     # restore node order
    if not candidates:
        return PreemptionOutcome(None, [], message_counts)

    # pickOneNodeForPreemption (preemption.go:624): explicit tournament.
    # Criterion 5 compares each node's EARLIEST start among its
    # highest-priority victims (GetEarliestPodStartTime, util/utils.go:59-81)
    # and prefers the node where that earliest start is LATEST; ISO-8601
    # strings order lexicographically, so string comparison suffices.
    def stats(c):
        i, victims, pdb_viol = c
        priorities = sorted((resolve_priority(p, snapshot.priority_classes)
                             for p in victims), reverse=True)
        highest = priorities[0] if priorities else -(2 ** 31)
        # criterion 3 sums priorities OFFSET by MaxInt32+1 (preemption.go
        # minSumPrioritiesScoreFunc): the offset folds the victim count in,
        # so a node with few very-negative-priority victims does not beat a
        # node with fewer victims of the same priority.
        sum_offset = sum(p + 2 ** 31 for p in priorities)
        earliest_start = min((_pod_start_time(p) for p in victims
                              if resolve_priority(p, snapshot.priority_classes)
                              == highest), default="")
        return (pdb_viol, highest, sum_offset, len(victims),
                earliest_start, i)

    def better(a, b) -> bool:
        """True when candidate-stats a beats b."""
        for field_idx in (0, 1, 2, 3):          # all: smaller wins
            if a[field_idx] != b[field_idx]:
                return a[field_idx] < b[field_idx]
        if a[4] != b[4]:                        # latest start time wins
            return a[4] > b[4]
        return a[5] < b[5]                      # first in node order

    best = candidates[0]
    best_stats = stats(best)
    for c in candidates[1:]:
        c_stats = stats(c)
        if better(c_stats, best_stats):
            best, best_stats = c, c_stats
    return PreemptionOutcome(best[0], best[1], message_counts)


def format_preemption_message(num_nodes: int,
                              counts: Dict[str, int]) -> str:
    """'preemption: 0/N nodes are available: <sorted counts>.'"""
    reasons = sorted(f"{v} {k}" for k, v in counts.items())
    msg = f"preemption: 0/{num_nodes} nodes are available"
    if reasons:
        msg += ": " + ", ".join(reasons) + "."
    return msg

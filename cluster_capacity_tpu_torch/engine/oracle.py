"""Sequential CPU oracle: an independent re-implementation of the scheduling
semantics in plain Python integer arithmetic — the bottom rung of the
degradation ladder (runtime/degrade.py) and the engine DefaultPreemption's
dry run is built on (engine/preemption.py).

This deliberately mirrors the *reference's* structure — per-pod cycle, per-node
plugin loops, int64 score math (vendor/.../schedule_one.go:430-478 +
runtime/framework.go:1137-1240) — rather than the tensorized engine's, so bugs
in the encoding/kernel path don't cancel out.  Shares only the low-level
string matchers (models/labels.py).  It is the JAX package's oracle, held
equal to it by tests/test_torch_oracle.py.

Host Python, with caches the JAX oracle has not: the cluster-wide counts
the PodTopologySpread and InterPodAffinity filters read (a pass over every
node and pod) are kept as per-node contributions and their sum
(OracleState.node_sum), and a roster change redoes only the changed node's
contribution.  They compute the same values; they turn the filter chain
over N nodes from O(N^2) into O(N), and a preemption dry run's change of
one node's roster into O(pods on it), which is what lets preemption and
the oracle rung run at 10,000 nodes.  Rosters change only through
`pods_by_node = ...`, `set_pods` and `add_pod`.

Not a performance path otherwise: O(pods x nodes x plugins) pure Python.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Tuple

from ..models import labels as lbl
from ..models import podspec as ps
from ..models.snapshot import OBJECT_FIELDS, ClusterSnapshot
from ..utils.config import SchedulerProfile

DNS = ("NoSchedule", "NoExecute")


class _NodeSum:
    """One cached sum over nodes (see OracleState.node_sum)."""

    def __init__(self, anchor, epoch, pos, parts, total):
        self.anchor = anchor
        self.epoch, self.pos, self.parts, self.total = epoch, pos, parts, total
        self.derived = None
        self.fresh = False


class OracleState:
    """Mutable cluster state during a sequential simulation."""

    def __init__(self, snapshot: ClusterSnapshot):
        self.snapshot = snapshot
        self._epoch = 0              # bumped when every roster is replaced
        self._log: List[int] = []    # nodes changed since, in order
        self._sums: Dict = {}
        self._pod_memo: Dict[int, tuple] = {}
        self._alloc_memo: Dict[int, Dict[str, int]] = {}
        self.pods_by_node = [list(p) for p in snapshot.pods_by_node]

    @property
    def pods_by_node(self) -> List[List[dict]]:
        return self._pods

    @pods_by_node.setter
    def pods_by_node(self, pods: List[List[dict]]) -> None:
        self._pods = pods
        self._epoch += 1
        self._log = []

    def set_pods(self, i: int, pods: List[dict]) -> None:
        """Replace node i's roster."""
        self._pods[i] = pods
        self._log.append(i)

    def add_pod(self, i: int, pod: dict) -> None:
        """Append a pod to node i's roster."""
        self._pods[i].append(pod)
        self._log.append(i)

    def node_sum(self, pod: dict, key, contrib, derive):
        """(total, derive(total)) of the sum over nodes j of contrib(j), a
        {key: count} dict, for the incoming `pod`, kept current across
        roster changes: only the nodes changed since the last call are
        redone.  Keys whose count falls to 0 stay in the total.  `key`
        names the sum for this pod (held by identity)."""
        key = (id(pod), key)
        ent = self._sums.get(key)
        if ent is None or ent.anchor is not pod or ent.epoch != self._epoch:
            parts = [contrib(j) for j in range(self.snapshot.num_nodes)]
            total: Dict = {}
            for d in parts:
                for k, v in d.items():
                    total[k] = total.get(k, 0) + v
            ent = _NodeSum(pod, self._epoch, len(self._log), parts, total)
            self._sums[key] = ent
        elif ent.pos < len(self._log):
            total = ent.total
            for i in set(self._log[ent.pos:]):
                new = contrib(i)
                for k, v in ent.parts[i].items():
                    total[k] -= v
                for k, v in new.items():
                    total[k] = total.get(k, 0) + v
                ent.parts[i] = new
            ent.pos = len(self._log)
            ent.fresh = False
        if not ent.fresh:
            ent.derived = derive(ent.total)
            ent.fresh = True
        return ent.total, ent.derived

    def _pod_info(self, pod: dict) -> tuple:
        """(requests, nonzero cpu/mem) of one pod object, parsed once (the
        memo holds the pod, so its id is never reused while cached)."""
        hit = self._pod_memo.get(id(pod))
        if hit is None or hit[0] is not pod:
            hit = (pod, ps.pod_requests(pod), ps.pod_nonzero_cpu_mem(pod))
            self._pod_memo[id(pod)] = hit
        return hit

    def requested(self, i: int) -> Dict[str, int]:
        agg: Dict[str, int] = {}
        for pod in self.pods_by_node[i]:
            for k, v in self._pod_info(pod)[1].items():
                agg[k] = agg.get(k, 0) + v
        return agg

    def nonzero_requested(self, i: int) -> Tuple[int, int]:
        cpu = mem = 0
        for pod in self.pods_by_node[i]:
            c, m = self._pod_info(pod)[2]
            cpu += c
            mem += m
        return cpu, mem

    def allocatable(self, i: int) -> Dict[str, int]:
        out = self._alloc_memo.get(i)
        if out is not None:
            return out
        out = {}
        alloc = ((self.snapshot.nodes[i].get("status") or {})
                 .get("allocatable")) or {}
        from ..utils.quantity import int_value, milli_value
        for name, q in alloc.items():
            out[name] = milli_value(q) if name == "cpu" else int_value(q)
        self._alloc_memo[i] = out
        return out


def _filter_node(state: OracleState, i: int, pod: dict,
                 profile: SchedulerProfile) -> Optional[str]:
    """Run the filter chain in default plugin order; return the fail reason
    (first failing plugin) or None."""
    snap = state.snapshot
    spec = pod.get("spec") or {}
    tols = ps.pod_tolerations(pod)

    if profile.filter_enabled("NodeUnschedulable") and snap.node_unschedulable(i):
        unsched_taint = {"key": "node.kubernetes.io/unschedulable",
                         "effect": "NoSchedule"}
        if not any(lbl.toleration_tolerates_taint(t, unsched_taint)
                   for t in tols):
            return "node(s) were unschedulable"

    if profile.filter_enabled("NodeName"):
        want = spec.get("nodeName") or ""
        if want and snap.node_names[i] != want:
            return "node(s) didn't match the requested node name"

    if profile.filter_enabled("TaintToleration"):
        taint = lbl.find_matching_untolerated_taint(snap.node_taints(i), tols, DNS)
        if taint is not None:
            return (f"node(s) had untolerated taint "
                    f"{{{taint.get('key', '')}: {taint.get('value', '')}}}")

    if profile.filter_enabled("NodeAffinity"):
        if not lbl.pod_matches_node_selector_and_affinity(
                spec, snap.node_labels(i), snap.node_names[i]):
            return "node(s) didn't match Pod's node affinity/selector"

    if profile.filter_enabled("NodePorts"):
        want = ps.pod_host_ports(pod)
        used = []
        for p in state.pods_by_node[i]:
            used.extend(ps.pod_host_ports(p))
        for (wp, wip, wport) in want:
            for (up, uip, uport) in used:
                if wport == uport and wp == up and \
                        (wip == "0.0.0.0" or uip == "0.0.0.0" or wip == uip):
                    return ("node(s) didn't have free ports for the "
                            "requested pod ports")

    if profile.filter_enabled("NodeResourcesFit"):
        reasons = _fit_reasons(state, i, pod)
        if reasons:
            return reasons[0]

    if profile.filter_enabled("PodTopologySpread"):
        r = _spread_filter(state, i, pod)
        if r:
            return r

    if profile.filter_enabled("InterPodAffinity"):
        r = _ipa_filter(state, i, pod)
        if r:
            return r
    return None


def _fit_reasons(state: OracleState, i: int, pod: dict) -> List[str]:
    alloc = state.allocatable(i)
    req = state.requested(i)
    podreq = ps.pod_requests(pod)
    out = []
    if len(state.pods_by_node[i]) + 1 > alloc.get("pods", 0):
        out.append("Too many pods")
    for name, want in podreq.items():
        if want <= 0:
            continue
        if want > alloc.get(name, 0) - req.get(name, 0):
            out.append(f"Insufficient {name}")
    return out


# --- PodTopologySpread ------------------------------------------------------

def _spread_constraints(pod: dict, action: str) -> List[dict]:
    return [c for c in (pod.get("spec") or {}).get("topologySpreadConstraints")
            or [] if (c.get("whenUnsatisfiable") or "DoNotSchedule") == action]


def _spread_countable(state: OracleState, i: int, pod: dict,
                      constraints: List[dict], c: dict) -> bool:
    snap = state.snapshot
    labels = snap.node_labels(i)
    if not all((cc.get("topologyKey") or "") in labels for cc in constraints):
        return False
    if (c.get("nodeAffinityPolicy") or "Honor") == "Honor":
        if not lbl.pod_matches_node_selector_and_affinity(
                pod.get("spec") or {}, labels, snap.node_names[i]):
            return False
    if (c.get("nodeTaintsPolicy") or "Ignore") == "Honor":
        if lbl.find_matching_untolerated_taint(
                snap.node_taints(i), ps.pod_tolerations(pod), DNS) is not None:
            return False
    return True


def _count_match(pods: List[dict], selector, namespace: str) -> int:
    n = 0
    for p in pods:
        meta = p.get("metadata") or {}
        if (meta.get("namespace") or "default") != namespace:
            continue
        if meta.get("deletionTimestamp"):
            continue
        if lbl.match_label_selector(selector, meta.get("labels") or {}):
            n += 1
    return n


def _spread_filter(state: OracleState, i: int, pod: dict) -> Optional[str]:
    constraints = _spread_constraints(pod, "DoNotSchedule")
    if not constraints:
        return None
    snap = state.snapshot
    ns = (pod.get("metadata") or {}).get("namespace") or "default"
    pod_labels = (pod.get("metadata") or {}).get("labels") or {}
    node_labels = snap.node_labels(i)

    for ci, c in enumerate(constraints):
        key = c.get("topologyKey") or ""
        if key not in node_labels:
            return ("node(s) didn't match pod topology spread constraints "
                    "(missing required label)")

        def contrib(j, c=c, key=key):
            if not _spread_countable(state, j, pod, constraints, c):
                return {}
            return {snap.node_labels(j).get(key): _count_match(
                state.pods_by_node[j], c.get("labelSelector"), ns)}

        def derive(counts, c=c):
            min_domains = int(c.get("minDomains") or 1)
            if not counts:
                min_match = 2**31 - 1
            else:
                min_match = min(counts.values())
            if len(counts) < min_domains:
                min_match = 0
            return min_match
        counts, min_match = state.node_sum(pod, ("spread", ci), contrib,
                                           derive)
        self_match = 1 if lbl.match_label_selector(c.get("labelSelector"),
                                                   pod_labels) else 0
        match_num = counts.get(node_labels[key], 0)
        if match_num + self_match - min_match > int(c.get("maxSkew", 1)):
            return "node(s) didn't match pod topology spread constraints"
    return None


# --- InterPodAffinity -------------------------------------------------------

def _ns_labels(state: OracleState) -> Dict[str, Mapping[str, str]]:
    out = {}
    for nso in state.snapshot.namespaces:
        meta = nso.get("metadata") or {}
        out[meta.get("name", "")] = meta.get("labels") or {}
    return out


def _term_matches(term: Mapping, owner_ns: str, candidate: Mapping,
                  ns_labels) -> bool:
    from ..ops.inter_pod_affinity import _term_matches_pod
    return _term_matches_pod(term, owner_ns, candidate, ns_labels)


def _req_terms(pod: Mapping, kind: str) -> List[Mapping]:
    aff = (pod.get("spec") or {}).get("affinity") or {}
    return (aff.get(kind) or {}).get(
        "requiredDuringSchedulingIgnoredDuringExecution") or []


def _ipa_contrib(state: OracleState, j: int, pod: dict, aff_terms,
                 anti_terms, owner_ns: str, ns_labels) -> Dict:
    """Node j's part of the cluster-wide InterPodAffinity state the filter
    reads: ("aff"|"anti", key, value) counts of its pods that match the
    incoming pod's required terms, and ("block", key, value) counts of its
    pods' required anti-affinity terms that match the incoming pod."""
    out: Dict = {}
    j_labels = state.snapshot.node_labels(j)
    for p in state.pods_by_node[j]:
        for terms, tag in ((aff_terms, "aff"), (anti_terms, "anti")):
            for t in terms:
                key = t.get("topologyKey", "")
                if key in j_labels and _term_matches(t, owner_ns, p,
                                                     ns_labels):
                    k = (tag, key, j_labels[key])
                    out[k] = out.get(k, 0) + 1
        p_ns = (p.get("metadata") or {}).get("namespace") or "default"
        for t in _req_terms(p, "podAntiAffinity"):
            key = t.get("topologyKey", "")
            if key not in j_labels:
                continue
            if _term_matches(t, p_ns, pod, ns_labels):
                k = ("block", key, j_labels[key])
                out[k] = out.get(k, 0) + 1
    return out


def _ipa_derive(total: Dict):
    """(any affinity match at all, {key: values existing pods block})."""
    any_aff = any(c > 0 for (tag, _k, _v), c in total.items()
                  if tag == "aff")
    blocked: Dict[str, set] = {}
    for (tag, key, val), c in total.items():
        if tag == "block" and c > 0:
            blocked.setdefault(key, set()).add(val)
    return any_aff, blocked


def _ipa_filter(state: OracleState, i: int, pod: dict) -> Optional[str]:
    snap = state.snapshot
    ns_labels = _ns_labels(state)
    owner_ns = (pod.get("metadata") or {}).get("namespace") or "default"
    node_labels = snap.node_labels(i)
    aff_terms = _req_terms(pod, "podAffinity")
    anti_terms = _req_terms(pod, "podAntiAffinity")

    # affinityCounts / antiAffinityCounts over all existing pods, and the
    # values existing pods' required anti-affinity blocks for the incoming
    total, (any_aff, blocked) = state.node_sum(
        pod, "ipa", lambda j: _ipa_contrib(
            state, j, pod, aff_terms, anti_terms, owner_ns, ns_labels),
        _ipa_derive)

    if aff_terms:
        pods_exist = True
        for t in aff_terms:
            key = t.get("topologyKey", "")
            if key not in node_labels:
                return "node(s) didn't match pod affinity rules"
            if total.get(("aff", key, node_labels[key]), 0) <= 0:
                pods_exist = False
        if not pods_exist:
            pod_self = {"metadata": {
                "namespace": owner_ns,
                "labels": (pod.get("metadata") or {}).get("labels") or {}}}
            escape = (not any_aff) and all(
                _term_matches(t, owner_ns, pod_self, ns_labels)
                for t in aff_terms)
            if not escape:
                return "node(s) didn't match pod affinity rules"

    for t in anti_terms:
        key = t.get("topologyKey", "")
        if key in node_labels and \
                total.get(("anti", key, node_labels[key]), 0) > 0:
            return "node(s) didn't match pod anti-affinity rules"

    # existing pods' required anti-affinity vs incoming
    for key, values in blocked.items():
        if node_labels.get(key) in values:
            return ("node(s) didn't satisfy existing pods "
                    "anti-affinity rules")
    return None


# --- Scores ----------------------------------------------------------------

def _score_nodes(state: OracleState, feasible: List[int], pod: dict,
                 profile: SchedulerProfile,
                 breakdown: Optional[dict] = None) -> Dict[int, int]:
    """Per-node totals of the weighted plugin scores; with `breakdown`
    given, also records each plugin's weighted per-node contribution
    ({plugin: {i: int}}) for why-here attribution — the values folded into
    totals, unchanged."""
    snap = state.snapshot
    totals = {i: 0 for i in feasible}

    def fold(name: str, vals: Dict[int, int]) -> None:
        for i, v in vals.items():
            totals[i] += v
        if breakdown is not None:
            breakdown[name] = vals

    w = profile.score_weight("NodeResourcesFit")
    if w:
        raw = {i: _fit_score(state, i, pod, profile) for i in feasible}
        fold("NodeResourcesFit", {i: w * raw[i] for i in feasible})

    w = profile.score_weight("NodeResourcesBalancedAllocation")
    if w:
        fold("NodeResourcesBalancedAllocation",
             {i: w * _balanced_score(state, i, pod, profile)
              for i in feasible})

    w = profile.score_weight("TaintToleration")
    if w:
        raw = {i: lbl.count_intolerable_prefer_no_schedule(
            snap.node_taints(i), ps.pod_tolerations(pod)) for i in feasible}
        mx = max(raw.values(), default=0)
        vals = {}
        for i in feasible:
            s = 100 * raw[i] // mx if mx > 0 else 0
            vals[i] = w * (100 - s if mx > 0 else 100)
        fold("TaintToleration", vals)

    w = profile.score_weight("NodeAffinity")
    aff = ((pod.get("spec") or {}).get("affinity") or {}).get("nodeAffinity") or {}
    if w and aff.get("preferredDuringSchedulingIgnoredDuringExecution"):
        raw = {i: lbl.preferred_node_affinity_score(
            pod.get("spec") or {}, snap.node_labels(i), snap.node_names[i])
            for i in feasible}
        mx = max(raw.values(), default=0)
        fold("NodeAffinity",
             {i: w * (100 * raw[i] // mx if mx > 0 else raw[i])
              for i in feasible})

    w = profile.score_weight("ImageLocality")
    if w:
        from ..ops.image_locality import static_score
        raw = static_score(snap, pod)
        fold("ImageLocality", {i: w * int(raw[i]) for i in feasible})

    w = profile.score_weight("PodTopologySpread")
    if w:
        soft, require_all = _soft_constraints(state, pod)
        if soft:
            raw = _spread_scores(state, feasible, pod, soft, require_all)
            fold("PodTopologySpread", {i: w * raw[i] for i in feasible})

    w = profile.score_weight("InterPodAffinity")
    if w:
        raw = _ipa_scores(state, feasible, pod)
        if raw is not None:
            fold("InterPodAffinity", {i: w * raw[i] for i in feasible})
    return totals


def _fit_score(state: OracleState, i: int, pod: dict,
               profile: SchedulerProfile) -> int:
    alloc = state.allocatable(i)
    req = state.requested(i)
    nz_cpu, nz_mem = state.nonzero_requested(i)
    podreq = ps.pod_requests(pod, non_missing_defaults=True)
    podreq_actual = ps.pod_requests(pod)

    node_score = 0
    weight_sum = 0
    for name, weight in profile.fit_strategy.resources:
        if ps.is_scalar_resource_name(name) and not podreq.get(name, 0):
            continue
        a = alloc.get(name, 0)
        if a == 0:
            continue
        if name == "cpu":
            r = nz_cpu + podreq.get("cpu", 0)
        elif name == "memory":
            r = nz_mem + podreq.get("memory", 0)
        else:
            r = req.get(name, 0) + podreq_actual.get(name, 0)
        if profile.fit_strategy.type == "MostAllocated":
            rs = min(r, a) * 100 // a
        elif profile.fit_strategy.type == "RequestedToCapacityRatio":
            rs = _broken_linear(profile.fit_strategy.shape_utilization,
                                profile.fit_strategy.shape_score,
                                r * 100 // a)
            # RTC's mean counts a weight only for score>0 resources and
            # math.Rounds the quotient (requested_to_capacity_ratio.go:48-56)
            if rs > 0:
                node_score += rs * weight
                weight_sum += weight
            continue
        else:
            rs = 0 if r > a else (a - r) * 100 // a
        node_score += rs * weight
        weight_sum += weight
    if not weight_sum:
        return 0
    if profile.fit_strategy.type == "RequestedToCapacityRatio":
        import math
        return int(math.floor(node_score / weight_sum + 0.5))
    return node_score // weight_sum


def _broken_linear(shape_utilization, shape_score, p: int) -> int:
    """helper.BuildBrokenLinearFunction (shape_score.go:40-53) in the same
    pure int64 arithmetic as Go (division truncates toward zero) — an
    independent expression of the RTC shape, differential target for
    ops.node_resources_fit.piecewise_shape."""
    shape = [(int(x), int(y) * 10) for x, y in
             zip(shape_utilization, shape_score)]
    for i, (xi, yi) in enumerate(shape):
        if p <= xi:
            if i == 0:
                return shape[0][1]
            x1, y1 = shape[i - 1]
            num = (yi - y1) * (p - x1)
            den = xi - x1
            q = abs(num) // den if num >= 0 else -(abs(num) // den)
            return y1 + q
    return shape[-1][1]


def _balanced_score(state: OracleState, i: int, pod: dict,
                    profile: SchedulerProfile) -> int:
    alloc = state.allocatable(i)
    req = state.requested(i)
    podreq = ps.pod_requests(pod)
    fractions = []
    for name, _w in profile.balanced_resources:
        if ps.is_scalar_resource_name(name) and not podreq.get(name, 0):
            continue
        a = alloc.get(name, 0)
        if a == 0:
            continue
        fractions.append(min((req.get(name, 0) + podreq.get(name, 0)) / a, 1.0))
    if len(fractions) == 2:
        std = abs(fractions[0] - fractions[1]) / 2
    elif len(fractions) > 2:
        mean = sum(fractions) / len(fractions)
        std = math.sqrt(sum((f - mean) ** 2 for f in fractions) / len(fractions))
    else:
        std = 0.0
    return int((1 - std) * 100)


def _soft_constraints(state: OracleState, pod: dict):
    """Pod's ScheduleAnyway constraints, else system-default spreading via
    the merged service/RC/RS/SS selector (common.go:58-80)."""
    explicit = _spread_constraints(pod, "ScheduleAnyway")
    if (pod.get("spec") or {}).get("topologySpreadConstraints"):
        return explicit, True
    from ..ops.pod_topology_spread import (SYSTEM_DEFAULT_CONSTRAINTS,
                                           default_selector)
    selector = default_selector(state.snapshot, pod)
    if selector is None:
        return [], False
    return [dict(c, labelSelector=selector)
            for c in SYSTEM_DEFAULT_CONSTRAINTS], False


def _spread_countable_soft(state: OracleState, i: int, pod: dict,
                           constraints: List[dict], c: dict,
                           require_all: bool) -> bool:
    if require_all:
        return _spread_countable(state, i, pod, constraints, c)
    snap = state.snapshot
    labels = snap.node_labels(i)
    if (c.get("topologyKey") or "") not in labels:
        return False
    if (c.get("nodeAffinityPolicy") or "Honor") == "Honor":
        if not lbl.pod_matches_node_selector_and_affinity(
                pod.get("spec") or {}, labels, snap.node_names[i]):
            return False
    if (c.get("nodeTaintsPolicy") or "Ignore") == "Honor":
        if lbl.find_matching_untolerated_taint(
                snap.node_taints(i), ps.pod_tolerations(pod), DNS) is not None:
            return False
    return True


def _spread_scores(state: OracleState, feasible: List[int],
                   pod: dict, constraints: List[dict],
                   require_all: bool) -> Dict[int, int]:
    snap = state.snapshot
    ns = (pod.get("metadata") or {}).get("namespace") or "default"
    ignored = set()
    for i in feasible:
        labels = snap.node_labels(i)
        if require_all and not all((c.get("topologyKey") or "") in labels
                                   for c in constraints):
            ignored.add(i)

    raw: Dict[int, float] = {}
    sizes: List[int] = []
    counts_per_c: List[Dict[str, int]] = []
    for c in constraints:
        key = c.get("topologyKey") or ""
        domains = set()
        for i in feasible:
            if i in ignored:
                continue
            val = snap.node_labels(i).get(key)
            if val is not None:
                domains.add(val)
        counts: Dict[str, int] = {}
        for j in range(snap.num_nodes):
            if not _spread_countable_soft(state, j, pod, constraints, c,
                                          require_all):
                continue
            val = snap.node_labels(j).get(key)
            if val in domains:
                counts[val] = counts.get(val, 0) + _count_match(
                    state.pods_by_node[j], c.get("labelSelector"), ns)
        counts_per_c.append(counts)
        if key == "kubernetes.io/hostname":
            sizes.append(len(feasible) - len(ignored))
        else:
            sizes.append(len(domains))

    for i in feasible:
        if i in ignored:
            raw[i] = 0
            continue
        labels = snap.node_labels(i)
        score = 0.0
        for ci, c in enumerate(constraints):
            key = c.get("topologyKey") or ""
            if key not in labels:
                continue
            if key == "kubernetes.io/hostname":
                cnt = _count_match(state.pods_by_node[i],
                                   c.get("labelSelector"), ns)
            else:
                cnt = counts_per_c[ci].get(labels[key], 0)
            tp_weight = math.log(sizes[ci] + 2)
            score += cnt * tp_weight + (int(c.get("maxSkew", 1)) - 1)
        raw[i] = int(round(score))

    scored = [i for i in feasible if i not in ignored]
    if not scored:
        return {i: 0 for i in feasible}
    mx = max(raw[i] for i in scored)
    mn = min(raw[i] for i in scored)
    out = {}
    for i in feasible:
        if i in ignored:
            out[i] = 0
        elif mx == 0:
            out[i] = 100
        else:
            out[i] = 100 * (mx + mn - raw[i]) // mx
    return out


def _ipa_scores(state: OracleState, feasible: List[int],
                pod: dict) -> Optional[Dict[int, int]]:
    from ..ops.inter_pod_affinity import HARD_POD_AFFINITY_WEIGHT
    snap = state.snapshot
    ns_labels = _ns_labels(state)
    owner_ns = (pod.get("metadata") or {}).get("namespace") or "default"
    aff = (pod.get("spec") or {}).get("affinity") or {}

    def pref(p, kind):
        a = (p.get("spec") or {}).get("affinity") or {}
        return (a.get(kind) or {}).get(
            "preferredDuringSchedulingIgnoredDuringExecution") or []

    has_constraints = bool(pref(pod, "podAffinity") or
                           pref(pod, "podAntiAffinity"))
    pair_scores: Dict[Tuple[str, str], float] = {}

    def add(key, j, w):
        val = snap.node_labels(j).get(key)
        if val is not None:
            pair_scores[(key, val)] = pair_scores.get((key, val), 0.0) + w

    any_contrib = False
    for j in range(snap.num_nodes):
        for p in state.pods_by_node[j]:
            p_ns = (p.get("metadata") or {}).get("namespace") or "default"
            p_has_aff = bool((p.get("spec") or {}).get("affinity"))
            if has_constraints:
                for t in pref(pod, "podAffinity"):
                    term = t.get("podAffinityTerm") or {}
                    if _term_matches(term, owner_ns, p, ns_labels):
                        add(term.get("topologyKey", ""), j,
                            float(t.get("weight", 0)))
                        any_contrib = True
                for t in pref(pod, "podAntiAffinity"):
                    term = t.get("podAffinityTerm") or {}
                    if _term_matches(term, owner_ns, p, ns_labels):
                        add(term.get("topologyKey", ""), j,
                            -float(t.get("weight", 0)))
                        any_contrib = True
            if p_has_aff or has_constraints:
                for term in _req_terms(p, "podAffinity"):
                    if _term_matches(term, p_ns, pod, ns_labels):
                        add(term.get("topologyKey", ""), j,
                            HARD_POD_AFFINITY_WEIGHT)
                        any_contrib = True
                for t in pref(p, "podAffinity"):
                    term = t.get("podAffinityTerm") or {}
                    if _term_matches(term, p_ns, pod, ns_labels):
                        add(term.get("topologyKey", ""), j,
                            float(t.get("weight", 0)))
                        any_contrib = True
                for t in pref(p, "podAntiAffinity"):
                    term = t.get("podAffinityTerm") or {}
                    if _term_matches(term, p_ns, pod, ns_labels):
                        add(term.get("topologyKey", ""), j,
                            -float(t.get("weight", 0)))
                        any_contrib = True
    if not any_contrib:
        return None

    raw = {}
    for i in feasible:
        labels = snap.node_labels(i)
        raw[i] = int(sum(w for (k, v), w in pair_scores.items()
                         if labels.get(k) == v))
    mx = max(raw.values())
    mn = min(raw.values())
    diff = mx - mn
    return {i: int(100 * (raw[i] - mn) / diff) if diff > 0 else 0
            for i in feasible}


# --- Main loop --------------------------------------------------------------

def sample_window(feasible: List[int], n: int, sample_k: int,
                  next_start: int):
    """findNodesThatPassFilters truncation (schedule_one.go:610-694): take
    the first sample_k feasible nodes in round-robin order from next_start,
    advancing the start past the LAST NODE EXAMINED — the k-th feasible
    node's position when k were found, or all n nodes (advance ≡ 0 mod n)
    when fewer than k exist.  Single source for the oracle and the
    interleaved queue sweep; the engine's scan step mirrors it exactly
    (simulator._step)."""
    if sample_k <= 0:
        return feasible, next_start
    if len(feasible) < sample_k:
        return list(feasible), next_start      # processed all n nodes
    by_rank = sorted(feasible, key=lambda i: (i - next_start) % n)
    scorable = by_rank[:sample_k]
    last_rank = (scorable[-1] - next_start) % n
    return scorable, (next_start + last_rank + 1) % n


def simulate_with_preemption(snapshot: ClusterSnapshot, template: dict,
                             profile: Optional[SchedulerProfile] = None,
                             max_limit: int = 0,
                             snapshot_options: Optional[dict] = None):
    """simulate() plus the DefaultPreemption PostFilter loop — the sequential
    differential target for framework._solve_with_preemption.

    `snapshot_options` carries from_objects ordering options (sort_nodes)
    so the oracle's node axis matches the engine's.

    Extenders: preemption-supporting extenders from the profile are
    consulted exactly as the framework consults them (filter-chain node
    veto + ProcessPreemption victim veto).  Only preempt-only extenders are
    faithful here — simulate() does not model extender Filter/Prioritize,
    so profiles whose extenders filter or score nodes are out of this
    oracle's scope (solve_with_extenders has its own tests)."""
    from . import preemption as pre
    from .extenders import make_node_ok

    profile = profile or SchedulerProfile.parity()
    extenders = list(profile.extenders or [])
    placements: List[int] = []
    reasons: Dict[str, int] = {}
    working_pods = [p for plist in snapshot.pods_by_node for p in plist]
    clone_seq = 0
    while True:
        snap = ClusterSnapshot.from_objects(
            snapshot.nodes, working_pods, **(snapshot_options or {}),
            **{k: getattr(snapshot, k) for k in OBJECT_FIELDS})
        remaining = (max_limit - len(placements)) if max_limit else 0
        if max_limit and remaining <= 0:
            return placements, {}
        got, reasons = simulate(snap, template, profile, max_limit=remaining)
        placements.extend(got)
        if max_limit and len(placements) >= max_limit:
            return placements, {}
        if "DefaultPreemption" not in profile.post_filters:
            return placements, reasons
        state_pods = [list(p) for p in snap.pods_by_node]
        for j, idx in enumerate(got):
            clone = ps.make_clone(template, clone_seq + j)
            clone["spec"]["nodeName"] = snap.node_names[idx]
            state_pods[idx].append(clone)
        outcome = pre.evaluate(
            snap, state_pods, template, profile,
            node_ok=make_node_ok(extenders, template, snap.node_names,
                                 snap.nodes),
            extenders=extenders)
        if not outcome.succeeded:
            return placements, reasons
        is_victim = pre.victim_matcher(outcome.victims)
        before = sum(len(pl) for pl in snap.pods_by_node)
        working_pods = [p for plist in snap.pods_by_node for p in plist
                        if not is_victim(p)]
        if len(working_pods) == before and not got:
            # nothing evicted and nothing placed: cannot progress
            return placements, reasons
        for idx in got:
            clone = ps.make_clone(template, clone_seq)
            clone_seq += 1
            clone["spec"]["nodeName"] = snap.node_names[idx]
            working_pods.append(clone)


def simulate(snapshot: ClusterSnapshot, template: dict,
             profile: Optional[SchedulerProfile] = None,
             max_limit: int = 0, explain_out: Optional[dict] = None):
    """Sequential greedy simulation; returns (placements, fail_counts).

    With `explain_out` (a dict the caller owns), the oracle also records
    attribution: "why_here" — per placement the per-plugin weighted score
    contributions of the chosen node, in explain/artifacts.PLUGINS order;
    "elim_step" / "elim_reason" — per node the step index at which it first
    left the feasible set (-1 = never) and its first-fail reason string.
    This is the host recomputation the device rungs' attribution is held
    against.  The JAX oracle's `alive_mask` (resilience sweeps) arrives
    with resilience/."""
    from ..ops import volumes as vol_ops

    profile = profile or SchedulerProfile.parity()
    state = OracleState(snapshot)
    placements: List[int] = []
    step = 0
    n = snapshot.num_nodes

    if explain_out is not None:
        from ..explain.artifacts import PLUGINS
        explain_out.setdefault("plugins", list(PLUGINS))
        explain_out.setdefault("why_here", [])
        explain_out.setdefault("elim_step", [-1] * n)
        explain_out.setdefault("elim_reason", [None] * n)

    if (template.get("spec") or {}).get("schedulingGates"):
        from .encode import REASON_SCHEDULING_GATED
        return [], {REASON_SCHEDULING_GATED: n}
    verdict = vol_ops.evaluate(snapshot, template, profile.filter_enabled)
    if verdict.pod_level_reason:
        return [], {verdict.pod_level_reason: n}

    placed_per_node = [0] * n
    has_ports = bool(ps.pod_host_ports(template)) and \
        profile.filter_enabled("NodePorts")
    next_start = 0

    from .simulator import _num_feasible_nodes_to_find
    sample_k = _num_feasible_nodes_to_find(profile, n)

    def node_reason(i: int) -> Optional[str]:
        r = _filter_node(state, i, template, profile)
        if r is not None:
            return r
        if has_ports and placed_per_node[i] > 0:
            return ("node(s) didn't have free ports for the requested "
                    "pod ports")
        if not verdict.mask[i]:
            return verdict.reasons[i]
        if verdict.self_disk_conflict and placed_per_node[i] > 0:
            return vol_ops.REASON_DISK_CONFLICT
        if verdict.rwop_self_conflict and placements:
            return vol_ops.REASON_RWOP_CONFLICT
        return None

    while True:
        if max_limit and len(placements) >= max_limit:
            return placements, {}
        feasible = [i for i in range(n) if node_reason(i) is None]
        if explain_out is not None:
            feas_set = set(feasible)
            es = explain_out["elim_step"]
            for i in range(n):
                if es[i] < 0 and i not in feas_set:
                    es[i] = step
                    explain_out["elim_reason"][i] = node_reason(i)
        if not feasible:
            reasons: Dict[str, int] = {}
            for i in range(n):
                r = node_reason(i)
                if r and (r.startswith("Insufficient") or r == "Too many pods"):
                    for fr in _fit_reasons(state, i, template):
                        reasons[fr] = reasons.get(fr, 0) + 1
                elif r:
                    reasons[r] = reasons.get(r, 0) + 1
            return placements, reasons
        scorable, next_start = sample_window(feasible, n, sample_k,
                                             next_start)
        bd = {} if explain_out is not None else None
        totals = _score_nodes(state, scorable, template, profile,
                              breakdown=bd)
        best = max(scorable, key=lambda i: (totals[i], -i))
        if explain_out is not None:
            explain_out["why_here"].append(
                [bd.get(p, {}).get(best, 0) for p in explain_out["plugins"]])
        placements.append(best)
        placed_per_node[best] += 1
        clone = ps.make_clone(template, step)
        clone["spec"]["nodeName"] = snapshot.node_names[best]
        state.add_pod(best, clone)
        step += 1

"""PodTopologySpread: filter + score as carried domain-count tensors.

Reference semantics (vendor/k8s.io/kubernetes/pkg/scheduler/framework/plugins/podtopologyspread/):
- PreFilter (filtering.go:234-308): per hard constraint, count same-namespace
  pods matching the constraint selector per topology domain; nodes are counted
  only if they carry ALL hard topology keys and pass per-constraint node
  inclusion policies (NodeAffinityPolicy=Honor, NodeTaintsPolicy=Ignore by
  default, common.go:42-56).
- Filter (filtering.go:310-357): reject when
  matchNum + selfMatch - minMatchNum > maxSkew; missing topology key is
  UnschedulableAndUnresolvable.  minMatchNum treats the global minimum as 0
  when the eligible-domain count is below minDomains (filtering.go:56-69).
- Score (scoring.go:100-260): per soft constraint, score = cnt*log(size+2) +
  (maxSkew-1), hostname constraints count pods on the node itself; normalized
  as 100*(max+min-s)/max over the feasible set with ignored nodes zeroed.

Design: domains are integer-encoded per constraint on the host; the engine
carries per-node count planes updated at each placement.
Because every clone is identical, whether a placement increments a constraint's
domain count is a static boolean (`self_match`) times the static per-node
counting eligibility.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Mapping, Optional, Sequence, Tuple

import torch
import numpy as np

from ..models.labels import match_label_selector
from ..models.snapshot import ClusterSnapshot
from ..obs import spans as obs_spans
from ..parallel.mesh import PLAIN
from ..utils import metrics

REASON_CONSTRAINTS = "node(s) didn't match pod topology spread constraints"
REASON_MISSING_LABEL = ("node(s) didn't match pod topology spread constraints "
                        "(missing required label)")
LABEL_HOSTNAME = "kubernetes.io/hostname"

_BIG = np.float64(2**31 - 1)  # stand-in for the MaxInt32 critical-path init


@dataclass
class SpreadConstraintSet:
    """Encoded constraints of one kind (hard or soft) for one template."""

    num_constraints: int
    max_domains: int
    topology_keys: List[str]
    max_skew: np.ndarray          # f64[C]
    min_domains: np.ndarray       # f64[C] (hard only; 1 when unset)
    is_hostname: np.ndarray       # bool[C]
    self_match: np.ndarray        # bool[C] — template matches its own selector
    node_domain: np.ndarray       # i32[C, N], -1 when node lacks the key
    node_countable: np.ndarray    # bool[C, N] — inclusion-policy eligibility
    node_has_all_keys: np.ndarray  # bool[N] — node carries every key in set
    domain_valid: np.ndarray      # bool[C, D] — domain exists among countable nodes
    init_counts: np.ndarray       # f64[C, D] — existing matching pods per domain
    node_existing: np.ndarray     # f64[C, N] — matching pods on the node itself
    # raw per-constraint labelSelectors + the owner namespace: the tensor
    # interleave engine derives cross-template increment matrices from them
    # (does template t's clone count under template u's constraint c?)
    selectors: List = field(default_factory=list)
    namespace: str = "default"

    @property
    def empty(self) -> bool:
        return self.num_constraints == 0


def _constraints_of(pod: Mapping, action: str) -> List[dict]:
    out = []
    for c in (pod.get("spec") or {}).get("topologySpreadConstraints") or []:
        if (c.get("whenUnsatisfiable") or "DoNotSchedule") == action:
            out.append(c)
    return out


def _count_matching(pods: Sequence[Mapping], selector, namespace: str) -> int:
    """countPodsMatchSelector: same-namespace, selector match, skip terminating."""
    n = 0
    for p in pods:
        meta = p.get("metadata") or {}
        if (meta.get("namespace") or "default") != namespace:
            continue
        if meta.get("deletionTimestamp"):
            continue
        if match_label_selector(selector, meta.get("labels") or {}):
            n += 1
    return n


def encode_constraints(snapshot: ClusterSnapshot, pod: Mapping,
                       action: str) -> SpreadConstraintSet:
    """Encode the pod's constraints with whenUnsatisfiable==action (kind
    "hard" for DoNotSchedule, "soft" for ScheduleAnyway in `_encode`'s
    span and count)."""
    constraints = _constraints_of(pod, action)
    return _encode(snapshot, pod, constraints,
                   kind="hard" if action == "DoNotSchedule" else "soft")


def default_selector(snapshot: ClusterSnapshot, pod: Mapping) -> Optional[dict]:
    """helper.DefaultSelector: merge the selectors of every service/RC/RS/SS
    that selects the pod (plugins/helper/spread.go); None when nothing does."""
    meta = pod.get("metadata") or {}
    ns = meta.get("namespace") or "default"
    labels = meta.get("labels") or {}
    match_labels: dict = {}
    match_exprs: List[dict] = []
    found = False

    def same_ns(obj):
        return ((obj.get("metadata") or {}).get("namespace") or "default") == ns

    for svc in snapshot.services:
        sel = (svc.get("spec") or {}).get("selector") or {}
        if sel and same_ns(svc) and all(labels.get(k) == v
                                        for k, v in sel.items()):
            match_labels.update(sel)
            found = True
    for rc in snapshot.replication_controllers:
        sel = (rc.get("spec") or {}).get("selector") or {}
        if sel and same_ns(rc) and all(labels.get(k) == v
                                       for k, v in sel.items()):
            match_labels.update(sel)
            found = True
    for obj in list(snapshot.replica_sets) + list(snapshot.stateful_sets):
        sel = (obj.get("spec") or {}).get("selector")
        if sel and same_ns(obj) and match_label_selector(sel, labels):
            match_labels.update(sel.get("matchLabels") or {})
            match_exprs.extend(sel.get("matchExpressions") or [])
            found = True
    if not found:
        return None
    out: dict = {}
    if match_labels:
        out["matchLabels"] = match_labels
    if match_exprs:
        out["matchExpressions"] = match_exprs
    return out


SYSTEM_DEFAULT_CONSTRAINTS = (
    # systemDefaultConstraints (podtopologyspread/plugin.go; the docs'
    # "Internal default constraints"): hostname maxSkew 3, zone maxSkew 5,
    # both ScheduleAnyway.
    {"maxSkew": 3, "topologyKey": LABEL_HOSTNAME,
     "whenUnsatisfiable": "ScheduleAnyway"},
    {"maxSkew": 5, "topologyKey": "topology.kubernetes.io/zone",
     "whenUnsatisfiable": "ScheduleAnyway"},
)


def encode_system_default(snapshot: ClusterSnapshot,
                          pod: Mapping) -> SpreadConstraintSet:
    """System default spreading (buildDefaultConstraints, common.go:58-80):
    applies only when the pod declares no constraints and some
    service/RC/RS/SS selects it; soft (score-only) constraints with the merged
    selector; nodes need not carry every topology key (requireAllTopologies is
    false for system defaulting, scoring.go:141-145)."""
    selector = default_selector(snapshot, pod)
    if selector is None:
        return _encode(snapshot, pod, [], kind="system_default")
    constraints = [dict(c, labelSelector=selector)
                   for c in SYSTEM_DEFAULT_CONSTRAINTS]
    return _encode(snapshot, pod, constraints, require_all=False,
                   kind="system_default")


def _encode(snapshot: ClusterSnapshot, pod: Mapping,
            constraints: List[dict], require_all: bool = True,
            kind: str = "hard") -> SpreadConstraintSet:
    """Every encode counts once in utils/metrics SPREAD_ENCODES by `kind`
    ("hard", "soft" or "system_default") and runs in a span `pts.encode`,
    attrs `kind`, `constraints`, `hostname_rows`, `domains` (each row's
    domain count, summed) and `residents_read` (resident pods read, summed
    over the rows: 0 on an empty cluster or with no constraint)."""
    metrics.default_registry.inc(metrics.SPREAD_ENCODES, kind=kind)
    with obs_spans.span(
            "pts.encode", kind=kind, constraints=len(constraints),
            hostname_rows=sum(c.get("topologyKey") == LABEL_HOSTNAME
                              for c in constraints)) as sp:
        if constraints:
            return _encode_impl(snapshot, pod, constraints, require_all,
                                sp.attrs)
        # the empty set's arrays depend only on the node count (and the
        # namespace field for the interleave engine) — one object per
        # (snapshot, namespace) serves every unconstrained template of a
        # sweep, and the sweep dedup's id-cache then hashes it once
        sp.attrs.update(domains=0, residents_read=0)
        ns = (pod.get("metadata") or {}).get("namespace") or "default"
        from .inter_pod_affinity import _freeze_encoding
        return snapshot.memo(
            ("spread_empty", ns),
            lambda: _freeze_encoding(
                _encode_impl(snapshot, pod, [], require_all, {})))


def _encode_impl(snapshot: ClusterSnapshot, pod: Mapping,
                 constraints: List[dict], require_all: bool,
                 attrs: dict) -> SpreadConstraintSet:
    """`_encode`'s work; sets attrs `domains` and `residents_read`."""
    n = snapshot.num_nodes
    c_num = len(constraints)
    namespace = (pod.get("metadata") or {}).get("namespace") or "default"
    pod_labels = (pod.get("metadata") or {}).get("labels") or {}
    keys = [c.get("topologyKey", "") for c in constraints]
    has_all = np.ones(n, dtype=bool)
    for k in keys:
        has_all &= snapshot.labels_have_key(k)

    # Domain vocabularies per constraint (pod-independent: cached on the
    # snapshot; sweeps encode hundreds of templates sharing the same keys).
    domains: List[dict] = []
    node_domain = np.full((max(c_num, 1), n), -1, dtype=np.int32)
    countable = np.zeros((max(c_num, 1), n), dtype=bool)
    for ci, c in enumerate(constraints):
        dom, vocab = snapshot.topology_domains(keys[ci])
        node_domain[ci] = dom
        domains.append(vocab)
        affinity_policy = c.get("nodeAffinityPolicy") or "Honor"
        taints_policy = c.get("nodeTaintsPolicy") or "Ignore"
        base = has_all if require_all else (dom >= 0)
        ok = np.asarray(base).copy()
        if affinity_policy == "Honor":
            # same computation as NodeAffinity's Filter mask -> shared memo
            from .node_affinity import static_mask as _na_mask
            ok &= _na_mask(snapshot, pod)
        if taints_policy == "Honor":
            from .taint_toleration import static_mask_and_reasons as _tt_mask
            ok &= _tt_mask(snapshot, pod)[0]
        countable[ci] = ok

    d_max = max([len(v) for v in domains], default=0)
    d_max = max(d_max, 1)
    attrs["domains"] = sum(len(v) for v in domains)
    init_counts = np.zeros((max(c_num, 1), d_max), dtype=np.float64)
    node_existing = np.zeros((max(c_num, 1), n), dtype=np.float64)
    domain_valid = np.zeros((max(c_num, 1), d_max), dtype=bool)
    self_match = np.zeros(max(c_num, 1), dtype=bool)
    has_pods = snapshot.memo(("has_pods",), lambda: any(
        len(p) for p in snapshot.pods_by_node))
    residents_read = 0
    for ci, c in enumerate(constraints):
        sel = c.get("labelSelector")
        self_match[ci] = match_label_selector(sel, pod_labels)
        if not has_pods:
            # empty cluster: counts stay zero; only domain validity remains
            doms = node_domain[ci][countable[ci]]
            domain_valid[ci, np.unique(doms[doms >= 0])] = True
            continue
        for i in range(n):
            residents_read += len(snapshot.pods_by_node[i])
            cnt = _count_matching(snapshot.pods_by_node[i], sel, namespace)
            node_existing[ci, i] = cnt
            if countable[ci, i]:
                d = node_domain[ci, i]
                domain_valid[ci, d] = True
                init_counts[ci, d] += cnt
    attrs["residents_read"] = residents_read

    return SpreadConstraintSet(
        num_constraints=c_num,
        max_domains=d_max,
        topology_keys=keys,
        max_skew=np.asarray([float(c.get("maxSkew", 1)) for c in constraints] or [1.0]),
        min_domains=np.asarray([float(c.get("minDomains") or 1)
                                for c in constraints] or [1.0]),
        is_hostname=np.asarray([k == LABEL_HOSTNAME for k in keys] or [False]),
        self_match=self_match,
        node_domain=node_domain,
        node_countable=countable,
        node_has_all_keys=has_all,
        domain_valid=domain_valid,
        init_counts=init_counts,
        node_existing=node_existing,
        selectors=[c.get("labelSelector") for c in constraints],
        namespace=namespace,
    )


# ---------------------------------------------------------------------------
# Device-side functions (torch; operate on carried PER-NODE count tensors)
#
# The carry holds cnt_node[C, N] — each node's own domain's match count —
# instead of domain-indexed counts[C, D], so the domain lookup the Go code
# does per node (filtering.go:329-339) is a dense elementwise read.
# ---------------------------------------------------------------------------

def dense_count_update(cnt_node: torch.Tensor, node_domain: torch.Tensor,
                       dom_chosen: torch.Tensor, inc: torch.Tensor
                       ) -> torch.Tensor:
    """Add inc[c] to every node sharing the chosen node's domain.

    cnt_node: f[C, N]; node_domain: i32[C, N]; dom_chosen: i32[C]; inc: f[C].
    """
    hit = (node_domain == dom_chosen[:, None]) & (node_domain >= 0)
    return cnt_node + hit.to(cnt_node.dtype) * inc[:, None]


def hard_filter(cnt_node: torch.Tensor, node_domain: torch.Tensor,
                node_countable: torch.Tensor, max_skew: torch.Tensor,
                min_domains: torch.Tensor, domains_num: torch.Tensor,
                self_match: torch.Tensor, missing: torch.Tensor, red=PLAIN
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Filter over all nodes.  Returns (pass[N], missing_label[N]).

    minMatchNum (filtering.go:56-69): the min over valid domains equals the
    min over countable nodes of cnt_node — every valid domain has at least
    one countable node and all its nodes share one count.  `red`: the
    node-axis reducer (parallel/mesh.py), a node shard's on a mesh.
    """
    has_key = node_domain >= 0                               # [C, N]
    big = torch.full((), float(_BIG), dtype=cnt_node.dtype,
                     device=cnt_node.device)
    masked = torch.where(node_countable, cnt_node, big)
    min_match = red.min_rows(masked)                         # [C]
    min_match = torch.where(domains_num < min_domains,
                            torch.zeros_like(min_match), min_match)
    skew = cnt_node + self_match[:, None].to(cnt_node.dtype) \
        - min_match[:, None]                                 # [C, N]
    violated = ((skew > max_skew[:, None]) & has_key).any(dim=0)
    return ~(missing | violated), missing


def fold_rows(x: torch.Tensor) -> torch.Tensor:
    """Sum over the leading (constraint or group) axis as a left fold
    x0 + x1 + ..., the JAX package's XLA row reduction in the same order."""
    acc = x[0]
    for c in range(1, x.shape[0]):
        acc = acc + x[c]
    return acc


def domain_slots(node_domain: np.ndarray, is_hostname: np.ndarray
                 ) -> Tuple[np.ndarray, int]:
    """(slot[C, N] int64, D): each node's row-major slot c * D + domain in a
    [C, D] table of per-domain presence, D the largest domain count of the
    non-hostname rows (at least 1); soft_score counts distinct domains by
    scattering into it.  Nodes without the key point at their row's slot 0
    and scatter zero."""
    d = 1
    for c in range(node_domain.shape[0]):
        if not is_hostname[c] and (node_domain[c] >= 0).any():
            d = max(d, int(node_domain[c].max()) + 1)
    rows = np.arange(node_domain.shape[0], dtype=np.int64)[:, None]
    return rows * d + np.clip(node_domain, 0, d - 1).astype(np.int64), d


def soft_score(cnt_node: torch.Tensor, hostname_cnt: torch.Tensor,
               node_domain: torch.Tensor, is_hostname: torch.Tensor,
               max_skew: torch.Tensor, slots: torch.Tensor,
               present0: torch.Tensor, log_table: torch.Tensor,
               ignored: torch.Tensor, feasible: torch.Tensor, red=PLAIN
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw spread score for soft constraints over the current feasible set
    (scoring.go:141-200).

    cnt_node: f[C, N] carried per-node domain counts (non-hostname rows);
    hostname_cnt: f[C, N] per-node matching-pod counts (hostname rows);
    slots / present0: domain_slots' index [C, N] and a zero int32 [C, D]
    table — the distinct-domain count over the scorable set is a scatter of
    the scorable nodes into the table, then a count of non-empty slots;
    log_table: log(size + 2) for size = 0..N in the score's dtype, read
    instead of computing the logarithm on the device.
    Returns (raw_score[N], scored[N]), scored = feasible & ~ignored.
    On a node shard (`red`) the presence tables and the scorable counts of
    the shards add up (integers, exact).
    """
    scorable = feasible & ~ignored
    has_key = node_domain >= 0                               # [C, N]
    hits = (scorable[None, :] & has_key).to(torch.int32)
    present = red.add(torch.zeros_like(present0).view(-1).scatter_add_(
        0, slots.reshape(-1), hits.reshape(-1)).view(present0.shape))
    topo_size = (present > 0).sum(dim=1)                     # [C]
    host_size = red.sum(scorable)
    size = torch.where(is_hostname, host_size, topo_size)
    tp_weight = log_table[size]                              # [C]

    cnt = torch.where(is_hostname[:, None], hostname_cnt, cnt_node)
    per_c = torch.where(has_key, cnt * tp_weight[:, None]
                        + (max_skew[:, None] - 1.0), 0.0)
    return torch.round(fold_rows(per_c)), scorable


def soft_normalize(raw: torch.Tensor, scored: torch.Tensor,
                   red=PLAIN) -> torch.Tensor:
    """NormalizeScore (scoring.go:226-265): 100*(max+min-s)/max over scored
    nodes; ignored/unscored nodes get 0; max==0 -> 100."""
    any_scored = red.any(scored)
    max_s = red.max(torch.where(scored, raw, -np.inf))
    min_s = red.min(torch.where(scored, raw, np.inf))
    max_s = torch.where(any_scored, max_s, 0.0)
    min_s = torch.where(any_scored, min_s, 0.0)
    tiny = torch.full((), 1e-30, dtype=raw.dtype, device=raw.device)
    out = torch.where(max_s == 0, 100.0,
                      torch.floor(100.0 * (max_s + min_s - raw)
                                  / torch.maximum(max_s, tiny)))
    return torch.where(scored, out, 0.0)


def pad_constraints(spread: SpreadConstraintSet, c_rows: int
                    ) -> SpreadConstraintSet:
    """Pad the constraint axis to c_rows with inert always-pass rows so
    heterogeneous templates can share one batched solve.  Inert row: no
    topology key anywhere (node_domain -1 → has_key False masks the skew
    check and zeroes the soft contribution), nothing countable, self_match
    False (no carry updates), maxSkew huge."""
    cur = spread.node_domain.shape[0]
    if cur >= c_rows:
        return spread
    pad = c_rows - cur
    n = spread.node_domain.shape[1]
    d = spread.init_counts.shape[1]

    def rows(val, dtype):
        return np.full((pad, n), val, dtype=dtype)

    return SpreadConstraintSet(
        num_constraints=spread.num_constraints,
        max_domains=spread.max_domains,
        topology_keys=list(spread.topology_keys) + [""] * pad,
        max_skew=np.concatenate([spread.max_skew, np.full(pad, _BIG)]),
        min_domains=np.concatenate([spread.min_domains, np.ones(pad)]),
        is_hostname=np.concatenate([spread.is_hostname,
                                    np.zeros(pad, dtype=bool)]),
        self_match=np.concatenate([spread.self_match,
                                   np.zeros(pad, dtype=bool)]),
        node_domain=np.concatenate([spread.node_domain, rows(-1, np.int32)]),
        node_countable=np.concatenate([spread.node_countable,
                                       rows(False, bool)]),
        node_has_all_keys=spread.node_has_all_keys,
        domain_valid=np.concatenate([spread.domain_valid,
                                     np.zeros((pad, d), dtype=bool)]),
        init_counts=np.concatenate([spread.init_counts, np.zeros((pad, d))]),
        node_existing=np.concatenate([spread.node_existing,
                                      rows(0.0, np.float64)]),
        selectors=list(spread.selectors),
        namespace=spread.namespace,
    )


def static_ignored(spread: SpreadConstraintSet, require_all: bool) -> np.ndarray:
    """Nodes the score pass ignores (missing soft topology labels when
    requireAllTopologies)."""
    if spread.empty or not require_all:
        return np.zeros(spread.node_has_all_keys.shape[0], dtype=bool)
    return ~spread.node_has_all_keys

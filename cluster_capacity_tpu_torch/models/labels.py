"""Label-selector, node-selector and taint/toleration matching (host side).

Design note: all string matching in this framework happens ONCE on
the host when a (snapshot, podspec) pair is encoded into device tensors.  The
device only ever sees integer/boolean arrays.  This module is the single place
where Kubernetes string-matching semantics live.

Reference semantics:
- metav1.LabelSelector matching: vendor/k8s.io/apimachinery/pkg/apis/meta/v1/helpers.go
  (LabelSelectorAsSelector), operators In/NotIn/Exists/DoesNotExist.
- v1.NodeSelector matching: vendor/k8s.io/component-helpers/scheduling/corev1/nodeaffinity
  (used by the NodeAffinity plugin,
  vendor/k8s.io/kubernetes/pkg/scheduler/framework/plugins/nodeaffinity/node_affinity.go:147-265).
- Taints/tolerations: vendor/k8s.io/api/core/v1/toleration.go ToleratesTaint
  (used by vendor/.../plugins/tainttoleration/taint_toleration.go:110-121).
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence


# ---------------------------------------------------------------------------
# metav1.LabelSelector (pod label selectors: affinity terms, topology spread)
# ---------------------------------------------------------------------------

def match_label_selector(selector: Optional[Mapping], labels: Mapping[str, str]) -> bool:
    """Match a metav1.LabelSelector dict against a label map.

    A nil selector matches nothing; an empty selector ({}) matches everything —
    mirroring LabelSelectorAsSelector.
    """
    if selector is None:
        return False
    match_labels = selector.get("matchLabels") or {}
    for k, v in match_labels.items():
        if labels.get(k) != v:
            return False
    for expr in selector.get("matchExpressions") or []:
        if not _match_selector_requirement(expr, labels):
            return False
    return True


def _match_selector_requirement(expr: Mapping, labels: Mapping[str, str]) -> bool:
    key = expr["key"]
    op = expr["operator"]
    values = expr.get("values") or []
    present = key in labels
    if op == "In":
        return present and labels[key] in values
    if op == "NotIn":
        return not present or labels[key] not in values
    if op == "Exists":
        return present
    if op == "DoesNotExist":
        return not present
    raise ValueError(f"unsupported label selector operator {op!r}")


# ---------------------------------------------------------------------------
# v1.NodeSelector (node affinity required/preferred terms + plain nodeSelector)
# ---------------------------------------------------------------------------

def _match_node_selector_requirement(expr: Mapping, node_labels: Mapping[str, str]) -> bool:
    key = expr["key"]
    op = expr["operator"]
    values = expr.get("values") or []
    present = key in node_labels
    if op == "In":
        return present and node_labels[key] in values
    if op == "NotIn":
        return not present or node_labels[key] not in values
    if op == "Exists":
        return present
    if op == "DoesNotExist":
        return not present
    if op in ("Gt", "Lt"):
        # Reference parses both sides as int64 and fails the term on parse error
        # (nodeaffinity.nodeSelectorRequirementsAsSelector → labels.Selector Gt/Lt).
        if not present or len(values) != 1:
            return False
        try:
            lhs = int(node_labels[key])
            rhs = int(values[0])
        except ValueError:
            return False
        return lhs > rhs if op == "Gt" else lhs < rhs
    raise ValueError(f"unsupported node selector operator {op!r}")


def _match_node_field_requirement(expr: Mapping, node_name: str) -> bool:
    # Only supported field is metadata.name (same as upstream).
    if expr["key"] != "metadata.name":
        return False
    values = expr.get("values") or []
    if expr["operator"] == "In":
        return node_name in values
    if expr["operator"] == "NotIn":
        return node_name not in values
    return False


def match_node_selector_term(term: Mapping, node_labels: Mapping[str, str],
                             node_name: str) -> bool:
    """One NodeSelectorTerm: matchExpressions AND matchFields (all must hold).

    An empty/nil term matches nothing (upstream: terms with no requirements are
    skipped).
    """
    exprs = term.get("matchExpressions") or []
    fields = term.get("matchFields") or []
    if not exprs and not fields:
        return False
    return all(_match_node_selector_requirement(e, node_labels) for e in exprs) and \
        all(_match_node_field_requirement(f, node_name) for f in fields)


def match_node_selector(node_selector: Optional[Mapping],
                        node_labels: Mapping[str, str], node_name: str) -> bool:
    """v1.NodeSelector: OR over NodeSelectorTerms."""
    if node_selector is None:
        return True
    terms = node_selector.get("nodeSelectorTerms") or []
    if not terms:
        return False
    return any(match_node_selector_term(t, node_labels, node_name) for t in terms)


def pod_matches_node_selector_and_affinity(pod_spec: Mapping,
                                           node_labels: Mapping[str, str],
                                           node_name: str) -> bool:
    """GetRequiredNodeAffinity(pod).Match(node): spec.nodeSelector (AND of all
    entries) AND requiredDuringScheduling node affinity."""
    ns = pod_spec.get("nodeSelector") or {}
    for k, v in ns.items():
        if node_labels.get(k) != v:
            return False
    affinity = (pod_spec.get("affinity") or {}).get("nodeAffinity") or {}
    required = affinity.get("requiredDuringSchedulingIgnoredDuringExecution")
    if required is not None:
        if not match_node_selector(required, node_labels, node_name):
            return False
    return True


def preferred_node_affinity_score(pod_spec: Mapping,
                                  node_labels: Mapping[str, str],
                                  node_name: str) -> int:
    """Sum of weights of preferred node-affinity terms matching the node
    (NodeAffinity.Score raw value, node_affinity.go:260-285)."""
    affinity = (pod_spec.get("affinity") or {}).get("nodeAffinity") or {}
    total = 0
    for pref in affinity.get("preferredDuringSchedulingIgnoredDuringExecution") or []:
        term = pref.get("preference") or {}
        if match_node_selector_term(term, node_labels, node_name):
            total += int(pref.get("weight", 0))
    return total


# ---------------------------------------------------------------------------
# Vectorized node-selector matching over the snapshot's node axis
#
# The scalar functions above are the semantics reference (and serve the
# object-level oracle); sweeps encoding hundreds of templates against one
# 50k-node snapshot need the same answers as whole-node-axis arrays.  These
# ride the snapshot's memoized topology_domains factorization (one O(N) pass
# per distinct label key, shared by every template), so a requirement match
# is an np.isin over integer codes instead of N Python dict lookups.
# Differential-tested against the scalar versions in
# tests/test_filters.py::test_vectorized_matches_scalar_*.
# ---------------------------------------------------------------------------

import numpy as np


def _names_array(snapshot) -> np.ndarray:
    return snapshot.node_memo(
        ("names_array",),
        lambda: np.asarray(snapshot.node_names, dtype=object))


def _label_ints(snapshot, key: str):
    """(valid bool[N], value int64[N]) — node label parsed as int64 (for
    Gt/Lt requirements); invalid/absent parses are masked out."""
    def build():
        dom, vocab = snapshot.topology_domains(key)
        ok = np.zeros(max(len(vocab), 1), dtype=bool)
        vals = np.zeros(max(len(vocab), 1), dtype=np.int64)
        for v, idx in vocab.items():
            try:
                vals[idx] = int(v)
                ok[idx] = True
            except (ValueError, TypeError):
                pass
        present = dom >= 0
        out_ok = np.zeros(dom.shape[0], dtype=bool)
        out_val = np.zeros(dom.shape[0], dtype=np.int64)
        out_ok[present] = ok[dom[present]]
        out_val[present] = vals[dom[present]]
        return out_ok, out_val
    return snapshot.node_memo(("label_ints", key), build)


def node_selector_requirement_mask(snapshot, expr: Mapping) -> np.ndarray:
    """bool[N] — vectorized _match_node_selector_requirement."""
    key = expr["key"]
    op = expr["operator"]
    values = expr.get("values") or []
    dom, vocab = snapshot.topology_domains(key)
    n = dom.shape[0]
    if op == "In":
        codes = [vocab[v] for v in values if v in vocab]
        return np.isin(dom, codes) if codes else np.zeros(n, dtype=bool)
    if op == "NotIn":
        # absent (dom == -1) is "not in" too; -1 never appears in codes
        codes = [vocab[v] for v in values if v in vocab]
        return ~np.isin(dom, codes) if codes else np.ones(n, dtype=bool)
    if op == "Exists":
        return dom >= 0
    if op == "DoesNotExist":
        return dom < 0
    if op in ("Gt", "Lt"):
        if len(values) != 1:
            return np.zeros(n, dtype=bool)
        try:
            rhs = int(values[0])
        except (ValueError, TypeError):
            return np.zeros(n, dtype=bool)
        ok, lhs = _label_ints(snapshot, key)
        return ok & (lhs > rhs) if op == "Gt" else ok & (lhs < rhs)
    raise ValueError(f"unsupported node selector operator {op!r}")


def _node_field_requirement_mask(snapshot, expr: Mapping) -> np.ndarray:
    n = len(snapshot.node_names)
    if expr["key"] != "metadata.name":
        return np.zeros(n, dtype=bool)
    values = list(expr.get("values") or [])
    hit = np.isin(_names_array(snapshot), values)
    if expr["operator"] == "In":
        return hit
    if expr["operator"] == "NotIn":
        return ~hit
    return np.zeros(n, dtype=bool)


def node_selector_term_mask(snapshot, term: Mapping) -> np.ndarray:
    """bool[N] — vectorized match_node_selector_term (empty term matches
    nothing)."""
    exprs = term.get("matchExpressions") or []
    fields = term.get("matchFields") or []
    n = len(snapshot.node_names)
    if not exprs and not fields:
        return np.zeros(n, dtype=bool)
    mask = np.ones(n, dtype=bool)
    for e in exprs:
        mask &= node_selector_requirement_mask(snapshot, e)
    for f in fields:
        mask &= _node_field_requirement_mask(snapshot, f)
    return mask


def node_selector_mask(snapshot, node_selector: Optional[Mapping]) -> np.ndarray:
    """bool[N] — vectorized match_node_selector (OR over terms; nil matches
    everything, zero terms match nothing)."""
    n = len(snapshot.node_names)
    if node_selector is None:
        return np.ones(n, dtype=bool)
    terms = node_selector.get("nodeSelectorTerms") or []
    if not terms:
        return np.zeros(n, dtype=bool)
    mask = np.zeros(n, dtype=bool)
    for t in terms:
        mask |= node_selector_term_mask(snapshot, t)
    return mask


def selector_and_affinity_mask(snapshot, pod_spec: Mapping) -> np.ndarray:
    """bool[N] — vectorized pod_matches_node_selector_and_affinity."""
    n = len(snapshot.node_names)
    mask = np.ones(n, dtype=bool)
    for k, v in (pod_spec.get("nodeSelector") or {}).items():
        dom, vocab = snapshot.topology_domains(k)
        code = vocab.get(v)
        if code is None:
            return np.zeros(n, dtype=bool)
        mask &= dom == code
    affinity = (pod_spec.get("affinity") or {}).get("nodeAffinity") or {}
    required = affinity.get("requiredDuringSchedulingIgnoredDuringExecution")
    if required is not None:
        mask &= node_selector_mask(snapshot, required)
    return mask


def preferred_node_affinity_scores(snapshot, pod_spec: Mapping) -> np.ndarray:
    """f64[N] — vectorized preferred_node_affinity_score."""
    affinity = (pod_spec.get("affinity") or {}).get("nodeAffinity") or {}
    total = np.zeros(len(snapshot.node_names), dtype=np.float64)
    for pref in affinity.get(
            "preferredDuringSchedulingIgnoredDuringExecution") or []:
        term = pref.get("preference") or {}
        w = int(pref.get("weight", 0))
        if w:
            total += float(w) * node_selector_term_mask(snapshot, term)
    return total


# ---------------------------------------------------------------------------
# Taints & tolerations
# ---------------------------------------------------------------------------

def toleration_tolerates_taint(tol: Mapping, taint: Mapping) -> bool:
    """v1.Toleration.ToleratesTaint."""
    t_effect = tol.get("effect") or ""
    if t_effect and t_effect != taint.get("effect"):
        return False
    t_key = tol.get("key") or ""
    if t_key and t_key != taint.get("key"):
        return False
    op = tol.get("operator") or "Equal"
    if op == "Exists":
        return True
    if op == "Equal":
        return (tol.get("value") or "") == (taint.get("value") or "")
    return False


def find_matching_untolerated_taint(taints: Sequence[Mapping],
                                    tolerations: Sequence[Mapping],
                                    effects: Sequence[str]) -> Optional[Mapping]:
    """FindMatchingUntoleratedTaint restricted to the given effects.

    Returns the first taint (in node order) with an effect in `effects` that no
    toleration tolerates, or None.  The scheduler's Filter uses
    effects=('NoSchedule','NoExecute') (DoNotScheduleTaintsFilterFunc).
    """
    for taint in taints:
        if taint.get("effect") not in effects:
            continue
        if not any(toleration_tolerates_taint(t, taint) for t in tolerations):
            return taint
    return None


def count_intolerable_prefer_no_schedule(taints: Sequence[Mapping],
                                         tolerations: Sequence[Mapping]) -> int:
    """TaintToleration score raw value (taint_toleration.go:169-183): number of
    PreferNoSchedule taints not tolerated by the pod's tolerations that have
    empty or PreferNoSchedule effect."""
    prefer_tols = [t for t in tolerations
                   if not (t.get("effect") or "") or t.get("effect") == "PreferNoSchedule"]
    count = 0
    for taint in taints:
        if taint.get("effect") != "PreferNoSchedule":
            continue
        if not any(toleration_tolerates_taint(t, taint) for t in prefer_tols):
            count += 1
    return count

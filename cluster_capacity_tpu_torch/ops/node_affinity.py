"""NodeAffinity plugin: required match filter + preferred-term score precompute.

Reference: vendor/k8s.io/kubernetes/pkg/scheduler/framework/plugins/nodeaffinity/node_affinity.go:
- Filter (:147-215): spec.nodeSelector AND requiredDuringScheduling node
  affinity must match; reason "node(s) didn't match Pod's node affinity/selector".
- Score (:240-285): sum of weights of matching preferred terms; normalized with
  DefaultNormalizeScore(reverse=false).  PreScore returns Skip when the pod has
  no preferred terms (:246-249) — the plugin then contributes nothing.

Static per node; normalize happens on device per scan step.
"""

from __future__ import annotations

import numpy as np

from ..models.labels import (preferred_node_affinity_scores,
                             selector_and_affinity_mask)
from ..models.snapshot import ClusterSnapshot

REASON = "node(s) didn't match Pod's node affinity/selector"


def _required_key(spec: dict) -> str:
    """Canonical key of everything static_mask reads: spec.nodeSelector +
    requiredDuringScheduling node affinity."""
    import json
    affinity = ((spec.get("affinity") or {}).get("nodeAffinity") or {})
    return json.dumps(
        [spec.get("nodeSelector"),
         affinity.get("requiredDuringSchedulingIgnoredDuringExecution")],
        sort_keys=True)


def static_mask(snapshot: ClusterSnapshot, pod: dict) -> np.ndarray:
    """Memoized per (snapshot, canonical selector+required-affinity) — the
    sweep use case encodes many templates against one snapshot, and the
    spread encoder's nodeAffinityPolicy=Honor pass reuses the same mask."""
    spec = pod.get("spec") or {}
    return snapshot.memo(
        ("na_mask", _required_key(spec)),
        lambda: selector_and_affinity_mask(snapshot, spec))


def has_preferred_terms(pod: dict, added_affinity: dict = None) -> bool:
    """PreScore skips when neither the pod nor NodeAffinityArgs.addedAffinity
    carries preferred terms (node_affinity.go:246-249 + :98-106)."""
    affinity = ((pod.get("spec") or {}).get("affinity") or {}).get("nodeAffinity") or {}
    if affinity.get("preferredDuringSchedulingIgnoredDuringExecution"):
        return True
    return bool((added_affinity or {}).get(
        "preferredDuringSchedulingIgnoredDuringExecution"))


def static_raw_score(snapshot: ClusterSnapshot, pod: dict,
                     added_affinity: dict = None) -> np.ndarray:
    """Raw preferred-term score per node; NodeAffinityArgs.addedAffinity
    preferred terms score every pod of the profile on top of the pod's own
    (node_affinity.go:98-106 + :260-285)."""
    import json
    spec = pod.get("spec") or {}
    added = (added_affinity or {}).get(
        "preferredDuringSchedulingIgnoredDuringExecution")
    if added:
        spec = dict(spec)
        own = ((spec.get("affinity") or {}).get("nodeAffinity") or {}).get(
            "preferredDuringSchedulingIgnoredDuringExecution") or []
        affinity = dict(spec.get("affinity") or {})
        node_aff = dict(affinity.get("nodeAffinity") or {})
        node_aff["preferredDuringSchedulingIgnoredDuringExecution"] = \
            list(own) + list(added)
        affinity["nodeAffinity"] = node_aff
        spec["affinity"] = affinity
    merged = ((spec.get("affinity") or {}).get("nodeAffinity") or {}).get(
        "preferredDuringSchedulingIgnoredDuringExecution")
    key = ("na_raw", json.dumps(merged, sort_keys=True))
    return snapshot.memo(
        key, lambda: preferred_node_affinity_scores(snapshot, spec))

"""NodeUnschedulable plugin: reject cordoned nodes unless tolerated.

Reference: vendor/k8s.io/kubernetes/pkg/scheduler/framework/plugins/nodeunschedulable/node_unschedulable.go:120-145:
a node with spec.unschedulable fails unless the pod tolerates the
node.kubernetes.io/unschedulable:NoSchedule taint.
"""

from __future__ import annotations

import numpy as np

from ..models.labels import toleration_tolerates_taint
from ..models.podspec import pod_tolerations
from ..models.snapshot import ClusterSnapshot

REASON = "node(s) were unschedulable"

_UNSCHEDULABLE_TAINT = {"key": "node.kubernetes.io/unschedulable",
                        "effect": "NoSchedule"}


def static_mask(snapshot: ClusterSnapshot, pod: dict) -> np.ndarray:
    tols = pod_tolerations(pod)
    tolerated = any(toleration_tolerates_taint(t, _UNSCHEDULABLE_TAINT)
                    for t in tols)
    if tolerated:
        return np.ones(snapshot.num_nodes, dtype=bool)
    # pod-independent from here (cordon state): cached per snapshot
    return snapshot.node_memo(("unschedulable_mask",), lambda: np.asarray(
        [not snapshot.node_unschedulable(i)
         for i in range(snapshot.num_nodes)], dtype=bool))

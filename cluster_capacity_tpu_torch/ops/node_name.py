"""NodeName plugin: pod.Spec.NodeName equality filter.

Reference: vendor/k8s.io/kubernetes/pkg/scheduler/framework/plugins/nodename/node_name.go:72-80.
The mask depends only on static node identity, so it is precomputed on host.
"""

from __future__ import annotations

import numpy as np

from ..models.snapshot import ClusterSnapshot

REASON = "node(s) didn't match the requested node name"


def static_mask(snapshot: ClusterSnapshot, pod: dict) -> np.ndarray:
    want = (pod.get("spec") or {}).get("nodeName") or ""
    if not want:
        return np.ones(snapshot.num_nodes, dtype=bool)
    return np.asarray([name == want for name in snapshot.node_names], dtype=bool)

"""TaintToleration plugin: filter + score precompute.

Reference: vendor/k8s.io/kubernetes/pkg/scheduler/framework/plugins/tainttoleration/taint_toleration.go:
- Filter (:110-121): first untolerated NoSchedule/NoExecute taint rejects the
  node (UnschedulableAndUnresolvable) with reason
  "node(s) had untolerated taint {key: value}".
- Score (:169-195): count of PreferNoSchedule taints not tolerated; normalized
  with DefaultNormalizeScore(reverse=true) (:197-199) — the normalize runs over
  the per-cycle feasible set, so only the raw counts are static.

Both the mask and the raw score depend only on static node taints + the pod's
tolerations, so they are host precomputes; the reverse-normalize happens on
device each scan step.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..models.labels import (count_intolerable_prefer_no_schedule,
                             find_matching_untolerated_taint)
from ..models.podspec import pod_tolerations
from ..models.snapshot import ClusterSnapshot

_DO_NOT_SCHEDULE = ("NoSchedule", "NoExecute")


def _tols_key(tols) -> str:
    import json
    return json.dumps(tols, sort_keys=True)


def static_mask_and_reasons(snapshot: ClusterSnapshot, pod: dict
                            ) -> Tuple[np.ndarray, List[Optional[str]]]:
    """Returns (mask[N], per-node reason string or None).

    Reason strings carry the specific taint, mirroring the Filter message.
    Memoized per (snapshot, canonical tolerations): sweeps encode many
    templates, nearly all sharing the same (usually empty) toleration set."""
    tols = pod_tolerations(pod)

    def build():
        n = snapshot.num_nodes
        mask = np.ones(n, dtype=bool)
        reasons: List[Optional[str]] = [None] * n
        for i in range(n):
            taint = find_matching_untolerated_taint(
                snapshot.node_taints(i), tols, _DO_NOT_SCHEDULE)
            if taint is not None:
                mask[i] = False
                reasons[i] = (
                    "node(s) had untolerated taint "
                    f"{{{taint.get('key', '')}: {taint.get('value', '')}}}")
        return mask, tuple(reasons)

    mask, reasons = snapshot.node_memo(("taint_mask", _tols_key(tols)),
                                       build)
    # the memoized tuple is returned as-is (read-only by contract): copying
    # it to a fresh 50k-entry list per template was a measurable share of
    # sweep encode time
    return mask, reasons


def static_raw_score(snapshot: ClusterSnapshot, pod: dict) -> np.ndarray:
    """Raw score = count of intolerable PreferNoSchedule taints per node."""
    tols = pod_tolerations(pod)
    return snapshot.node_memo(
        ("taint_raw", _tols_key(tols)), lambda: np.asarray(
            [count_intolerable_prefer_no_schedule(snapshot.node_taints(i),
                                                  tols)
             for i in range(snapshot.num_nodes)], dtype=np.float64))

"""ImageLocality plugin: score nodes by present image bytes, spread-scaled.

Reference: vendor/k8s.io/kubernetes/pkg/scheduler/framework/plugins/imagelocality/image_locality.go:54-127:
- sumImageScores: for each pod container image present on the node, add
  imageSize * (numNodesWithImage / totalNodes).
- calculatePriority: clamp sum to [23Mi, 1000Mi * numContainers], scale to 0-100.
- no NormalizeScore.

Node image states never change during a simulation (binding does not pull
images in the fake cluster either), so the whole score is a host precompute.
"""

from __future__ import annotations

import numpy as np

from ..models.podspec import pod_images
from ..models.snapshot import ClusterSnapshot, _normalize_image

_MB = 1024 * 1024
MIN_THRESHOLD = 23 * _MB
MAX_CONTAINER_THRESHOLD = 1000 * _MB


def static_score(snapshot: ClusterSnapshot, pod: dict) -> np.ndarray:
    """Memoized per (snapshot, image multiset, container count) — identical
    for every template sharing an image list in a sweep."""
    n = snapshot.num_nodes
    images = [_normalize_image(im) for im in pod_images(pod)]
    spec = pod.get("spec") or {}
    num_containers = len(spec.get("containers") or []) + \
        len(spec.get("initContainers") or [])
    if not images or num_containers == 0 or n == 0:
        return np.zeros(n, dtype=np.float64)
    return snapshot.memo(("il", tuple(images), num_containers),
                         lambda: _score(snapshot, images, num_containers))


def _score(snapshot: ClusterSnapshot, images, num_containers) -> np.ndarray:
    n = snapshot.num_nodes
    node_images = snapshot.memo(
        ("node_images",),
        lambda: tuple(snapshot.node_images(i) for i in range(n)))
    num_nodes_with = {im: sum(1 for ni in node_images if im in ni)
                      for im in set(images)}

    scores = np.zeros(n, dtype=np.float64)
    max_threshold = MAX_CONTAINER_THRESHOLD * num_containers
    for i in range(n):
        total = 0
        for im in images:
            size = node_images[i].get(im)
            if size is not None:
                spread = num_nodes_with[im] / n
                total += int(size * spread)
        total = min(max(total, MIN_THRESHOLD), max_threshold)
        scores[i] = (100 * (total - MIN_THRESHOLD)) // (max_threshold - MIN_THRESHOLD)
    return scores

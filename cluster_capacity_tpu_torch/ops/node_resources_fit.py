"""NodeResourcesFit: the filter and the score helpers the fused step shares.

Reference semantics:
- Filter: vendor/k8s.io/kubernetes/pkg/scheduler/framework/plugins/noderesources/fit.go:564-660
  (fitsRequest): always check pod-count slot; each resource checked only when
  the pod requests it; insufficient reasons reported per resource.
- RequestedToCapacityRatio: requested_to_capacity_ratio.go:60 +
  helper.BuildBrokerFunction piecewise-linear shape.

The Least/Most/RTC and balanced-allocation scores themselves live in the
fused step (engine/fused.py and its CUDA kernel), which is the only place
this package computes them.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..models.snapshot import IDX_PODS

MAX_NODE_SCORE = 100.0


def _floor_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """Integer floor(num/den) computed in floats; exact when the inputs are
    exact integers in the dtype's range."""
    return torch.floor(num / torch.clamp(den, min=1e-30))


class FitVerdict(NamedTuple):
    mask: torch.Tensor           # bool[N] — node passes the fit filter
    insufficient: torch.Tensor   # bool[N, R] — per-resource "Insufficient X"
    too_many_pods: torch.Tensor  # bool[N] — "Too many pods"


def fit_filter(allocatable: torch.Tensor, requested: torch.Tensor,
               req_vec: torch.Tensor) -> FitVerdict:
    """fitsRequest over all nodes.

    allocatable, requested: [N, R]; req_vec: [R] with req_vec[IDX_PODS]
    ignored (the pod-count check is always `pods_on_node + 1 > allowed`).
    """
    too_many = requested[:, IDX_PODS] + 1.0 > allocatable[:, IDX_PODS]
    free = allocatable - requested
    pos = req_vec > 0
    insufficient = (req_vec[None, :] > free) & pos[None, :]
    insufficient[:, IDX_PODS] = False
    mask = ~(too_many | insufficient.any(dim=1))
    return FitVerdict(mask=mask, insufficient=insufficient,
                      too_many_pods=too_many)


def piecewise_segments(shape_utilization: Sequence[float],
                       shape_score: Sequence[float]
                       ) -> List[Tuple[float, float, float, float, float]]:
    """helper.BuildBrokenLinearFunction (shape_score.go:40-53) as float32
    constants: one (x_lo, x_hi, y_lo, dy, dx) row per segment, each value
    rounded to float32 exactly where the JAX step rounds it (the products
    are formed in float64 on the host, then used as float32 literals)."""
    xs = [float(x) for x in shape_utilization]
    ys = [float(y) * 10.0 for y in shape_score]
    f32 = lambda v: float(np.float32(v))
    out = []
    for i in range(1, len(xs)):
        dx = xs[i] - xs[i - 1]
        out.append((f32(xs[i - 1]), f32(xs[i]), f32(ys[i - 1]),
                    f32(ys[i] - ys[i - 1]), f32(dx if dx else 1.0)))
    return out

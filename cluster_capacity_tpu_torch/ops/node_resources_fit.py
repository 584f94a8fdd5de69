"""NodeResourcesFit: the filter and the score helpers the fused step shares.

Reference semantics:
- Filter: vendor/k8s.io/kubernetes/pkg/scheduler/framework/plugins/noderesources/fit.go:564-660
  (fitsRequest): always check pod-count slot; each resource checked only when
  the pod requests it; insufficient reasons reported per resource.
- LeastAllocated score: least_allocated.go:30-60
  floor((cap-req)*100/cap) per resource, weighted integer mean.
- MostAllocated score: most_allocated.go:30-65 (mirror, req clamped to cap).
- RequestedToCapacityRatio: requested_to_capacity_ratio.go:60 +
  helper.BuildBrokerFunction piecewise-linear shape.

The score functions below take [..., K] strategy-resource views and reduce
over the trailing axis; the scan step (engine/simulator.py) calls them on
[N, K] and the closed-form fast path (engine/fast_path.py) on [N, Kc, K]
and [B, N, Kc, K] operands.  Their op order is the JAX package's, with
trailing-axis sums written as left folds, and they compute in the input's
dtype, so the float32 and the float64 (parity) results are bit-identical;
balanced_allocation_score takes any number of resources.  The fused kernel
computes the same float32 scores per node inside engine/fused.py and its
CUDA kernel.
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


def _fold_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the trailing axis as a left fold (x0 + x1) + x2 ..."""
    acc = x[..., 0]
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """v as a 0-d tensor of like's dtype and device, made by a fill on the
    device (no host copy, so a CUDA graph can capture it)."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


def least_allocated_score(alloc: torch.Tensor, req_with_pod: torch.Tensor,
                          weights: torch.Tensor) -> torch.Tensor:
    """leastResourceScorer over [..., K] strategy-resource views; weights
    [K].  Resources with alloc == 0 drop out of the weighted mean."""
    zero = _scalar(0.0, alloc)
    valid = alloc > 0
    over = req_with_pod > alloc
    per_res = torch.where(over, zero, _floor_div(
        (alloc - req_with_pod) * MAX_NODE_SCORE, alloc))
    per_res = torch.where(valid, per_res, zero)
    wsum = _fold_sum(torch.where(valid, weights, zero))
    total = _fold_sum(per_res * weights)
    return torch.where(wsum > 0, _floor_div(total, wsum), zero)


def most_allocated_score(alloc: torch.Tensor, req_with_pod: torch.Tensor,
                         weights: torch.Tensor) -> torch.Tensor:
    """mostResourceScorer: requested clamped to capacity."""
    zero = _scalar(0.0, alloc)
    valid = alloc > 0
    req = torch.minimum(req_with_pod, alloc)
    per_res = torch.where(valid, _floor_div(req * MAX_NODE_SCORE, alloc),
                          zero)
    wsum = _fold_sum(torch.where(valid, weights, zero))
    total = _fold_sum(per_res * weights)
    return torch.where(wsum > 0, _floor_div(total, wsum), zero)


def piecewise_shape(util: torch.Tensor, shape_utilization: Sequence[float],
                    shape_score: Sequence[float]) -> torch.Tensor:
    """helper.BuildBrokenLinearFunction (shape_score.go:40-53) on util's
    dtype, the segment quotient divided by a tensor."""
    xs = [float(x) for x in shape_utilization]
    ys = [float(y) * 10.0 for y in shape_score]
    out = torch.full_like(util, ys[0])
    for i in range(1, len(xs)):
        dx = xs[i] - xs[i - 1]
        q = (ys[i] - ys[i - 1]) * (util - xs[i - 1]) \
            / _scalar(dx if dx else 1.0, util)
        seg = ys[i - 1] + torch.trunc(q)
        out = torch.where((util > xs[i - 1]) & (util <= xs[i]), seg, out)
    return torch.where(util > xs[-1], _scalar(ys[-1], util), out)


def requested_to_capacity_ratio_score(alloc: torch.Tensor,
                                      req_with_pod: torch.Tensor,
                                      weights: torch.Tensor,
                                      shape_utilization: Sequence[float],
                                      shape_score: Sequence[float]
                                      ) -> torch.Tensor:
    """requestedToCapacityRatioScorer: a resource's weight counts only when
    its shaped score is > 0, and the mean is math.Round-ed
    (requested_to_capacity_ratio.go:48-56)."""
    zero = _scalar(0.0, alloc)
    valid = alloc > 0
    util = torch.where(valid, _floor_div(req_with_pod * MAX_NODE_SCORE,
                                         alloc), zero)
    per_res = torch.trunc(piecewise_shape(util, shape_utilization,
                                          shape_score))
    per_res = torch.where(valid, per_res, zero)
    counted = valid & (per_res > 0)
    wsum = _fold_sum(torch.where(counted, weights, zero))
    total = _fold_sum(per_res * weights)
    return torch.where(wsum > 0, torch.floor(
        total / torch.clamp(wsum, min=1e-30) + 0.5), zero)


def balanced_allocation_score(alloc: torch.Tensor,
                              req_with_pod: torch.Tensor) -> torch.Tensor:
    """NodeResourcesBalancedAllocation (balanced_allocation.go:146-182):
    fraction clamped to 1, population std over the valid resources,
    trunc((1-std)*100)."""
    zero = _scalar(0.0, alloc)
    one = _scalar(1.0, alloc)
    valid = alloc > 0
    frac = torch.where(valid, torch.minimum(
        req_with_pod / torch.clamp(alloc, min=1e-30), one), zero)
    n_valid = _fold_sum(valid.to(alloc.dtype))
    count = torch.clamp(n_valid, min=1.0)
    mean = _fold_sum(frac) / count
    d = frac - mean[..., None]
    var = _fold_sum(torch.where(valid, d * d, zero)) / count
    std = torch.where(n_valid >= 2, torch.sqrt(var), zero)
    return torch.trunc((1.0 - std) * MAX_NODE_SCORE)


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

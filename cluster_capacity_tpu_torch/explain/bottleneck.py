"""Bottleneck analysis: which resource dimension binds first, per node and
cluster-wide.

Pure host numpy over the fit encodings (mirrors fast_path._per_node_caps
arithmetic exactly): no device work, so it is safe to call from any surface
(CLI, report) without touching the card.

The marginal-capacity table answers the paper's binding-constraints question
directly: "adding X of resource R to every node yields +K placements", where
X is one clone's request of R (so the per-node cap along that dimension
rises by exactly 1) and K is the resulting gain in the min-fold capacity.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..engine import encode as enc
from ..models.snapshot import IDX_PODS


def _cap_components(pb: enc.EncodedProblem) -> Dict[str, np.ndarray]:
    """Per-dimension placement caps, keyed by dimension name.  The min over
    dimensions reproduces fast_path._per_node_caps on eligible nodes."""
    free = pb.allocatable - pb.init_requested
    comps: Dict[str, np.ndarray] = {
        "pods": np.maximum(pb.allocatable[:, IDX_PODS]
                           - pb.init_requested[:, IDX_PODS], 0.0),
    }
    if pb.profile.filter_enabled("NodeResourcesFit"):
        for j, rname in enumerate(pb.resource_names):
            if j != IDX_PODS and pb.req_vec[j] > 0:
                comps[rname] = np.floor(
                    np.maximum(free[:, j], 0.0) / pb.req_vec[j])
    return comps


def bottleneck_analysis(pb: enc.EncodedProblem,
                        max_nodes: int = 0) -> Optional[dict]:
    """Binding dimension per node + cluster marginal capacity.

    max_nodes controls the optional perNode detail list: 0 omits it (the
    default for report embedding), > 0 caps it, < 0 includes every node.
    Returns None when the fit filter is off (no safe capacity bound exists,
    mirroring _per_node_caps' zero-cap degenerate branch).
    """
    if not pb.profile.filter_enabled("NodeResourcesFit"):
        return None

    n = pb.snapshot.num_nodes
    comps = _cap_components(pb)
    names = list(comps.keys())
    mat = np.stack([comps[k] for k in names], axis=0)       # [D, N]
    eligible = pb.static_mask & pb.volume_mask
    caps = np.where(eligible, mat.min(axis=0), 0.0)
    # dimension achieving the min (first in order on ties) per node
    argmin = np.argmin(mat, axis=0)

    binding = []
    for i in range(n):
        if not eligible[i]:
            binding.append("filtered")
        elif pb.clone_has_host_ports and caps[i] >= 1:
            # host-port conflict caps every node at one clone regardless of
            # how much resource headroom remains
            binding.append("ports")
        else:
            binding.append(names[argmin[i]])
    binding_counts: Dict[str, int] = {}
    for b in binding:
        binding_counts[b] = binding_counts.get(b, 0) + 1

    total = int(caps.sum())
    marginal = {}
    for k in names:
        bumped = dict(comps)
        bumped[k] = comps[k] + 1.0   # +1 cap: exactly one clone's worth of k
        mat2 = np.stack([bumped[x] for x in names], axis=0)
        caps2 = np.where(eligible, mat2.min(axis=0), 0.0)
        gain = int(caps2.sum() - caps.sum())
        if k == "pods":
            add_per_node = 1.0
        else:
            add_per_node = float(pb.req_vec[pb.resource_names.index(k)])
        marginal[k] = {"addPerNode": add_per_node, "extraPlacements": gain}

    out = {
        "totalCapacity": total,
        "bindingCounts": dict(sorted(binding_counts.items())),
        "marginal": marginal,
    }
    if max_nodes:
        limit = n if max_nodes < 0 else min(max_nodes, n)
        out["perNode"] = [
            {"node": pb.snapshot.node_names[i], "binding": binding[i],
             "cap": int(caps[i])}
            for i in range(limit)]
    return out

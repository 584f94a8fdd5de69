"""Host-side attribution artifacts.

Everything here consumes plain numpy arrays that a solver already read back
from the device at its own sync points; no function in this module touches
a tensor.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..engine import encode as enc

# Canonical plugin order for why-here attribution columns.  This is the
# score-fold order of simulator._score_terms; rungs that cannot produce a
# given term (e.g. the fast path never runs spread/IPA — ineligible) emit a
# zero column so the artifact shape is rung-independent.
PLUGINS = (
    "NodeResourcesFit",
    "NodeResourcesBalancedAllocation",
    "TaintToleration",
    "NodeAffinity",
    "ImageLocality",
    "PodTopologySpread",
    "InterPodAffinity",
)


@dataclass
class Explanation:
    """Attribution artifact attached to a SolveResult (result.explain).

    why_here   — f64[placements, len(plugins)]: weighted per-plugin score
                 contribution of the chosen node at each placement step.
    final_codes / elim_step / elim_code — i32[N] why-not tensors: the reason
                 code per node at the terminal state, the step at which each
                 node was first eliminated (-1 = never), and the code it was
                 first eliminated with (0 = never).
    reason_histogram — terminal codes expanded to diagnose()-compatible
                 reason strings, counted over ALL nodes.
    """

    plugins: List[str]
    why_here: Optional[np.ndarray] = None
    final_codes: Optional[np.ndarray] = None
    elim_step: Optional[np.ndarray] = None
    elim_code: Optional[np.ndarray] = None
    reason_histogram: Dict[str, int] = field(default_factory=dict)
    feasible_nodes: int = 0
    bottleneck: Optional[dict] = None
    rung: str = ""

    def to_dict(self) -> dict:
        def _ints(a):
            return None if a is None else [int(x) for x in a]

        return {
            "plugins": list(self.plugins),
            "whyHere": None if self.why_here is None
            else [[float(x) for x in row] for row in self.why_here],
            "finalCodes": _ints(self.final_codes),
            "elimStep": _ints(self.elim_step),
            "elimCode": _ints(self.elim_code),
            "reasons": {k: int(v) for k, v in sorted(
                self.reason_histogram.items())},
            "feasibleNodes": int(self.feasible_nodes),
            "bottleneck": self.bottleneck,
            "rung": self.rung,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Explanation":
        def _arr(key, dtype):
            v = d.get(key)
            return None if v is None else np.asarray(v, dtype=dtype)

        return cls(
            plugins=list(d.get("plugins", PLUGINS)),
            why_here=_arr("whyHere", np.float64),
            final_codes=_arr("finalCodes", np.int32),
            elim_step=_arr("elimStep", np.int32),
            elim_code=_arr("elimCode", np.int32),
            reason_histogram={k: int(v)
                              for k, v in (d.get("reasons") or {}).items()},
            feasible_nodes=int(d.get("feasibleNodes", 0)),
            bottleneck=d.get("bottleneck"),
            rung=d.get("rung", ""),
        )


def reason_histogram(pb: enc.EncodedProblem, codes: np.ndarray,
                     insufficient: Optional[np.ndarray] = None,
                     too_many: Optional[np.ndarray] = None) -> Dict[str, int]:
    """Expand terminal per-node reason codes into the same reason-string
    vocabulary simulator.diagnose() emits, counted over all nodes.

    Mirrors diagnose() exactly: taint/volume codes expand through the
    per-node string lists; fit expands into "Too many pods" plus per-resource
    "Insufficient <r>" lines (a node can contribute several), with
    DRA-prefixed virtual columns aggregated into the single
    cannot-allocate-claims reason.  At a terminal (exhausted) carry this
    histogram is equal to diagnose()'s fail_counts — pinned by test.
    """
    from ..ops.dynamic_resources import (DRA_RESOURCE_PREFIX,
                                         REASON_CANNOT_ALLOCATE)

    counts: Dict[str, int] = {}

    def add(reason: str, k: int = 1) -> None:
        if k:
            counts[reason] = counts.get(reason, 0) + int(k)

    for code in np.unique(codes[codes != enc.CODE_OK]):
        code = int(code)
        idxs = np.flatnonzero(codes == code)
        if code == enc.CODE_TAINT:
            for i in idxs:
                add(pb.taint_reasons[i] or "node(s) had untolerated taint")
        elif code == enc.CODE_VOLUME:
            for i in idxs:
                add(pb.volume_reasons[i] or "volume conflict")
        elif code == enc.CODE_FIT:
            take = codes == enc.CODE_FIT
            if too_many is not None:
                add("Too many pods", int(np.sum(take & too_many)))
            if insufficient is not None \
                    and insufficient.shape[1] == len(pb.resource_names):
                dra_cols = [j for j, rn in enumerate(pb.resource_names)
                            if rn.startswith(DRA_RESOURCE_PREFIX)]
                dra_set = set(dra_cols)
                for j, rname in enumerate(pb.resource_names):
                    if j in dra_set:
                        continue
                    add("Insufficient %s" % rname,
                        int(np.sum(take & insufficient[:, j])))
                if dra_cols:
                    dra_any = insufficient[:, dra_cols].any(axis=1)
                    add(REASON_CANNOT_ALLOCATE, int(np.sum(take & dra_any)))
        else:
            add(enc.STATIC_REASONS.get(code, "reason code %d" % code),
                len(idxs))
    return counts


def node_reason(pb: enc.EncodedProblem, code: int, i: int) -> str:
    """Single human-readable reason string for node `i` eliminated with
    `code` ('' when the node is feasible).  Per-node variants (taint /
    volume) read the encoded string lists; fit collapses to a generic
    line — the per-resource expansion needs the insufficient matrix and
    lives in reason_histogram()."""
    code = int(code)
    if code == enc.CODE_OK:
        return ""
    if code == enc.CODE_TAINT:
        return pb.taint_reasons[i] or "node(s) had untolerated taint"
    if code == enc.CODE_VOLUME:
        return pb.volume_reasons[i] or "volume conflict"
    if code == enc.CODE_FIT:
        return "Insufficient resources"
    return enc.STATIC_REASONS.get(code, "reason code %d" % code)


def build_explanation(pb: enc.EncodedProblem, *,
                      why_here: Optional[np.ndarray] = None,
                      final_codes: Optional[np.ndarray] = None,
                      elim_step: Optional[np.ndarray] = None,
                      elim_code: Optional[np.ndarray] = None,
                      insufficient: Optional[np.ndarray] = None,
                      too_many: Optional[np.ndarray] = None,
                      histogram: Optional[Dict[str, int]] = None,
                      feasible_nodes: Optional[int] = None,
                      rung: str = "",
                      with_bottleneck: bool = True) -> Explanation:
    """Assemble an Explanation from host arrays.  (The JAX package also
    records its cc_explain* metrics here; they arrive with the port's obs/
    slice.)

    `histogram` overrides the code expansion (the oracle rung counts reason
    strings directly); otherwise it is derived from `final_codes`.
    """
    if histogram is None:
        histogram = ({} if final_codes is None
                     else reason_histogram(pb, final_codes,
                                           insufficient, too_many))
    if feasible_nodes is not None:
        feasible = int(feasible_nodes)
    else:
        feasible = (0 if final_codes is None
                    else int(np.sum(final_codes == enc.CODE_OK)))
    bn = None
    if with_bottleneck:
        from .bottleneck import bottleneck_analysis
        bn = bottleneck_analysis(pb)
    return Explanation(
        plugins=list(PLUGINS),
        why_here=why_here,
        final_codes=final_codes,
        elim_step=elim_step,
        elim_code=elim_code,
        reason_histogram=histogram,
        feasible_nodes=feasible,
        bottleneck=bn,
        rung=rung,
    )

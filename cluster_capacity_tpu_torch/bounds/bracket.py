"""Capacity bracketing on the host: a fractional upper bound and a
constructive lower bound per encoded problem, in float64 numpy.

- *Upper bound*: the LP-style fractional relaxation of the fit encodings —
  per-node headroom / per-clone demand, min over resource dimensions and
  pod slots — tightened by the per-node integer floor (no schedule places
  more than floor(headroom/demand) clones on a node) and by every hard
  topology-spread constraint folded as a row cap over its domain
  capacities.
- *Lower bound*: with a single template and no dynamic gate beyond the fit
  filter, the per-node floors are a feasible schedule.

The floors share fast_path._per_node_caps's float64 formula bit for bit, so
for fit-only problems the bracket is the engine's own arithmetic.  For
fit-only shapes with an order-independent terminal (`exact_capacity`) the
greedy capacity equals the sum of per-node caps whatever the scoring
order, and the terminal FitError histogram is a pure function of the caps
(`exhausted_fit_counts`).

The engine's budget clamps (simulator.solve, parallel.sweep._batched_solve)
read `upper_bound_host`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from ..engine import encode as enc
from ..engine import simulator as sim
from ..models.snapshot import IDX_PODS

# No finite bound exists (fit filter off: nothing limits placements).  It
# equals the engine's unlimited budget cap, so a bracket never promises
# more than the engine could count.
UNBOUNDED = sim._DEFAULT_UNLIMITED_CAP


@dataclass(frozen=True)
class CapacityBracket:
    """lower <= true greedy capacity <= upper.  `frac` keeps the raw LP
    relaxation value (pre-floor); `exact` records that the problem met the
    `exact_capacity` gates, under which `tight` brackets equal the engine's
    placed count."""

    lower: int
    upper: int
    exact: bool
    frac: float = 0.0
    method: str = "frac+ffd"

    @property
    def tight(self) -> bool:
        return self.exact and self.lower == self.upper


def _free_matrix(pb: enc.EncodedProblem) -> np.ndarray:
    snap = pb.snapshot
    if pb.allocatable is getattr(snap, "allocatable", None) \
            and pb.init_requested is getattr(snap, "requested", None):
        # snapshot-owned arrays: one subtraction per snapshot
        return snap.memo(("free_matrix",),
                         lambda: pb.allocatable - pb.init_requested)
    return pb.allocatable - pb.init_requested


def _host_planes(pb: enc.EncodedProblem) -> Tuple[np.ndarray, np.ndarray]:
    """(frac, gate): per-node fractional fit headroom (float64, pre-floor)
    and the static & volume gate."""
    free = _free_matrix(pb)
    frac = np.maximum(pb.allocatable[:, IDX_PODS]
                      - pb.init_requested[:, IDX_PODS], 0.0).astype(np.float64)
    for j in range(pb.req_vec.shape[0]):
        if j != IDX_PODS and pb.req_vec[j] > 0:
            frac = np.minimum(frac, np.maximum(free[:, j], 0.0)
                              / pb.req_vec[j])
    gate = np.asarray(pb.static_mask) & np.asarray(pb.volume_mask)
    return np.where(gate, frac, 0.0), gate


def _fit_only(pb: enc.EncodedProblem) -> bool:
    """No dynamic gate beyond NodeResourcesFit: greedy capacity equals the
    sum of per-node fit caps whatever the scoring order, so the per-node
    floors double as a constructive (lower-bound) schedule."""
    return (pb.profile.filter_enabled("NodeResourcesFit")
            and not pb.profile.extenders
            and pb.pod_level_reason is None
            and not pb.clone_has_host_ports
            and not pb.volume_self_conflict
            and not pb.rwop_self_conflict
            and not pb.dra_shared_colocate
            and not np.asarray(pb.shared_req_vec).any()
            and pb.spread_hard.num_constraints == 0
            and not pb.ipa.active
            and not np.asarray(pb.ipa.existing_anti_static).any())


def exact_capacity(pb: enc.EncodedProblem) -> bool:
    """Gates under which lower == upper is provable and the terminal fail
    message is recomputable on the host: fit-only capacity plus an order-
    independent terminal (deterministic profile, full sampling)."""
    profile = pb.profile
    return (_fit_only(pb)
            and profile.deterministic
            and not profile.adaptive_sampling
            and profile.percentage_of_nodes_to_score >= 100
            and sim._num_feasible_nodes_to_find(profile, pb.num_alive) == 0)


def _spread_fold_host(pb: enc.EncodedProblem, caps_up: np.ndarray) -> float:
    """Every hard spread constraint folded as a row cap on the upper bound.

    Self-matching constraints evolve with placements: with m = min over
    valid domains of (existing + domain capacity) — an overestimate of the
    final global min — a domain d can absorb at most
    max(0, m + maxSkew - existing_d) clones, capped by the domain's fit
    capacity; nodes missing the key are infeasible.  Constraints the clone
    does not match keep static counts, so the fold is the initial violation
    mask.  minDomains above the valid-domain count zeroes the min term, as
    ops/pod_topology_spread.hard_filter does."""
    sh = pb.spread_hard
    if sh.num_constraints == 0:
        return float("inf")
    dom = np.asarray(sh.node_domain)
    e = np.asarray(sh.init_counts, dtype=np.float64)
    valid = np.asarray(sh.domain_valid)
    best = float("inf")
    for c in range(sh.num_constraints):
        keyed = dom[c] >= 0
        d_idx = np.clip(dom[c], 0, max(e.shape[1] - 1, 0))
        cap_d = np.zeros(e.shape[1])
        np.add.at(cap_d, d_idx[keyed], caps_up[keyed])
        ndom = int(valid[c].sum())
        skew = float(sh.max_skew[c])
        enough = ndom >= float(sh.min_domains[c])
        if bool(sh.self_match[c]):
            m = float(np.min(np.where(valid[c], e[c] + cap_d, np.inf))) \
                if ndom else 0.0
            m_eff = m if enough else 0.0
            allow = np.maximum(m_eff + skew - e[c], 0.0)
            fold = float(np.sum(np.where(valid[c],
                                         np.minimum(cap_d, allow), cap_d)))
        else:
            m_e = float(np.min(np.where(valid[c], e[c], np.inf))) \
                if ndom else 0.0
            m_eff = m_e if enough else 0.0
            ok = keyed & ~((e[c][d_idx] - m_eff) > skew)
            fold = float(np.sum(caps_up[ok]))
        best = min(best, fold)
    return best


def bracket_host(pb: enc.EncodedProblem) -> CapacityBracket:
    """The bracket of one problem, float64 numpy."""
    if pb.pod_level_reason is not None:
        return CapacityBracket(0, 0, exact=False, method="pod_level")
    if not pb.profile.filter_enabled("NodeResourcesFit"):
        return CapacityBracket(0, UNBOUNDED, exact=False, method="no_fit")
    frac, _gate = _host_planes(pb)
    caps = np.floor(frac)                 # == fast_path._per_node_caps
    upper = float(np.sum(caps))
    lower = upper
    upper = min(upper, _spread_fold_host(pb, caps))
    if not _fit_only(pb):
        # a dynamic gate (spread / IPA / self-conflict / ...) can block
        # placements the relaxation admits: the upper bound stays valid,
        # the constructive per-node lower does not
        lower = 0.0
    lower = min(lower, upper)
    return CapacityBracket(int(min(lower, UNBOUNDED)),
                           int(min(upper, UNBOUNDED)),
                           exact=exact_capacity(pb),
                           frac=float(np.sum(frac)))


def upper_bound_host(pb: enc.EncodedProblem) -> int:
    """Fit + spread upper bound for budget right-sizing (host, float64).
    Always >= the true capacity; UNBOUNDED when no finite bound exists."""
    return bracket_host(pb).upper


def exhausted_fit_counts(pb: enc.EncodedProblem
                         ) -> Optional[Dict[str, int]]:
    """The FitError reason histogram at the caps-exhausted terminal of an
    `exact_capacity` problem, recomputed on the host: the terminal requested
    plane is init + caps * req whatever the placement order, so the counts —
    and simulator.format_fit_error's message — match what the engine's
    diagnose() reports.  None when a node is still feasible there."""
    n = pb.snapshot.num_nodes
    frac, _gate = _host_planes(pb)
    caps = np.floor(frac)
    term_req = pb.init_requested + caps[:, None] * pb.req_vec[None, :]

    counts: Dict[str, int] = {}

    def add(reason: str, k: int = 1):
        if k:
            counts[reason] = counts.get(reason, 0) + int(k)

    remaining = np.ones(n, dtype=bool)
    static_code = np.asarray(pb.static_code)
    static_fail = static_code != enc.CODE_OK
    for code in np.unique(static_code[static_fail]):
        idxs = np.flatnonzero(static_code == code)
        if int(code) == enc.CODE_TAINT:
            for i in idxs:
                add(pb.taint_reasons[i] or "node(s) had untolerated taint")
        else:
            add(enc.STATIC_REASONS[int(code)], len(idxs))
    remaining &= ~static_fail

    # fit at the terminal plane, ops/node_resources_fit.fit_filter's rule
    too_many = term_req[:, IDX_PODS] + 1.0 > pb.allocatable[:, IDX_PODS]
    free = pb.allocatable - term_req
    insufficient = ((pb.req_vec[None, :] > free)
                    & (pb.req_vec > 0)[None, :])
    insufficient[:, IDX_PODS] = False
    fit_fail = too_many | insufficient.any(axis=1)
    take = remaining & fit_fail
    if take.any():
        add("Too many pods", int((take & too_many).sum()))
        dra_cols = [j for j, rn in enumerate(pb.resource_names)
                    if rn.startswith(sim.DRA_RESOURCE_PREFIX)]
        for j, rname in enumerate(pb.resource_names):
            if j in dra_cols:
                continue
            add(f"Insufficient {rname}",
                int((take & insufficient[:, j]).sum()))
        if dra_cols:
            dra_any = np.logical_or.reduce(
                [insufficient[:, j] for j in dra_cols])
            add(sim.REASON_CANNOT_ALLOCATE, int((take & dra_any).sum()))
    remaining &= ~take

    take = remaining & ~np.asarray(pb.volume_mask)
    for i in np.flatnonzero(take):
        add(pb.volume_reasons[i] or "volume conflict")
    remaining &= ~take

    if remaining.any():
        # a still-feasible node contradicts exhaustion
        return None
    return counts

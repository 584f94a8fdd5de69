"""Capacity bracketing: a fractional upper bound and a constructive lower
bound per encoded problem, on the host in float64 numpy and on the device
in one batched float32 shot.

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

The device half (`bracket_device`, under `bracket_group`) stacks the fit
and hard-spread planes of a batch of problems on a leading axis padded to a
power of two and computes the same bounds with plain torch ops in float32,
the JAX package's vmapped bracket kernel op for op (its float32 `_BIG`
sentinel included).  A rounding flip across an integer boundary is possible
in float32, so `bracket_group` holds every device shot against
`bracket_host` and serves the host brackets, stamped degraded, on any
mismatch: resilience/analyzer.py prunes scenario rows only on brackets that
equal the float64 ones.

Template mixes racing for one snapshot (parallel/interleave.py) get a joint
bracket from `bracket_mix`: the solo uppers summed and capped by the pooled
pod slots, and a K-round auction (`auction_device`, plain float32 torch
ops, held against its float64 host mirror) as the lower bound.

Over a device mesh (parallel/mesh.py) the device shot pads the batch and
node axes to the shard multiples, splits the batch across the mesh rows and
the node planes across the row's shards; each shard sums its nodes and the
shards' partials add up in shard order.  Every sum but the LP value `frac`
adds integers, so `lower` and `upper` are the unsharded shot's exactly;
`frac` (a float32 sum over the nodes) agrees within a few float32 ulps.
The auction shards its nodes the same way; its claim totals are integer
sums, so its claims are the unsharded auction's exactly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..engine import encode as enc
from ..engine import simulator as sim
from ..models.snapshot import IDX_PODS

# No finite bound exists (fit filter off: nothing limits placements).  It
# equals the engine's unlimited budget cap, so a bracket never promises
# more than the engine could count.
UNBOUNDED = sim._DEFAULT_UNLIMITED_CAP

_BIG = np.float32(3.0e38)


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


# --------------------------------------------------------------------------
# the device shot
# --------------------------------------------------------------------------

def _quantize_batch(b: int) -> int:
    """Pad the scenario/template axis to a power of two (the JAX package
    pads so varying batch sizes share a few compiled kernels; the padded
    rows are all-infeasible and never read)."""
    out = 1
    while out < b:
        out *= 2
    return out


def _node_sums(free, req, pods_free, gate, dom, e, valid, skew, mindom,
               num_constraints: int, num_domains: int):
    """The node-axis sums of the bracket over the nodes these planes hold:
    (floors summed [B], LP value [B], per-domain floors [B, C, D] and the
    static-skew floors [B, C], the last two None without hard spread
    constraints).  Shapes as _bracket_runner's."""
    big = torch.full((), float(_BIG), dtype=torch.float32, device=free.device)
    zero = torch.zeros((), dtype=torch.float32, device=free.device)
    one = torch.ones((), dtype=torch.float32, device=free.device)
    pos = req > 0
    ratio = torch.where(pos[:, None, :],
                        torch.maximum(free, zero)
                        / torch.where(pos, req, one)[:, None, :], big)
    frac = torch.minimum(ratio.amin(dim=2), torch.maximum(pods_free, zero))
    frac = torch.where(gate, torch.maximum(frac, zero), zero)
    up = torch.floor(frac)
    upper = up.sum(dim=1)
    lp = frac.sum(dim=1)
    if not num_constraints:
        return upper, lp, None, None
    onehot = dom[:, :, :, None] == torch.arange(
        num_domains, dtype=dom.dtype, device=dom.device)
    cap_d = torch.where(onehot, up[:, None, :, None], zero).sum(dim=2)
    enough = valid.sum(dim=2).to(torch.float32) >= mindom
    m_e = torch.where(valid, e, big).amin(dim=2)
    me_eff = torch.where(enough, m_e, zero)
    e_at = torch.gather(e, 2, dom.clamp(0, num_domains - 1).long())
    ok = (dom >= 0) & ~((e_at - me_eff[:, :, None]) > skew[:, :, None])
    stat = torch.where(ok, up[:, None, :], zero).sum(dim=2)
    return upper, lp, cap_d, stat


def _fold(upper, cap_d, stat, e, valid, skew, mindom, selfm):
    """(lower, upper) from the node sums: every hard spread constraint
    folded as a row cap over its domain capacities."""
    lower = upper
    if cap_d is None:
        return lower, upper
    big = torch.full((), float(_BIG), dtype=torch.float32,
                     device=upper.device)
    zero = torch.zeros((), dtype=torch.float32, device=upper.device)
    enough = valid.sum(dim=2).to(torch.float32) >= mindom
    m = torch.where(valid, e + cap_d, big).amin(dim=2)
    m_eff = torch.where(enough, m, zero)
    allow = torch.maximum(m_eff[:, :, None] + skew[:, :, None] - e, zero)
    dyn = torch.where(valid, torch.minimum(cap_d, allow), cap_d).sum(dim=2)
    fold = torch.where(selfm, dyn, stat).amin(dim=1)
    upper = torch.minimum(upper, fold)
    lower = torch.minimum(lower, upper)
    return lower, upper


def _bracket_runner(free, req, pods_free, gate, dom, e, valid, skew,
                    mindom, selfm, num_constraints: int, num_domains: int):
    """The bracket of every row of the stacked planes, float32 torch ops:
    free [B, N, R], req [B, R], pods_free [B, N], gate [B, N] bool; with
    `num_constraints` hard spread rows dom [B, C, N] int32, e / valid
    [B, C, D], skew / mindom / selfm [B, C].  Returns (lower, upper, lp),
    each [B] float32 — the JAX package's vmapped `one` op for op."""
    upper, lp, cap_d, stat = _node_sums(free, req, pods_free, gate, dom, e,
                                        valid, skew, mindom, num_constraints,
                                        num_domains)
    lower, upper = _fold(upper, cap_d, stat, e, valid, skew, mindom, selfm)
    return lower, upper, lp


def _bracket_sharded(mesh, dev, arrays, num_constraints: int,
                     num_domains: int):
    """The shot over a mesh: `arrays` (_bracket_runner's planes, numpy)
    padded to the shard multiples (pad scenarios all-infeasible, pad nodes
    gate-False and domainless: zero capacity), the batch split across the
    mesh rows, each row's node planes across its shards; the shards' sums
    add up in shard order on the lead device.  Returns numpy (lower, upper,
    lp) over the padded batch."""
    from ..parallel import mesh as mesh_lib

    mesh_lib.check_device(mesh, dev)
    free, req, pods_free, gate, dom, e, valid, skew, mindom, selfm = arrays
    nb, nn = mesh.shape[mesh_lib.BATCH_AXIS], mesh.shape[mesh_lib.NODE_AXIS]
    bq = -(-free.shape[0] // nb) * nb
    n = mesh_lib.node_pad(mesh, free.shape[1])
    pad = mesh_lib._pad_axis
    free = pad(pad(free, 0, bq, 0), 1, n, 0)
    pods_free = pad(pad(pods_free, 0, bq, 0), 1, n, 0)
    gate = pad(pad(gate, 0, bq, False), 1, n, False)
    dom = pad(pad(dom, 0, bq, -1), 2, n, -1)
    req, e, valid, skew, mindom, selfm = (
        pad(a, 0, bq, v) for a, v in ((req, 0), (e, 0), (valid, False),
                                       (skew, _BIG), (mindom, 0),
                                       (selfm, False)))
    per, n_local = bq // nb, n // nn
    out = {}
    for r in mesh.local_rows():
        rows = slice(r * per, (r + 1) * per)
        rep = [torch.from_numpy(np.ascontiguousarray(a[rows])).to(mesh.lead)
               for a in (e, valid, skew, mindom, selfm)]
        parts = []
        for k in mesh.local_shards(r):
            nodes = slice(k * n_local, (k + 1) * n_local)
            d = mesh.devices[r, k]
            t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(d)
            parts.append(_node_sums(
                t(free[rows, nodes]), t(req[rows]), t(pods_free[rows, nodes]),
                t(gate[rows, nodes]), t(dom[rows, :, nodes]),
                t(e[rows]), t(valid[rows]), t(skew[rows]), t(mindom[rows]),
                num_constraints, num_domains))
        sums = []
        for i in range(4):
            if parts[0][i] is None:
                sums.append(None)
                continue
            vals = [p[i] for p in parts]
            if mesh.groups.get(r) is not None:
                vals = mesh_lib._all_gather(vals, mesh.groups[r])
            sums.append(torch.stack([v.to(mesh.lead) for v in vals]).sum(0))
        upper, lp, cap_d, stat = sums
        lower, upper = _fold(upper, cap_d, stat, *rep[:4], rep[4])
        out[r] = tuple(t.cpu().numpy() for t in (lower, upper, lp))
    if mesh.multi_process and nb > 1:
        import torch.distributed as dist
        gathered: List[dict] = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, out)
        for part in gathered:
            out.update(part)
    return tuple(np.concatenate([out[r][i] for r in range(nb)])
                 for i in range(3))


def _spread_arrays(pb: enc.EncodedProblem, ch: int, dh: int, n: int):
    """This problem's hard-constraint planes padded to the group maxima
    (ch constraints × dh domains); padded rows are inert (no keyed node,
    no valid domain, huge skew)."""
    sh = pb.spread_hard
    dom = np.full((ch, n), -1, dtype=np.int32)
    e = np.zeros((ch, dh), dtype=np.float32)
    valid = np.zeros((ch, dh), dtype=bool)
    skew = np.full(ch, _BIG, dtype=np.float32)
    mindom = np.zeros(ch, dtype=np.float32)
    selfm = np.zeros(ch, dtype=bool)
    c, d = sh.node_domain.shape[0], sh.init_counts.shape[1]
    if sh.num_constraints:
        dom[:c] = sh.node_domain
        e[:c, :d] = sh.init_counts
        valid[:c, :d] = sh.domain_valid
        skew[:sh.num_constraints] = sh.max_skew[:sh.num_constraints]
        mindom[:c] = sh.min_domains
        selfm[:c] = sh.self_match
    return dom, e, valid, skew, mindom, selfm


def bracket_device(pbs: Sequence[enc.EncodedProblem], *, mesh=None,
                   device=None) -> List[CapacityBracket]:
    """ONE batched shot on `device` (default the card) bracketing every
    problem: the fit planes (and any hard-spread planes, padded to the group
    maxima) stack on a power-of-two leading axis.  Problems must share the
    node/resource axes (the analyzer's scenario family and a sweep's
    template group both do).  With `mesh` the shot shards over it
    (_bracket_sharded).  Route every call through runtime/guard.run under
    faults.SITE_BOUNDS — `bracket_group` is the guarded entry."""
    pbs = list(pbs)
    if not pbs:
        return []
    n = pbs[0].snapshot.num_nodes
    r = pbs[0].req_vec.shape[0]
    for pb in pbs:
        if pb.snapshot.num_nodes != n or pb.req_vec.shape[0] != r:
            raise ValueError("bracket_device needs uniform node/resource "
                             "axes across the batch")
    ch = max(pb.spread_hard.node_domain.shape[0] for pb in pbs)
    ch = max(ch, max(pb.spread_hard.num_constraints for pb in pbs))
    dh = max(max(pb.spread_hard.init_counts.shape[1] for pb in pbs), 1)
    any_spread = any(pb.spread_hard.num_constraints for pb in pbs)

    b = len(pbs)
    bq = _quantize_batch(b)
    free = np.zeros((bq, n, r), dtype=np.float32)
    req = np.zeros((bq, r), dtype=np.float32)
    pods_free = np.zeros((bq, n), dtype=np.float32)
    gate = np.zeros((bq, n), dtype=bool)
    c_eff = ch if any_spread else 0
    dom = np.full((bq, c_eff, n), -1, dtype=np.int32)
    e = np.zeros((bq, c_eff, dh), dtype=np.float32)
    valid = np.zeros((bq, c_eff, dh), dtype=bool)
    skew = np.full((bq, c_eff), _BIG, dtype=np.float32)
    mindom = np.zeros((bq, c_eff), dtype=np.float32)
    selfm = np.zeros((bq, c_eff), dtype=bool)
    kernel_rows: List[int] = []
    for i, pb in enumerate(pbs):
        if pb.pod_level_reason is not None \
                or not pb.profile.filter_enabled("NodeResourcesFit"):
            continue                     # host-decided sentinel brackets
        kernel_rows.append(i)
        free[i] = _free_matrix(pb)
        rv = np.asarray(pb.req_vec, dtype=np.float32).copy()
        rv[IDX_PODS] = 0.0               # pod slots ride pods_free
        req[i] = rv
        pods_free[i] = (pb.allocatable[:, IDX_PODS]
                        - pb.init_requested[:, IDX_PODS])
        gate[i] = np.asarray(pb.static_mask) & np.asarray(pb.volume_mask)
        if c_eff:
            (dom[i], e[i], valid[i], skew[i], mindom[i],
             selfm[i]) = _spread_arrays(pb, c_eff, dh, n)

    lo = hi = lp = None
    if kernel_rows:
        dev = sim.resolve_device(device)
        arrays = (free, req, pods_free, gate, dom, e, valid, skew, mindom,
                  selfm)
        if mesh is not None:
            lo, hi, lp = _bracket_sharded(mesh, dev, arrays, c_eff, dh)
        else:
            args = [torch.from_numpy(a).to(dev) for a in arrays]
            lo, hi, lp = (t.cpu().numpy() for t in
                          _bracket_runner(*args, num_constraints=c_eff,
                                          num_domains=dh))

    out: List[CapacityBracket] = []
    for i, pb in enumerate(pbs):
        if pb.pod_level_reason is not None:
            out.append(CapacityBracket(0, 0, exact=False, method="pod_level"))
        elif not pb.profile.filter_enabled("NodeResourcesFit"):
            out.append(CapacityBracket(0, UNBOUNDED, exact=False,
                                       method="no_fit"))
        else:
            upper = float(hi[i])
            lower = 0.0 if not _fit_only(pb) else float(lo[i])
            lower = min(lower, upper)
            out.append(CapacityBracket(int(min(lower, UNBOUNDED)),
                                       int(min(upper, UNBOUNDED)),
                                       exact=exact_capacity(pb),
                                       frac=float(lp[i])))
    return out


def _validate_brackets(brs: Sequence[CapacityBracket], *, site: str) -> None:
    """Post-guard output validation: a bracket has no placement planes for
    guard.validate_result, so corruption checks live here (the chaos drill
    injects ``bounds.bracket:corrupt`` and this must catch it)."""
    from ..runtime.errors import NumericCorruption
    for br in brs:
        if br.lower < 0 or br.upper < br.lower or br.upper > UNBOUNDED:
            raise NumericCorruption(
                f"capacity bracket [{br.lower}, {br.upper}] is not a valid "
                f"bracket", site=site)


def bracket_group(pbs: Sequence[enc.EncodedProblem], *,
                  parity: bool = True, mesh=None, device=None
                  ) -> Tuple[List[CapacityBracket], bool]:
    """Guarded batched bracketing: one device shot under guard.run at
    faults.SITE_BOUNDS (rung "bounds"), validated, then held against the
    host recomputation (pruning decisions must never ride a silently wrong
    shot).  Any classified fault — or a mismatch, raised as
    NumericCorruption — degrades to the host brackets, which share the
    formulas exactly.  With a mesh the shot shards over it and the same
    check applies.  Returns (brackets, degraded)."""
    from ..parallel import mesh as mesh_lib
    from ..runtime import faults, guard
    from ..runtime.degrade import _record
    from ..runtime.errors import NumericCorruption, RuntimeFault

    pbs = list(pbs)
    if not pbs:
        return [], False
    try:
        try:
            brs = guard.run(lambda: bracket_device(pbs, mesh=mesh,
                                                   device=device),
                            site=faults.SITE_BOUNDS, rung="bounds",
                            batch=len(pbs),
                            mesh_shape=mesh_lib.mesh_shape(mesh))
            _validate_brackets(brs, site=faults.SITE_BOUNDS)
            if parity:
                host = [bracket_host(pb) for pb in pbs]
                for h, d in zip(host, brs):
                    if h.lower != d.lower or h.upper != d.upper:
                        raise NumericCorruption(
                            f"device bracket [{d.lower}, {d.upper}] "
                            f"disagrees with host recomputation "
                            f"[{h.lower}, {h.upper}]",
                            site=faults.SITE_BOUNDS)
            return brs, False
        except RuntimeFault as fault:
            _record(fault, "bounds_host")
            raise
    except RuntimeFault:
        return [bracket_host(pb) for pb in pbs], True


# --------------------------------------------------------------------------
# template mixes: the K-round auction
# --------------------------------------------------------------------------

def _auction_rounds(free: torch.Tensor, pods_free: torch.Tensor,
                    reqs: torch.Tensor, gates: torch.Tensor,
                    rounds: int) -> torch.Tensor:
    """K-round FFD/auction in float32 torch ops, the JAX package's jitted
    `_auction_runner` op for op: templates take turns in order against the
    shared free matrix, each round claiming ceil(claimable / rounds left)
    per node — round-robin fairness across the mix, everything claimable
    by the last round.  free [N, R], pods_free [N], reqs [T, R], gates
    [T, N] bool; returns the claims [T] float32 with no host sync (the
    divisors are tensors, so no division becomes a reciprocal multiply)."""
    dev = free.device
    f32 = lambda v: torch.full((), float(v), dtype=torch.float32, device=dev)
    big, zero, one = f32(_BIG), f32(0.0), f32(1.0)
    claimed = torch.zeros(reqs.shape[0], dtype=torch.float32, device=dev)
    for r in range(rounds):
        left = torch.maximum(f32(rounds) - f32(r), one)
        takes = []
        for t in range(reqs.shape[0]):
            req, gate = reqs[t], gates[t]
            pos = req > 0
            ratio = torch.where(pos[None, :],
                                torch.maximum(free, zero)
                                / torch.where(pos, req, one)[None, :], big)
            cap = torch.minimum(ratio.amin(dim=1),
                                torch.maximum(pods_free, zero))
            cap = torch.where(gate, torch.maximum(torch.floor(cap), zero),
                              zero)
            take = torch.minimum(cap, torch.ceil(cap / left))
            free = free - take[:, None] * req[None, :]
            pods_free = pods_free - take
            takes.append(take.sum())
        claimed = claimed + torch.stack(takes)
    return claimed


def _mix_arrays(pbs: Sequence[enc.EncodedProblem]):
    pb0 = pbs[0]
    n, r = pb0.snapshot.num_nodes, pb0.req_vec.shape[0]
    free = np.asarray(_free_matrix(pb0), dtype=np.float32).copy()
    free[:, IDX_PODS] = 0.0
    pods_free = np.asarray(pb0.allocatable[:, IDX_PODS]
                           - pb0.init_requested[:, IDX_PODS],
                           dtype=np.float32)
    reqs = np.zeros((len(pbs), r), dtype=np.float32)
    gates = np.zeros((len(pbs), n), dtype=bool)
    for t, pb in enumerate(pbs):
        rv = np.asarray(pb.req_vec, dtype=np.float32).copy()
        rv[IDX_PODS] = 0.0
        reqs[t] = rv
        gates[t] = np.asarray(pb.static_mask) & np.asarray(pb.volume_mask)
    return free, pods_free, reqs, gates


def auction_device(pbs: Sequence[enc.EncodedProblem], rounds: int = 4, *,
                   mesh=None, device=None) -> List[int]:
    """The K-round auction on `device` (default the card): per-template
    constructive claims against the SHARED free matrix (the templates must
    encode the same snapshot).  `bracket_mix` is the guarded entry.

    With `mesh` the free matrix [N, R], the pod slots [N] and the gates
    [T, N] shard over the node axis of the mesh's first row of this
    process (there is no batch: every template bids against one snapshot),
    padded with gate-False, zero-headroom nodes that never claim.  Nothing
    crosses nodes but each template's claim total, so every shard runs
    the rounds on its nodes and the shards' totals add up through the
    node reducer's integer `add`: whole numbers in float32, exact below
    2**24."""
    dev = sim.resolve_device(device)
    arrays = _mix_arrays(pbs)
    if mesh is None:
        free, pods_free, reqs, gates = (torch.from_numpy(a).to(dev)
                                        for a in arrays)
        claimed = _auction_rounds(free, pods_free, reqs, gates, int(rounds))
    else:
        claimed = _auction_sharded(mesh, dev, arrays, int(rounds))
    return [int(c) for c in claimed.cpu().numpy()]


def _auction_sharded(mesh, dev, arrays, rounds: int) -> torch.Tensor:
    from ..parallel import mesh as mesh_lib

    mesh_lib.check_device(mesh, dev)
    free, pods_free, reqs, gates = arrays
    n = mesh_lib.node_pad(mesh, free.shape[0])
    pad = mesh_lib._pad_axis
    free, pods_free = pad(free, 0, n, 0), pad(pods_free, 0, n, 0)
    gates = pad(gates, 1, n, False)
    n_local = n // mesh.shape[mesh_lib.NODE_AXIS]

    def shard(r, red):
        d = red.device
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(d)
        nodes = slice(red.offset, red.offset + n_local)
        local = _auction_rounds(t(free[nodes]), t(pods_free[nodes]),
                                t(reqs), t(gates[:, nodes]), rounds)
        return red.add(local)

    row = mesh.local_rows()[0]
    out = mesh_lib.run_shards(mesh, [row], n_local, shard)
    return out[(row, mesh.local_shards(row)[0])]


def _auction_host(pbs: Sequence[enc.EncodedProblem],
                  rounds: int = 4) -> List[int]:
    """Oracle-side auction: the float64 numpy mirror of the device one."""
    free, pods_free, reqs, gates = (a.astype(np.float64)
                                    if a.dtype != bool else a
                                    for a in _mix_arrays(pbs))
    claimed = [0.0] * len(pbs)
    for r in range(rounds):
        left = float(rounds - r)
        for t in range(len(pbs)):
            pos = reqs[t] > 0
            ratio = np.where(pos[None, :],
                             np.maximum(free, 0.0)
                             / np.where(pos, reqs[t], 1.0)[None, :],
                             np.inf)
            cap = np.minimum(np.min(ratio, axis=1),
                             np.maximum(pods_free, 0.0))
            cap = np.where(gates[t], np.maximum(np.floor(cap), 0.0), 0.0)
            take = np.minimum(cap, np.ceil(cap / left))
            free = free - take[:, None] * reqs[t][None, :]
            pods_free = pods_free - take
            claimed[t] += float(np.sum(take))
    return [int(c) for c in claimed]


def bracket_mix(pbs: Sequence[enc.EncodedProblem], rounds: int = 4, *,
                mesh=None, device=None
                ) -> Tuple[CapacityBracket, List[int], bool]:
    """Joint bracket for a template mix against ONE shared snapshot: the
    upper bound sums the per-template solo uppers (any joint schedule is
    dominated per template) capped by the pooled pod slots; the lower bound
    is the guarded K-round auction's total.  The device auction runs under
    guard.run at faults.SITE_BOUNDS and is held against `_auction_host`: a
    classified fault, a negative claim or a mismatch (NumericCorruption)
    serves the host claims, degraded.  Returns (joint bracket,
    per-template claims, degraded)."""
    from ..parallel import mesh as mesh_lib
    from ..runtime import faults, guard
    from ..runtime.degrade import _record
    from ..runtime.errors import NumericCorruption, RuntimeFault

    pbs = list(pbs)
    if not pbs:
        return CapacityBracket(0, 0, exact=False), [], False
    degraded = False
    try:
        claims = guard.run(lambda: auction_device(pbs, rounds, mesh=mesh,
                                                  device=device),
                           site=faults.SITE_BOUNDS, rung="bounds",
                           batch=len(pbs),
                           mesh_shape=mesh_lib.mesh_shape(mesh))
        if any(c < 0 for c in claims):
            raise NumericCorruption("negative auction claim",
                                    site=faults.SITE_BOUNDS)
        host_claims = _auction_host(pbs, rounds)
        if claims != host_claims:
            raise NumericCorruption(
                f"device auction claims {claims} disagree with host "
                f"recomputation {host_claims}", site=faults.SITE_BOUNDS)
    except RuntimeFault as fault:
        _record(fault, "bounds_host")
        claims = _auction_host(pbs, rounds)
        degraded = True
    solos = [bracket_host(pb) for pb in pbs]
    pods_free = np.maximum(
        np.asarray(pbs[0].allocatable[:, IDX_PODS]
                   - pbs[0].init_requested[:, IDX_PODS], dtype=np.float64),
        0.0)
    any_gate = np.zeros(pbs[0].snapshot.num_nodes, dtype=bool)
    for pb in pbs:
        any_gate |= np.asarray(pb.static_mask) & np.asarray(pb.volume_mask)
    upper = min(sum(s.upper for s in solos),
                int(np.sum(np.floor(pods_free[any_gate]))))
    lower = min(sum(claims), upper)
    exact = len(pbs) == 1 and solos[0].exact
    return (CapacityBracket(int(min(lower, UNBOUNDED)),
                            int(min(upper, UNBOUNDED)), exact=exact,
                            frac=float(sum(s.frac for s in solos))),
            claims, degraded)

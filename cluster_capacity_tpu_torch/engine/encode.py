"""Problem encoding: (snapshot, pod template, profile) → host arrays.

All string matching and per-pod precomputation happens once here on the host
(the analog of the scheduler pre-parsing PodInfo, types.go:602, and each
plugin's PreFilter), producing fixed-shape numpy arrays the engine moves to
the device.  Field for field this is the JAX package's EncodedProblem, so a
problem encoded by either package can be fed to the other's engine
(problem_from_arrays).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, List, Mapping, Optional

import numpy as np

from ..models import podspec as ps
from ..models.podspec import is_scalar_resource_name
from ..models.snapshot import ClusterSnapshot, IDX_CPU, IDX_MEM, IDX_PODS
from ..ops import (dynamic_resources, image_locality, inter_pod_affinity,
                   node_affinity, node_name, node_ports, node_unschedulable,
                   pod_topology_spread, taint_toleration, volumes)
from ..utils.config import SchedulerProfile

# Per-node failure reason codes (first failing plugin in default filter order:
# NodeUnschedulable, NodeName, TaintToleration, NodeAffinity, NodePorts,
# NodeResourcesFit, PodTopologySpread, InterPodAffinity —
# default_plugins.go:34-51).  Numbering matches the JAX package.
CODE_OK = 0
CODE_UNSCHEDULABLE = 1
CODE_NODE_NAME = 2
CODE_TAINT = 3
CODE_NODE_AFFINITY = 4
CODE_PORTS = 5
CODE_FIT = 6
CODE_SPREAD_MISSING_LABEL = 7
CODE_SPREAD = 8
CODE_IPA_AFFINITY = 9
CODE_IPA_ANTI = 10
CODE_IPA_EXISTING_ANTI = 11
# (volume plugin failures flow through the separate volume_mask /
# volume_reasons channel; they sit between fit and spread in diagnosis order)
CODE_DRA = 12
# The JAX package's resilience code (a node simulated as failed); the port
# has no failure overlay yet, but the number stays reserved.
CODE_NODE_FAILED = 13
# explain/: the reason stamp chain needs a code for every eliminator
# diagnose() attributes, including the channels outside static_code — the
# static volume_mask (per-node detail stays in volume_reasons), the clone
# self disk conflict and the RWOP cluster-wide conflict.  DRA colocation
# reuses CODE_DRA (the same reason string).
CODE_VOLUME = 14
CODE_VOLUME_SELF = 15
CODE_RWOP = 16

STATIC_REASONS = {
    CODE_UNSCHEDULABLE: node_unschedulable.REASON,
    CODE_NODE_NAME: node_name.REASON,
    CODE_NODE_AFFINITY: node_affinity.REASON,
    CODE_PORTS: node_ports.REASON,
    CODE_SPREAD_MISSING_LABEL: pod_topology_spread.REASON_MISSING_LABEL,
    CODE_SPREAD: pod_topology_spread.REASON_CONSTRAINTS,
    CODE_IPA_AFFINITY: inter_pod_affinity.REASON_AFFINITY,
    CODE_IPA_ANTI: inter_pod_affinity.REASON_ANTI_AFFINITY,
    CODE_IPA_EXISTING_ANTI: inter_pod_affinity.REASON_EXISTING_ANTI,
    CODE_DRA: dynamic_resources.REASON_CANNOT_ALLOCATE,
    CODE_VOLUME_SELF: volumes.REASON_DISK_CONFLICT,
    CODE_RWOP: volumes.REASON_RWOP_CONFLICT,
}
# CODE_TAINT and CODE_VOLUME have no entry: their reason strings are per
# node (taint_reasons / volume_reasons).

# PreEnqueue gate wording (kubelet's condition message)
REASON_SCHEDULING_GATED = ("Scheduling is blocked due to non-empty "
                           "scheduling gates")


@dataclass
class EncodedProblem:
    snapshot: ClusterSnapshot
    pod: dict
    profile: SchedulerProfile

    # resource axis — R may EXCEED the snapshot's vocabulary: resources the
    # pod requests that no node publishes become zero-allocatable virtual
    # columns (fit.go:564-660: an absent scalar resource reads as 0).
    resource_names: List[str]
    allocatable: np.ndarray        # f[N, R]
    init_requested: np.ndarray     # f[N, R]
    init_nonzero: np.ndarray       # f[N, 2]
    req_vec: np.ndarray            # f[R] — Filter-path pod request
    req_nonzero: np.ndarray        # f[2] — (cpu,mem) with 100m/200MB defaults

    # fit score strategy views (indices into resource axis)
    fit_res_idx: np.ndarray        # i32[K]
    fit_res_weights: np.ndarray    # f[K]
    fit_req: np.ndarray            # f[K] — scoring-path request
    fit_uses_nonzero: np.ndarray   # bool[K] — cpu/mem use NonZeroRequested
    balanced_res_idx: np.ndarray   # i32[Kb]
    balanced_req: np.ndarray       # f[Kb] — actual requests

    # static filter state
    static_mask: np.ndarray        # bool[N] — pre-fit static filters
    static_code: np.ndarray        # i32[N] — first static fail reason
    taint_reasons: List[Optional[str]]
    clone_has_host_ports: bool
    # volume plugins: static post-fit mask + per-node reasons, plus clone
    # self-conflict flags the engine applies dynamically
    volume_mask: np.ndarray        # bool[N]
    volume_reasons: List[Optional[str]]
    volume_self_conflict: bool
    rwop_self_conflict: bool
    # pod-level gate: PreEnqueue failure affecting every node
    pod_level_reason: Optional[str]
    pod_level_fail_type: str
    dra_shared_colocate: bool
    shared_req_vec: np.ndarray     # f[R]

    # static score state
    taint_raw: np.ndarray          # f[N]
    node_affinity_raw: np.ndarray  # f[N]
    node_affinity_active: bool
    image_locality_score: np.ndarray  # f[N]

    # stateful plugins
    spread_hard: pod_topology_spread.SpreadConstraintSet
    spread_soft: pod_topology_spread.SpreadConstraintSet
    spread_ignored: np.ndarray     # bool[N] — score-pass ignored nodes
    ipa: inter_pod_affinity.AffinityEncoding

    num_alive: int                 # nodes percentageOfNodesToScore sees
    max_steps_hint: int            # fit-based upper bound on placements


def encode_problem(snapshot: ClusterSnapshot, pod: dict,
                   profile: SchedulerProfile) -> EncodedProblem:
    n = snapshot.num_nodes

    # --- pod request vectors ------------------------------------------------
    reqs = ps.pod_requests(pod)
    ignored = set(profile.ignored_resources)
    ignored_groups = set(profile.ignored_resource_groups)

    def _ignored(name: str) -> bool:
        # fit.go:626-640: only extended resources can be ignored
        if not is_scalar_resource_name(name):
            return False
        return name in ignored or name.split("/")[0] in ignored_groups

    # Requested resources absent from the snapshot vocabulary: no node
    # publishes them → allocatable reads as 0 everywhere (fit.go:585-600).
    missing = sorted(name for name, v in reqs.items()
                     if v > 0 and not _ignored(name)
                     and snapshot.resource_index(name) is None)
    resource_names = list(snapshot.resource_names) + missing
    r = len(resource_names)

    def rindex(name: str):
        j = snapshot.resource_index(name)
        if j is None and name in missing:
            return snapshot.num_resources + missing.index(name)
        return j

    allocatable = snapshot.allocatable
    init_requested = snapshot.requested
    if missing:
        zeros = np.zeros((n, len(missing)), dtype=np.float64)
        allocatable = np.concatenate([allocatable, zeros], axis=1)
        init_requested = np.concatenate([init_requested, zeros], axis=1)

    req_vec = np.zeros(r, dtype=np.float64)
    for name, v in reqs.items():
        if _ignored(name):
            continue
        j = rindex(name)
        if j is not None:
            req_vec[j] = v
    req_vec[IDX_PODS] = 1.0

    # DRA claims -> device pseudo-resource requests (ops/dynamic_resources)
    dra = dynamic_resources
    dra_on = profile.filter_enabled("DynamicResources")
    dra_enc = dra.encode(
        pod, snapshot.resource_claims, snapshot.resource_claim_templates,
        device_classes=snapshot.device_classes,
        has_shared_counters=snapshot.memo(
            ("has_shared_counters",),
            lambda: any((rs.get("spec") or {}).get("sharedCounters")
                        for rs in snapshot.resource_slices))) if dra_on \
        else dra.DraEncoding()
    dra_missing_class = False
    shared_req_vec = np.zeros(r, dtype=np.float64)
    for name, v in dra_enc.per_clone_requests.items():
        j = snapshot.resource_index(name)
        if j is None:
            # no node publishes this device class: nothing can place
            dra_missing_class = True
        else:
            req_vec[j] = v
    for name, v in dra_enc.shared_first_requests.items():
        j = snapshot.resource_index(name)
        if j is None:
            dra_missing_class = True
        else:
            shared_req_vec[j] = v
    if dra_enc.slot_requests or dra_enc.shared_slot_requests:
        # structured allocator (CEL selectors / adminAccess / partitionable
        # devices): one virtual per-node column, allocatable = the clones
        # the node's free devices support, each clone requests 1.  An
        # unallocated shared named claim's structured requests are reserved
        # once per node inside the column (its +1 is charged to the FIRST
        # clone through shared_req_vec; dra_shared_colocate keeps every
        # later clone on the allocation's node).
        slots = dra.compute_slot_columns(
            snapshot, dra_enc.slot_requests,
            shared_reqs=dra_enc.shared_slot_requests)
        resource_names = resource_names + [dra.DRA_SLOTS_RESOURCE]
        allocatable = np.concatenate([allocatable, slots[:, None]], axis=1)
        init_requested = np.concatenate(
            [init_requested, np.zeros((n, 1))], axis=1)
        req_vec = np.concatenate(
            [req_vec, [1.0 if dra_enc.slot_requests else 0.0]])
        shared_req_vec = np.concatenate(
            [shared_req_vec,
             [1.0 if dra_enc.shared_slot_requests else 0.0]])
        r = len(resource_names)
    cpu_nz, mem_nz = ps.pod_nonzero_cpu_mem(pod)
    req_nonzero = np.asarray([cpu_nz, mem_nz], dtype=np.float64)

    # --- fit score strategy views ------------------------------------------
    strat = profile.fit_strategy
    fit_idx, fit_w, fit_req, fit_nz = [], [], [], []
    score_reqs = ps.pod_requests(pod, non_missing_defaults=True)
    for name, w in strat.resources:
        j = snapshot.resource_index(name)
        if j is None:
            continue
        # calculateResourceAllocatableRequest (resource_allocation.go:88-99):
        # a scalar resource the pod doesn't request drops out of the mean.
        if is_scalar_resource_name(name) and not score_reqs.get(name, 0):
            continue
        fit_idx.append(j)
        fit_w.append(float(w))
        fit_req.append(float(score_reqs.get(name, 0)))
        fit_nz.append(j in (IDX_CPU, IDX_MEM))
    bal_idx, bal_req = [], []
    for name, _w in profile.balanced_resources:
        j = snapshot.resource_index(name)
        if j is None:
            continue
        if is_scalar_resource_name(name) and not reqs.get(name, 0):
            continue
        bal_idx.append(j)
        bal_req.append(float(reqs.get(name, 0)))

    # --- static filters -----------------------------------------------------
    enabled = profile.filter_enabled
    masks: List[np.ndarray] = []
    static_code = np.zeros(n, dtype=np.int32)
    taint_reasons: List[Optional[str]] = [None] * n

    def fold(mask: np.ndarray, code: int):
        np.copyto(static_code, code,
                  where=(static_code == CODE_OK) & ~mask)
        masks.append(mask)

    if enabled("NodeUnschedulable"):
        fold(node_unschedulable.static_mask(snapshot, pod), CODE_UNSCHEDULABLE)
    if enabled("NodeName"):
        fold(node_name.static_mask(snapshot, pod), CODE_NODE_NAME)
    if enabled("TaintToleration"):
        t_mask, taint_reasons = taint_toleration.static_mask_and_reasons(
            snapshot, pod)
        fold(t_mask, CODE_TAINT)
    if enabled("NodeAffinity"):
        na_mask = node_affinity.static_mask(snapshot, pod)
        if profile.added_affinity:
            # NodeAffinityArgs.addedAffinity: ANDed with the pod's own
            # required affinity for every pod of the profile
            from ..models.labels import node_selector_mask
            required = profile.added_affinity.get(
                "requiredDuringSchedulingIgnoredDuringExecution")
            if required:
                na_mask = na_mask & node_selector_mask(snapshot, required)
        fold(na_mask, CODE_NODE_AFFINITY)
    if enabled("NodePorts"):
        fold(node_ports.static_mask(snapshot, pod), CODE_PORTS)
    if dra_enc.allocation_node_selectors:
        from ..models.labels import node_selector_mask
        dra_mask = np.ones(n, dtype=bool)
        for sel in dra_enc.allocation_node_selectors:
            dra_mask &= node_selector_mask(snapshot, sel)
        fold(dra_mask, CODE_DRA)
    static_mask = np.logical_and.reduce(masks) if masks \
        else np.ones(n, dtype=bool)

    # --- volume plugins (static, post-fit in plugin order) -------------------
    vol = volumes.evaluate(snapshot, pod, enabled)
    pod_level_reason = vol.pod_level_reason
    pod_level_fail_type = "Unschedulable"
    if dra_enc.pod_level_reason:
        pod_level_reason = dra_enc.pod_level_reason
    elif dra_missing_class:
        pod_level_reason = dra.REASON_CANNOT_ALLOCATE
    # PreEnqueue: SchedulingGates holds the pod before it enters a cycle
    # (scheduling_gates.go:49); fail fast with the kubelet's wording.
    if (pod.get("spec") or {}).get("schedulingGates"):
        pod_level_reason = REASON_SCHEDULING_GATED
        pod_level_fail_type = "SchedulingGated"

    # --- static scores ------------------------------------------------------
    taint_raw = taint_toleration.static_raw_score(snapshot, pod) \
        if profile.score_weight("TaintToleration") else np.zeros(n)
    na_active = node_affinity.has_preferred_terms(
        pod, added_affinity=profile.added_affinity)
    na_raw = node_affinity.static_raw_score(
        snapshot, pod, added_affinity=profile.added_affinity) \
        if na_active and profile.score_weight("NodeAffinity") else np.zeros(n)
    il_score = image_locality.static_score(snapshot, pod) \
        if profile.score_weight("ImageLocality") else np.zeros(n)

    # --- stateful plugins ---------------------------------------------------
    bare = {"metadata": pod.get("metadata", {}), "spec": {}}
    spread_hard = pod_topology_spread.encode_constraints(
        snapshot, pod if enabled("PodTopologySpread") else bare,
        "DoNotSchedule")
    if profile.score_weight("PodTopologySpread"):
        if (pod.get("spec") or {}).get("topologySpreadConstraints"):
            spread_soft = pod_topology_spread.encode_constraints(
                snapshot, pod, "ScheduleAnyway")
        else:
            # system default spreading via service/RC/RS/SS selectors
            spread_soft = pod_topology_spread.encode_system_default(
                snapshot, pod)
    else:
        spread_soft = pod_topology_spread.encode_constraints(
            snapshot, bare, "ScheduleAnyway")
    require_all = bool((pod.get("spec") or {}).get("topologySpreadConstraints"))
    spread_ignored = pod_topology_spread.static_ignored(spread_soft,
                                                        require_all)

    if enabled("InterPodAffinity") or profile.score_weight("InterPodAffinity"):
        ipa = inter_pod_affinity.encode(
            snapshot, pod,
            ignore_preferred_terms_of_existing_pods=
            profile.ignore_preferred_terms_of_existing_pods)
    else:
        ipa = inter_pod_affinity.encode(snapshot, bare)

    # --- step-count upper bound from the fit filter -------------------------
    free = allocatable - init_requested
    per_node = np.full(n, np.inf)
    pod_slots = np.maximum(allocatable[:, IDX_PODS]
                           - init_requested[:, IDX_PODS], 0.0)
    per_node = np.minimum(per_node, pod_slots)
    if enabled("NodeResourcesFit"):
        for j in range(r):
            if j != IDX_PODS and req_vec[j] > 0:
                per_node = np.minimum(per_node,
                                      np.floor(np.maximum(free[:, j], 0.0)
                                               / req_vec[j]))
    per_node = np.where(static_mask & vol.mask, per_node, 0.0)
    hint = int(per_node.sum()) if np.isfinite(per_node.sum()) else 10 ** 6
    if pod_level_reason:
        hint = 0
    elif vol.rwop_self_conflict:
        hint = min(hint, 1)

    return EncodedProblem(
        snapshot=snapshot, pod=pod, profile=profile,
        resource_names=resource_names,
        allocatable=allocatable, init_requested=init_requested,
        init_nonzero=snapshot.nonzero_requested,
        req_vec=req_vec, req_nonzero=req_nonzero,
        fit_res_idx=np.asarray(fit_idx or [IDX_CPU], dtype=np.int32),
        fit_res_weights=np.asarray(fit_w or [0.0], dtype=np.float64),
        fit_req=np.asarray(fit_req or [0.0], dtype=np.float64),
        fit_uses_nonzero=np.asarray(fit_nz or [False], dtype=bool),
        balanced_res_idx=np.asarray(bal_idx or [IDX_CPU], dtype=np.int32),
        balanced_req=np.asarray(bal_req or [0.0], dtype=np.float64),
        static_mask=static_mask, static_code=static_code,
        taint_reasons=taint_reasons,
        clone_has_host_ports=(enabled("NodePorts")
                              and node_ports.template_has_host_ports(pod)),
        volume_mask=vol.mask, volume_reasons=vol.reasons,
        volume_self_conflict=vol.self_disk_conflict,
        rwop_self_conflict=vol.rwop_self_conflict,
        pod_level_reason=pod_level_reason,
        pod_level_fail_type=pod_level_fail_type,
        dra_shared_colocate=dra_enc.shared_claim_colocate,
        shared_req_vec=shared_req_vec,
        taint_raw=taint_raw, node_affinity_raw=na_raw,
        node_affinity_active=na_active, image_locality_score=il_score,
        spread_hard=spread_hard, spread_soft=spread_soft,
        spread_ignored=spread_ignored, ipa=ipa,
        num_alive=n, max_steps_hint=hint,
    )


# Fields whose values are nested dataclasses in both packages.
_NESTED = {
    "spread_hard": pod_topology_spread.SpreadConstraintSet,
    "spread_soft": pod_topology_spread.SpreadConstraintSet,
    "ipa": inter_pod_affinity.AffinityEncoding,
}


def problem_from_arrays(d: Mapping[str, Any]) -> EncodedProblem:
    """Build an EncodedProblem from another encoder's fields given as plain
    numpy arrays and Python scalars: every EncodedProblem field by name, with
    spread_hard / spread_soft / ipa as mappings of their own dataclass
    fields.  `snapshot`, `pod` and `profile` must be this package's objects;
    the profile carries the arithmetic's dtype (float64 under parity) and
    the tie-break's seed, so a parity or random-mode problem crosses whole.
    Feeding one encoded problem to two engines separates engine differences
    from encoder differences."""
    kw = {}
    for f in dataclasses.fields(EncodedProblem):
        v = d[f.name]
        if f.name in _NESTED:
            cls = _NESTED[f.name]
            v = cls(**{g.name: _plain(v[g.name])
                       for g in dataclasses.fields(cls) if g.name in v})
        else:
            v = _plain(v)
        kw[f.name] = v
    return EncodedProblem(**kw)


def _plain(v):
    """Copy arrays so the problem owns writable host data."""
    return np.array(v) if isinstance(v, np.ndarray) else v

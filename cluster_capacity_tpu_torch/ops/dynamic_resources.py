"""DynamicResources (DRA): structured-parameters device allocation.

Reference: vendor/k8s.io/kubernetes/pkg/scheduler/framework/plugins/dynamicresources/
(2,439 LoC; PreEnqueue→PreBind).  The capacity-relevant core: pods reference
ResourceClaims (directly or via resourceClaimTemplates); claims request
devices of a DeviceClass, optionally narrowed by CEL selectors; nodes
publish devices through ResourceSlices; the plugin filters nodes whose
unallocated devices cannot satisfy the claim ("cannot allocate all claims").

The reduction implemented here:
- Plain count requests: devices become pseudo-resources
  `dra/<deviceClassName>` appended to the snapshot's resource axis;
  per-node allocatable = devices that node's ResourceSlices publish.
- CEL selectors / adminAccess / partitionable devices: the structured
  allocator runs ON THE HOST at encode time — selectors evaluate against
  each device's attributes/capacity (dynamicresources.go:898 + the
  structured allocator), shared counters bound partition co-allocation, and
  the answer folds into one per-node virtual column `dra/__slots__`
  (allocatable = max clones the node's free devices support, request = 1 per
  clone).  Device state never changes mid-solve, so the column is exact for
  identical clones on counter-free nodes; with shared-counter pools the
  greedy first-fit count is a LOWER BOUND on the reference's backtracking
  structured allocator (it never over-admits).
- SHARED named ResourceClaims are allocated ONCE: their devices are charged
  on the first placement only, every user colocates with the allocation, and
  a claim that is already allocated (status.allocation) pins all users to
  the nodes matching its allocation node selector and charges its devices to
  that node up front.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

DRA_RESOURCE_PREFIX = "dra/"
DRA_SLOTS_RESOURCE = "dra/__slots__"
REASON_CANNOT_ALLOCATE = "cannot allocate all claims"
# DeviceAllocationMode All (every matching device goes to the claim)
COUNT_ALL = -1
_SLOTS_UNLIMITED = 1e9


@dataclass
class SlotRequest:
    """One device request that needs the structured allocator (selectors,
    admin access, or partitionable devices)."""

    device_class: str
    count: int = 1
    selectors: List[str] = field(default_factory=list)   # CEL expressions
    admin_access: bool = False


@dataclass
class DraEncoding:
    # per-class device counts each clone charges (template claims)
    per_clone_requests: Dict[str, int] = field(default_factory=dict)
    # per-class device counts charged once, at the first placement
    # (unallocated shared claims)
    shared_first_requests: Dict[str, int] = field(default_factory=dict)
    # requests handled by the host-side structured allocator (CEL/admin);
    # they fold into the per-node dra/__slots__ virtual column
    slot_requests: List[SlotRequest] = field(default_factory=list)
    # structured requests of UNALLOCATED shared named claims: reserved once
    # on the first clone's node (the allocation), before per-clone slots
    shared_slot_requests: List[SlotRequest] = field(default_factory=list)
    # pod references a shared claim → all clones colocate
    shared_claim_colocate: bool = False
    # node selectors from already-allocated claims (every one must match)
    allocation_node_selectors: List[Mapping] = field(default_factory=list)
    # missing claim/class names → pod-level failure
    pod_level_reason: Optional[str] = None


# ---------------------------------------------------------------------------
# CEL device-selector evaluation
#
# DRA selectors are CEL expressions over `device`
# (resource.k8s.io DeviceSelector.cel.expression), e.g.
#   device.attributes["driver.example.com"].model == "a100"
#   device.capacity["driver.example.com"].memory >= 40
# Evaluated by ops/cel.py — a real lexer/parser/evaluator with CEL
# semantics (truncating int division, error-absorbing && / ||, typed
# arithmetic, string functions, has(), quantity()).  No Python eval is
# involved anywhere: selectors come from CLUSTER objects (a live sync
# pulls anyone's ResourceClaimTemplates), and the closed tree walker
# cannot reach Python state; memory stays linear in expression length.
# ---------------------------------------------------------------------------

from . import cel as cel_mod

_CEL_INT_MIN, _CEL_INT_MAX = -2 ** 63, 2 ** 63 - 1
_CEL_MAX_EXPR_LEN = cel_mod.MAX_EXPR_LEN


def _cel_value(v):
    """CEL attribute values are string/int/bool/double only; a
    cluster-sourced value outside that (or an int past int64) is a CEL
    type error → the device does not match."""
    if isinstance(v, (str, bool, float)) or v is None:
        return v
    if isinstance(v, int):
        if not _CEL_INT_MIN <= v <= _CEL_INT_MAX:
            raise cel_mod.CelError("attribute outside CEL int64 range")
        return v
    raise cel_mod.CelError(f"attribute type outside CEL: {type(v)!r}")


def _device_vars(device: "Device") -> dict:
    return {"device": {
        "driver": device.driver,
        "attributes": {dom: {k: _cel_value(v) for k, v in vals.items()}
                       for dom, vals in device.attributes.items()},
        "capacity": {dom: {k: _cel_value(v) for k, v in vals.items()}
                     for dom, vals in device.capacity.items()},
    }}


@functools.lru_cache(maxsize=512)
def _compiled(expr: str):
    return cel_mod.compile_expr(expr)


def cel_matches(expr: str, device: "Device") -> bool:
    """Evaluate one CEL selector against a device.  Failed lookups,
    evaluation/type errors, and malformed expressions mean 'does not
    match' (the reference treats runtime CEL errors as a non-matching
    device with an event, allocator.go)."""
    try:
        ast = _compiled(expr)
        return cel_mod.evaluate(ast, _device_vars(device)) is True
    except cel_mod.CelError:
        return False
    except Exception:
        # defense in depth: selectors are cluster-controlled, and a crash
        # here would abort the whole capacity run — any escape from the
        # evaluator (e.g. an unforeseen Recursion/OverflowError) is the
        # same "device does not match" the reference's CEL-error path takes
        return False


@dataclass
class Device:
    """One published device (ResourceSlice.spec.devices[] reduced)."""

    name: str
    device_class: str
    driver: str
    attributes: Dict[str, Dict[str, object]] = field(default_factory=dict)
    capacity: Dict[str, Dict[str, object]] = field(default_factory=dict)
    # partitionable devices: counter consumption per shared-counter set
    consumes: Dict[Tuple[str, str], float] = field(default_factory=dict)


def _unwrap_attr(v):
    """Attribute values are typed unions {string:|int:|bool:|version:}."""
    if isinstance(v, Mapping):
        for k in ("string", "int", "bool", "version"):
            if k in v:
                return v[k]
        return None
    return v


def _parse_devices(rs: Mapping) -> List[Device]:
    from ..utils.quantity import parse_quantity
    spec = rs.get("spec") or {}
    driver = spec.get("driver") or ""
    out = []
    for dev in spec.get("devices") or []:
        basic = dev.get("basic") or dev      # 1.31 nests under "basic"
        attrs: Dict[str, Dict[str, object]] = {}
        for qname, val in (basic.get("attributes") or {}).items():
            domain, _, name = qname.rpartition("/")
            attrs.setdefault(domain or driver, {})[name or qname] = \
                _unwrap_attr(val)
        caps: Dict[str, Dict[str, object]] = {}
        for qname, val in (basic.get("capacity") or {}).items():
            domain, _, name = qname.rpartition("/")
            if isinstance(val, Mapping):
                val = val.get("value", val)
            try:
                val = int(parse_quantity(val))
            except Exception:
                pass
            caps.setdefault(domain or driver, {})[name or qname] = val
        consumes: Dict[Tuple[str, str], float] = {}
        for cc in basic.get("consumesCounters") or []:
            cset = cc.get("counterSet") or ""
            for cname, cval in (cc.get("counters") or {}).items():
                if isinstance(cval, Mapping):
                    cval = cval.get("value", 0)
                try:
                    consumes[(cset, cname)] = float(parse_quantity(cval))
                except Exception:
                    consumes[(cset, cname)] = float(cval or 0)
        out.append(Device(
            name=dev.get("name") or "",
            device_class=dev.get("deviceClassName") or driver,
            driver=driver, attributes=attrs, capacity=caps,
            consumes=consumes))
    return out


def _shared_counters(rs: Mapping) -> Dict[Tuple[str, str], float]:
    from ..utils.quantity import parse_quantity
    out: Dict[Tuple[str, str], float] = {}
    for cs in (rs.get("spec") or {}).get("sharedCounters") or []:
        name = cs.get("name") or ""
        for cname, cval in (cs.get("counters") or {}).items():
            if isinstance(cval, Mapping):
                cval = cval.get("value", 0)
            try:
                out[(name, cname)] = float(parse_quantity(cval))
            except Exception:
                out[(name, cname)] = float(cval or 0)
    return out


def node_devices(resource_slices: Sequence[Mapping], node_name: str
                 ) -> Tuple[List[Device], Dict[Tuple[str, str], float]]:
    """All devices + merged shared-counter pools a node publishes."""
    devices: List[Device] = []
    counters: Dict[Tuple[str, str], float] = {}
    for rs in resource_slices:
        if (rs.get("spec") or {}).get("nodeName") != node_name:
            continue
        devices.extend(_parse_devices(rs))
        counters.update(_shared_counters(rs))
    return devices, counters


def _class_selectors(device_classes: Sequence[Mapping], name: str
                     ) -> List[str]:
    for dc in device_classes:
        if (dc.get("metadata") or {}).get("name") == name:
            return [s.get("cel", {}).get("expression", "")
                    for s in (dc.get("spec") or {}).get("selectors") or []
                    if s.get("cel")]
    return []


def _request_eligible(dev: Device, req: SlotRequest,
                      class_selectors: List[str]) -> bool:
    if req.device_class and dev.device_class != req.device_class:
        return False
    for expr in class_selectors + req.selectors:
        if expr and not cel_matches(expr, dev):
            return False
    return True


def _greedy_assign(all_units: List[List[int]], n_devices: int,
                   consumes: List[Dict], pools: Dict,
                   used: Optional[List[bool]] = None):
    """Greedy fewest-options-first assignment with counter tracking — the
    same first-fit shape as the reference's structured allocator.  Returns
    (used, remaining_pools) or None when some unit cannot place.  `used`
    seeds already-reserved devices (shared-claim reservation)."""
    used = list(used) if used is not None else [False] * n_devices
    remaining = dict(pools)
    for elig in sorted(all_units, key=len):
        placed = False
        for di in elig:
            if used[di]:
                continue
            need = consumes[di]
            if any(remaining.get(key, 0.0) < val
                   for key, val in need.items()):
                continue
            used[di] = True
            for key, val in need.items():
                remaining[key] = remaining.get(key, 0.0) - val
            placed = True
            break
        if not placed:
            return None
    return used, remaining


def _exact_assign(units: List[List[int]], n_devices: int,
                  consumes: List[Dict], pools: Dict,
                  used: Optional[List[bool]] = None,
                  budget: int = 50000) -> Optional[bool]:
    """Exact feasibility of assigning every unit a distinct device under
    the shared-counter pools — backtracking with symmetry reduction, the
    exactness the reference's allocator gets from recursive descent
    (structured/allocator.go).  Greedy first-fit can pick a counter-hungry
    device and wrongly report infeasible (e.g. pool c=2, devices
    A{c:2}/B{c:1}/C{c:1}, two units: greedy takes A and strands B) — this
    search settles the truth.

    Symmetry reduction: devices collapse into equivalence classes (same
    per-unit-type eligibility row + same counter consumption) and identical
    units into typed multiplicities, so k-clone questions branch over a few
    (type, class) pairs instead of k! device permutations.

    Returns True/False, or None when the branch budget exhausts (callers
    treat None as infeasible — a sound lower bound; practically unreachable
    for real node-local device counts)."""
    used = used or [False] * n_devices

    # unit types: identical eligibility sets with multiplicity
    type_mult: Dict[frozenset, int] = {}
    for elig in units:
        key = frozenset(elig)
        type_mult[key] = type_mult.get(key, 0) + 1
    types = sorted(type_mult, key=len)          # fewest options first
    mults = [type_mult[t] for t in types]

    # device classes: same (eligibility row, consumption) are interchangeable
    cls_key_to_i: Dict[tuple, int] = {}
    cls_cap: List[int] = []
    cls_need: List[Dict] = []
    cls_elig_row: List[tuple] = []
    for di in range(n_devices):
        if used[di]:
            continue
        row = tuple(di in t for t in types)
        if not any(row):
            continue
        key = (row, tuple(sorted(consumes[di].items())))
        ci = cls_key_to_i.get(key)
        if ci is None:
            ci = len(cls_cap)
            cls_key_to_i[key] = ci
            cls_cap.append(0)
            cls_need.append(consumes[di])
            cls_elig_row.append(row)
        cls_cap[ci] += 1

    caps = list(cls_cap)
    pool = dict(pools)
    steps = [budget]

    def feasible_count(ti: int) -> bool:
        # capacity pruning (counters ignored): every remaining type must
        # still have enough eligible devices
        for tj in range(ti, len(types)):
            have = sum(caps[ci] for ci in range(len(caps))
                       if cls_elig_row[ci][tj])
            if have < mults[tj]:
                return False
        return True

    def dfs(ti: int, m: int, start_ci: int) -> Optional[bool]:
        if steps[0] <= 0:
            return None
        steps[0] -= 1
        if ti == len(types):
            return True
        if m == 0:
            if not feasible_count(ti + 1):
                return False
            return dfs(ti + 1, mults[ti + 1] if ti + 1 < len(types) else 0, 0)
        saw_unknown = False
        for ci in range(start_ci, len(caps)):
            if not cls_elig_row[ci][ti] or caps[ci] == 0:
                continue
            need = cls_need[ci]
            if any(pool.get(k, 0.0) < v for k, v in need.items()):
                continue
            caps[ci] -= 1
            for k, v in need.items():
                pool[k] = pool.get(k, 0.0) - v
            r = dfs(ti, m - 1, ci)      # non-decreasing class order: no
            caps[ci] += 1               # permutation symmetry
            for k, v in need.items():
                pool[k] = pool.get(k, 0.0) + v
            if r:
                return True
            if r is None:
                saw_unknown = True
        return None if saw_unknown else False

    if not types:
        return True
    if not feasible_count(0):
        return False
    return dfs(0, mults[0], 0)


def _fits_k_clones(k: int, units: List[List[int]],
                   n_devices: int, consumes: List[Dict],
                   pools: Dict, used=None,
                   shared_units: Optional[List[List[int]]] = None
                   ) -> Optional[bool]:
    """Can k identical clones (plus an optional shared allocation's units,
    searched JOINTLY — a greedily pre-reserved shared claim could strand
    the counter pool for the clones) be allocated on top of `used`
    devices?  Greedy first-fit fast-accepts; a greedy miss is settled by
    the exact backtracking search, so the answer is EXACT and monotone in
    k (any feasible k stays feasible for k-1 by dropping one clone's
    units).  Returns None when the search budget exhausts — the caller
    must then treat feasibility as non-monotone (greedy lower bound)."""
    all_units = list(shared_units or []) + units * k
    if _greedy_assign(all_units, n_devices, consumes, pools,
                      used=used) is not None:
        return True
    return _exact_assign(all_units, n_devices, consumes, pools, used=used)


def compute_slot_columns(snapshot, reqs: List[SlotRequest],
                         shared_reqs: Sequence[SlotRequest] = ()):
    """Per-node max clone count for the structured requests (the
    dra/__slots__ virtual column) — host-side, once per encode.

    Devices already held by existing pods' template claims are removed
    first (greedy, class-eligibility only — their selectors are not
    re-evaluated, matching the allocator's first-fit).

    shared_reqs are an UNALLOCATED shared named claim's structured
    requests: they are reserved ONCE per node before the per-clone
    computation (the allocation the first clone would trigger; all clones
    colocate there, dra_shared_colocate).  The returned column then counts
    1 for the shared allocation itself — charged to the first clone via
    the shared_req_vec mechanism — plus one per clone; a node that cannot
    host the shared allocation gets 0."""
    import numpy as np

    templates_by_key = claim_index(snapshot.resource_claim_templates)
    slots = np.zeros(snapshot.num_nodes, dtype=np.float64)
    admin_ok = np.ones(snapshot.num_nodes, dtype=bool)
    class_sel = {r.device_class: _class_selectors(snapshot.device_classes,
                                                  r.device_class)
                 for r in list(reqs) + list(shared_reqs)}
    # one bucketing pass over the slices, not one scan per node
    slices_by_node: Dict[str, List[Mapping]] = {}
    for rs in snapshot.resource_slices:
        node = (rs.get("spec") or {}).get("nodeName")
        if node:
            slices_by_node.setdefault(node, []).append(rs)

    for i, name in enumerate(snapshot.node_names):
        devices, pools = node_devices(slices_by_node.get(name, ()), name)
        # remove devices consumed by existing pods (per-class greedy)
        existing: Dict[str, int] = {}
        for p in snapshot.pods_by_node[i]:
            for key, v in template_pod_device_usage(
                    p, templates_by_key).items():
                cls = key[len(DRA_RESOURCE_PREFIX):]
                existing[cls] = existing.get(cls, 0) + v
        free: List[Device] = []
        for dev in devices:
            if existing.get(dev.device_class, 0) > 0:
                existing[dev.device_class] -= 1
                for key, val in dev.consumes.items():
                    pools[key] = pools.get(key, 0.0) - val
                continue
            free.append(dev)

        # admin-access requests need an eligible device to exist, consumed
        # or not (they never allocate exclusively, dynamicresources
        # AdminAccess semantics); a node failing one is infeasible outright
        for r in list(reqs) + list(shared_reqs):
            if r.admin_access and not any(
                    _request_eligible(d, r, class_sel[r.device_class])
                    for d in devices):
                admin_ok[i] = False
        if not admin_ok[i]:
            continue                    # slots stay 0 → Insufficient

        consumes = [d.consumes for d in free]

        def build_units(rs_list):
            units: List[List[int]] = []
            for r in rs_list:
                if r.admin_access:
                    continue
                elig = [di for di, d in enumerate(free)
                        if _request_eligible(d, r,
                                             class_sel[r.device_class])]
                if r.count == COUNT_ALL:
                    # allocationMode All: take every matching device; at
                    # least one must exist (resource/v1 types.go:847)
                    if not elig:
                        return None
                    units.extend([elig] * len(elig))
                else:
                    units.extend([elig] * r.count)
            return units

        shared_units = None
        extra = 0.0
        if shared_reqs:
            shared_units = build_units(shared_reqs)
            if shared_units is None:
                continue                # All-mode shared with no devices
            can_host = _fits_k_clones(0, [], len(free), consumes, pools,
                                      shared_units=shared_units)
            if not can_host:
                continue                # node cannot host the allocation
            extra = 1.0                 # the first clone's shared charge

        units = build_units(reqs)
        if units is None:
            continue                    # slots stay 0 → cannot allocate
        if not units:
            slots[i] = _SLOTS_UNLIMITED
            continue
        n_shared = len(shared_units) if shared_units else 0
        cap = (len(free) - n_shared) // max(1, len(units))
        # _fits_k_clones is EXACT (greedy fast-accept + backtracking
        # settle; a shared allocation's units are searched JOINTLY with
        # the clones so a greedy shared reservation cannot strand the
        # pool), and exact feasibility is monotone in k, so binary search
        # finds the true maximum (not the greedy lower bound).  A
        # budget-exhausted probe (None) breaks monotonicity — fall back to
        # False there and rescue with exponential step-down probes
        # afterwards.
        unknown = False

        def fits(k: int) -> bool:
            nonlocal unknown
            r = _fits_k_clones(k, units, len(free), consumes, pools,
                               shared_units=shared_units)
            if r is None:
                unknown = True
                return False
            return r

        lo, hi = 0, cap
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if fits(mid):
                lo = mid
            else:
                hi = mid - 1
        if unknown:
            # any feasible k is a sound answer (greedy lower bound
            # semantics while the exact search is budget-starved)
            step, k = 1, cap
            while k > lo:
                if fits(k):
                    lo = k
                    break
                k -= step
                step *= 2
        slots[i] = float(lo) + extra
    return slots


def slice_device_map(resource_slices: Sequence[Mapping]
                     ) -> Dict[str, Dict[str, int]]:
    """One pass over all ResourceSlices → {nodeName: {dra/<class>: count}}.

    ResourceSlice reduced shape: spec.nodeName + spec.devices[] each with a
    deviceClassName (or spec.driver used as the class fallback)."""
    out: Dict[str, Dict[str, int]] = {}
    for rs in resource_slices:
        spec = rs.get("spec") or {}
        node = spec.get("nodeName")
        if not node:
            continue
        bucket = out.setdefault(node, {})
        for dev in spec.get("devices") or []:
            cls = dev.get("deviceClassName") or spec.get("driver") or ""
            if cls:
                key = DRA_RESOURCE_PREFIX + cls
                bucket[key] = bucket.get(key, 0) + 1
    return out


def node_device_counts(resource_slices: Sequence[Mapping],
                       node_name: str) -> Dict[str, int]:
    return slice_device_map(resource_slices).get(node_name, {})


def claim_index(resource_claims: Sequence[Mapping]
                ) -> Dict[Tuple[str, str], dict]:
    out = {}
    for c in resource_claims:
        meta = c.get("metadata") or {}
        out[(meta.get("namespace") or "default", meta.get("name", ""))] = c
    return out


def _claim_requests(claim_spec: Mapping) -> Dict[str, int]:
    """Device counts per class from a ResourceClaim spec
    (spec.devices.requests[]: {deviceClassName, count=1})."""
    out: Dict[str, int] = {}
    for req in ((claim_spec.get("devices") or {}).get("requests")) or []:
        cls = req.get("deviceClassName") or ""
        if not cls:
            continue
        count = int(req.get("count", 1) or 1)
        out[DRA_RESOURCE_PREFIX + cls] = \
            out.get(DRA_RESOURCE_PREFIX + cls, 0) + count
    return out


def allocation_node_selector(claim: Mapping) -> Optional[Mapping]:
    alloc = (claim.get("status") or {}).get("allocation") or {}
    return alloc.get("nodeSelector")


def _claim_slot_requests(claim_spec: Mapping) -> List[SlotRequest]:
    out = []
    for req in ((claim_spec.get("devices") or {}).get("requests")) or []:
        selectors = [s.get("cel", {}).get("expression", "")
                     for s in req.get("selectors") or [] if s.get("cel")]
        mode = req.get("allocationMode") or "ExactCount"
        count = COUNT_ALL if mode == "All" else int(req.get("count", 1) or 1)
        out.append(SlotRequest(
            device_class=req.get("deviceClassName") or "",
            count=count, selectors=[s for s in selectors if s],
            admin_access=bool(req.get("adminAccess"))))
    return out


def _needs_structured(sreqs: List[SlotRequest],
                      device_classes: Sequence[Mapping]) -> bool:
    for r in sreqs:
        if r.selectors or r.admin_access or r.count == COUNT_ALL:
            return True
        if _class_selectors(device_classes, r.device_class):
            return True
    return False


def encode(pod: Mapping, resource_claims: Sequence[Mapping],
           resource_claim_templates: Sequence[Mapping],
           namespace_default: str = "default",
           device_classes: Sequence[Mapping] = (),
           has_shared_counters: bool = False) -> DraEncoding:
    """Resolve the pod's spec.resourceClaims references.

    Template claims with CEL selectors / adminAccess / All-mode requests —
    or any claim when the slices publish shared counters (partitionable
    devices break per-class counting) — route through the structured
    host-side allocator (slot_requests); plain counted claims stay on the
    cheap pseudo-resource path."""
    enc = DraEncoding()
    spec = pod.get("spec") or {}
    refs = spec.get("resourceClaims") or []
    if not refs:
        return enc
    ns = (pod.get("metadata") or {}).get("namespace") or namespace_default
    claims = claim_index(resource_claims)
    templates = claim_index(resource_claim_templates)

    template_specs: List[Mapping] = []
    shared_specs: List[Mapping] = []    # unallocated shared named claims
    for ref in refs:
        claim_name = ref.get("resourceClaimName")
        tmpl_name = ref.get("resourceClaimTemplateName")
        if claim_name:
            claim = claims.get((ns, claim_name))
            if claim is None:
                enc.pod_level_reason = \
                    f'resourceclaim "{claim_name}" not found'
                return enc
            enc.shared_claim_colocate = True
            selector = allocation_node_selector(claim)
            if selector is not None:
                # already allocated: pin to the allocation's nodes; devices
                # were charged to that node at snapshot build
                enc.allocation_node_selectors.append(selector)
            else:
                # unallocated: the first clone allocates it
                shared_specs.append(claim.get("spec") or {})
        elif tmpl_name:
            tmpl = templates.get((ns, tmpl_name))
            if tmpl is None:
                enc.pod_level_reason = \
                    f'resourceclaimtemplate "{tmpl_name}" not found'
                return enc
            template_specs.append(((tmpl.get("spec") or {}).get("spec")) or {})

    all_sreqs: List[SlotRequest] = []
    for claim_spec in template_specs:
        all_sreqs.extend(_claim_slot_requests(claim_spec))
    shared_sreqs: List[SlotRequest] = []
    for claim_spec in shared_specs:
        shared_sreqs.extend(_claim_slot_requests(claim_spec))
    if (all_sreqs or shared_sreqs) and (
            has_shared_counters
            or _needs_structured(all_sreqs + shared_sreqs, device_classes)):
        # one structured request pulls EVERY request — template AND shared
        # — into the slot allocator: mixing paths would double-account
        # devices a plain request and a selector request both want
        enc.slot_requests = all_sreqs
        enc.shared_slot_requests = shared_sreqs
    else:
        for claim_spec in template_specs:
            for k, v in _claim_requests(claim_spec).items():
                enc.per_clone_requests[k] = \
                    enc.per_clone_requests.get(k, 0) + v
        for claim_spec in shared_specs:
            # devices charged once, at the first placement
            for k, v in _claim_requests(claim_spec).items():
                enc.shared_first_requests[k] = \
                    enc.shared_first_requests.get(k, 0) + v
    return enc


def template_pod_device_usage(pod: Mapping,
                              templates_by_key: Dict[Tuple[str, str], dict]
                              ) -> Dict[str, int]:
    """Devices an EXISTING pod consumes through claim templates (its own
    per-pod allocation).  Shared named claims are charged claim-centrically
    by the snapshot builder, not per pod."""
    out: Dict[str, int] = {}
    spec = pod.get("spec") or {}
    ns = (pod.get("metadata") or {}).get("namespace") or "default"
    for ref in spec.get("resourceClaims") or []:
        tmpl_name = ref.get("resourceClaimTemplateName")
        if not tmpl_name:
            continue
        tmpl = templates_by_key.get((ns, tmpl_name))
        if tmpl is None:
            continue
        claim_spec = ((tmpl.get("spec") or {}).get("spec")) or {}
        for k, v in _claim_requests(claim_spec).items():
            out[k] = out.get(k, 0) + v
    return out

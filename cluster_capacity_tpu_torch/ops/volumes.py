"""Volume plugin family: VolumeBinding, VolumeZone, VolumeRestrictions,
NodeVolumeLimits — all static masks over the node axis (PV/PVC/StorageClass
objects never change during a simulation), plus per-clone self-conflict flags
the engine applies dynamically.

Reference semantics (kube-scheduler plugins):
- VolumeBinding: vendor/.../plugins/volumebinding/volume_binding.go:353-447 —
  missing PVC is a pod-level UnschedulableAndUnresolvable; unbound immediate
  claims likewise; bound claims check PV nodeAffinity; WaitForFirstConsumer
  claims match available PVs or rely on dynamic provisioning.
- VolumeZone: vendor/.../plugins/volumezone/volume_zone.go:150-240 — bound
  PVs' zone/region labels must match node labels ("node(s) had no available
  volume zone").
- VolumeRestrictions: vendor/.../plugins/volumerestrictions/volume_restrictions.go
  — inline GCEPersistentDisk/AWSEBS/ISCSI/RBD conflicts ("node(s) had no
  available disk") and ReadWriteOncePod PVCs in use ("node(s) unavailable due
  to PersistentVolumeClaim with ReadWriteOncePod access mode already in-use by
  another pod").
- NodeVolumeLimits (CSI): vendor/.../plugins/nodevolumelimits/csi.go — unique
  CSI volumes per driver vs CSINode allocatable count
  ("node(s) exceed max volume count").
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Set, Tuple

import numpy as np

from ..models.labels import match_label_selector, match_node_selector
from ..models.snapshot import ClusterSnapshot

REASON_UNBOUND_IMMEDIATE = "pod has unbound immediate PersistentVolumeClaims"
REASON_NODE_CONFLICT = "node(s) had volume node affinity conflict"
REASON_BINDING = "node(s) didn't find available persistent volumes to bind"
REASON_ZONE_CONFLICT = "node(s) had no available volume zone"
REASON_DISK_CONFLICT = "node(s) had no available disk"
REASON_RWOP_CONFLICT = ("node(s) unavailable due to PersistentVolumeClaim with "
                        "ReadWriteOncePod access mode already in-use by "
                        "another pod")
REASON_MAX_VOLUME_COUNT = "node(s) exceed max volume count"
REASON_NOT_ENOUGH_SPACE = "node(s) did not have enough free storage"

_ZONE_LABELS = ("topology.kubernetes.io/zone", "topology.kubernetes.io/region",
                "failure-domain.beta.kubernetes.io/zone",
                "failure-domain.beta.kubernetes.io/region")


@dataclass
class VolumeVerdict:
    """Combined static result for all four volume plugins."""

    # Pod-level failure affecting every node (missing PVC / unbound immediate
    # claims): short-circuits the simulation at step 0.
    pod_level_reason: Optional[str] = None
    # per-node mask + reason (first failing volume plugin in MultiPoint order:
    # VolumeRestrictions, NodeVolumeLimits, VolumeBinding, VolumeZone)
    mask: Optional[np.ndarray] = None          # bool[N]
    reasons: Optional[List[Optional[str]]] = None
    # clones conflict with themselves on the same node (inline disk reuse)
    self_disk_conflict: bool = False
    # template uses a ReadWriteOncePod PVC → only one clone can ever mount it
    rwop_self_conflict: bool = False


def _pod_volumes(pod: Mapping) -> List[Mapping]:
    return (pod.get("spec") or {}).get("volumes") or []


def _pvc_map(snapshot: ClusterSnapshot, namespace: str) -> Dict[str, dict]:
    out = {}
    for pvc in snapshot.pvcs:
        meta = pvc.get("metadata") or {}
        if (meta.get("namespace") or "default") == namespace:
            out[meta.get("name", "")] = pvc
    return out


def _pv_map(snapshot: ClusterSnapshot) -> Dict[str, dict]:
    return {(pv.get("metadata") or {}).get("name", ""): pv
            for pv in snapshot.pvs}


def _sc_map(snapshot: ClusterSnapshot) -> Dict[str, dict]:
    return {(sc.get("metadata") or {}).get("name", ""): sc
            for sc in snapshot.storage_classes}


def evaluate(snapshot: ClusterSnapshot, pod: Mapping,
             filters_enabled) -> VolumeVerdict:
    """Run all four volume plugins' static logic for the template.

    Memoized per (snapshot, namespace, spec.volumes, enabled plugin set):
    the verdict reads ONLY those pod slices (the sweep dedup signature in
    parallel/sweep.py relies on the same contract), and a what-if sweep
    encodes many templates sharing a handful of volume shapes — the WFFC
    capacity walk is a Python loop over all N nodes, far too hot to repeat
    per template.  Treat the returned verdict as read-only."""
    import json
    meta_ns = (pod.get("metadata") or {}).get("namespace") or "default"
    key = ("vol_eval", meta_ns,
           json.dumps((pod.get("spec") or {}).get("volumes"),
                      sort_keys=True, default=str),
           tuple(filters_enabled(p) for p in (
               "VolumeBinding", "VolumeRestrictions", "NodeVolumeLimits",
               "VolumeZone")))
    return snapshot.memo(key, lambda: _evaluate_impl(snapshot, pod,
                                                     filters_enabled))


def _evaluate_impl(snapshot: ClusterSnapshot, pod: Mapping,
                   filters_enabled) -> VolumeVerdict:
    n = snapshot.num_nodes
    namespace = (pod.get("metadata") or {}).get("namespace") or "default"
    volumes = _pod_volumes(pod)
    verdict = VolumeVerdict(mask=np.ones(n, dtype=bool),
                            reasons=[None] * n)
    if not volumes:
        return verdict

    pvcs = _pvc_map(snapshot, namespace)
    pvs = _pv_map(snapshot)
    scs = _sc_map(snapshot)

    # Resolve the pod's PVC references once.
    claims: List[dict] = []
    for vol in volumes:
        ref = vol.get("persistentVolumeClaim")
        if not ref:
            continue
        name = ref.get("claimName", "")
        pvc = pvcs.get(name)
        if pvc is None:
            if filters_enabled("VolumeBinding"):
                verdict.pod_level_reason = \
                    f'persistentvolumeclaim "{name}" not found'
                return verdict
            continue
        claims.append(pvc)

    # ---------------- VolumeRestrictions ---------------------------------
    if filters_enabled("VolumeRestrictions"):
        _volume_restrictions(snapshot, pod, claims, verdict)
        if verdict.pod_level_reason:
            return verdict

    # ---------------- NodeVolumeLimits (CSI) -----------------------------
    if filters_enabled("NodeVolumeLimits") and claims:
        _csi_limits(snapshot, pod, claims, pvs, scs, verdict)

    # ---------------- VolumeBinding --------------------------------------
    if filters_enabled("VolumeBinding") and claims:
        _volume_binding(snapshot, claims, pvs, scs, verdict)
        if verdict.pod_level_reason:
            return verdict

    # ---------------- VolumeZone ------------------------------------------
    if filters_enabled("VolumeZone") and claims:
        _volume_zone(snapshot, claims, pvs, scs, verdict)

    return verdict


def _fail(verdict: VolumeVerdict, i: int, reason: str) -> None:
    if verdict.mask[i]:
        verdict.mask[i] = False
        verdict.reasons[i] = reason


# --- VolumeRestrictions -----------------------------------------------------

_DISK_KINDS = ("gcePersistentDisk", "awsElasticBlockStore", "iscsi", "rbd")


def _disk_key(vol: Mapping) -> Optional[Tuple]:
    for kind in _DISK_KINDS:
        src = vol.get(kind)
        if not src:
            continue
        if kind == "gcePersistentDisk":
            return (kind, src.get("pdName"), bool(src.get("readOnly")))
        if kind == "awsElasticBlockStore":
            return (kind, src.get("volumeID"), False)
        if kind == "iscsi":
            return (kind, (src.get("targetPortal"), src.get("iqn"),
                           src.get("lun")), bool(src.get("readOnly")))
        if kind == "rbd":
            return (kind, (tuple(src.get("monitors") or []), src.get("image"),
                           src.get("pool")), bool(src.get("readOnly")))
    return None


def _disks_conflict(a: Tuple, b: Tuple) -> bool:
    """isVolumeConflict: same disk conflicts unless both mounts are read-only
    (GCE PD / iSCSI / RBD allow shared read-only; AWS EBS never shares)."""
    kind_a, id_a, ro_a = a
    kind_b, id_b, ro_b = b
    if kind_a != kind_b or id_a != id_b:
        return False
    if kind_a == "awsElasticBlockStore":
        return True
    return not (ro_a and ro_b)


def _volume_restrictions(snapshot: ClusterSnapshot, pod: Mapping,
                         claims: List[dict], verdict: VolumeVerdict) -> None:
    pod_disks = [k for k in (_disk_key(v) for v in _pod_volumes(pod)) if k]

    # inline disk conflicts vs existing pods (per node) + clone self-conflict
    if pod_disks:
        for a in pod_disks:
            for b in pod_disks:
                if a is not b and _disks_conflict(a, b):
                    verdict.self_disk_conflict = True
        # a single disk mounted non-read-only by two clones also conflicts
        for a in pod_disks:
            if _disks_conflict(a, a):
                verdict.self_disk_conflict = True
        for i in range(snapshot.num_nodes):
            used = [k for p in snapshot.pods_by_node[i]
                    for k in (_disk_key(v) for v in _pod_volumes(p)) if k]
            if any(_disks_conflict(a, u) for a in pod_disks for u in used):
                _fail(verdict, i, REASON_DISK_CONFLICT)

    # ReadWriteOncePod: in use by ANY existing pod → pod-level unschedulable;
    # otherwise the first clone takes it and later clones conflict.
    rwop_names = set()
    for pvc in claims:
        modes = (pvc.get("spec") or {}).get("accessModes") or []
        if "ReadWriteOncePod" in modes:
            rwop_names.add((pvc.get("metadata") or {}).get("name", ""))
    if rwop_names:
        verdict.rwop_self_conflict = True
        ns = (pod.get("metadata") or {}).get("namespace") or "default"
        for plist in snapshot.pods_by_node:
            for p in plist:
                if ((p.get("metadata") or {}).get("namespace") or "default") != ns:
                    continue
                for vol in _pod_volumes(p):
                    ref = vol.get("persistentVolumeClaim") or {}
                    if ref.get("claimName") in rwop_names:
                        verdict.pod_level_reason = REASON_RWOP_CONFLICT
                        return


# --- NodeVolumeLimits (CSI) -------------------------------------------------

def _csi_driver_of(pv: Optional[dict], sc: Optional[dict]) -> Optional[str]:
    if pv:
        csi = ((pv.get("spec") or {}).get("csi")) or {}
        if csi.get("driver"):
            return csi["driver"]
    if sc:
        return sc.get("provisioner")
    return None


def _csi_limits(snapshot: ClusterSnapshot, pod: Mapping, claims: List[dict],
                pvs: Dict[str, dict], scs: Dict[str, dict],
                verdict: VolumeVerdict) -> None:
    csinode_by_name = {(c.get("metadata") or {}).get("name", ""): c
                       for c in snapshot.csinodes}
    if not csinode_by_name:
        return
    pvcs_by_ns: Dict[str, Dict[str, dict]] = {}
    for pvc in snapshot.pvcs:
        meta = pvc.get("metadata") or {}
        pvcs_by_ns.setdefault(meta.get("namespace") or "default", {})[
            meta.get("name", "")] = pvc

    def claim_driver_and_handle(pvc: dict) -> Tuple[Optional[str], str]:
        spec = pvc.get("spec") or {}
        pv = pvs.get(spec.get("volumeName") or "")
        sc = scs.get(spec.get("storageClassName") or "")
        driver = _csi_driver_of(pv, sc)
        handle = (((pv or {}).get("spec") or {}).get("csi") or {}).get(
            "volumeHandle") or f'pvc/{(pvc.get("metadata") or {}).get("name")}'
        return driver, handle

    new_by_driver: Dict[str, Set[str]] = {}
    for pvc in claims:
        driver, handle = claim_driver_and_handle(pvc)
        if driver:
            new_by_driver.setdefault(driver, set()).add(handle)
    if not new_by_driver:
        return

    for i, node_name in enumerate(snapshot.node_names):
        csinode = csinode_by_name.get(node_name)
        if csinode is None:
            continue
        limits = {}
        for drv in ((csinode.get("spec") or {}).get("drivers")) or []:
            count = ((drv.get("allocatable") or {}).get("count"))
            if count is not None:
                limits[drv.get("name")] = int(count)
        if not limits:
            continue
        # unique volumes already attached per driver
        used: Dict[str, Set[str]] = {}
        for p in snapshot.pods_by_node[i]:
            p_ns = (p.get("metadata") or {}).get("namespace") or "default"
            p_pvcs = pvcs_by_ns.get(p_ns, {})
            for vol in _pod_volumes(p):
                ref = vol.get("persistentVolumeClaim") or {}
                pvc = p_pvcs.get(ref.get("claimName", ""))
                if pvc is None:
                    continue
                driver, handle = claim_driver_and_handle(pvc)
                if driver:
                    used.setdefault(driver, set()).add(handle)
        for driver, new_handles in new_by_driver.items():
            if driver not in limits:
                continue
            total = len(used.get(driver, set()) | new_handles)
            if total > limits[driver]:
                _fail(verdict, i, REASON_MAX_VOLUME_COUNT)
                break


# --- VolumeBinding ----------------------------------------------------------

def _pv_matches_claim(pv: dict, pvc: dict) -> bool:
    """Simplified PV↔PVC matching: storage class, access modes, capacity."""
    pv_spec = pv.get("spec") or {}
    pvc_spec = pvc.get("spec") or {}
    if (pv_spec.get("storageClassName") or "") != \
            (pvc_spec.get("storageClassName") or ""):
        return False
    want_modes = set(pvc_spec.get("accessModes") or [])
    have_modes = set(pv_spec.get("accessModes") or [])
    if not want_modes.issubset(have_modes):
        return False
    if (pv_spec.get("claimRef") or {}).get("name") not in (
            None, (pvc.get("metadata") or {}).get("name")):
        return False
    from ..utils.quantity import parse_quantity
    want = ((pvc_spec.get("resources") or {}).get("requests") or {}).get("storage")
    have = (pv_spec.get("capacity") or {}).get("storage")
    if want is not None and have is not None:
        if parse_quantity(have) < parse_quantity(want):
            return False
    return True


def _pv_node_ok(pv: dict, snapshot: ClusterSnapshot, i: int) -> bool:
    affinity = ((pv.get("spec") or {}).get("nodeAffinity") or {}).get("required")
    if affinity is None:
        return True
    return match_node_selector(affinity, snapshot.node_labels(i),
                               snapshot.node_names[i])


def _topology_terms_match(terms: List[dict], labels: Mapping[str, str]) -> bool:
    """v1helper.MatchTopologySelectorTerms: ANY term matches, every
    matchLabelExpression of the term must match (key present, value in set)."""
    if not terms:
        return True
    for term in terms:
        exprs = term.get("matchLabelExpressions") or []
        ok = True
        for e in exprs:
            val = labels.get(e.get("key", ""))
            if val is None or val not in (e.get("values") or []):
                ok = False
                break
        if ok:
            return True
    return False


def _claim_size(pvc: dict) -> int:
    from ..utils.quantity import parse_quantity
    want = (((pvc.get("spec") or {}).get("resources") or {})
            .get("requests") or {}).get("storage")
    return int(parse_quantity(want)) if want is not None else 0


def _has_enough_capacity(snapshot: ClusterSnapshot, pvc: dict, sc: dict,
                         i: int) -> bool:
    """binder.go hasEnoughCapacity: when the driver publishes
    CSIStorageCapacity objects for the storage class, some object whose
    nodeTopology matches the node must cover the claim size (and its
    maximumVolumeSize, when set, must too); a driver publishing nothing is
    assumed unlimited."""
    from ..utils.quantity import parse_quantity

    sc_name = (sc.get("metadata") or {}).get("name", "")
    relevant = [c for c in snapshot.csistoragecapacities
                if c.get("storageClassName") == sc_name]
    if not relevant:
        return True
    size = _claim_size(pvc)
    labels = snapshot.node_labels(i)
    for cap in relevant:
        topo = cap.get("nodeTopology")
        if topo is not None and not match_label_selector(topo, labels):
            continue
        capacity = cap.get("capacity")
        if capacity is None or parse_quantity(capacity) < size:
            continue
        max_size = cap.get("maximumVolumeSize")
        if max_size is not None and parse_quantity(max_size) < size:
            continue
        return True
    return False


def _volume_binding(snapshot: ClusterSnapshot, claims: List[dict],
                    pvs: Dict[str, dict], scs: Dict[str, dict],
                    verdict: VolumeVerdict) -> None:
    bound, wait_unbound = [], []
    for pvc in claims:
        spec = pvc.get("spec") or {}
        if spec.get("volumeName"):
            bound.append(pvc)
            continue
        sc = scs.get(spec.get("storageClassName") or "")
        mode = (sc or {}).get("volumeBindingMode") or "Immediate"
        if sc is None or mode == "Immediate":
            verdict.pod_level_reason = REASON_UNBOUND_IMMEDIATE
            return
        wait_unbound.append((pvc, sc))

    for i in range(snapshot.num_nodes):
        if not verdict.mask[i]:
            continue
        for pvc in bound:
            pv = pvs.get((pvc.get("spec") or {}).get("volumeName") or "")
            if pv is None or not _pv_node_ok(pv, snapshot, i):
                _fail(verdict, i, REASON_NODE_CONFLICT)
                break
        if not verdict.mask[i]:
            continue
        for pvc, sc in wait_unbound:
            provisioner = sc.get("provisioner") or ""
            if provisioner and provisioner != "kubernetes.io/no-provisioner":
                # dynamic provisioning (binder.go checkVolumeProvisions):
                # the class's allowedTopologies must admit the node, and the
                # driver's published CSIStorageCapacity must cover the claim.
                if not _topology_terms_match(
                        sc.get("allowedTopologies") or [],
                        snapshot.node_labels(i)):
                    _fail(verdict, i, REASON_BINDING)
                    break
                if not _has_enough_capacity(snapshot, pvc, sc, i):
                    _fail(verdict, i, REASON_NOT_ENOUGH_SPACE)
                    break
                continue
            # static provisioning: some unbound (or pre-bound-to-this-claim)
            # PV must match claim + node.
            candidates = [pv for pv in pvs.values()
                          if _pv_matches_claim(pv, pvc)]
            if not any(_pv_node_ok(pv, snapshot, i) for pv in candidates):
                _fail(verdict, i, REASON_BINDING)
                break


# --- VolumeZone -------------------------------------------------------------

def _volume_zone(snapshot: ClusterSnapshot, claims: List[dict],
                 pvs: Dict[str, dict], scs: Dict[str, dict],
                 verdict: VolumeVerdict) -> None:
    topologies: List[Tuple[str, Set[str]]] = []
    for pvc in claims:
        pv_name = (pvc.get("spec") or {}).get("volumeName")
        if not pv_name:
            continue
        pv = pvs.get(pv_name)
        if pv is None:
            continue
        for key, val in ((pv.get("metadata") or {}).get("labels") or {}).items():
            if key in _ZONE_LABELS:
                topologies.append((key, set(val.split("__"))))

    if not topologies:
        return
    for i in range(snapshot.num_nodes):
        if not verdict.mask[i]:
            continue
        labels = snapshot.node_labels(i)
        if not any(k in labels for k in _ZONE_LABELS):
            continue  # single-zone cluster fast path
        for key, values in topologies:
            v = labels.get(key)
            if v is None:
                v = labels.get(_beta_to_ga(key))
            if v is None or v not in values:
                _fail(verdict, i, REASON_ZONE_CONFLICT)
                break


def _beta_to_ga(key: str) -> str:
    return key.replace("failure-domain.beta.kubernetes.io/",
                       "topology.kubernetes.io/")

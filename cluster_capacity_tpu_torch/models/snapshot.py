"""Tensorized cluster snapshot — the framework's core data model.

Host numpy arrays over a fixed node axis, built the way the reference's
SyncWithClient copies a cluster (pkg/framework/simulator.go:176-295); the
engine moves them to the device once per solve.  NodeInfo semantics mirrored:
- per-node Requested / NonZeroRequested / Allocatable resource vectors
  (vendor/.../scheduler/framework/types.go:160-200,940-948)
- pod rosters kept as python lists for host-side precomputation only.

Resource axis layout: index 0=pods, 1=cpu (milli), 2=memory (bytes),
3=ephemeral-storage (bytes), 4..=scalar resource vocabulary (sorted names).

Resource columns past the scalars: one `dra/<DeviceClass>` column per
device class that ResourceSlices publish (sorted), with the devices each
node publishes as allocatable (ops/dynamic_resources.py).  The resource
aggregation runs in Python; use_native=True runs it through the native
snapshot compiler instead (models/native.py, a build of native/ccsnap.cpp),
which is slower at 10,000 nodes (PERF.md) and stays opt-in.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .podspec import (RES_CPU, RES_EPHEMERAL, RES_MEMORY, RES_PODS,
                      is_scalar_resource_name, pod_host_ports,
                      pod_nonzero_cpu_mem, pod_requests)
from ..runtime.errors import SnapshotValidationError
from ..utils.quantity import QuantityError, int_value, milli_value

IDX_PODS = 0
IDX_CPU = 1
IDX_MEM = 2
IDX_EPHEMERAL = 3
N_BASE_RESOURCES = 4

_TERMINAL_PHASES = ("Succeeded", "Failed")

# Auxiliary-object kinds a snapshot carries.
OBJECT_FIELDS = ("services", "pvcs", "pvs", "csinodes", "limit_ranges",
                 "priority_classes", "pdbs", "replication_controllers",
                 "replica_sets", "stateful_sets", "storage_classes",
                 "namespaces", "csistoragecapacities",
                 "resource_slices", "resource_claims",
                 "resource_claim_templates", "device_classes")


def _parse_allocatable(alloc: Mapping,
                       field_path: str = "") -> Dict[str, int]:
    out: Dict[str, int] = {}
    for name, q in (alloc or {}).items():
        try:
            out[name] = milli_value(q) if name == RES_CPU else int_value(q)
        except QuantityError as exc:
            raise SnapshotValidationError(
                str(exc),
                field_path=f"{field_path}.{name}" if field_path
                else str(name)) from exc
    return out


def _pod_path(pod, fallback: str) -> str:
    """pods[<ns>/<name>] when identifiable, else the positional fallback."""
    try:
        meta = pod.get("metadata") or {}
        name = meta.get("name") or ""
        ns = meta.get("namespace") or "default"
        if name:
            return f"pods[{ns}/{name}]"
    except AttributeError:
        pass
    return fallback


def _validated_pod_requests(pod, fallback: str) -> Dict[str, int]:
    path = _pod_path(pod, fallback)
    try:
        return pod_requests(pod)
    except QuantityError as exc:
        raise SnapshotValidationError(
            str(exc),
            field_path=f"{path}.spec.containers.resources.requests") from exc
    except (AttributeError, TypeError, KeyError, IndexError) as exc:
        raise SnapshotValidationError(
            f"malformed pod spec: {type(exc).__name__}: {exc}",
            field_path=f"{path}.spec") from exc


@dataclass
class ClusterSnapshot:
    """Immutable snapshot of cluster state over a fixed node axis."""

    nodes: List[dict]                      # node objects, in node-axis order
    node_names: List[str]
    resource_names: List[str]              # resource-axis vocabulary
    allocatable: np.ndarray                # f64[N, R]
    requested: np.ndarray                  # f64[N, R] incl. pod count at IDX_PODS
    nonzero_requested: np.ndarray          # f64[N, 2] (cpu milli, mem bytes)
    pods_by_node: List[List[dict]]         # existing (non-terminal) pods per node
    services: List[dict] = field(default_factory=list)
    pvcs: List[dict] = field(default_factory=list)
    pvs: List[dict] = field(default_factory=list)
    csinodes: List[dict] = field(default_factory=list)
    limit_ranges: List[dict] = field(default_factory=list)
    priority_classes: List[dict] = field(default_factory=list)
    pdbs: List[dict] = field(default_factory=list)
    replication_controllers: List[dict] = field(default_factory=list)
    replica_sets: List[dict] = field(default_factory=list)
    stateful_sets: List[dict] = field(default_factory=list)
    storage_classes: List[dict] = field(default_factory=list)
    namespaces: List[dict] = field(default_factory=list)
    csistoragecapacities: List[dict] = field(default_factory=list)
    resource_slices: List[dict] = field(default_factory=list)
    resource_claims: List[dict] = field(default_factory=list)
    resource_claim_templates: List[dict] = field(default_factory=list)
    device_classes: List[dict] = field(default_factory=list)

    @property
    def num_nodes(self) -> int:
        return len(self.nodes)

    @property
    def num_resources(self) -> int:
        return len(self.resource_names)

    def resource_index(self, name: str) -> Optional[int]:
        try:
            return self.resource_names.index(name)
        except ValueError:
            return None

    def node_labels(self, i: int) -> Mapping[str, str]:
        return (self.nodes[i].get("metadata") or {}).get("labels") or {}

    def node_taints(self, i: int) -> Sequence[Mapping]:
        return (self.nodes[i].get("spec") or {}).get("taints") or []

    def node_unschedulable(self, i: int) -> bool:
        return bool((self.nodes[i].get("spec") or {}).get("unschedulable"))

    def node_images(self, i: int) -> Dict[str, int]:
        """Normalized image name → sizeBytes for node i (NodeInfo.ImageStates)."""
        out: Dict[str, int] = {}
        for img in ((self.nodes[i].get("status") or {}).get("images") or []):
            size = int(img.get("sizeBytes", 0))
            for name in img.get("names") or []:
                out[_normalize_image(name)] = size
        return out

    def node_used_host_ports(self, i: int) -> List[Tuple[str, str, int]]:
        out = []
        for pod in self.pods_by_node[i]:
            out.extend(pod_host_ports(pod))
        return out

    def memo(self, key, fn):
        """Per-snapshot memo of node-derived host arrays (frozen: callers
        copy before mutating)."""
        if not hasattr(self, "_memo"):
            object.__setattr__(self, "_memo", {})
        if key not in self._memo:
            val = fn()
            if isinstance(val, np.ndarray):
                val.flags.writeable = False
            elif isinstance(val, tuple):
                for v in val:
                    if isinstance(v, np.ndarray):
                        v.flags.writeable = False
            self._memo[key] = val
        return self._memo[key]

    def topology_domains(self, key: str) -> Tuple[np.ndarray, dict]:
        """(node_domain i32[N], value→index vocab) for one topology label
        key, vocabulary in node-axis order."""
        def build():
            n = self.num_nodes
            node_domain = np.full(n, -1, dtype=np.int32)
            vocab: Dict[str, int] = {}
            for i in range(n):
                val = self.node_labels(i).get(key)
                if val is None:
                    continue
                if val not in vocab:
                    vocab[val] = len(vocab)
                node_domain[i] = vocab[val]
            return node_domain, vocab
        return self.memo(("topology_domains", key), build)

    def labels_have_key(self, key: str) -> np.ndarray:
        """bool[N]: node carries the label key."""
        return self.memo(("labels_have_key", key),
                         lambda: self.topology_domains(key)[0] >= 0)

    def nodes_with_pods(self) -> List[int]:
        """Node indices with a non-empty pod roster."""
        return self.memo(("nodes_with_pods",),
                         lambda: [i for i, p in enumerate(self.pods_by_node)
                                  if p])

    @classmethod
    def from_objects(cls, nodes: Sequence[Mapping],
                     pods: Sequence[Mapping] = (),
                     exclude_nodes: Sequence[str] = (),
                     sort_nodes: bool = True,
                     node_order: Optional[str] = None,
                     use_native: Optional[bool] = None,
                     **extra_objects) -> "ClusterSnapshot":
        """Build a snapshot the way SyncWithClient does: skip excluded nodes
        (simulator.go:209), drop terminal pods (:196), pivot pods onto their
        nodes (NewSnapshot, backend/cache/snapshot.go:86-107).  Nodes are
        sorted by name by default for a deterministic node-axis order;
        node_order="zone-round-robin" takes the reference scheduler's
        iteration order instead.

        use_native: True aggregates the resource tensors through the native
        compiler (models/native.py; raises when it cannot build); None and
        False aggregate in Python.  node_order, sort_nodes=False and
        ResourceSlices (the DRA device columns) refuse use_native=True."""
        unknown = set(extra_objects) - set(OBJECT_FIELDS)
        if unknown:
            raise TypeError(f"unknown snapshot object kinds: {sorted(unknown)}")
        for i, n in enumerate(nodes):
            if not isinstance(n, Mapping):
                raise SnapshotValidationError(
                    f"node object is {type(n).__name__}, expected a mapping",
                    field_path=f"nodes[{i}]")
        for i, p in enumerate(pods):
            if not isinstance(p, Mapping):
                raise SnapshotValidationError(
                    f"pod object is {type(p).__name__}, expected a mapping",
                    field_path=f"pods[{i}]")
        excluded = set(exclude_nodes)
        node_list = [dict(n) for n in nodes
                     if (n.get("metadata") or {}).get("name") not in excluded]
        if sort_nodes:
            node_list.sort(key=lambda n: (n.get("metadata") or {}).get("name", ""))
        if node_order == "zone-round-robin":
            if use_native:
                raise ValueError("use_native=True is incompatible with "
                                 "node_order (native emits the sorted axis)")
            node_list = zone_round_robin_order(node_list)
        names = [(n.get("metadata") or {}).get("name", "") for n in node_list]
        index_of = {name: i for i, name in enumerate(names)}

        pods_by_node: List[List[dict]] = [[] for _ in node_list]
        for pod in pods:
            phase = ((pod.get("status") or {}).get("phase")) or ""
            if phase in _TERMINAL_PHASES:
                continue
            node_name = (pod.get("spec") or {}).get("nodeName") or ""
            if node_name in index_of:
                pods_by_node[index_of[node_name]].append(dict(pod))

        if use_native and not sort_nodes:
            raise ValueError("use_native=True requires sort_nodes=True "
                             "(the native compiler emits a sorted node axis)")
        if use_native and extra_objects.get("resource_slices"):
            raise ValueError("use_native=True unsupported with "
                             "ResourceSlices (DRA device columns)")
        if use_native:
            from . import native
            if not native.available():
                raise RuntimeError(
                    "use_native=True but the native snapshot compiler "
                    f"is not available: {native.build_error()}")
            compiled = native.compile_snapshot(
                {"nodes": [dict(n) for n in nodes],
                 "pods": [dict(p) for p in pods]},
                exclude_nodes=exclude_nodes)
            if compiled.node_names != names:
                raise RuntimeError("native snapshot compiler node-axis "
                                   "mismatch")
            return cls(nodes=node_list, node_names=names,
                       resource_names=compiled.resource_names,
                       allocatable=compiled.allocatable,
                       requested=compiled.requested,
                       nonzero_requested=compiled.nonzero,
                       pods_by_node=pods_by_node,
                       **_extra_kwargs(extra_objects))

        # Resource vocabulary: base + scalars seen in allocatable or requests.
        scalars = set()
        alloc_maps = []
        for i, n in enumerate(node_list):
            alloc = (n.get("status") or {}).get("allocatable")
            if alloc is not None and not isinstance(alloc, Mapping):
                raise SnapshotValidationError(
                    f"allocatable is {type(alloc).__name__}, expected a "
                    f"mapping",
                    field_path=f"nodes[{i}].status.allocatable")
            am = _parse_allocatable(
                alloc, field_path=f"nodes[{i}].status.allocatable")
            alloc_maps.append(am)
            scalars.update(k for k in am if is_scalar_resource_name(k))
        req_maps: List[Dict[str, int]] = []
        for ni, plist in enumerate(pods_by_node):
            agg: Dict[str, int] = {}
            for pi, pod in enumerate(plist):
                reqs = _validated_pod_requests(
                    pod, f"nodes[{ni}].pods[{pi}]")
                for k, v in reqs.items():
                    agg[k] = agg.get(k, 0) + v
            req_maps.append(agg)
            scalars.update(k for k in agg if is_scalar_resource_name(k))
        slices = list(extra_objects.get("resource_slices", ()))
        dra_classes = set()
        device_map = {}
        if slices:
            from ..ops.dynamic_resources import slice_device_map
            device_map = slice_device_map(slices)
            for counts in device_map.values():
                dra_classes.update(counts)
        resource_names = [RES_PODS, RES_CPU, RES_MEMORY, RES_EPHEMERAL] + \
            sorted(scalars) + sorted(dra_classes)
        r_index = {r: i for i, r in enumerate(resource_names)}

        n_nodes, n_res = len(node_list), len(resource_names)
        allocatable = np.zeros((n_nodes, n_res), dtype=np.float64)
        requested = np.zeros((n_nodes, n_res), dtype=np.float64)
        nonzero = np.zeros((n_nodes, 2), dtype=np.float64)
        for i in range(n_nodes):
            for k, v in alloc_maps[i].items():
                j = r_index.get(k)
                if j is not None:
                    allocatable[i, j] = v
            for k, v in req_maps[i].items():
                j = r_index.get(k)
                if j is not None:
                    requested[i, j] = v
            requested[i, IDX_PODS] = len(pods_by_node[i])
            for pi, pod in enumerate(pods_by_node[i]):
                try:
                    cpu, mem = pod_nonzero_cpu_mem(pod)
                except QuantityError as exc:
                    raise SnapshotValidationError(
                        str(exc),
                        field_path=f"{_pod_path(pod, f'nodes[{i}].pods[{pi}]')}"
                                   f".spec.containers.resources") from exc
                nonzero[i, 0] += cpu
                nonzero[i, 1] += mem

        if slices:
            _charge_devices(node_list, names, pods_by_node, device_map,
                            r_index, allocatable, requested, extra_objects)

        return cls(nodes=node_list, node_names=names,
                   resource_names=resource_names, allocatable=allocatable,
                   requested=requested, nonzero_requested=nonzero,
                   pods_by_node=pods_by_node,
                   **_extra_kwargs(extra_objects))


def _extra_kwargs(extra_objects: Mapping) -> dict:
    return {k: list(extra_objects.get(k, ())) for k in OBJECT_FIELDS}


def _charge_devices(node_list, names, pods_by_node, device_map, r_index,
                    allocatable, requested, extra_objects) -> None:
    """Fill the dra/<class> columns in place: the devices each node's
    ResourceSlices publish as allocatable; existing pods' template claims
    as requested on their node; each shared ResourceClaim charged once,
    claim-centrically — an allocated claim to the node its allocation
    selector targets, an unallocated claim referenced by existing pods to
    the first referencing pod's node."""
    from ..models.labels import match_node_selector
    from ..ops.dynamic_resources import (
        _claim_requests, allocation_node_selector, claim_index,
        template_pod_device_usage)
    n_nodes = len(node_list)
    for i in range(n_nodes):
        for k, v in device_map.get(names[i], {}).items():
            allocatable[i, r_index[k]] = v
    templates_by_key = claim_index(
        extra_objects.get("resource_claim_templates", ()))
    for i in range(n_nodes):
        for pod in pods_by_node[i]:
            for k, v in template_pod_device_usage(
                    pod, templates_by_key).items():
                if k in r_index:
                    requested[i, r_index[k]] += v
    referencing_node = {}
    for i in range(n_nodes):
        for pod in pods_by_node[i]:
            p_ns = (pod.get("metadata") or {}).get("namespace") or "default"
            for ref in (pod.get("spec") or {}).get("resourceClaims") or []:
                nm = ref.get("resourceClaimName")
                if nm:
                    referencing_node.setdefault((p_ns, nm), i)
    for key, claim in claim_index(
            extra_objects.get("resource_claims", ())).items():
        reqs_c = _claim_requests(claim.get("spec") or {})
        if not reqs_c:
            continue
        target = None
        selector = allocation_node_selector(claim)
        if selector is not None:
            for i in range(n_nodes):
                labels = (node_list[i].get("metadata") or {}).get("labels") \
                    or {}
                if match_node_selector(selector, labels, names[i]):
                    target = i
                    break
        elif key in referencing_node:
            target = referencing_node[key]
        if target is not None:
            for k, v in reqs_c.items():
                if k in r_index:
                    requested[target, r_index[k]] += v


def with_pods_by_node(snapshot: ClusterSnapshot,
                      pods_by_node: List[List[dict]],
                      changed: Sequence[int]) -> Optional[ClusterSnapshot]:
    """Incremental re-snapshot: same nodes/vocabulary, new pod rosters —
    only the `changed` nodes' requested/nonzero rows recompute (the
    cache.UpdateSnapshot analog, backend/cache/cache.go:194, replacing the
    O(rounds x full-encode) rebuild in deep preemption chains).

    Returns None when incremental rules don't hold (shared ResourceClaims
    charge nodes globally; a pod requesting a resource outside the
    vocabulary changes the resource axis) — callers fall back to
    from_objects."""
    if snapshot.resource_claims:
        return None
    from dataclasses import replace as dc_replace

    requested = snapshot.requested.copy()
    nonzero = snapshot.nonzero_requested.copy()
    r_index = {r: i for i, r in enumerate(snapshot.resource_names)}
    templates_by_key = None
    if snapshot.resource_slices:
        from ..ops.dynamic_resources import claim_index
        templates_by_key = claim_index(snapshot.resource_claim_templates)

    for i in changed:
        row = np.zeros(len(snapshot.resource_names), dtype=np.float64)
        cz = mz = 0.0
        for pod in pods_by_node[i]:
            for k, v in pod_requests(pod).items():
                j = r_index.get(k)
                if j is None:
                    return None            # new resource → vocabulary change
                row[j] += v
            if templates_by_key is not None:
                from ..ops.dynamic_resources import template_pod_device_usage
                for k, v in template_pod_device_usage(
                        pod, templates_by_key).items():
                    if k in r_index:
                        row[r_index[k]] += v
            cpu, mem = pod_nonzero_cpu_mem(pod)
            cz += cpu
            mz += mem
        row[IDX_PODS] = len(pods_by_node[i])
        requested[i] = row
        nonzero[i] = (cz, mz)
    return dc_replace(snapshot,
                      pods_by_node=[list(p) for p in pods_by_node],
                      requested=requested, nonzero_requested=nonzero)


def zone_round_robin_order(node_list: List[dict]) -> List[dict]:
    """Zone round-robin node ordering (vendor/.../backend/cache/node_tree.go):
    group by topology.kubernetes.io/zone (region/zone pair), emit one node per
    zone in rotation — the order the reference's scheduler iterates nodes in.
    The default sorted order is the parity-mode convention."""
    zones: Dict[str, List[dict]] = {}
    for n in node_list:
        labels = (n.get("metadata") or {}).get("labels") or {}
        zone = (labels.get("topology.kubernetes.io/region", "") + ":" +
                labels.get("topology.kubernetes.io/zone", ""))
        zones.setdefault(zone, []).append(n)
    ordered: List[dict] = []
    buckets = [zones[z] for z in sorted(zones)]
    while buckets:
        for b in buckets:
            ordered.append(b.pop(0))
        buckets = [b for b in buckets if b]
    return ordered


def _normalize_image(name: str) -> str:
    """CRI image-name normalization (image_locality.go:120-127)."""
    if name.rfind(":") <= name.rfind("/"):
        name = name + ":latest"
    return name

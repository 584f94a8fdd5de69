"""Pod template model: YAML/JSON parsing, API defaulting, resource requests.

Mirrors the behaviour of:
- pod spec load + defaulting + validation:
  cmd/cluster-capacity/app/options/options.go:79-147 (ParseAPISpec)
- pod resource request computation (Filter path):
  vendor/k8s.io/kubernetes/pkg/scheduler/framework/plugins/noderesources/fit.go:224
  → resourcehelper.PodRequests (max(sum(containers), initContainers) + overhead,
  with sidecar (restartPolicy: Always) init containers summed).
- non-zero request defaults for scoring (100 mCPU / 200 MB):
  vendor/k8s.io/kubernetes/pkg/scheduler/util/pod_resources.go:28-31

Pods are held as plain dicts in Kubernetes v1 JSON shape; this module provides
typed accessors over them.  All computation here is host-side.
"""

from __future__ import annotations

import copy
import json
import uuid
from typing import Dict, List, Mapping, Tuple

import yaml

from ..utils.quantity import int_value, milli_value

DEFAULT_SCHEDULER_NAME = "default-scheduler"
DEFAULT_NAMESPACE = "default"
# Annotation the simulator stamps on generated pods; the stop-condition watcher
# keys on it (pkg/framework/simulator.go:50-52,331).
PROVISIONED_BY_ANNOTATION = "cc.kubernetes.io/provisioned-by"
PROVISIONER_NAME = "cluster-capacity"

# Scoring-only defaults for containers with no cpu/mem request
# (pod_resources.go:28-31).
DEFAULT_MILLI_CPU_REQUEST = 100
DEFAULT_MEMORY_REQUEST = 200 * 1024 * 1024

# Well-known resource names.
RES_PODS = "pods"
RES_CPU = "cpu"
RES_MEMORY = "memory"
RES_EPHEMERAL = "ephemeral-storage"
_NON_SCALAR = {RES_PODS, RES_CPU, RES_MEMORY, RES_EPHEMERAL, "storage",
               "hugepages-"}


def is_scalar_resource_name(name: str) -> bool:
    """schedutil.IsScalarResourceName: extended (domain-prefixed, not
    kubernetes.io native request), hugepages-*, or attachable-volumes-*."""
    if name.startswith("hugepages-") or name.startswith("attachable-volumes-"):
        return True
    # Extended resources: any fully-qualified name outside kubernetes.io
    # (IsExtendedResourceName: not native + not prefixed "requests.").
    if name in (RES_CPU, RES_MEMORY, RES_EPHEMERAL, RES_PODS, "storage"):
        return False
    if name.startswith("requests."):
        return False
    return "/" in name


class PodSpecError(ValueError):
    pass


def load_pod_yaml(path: str) -> dict:
    with open(path) as f:
        text = f.read()
    return parse_pod_text(text)


def parse_pod_text(text: str) -> dict:
    text = text.strip()
    if text.startswith("{"):
        pod = json.loads(text)
    else:
        pod = yaml.safe_load(text)
    if not isinstance(pod, dict):
        raise PodSpecError("pod spec did not parse to an object")
    return pod


def default_pod(pod: dict) -> dict:
    """Apply the defaulting ParseAPISpec applies (options.go:100-144)."""
    pod = copy.deepcopy(pod)
    meta = pod.setdefault("metadata", {})
    if not meta.get("namespace"):
        meta["namespace"] = DEFAULT_NAMESPACE
    if not meta.get("name"):
        raise PodSpecError("pod spec must have metadata.name")
    spec = pod.setdefault("spec", {})
    if not spec.get("schedulerName"):
        spec["schedulerName"] = DEFAULT_SCHEDULER_NAME
    if not spec.get("dnsPolicy"):
        spec["dnsPolicy"] = "ClusterFirst"
    if not spec.get("restartPolicy"):
        spec["restartPolicy"] = "Always"
    for c in spec.get("containers") or []:
        if not c.get("terminationMessagePolicy"):
            c["terminationMessagePolicy"] = "File"
        if not c.get("terminationMessagePath"):
            c["terminationMessagePath"] = "/dev/termination-log"
        if not c.get("imagePullPolicy"):
            tag = c.get("image", "").rsplit(":", 1)
            c["imagePullPolicy"] = ("Always" if len(tag) == 2 and tag[1] == "latest"
                                    or ":" not in c.get("image", "") else "IfNotPresent")
    return pod


def validate_pod(pod: dict) -> None:
    """Subset of ValidatePodCreate the simulator relies on."""
    spec = pod.get("spec") or {}
    if not spec.get("containers"):
        raise PodSpecError("pod spec must declare at least one container")
    for c in spec["containers"]:
        if not c.get("name"):
            raise PodSpecError("containers must be named")


def _requests_of(container: Mapping) -> Dict[str, int]:
    """Container requests → {resource: int}, cpu in milli, others in units."""
    out: Dict[str, int] = {}
    reqs = ((container.get("resources") or {}).get("requests")) or {}
    for name, q in reqs.items():
        out[name] = milli_value(q) if name == RES_CPU else int_value(q)
    return out


def _add(a: Dict[str, int], b: Mapping[str, int]) -> None:
    for k, v in b.items():
        a[k] = a.get(k, 0) + v


def _max_into(a: Dict[str, int], b: Mapping[str, int]) -> None:
    for k, v in b.items():
        if v > a.get(k, 0):
            a[k] = v


def pod_requests(pod: Mapping, non_missing_defaults: bool = False) -> Dict[str, int]:
    """resourcehelper.PodRequests.

    cpu is in milli-units, everything else in plain units (bytes for memory).
    With non_missing_defaults=True, containers missing a cpu/mem request are
    treated as requesting 100m / 200MB (scoring path, resource_allocation.go:126-131).
    """
    spec = pod.get("spec") or {}
    reqs: Dict[str, int] = {}

    def with_defaults(r: Dict[str, int]) -> Dict[str, int]:
        if not non_missing_defaults:
            return r
        r = dict(r)
        r.setdefault(RES_CPU, DEFAULT_MILLI_CPU_REQUEST)
        r.setdefault(RES_MEMORY, DEFAULT_MEMORY_REQUEST)
        return r

    for c in spec.get("containers") or []:
        _add(reqs, with_defaults(_requests_of(c)))

    init_reqs: Dict[str, int] = {}
    restartable_sum: Dict[str, int] = {}
    for c in spec.get("initContainers") or []:
        c_reqs = with_defaults(_requests_of(c))
        if c.get("restartPolicy") == "Always":
            _add(reqs, c_reqs)
            _add(restartable_sum, c_reqs)
            c_reqs = dict(restartable_sum)
        else:
            c_reqs = dict(c_reqs)
            _add(c_reqs, restartable_sum)
        _max_into(init_reqs, c_reqs)
    _max_into(reqs, init_reqs)

    for name, q in (spec.get("overhead") or {}).items():
        reqs[name] = reqs.get(name, 0) + (milli_value(q) if name == RES_CPU
                                          else int_value(q))
    return reqs


def pod_nonzero_cpu_mem(pod: Mapping) -> Tuple[int, int]:
    """GetNonzeroRequests: (milliCPU, memoryBytes) with 100m/200MB defaults,
    used to maintain NodeInfo.NonZeroRequested."""
    reqs = pod_requests(pod, non_missing_defaults=True)
    return reqs.get(RES_CPU, DEFAULT_MILLI_CPU_REQUEST), \
        reqs.get(RES_MEMORY, DEFAULT_MEMORY_REQUEST)


def pod_host_ports(pod: Mapping) -> List[Tuple[str, str, int]]:
    """HostPorts used by the pod as (protocol, hostIP, hostPort) triples
    (NodePorts plugin key format, node_ports.go)."""
    out = []
    spec = pod.get("spec") or {}
    for c in (spec.get("containers") or []) + (spec.get("initContainers") or []):
        for p in c.get("ports") or []:
            hp = p.get("hostPort", 0)
            if hp:
                out.append((p.get("protocol") or "TCP",
                            p.get("hostIP") or "0.0.0.0", int(hp)))
    return out


def pod_tolerations(pod: Mapping) -> List[Mapping]:
    return (pod.get("spec") or {}).get("tolerations") or []


def pod_images(pod: Mapping) -> List[str]:
    spec = pod.get("spec") or {}
    return [c.get("image", "") for c in
            (spec.get("initContainers") or []) + (spec.get("containers") or [])]


def make_clone(template: Mapping, index: int) -> dict:
    """singlePodGenerator.Generate (podgenerator.go:27-46): clone the template,
    name it `<name>-<index>`, fresh UID, cleared nodeName, provisioner
    annotation."""
    pod = copy.deepcopy(dict(template))
    meta = pod.setdefault("metadata", {})
    base = meta.get("name", "pod")
    meta["name"] = f"{base}-{index}"
    meta["uid"] = str(uuid.uuid4())
    meta.setdefault("annotations", {})[PROVISIONED_BY_ANNOTATION] = PROVISIONER_NAME
    pod.setdefault("spec", {})["nodeName"] = ""
    return pod

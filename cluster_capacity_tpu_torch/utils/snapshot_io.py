"""Cluster snapshot file IO.

The reference snapshots a live cluster over HTTPS (SyncWithClient,
pkg/framework/simulator.go:176-295).  This package adds an
explicit on-disk snapshot format so capacity analysis is reproducible and
offline (SURVEY.md §5 "Checkpoint / resume": snapshot save/load is a new
capability).  Two formats are accepted:

1. a mapping of object lists:
   {"nodes": [...], "pods": [...], "services": [...], ...}
2. a Kubernetes v1.List: {"kind": "List", "items": [objects with kind:]}

Object-list keys mirror the ten resource kinds SyncWithClient copies.

Malformed input raises SnapshotValidationError with the exact field path
(`items[3].kind`, `pods[0]`) instead of a bare KeyError/AttributeError from
deep inside snapshot encoding.
"""

from __future__ import annotations

import json
from typing import Dict, List

import yaml

from ..runtime.errors import SnapshotValidationError

_KIND_TO_KEY = {
    "Node": "nodes",
    "Pod": "pods",
    "Service": "services",
    "PersistentVolumeClaim": "pvcs",
    "PersistentVolume": "pvs",
    "CSINode": "csinodes",
    "PodDisruptionBudget": "pdbs",
    "ReplicationController": "replication_controllers",
    "ReplicaSet": "replica_sets",
    "StatefulSet": "stateful_sets",
    "StorageClass": "storage_classes",
    "CSIStorageCapacity": "csistoragecapacities",
    "Namespace": "namespaces",
    "LimitRange": "limit_ranges",
    "PriorityClass": "priority_classes",
    "ResourceSlice": "resource_slices",
    "ResourceClaim": "resource_claims",
    "ResourceClaimTemplate": "resource_claim_templates",
    "DeviceClass": "device_classes",
}

SNAPSHOT_KEYS = list(_KIND_TO_KEY.values())


def load_snapshot_objects(path: str) -> Dict[str, List[dict]]:
    with open(path) as f:
        text = f.read()
    try:
        data = json.loads(text) if text.lstrip().startswith("{") \
            else yaml.safe_load(text)
    except (json.JSONDecodeError, yaml.YAMLError) as exc:
        raise SnapshotValidationError(
            f"snapshot file {path!r} does not parse: {exc}",
            field_path="") from exc
    if not isinstance(data, dict):
        raise SnapshotValidationError(
            f"snapshot file {path!r} parsed to "
            f"{type(data).__name__}, expected an object")
    return parse_snapshot_dict(data)


def parse_snapshot_dict(data: dict) -> Dict[str, List[dict]]:
    out: Dict[str, List[dict]] = {}
    if data.get("kind") == "List" or "items" in data and "nodes" not in data:
        items = data.get("items") or []
        if not isinstance(items, list):
            raise SnapshotValidationError(
                f"items is {type(items).__name__}, expected a list",
                field_path="items")
        for i, obj in enumerate(items):
            if not isinstance(obj, dict):
                raise SnapshotValidationError(
                    f"list item is {type(obj).__name__}, expected an "
                    f"object", field_path=f"items[{i}]")
            kind = obj.get("kind")
            if not isinstance(kind, str) or not kind:
                raise SnapshotValidationError(
                    "list item has no kind", field_path=f"items[{i}].kind")
            key = _KIND_TO_KEY.get(kind)
            if key:
                out.setdefault(key, []).append(obj)
        return out
    for key in SNAPSHOT_KEYS:
        if key in data:
            objs = data[key] or []
            if not isinstance(objs, list):
                raise SnapshotValidationError(
                    f"{key} is {type(objs).__name__}, expected a list",
                    field_path=key)
            for i, obj in enumerate(objs):
                if not isinstance(obj, dict):
                    raise SnapshotValidationError(
                        f"object is {type(obj).__name__}, expected a "
                        f"mapping", field_path=f"{key}[{i}]")
            out[key] = list(objs)
    return out


def save_snapshot_objects(path: str, objects: Dict[str, List[dict]]) -> None:
    with open(path, "w") as f:
        yaml.safe_dump({k: v for k, v in objects.items() if v}, f,
                       sort_keys=False)

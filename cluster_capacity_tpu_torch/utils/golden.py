"""Recorded-golden scenario files: schema, runner, exporter.

A golden *scenario* is a self-contained JSON file — cluster objects +
podspec + profile + expected outcome — that any implementation of the
kube-scheduler semantics can replay.  This is the mechanism that lets a
machine WITH a Go toolchain run the very same scenario through a real
kube-scheduler (the reference wires one up against a fake clientset,
pkg/framework/simulator_test.go:154-259) and commit its decisions verbatim
as `<name>.recorded.json`.  The format is the JAX package's: a scenario
recorded by either package replays in the other, and the two recordings of
one run are the same bytes.

Schema (all fields except `snapshot` + `pod` optional):

    {
      "description": "...",
      "derivation": "reference-doc | manual-arithmetic | self-recorded
                     | kube-scheduler-recorded",
      "snapshot":  {"nodes": [...], "pods": [...], ...},   # snapshot_io keys
      "pod":       {... v1.Pod ...},
      "profile":   {... SchedulerProfile field overrides ...},
      "parity":    true,          # shortcut: compute_dtype=float64
      "max_limit": 0,
      "exclude_nodes": ["name", ...],
      "node_order": "" | "sorted" | "zone-round-robin",
      "expected": {
        "placed_count":          int,
        "placements":            ["node-name", ...],   # exact greedy order
        "per_node_counts":       {"node-name": int},
        "fail_type":             "Unschedulable" | "LimitReached",
        "fail_message":          "...",                # exact string
        "fail_message_contains": "...",
        "one_node":  true,       # colocation property: all on ONE node
        "one_zone":  true        # ... in ONE topology.kubernetes.io/zone
      }
    }

Only the expectation keys PRESENT are compared, so loose reference-doc
fixtures (count + substring) and exact recorded fixtures (full placement
sequence + verbatim FitError) share one runner.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

from .config import SchedulerProfile, ScoringStrategy


def profile_from_dict(data: Optional[dict], parity: bool = False
                      ) -> SchedulerProfile:
    data = dict(data or {})
    if "fit_strategy" in data and isinstance(data["fit_strategy"], dict):
        fs = dict(data["fit_strategy"])
        if "resources" in fs:
            fs["resources"] = [tuple(r) for r in fs["resources"]]
        data["fit_strategy"] = ScoringStrategy(**fs)
    if "balanced_resources" in data:
        data["balanced_resources"] = [tuple(r)
                                      for r in data["balanced_resources"]]
    unknown = set(data) - {f.name for f in
                           dataclasses.fields(SchedulerProfile)}
    if unknown:
        raise ValueError(f"unknown profile fields in scenario: {sorted(unknown)}")
    profile = SchedulerProfile(**data)
    if parity:
        profile.compute_dtype = "float64"
    return profile


def profile_to_dict(profile: SchedulerProfile) -> dict:
    """Serializable profile (extenders are callables/objects — scenarios
    with extenders cannot be recorded; recorders must reject them)."""
    if profile.extenders:
        raise ValueError("profiles with extenders cannot be recorded "
                         "as golden scenarios")
    out = dataclasses.asdict(profile)
    out.pop("extenders")
    return out


def run_scenario(data: dict, device=None):
    """Execute one scenario through the framework on `device` (default the
    card; "cpu" runs the plain PyTorch versions); returns the
    SolveResult."""
    from ..framework import ClusterCapacity
    from ..models.podspec import default_pod
    from .snapshot_io import parse_snapshot_dict

    profile = profile_from_dict(data.get("profile"),
                                parity=bool(data.get("parity")))
    pod = default_pod(data["pod"])
    cc = ClusterCapacity(pod, max_limit=int(data.get("max_limit") or 0),
                         profile=profile,
                         exclude_nodes=list(data.get("exclude_nodes") or []),
                         device=device)
    objs = parse_snapshot_dict(data.get("snapshot") or {})
    if data.get("node_order"):
        objs["node_order"] = data["node_order"]
    cc.sync_with_objects(objs.pop("nodes", []), objs.pop("pods", []), **objs)
    return cc.run()


def compare_result(scenario: dict, res) -> List[str]:
    """Compare a SolveResult against the scenario's `expected` block; returns
    mismatch descriptions (empty == pass).  Only the keys present are
    checked."""
    expected = scenario["expected"]
    problems: List[str] = []

    def check(key, actual):
        if key in expected and expected[key] != actual:
            problems.append(f"{key}: expected {expected[key]!r}, "
                            f"got {actual!r}")

    check("placed_count", res.placed_count)
    check("fail_type", res.fail_type)
    check("fail_message", res.fail_message)
    if "fail_message_contains" in expected \
            and expected["fail_message_contains"] not in res.fail_message:
        problems.append(f"fail_message_contains: {res.fail_message!r} "
                        f"lacks {expected['fail_message_contains']!r}")
    if "placements" in expected:
        got = [res.node_names[i] for i in res.placements]
        if got != list(expected["placements"]):
            problems.append(f"placements: expected {expected['placements']}, "
                            f"got {got}")
    if "per_node_counts" in expected:
        check("per_node_counts", dict(res.per_node_counts))
    if expected.get("one_node") and len(res.per_node_counts) != 1:
        problems.append(f"one_node: spread over {sorted(res.per_node_counts)}")
    if expected.get("one_zone"):
        node_zone = {
            n.get("metadata", {}).get("name", ""):
                n.get("metadata", {}).get("labels", {}).get(
                    "topology.kubernetes.io/zone", "")
            for n in (scenario.get("snapshot") or {}).get("nodes", [])}
        zones = {node_zone.get(name, "") for name in res.per_node_counts}
        if len(zones) > 1:
            problems.append(f"one_zone: spread over zones {sorted(zones)}")
    return problems


def load_scenario(path: str) -> dict:
    with open(path) as f:
        data = json.load(f)
    if "snapshot" not in data or "pod" not in data:
        raise ValueError(f"{path}: scenario needs 'snapshot' and 'pod'")
    if data.get("expected") is None:
        raise ValueError(f"{path}: scenario has no 'expected' block "
                         "(record one first)")
    return data


def record_scenario(path: str, pod: dict, snapshot_objects: Dict[str, list],
                    profile: SchedulerProfile, max_limit: int, res,
                    description: str = "",
                    exclude_nodes: Optional[List[str]] = None,
                    node_order: str = "") -> None:
    """Write a replayable scenario whose `expected` block is THIS engine's
    observed outcome (derivation self-recorded).  A kube-scheduler machine
    replays the same file and overwrites `expected`/derivation verbatim in a
    `.recorded.json` sibling."""
    data = {
        "description": description or "recorded by cluster-capacity "
                                      "--record-golden",
        "derivation": "self-recorded",
        "snapshot": {k: v for k, v in snapshot_objects.items() if v},
        "pod": pod,
        "profile": profile_to_dict(profile),
        "max_limit": int(max_limit),
        **({"exclude_nodes": list(exclude_nodes)} if exclude_nodes else {}),
        **({"node_order": node_order} if node_order else {}),
        "expected": {
            "placed_count": res.placed_count,
            "placements": [res.node_names[i] for i in res.placements],
            "per_node_counts": dict(res.per_node_counts),
            "fail_type": res.fail_type,
            "fail_message": res.fail_message,
        },
    }
    with open(path, "w") as f:
        json.dump(data, f, indent=2, sort_keys=False)
        f.write("\n")

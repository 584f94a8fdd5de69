"""The benchmark's own generators: Kubernetes node, pod and template objects
made from a configuration file, a traffic file and a seed.

Frozen with the benchmark so that a change to the program cannot move the
yardstick.  The pattern follows the port's bench cells (seeded allocatable
per node pool, zone labels, own-label zone spreads), re-sized to the
configurations under portbench/configs.  Every seed gives the same sizes
(node counts per pool and per zone, residents per node, the multiset of
template shapes); the seed draws only which node gets which pool and zone,
the order of the object lists and the order of the templates.
"""

from __future__ import annotations

import copy
from fractions import Fraction
from typing import Dict, List, Sequence, Tuple

import numpy as np

HOSTNAME_KEY = "kubernetes.io/hostname"

_BINARY = {"Ki": 2 ** 10, "Mi": 2 ** 20, "Gi": 2 ** 30, "Ti": 2 ** 40,
           "Pi": 2 ** 50, "Ei": 2 ** 60}
_DECIMAL = {"n": Fraction(1, 10 ** 9), "u": Fraction(1, 10 ** 6),
            "m": Fraction(1, 1000), "k": 10 ** 3, "M": 10 ** 6, "G": 10 ** 9,
            "T": 10 ** 12, "P": 10 ** 15, "E": 10 ** 18}


def quantity(text) -> Fraction:
    """A Kubernetes quantity ("4", "100m", "500Mi", "32Gi", "1e3") as an
    exact fraction of its base unit."""
    s = str(text).strip()
    for suffix in sorted(_BINARY, key=len, reverse=True):
        if s.endswith(suffix):
            return Fraction(s[:-len(suffix)]) * _BINARY[suffix]
    if s and s[-1] in _DECIMAL:
        return Fraction(s[:-1]) * _DECIMAL[s[-1]]
    if "e" in s.lower():
        mant, exp = s.lower().split("e")
        return Fraction(mant) * Fraction(10) ** int(exp)
    return Fraction(s)


def ceil_int(q: Fraction) -> int:
    return -((-q.numerator) // q.denominator)


def milli(text) -> int:
    """Quantity.MilliValue(): milli-units, rounded up."""
    return ceil_int(quantity(text) * 1000)


def units(text) -> int:
    """Quantity.Value(): base units, rounded up."""
    return ceil_int(quantity(text))


def split_even(total: int, parts: int) -> List[int]:
    """total over `parts` shares that differ by at most one, the larger
    first: 5,000 over 3 is 1,667, 1,667, 1,666."""
    base, extra = divmod(total, parts)
    return [base + (1 if i < extra else 0) for i in range(parts)]


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (2 ** 63), stream])


def _drawn_assignment(rng: np.random.Generator, counts: Sequence[int]
                      ) -> np.ndarray:
    """One label index per node: exactly counts[i] nodes get index i, which
    ones drawn from rng."""
    labels = np.repeat(np.arange(len(counts)), counts)
    rng.shuffle(labels)
    return labels


def make_cluster(config: dict, seed: int) -> Tuple[List[dict], List[dict]]:
    """(nodes, resident pods) of one configuration, as the API server lists
    them.  A pool's `allocatable` entry, where it has one, gives its nodes'
    allocatable; otherwise that equals the capacity.  A pool's `node_spec`
    is merged into each of its nodes' spec.  Node names are fixed; the seed
    draws each node's pool and zone and the order of both lists.  A
    configuration with no `zones` gives its nodes no zone label."""
    n = int(config["nodes"])
    pools = config["pools"]
    zones = config.get("zones") or []
    pool_of = _drawn_assignment(_rng(seed, 1),
                                split_even(n, len(pools)))
    if zones:
        zone_key = config["zone_key"]
        zone_of = _drawn_assignment(_rng(seed, 2),
                                    split_even(n, len(zones)))
    prefix = config["node_name_prefix"]
    nodes = []
    for i in range(n):
        name = f"{prefix}{i:05d}"
        pool = pools[pool_of[i]]
        resources = {"cpu": str(pool["cpu"]), "memory": str(pool["memory"]),
                     "pods": str(pool["pods"])}
        allocatable = dict(resources, **(pool.get("allocatable") or {}))
        labels = {HOSTNAME_KEY: name}
        if zones:
            labels[zone_key] = zones[zone_of[i]]
        labels.update(pool.get("labels") or {})
        nodes.append({
            "apiVersion": "v1", "kind": "Node",
            "metadata": {"name": name, "labels": labels},
            "spec": copy.deepcopy(pool.get("node_spec") or {}),
            "status": {"capacity": dict(resources),
                       "allocatable": allocatable,
                       "phase": "Running",
                       "conditions": [{"type": "Ready", "status": "True"}]}})
    res = config["resident"]
    pods = []
    per_node = int(res["per_node"])
    for i in range(n):
        for j in range(per_node):
            k = i * per_node + j
            pods.append(make_pod(
                {"name": f"{res['name_prefix']}{k:05d}",
                 "namespace": res.get("namespace", "default"),
                 "labels": res.get("labels") or {},
                 "cpu": res["cpu"], "memory": res["memory"],
                 "image": res.get("image", ""), "spec": res.get("spec")},
                node_name=nodes[i]["metadata"]["name"]))
    order = _rng(seed, 3)
    nodes = [nodes[i] for i in order.permutation(n)]
    pods = [pods[i] for i in order.permutation(len(pods))]
    return nodes, pods


def make_pod(spec: dict, node_name: str = "") -> dict:
    """A one-container pod object from a flat description: name, namespace,
    labels, cpu, memory (either may be absent), image, hard zone spreads as
    {"maxSkew", "topologyKey", "selector"}, and a `spec` object merged last
    into the pod's spec (priority, tolerations, affinity, ...)."""
    requests = {}
    if spec.get("cpu"):
        requests["cpu"] = str(spec["cpu"])
    if spec.get("memory"):
        requests["memory"] = str(spec["memory"])
    container = {"name": spec.get("container", "pause"),
                 "image": spec.get("image") or "registry.k8s.io/pause:3.10",
                 "ports": [{"containerPort": 80}],
                 "resources": {"requests": dict(requests),
                               "limits": dict(requests)}}
    pod = {"apiVersion": "v1", "kind": "Pod",
           "metadata": {"name": spec["name"],
                        "namespace": spec.get("namespace", "default"),
                        "labels": dict(spec.get("labels") or {})},
           "spec": {"containers": [container]}}
    spreads = spec.get("spread") or []
    if spreads:
        pod["spec"]["topologySpreadConstraints"] = [{
            "maxSkew": int(c["maxSkew"]), "topologyKey": c["topologyKey"],
            "whenUnsatisfiable": "DoNotSchedule",
            "labelSelector": {"matchLabels": dict(c["selector"])}}
            for c in spreads]
    if node_name:
        pod["spec"]["nodeName"] = node_name
        pod["status"] = {"phase": "Running"}
    pod["spec"].update(copy.deepcopy(spec.get("spec") or {}))
    return pod


def make_templates(traffic: dict, config: dict, seed: int) -> List[dict]:
    """The pod templates a traffic mix asks about.  A mix names one `pod`
    (a question about one template) or a `templates` family: `count`
    templates cycling through every combination of the listed cpu, memory
    and maxSkew values, each with a zone spread on its own label, the
    order and the names' assignment drawn from the seed."""
    if "pod" in traffic:
        return [make_pod(traffic["pod"])]
    fam = traffic["templates"]
    cpus = list(fam["cpu"])
    mems = list(fam.get("memory") or [None])
    skews = list(fam["max_skew"])
    shapes = [(c, m, s) for c in cpus for m in mems for s in skews]
    count = int(fam["count"])
    cycle = [shapes[i % len(shapes)] for i in range(count)]
    order = _rng(seed, 4).permutation(count)
    out = []
    for k, idx in enumerate(order):
        cpu, mem, skew = cycle[idx]
        name = f"{fam['name_prefix']}{k:03d}"
        label = {fam.get("label_key", "app"): name}
        out.append(make_pod({
            "name": name, "labels": label, "cpu": cpu, "memory": mem,
            "spread": [{"maxSkew": skew, "topologyKey": config["zone_key"],
                        "selector": label}]}))
    return out


def make_objects(config: dict, traffic: dict, seed: int) -> dict:
    """Everything a cell's run asks about: the cluster's nodes and
    resident pods, and the templates of its questions."""
    nodes, pods = make_cluster(config, seed)
    return {"nodes": nodes, "pods": pods,
            "templates": make_templates(traffic, config, seed)}


def shape_classes(templates: Sequence[dict]) -> Dict[tuple, int]:
    """Templates by (cpu, memory, maxSkew): the classes whose solves are
    alike (own-label spreads only count their own clones)."""
    out: Dict[tuple, int] = {}
    for t in templates:
        c = t["spec"]["containers"][0]["resources"]["requests"]
        skews = tuple(s["maxSkew"] for s in
                      t["spec"].get("topologySpreadConstraints") or [])
        key = (c.get("cpu"), c.get("memory"), skews)
        out[key] = out.get(key, 0) + 1
    return out

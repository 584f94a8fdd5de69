"""Scheduler extenders: the HTTP webhook escape hatch.

Reference semantics (vendor/k8s.io/kubernetes/pkg/scheduler/extender.go):
extenders are called sequentially after the in-tree filters with the feasible
node set (schedule_one.go:725-773) and during prioritization
(schedule_one.go:819-877); extender priorities are weighted and ADDED to the
plugin score sum (no normalization).

A webhook call per cycle breaks batching, so extender mode runs a
host-driven loop, as the JAX package does: each cycle the device computes
every filter mask and the summed plugin scores in one pass (plain PyTorch on
the card; the fused kernels never run here), the host copies the [N]
feasible mask and totals, calls the extenders with the feasible node list,
applies their verdicts, picks the argmax, and commits the placement through
the step's commit.  Extenders are configured from the
KubeSchedulerConfiguration `extenders:` section or injected as Python
callables (tests / embedding).
"""

from __future__ import annotations

import json
import urllib.request
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import encode as enc
from . import simulator as sim


@dataclass
class ExtenderConfig:
    """One extender (KubeSchedulerConfiguration .extenders[] subset)."""

    url_prefix: str = ""
    filter_verb: str = ""
    prioritize_verb: str = ""
    bind_verb: str = ""
    preempt_verb: str = ""
    weight: int = 1
    node_cache_capable: bool = False
    ignorable: bool = False
    http_timeout_s: float = 30.0
    # managedResources (extender.go:375-380 IsInterested): when non-empty the
    # extender is consulted only for pods requesting one of these resources.
    managed_resources: List[str] = field(default_factory=list)
    # test/embedding hooks: take (pod, node_names) → same payloads as HTTP
    filter_callable: Optional[Callable] = None
    prioritize_callable: Optional[Callable] = None
    bind_callable: Optional[Callable] = None
    preempt_callable: Optional[Callable] = None

    @property
    def is_binder(self) -> bool:
        return bool(self.bind_verb or self.bind_callable)

    @property
    def supports_preemption(self) -> bool:
        return bool(self.preempt_verb or self.preempt_callable)

    def is_interested(self, pod: dict) -> bool:
        """IsInterested (extender.go:364-380): empty managedResources means
        every pod; otherwise any container requesting or limiting one of the
        managed resource names (init containers included)."""
        if not self.managed_resources:
            return True
        managed = set(self.managed_resources)
        spec = pod.get("spec") or {}
        containers = list(spec.get("containers") or []) + \
            list(spec.get("initContainers") or [])
        for c in containers:
            res = c.get("resources") or {}
            for kind in ("requests", "limits"):
                if managed & set((res.get(kind) or {}).keys()):
                    return True
        return False

    def filter(self, pod: dict, node_names: List[str],
               node_objects: Optional[Dict[str, dict]] = None) -> Dict:
        if self.filter_callable is not None:
            return self.filter_callable(pod, node_names) or {}
        if not self.filter_verb:
            return {}
        return self._post(self.filter_verb, pod, node_names, node_objects)

    def prioritize(self, pod: dict, node_names: List[str]) -> List[Dict]:
        if self.prioritize_callable is not None:
            return self.prioritize_callable(pod, node_names) or []
        if not self.prioritize_verb:
            return []
        out = self._post(self.prioritize_verb, pod, node_names)
        return out if isinstance(out, list) else []

    def bind(self, pod: dict, node_name: str) -> Dict:
        """Bind verb (extender.go:318-341): ExtenderBindingArgs →
        ExtenderBindingResult; a non-empty Error fails the binding."""
        meta = pod.get("metadata") or {}
        if self.bind_callable is not None:
            return self.bind_callable(pod, node_name) or {}
        args = {"PodName": meta.get("name", ""),
                "PodNamespace": meta.get("namespace", "default"),
                "PodUID": meta.get("uid", ""),
                "Node": node_name}
        req = urllib.request.Request(
            self.url_prefix.rstrip("/") + "/" + self.bind_verb,
            data=json.dumps(args).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.http_timeout_s) as r:
            return json.loads(r.read().decode()) or {}

    def process_preemption(self, pod: dict,
                           node_to_victims: Dict[str, List[dict]]
                           ) -> Optional[Dict[str, List[dict]]]:
        """ProcessPreemption (extender.go:343-373): the extender returns the
        subset of candidate nodes (with possibly-updated victim lists) it
        accepts; None on a skipped/verbless extender."""
        if self.preempt_callable is not None:
            return self.preempt_callable(pod, node_to_victims)
        if not self.preempt_verb:
            return None
        args = {"Pod": pod,
                "NodeNameToVictims": {
                    n: {"Pods": v, "NumPDBViolations": 0}
                    for n, v in node_to_victims.items()}}
        req = urllib.request.Request(
            self.url_prefix.rstrip("/") + "/" + self.preempt_verb,
            data=json.dumps(args).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.http_timeout_s) as r:
            result = json.loads(r.read().decode()) or {}
        kept = result.get("NodeNameToVictims") \
            or result.get("NodeNameToMetaVictims")
        if kept is None:
            return None
        out: Dict[str, List[dict]] = {}
        for n, victims in kept.items():
            if n not in node_to_victims:
                continue
            pods = (victims or {}).get("Pods")
            if pods and all(isinstance(p, dict) and p.get("metadata")
                            for p in pods):
                out[n] = list(pods)
            else:
                # MetaVictims (uid-only) or absent: keep the local victims
                out[n] = node_to_victims[n]
        return out

    def _post(self, verb: str, pod: dict, node_names: List[str],
              node_objects: Optional[Dict[str, dict]] = None):
        # protocol (vendor/k8s.io/kube-scheduler/extender/v1/types.go):
        # cache-capable extenders exchange NodeNames; others full Node lists.
        if self.node_cache_capable or node_objects is None:
            args = {"Pod": pod, "NodeNames": node_names}
        else:
            args = {"Pod": pod,
                    "Nodes": {"items": [node_objects[n] for n in node_names
                                        if n in node_objects]}}
        req = urllib.request.Request(
            self.url_prefix.rstrip("/") + "/" + verb,
            data=json.dumps(args).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.http_timeout_s) as r:
            return json.loads(r.read().decode())


def parse_extenders(cfg: dict) -> List[ExtenderConfig]:
    """Parse the `extenders:` section of a KubeSchedulerConfiguration."""
    out = []
    for e in cfg.get("extenders") or []:
        out.append(ExtenderConfig(
            url_prefix=e.get("urlPrefix", ""),
            filter_verb=e.get("filterVerb", ""),
            prioritize_verb=e.get("prioritizeVerb", ""),
            bind_verb=e.get("bindVerb", ""),
            preempt_verb=e.get("preemptVerb", ""),
            weight=int(e.get("weight", 1)),
            node_cache_capable=bool(e.get("nodeCacheCapable")),
            ignorable=bool(e.get("ignorable")),
            http_timeout_s=_parse_duration(e.get("httpTimeout")),
            managed_resources=[str(m.get("name", m) if isinstance(m, dict)
                                   else m)
                               for m in e.get("managedResources") or []],
        ))
    return out


def run_preemption_chain(extenders, pod: dict,
                         node_to_victims: Dict[str, List[dict]]
                         ) -> Dict[str, List[dict]]:
    """Consult every preemption-supporting, interested extender in turn,
    intersecting the candidate map (Evaluator.callExtenders,
    preemption.go:341-402)."""
    current = dict(node_to_victims)
    for ext in extenders or []:
        if not ext.supports_preemption or not ext.is_interested(pod):
            continue
        try:
            result = ext.process_preemption(pod, current)
            if result is not None:
                # intersection semantics regardless of transport: an
                # extender can only REMOVE candidates or update their
                # victim lists, never resurrect or invent nodes
                current = {n: (v if isinstance(v, list) else current[n])
                           for n, v in result.items() if n in current}
            if not current:
                break
        except Exception:
            if not ext.ignorable:
                raise
    return current


def run_bind(extenders, pod: dict, node_name: str) -> None:
    """Delegate binding to the first interested binder extender
    (schedule_one.go extendersBinding): a returned Error fails the bind."""
    for ext in extenders or []:
        if not ext.is_binder or not ext.is_interested(pod):
            continue
        result = ext.bind(pod, node_name)
        if result.get("Error"):
            raise RuntimeError(
                f"extender bind failed for node {node_name}: "
                f"{result['Error']}")
        return


def _parse_duration(v) -> float:
    """metav1.Duration subset: ms / s / m / h."""
    if v is None:
        return 30.0
    if isinstance(v, (int, float)):
        return float(v)
    s = str(v)
    try:
        if s.endswith("ms"):
            return float(s[:-2]) / 1000.0
        if s.endswith("h"):
            return float(s[:-1]) * 3600.0
        if s.endswith("m"):
            return float(s[:-1]) * 60.0
        if s.endswith("s"):
            return float(s[:-1])
        return float(s)
    except ValueError:
        return 30.0


def _kept_names(verdict: Dict) -> Optional[List[str]]:
    """Accept both response shapes: NodeNames (cache-capable) or Nodes.items
    (full objects)."""
    kept = verdict.get("NodeNames")
    if kept is not None:
        return list(kept)
    nodes = verdict.get("Nodes")
    if nodes is not None:
        return [((n.get("metadata") or {}).get("name", ""))
                for n in (nodes.get("items") or [])]
    return None


def make_node_ok(extenders, pod: dict, node_names: List[str], nodes):
    """Preemption-candidate veto from the extender filter chain: returns a
    `node_ok(name) -> bool` callback, or None without extenders.  Shared by
    framework._solve_with_preemption and oracle.simulate_with_preemption so
    the differential pair cannot drift (preemption.go consults supporting
    extenders during victim selection)."""
    if not extenders:
        return None
    passing = frozenset(run_filter_chain(
        extenders, pod, list(node_names),
        {n: o for n, o in zip(node_names, nodes)}))

    def node_ok(name, _passing=passing):
        return name in _passing
    return node_ok


# FitError bucket for nodes the in-tree filters accepted but an extender's
# Filter verb rejected (extender.go FailedNodes carry per-extender messages;
# this single bucket is the reduced model shared by the solve/interleave
# paths).
REASON_EXTENDER_FILTER = "node(s) didn't pass the extender filter"


def run_prioritize_chain(extenders, pod: dict,
                         node_names: List[str]) -> Dict[str, float]:
    """Weighted extender Prioritize sum per node name (prioritizeNodes,
    schedule_one.go:819-877).  Single source for solve_with_extenders and
    the interleaved queue sweep so the two paths cannot drift."""
    bonus = {n: 0.0 for n in node_names}
    for ext in extenders:
        if not (ext.prioritize_verb or ext.prioritize_callable):
            continue
        if not ext.is_interested(pod):
            continue
        try:
            for hp in ext.prioritize(pod, list(node_names)):
                nm = hp.get("Host")
                if nm in bonus:
                    bonus[nm] += ext.weight * float(hp.get("Score", 0))
        except Exception:
            if not ext.ignorable:
                raise
    return bonus


def run_filter_chain(extenders, pod: dict, node_names: List[str],
                     node_objects: Optional[Dict[str, dict]] = None
                     ) -> List[str]:
    """Apply every extender's Filter sequentially; returns surviving names."""
    names = list(node_names)
    for ext in extenders:
        if not (ext.filter_verb or ext.filter_callable):
            continue
        if not ext.is_interested(pod):
            continue
        try:
            verdict = ext.filter(pod, names, node_objects)
            if verdict.get("Error"):
                raise RuntimeError(verdict["Error"])
            kept = _kept_names(verdict)
            if kept is not None:
                keep = set(kept)
                names = [n for n in names if n in keep]
        except Exception:
            if not ext.ignorable:
                raise
    return names


def _compute(cfg, consts, carry):
    """One cycle's device pass: the in-tree feasible mask and the summed
    plugin scores over the WHOLE feasible set (simulator._feasibility and
    the sum of simulator._score_terms in their order: no sampling window and
    no random jitter, as in the JAX package's extender loop)."""
    feasible, _ = sim._feasibility(cfg, consts, carry)
    total = torch.zeros(feasible.shape[0], dtype=sim._dt(cfg),
                        device=feasible.device)
    for _name, term in sim._score_terms(cfg, consts, carry, feasible):
        total = total + term
    return feasible, total


def solve_with_extenders(pb: enc.EncodedProblem,
                         extenders: Sequence[ExtenderConfig],
                         max_limit: int = 0, device=None) -> sim.SolveResult:
    """Host-driven greedy loop with extender calls each cycle, on `device`
    (default the card; "cpu" runs the same torch ops on the CPU)."""
    if pb.snapshot.num_nodes == 0 or pb.pod_level_reason:
        return sim.solve(pb, max_limit=max_limit, device=device)

    dev = sim.resolve_device(device)
    cfg = sim.static_config(pb)
    consts = sim.build_consts(pb, dev)
    carry = sim._init_carry(pb, consts)
    names = pb.snapshot.node_names
    name_to_idx = {n: i for i, n in enumerate(names)}
    node_objs = {n: o for n, o in zip(names, pb.snapshot.nodes)}

    budget = pb.max_steps_hint + 1
    if max_limit and max_limit > 0:
        budget = min(max_limit, budget)
    budget = max(1, min(budget, sim._DEFAULT_UNLIMITED_CAP))

    place = torch.ones((), dtype=torch.bool, device=dev)
    placements: List[int] = []
    ext_blocked = 0        # in-tree-feasible nodes the extenders rejected
    while len(placements) < budget:
        feasible, total = _compute(cfg, consts, carry)
        feasible = feasible.cpu().numpy().copy()
        # float64 before the extender bonus is added, as in the JAX loop
        total = total.cpu().numpy().astype(np.float64)
        if not feasible.any():
            break

        feasible_names = [names[i] for i in np.flatnonzero(feasible)]
        surviving = run_filter_chain(extenders, pb.pod, feasible_names,
                                     node_objs)
        if len(surviving) != len(feasible_names):
            keep = set(surviving)
            for nm in feasible_names:
                if nm not in keep:
                    feasible[name_to_idx[nm]] = False
        for nm, b in run_prioritize_chain(extenders, pb.pod,
                                          surviving).items():
            total[name_to_idx[nm]] += b
        if not feasible.any():
            ext_blocked = len(feasible_names)
            break

        # -inf sentinel: extender scores may push totals negative
        keyed = np.where(feasible, total, -np.inf)
        chosen = int(np.argmax(keyed))     # first max → lowest index ties
        # Bind verb: an interested binder extender replaces the default
        # binder for this pod (extender.go:318-341); a bind error fails the
        # simulation loudly rather than retrying forever.
        run_bind(extenders, pb.pod, names[chosen])
        # the rotating start index and the PRNG key stay as they are
        carry = sim._apply_placement(
            cfg, consts, carry,
            torch.full((), chosen, dtype=torch.int64, device=dev), place,
            next_start=carry.next_start, rng=carry.rng)
        placements.append(chosen)

    placed = len(placements)
    if max_limit and placed >= max_limit:
        return sim.SolveResult(
            placements=placements, placed_count=placed,
            fail_type=sim.FAIL_LIMIT_REACHED,
            fail_message=f"Maximum number of pods simulated: {max_limit}",
            node_names=names)
    counts = sim.diagnose(pb, cfg, consts, carry)
    if ext_blocked:
        # the solve ended with in-tree-feasible nodes left: only the
        # extender Filter chain rejected them (same bucket as the
        # interleaved path's accounting)
        counts = dict(counts)
        counts[REASON_EXTENDER_FILTER] = ext_blocked
    msg = sim.format_fit_error(pb.snapshot.num_nodes, counts)
    return sim.SolveResult(
        placements=placements, placed_count=placed,
        fail_type=sim.FAIL_UNSCHEDULABLE, fail_message=msg,
        fail_counts=counts, node_names=names)

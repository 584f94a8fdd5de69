"""ClusterCapacityReview report model + printers.

Schema and formatting mirror pkg/framework/report.go:38-317
(including the preserved `nvdia.com/gpu` typo at report.go:35 and the
pretty-print wording), plus doc/api-definitions.md.  The reference leaves
FailSummary nil; this framework fills it with the per-reason node counts from
the final infeasible cycle — strictly more information, same schema.
"""

from __future__ import annotations

import copy
import json
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Dict, List, Mapping, Optional

import yaml

from ..models.podspec import RES_CPU, RES_MEMORY, is_scalar_resource_name
from ..utils.quantity import format_bytes, format_milli, int_value, milli_value

RESOURCE_NVIDIA_GPU = "nvdia.com/gpu"  # sic — report.go:35


@dataclass
class ReplicasOnNode:
    node_name: str
    replicas: int


@dataclass
class PodResult:
    pod_name: str
    replicas_on_nodes: List[ReplicasOnNode] = field(default_factory=list)
    # legacy reason list ({"reason", "count"} entries) kept for schema
    # compatibility; `reasons` is the per-run block with counts over ALL
    # nodes (from the explain attribution when the solve ran with
    # explain=True, else from the final diagnose cycle)
    fail_summary: Optional[List[Dict]] = None
    reasons: Optional[Dict[str, int]] = None
    # Explanation.to_dict() artifact (explain/artifacts.py) when the solve
    # behind this pod carried attribution; None otherwise
    explain: Optional[dict] = None


@dataclass
class ClusterCapacityReview:
    templates: List[dict]
    pod_requirements: List[Dict]
    replicas: int
    fail_type: str
    fail_message: str
    pods: List[PodResult]
    creation_timestamp: str
    # provenance stamp of the JAX package's degradation ladder: `degraded`
    # is True when a solve fell off its healthy rung, `rung` names the
    # lowest rung that served any template (runtime/degrade.worst_rung)
    degraded: bool = False
    rung: str = ""

    # flight-recorder bundles dumped during the run (obs/flight.py); the
    # key only appears in the envelope when the recorder was armed AND
    # something faulted, so existing golden reports are unaffected
    flight_bundles: List[str] = field(default_factory=list)

    def to_dict(self) -> dict:
        """Stable machine-readable schema: a {"spec", "status"} envelope
        that round-trips through from_dict."""
        status = {
            "creationTimestamp": self.creation_timestamp,
            "replicas": self.replicas,
            "degraded": self.degraded,
            "rung": self.rung,
            "failReason": {
                "failType": self.fail_type,
                "failMessage": self.fail_message,
            },
            "pods": [
                {
                    "podName": p.pod_name,
                    "replicasOnNodes": [
                        {"nodeName": r.node_name, "replicas": r.replicas}
                        for r in p.replicas_on_nodes
                    ],
                    "failSummary": p.fail_summary,
                    "reasons": ({k: int(v) for k, v in
                                 sorted(p.reasons.items())}
                                if p.reasons else None),
                    "explain": p.explain,
                }
                for p in self.pods
            ],
        }
        if self.flight_bundles:
            status["flightBundles"] = list(self.flight_bundles)
        return {
            "spec": {
                "templates": self.templates,
                "replicas": 0,
                "podRequirements": self.pod_requirements,
            },
            "status": status,
        }

    @classmethod
    def from_dict(cls, data: dict) -> "ClusterCapacityReview":
        spec, status = data["spec"], data["status"]
        fail = status.get("failReason") or {}
        return cls(
            templates=list(spec.get("templates") or []),
            pod_requirements=list(spec.get("podRequirements") or []),
            replicas=status.get("replicas", 0),
            fail_type=fail.get("failType", ""),
            fail_message=fail.get("failMessage", ""),
            pods=[
                PodResult(
                    pod_name=p.get("podName", ""),
                    replicas_on_nodes=[
                        ReplicasOnNode(r["nodeName"], r["replicas"])
                        for r in p.get("replicasOnNodes") or []],
                    fail_summary=p.get("failSummary"),
                    reasons=({k: int(v) for k, v in p["reasons"].items()}
                             if p.get("reasons") else None),
                    explain=p.get("explain"))
                for p in status.get("pods") or []],
            creation_timestamp=status.get("creationTimestamp", ""),
            degraded=status.get("degraded", False),
            rung=status.get("rung", ""),
            flight_bundles=list(status.get("flightBundles") or []),
        )


def _resource_request(pod: Mapping) -> Dict:
    """getResourceRequest (report.go:110-143): containers' requests only;
    cpu/memory/gpu always present, scalars collected separately."""
    cpu_milli = 0
    mem = 0
    scalars: Dict[str, int] = {}
    for c in ((pod.get("spec") or {}).get("containers")) or []:
        for name, q in ((c.get("resources") or {}).get("requests") or {}).items():
            if name == RES_CPU:
                cpu_milli += milli_value(q)
            elif name == RES_MEMORY:
                mem += int_value(q)
            elif is_scalar_resource_name(name):
                scalars[name] = scalars.get(name, 0) + int_value(q)
    out = {
        "primaryResources": {
            "cpu": format_milli(cpu_milli),
            "memory": format_bytes(mem),
            RESOURCE_NVIDIA_GPU: "0",
        },
        "scalarResources": scalars or None,
    }
    return out


def build_review(templates: List[dict], results) -> ClusterCapacityReview:
    """Build the review from SolveResults (engine/simulator.py) — one result
    per template, aligned by index.  A single result is accepted for the
    single-template case."""
    if not isinstance(results, (list, tuple)):
        results = [results]
    if len(results) != len(templates):
        raise ValueError(f"{len(templates)} templates but {len(results)} results")

    reqs = [{
        "podName": (t.get("metadata") or {}).get("name", ""),
        "resources": _resource_request(t),
        "nodeSelectors": (t.get("spec") or {}).get("nodeSelector"),
    } for t in templates]

    pods: List[PodResult] = []
    for t, result in zip(templates, results):
        pr = PodResult(pod_name=(t.get("metadata") or {}).get("name", ""))
        # first-seen node order, as parsePodsReview (report.go:146-180)
        order: List[str] = []
        counts: Dict[str, int] = {}
        for node_idx in result.placements:
            name = result.node_names[node_idx]
            if name not in counts:
                order.append(name)
                counts[name] = 0
            counts[name] += 1
        pr.replicas_on_nodes = [ReplicasOnNode(n, counts[n]) for n in order]
        if result.fail_counts:
            pr.fail_summary = [{"reason": k, "count": v}
                               for k, v in sorted(result.fail_counts.items())]
        expl = getattr(result, "explain", None)
        if expl is not None:
            pr.explain = expl.to_dict()
            if expl.reason_histogram:
                pr.reasons = dict(expl.reason_histogram)
        if pr.reasons is None and result.fail_counts:
            pr.reasons = dict(result.fail_counts)
        pods.append(pr)

    first = results[0]
    from ..runtime.degrade import worst_rung
    return ClusterCapacityReview(
        templates=[copy.deepcopy(t) for t in templates],
        pod_requirements=reqs,
        replicas=sum(r.placed_count for r in results),
        fail_type=first.fail_type,
        fail_message=first.fail_message,
        pods=pods,
        creation_timestamp=datetime.now(timezone.utc).isoformat(),
        degraded=any(getattr(r, "degraded", False) for r in results),
        rung=worst_rung(results),
    )


def print_review(review: ClusterCapacityReview, verbose: bool = False,
                 fmt: str = "", out=None) -> None:
    """ClusterCapacityReviewPrint (report.go:305-317)."""
    import sys
    out = out or sys.stdout
    if fmt == "json":
        out.write(json.dumps(review.to_dict()) + "\n")
        return
    if fmt == "yaml":
        out.write(yaml.safe_dump(review.to_dict(), sort_keys=False,
                                 default_flow_style=False))
        return
    if fmt not in ("", "pretty"):
        raise ValueError(f"output format {fmt!r} not recognized")
    _pretty_print(review, verbose, out)


def survivability_from_dict(data: dict):
    """Parse a resilience survivability report back from its JSON form
    (the same {"spec", "status"} envelope as the capacity review)."""
    from ..resilience.analyzer import SurvivabilityReport
    return SurvivabilityReport.from_dict(data)


def print_survivability(report, verbose: bool = False, fmt: str = "",
                        out=None) -> None:
    """Survivability report printer: table by default, json/yaml for the
    machine-readable schema (resilience/analyzer.SurvivabilityReport)."""
    import sys
    out = out or sys.stdout
    if fmt == "json":
        out.write(json.dumps(report.to_dict()) + "\n")
        return
    if fmt == "yaml":
        out.write(yaml.safe_dump(report.to_dict(), sort_keys=False,
                                 default_flow_style=False))
        return
    if fmt not in ("", "pretty"):
        raise ValueError(f"output format {fmt!r} not recognized")

    if report.degraded:
        out.write(_degraded_warning(report.worst_rung))
    out.write(f"Survivability of probe '{report.probe_name}' on "
              f"{report.num_nodes} node(s); baseline headroom "
              f"{report.baseline_headroom}\n")
    out.write(f"{len(report.scenarios)} scenario(s): "
              f"{report.collapsed_scenarios} collapsed as symmetric "
              f"duplicates, {report.batched_scenarios} in one batched "
              f"device sweep, {report.sequential_scenarios} sequential\n")
    bounds = getattr(report, "bounds", None)
    if bounds:
        out.write(f"capacity bracket [{bounds['lower']}, "
                  f"{bounds['upper']}] on the intact cluster; "
                  f"{bounds['pruned']} scenario(s) proved by bounds "
                  f"without a device solve\n")
    mk = report.min_k_to_stranded
    out.write("min k to first stranded pod: "
              f"{mk if mk is not None else '-'}\n")
    mk = report.min_k_to_zero_headroom
    out.write("min k to zero headroom: "
              f"{mk if mk is not None else '-'}\n\n")

    name_w = max([len("SCENARIO")]
                 + [len(r.name) for r in report.scenarios])
    out.write(f"{'SCENARIO':<{name_w}}  {'K':>3}  {'DISPLACED':>9}  "
              f"{'REPLACED':>8}  {'STRANDED':>8}  {'PREEMPTED':>9}  "
              f"{'HEADROOM':>8}\n")
    for r in report.scenarios:
        out.write(f"{r.name:<{name_w}}  {r.k:>3}  {r.displaced:>9}  "
                  f"{r.replaced:>8}  {r.stranded:>8}  {r.preempted:>9}  "
                  f"{r.headroom:>8}\n")
        if r.degraded:
            out.write(f"{'':<{name_w}}  WARNING: degraded — served by "
                      f"rung '{r.rung or '?'}'\n")
        if verbose and r.deduped_of:
            out.write(f"{'':<{name_w}}  (metrics shared with "
                      f"{r.deduped_of})\n")
        if verbose and getattr(r, "bounded_of", None):
            out.write(f"{'':<{name_w}}  (proved by capacity bracket: "
                      f"{r.bounded_of})\n")
        if verbose and r.fail_message:
            out.write(f"{'':<{name_w}}  {r.fail_message}\n")
        bn = getattr(r, "bottleneck", None)
        if bn:
            binding = ", ".join(f"{k} ({v})"
                                for k, v in bn["bindingCounts"].items())
            delta = bn.get("deltaCapacity")
            out.write(f"{'':<{name_w}}  bottleneck: {binding or '-'}; "
                      f"capacity {bn['totalCapacity']}"
                      + (f" ({delta:+d} vs baseline)\n"
                         if delta is not None else "\n"))

    worst = report.worst_nodes()
    if worst:
        out.write("\nWorst nodes (stranded desc, headroom asc):\n")
        for i, (nm, headroom, stranded) in enumerate(worst, 1):
            out.write(f"  {i}. {nm}  headroom={headroom}  "
                      f"stranded={stranded}\n")


def _degraded_warning(rung: str) -> str:
    return (f"WARNING: solve degraded — served by ladder rung "
            f"'{rung or '?'}' after a classified device fault; results "
            f"are bit-identical to the healthy path but the device "
            f"misbehaved (see runtime/degrade.py)\n")


def _pretty_print(r: ClusterCapacityReview, verbose: bool, out) -> None:
    """clusterCapacityReviewPrettyPrint (report.go:235-284), wording
    preserved, after the JAX package's degraded-solve warning line."""
    if r.degraded:
        out.write(_degraded_warning(r.rung))
    if verbose:
        for req in r.pod_requirements:
            out.write(f"{req['podName']} pod requirements:\n")
            out.write(f"\t- CPU: {req['resources']['primaryResources']['cpu']}\n")
            out.write(f"\t- Memory: {req['resources']['primaryResources']['memory']}\n")
            if req["resources"]["scalarResources"]:
                out.write(f"\t- ScalarResources: {req['resources']['scalarResources']}\n")
            if req["nodeSelectors"]:
                sel = ",".join(f"{k}={v}"
                               for k, v in sorted(req["nodeSelectors"].items()))
                out.write(f"\t- NodeSelector: {sel}\n")
            out.write("\n")

    for pod in r.pods:
        total = sum(x.replicas for x in pod.replicas_on_nodes)
        if verbose:
            out.write(f"The cluster can schedule {total} instance(s) of the "
                      f"pod {pod.pod_name}.\n")
        else:
            out.write(f"{total}\n")

    if verbose:
        out.write(f"\nTermination reason: {r.fail_type}: {r.fail_message}\n")

    if verbose and r.replicas > 0:
        for pod in r.pods:
            if pod.fail_summary:
                out.write("fit failure summary on nodes: ")
                out.write(", ".join(f"{fs['reason']} ({fs['count']})"
                                    for fs in pod.fail_summary))
                out.write("\n")
        out.write("\nPod distribution among nodes:\n")
        for pod in r.pods:
            out.write(f"{pod.pod_name}\n")
            for ron in pod.replicas_on_nodes:
                out.write(f"\t- {ron.node_name}: {ron.replicas} instance(s)\n")

    if verbose:
        for pod in r.pods:
            if pod.explain:
                _print_explain(pod.pod_name, pod.explain, out)


def _print_explain(pod_name: str, expl: dict, out) -> None:
    """Render an Explanation.to_dict() artifact as the report's
    explainability section (why-not histogram, why-here totals,
    bottleneck summary)."""
    out.write(f"\nExplainability for {pod_name} "
              f"(rung '{expl.get('rung') or '?'}'):\n")
    reasons = expl.get("reasons") or {}
    if reasons:
        out.write("  why not — node elimination reasons:\n")
        for k, v in sorted(reasons.items(), key=lambda kv: (-kv[1], kv[0])):
            out.write(f"\t- {k}: {v} node(s)\n")
    wh = expl.get("whyHere")
    if wh:
        plugins = expl.get("plugins") or []
        totals = [sum(row[j] for row in wh) for j in range(len(plugins))]
        out.write("  why here — total weighted score contribution by "
                  "plugin:\n")
        for name, t in sorted(zip(plugins, totals), key=lambda x: -x[1]):
            if t:
                out.write(f"\t- {name}: {t:g}\n")
    bn = expl.get("bottleneck")
    if bn:
        out.write("  bottleneck — binding resource per node:\n")
        for k, v in (bn.get("bindingCounts") or {}).items():
            out.write(f"\t- {k}: {v} node(s)\n")
        marginal = bn.get("marginal") or {}
        if marginal:
            out.write("  marginal capacity — adding one unit of R per "
                      "node yields:\n")
            for k, m in marginal.items():
                out.write(f"\t- {k} (+{m['addPerNode']:g}/node): "
                          f"+{m['extraPlacements']} placement(s)\n")

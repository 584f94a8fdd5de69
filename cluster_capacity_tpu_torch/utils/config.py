"""Scheduler profile configuration.

Mirrors the three config tiers of the reference
(cmd/cluster-capacity/app/server.go:102-163 + pkg/utils/utils.go:90-143):
CLI flags, a pod-spec file, and a KubeSchedulerConfiguration-style profile that
controls which filter/score kernels run and their weights.  Defaults mirror
vendor/.../scheduler/apis/config/v1/default_plugins.go:30-51.

The port runs every profile the JAX package runs: float32 or float64
(parity) arithmetic, the deterministic or the random tie-break, and
scheduler extenders (engine/extenders.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import yaml

# Default MultiPoint score weights (default_plugins.go:34-51).
DEFAULT_SCORE_WEIGHTS = {
    "TaintToleration": 3,
    "NodeAffinity": 2,
    "NodeResourcesFit": 1,
    "PodTopologySpread": 2,
    "InterPodAffinity": 2,
    "NodeResourcesBalancedAllocation": 1,
    "ImageLocality": 1,
}

DEFAULT_FILTERS = [
    "NodeUnschedulable",
    "NodeName",
    "TaintToleration",
    "NodeAffinity",
    "NodePorts",
    "NodeResourcesFit",
    "VolumeRestrictions",
    "NodeVolumeLimits",
    "VolumeBinding",
    "VolumeZone",
    "PodTopologySpread",
    "InterPodAffinity",
    # DynamicResources sits at the end of the filter chain when the feature
    # gate is on (default_plugins.go:76); no-op without DRA objects.
    "DynamicResources",
]

# PreEnqueue plugins (SchedulingGates, scheduling_gates.go:49) are modeled as a
# pod-level gate before the scan starts.
DEFAULT_PRE_ENQUEUE = ["SchedulingGates"]

ALL_SCORE_PLUGINS = list(DEFAULT_SCORE_WEIGHTS)

# Every plugin name this framework implements, per extension point — the
# vocabulary ValidateKubeSchedulerConfiguration checks against
# (cmd/cluster-capacity/app/server.go:111; apis/config/validation).
KNOWN_PLUGINS = set(DEFAULT_FILTERS) | set(DEFAULT_SCORE_WEIGHTS) | {
    "SchedulingGates", "PrioritySort", "DefaultPreemption", "DefaultBinder",
    "VolumeRestrictions", "NodeVolumeLimits", "VolumeBinding", "VolumeZone",
}
_SCORING_STRATEGIES = {"LeastAllocated", "MostAllocated",
                       "RequestedToCapacityRatio"}


class ConfigValidationError(ValueError):
    """A malformed or unknown KubeSchedulerConfiguration field — the analog
    of ValidateKubeSchedulerConfiguration rejecting the config at startup
    instead of silently running with defaults."""


@dataclass
class ScoringStrategy:
    """NodeResourcesFitArgs.ScoringStrategy (apis/config defaults: LeastAllocated
    over cpu:1, memory:1)."""

    type: str = "LeastAllocated"
    resources: List[Tuple[str, int]] = field(
        default_factory=lambda: [("cpu", 1), ("memory", 1)])
    # RequestedToCapacityRatio shape (utilization → score 0-10).
    shape_utilization: List[float] = field(default_factory=lambda: [0.0, 100.0])
    shape_score: List[float] = field(default_factory=lambda: [0.0, 10.0])


@dataclass
class SchedulerProfile:
    name: str = "default-scheduler"
    filters: List[str] = field(default_factory=lambda: list(DEFAULT_FILTERS))
    score_weights: Dict[str, int] = field(
        default_factory=lambda: dict(DEFAULT_SCORE_WEIGHTS))
    fit_strategy: ScoringStrategy = field(default_factory=ScoringStrategy)
    balanced_resources: List[Tuple[str, int]] = field(
        default_factory=lambda: [("cpu", 1), ("memory", 1)])
    # Parity mode: score every feasible node (reference's adaptive sampling,
    # schedule_one.go:697-725, is order-dependent; disabled for determinism).
    # Set a percentage (or enable adaptive_sampling for the reference's
    # `max(5, 50-N/125)` formula) to emulate the sampling deterministically:
    # the first numFeasibleNodesToFind feasible nodes in round-robin order
    # from a rotating start index (schedule_one.go:610-694).
    percentage_of_nodes_to_score: int = 100
    adaptive_sampling: bool = False
    # PostFilter plugins (DefaultPreemption enabled by default,
    # default_plugins.go:47): when a cycle ends Unschedulable, lower-priority
    # victims may be evicted and the solve resumes.
    post_filters: List[str] = field(
        default_factory=lambda: ["DefaultPreemption"])
    # Append the reference's "preemption: 0/N nodes are available: ..."
    # clause to the failure message (off by default: the clause text varies
    # across kube versions and the reports stay cleaner without it).
    include_preemption_message: bool = False
    # Scheduler extenders (HTTP webhooks or injected callables); when set the
    # solve runs the host-driven extender loop (engine/extenders.py).
    extenders: List = field(default_factory=list)
    # The JAX package's switch for its interleaved studies (tensor-engine
    # extender verdicts, or the object-level queue loop for stateful
    # webhooks); carried so profiles and recorded scenarios have the same
    # fields in both packages.
    tensor_extenders: bool = True
    # NodeAffinityArgs.addedAffinity: extra required node affinity applied to
    # every pod of the profile (node_affinity.go args).
    added_affinity: Optional[dict] = None
    # NodeResourcesFitArgs ignored resources (fit.go:626-640)
    ignored_resources: List[str] = field(default_factory=list)
    ignored_resource_groups: List[str] = field(default_factory=list)
    # InterPodAffinityArgs.ignorePreferredTermsOfExistingPods (scoring.go:144)
    ignore_preferred_terms_of_existing_pods: bool = False
    # Deterministic tie-break (lowest node index) instead of the reference's
    # reservoir sampling among score ties (schedule_one.go:894-946).
    deterministic: bool = True
    seed: int = 0
    # float64 gives bit-exact parity with the reference's int64 score
    # arithmetic (the scan step serves it; kernel 1 is float32).
    compute_dtype: str = "float32"

    def filter_enabled(self, name: str) -> bool:
        return name in self.filters

    def score_weight(self, name: str) -> int:
        return int(self.score_weights.get(name, 0))

    @classmethod
    def parity(cls) -> "SchedulerProfile":
        return cls(compute_dtype="float64")


def load_scheduler_config(path: str) -> SchedulerProfile:
    """Load a KubeSchedulerConfiguration YAML (the --default-config /
    --config input format, cmd/cluster-capacity/app/server.go:193-208).

    Supports: profiles[0].plugins.{filter,score}.{enabled,disabled} (with "*"
    wildcard) and pluginConfig args for NodeResourcesFitArgs scoringStrategy.
    Malformed configs are rejected loudly (ConfigValidationError), mirroring
    ValidateKubeSchedulerConfiguration at cmd/cluster-capacity/app/server.go:111
    — a typo'd plugin name must not silently run with defaults.
    """
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    _validate_config(cfg)
    prof = SchedulerProfile()
    profiles = cfg.get("profiles") or []
    if not profiles:
        return prof
    p0 = profiles[0] or {}
    # Profile 0 is forcibly renamed default-scheduler (pkg/utils/utils.go:102-108).
    prof.name = "default-scheduler"
    plugins = p0.get("plugins") or {}

    def apply(section: str, defaults: List[str]) -> List[str]:
        sec = plugins.get(section) or {}
        out = list(defaults)
        for d in sec.get("disabled") or []:
            name = d.get("name")
            if name == "*":
                out = []
            elif name in out:
                out.remove(name)
        for e in sec.get("enabled") or []:
            name = e.get("name")
            if name and name not in out:
                out.append(name)
        return out

    prof.filters = apply("filter", DEFAULT_FILTERS)
    prof.post_filters = apply("postFilter", ["DefaultPreemption"])
    score_names = apply("score", list(DEFAULT_SCORE_WEIGHTS))
    weights = {}
    for name in score_names:
        weights[name] = DEFAULT_SCORE_WEIGHTS.get(name, 1)
    sec = plugins.get("score") or {}
    for e in sec.get("enabled") or []:
        if e.get("weight") and e.get("name") in weights:
            weights[e["name"]] = int(e["weight"])
    prof.score_weights = weights

    for pc in p0.get("pluginConfig") or []:
        if pc.get("name") == "NodeResourcesFit":
            args = pc.get("args") or {}
            prof.ignored_resources = list(args.get("ignoredResources") or [])
            prof.ignored_resource_groups = list(
                args.get("ignoredResourceGroups") or [])
            strat = args.get("scoringStrategy") or {}
            if strat:
                resources = [(r.get("name"), int(r.get("weight", 1)))
                             for r in strat.get("resources") or []]
                shape = strat.get("requestedToCapacityRatio", {}).get("shape") or []
                prof.fit_strategy = ScoringStrategy(
                    type=strat.get("type", "LeastAllocated"),
                    resources=resources or [("cpu", 1), ("memory", 1)],
                    shape_utilization=[float(s.get("utilization", 0))
                                       for s in shape] or [0.0, 100.0],
                    shape_score=[float(s.get("score", 0)) for s in shape]
                    or [0.0, 10.0],
                )
        if pc.get("name") == "NodeAffinity":
            args = pc.get("args") or {}
            if args.get("addedAffinity"):
                prof.added_affinity = args["addedAffinity"]
        if pc.get("name") == "InterPodAffinity":
            args = pc.get("args") or {}
            prof.ignore_preferred_terms_of_existing_pods = bool(
                args.get("ignorePreferredTermsOfExistingPods"))
        if pc.get("name") == "NodeResourcesBalancedAllocation":
            args = pc.get("args") or {}
            res = [(r.get("name"), int(r.get("weight", 1)))
                   for r in args.get("resources") or []]
            if res:
                prof.balanced_resources = res
    pct = p0.get("percentageOfNodesToScore") or cfg.get("percentageOfNodesToScore")
    if pct:
        prof.percentage_of_nodes_to_score = int(pct)
    if cfg.get("extenders"):
        from ..engine.extenders import parse_extenders
        prof.extenders = parse_extenders(cfg)
    return prof


def _validate_config(cfg: dict) -> None:
    """Reject unknown plugin names and malformed fields before anything runs
    (the ValidateKubeSchedulerConfiguration analog).  Malformed TYPES must
    also surface as ConfigValidationError, not raw tracebacks."""
    try:
        _validate_config_inner(cfg)
    except ConfigValidationError:
        raise
    except Exception as e:
        raise ConfigValidationError(
            f"invalid KubeSchedulerConfiguration: malformed structure "
            f"({type(e).__name__}: {e})") from e


def _validate_config_inner(cfg: dict) -> None:
    errs: List[str] = []

    kind = cfg.get("kind")
    if kind is not None and kind != "KubeSchedulerConfiguration":
        errs.append(f"unexpected kind {kind!r} "
                    f"(want KubeSchedulerConfiguration)")
    api = cfg.get("apiVersion")
    if api is not None and not str(api).startswith(
            "kubescheduler.config.k8s.io/"):
        errs.append(f"unexpected apiVersion {api!r}")

    profiles = cfg.get("profiles") or []
    if len(profiles) > 1:
        # the reference forces a single profile renamed default-scheduler
        # (pkg/utils/utils.go:102-108)
        errs.append(f"exactly one profile is supported, got {len(profiles)}")
    for p in profiles:
        if not isinstance(p, dict):
            errs.append(f"profile entries must be mappings, got {type(p).__name__}")
            continue
        plugins = p.get("plugins") or {}
        if not isinstance(plugins, dict):
            errs.append("profiles[].plugins must be a mapping")
            plugins = {}
        for section, sec in plugins.items():
            for kind_key in ("enabled", "disabled"):
                for e in (sec or {}).get(kind_key) or []:
                    name = (e or {}).get("name")
                    if name is None:
                        errs.append(f"plugins.{section}.{kind_key} entry "
                                    f"without a name")
                    elif name != "*" and name not in KNOWN_PLUGINS:
                        errs.append(f"unknown plugin "
                                    f"plugins.{section}.{kind_key}: {name!r}")
                    w = (e or {}).get("weight")
                    if w is not None:
                        try:
                            if int(w) < 0:
                                errs.append(f"plugin {name!r}: weight must "
                                            f"be >= 0")
                        except (TypeError, ValueError):
                            errs.append(f"plugin {name!r}: weight {w!r} is "
                                        f"not an integer")
        for pc in p.get("pluginConfig") or []:
            name = (pc or {}).get("name")
            if name not in KNOWN_PLUGINS:
                errs.append(f"pluginConfig for unknown plugin {name!r}")
            if name == "NodeResourcesFit":
                strat = ((pc.get("args") or {}).get("scoringStrategy")
                         or {}).get("type")
                if strat and strat not in _SCORING_STRATEGIES:
                    errs.append(f"unknown scoringStrategy type {strat!r}")
        pct = p.get("percentageOfNodesToScore")
        if pct is not None and not (0 <= int(pct) <= 100):
            errs.append(f"percentageOfNodesToScore must be in [0, 100], "
                        f"got {pct}")
    pct = cfg.get("percentageOfNodesToScore")
    if pct is not None and not (0 <= int(pct) <= 100):
        errs.append(f"percentageOfNodesToScore must be in [0, 100], got {pct}")
    for e in cfg.get("extenders") or []:
        if not (e or {}).get("urlPrefix"):
            errs.append("extender without urlPrefix")
        for verb in ("filterVerb", "prioritizeVerb", "bindVerb",
                     "preemptVerb"):
            v = (e or {}).get(verb)
            if v is not None and not isinstance(v, str):
                errs.append(f"extender {verb} must be a string")
    if errs:
        raise ConfigValidationError(
            "invalid KubeSchedulerConfiguration: " + "; ".join(errs))

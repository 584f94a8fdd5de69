"""The work of one placement step with InterPodAffinity's planes live,
counted from a cell's pod descriptions and shapes (not from the program's
launch tables): roofline.py's step plus InterPodAffinity's per-node work
(the filter probes, the preferred score and its min-max normalisation over
the feasible nodes, the commit to the chosen node's domain) and its planes
(each group's domain ids and counts, the static preference).

Groups are the topology keys that the pod's terms and the residents' terms
name; a plane is live as kernel 1's step reads it: "filter" where the pod
has a required term or a resident a required anti-affinity term,
"affinity" and "anti_affinity" for the pod's own required terms,
"preferred" where the pod has a preferred term (the score's carried
counts), and the score itself wherever any term can score the pod.
"""

from __future__ import annotations

from typing import Dict, Iterable, Set, Tuple

from . import roofline

_KINDS = ("podAffinity", "podAntiAffinity")
_REQ = "requiredDuringSchedulingIgnoredDuringExecution"
_PREF = "preferredDuringSchedulingIgnoredDuringExecution"


def _terms(desc: dict) -> Dict[Tuple[str, str], list]:
    """(kind, "required" or "preferred") -> the terms of one flat pod
    description (reference/cluster.make_pod's)."""
    aff = ((desc.get("spec") or {}).get("affinity")) or {}
    out = {}
    for kind in _KINDS:
        section = aff.get(kind) or {}
        out[(kind, "required")] = list(section.get(_REQ) or [])
        out[(kind, "preferred")] = [t.get("podAffinityTerm") or {}
                                    for t in section.get(_PREF) or []]
    return out


def ipa_shape(pod: dict, residents: Iterable[dict]) -> Tuple[int, Set[str],
                                                           bool]:
    """(groups, live planes, score live) of a question about `pod` over
    residents described by `residents`."""
    mine = _terms(pod)
    theirs = [_terms(r) for r in residents]
    keys = {t.get("topologyKey", "") for terms in [mine] + theirs
            for ts in terms.values() for t in ts}
    planes = set()
    if mine[("podAffinity", "required")]:
        planes.add("affinity")
    if mine[("podAntiAffinity", "required")]:
        planes.add("anti_affinity")
    if planes or any(t[("podAntiAffinity", "required")] for t in theirs):
        planes.add("filter")
    if any(mine[(kind, "preferred")] for kind in _KINDS):
        planes.add("preferred")
    # what scores: preferred terms on either side, required affinity terms
    # on either side (hardPodAffinityWeight)
    score = any(terms[(kind, "preferred")] or terms[("podAffinity",
                                                      "required")]
                for terms in [mine] + theirs for kind in _KINDS)
    return len(keys), planes, score


def ipa_ops(groups: int, planes: Set[str], score: bool) -> int:
    """InterPodAffinity's float operations per node per step."""
    ops = 0
    if "filter" in planes:
        if "affinity" in planes:
            ops += 5 * groups + 3        # key, count, escape
        if "anti_affinity" in planes:
            ops += 8 * groups            # the pod's and the clones' terms
        ops += 5                         # existing pods', the three gates
    if score:
        if "preferred" in planes:
            ops += 3 * groups            # carried counts at the domain
        ops += 12                        # masked min and max, normalise
    carried = len(planes & {"affinity", "anti_affinity", "preferred"})
    if carried:
        ops += groups * (6 + 2 * carried)    # the chosen domain, commit
    return ops


def ipa_planes(groups: int, planes: Set[str], score: bool
               ) -> Tuple[int, int]:
    """(planes read, planes written) once a solve, per node."""
    carried = groups * len(planes & {"affinity", "anti_affinity",
                                     "preferred"})
    read = carried + (groups if planes or score else 0)     # + domain ids
    if "filter" in planes:
        read += 2 * groups + 1          # static counts, existing anti
    if score:
        read += 1                       # static preference
    return read, carried


def least_seconds(nodes: int, resources: int, hard_spreads: int,
                  steps: int, groups: int, planes: Set[str], score: bool,
                  kind: str = "") -> dict:
    """roofline.least_seconds with InterPodAffinity's work added."""
    peak = roofline.peak_for(kind)
    per_node = roofline.step_ops(resources, hard_spreads) + \
        ipa_ops(groups, planes, score)
    flops = per_node * nodes * steps
    read, written = ipa_planes(groups, planes, score)
    moved = roofline.step_bytes(nodes, resources, hard_spreads, steps) + \
        4 * nodes * (read + written)
    t_ops = flops / peak["f32_flops"]
    t_bytes = moved / peak["hbm_bytes"]
    return {"seconds": max(t_ops, t_bytes), "flops": flops, "bytes": moved,
            "bound": "operations" if t_ops >= t_bytes else "bytes"}

"""InterPodAffinity: filter + score as carried topology-pair count tensors.

Reference semantics (vendor/k8s.io/kubernetes/pkg/scheduler/framework/plugins/interpodaffinity/):
- PreFilter (filtering.go:91-310) builds three (topologyKey,value)→count maps:
  affinityCounts / antiAffinityCounts for the incoming pod's required terms vs
  existing pods, and existingAntiAffinityCounts for existing pods' required
  anti-affinity terms vs the incoming pod.
- Filter (filtering.go:352-433) is three hash probes, in order: pod affinity
  (UnschedulableAndUnresolvable, with the lonely-pod self-match escape hatch at
  :400-406), pod anti-affinity, existing-pods anti-affinity.
- Score (scoring.go:100-300): weighted preferred terms, both directions
  (incoming↔existing), min-max normalized.

Design: terms are grouped by topologyKey; each group's (value→count) map
becomes one row of a `[G, D]` tensor, carried per node by the engine.  Because clones
are identical, every placement's increment is a static per-term boolean
(`self_match`) — the dynamic update is a one-hot scatter at the chosen node's
domain.  The merged-map semantics (counts shared between terms with the same
topologyKey) are preserved exactly.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import numpy as np

from ..models.labels import match_label_selector
from ..models.snapshot import ClusterSnapshot
from ..obs import spans as obs_spans
from ..parallel.mesh import PLAIN
from ..utils import metrics
from .pod_topology_spread import fold_rows

REASON_AFFINITY = "node(s) didn't match pod affinity rules"
REASON_ANTI_AFFINITY = "node(s) didn't match pod anti-affinity rules"
REASON_EXISTING_ANTI = "node(s) didn't satisfy existing pods anti-affinity rules"

# InterPodAffinityArgs.HardPodAffinityWeight default
# (apis/config/v1/defaults.go:187-188).
HARD_POD_AFFINITY_WEIGHT = 1.0


def _term_namespaces(term: Mapping, owner_ns: str) -> Tuple[set, Optional[Mapping]]:
    """getNamespacesFromPodAffinityTerm: explicit namespaces, else the owner's
    namespace when no namespaceSelector is given."""
    namespaces = set(term.get("namespaces") or [])
    ns_selector = term.get("namespaceSelector")
    if not namespaces and ns_selector is None:
        namespaces = {owner_ns}
    return namespaces, ns_selector


def _ns_labels_map(snapshot: ClusterSnapshot) -> Dict[str, Mapping[str, str]]:
    out = {}
    for ns in snapshot.namespaces:
        meta = ns.get("metadata") or {}
        out[meta.get("name", "")] = meta.get("labels") or {}
    return out


def _term_matches_pod(term: Mapping, owner_ns: str, candidate: Mapping,
                      ns_labels: Dict[str, Mapping[str, str]]) -> bool:
    """AffinityTerm.Matches: namespace membership (list or selector) AND label
    selector match against the candidate pod."""
    meta = candidate.get("metadata") or {}
    cand_ns = meta.get("namespace") or "default"
    namespaces, ns_selector = _term_namespaces(term, owner_ns)
    ns_ok = cand_ns in namespaces or (
        ns_selector is not None and
        match_label_selector(ns_selector, ns_labels.get(cand_ns, {})))
    if not ns_ok:
        return False
    return match_label_selector(term.get("labelSelector"), meta.get("labels") or {})


def _required_terms(pod: Mapping, kind: str) -> List[Mapping]:
    aff = (pod.get("spec") or {}).get("affinity") or {}
    section = aff.get(kind) or {}
    return section.get("requiredDuringSchedulingIgnoredDuringExecution") or []


def _preferred_terms(pod: Mapping, kind: str) -> List[Mapping]:
    aff = (pod.get("spec") or {}).get("affinity") or {}
    section = aff.get(kind) or {}
    return section.get("preferredDuringSchedulingIgnoredDuringExecution") or []


@dataclass
class AffinityEncoding:
    """Everything InterPodAffinity needs on device for one template."""

    # --- required terms, grouped by topologyKey -------------------------
    num_aff_terms: int
    num_anti_terms: int
    max_domains: int
    aff_group: np.ndarray        # i32[Ta] — group row per affinity term
    anti_group: np.ndarray       # i32[Tn]
    group_keys: List[str]        # key per group row (shared aff+anti vocab)
    node_domain: np.ndarray      # i32[G, N] — -1 when node lacks group key
    aff_init: np.ndarray         # f64[G, D] — merged affinityCounts
    anti_init: np.ndarray        # f64[G, D] — merged antiAffinityCounts
    self_aff_match: np.ndarray   # bool[Ta] — clone matches term (ns+selector)
    self_anti_match: np.ndarray  # bool[Tn]
    escape_allowed: bool         # template matches ALL its own affinity terms
    existing_anti_static: np.ndarray  # bool[N] — existing pods' anti-affinity blocks
    # --- preferred terms (score) ---------------------------------------
    num_pref_terms: int
    pref_group: np.ndarray       # i32[Tp] — group row per preferred term
    pref_weight: np.ndarray      # f64[Tp] — signed (anti terms negative)
    self_pref_match: np.ndarray  # bool[Tp]
    static_pref_score: np.ndarray  # f64[N] — existing-pod contributions
    has_any_score_terms: bool    # static_pref nonzero or dynamic terms exist
    # --- raw material for cross-template increment matrices -------------
    # (the tensor interleave engine asks: when template t's clone lands,
    # how do template u's carried counts change?)
    owner_ns: str = "default"
    raw_aff_terms: List = dataclasses.field(default_factory=list)
    raw_anti_terms: List = dataclasses.field(default_factory=list)
    raw_soft_terms: List = dataclasses.field(default_factory=list)  # (term, w)
    has_affinity_field: bool = False

    @property
    def active(self) -> bool:
        return (self.num_aff_terms + self.num_anti_terms +
                self.num_pref_terms) > 0 or \
            bool(self.existing_anti_static.any()) or \
            bool(np.any(self.static_pref_score != 0.0))


def encode(snapshot: ClusterSnapshot, pod: Mapping,
           ignore_preferred_terms_of_existing_pods: bool = False,
           extra_topology_keys: Sequence[str] = ()
           ) -> AffinityEncoding:
    """extra_topology_keys adds group rows (with real per-node domains) for
    topology keys beyond this pod's own terms — the interleave engine needs
    them so OTHER templates' term contributions (whose keys this pod never
    uses) have a row to land in.

    Residents are read only where they can contribute: every resident when
    the pod has required terms (walk 1) or preferred ones (the score's
    walk), else only the snapshot's affinity_residents, whose own terms
    are the rest.  The innermost open span (obs/spans) gets attrs
    `ipa_path` ("trivial" or "indexed"; "indexed" once any encode under it
    took that path) and `ipa_residents_read` (summed over its encodes).
    Every non-trivial encode runs in its own span `ipa.encode` (attrs
    `groups`, `domains`: summed over the groups, `pod_terms`: required and
    preferred, `resident_terms`: residents' terms that match the pod,
    `residents_read`), and every encode counts once in utils/metrics
    IPA_ENCODES by `path`: "trivial", "indexed" (the pod has no term of
    its own) or "pod_terms"."""
    every_resident = any(_pod_terms(pod))
    bearing = snapshot.affinity_residents()

    if not every_resident and not extra_topology_keys and not bearing:
        # term-free template, no resident with terms: nothing reads a
        # resident, and every field is pod-independent except the
        # namespace — one encoding per (snapshot, namespace) serves the
        # whole sweep (and the sweep dedup's id-cache hashes it once).
        _note_path("trivial", 0)
        metrics.default_registry.inc(metrics.IPA_ENCODES, path="trivial")
        owner_ns = (pod.get("metadata") or {}).get("namespace") or "default"
        has_aff_field = bool((pod.get("spec") or {}).get("affinity"))
        return snapshot.node_memo(
            ("ipa_trivial", owner_ns, has_aff_field),
            lambda: _encode_trivial(snapshot, owner_ns, has_aff_field))

    # The pod's own terms match against every resident's labels (walk 1
    # for required terms, the score's walk for preferred ones); else only
    # the affinity_residents are read, for their terms.
    residents_read = sum(len(snapshot.pods_by_node[i])
                         for i in snapshot.nodes_with_pods()) \
        if every_resident else sum(len(pods) for pods in bearing.values())
    _note_path("indexed", residents_read)
    metrics.default_registry.inc(
        metrics.IPA_ENCODES, path="pod_terms" if every_resident else "indexed")
    with obs_spans.span("ipa.encode",
                        pod_terms=sum(map(len, _pod_terms(pod))),
                        residents_read=residents_read) as sp:
        return _encode_terms(snapshot, pod, bearing,
                             ignore_preferred_terms_of_existing_pods,
                             extra_topology_keys, sp.attrs)


def _pod_terms(pod: Mapping) -> Tuple[List[Mapping], ...]:
    """The pod's required affinity, required anti-affinity, preferred
    affinity and preferred anti-affinity terms."""
    return (_required_terms(pod, "podAffinity"),
            _required_terms(pod, "podAntiAffinity"),
            _preferred_terms(pod, "podAffinity"),
            _preferred_terms(pod, "podAntiAffinity"))


def _encode_terms(snapshot: ClusterSnapshot, pod: Mapping, bearing,
                  ignore_preferred_terms_of_existing_pods: bool,
                  extra_topology_keys: Sequence[str],
                  attrs: dict) -> AffinityEncoding:
    """encode's general path; sets attrs `groups`, `domains` and
    `resident_terms`."""
    n = snapshot.num_nodes
    meta = pod.get("metadata") or {}
    owner_ns = meta.get("namespace") or "default"
    pod_self = {"metadata": {"namespace": owner_ns,
                             "labels": meta.get("labels") or {}}}
    aff_terms, anti_terms, pref_aff, pref_anti = _pod_terms(pod)
    ns_labels = _ns_labels_map(snapshot)

    # Group vocabulary over topology keys used by any term.
    keys: List[str] = []
    def group_of(key: str) -> int:
        if key not in keys:
            keys.append(key)
        return keys.index(key)

    aff_group = np.asarray([group_of(t.get("topologyKey", "")) for t in aff_terms],
                           dtype=np.int32)
    anti_group = np.asarray([group_of(t.get("topologyKey", "")) for t in anti_terms],
                            dtype=np.int32)
    # Score terms with their per-placement dynamic weights.  Soft terms apply
    # in BOTH directions between identical clones (scoring.go:95-99 + :117-119)
    # → 2x weight; existing pods' REQUIRED affinity terms score
    # HardPodAffinityWeight (default 1, apis/config/v1/defaults.go:187-188) in
    # direction (b) only (scoring.go:106-113) → 1x.
    pref_terms = [(t.get("podAffinityTerm") or {},
                   float(t.get("weight", 0)), 2.0 * float(t.get("weight", 0)))
                  for t in pref_aff] + \
                 [(t.get("podAffinityTerm") or {},
                   -float(t.get("weight", 0)), -2.0 * float(t.get("weight", 0)))
                  for t in pref_anti] + \
                 [(t, HARD_POD_AFFINITY_WEIGHT, HARD_POD_AFFINITY_WEIGHT)
                  for t in aff_terms]
    pref_group = np.asarray([group_of(t.get("topologyKey", ""))
                             for t, _, _ in pref_terms], dtype=np.int32)
    for k in extra_topology_keys:
        group_of(k)              # appended AFTER own terms: indices stable

    g = max(len(keys), 1)
    # Domain vocab per group (pod-independent, cached on the snapshot).
    node_domain = np.full((g, n), -1, dtype=np.int32)
    vocabs: List[dict] = [dict() for _ in range(g)]
    for gi, key in enumerate(keys):
        node_domain[gi], vocabs[gi] = snapshot.topology_domains(key)
    d_max = max(max((len(v) for v in vocabs), default=0), 1)
    attrs.update(groups=len(keys), domains=sum(len(v) for v in vocabs))
    has_pref_constraints = bool(pref_aff or pref_anti)
    resident_terms = 0

    aff_init = np.zeros((g, d_max), dtype=np.float64)
    anti_init = np.zeros((g, d_max), dtype=np.float64)
    for i in snapshot.nodes_with_pods() if aff_terms or anti_terms else ():
        for p in snapshot.pods_by_node[i]:
            for terms, groups, init in ((aff_terms, aff_group, aff_init),
                                        (anti_terms, anti_group, anti_init)):
                for t_idx, term in enumerate(terms):
                    gi = groups[t_idx]
                    d = node_domain[gi, i]
                    if d < 0:
                        continue
                    if _term_matches_pod(term, owner_ns, p, ns_labels):
                        init[gi, d] += 1.0

    self_aff = np.asarray([_term_matches_pod(t, owner_ns, pod_self, ns_labels)
                           for t in aff_terms] or [False], dtype=bool)
    self_anti = np.asarray([_term_matches_pod(t, owner_ns, pod_self, ns_labels)
                            for t in anti_terms] or [False], dtype=bool)
    escape = all(_term_matches_pod(t, owner_ns, pod_self, ns_labels)
                 for t in aff_terms) if aff_terms else False

    # Existing pods' required anti-affinity vs the incoming pod → static
    # per-node block mask (their terms never change during the simulation):
    # the blocked values of each topology key.
    blocked_pairs: Dict[str, set] = {}
    for i, pods in bearing.items():
        for p in pods:
            p_ns = (p.get("metadata") or {}).get("namespace") or "default"
            for term in _required_terms(p, "podAntiAffinity"):
                if _term_matches_pod(term, p_ns, pod, ns_labels):
                    resident_terms += 1
                    key = term.get("topologyKey", "")
                    val = snapshot.node_labels(i).get(key)
                    if val is not None:
                        blocked_pairs.setdefault(key, set()).add(val)
    existing_anti_static = np.zeros(n, dtype=bool)
    if blocked_pairs:
        for i in range(n):
            labels = snapshot.node_labels(i)
            existing_anti_static[i] = any(labels.get(k) in vals
                                          for k, vals in blocked_pairs.items())

    # Score-term static contributions from existing pods (processExistingPod,
    # scoring.go:81-125); dynamic contributions from placed clones go through
    # the carried per-term domain weights.
    static_pref = np.zeros(n, dtype=np.float64)
    pair_scores: Dict[Tuple[str, str], float] = {}
    soft_terms = [(t.get("podAffinityTerm") or {}, float(t.get("weight", 0)))
                  for t in pref_aff] + \
                 [(t.get("podAffinityTerm") or {}, -float(t.get("weight", 0)))
                  for t in pref_anti]

    def add_pair(key: str, node_idx: int, weight: float):
        val = snapshot.node_labels(node_idx).get(key)
        if val is not None:
            pair_scores[(key, val)] = pair_scores.get((key, val), 0.0) + weight

    def add_resident_pair(key: str, node_idx: int, weight: float):
        nonlocal resident_terms
        resident_terms += 1
        add_pair(key, node_idx, weight)

    # With no preferred terms of its own the pod scores only against the
    # residents' terms (b), and only affinity_residents have any; the
    # residents keep their order either way, and so do the sums.
    if has_pref_constraints:
        score_rows = ((i, snapshot.pods_by_node[i])
                      for i in snapshot.nodes_with_pods())
    elif not ignore_preferred_terms_of_existing_pods:
        score_rows = bearing.items()
    else:
        score_rows = ()
    for i, pods in score_rows:
        for p in pods:
            p_ns = (p.get("metadata") or {}).get("namespace") or "default"
            p_has_affinity = bool((p.get("spec") or {}).get("affinity"))
            # (a) incoming pod's preferred terms vs this existing pod
            # (scoring.go:93-103).
            if has_pref_constraints:
                for term, w in soft_terms:
                    if _term_matches_pod(term, owner_ns, p, ns_labels):
                        add_pair(term.get("topologyKey", ""), i, w)
            # (b) this existing pod's terms vs the incoming pod — processed
            # when the pod has any affinity, or always when the incoming pod
            # has preferred constraints (scoring.go:145-160, 219-227);
            # skipped entirely under IgnorePreferredTermsOfExistingPods when
            # the incoming pod has no preferred constraints (scoring.go:144).
            if (p_has_affinity or has_pref_constraints) and not (
                    ignore_preferred_terms_of_existing_pods
                    and not has_pref_constraints):
                # required affinity terms score HardPodAffinityWeight
                # (scoring.go:106-113).
                for term in _required_terms(p, "podAffinity"):
                    if _term_matches_pod(term, p_ns, pod, ns_labels):
                        add_resident_pair(term.get("topologyKey", ""), i,
                                 HARD_POD_AFFINITY_WEIGHT)
                for t in _preferred_terms(p, "podAffinity"):
                    term = t.get("podAffinityTerm") or {}
                    if _term_matches_pod(term, p_ns, pod, ns_labels):
                        add_resident_pair(term.get("topologyKey", ""), i,
                                 float(t.get("weight", 0)))
                for t in _preferred_terms(p, "podAntiAffinity"):
                    term = t.get("podAffinityTerm") or {}
                    if _term_matches_pod(term, p_ns, pod, ns_labels):
                        add_resident_pair(term.get("topologyKey", ""), i,
                                 -float(t.get("weight", 0)))
    if pair_scores:
        # each node matches at most one value of a key: per key, its
        # values' (first-seen position, weight), summed per node in the
        # pairs' first-seen order
        by_key: Dict[str, Dict[str, Tuple[int, float]]] = {}
        for pos, ((k, v), w) in enumerate(pair_scores.items()):
            by_key.setdefault(k, {})[v] = (pos, w)
        for i in range(n):
            labels = snapshot.node_labels(i)
            hits = sorted(vals[labels[k]] for k, vals in by_key.items()
                          if labels.get(k) in vals)
            static_pref[i] = sum(w for _pos, w in hits)
    attrs["resident_terms"] = resident_terms

    self_pref = np.asarray([_term_matches_pod(t, owner_ns, pod_self, ns_labels)
                            for t, _, _ in pref_terms] or [False], dtype=bool)

    return AffinityEncoding(
        num_aff_terms=len(aff_terms), num_anti_terms=len(anti_terms),
        max_domains=d_max,
        aff_group=aff_group if len(aff_terms) else np.zeros(1, np.int32),
        anti_group=anti_group if len(anti_terms) else np.zeros(1, np.int32),
        group_keys=keys, node_domain=node_domain,
        aff_init=aff_init, anti_init=anti_init,
        self_aff_match=self_aff, self_anti_match=self_anti,
        escape_allowed=escape, existing_anti_static=existing_anti_static,
        num_pref_terms=len(pref_terms),
        pref_group=pref_group if pref_terms else np.zeros(1, np.int32),
        pref_weight=np.asarray([dw for _, _, dw in pref_terms] or [0.0]),
        self_pref_match=self_pref,
        static_pref_score=static_pref,
        has_any_score_terms=bool(pref_terms) or bool(pair_scores),
        owner_ns=owner_ns,
        raw_aff_terms=list(aff_terms),
        raw_anti_terms=list(anti_terms),
        raw_soft_terms=list(soft_terms),
        has_affinity_field=bool((pod.get("spec") or {}).get("affinity")),
    )


def _note_path(path: str, residents: int) -> None:
    """encode's attrs on the innermost open span, if any."""
    sp = obs_spans.default_collector.current()
    if sp is None:
        return
    if sp.attrs.get("ipa_path") != "indexed":
        sp.attrs["ipa_path"] = path
    sp.attrs["ipa_residents_read"] = \
        sp.attrs.get("ipa_residents_read", 0) + residents


def _encode_trivial(snapshot: ClusterSnapshot, owner_ns: str,
                    has_affinity_field: bool) -> AffinityEncoding:
    """The encoding of a term-free pod on a snapshot where no resident
    carries pod (anti-)affinity terms — field-for-field what the general
    path above produces for that case (kept in lockstep by
    tests/test_torch_ipa_index.py, which holds both to a walk over every
    resident, and tests/test_interleave_tensor.py + the sweep
    differentials, which mix trivial and non-trivial templates)."""
    n = snapshot.num_nodes
    out = AffinityEncoding(
        num_aff_terms=0, num_anti_terms=0, max_domains=1,
        aff_group=np.zeros(1, np.int32), anti_group=np.zeros(1, np.int32),
        group_keys=[], node_domain=np.full((1, n), -1, dtype=np.int32),
        aff_init=np.zeros((1, 1)), anti_init=np.zeros((1, 1)),
        self_aff_match=np.asarray([False]),
        self_anti_match=np.asarray([False]),
        escape_allowed=False, existing_anti_static=np.zeros(n, dtype=bool),
        num_pref_terms=0, pref_group=np.zeros(1, np.int32),
        pref_weight=np.asarray([0.0]), self_pref_match=np.asarray([False]),
        static_pref_score=np.zeros(n, dtype=np.float64),
        has_any_score_terms=False, owner_ns=owner_ns,
        raw_aff_terms=[], raw_anti_terms=[], raw_soft_terms=[],
        has_affinity_field=has_affinity_field,
    )
    return _freeze_encoding(out)


def _freeze_encoding(enc_):
    """snapshot.memo's freeze contract only covers top-level arrays; a
    memoized encoding DATACLASS must freeze its own array fields — they
    are shared by every term-free template of a sweep, and an in-place
    mutation would otherwise corrupt all of them silently."""
    import dataclasses
    for f in dataclasses.fields(enc_):
        v = getattr(enc_, f.name)
        if isinstance(v, np.ndarray):
            v.flags.writeable = False
    return enc_


def group_fold(enc_: AffinityEncoding):
    """Fold per-term bookkeeping into per-GROUP statics (terms sharing a
    topologyKey read/write the same merged count row).  Returns
    (ghas_aff, ghas_anti, aff_ginc, anti_ginc, pref_gw) numpy arrays — the
    single source for both the XLA step consts and the fused kernel meta."""
    g = enc_.node_domain.shape[0]
    ghas_aff = np.zeros(g, dtype=bool)
    ghas_anti = np.zeros(g, dtype=bool)
    aff_ginc = np.zeros(g)
    anti_ginc = np.zeros(g)
    pref_gw = np.zeros(g)
    for t in range(enc_.num_aff_terms):
        gi = int(enc_.aff_group[t])
        ghas_aff[gi] = True
        aff_ginc[gi] += float(enc_.self_aff_match[t])
    for t in range(enc_.num_anti_terms):
        gi = int(enc_.anti_group[t])
        ghas_anti[gi] = True
        anti_ginc[gi] += float(enc_.self_anti_match[t])
    for t in range(enc_.num_pref_terms):
        pref_gw[int(enc_.pref_group[t])] += \
            float(enc_.self_pref_match[t]) * float(enc_.pref_weight[t])
    return ghas_aff, ghas_anti, aff_ginc, anti_ginc, pref_gw


def pad_groups(enc_: AffinityEncoding, g_rows: int) -> AffinityEncoding:
    """Pad the topology-group axis to g_rows with inert rows (no key on any
    node, zero counts) so heterogeneous templates can share one batched
    solve.  Term arrays keep their lengths — padded groups own no terms."""
    cur = enc_.node_domain.shape[0]
    if cur >= g_rows:
        return enc_
    pad = g_rows - cur
    n = enc_.node_domain.shape[1]
    d = enc_.aff_init.shape[1]
    return dataclasses.replace(
        enc_,
        group_keys=list(enc_.group_keys) + [""] * pad,
        node_domain=np.concatenate([enc_.node_domain,
                                    np.full((pad, n), -1, dtype=np.int32)]),
        aff_init=np.concatenate([enc_.aff_init, np.zeros((pad, d))]),
        anti_init=np.concatenate([enc_.anti_init, np.zeros((pad, d))]),
        raw_aff_terms=list(enc_.raw_aff_terms),
        raw_anti_terms=list(enc_.raw_anti_terms),
        raw_soft_terms=list(enc_.raw_soft_terms))


# ---------------------------------------------------------------------------
# Device-side functions (torch; dense per-node count formulation)
# ---------------------------------------------------------------------------

def filter_all(aff_cnt: torch.Tensor, anti_cnt: torch.Tensor,
               anti_dyn_cnt: torch.Tensor, node_domain: torch.Tensor,
               ghas_aff: torch.Tensor, ghas_anti: torch.Tensor,
               num_aff: int, num_anti: int, map_empty,
               escape_allowed: bool, existing_anti_static: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """Run the three probes (filtering.go:352-433) for every node.

    aff_cnt/anti_cnt: f[G, N] total (static+dynamic) per-node counts;
    anti_dyn_cnt: f[G, N] dynamic-only counts; ghas_aff/ghas_anti: bool[G]
    group carries >= 1 required (anti-)affinity term; map_empty: the
    lonely-pod escape hatch condition (filtering.go:400-406), a bool[] tensor
    (no host sync) or False.
    Returns (pass, fail_affinity, fail_anti, fail_existing_anti), each bool[N].
    """
    n = node_domain.shape[1]
    dev = node_domain.device
    has_key = node_domain >= 0                                  # [G, N]

    if num_aff > 0:
        ok_g = (~ghas_aff[:, None]) | (has_key & (aff_cnt > 0))
        pods_exist = ok_g.all(dim=0)
        if escape_allowed and map_empty is not False:
            all_keys = ((~ghas_aff[:, None]) | has_key).all(dim=0)
            aff_ok = pods_exist | (all_keys & map_empty)
        else:
            aff_ok = pods_exist
    else:
        aff_ok = torch.ones(n, dtype=torch.bool, device=dev)

    if num_anti > 0:
        anti_fail = (ghas_anti[:, None] & has_key & (anti_cnt > 0)).any(dim=0)
        eanti_dyn = (ghas_anti[:, None] & has_key
                     & (anti_dyn_cnt > 0)).any(dim=0)
    else:
        anti_fail = torch.zeros(n, dtype=torch.bool, device=dev)
        eanti_dyn = torch.zeros(n, dtype=torch.bool, device=dev)

    eanti_fail = existing_anti_static | eanti_dyn
    fail_aff = ~aff_ok
    fail_anti = aff_ok & anti_fail
    fail_eanti = aff_ok & ~anti_fail & eanti_fail
    ok = aff_ok & ~anti_fail & ~eanti_fail
    return ok, fail_aff, fail_anti, fail_eanti


def pref_score(pref_cnt: torch.Tensor, node_domain: torch.Tensor,
               static_pref: torch.Tensor, num_pref: int) -> torch.Tensor:
    """Raw preferred-term score per node: static + carried dynamic weights,
    each group's merged row summed once (scoring.go topologyScore map), the
    rows folded left in group order."""
    score = static_pref
    if num_pref > 0:
        score = score + fold_rows(torch.where(node_domain >= 0, pref_cnt,
                                              0.0))
    return score


def normalize(raw: torch.Tensor, feasible: torch.Tensor,
              active: bool, red=PLAIN) -> torch.Tensor:
    """NormalizeScore (scoring.go:268-300): min-max to 0-100 over the
    feasible set; all-equal (or inactive plugin) -> zeros.  `red`: the
    node-axis reducer (parallel/mesh.py), a node shard's on a mesh."""
    if not active:
        return torch.zeros_like(raw)
    max_s = red.max(torch.where(feasible, raw, -np.inf))
    min_s = red.min(torch.where(feasible, raw, np.inf))
    diff = max_s - min_s
    out = torch.where(diff > 0, torch.floor(
        100.0 * (raw - min_s) / torch.where(diff > 0, diff, 1.0)), 0.0)
    return torch.where(feasible, out, 0.0)

"""InterPodAffinity's encode over the snapshot's index of affinity-bearing
residents (models/snapshot.ClusterSnapshot.affinity_residents).

The port's ops/inter_pod_affinity.encode reads every resident only when the
incoming pod has terms of its own, else only the residents that carry pod
(anti-)affinity terms.  Over seeded random clusters its encoding must equal,
field for field (np.array_equal, exact), both the JAX package's encoder and
a plain walk over every resident written here.  The index is carried across
the roster commit (models/snapshot.replace_rosters): after each commit of a
chain it must equal one built from scratch on the same rosters, and leave
the old snapshot's index as it was.  Tolerance: exact.
"""

import random

import numpy as np
import pytest

from cluster_capacity_tpu.models.snapshot import ClusterSnapshot as JSnap
from cluster_capacity_tpu.ops import inter_pod_affinity as jipa
from cluster_capacity_tpu_torch.engine import encode as tenc
from cluster_capacity_tpu_torch.models import snapshot as tsnap
from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot as TSnap
from cluster_capacity_tpu_torch.obs import spans as obs_spans
from cluster_capacity_tpu_torch.ops import inter_pod_affinity as tipa
from cluster_capacity_tpu_torch.utils.config import SchedulerProfile

from helpers import build_test_node, build_test_pod
from test_torch_encode import assert_same

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
RACK = "example.com/rack"
KEYS = (ZONE, HOST, RACK)
APPS = ("web", "db", "cache")
NAMESPACES = [{"metadata": {"name": "default", "labels": {"team": "red"}}},
              {"metadata": {"name": "ns1", "labels": {"team": "blue"}}},
              {"metadata": {"name": "ns2", "labels": {}}}]
NS_NAMES = ("default", "ns1", "ns2")
TERM_KINDS = ("req_aff", "req_anti", "pref_aff", "pref_anti")


# --- seeded random clusters ---------------------------------------------------

def _selector(rng):
    pick = rng.randrange(3)
    if pick == 0:
        return {"matchLabels": {"app": rng.choice(APPS)}}
    if pick == 1:
        return {"matchExpressions": [{"key": "app", "operator": "In",
                                      "values": rng.sample(APPS, 2)}]}
    return {"matchExpressions": [{"key": "tier", "operator": "Exists"}]}


def _term(rng):
    term = {"labelSelector": _selector(rng), "topologyKey": rng.choice(KEYS)}
    pick = rng.randrange(4)
    if pick == 1:
        term["namespaces"] = rng.sample(NS_NAMES, rng.randint(1, 2))
    elif pick == 2:
        term["namespaceSelector"] = {
            "matchLabels": {"team": rng.choice(("red", "blue"))}}
    elif pick == 3:
        term["namespaceSelector"] = {}          # every namespace
    return term


def _affinity(rng, kinds):
    """spec.affinity with one or two terms of each kind in `kinds`."""
    aff = {}
    for kind in kinds:
        section = aff.setdefault(
            "podAffinity" if kind.endswith("_aff") else "podAntiAffinity", {})
        n = rng.randint(1, 2)
        if kind.startswith("req"):
            section["requiredDuringSchedulingIgnoredDuringExecution"] = \
                [_term(rng) for _ in range(n)]
        else:
            section["preferredDuringSchedulingIgnoredDuringExecution"] = \
                [{"weight": rng.randint(1, 100), "podAffinityTerm": _term(rng)}
                 for _ in range(n)]
    return aff


def _node_affinity_only(rng):
    """spec.affinity with no pod-affinity term: a nodeAffinity, at times
    beside empty pod-affinity sections."""
    aff = {"nodeAffinity": {
        "requiredDuringSchedulingIgnoredDuringExecution": {
            "nodeSelectorTerms": [{"matchExpressions": [
                {"key": ZONE, "operator": "Exists"}]}]}}}
    if rng.random() < 0.5:
        aff["podAntiAffinity"] = {}
        aff["podAffinity"] = {
            "requiredDuringSchedulingIgnoredDuringExecution": []}
    return aff


def _labels(rng):
    out = {"app": rng.choice(APPS)}
    if rng.random() < 0.5:
        out["tier"] = rng.choice(("front", "back"))
    return out


def _resident_affinity(rng, residents):
    if residents == "all":
        return _affinity(rng, rng.sample(TERM_KINDS, rng.randint(1, 4)))
    if residents == "all_anti":
        return _affinity(rng, ["req_anti"])
    if residents == "some" and rng.random() < 0.3:
        return _affinity(rng, rng.sample(TERM_KINDS, rng.randint(1, 4)))
    if residents in ("some", "node_affinity") and rng.random() < 0.4:
        return _node_affinity_only(rng)
    return None


def _cluster(seed, residents):
    """Ten nodes in three zones, a rack label on two in three, zero to four
    residents a node in three namespaces; `residents` says which of them
    carry pod (anti-)affinity terms."""
    rng = random.Random(seed)
    nodes, pods = [], []
    for k in range(10):
        labels = {ZONE: f"z{k % 3}", HOST: f"n{k}"}
        if k % 3:
            labels[RACK] = f"r{k % 2}"
        nodes.append(build_test_node(f"n{k}", 4000, int(8e9), 20,
                                     labels=labels))
        for j in range(rng.randint(0, 4)):
            pod = build_test_pod(f"p{k}-{j}", 100, 0, node_name=f"n{k}",
                                 labels=_labels(rng),
                                 namespace=rng.choice(NS_NAMES))
            aff = _resident_affinity(rng, residents)
            if aff is not None:
                pod["spec"]["affinity"] = aff
            pods.append(pod)
    return nodes, pods


def _incoming(seed, kinds):
    rng = random.Random(seed + 7919)
    pod = build_test_pod("incoming", 100, 0, labels=_labels(rng),
                         namespace=rng.choice(NS_NAMES))
    if kinds == ("node_affinity",):
        pod["spec"]["affinity"] = _node_affinity_only(rng)
    elif kinds:
        pod["spec"]["affinity"] = _affinity(rng, kinds)
    return pod


# --- the plain walk -----------------------------------------------------------

def _full_walk(snapshot, pod, ignore_preferred=False, extra_keys=()):
    """InterPodAffinity's encoding by one walk over every resident of every
    node: the pod's required terms against the resident, the resident's
    required anti-affinity against the pod, the pod's preferred terms
    against the resident and the resident's terms against the pod."""
    n = snapshot.num_nodes
    meta = pod.get("metadata") or {}
    owner_ns = meta.get("namespace") or "default"
    pod_self = {"metadata": {"namespace": owner_ns,
                             "labels": meta.get("labels") or {}}}
    ns_labels = tipa._ns_labels_map(snapshot)
    matches = tipa._term_matches_pod
    aff_terms = tipa._required_terms(pod, "podAffinity")
    anti_terms = tipa._required_terms(pod, "podAntiAffinity")
    soft = [(t.get("podAffinityTerm") or {}, float(t.get("weight", 0)))
            for t in tipa._preferred_terms(pod, "podAffinity")] + \
           [(t.get("podAffinityTerm") or {}, -float(t.get("weight", 0)))
            for t in tipa._preferred_terms(pod, "podAntiAffinity")]
    pref_terms = [(t, w, 2.0 * w) for t, w in soft] + \
        [(t, tipa.HARD_POD_AFFINITY_WEIGHT, tipa.HARD_POD_AFFINITY_WEIGHT)
         for t in aff_terms]

    keys = []
    for t in aff_terms + anti_terms + [t for t, _, _ in pref_terms]:
        if t.get("topologyKey", "") not in keys:
            keys.append(t.get("topologyKey", ""))
    keys += [k for k in extra_keys if k not in keys]
    key_row = {k: r for r, k in enumerate(keys)}
    g = max(len(keys), 1)
    node_domain = np.full((g, n), -1, dtype=np.int32)
    vocabs = [{} for _ in range(g)]
    for r, key in enumerate(keys):
        for i in range(n):
            val = snapshot.node_labels(i).get(key)
            if val is not None:
                node_domain[r, i] = vocabs[r].setdefault(val, len(vocabs[r]))
    d_max = max(max(len(v) for v in vocabs), 1)

    aff_init = np.zeros((g, d_max))
    anti_init = np.zeros((g, d_max))
    blocked = set()
    pair_scores = {}

    def add_pair(key, i, w):
        val = snapshot.node_labels(i).get(key)
        if val is not None:
            pair_scores[(key, val)] = pair_scores.get((key, val), 0.0) + w

    for i in range(n):
        for p in snapshot.pods_by_node[i]:
            p_ns = (p.get("metadata") or {}).get("namespace") or "default"
            for terms, init in ((aff_terms, aff_init), (anti_terms, anti_init)):
                for term in terms:
                    row = key_row[term.get("topologyKey", "")]
                    d = node_domain[row, i]
                    if d >= 0 and matches(term, owner_ns, p, ns_labels):
                        init[row, d] += 1.0
            for term in tipa._required_terms(p, "podAntiAffinity"):
                val = snapshot.node_labels(i).get(term.get("topologyKey", ""))
                if val is not None and matches(term, p_ns, pod, ns_labels):
                    blocked.add((term.get("topologyKey", ""), val))
            for term, w in soft:
                if matches(term, owner_ns, p, ns_labels):
                    add_pair(term.get("topologyKey", ""), i, w)
            if (p.get("spec") or {}).get("affinity") or soft:
                if ignore_preferred and not soft:
                    continue
                for term in tipa._required_terms(p, "podAffinity"):
                    if matches(term, p_ns, pod, ns_labels):
                        add_pair(term.get("topologyKey", ""), i,
                                 tipa.HARD_POD_AFFINITY_WEIGHT)
                for kind, sign in (("podAffinity", 1.0),
                                   ("podAntiAffinity", -1.0)):
                    for t in tipa._preferred_terms(p, kind):
                        term = t.get("podAffinityTerm") or {}
                        if matches(term, p_ns, pod, ns_labels):
                            add_pair(term.get("topologyKey", ""), i,
                                     sign * float(t.get("weight", 0)))

    labels = [snapshot.node_labels(i) for i in range(n)]
    existing_anti = np.asarray([any(lb.get(k) == v for k, v in blocked)
                                for lb in labels], dtype=bool)
    static_pref = np.asarray([sum(w for (k, v), w in pair_scores.items()
                                  if lb.get(k) == v) for lb in labels],
                             dtype=np.float64)

    def self_match(terms):
        return np.asarray([matches(t, owner_ns, pod_self, ns_labels)
                           for t in terms] or [False], dtype=bool)

    def groups(terms):
        return np.asarray([key_row[t.get("topologyKey", "")] for t in terms]
                          or [0], dtype=np.int32)

    return tipa.AffinityEncoding(
        num_aff_terms=len(aff_terms), num_anti_terms=len(anti_terms),
        max_domains=d_max, aff_group=groups(aff_terms),
        anti_group=groups(anti_terms), group_keys=keys,
        node_domain=node_domain, aff_init=aff_init, anti_init=anti_init,
        self_aff_match=self_match(aff_terms),
        self_anti_match=self_match(anti_terms),
        escape_allowed=bool(aff_terms) and bool(self_match(aff_terms).all()),
        existing_anti_static=existing_anti,
        num_pref_terms=len(pref_terms),
        pref_group=groups([t for t, _, _ in pref_terms]),
        pref_weight=np.asarray([dw for _, _, dw in pref_terms] or [0.0]),
        self_pref_match=self_match([t for t, _, _ in pref_terms]),
        static_pref_score=static_pref,
        has_any_score_terms=bool(pref_terms) or bool(pair_scores),
        owner_ns=owner_ns, raw_aff_terms=list(aff_terms),
        raw_anti_terms=list(anti_terms), raw_soft_terms=list(soft),
        has_affinity_field=bool((pod.get("spec") or {}).get("affinity")))


def _assert_encoding(got, want, path):
    assert_same(got, want, path)
    assert got.active == want.active, f"{path}.active"


def _bearing_names(snapshot):
    return [(i, [p["metadata"]["name"] for p in pods])
            for i, pods in snapshot.affinity_residents().items()]


def _fresh_bearing(snapshot):
    """affinity_residents of a snapshot built anew on the same rosters."""
    fresh = TSnap.from_objects(
        snapshot.nodes, [p for plist in snapshot.pods_by_node for p in plist],
        sort_nodes=False,
        **{k: getattr(snapshot, k) for k in tsnap.OBJECT_FIELDS})
    return _bearing_names(fresh)


# --- the encoder against the JAX package's and the plain walk -----------------

RESIDENTS = ("none", "node_affinity", "some", "all", "all_anti")
POD_KINDS = {"no_terms": (), "node_affinity": ("node_affinity",),
             "req_aff": ("req_aff",), "req_anti": ("req_anti",),
             "pref_aff": ("pref_aff",), "pref_anti": ("pref_anti",),
             "every_kind": TERM_KINDS}


@pytest.mark.parametrize("pod_kind", sorted(POD_KINDS))
@pytest.mark.parametrize("residents", RESIDENTS)
def test_encode_equals_jax_and_the_full_walk(residents, pod_kind):
    for seed in (11, 2024, 3_000_000_017):
        nodes, pods = _cluster(seed, residents)
        tsnap_ = TSnap.from_objects(nodes, pods, namespaces=NAMESPACES)
        jsnap = JSnap.from_objects(nodes, pods, namespaces=NAMESPACES)
        pod = _incoming(seed, POD_KINDS[pod_kind])
        for extra in ((), (RACK, ZONE)):
            for ignore in (False, True):
                path = f"seed {seed} extra {extra} ignore {ignore}"
                got = tipa.encode(tsnap_, pod, ignore, extra)
                _assert_encoding(got, jipa.encode(jsnap, pod, ignore, extra),
                                 f"jax: {path}")
                _assert_encoding(got, _full_walk(tsnap_, pod, ignore, extra),
                                 f"walk: {path}")


@pytest.mark.parametrize("residents", RESIDENTS)
def test_the_index_holds_exactly_the_residents_with_terms(residents):
    nodes, pods = _cluster(5, residents)
    snap = TSnap.from_objects(nodes, pods)
    want = [(i, [p["metadata"]["name"] for p in plist
                 if any(tipa._required_terms(p, k) or
                        tipa._preferred_terms(p, k)
                        for k in ("podAffinity", "podAntiAffinity"))])
            for i, plist in enumerate(snap.pods_by_node)]
    assert _bearing_names(snap) == [(i, names) for i, names in want if names]
    if residents in ("none", "node_affinity"):
        assert not snap.affinity_residents()
    if residents in ("all", "all_anti"):
        assert sum(len(v) for v in snap.affinity_residents().values()) \
            == len(pods)


# --- the counter on the innermost open span ----------------------------------

def _attrs_of_one_encode(snapshot, pod, **kw):
    with obs_spans.span("test.encode") as sp:
        tipa.encode(snapshot, pod, **kw)
    return sp.attrs.get("ipa_path"), sp.attrs.get("ipa_residents_read")


@pytest.mark.parametrize("residents", ["none", "node_affinity"])
def test_populated_snapshot_without_bearing_residents_takes_trivial(
        residents):
    nodes, pods = _cluster(3, residents)
    snap = TSnap.from_objects(nodes, pods)
    assert snap.nodes_with_pods() and not snap.affinity_residents()
    pod = _incoming(3, ())
    assert _attrs_of_one_encode(snap, pod) == ("trivial", 0)
    assert _attrs_of_one_encode(snap, pod) == ("trivial", 0)   # memo hit
    _assert_encoding(tipa.encode(snap, pod), _full_walk(snap, pod), "trivial")
    assert tipa.encode(snap, pod) is tipa.encode(snap, dict(pod))


def test_residents_read_counts_exactly_the_bearing_residents():
    nodes, pods = _cluster(9, "some")
    snap = TSnap.from_objects(nodes, pods)
    bearing = sum(len(v) for v in snap.affinity_residents().values())
    assert 0 < bearing < len(pods)
    assert _attrs_of_one_encode(snap, _incoming(9, ())) == \
        ("indexed", bearing)
    assert _attrs_of_one_encode(snap, _incoming(9, ()),
                                extra_topology_keys=(ZONE,)) == \
        ("indexed", bearing)
    for kinds in (("req_anti",), ("pref_aff",)):
        assert _attrs_of_one_encode(snap, _incoming(9, kinds)) == \
            ("indexed", len(pods))


def test_shared_encode_sums_the_counter_over_templates():
    """The race's template encode: one span over every template's encode,
    the count summed, the path indexed once any template took it."""
    nodes, pods = _cluster(13, "some")
    snap = TSnap.from_objects(nodes, pods)
    bearing = sum(len(v) for v in snap.affinity_residents().values())
    templates = [_incoming(13 + k, ()) for k in range(4)]
    with obs_spans.span("test.shared") as sp:
        tenc.encode_problems_shared(snap, templates, SchedulerProfile(),
                                    ipa_extra_keys=(ZONE,))
    assert sp.attrs["ipa_path"] == "indexed"
    assert sp.attrs["ipa_residents_read"] == 4 * bearing
    plain = TSnap.from_objects(nodes, [])
    with obs_spans.span("test.shared") as sp:
        tenc.encode_problems_shared(plain, templates, SchedulerProfile())
    assert (sp.attrs["ipa_path"], sp.attrs["ipa_residents_read"]) == \
        ("trivial", 0)


# --- the carry across the roster commit ---------------------------------------

def _anti_pod(name, node_name):
    pod = build_test_pod(name, 100, 0, node_name=node_name,
                         labels={"app": "db"})
    pod["spec"]["affinity"] = {"podAntiAffinity": {
        "requiredDuringSchedulingIgnoredDuringExecution": [
            {"labelSelector": {"matchLabels": {"app": "web"}},
             "topologyKey": ZONE}]}}
    return pod


def _evict(pbn, predicate):
    changed = [i for i, plist in enumerate(pbn)
               if any(predicate(p) for p in plist)]
    for i in changed:
        pbn[i] = [p for p in pbn[i] if not predicate(p)]
    return changed


def _bearing(p):
    return tsnap.carries_pod_affinity_terms(p)


def _commits(snap):
    """A chain of roster commits as (name, function of the rosters that
    changes them in place and returns the changed rows)."""
    def evict_plain(pbn):
        i = next(i for i, plist in enumerate(pbn)
                 if any(not _bearing(p) for p in plist))
        victim = next(p for p in pbn[i] if not _bearing(p))
        return _evict(pbn, lambda p: p is victim)

    def add_clones(pbn):
        for i in (0, 5):
            pbn[i].append(build_test_pod(f"clone-{i}", 100, 0,
                                         node_name=snap.node_names[i],
                                         labels={"app": "web"}))
        return [0, 5]

    def evict_bearing(pbn):
        victim = next(p for plist in pbn for p in plist
                      if tipa._required_terms(p, "podAntiAffinity"))
        return _evict(pbn, lambda p: p is victim)

    def add_bearing(pbn):
        i = next(i for i, plist in enumerate(pbn)
                 if not any(_bearing(p) for p in plist))
        pbn[i].append(_anti_pod("anti-new", snap.node_names[i]))
        return [i]

    def outside_vocabulary(pbn):
        odd = build_test_pod("odd", 100, 0, node_name=snap.node_names[2])
        odd["spec"]["containers"][0]["resources"]["requests"][
            "example.com/foo"] = "1"
        pbn[2].append(odd)
        return [2]

    def evict_every_bearing(pbn):
        return _evict(pbn, _bearing)

    return [("evict_plain", evict_plain), ("add_clones", add_clones),
            ("evict_bearing", evict_bearing), ("add_bearing", add_bearing),
            ("full_build", outside_vocabulary), ("after_full", add_bearing),
            ("evict_every_bearing", evict_every_bearing),
            ("add_bearing_again", add_bearing)]


def test_carried_index_equals_a_fresh_one_along_a_commit_chain():
    nodes, pods = _cluster(21, "some")
    pods.append(_anti_pod("anti-0", "n3"))
    snap = TSnap.from_objects(nodes, pods, namespaces=NAMESPACES)
    with_terms = _incoming(21, ("req_anti", "pref_aff"))
    without = _incoming(22, ())
    rebuilds = []
    for name, commit in _commits(snap):
        held = snap.affinity_residents()
        held_names = _bearing_names(snap)
        pbn = [list(p) for p in snap.pods_by_node]
        changed = commit(pbn)
        new, rebuilt = tsnap.replace_rosters(snap, pbn, changed)
        rebuilds.append(rebuilt)
        assert (tsnap._AFFINITY_RESIDENTS in getattr(new, "_memo", {})) \
            == (not rebuilt), name
        assert snap.affinity_residents() is held, name
        assert _bearing_names(snap) == held_names, name
        assert _bearing_names(new) == _fresh_bearing(new), name
        for pod in (with_terms, without):
            for ignore in (False, True):
                _assert_encoding(tipa.encode(new, pod, ignore),
                                 _full_walk(new, pod, ignore),
                                 f"{name} ignore {ignore}")
        snap = new
    assert rebuilds == [False] * 4 + [True] + [False] * 3
    assert [names for _, names in _bearing_names(snap)] == [["anti-new"]]


def test_commit_without_a_held_index_leaves_it_lazy():
    nodes, pods = _cluster(4, "some")
    snap = TSnap.from_objects(nodes, pods)
    pbn = [list(p) for p in snap.pods_by_node]
    changed = _evict(pbn, _bearing)
    new, rebuilt = tsnap.replace_rosters(snap, pbn, changed)
    assert not rebuilt
    assert tsnap._AFFINITY_RESIDENTS not in getattr(new, "_memo", {})
    assert not new.affinity_residents()


# --- node-derived memo entries across the commit ------------------------------

def _dressed_cluster():
    """_cluster's ten nodes and two more, with taints, images, a cordon
    and zone labels; a pod that reads every node-derived memo entry:
    tolerations, required and preferred node affinity, images."""
    nodes, pods = _cluster(31, "some")
    nodes.extend(build_test_node(f"m{k}", 4000, int(8e9), 20,
                                 labels={ZONE: f"z{k % 3}", "size": str(k)})
                 for k in range(2))
    for k, node in enumerate(nodes):
        if k % 4 == 1:
            node["spec"]["taints"] = [{"key": "dedicated", "value": "db",
                                       "effect": "NoSchedule"}]
        if k % 4 == 2:
            node["spec"]["taints"] = [{"key": "spot", "value": "yes",
                                       "effect": "PreferNoSchedule"}]
        if k == 5:
            node["spec"]["unschedulable"] = True
        node["status"]["images"] = [
            {"names": ["registry.example/app:v1"],
             "sizeBytes": (200 + 50 * k) * 1024 * 1024}] if k % 2 else []
    pod = build_test_pod("incoming", 100, 0, labels={"app": "web"})
    pod["spec"]["containers"][0]["image"] = "registry.example/app:v1"
    pod["spec"]["tolerations"] = [{"key": "dedicated", "operator": "Equal",
                                   "value": "db", "effect": "NoSchedule"}]
    pod["spec"]["affinity"] = {"nodeAffinity": {
        "requiredDuringSchedulingIgnoredDuringExecution": {
            "nodeSelectorTerms": [{"matchExpressions": [
                {"key": ZONE, "operator": "In", "values": ["z0", "z1"]}]}]},
        "preferredDuringSchedulingIgnoredDuringExecution": [
            {"weight": 7, "preference": {"matchExpressions": [
                {"key": "size", "operator": "Gt", "values": ["0"]}]}}]}}
    return nodes, pods, pod


def test_node_derived_memo_entries_carry_and_pod_derived_ones_do_not():
    nodes, pods, pod = _dressed_cluster()
    prof = SchedulerProfile()
    snap = TSnap.from_objects(nodes, pods, namespaces=NAMESPACES)
    for _ in range(3):
        tenc.encode_problem(snap, pod, prof)
        node_keys = {k for k in snap._memo if k[0] == tsnap._NODE_DERIVED}
        assert {k[1] for k in node_keys} >= {
            "taint_mask", "taint_raw", "unschedulable_mask", "na_mask",
            "na_raw", "il", "node_images", "label_ints", "topology_domains"}
        pbn = [list(p) for p in snap.pods_by_node]
        changed = _evict(pbn, lambda p, v=pbn[0][0]: p is v) \
            if pbn[0] else []
        pbn[3].append(build_test_pod(f"clone-{len(pbn[3])}", 100, 0,
                                     node_name=snap.node_names[3]))
        new, rebuilt = tsnap.replace_rosters(snap, pbn, changed + [3])
        assert not rebuilt
        assert set(new._memo) == node_keys | {tsnap._AFFINITY_RESIDENTS}
        for k in node_keys:
            assert new._memo[k] is snap._memo[k]
        fresh = TSnap.from_objects(new.nodes, [p for plist in pbn
                                               for p in plist],
                                   sort_nodes=False, namespaces=NAMESPACES)
        got, want = tenc.encode_problem(new, pod, prof), \
            tenc.encode_problem(fresh, pod, prof)
        for name in ("snapshot", "profile", "pod"):
            setattr(got, name, None)
            setattr(want, name, None)
        assert_same(got, want, "problem")
        assert {k for k in new._memo if k[0] == tsnap._NODE_DERIVED} == \
            {k for k in fresh._memo if k[0] == tsnap._NODE_DERIVED}
        snap = new


# --- many hostname domains: scheduler_perf's preferred anti-affinity ----------

def _prefanti_term():
    return {"weight": 1, "podAffinityTerm": {
        "labelSelector": {"matchLabels": {"foo": ""}}, "topologyKey": HOST,
        "namespaces": ["sched-1", "sched-0"]}}


@pytest.mark.parametrize("num_nodes", [1, 7, 130])
def test_published_preferred_anti_affinity_equals_jax_and_the_full_walk(
        num_nodes):
    """pod-with-preferred-pod-anti-affinity.yaml's term on every resident
    (sched-0, one or two a node, some in a third namespace or unlabelled)
    and on the pod (sched-1): one static score per hostname, as the JAX
    package and the plain walk give them."""
    rng = random.Random(num_nodes)
    nodes, pods = [], []
    for k in range(num_nodes):
        nodes.append(build_test_node(f"n{k}", 4000, int(8e9), 110,
                                     labels={HOST: f"n{k}"}))
        for j in range(rng.randint(1, 2)):
            pod = build_test_pod(
                f"p{k}-{j}", 100, 0, node_name=f"n{k}",
                labels={"foo": ""} if rng.random() < 0.8 else {},
                namespace="sched-0" if rng.random() < 0.8 else "ns2")
            pod["spec"]["affinity"] = {"podAntiAffinity": {
                "preferredDuringSchedulingIgnoredDuringExecution":
                    [_prefanti_term()]}}
            pods.append(pod)
    pod = build_test_pod("incoming", 100, 0, labels={"foo": ""},
                         namespace="sched-1")
    pod["spec"]["affinity"] = {"podAntiAffinity": {
        "preferredDuringSchedulingIgnoredDuringExecution":
            [_prefanti_term()]}}
    tsnap_ = TSnap.from_objects(nodes, pods)
    got = tipa.encode(tsnap_, pod)
    _assert_encoding(got, jipa.encode(JSnap.from_objects(nodes, pods), pod),
                     "jax")
    _assert_encoding(got, _full_walk(tsnap_, pod), "walk")
    assert got.static_pref_score.min() < 0 and got.max_domains == num_nodes

"""The port's DefaultPreemption loop (framework._solve_with_preemption,
engine/preemption.py) against the JAX package's, on the CPU.

ClusterCapacity.run(device="cpu") of both packages on the scenarios of
tests/test_preemption.py and on a seeded generator of priority/PDB
clusters: equal placements, fail type, FitError and preemption messages,
per-reason counts, rung stamps, -o json report, scheduled pods and
post_run_snapshot rosters (pod names and nodes; clone UIDs are random in
both packages).  Both run the default float32 profile here; the same
scenarios under the float64 parity profile are in
tests/test_torch_parity.py.  The incremental re-snapshot (with_pods_by_node) is held against the full
rebuild, and the dry run's no-candidate path against the full dry run.
Tolerance: exact.
"""

import io
import json

import numpy as np
import pytest

from cluster_capacity_tpu import ClusterCapacity as JCC
from cluster_capacity_tpu.engine import preemption as jpre
from cluster_capacity_tpu.models.podspec import default_pod as j_default_pod
from cluster_capacity_tpu.utils.config import SchedulerProfile as JProfile
from cluster_capacity_tpu.utils.events import default_recorder as j_events
from cluster_capacity_tpu.utils.report import print_review as j_print_review
from cluster_capacity_tpu_torch import ClusterCapacity as TCC
from cluster_capacity_tpu_torch.engine import preemption as tpre
from cluster_capacity_tpu_torch.models import snapshot as tsnap
from cluster_capacity_tpu_torch.models.podspec import default_pod as t_default_pod
from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot as TSnap
from cluster_capacity_tpu_torch.utils.config import SchedulerProfile as TProfile
from cluster_capacity_tpu_torch.utils.events import default_recorder as t_events
from cluster_capacity_tpu_torch.utils.report import print_review as t_print_review

from helpers import build_test_node, build_test_pod

ZONE = "topology.kubernetes.io/zone"


def run_pair(node_list, the_pod, pods=(), max_limit=0, objs=None,
             message=False):
    """(jcc, jres, tcc, tres): both packages' ClusterCapacity.run on one
    fixture, default profile (include_preemption_message=`message`)."""
    out = []
    for cc_cls, prof_cls, default_pod, extra in (
            (JCC, JProfile, j_default_pod, {}),
            (TCC, TProfile, t_default_pod, {"device": "cpu"})):
        profile = prof_cls()
        profile.include_preemption_message = message
        cc = cc_cls(default_pod(the_pod), max_limit=max_limit,
                    profile=profile, **extra)
        cc.sync_with_objects(node_list, list(pods), **dict(objs or {}))
        out += [cc, cc.run()]
    return tuple(out)


def _report(cc, printer):
    buf = io.StringIO()
    printer(cc.report(), fmt="json", out=buf)
    data = json.loads(buf.getvalue())
    data["status"].pop("creationTimestamp")
    return data


def _rosters(snap):
    return [[((p.get("metadata") or {}).get("namespace"),
              (p.get("metadata") or {}).get("name"),
              (p.get("spec") or {}).get("nodeName")) for p in plist]
            for plist in snap.pods_by_node]


def assert_same_run(jcc, jres, tcc, tres):
    assert tres.placements == jres.placements
    assert (tres.fail_type, tres.fail_message) == \
        (jres.fail_type, jres.fail_message)
    assert tres.fail_counts == jres.fail_counts
    assert (tres.rung, tres.degraded) == (jres.rung, jres.degraded)
    assert _report(tcc, t_print_review) == _report(jcc, j_print_review)
    assert [p["spec"]["nodeName"] for p in tcc.scheduled_pods()] == \
        [p["spec"]["nodeName"] for p in jcc.scheduled_pods()]
    js, ts = jcc.post_run_snapshot, tcc.post_run_snapshot
    assert ts.node_names == js.node_names
    assert _rosters(ts) == _rosters(js)
    assert np.array_equal(ts.requested, js.requested)
    assert np.array_equal(ts.nonzero_requested, js.nonzero_requested)


def _prio(p, value):
    p["spec"]["priority"] = value
    return p


# --- tests/test_preemption.py scenarios -------------------------------------

def _evicts_lower():
    return ([build_test_node("n1", 1000, int(1e9), 10)],
            _prio(build_test_pod("vip", 600, 0), 100),
            [_prio(build_test_pod("squatter", 800, 0, node_name="n1"), -1)],
            0, {})


def _equal_priority():
    return ([build_test_node("n1", 1000, int(1e9), 10)],
            build_test_pod("peer", 600, 0),
            [build_test_pod("squatter", 800, 0, node_name="n1")], 0, {})


def _fewest_victims():
    pods = [_prio(build_test_pod(f"small-{i}", 400, 0,
                                 node_name="two-victims"), 0) for i in (1, 2)]
    pods.append(_prio(build_test_pod("big", 800, 0, node_name="one-victim"),
                      0))
    return ([build_test_node("two-victims", 1000, int(1e9), 10),
             build_test_node("one-victim", 1000, int(1e9), 10)],
            _prio(build_test_pod("vip", 900, 0), 10), pods, 1, {})


def _policy_never():
    the_pod = _prio(build_test_pod("gentle", 600, 0), 100)
    the_pod["spec"]["preemptionPolicy"] = "Never"
    return ([build_test_node("n1", 1000, int(1e9), 10)], the_pod,
            [_prio(build_test_pod("squatter", 800, 0, node_name="n1"), -1)],
            0, {})


def _pdb_choice():
    protected = _prio(build_test_pod("guarded", 800, 0, node_name="protected",
                                     labels={"app": "guarded"}), 0)
    open_pod = _prio(build_test_pod("plain", 800, 0, node_name="open"), 0)
    pdb = {"metadata": {"name": "pdb", "namespace": "default"},
           "spec": {"selector": {"matchLabels": {"app": "guarded"}}},
           "status": {"disruptionsAllowed": 0}}
    return ([build_test_node("protected", 1000, int(1e9), 10),
             build_test_node("open", 1000, int(1e9), 10)],
            _prio(build_test_pod("vip", 600, 0), 50), [protected, open_pod],
            1, {"pdbs": [pdb]})


def _cascade():
    return ([build_test_node("n1", 1000, int(1e9), 10)],
            _prio(build_test_pod("vip", 250, 0), 10),
            [_prio(build_test_pod("squatter", 900, 0, node_name="n1"), -5)],
            0, {})


SCENARIOS = {"evicts_lower_priority": _evicts_lower,
             "no_preemption_among_equal_priority": _equal_priority,
             "prefers_fewest_victims": _fewest_victims,
             "policy_never": _policy_never,
             "respects_pdb_choice": _pdb_choice,
             "cascade_capacity": _cascade}


@pytest.mark.parametrize("message", [False, True])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_preemption_scenarios_match_jax(name, message):
    node_list, the_pod, pods, limit, objs = SCENARIOS[name]()
    assert_same_run(*run_pair(node_list, the_pod, pods, limit, objs,
                              message=message))


def test_preemption_message_clause_matches_jax():
    node_list = [build_test_node("n1", 1000, int(1e9), 10)]
    squatter = build_test_pod("squatter", 900, 0, node_name="n1")
    jcc, jres, tcc, tres = run_pair(node_list,
                                    build_test_pod("peer", 600, 0),
                                    [squatter], message=True)
    assert_same_run(jcc, jres, tcc, tres)
    assert "preemption: 0/1 nodes are available: " \
        "1 No preemption victims found for incoming pod." in tres.fail_message


def test_preemption_events_match_jax():
    """The FailedScheduling and Preempted events of the loop."""
    node_list, the_pod, pods, limit, objs = _cascade()
    j_events.clear()
    t_events.clear()
    run_pair(node_list, the_pod, pods, limit, objs)
    strip = lambda rec: [(e.object_name, e.reason, e.message)
                         for e in rec.events]
    assert strip(t_events) == strip(j_events)
    assert any(e.reason == "Preempted" for e in t_events.events)


def test_resolve_priority_and_pod_key_match_jax():
    pcs = [{"metadata": {"name": "high"}, "value": 1000},
           {"metadata": {"name": "low"}, "value": -10, "globalDefault": True}]
    for pod in ({"spec": {"priority": 7}},
                {"spec": {"priorityClassName": "high"}}, {"spec": {}}):
        assert tpre.resolve_priority(pod, pcs) == \
            jpre.resolve_priority(pod, pcs)
        assert tpre.resolve_priority(pod, []) == \
            jpre.resolve_priority(pod, [])
    for pod in ({}, {"metadata": {}}, {"metadata": {"namespace": "ns"}},
                {"metadata": {"name": "a"}}, {"metadata": {"uid": "u1"}}):
        assert tpre.pod_key(pod) == jpre.pod_key(pod)
    assert tpre.format_preemption_message(5, {"a": 2, "b": 3}) == \
        jpre.format_preemption_message(5, {"a": 2, "b": 3})


# --- seeded priority/PDB clusters --------------------------------------------

def priority_cluster(seed, n_nodes=8, affinity=False):
    """Nodes in three zones; existing pods of three PriorityClasses (some by
    spec.priority), some PDB-covered; a high-priority template, sometimes
    with a zone spread; with `affinity`, required inter-pod affinity terms
    on the template and on a third of the existing pods.  Returns (nodes,
    template, pods, max_limit, objs)."""
    rng = np.random.RandomState(4000 + seed)
    pcs = [{"metadata": {"name": "low"}, "value": 0},
           {"metadata": {"name": "mid"}, "value": 50},
           {"metadata": {"name": "high"}, "value": 1000}]
    node_list = [build_test_node(
        f"n{i:02d}", int(rng.choice([2000, 4000])),
        int(rng.choice([4, 8])) * 1024 ** 3, int(rng.choice([8, 16])),
        labels={"kubernetes.io/hostname": f"n{i:02d}",
                ZONE: f"z{i % 3}"}) for i in range(n_nodes)]
    pods = []
    for i in range(n_nodes):
        for k in range(int(rng.randint(4))):
            p = build_test_pod(f"e{i}-{k}", int(rng.choice([300, 700, 1200])),
                               int(rng.choice([256, 1024])) * 1024 ** 2,
                               node_name=f"n{i:02d}",
                               labels={"app": str(rng.choice(["a", "b"]))})
            if rng.rand() < 0.3:
                p["spec"]["priority"] = int(rng.choice([-5, 10]))
            else:
                p["spec"]["priorityClassName"] = str(
                    rng.choice(["low", "mid", "high"]))
            if rng.rand() < 0.3:
                p["status"] = {"startTime": f"2026-01-0{1 + k}T00:00:00Z"}
            pods.append(p)
    pdbs = [{"metadata": {"name": f"pdb-{app}", "namespace": "default"},
             "spec": {"maxUnavailable": 1,
                      "selector": {"matchLabels": {"app": app}}},
             "status": {"disruptionsAllowed": int(rng.choice([0, 1, 2]))}}
            for app in ("a", "b") if rng.rand() < 0.6]
    the_pod = build_test_pod("vip", int(rng.choice([500, 1000])),
                             512 * 1024 ** 2, labels={"app": "vip"})
    the_pod["spec"]["priorityClassName"] = str(rng.choice(["mid", "high"]))
    if rng.rand() < 0.4:
        the_pod["spec"]["topologySpreadConstraints"] = [{
            "maxSkew": int(rng.choice([1, 2])), "topologyKey": ZONE,
            "whenUnsatisfiable": "DoNotSchedule",
            "labelSelector": {"matchLabels": {"app": "vip"}}}]
    if affinity:
        # required inter-pod terms on both sides, so evictions change the
        # affinity counts, the lonely-pod escape and existing anti-affinity
        kind = seed % 3
        if kind == 0:
            the_pod["spec"]["affinity"] = {"podAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [{
                    "topologyKey": ZONE,
                    "labelSelector": {"matchLabels": {"app": "a"}}}]}}
        elif kind == 1:
            the_pod["spec"]["affinity"] = {"podAntiAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [{
                    "topologyKey": "kubernetes.io/hostname",
                    "labelSelector": {"matchLabels": {"app": "b"}}}]}}
        for p in pods[::3]:
            p["spec"]["affinity"] = {"podAntiAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [{
                    "topologyKey": "kubernetes.io/hostname",
                    "labelSelector": {"matchLabels": {"app": "vip"}}}]}}
    limit = int(rng.choice([0, 0, 12]))
    return node_list, the_pod, pods, limit, {"priority_classes": pcs,
                                             "pdbs": pdbs}


@pytest.mark.parametrize("affinity", [False, True])
@pytest.mark.parametrize("seed", range(10))
def test_priority_pdb_clusters_match_jax(seed, affinity):
    node_list, the_pod, pods, limit, objs = priority_cluster(seed,
                                                             affinity=affinity)
    jcc, jres, tcc, tres = run_pair(node_list, the_pod, pods, limit, objs,
                                    message=bool(seed % 2))
    assert_same_run(jcc, jres, tcc, tres)


@pytest.mark.parametrize("seed", range(4))
def test_with_pods_by_node_matches_full_rebuild(seed):
    """Evict a few pods and add clones on some nodes: the incremental
    re-snapshot equals from_objects over the same rosters."""
    node_list, the_pod, pods, _limit, objs = priority_cluster(seed)
    snap = TSnap.from_objects(node_list, pods, **objs)
    rng = np.random.RandomState(seed)
    new_pbn = [[p for p in plist if rng.rand() < 0.6]
               for plist in snap.pods_by_node]
    changed = {i for i, plist in enumerate(snap.pods_by_node)
               if len(new_pbn[i]) != len(plist)}
    for k, i in enumerate(rng.choice(len(node_list), size=3)):
        clone = t_default_pod(dict(the_pod, metadata=dict(
            the_pod["metadata"], name=f"vip-{k}")))
        clone["spec"]["nodeName"] = snap.node_names[int(i)]
        new_pbn[int(i)].append(clone)
        changed.add(int(i))
    inc = tsnap.with_pods_by_node(snap, new_pbn, sorted(changed))
    full = TSnap.from_objects(snap.nodes,
                              [p for plist in new_pbn for p in plist],
                              **objs)
    assert inc.node_names == full.node_names
    assert inc.resource_names == full.resource_names
    assert np.array_equal(inc.requested, full.requested)
    assert np.array_equal(inc.nonzero_requested, full.nonzero_requested)
    assert _rosters(inc) == _rosters(full)
    # a pod requesting a resource outside the vocabulary needs the rebuild
    odd = t_default_pod(build_test_pod("odd", 100, 0, node_name="n00"))
    odd["spec"]["containers"][0]["resources"]["requests"][
        "example.com/foo"] = "1"
    bumped = [list(p) for p in new_pbn]
    bumped[0].append(odd)
    assert tsnap.with_pods_by_node(snap, bumped, [0]) is None


def test_preemption_with_volumes_matches_jax():
    """A preempting template that mounts an inline disk (one clone per node)
    on a cluster with lower-priority squatters."""
    node_list = [build_test_node(f"n{i}", 1000, int(1e9), 10)
                 for i in range(3)]
    pods = [_prio(build_test_pod(f"sq{i}", 800, 0, node_name=f"n{i}"), 0)
            for i in range(3)]
    the_pod = _prio(build_test_pod("vip", 400, 0), 10)
    the_pod["spec"]["volumes"] = [{"name": "d", "gcePersistentDisk":
                                   {"pdName": "disk-1"}}]
    assert_same_run(*run_pair(node_list, the_pod, pods, message=True))


# --- the no-candidate short path against the full dry run --------------------

def _short_equal():
    nodes = [build_test_node(f"n{i}", 1000, int(1e9), 10) for i in range(3)]
    pods = [build_test_pod(f"r{i}", 300, 0, node_name=f"n{i}")
            for i in range(3)]
    return nodes, build_test_pod("peer", 200, 0), pods, {}


def _short_never():
    nodes, _pod, pods, objs = _short_equal()
    for p in pods:
        _prio(p, -1)
    the_pod = _prio(build_test_pod("gentle", 200, 0), 100)
    the_pod["spec"]["preemptionPolicy"] = "Never"
    return nodes, the_pod, pods, objs


def _short_evicts():
    nodes = [build_test_node(f"n{i}", 1000, int(1e9), 10) for i in range(2)]
    pods = [_prio(build_test_pod(f"low{i}", 600, 0, node_name=f"n{i}"), -1)
            for i in range(2)]
    return nodes, _prio(build_test_pod("vip", 400, 0), 10), pods, {}


def _short_not_helpful():
    nodes = [build_test_node(f"n{i}", 1200, int(1e9), 10) for i in range(2)]
    pods = []
    for i in range(2):
        pods.append(_prio(build_test_pod(f"big{i}", 800, 0,
                                         node_name=f"n{i}"), 10))
        pods.append(_prio(build_test_pod(f"low{i}", 100, 0,
                                         node_name=f"n{i}"), -1))
    return nodes, _prio(build_test_pod("vip", 300, 0), 10), pods, {}


def _short_global_default():
    nodes, _pod, pods, _objs = _short_evicts()
    for p in pods:
        del p["spec"]["priority"]
    pcs = [{"metadata": {"name": "low"}, "value": -10, "globalDefault": True},
           {"metadata": {"name": "high"}, "value": 100}]
    the_pod = build_test_pod("vip", 400, 0)
    the_pod["spec"]["priorityClassName"] = "high"
    return nodes, the_pod, pods, {"priority_classes": pcs}


# case: (fixture, include_preemption_message, extender, the dry run's
# (path, lower_priority_pods) in each cycle as shipped)
FULL, SHORT, FULL_LOWER = ("full", 0), ("no_candidate", 0), ("full", 1)
SHORT_PATH_CASES = {
    "equal_priority": (_short_equal, False, False, [SHORT]),
    "equal_priority_message": (_short_equal, True, False, [FULL]),
    "policy_never": (_short_never, False, False, [SHORT]),
    "lower_priority_evicted": (_short_evicts, False, False,
                               [FULL_LOWER, FULL_LOWER, SHORT]),
    "lower_priority_not_helpful": (_short_not_helpful, False, False,
                                   [FULL_LOWER]),
    "global_default_ranks_below": (_short_global_default, False, False,
                                   [FULL_LOWER, FULL_LOWER, SHORT]),
    "extender_equal_priority": (_short_equal, False, True, [FULL]),
}


def _run_recorded(fixture, message, extender):
    """ClusterCapacity.run of the port on one fixture, with what the
    short path must leave as the full dry run leaves it."""
    from cluster_capacity_tpu_torch import obs
    from cluster_capacity_tpu_torch.engine.extenders import ExtenderConfig
    node_list, the_pod, pods, objs = fixture()
    profile = TProfile()
    profile.include_preemption_message = message
    calls = []
    if extender:
        def passing(pod, names):
            calls.append(list(names))
            return {"NodeNames": list(names)}
        profile.extenders = [ExtenderConfig(filter_callable=passing)]
    cc = TCC(t_default_pod(the_pod), profile=profile, device="cpu")
    cc.sync_with_objects(node_list, list(pods), **objs)
    t_events.clear()
    obs.default_collector.reset()
    res = cc.run()
    dry = [s.attrs for s in obs.default_collector.spans()
           if s.name == "preemption.dryrun"]
    return ((res.placements, res.fail_type, res.fail_message,
             [(e.object_name, e.reason, e.message) for e in t_events.events],
             cc.preemptions, _rosters(cc.post_run_snapshot), calls), dry)


@pytest.mark.parametrize("case", sorted(SHORT_PATH_CASES))
def test_no_candidate_path_matches_full_dry_run(case, monkeypatch):
    """Each estimate as shipped and with no_candidate_possible forced
    False, so every cycle runs the full dry run: equal placements, fail
    type and message, events, preemptions, post-run rosters and extender
    calls; the dry run's span names the path each cycle took."""
    fixture, message, extender, paths = SHORT_PATH_CASES[case]
    shipped, dry = _run_recorded(fixture, message, extender)
    assert [(a["path"], a["lower_priority_pods"]) for a in dry] == paths
    monkeypatch.setattr(tpre, "no_candidate_possible",
                        lambda snapshot, pod: False)
    full, full_dry = _run_recorded(fixture, message, extender)
    assert [a["path"] for a in full_dry] == ["full"] * len(paths)
    assert shipped == full
    assert shipped[0]
    if case == "equal_priority_message":
        assert shipped[2].endswith("preemption: 0/3 nodes are available: "
                                   "3 No preemption victims found for "
                                   "incoming pod.")
    if case in ("lower_priority_evicted", "global_default_ranks_below"):
        assert len(shipped[4]) == 2
    if extender:
        assert shipped[6]


# --- the commit span and DefaultPreemption's counters ------------------------

def _run_counted(fixture):
    """ClusterCapacity.run of the port on one fixture: (the estimate, its
    preemption.commit spans, the attempts counted, the victims histogram's
    (count, sum) added by the run)."""
    from cluster_capacity_tpu_torch import obs
    from cluster_capacity_tpu_torch.utils import metrics
    node_list, the_pod, pods, objs = fixture()
    cc = TCC(t_default_pod(the_pod), profile=TProfile(), device="cpu")
    cc.sync_with_objects(node_list, list(pods), **objs)
    reg = metrics.default_registry

    def seen():
        h = reg.histograms.get((metrics.PREEMPTION_VICTIMS, ()))
        return (reg.get(metrics.PREEMPTION_ATTEMPTS),
                (h.count, h.total) if h else (0, 0.0))
    (a0, (n0, s0)) = seen()
    obs.default_collector.reset()
    cc.run()
    commits = [s for s in obs.default_collector.spans()
               if s.name == "preemption.commit"]
    (a1, (n1, s1)) = seen()
    return cc, commits, a1 - a0, (n1 - n0, s1 - s0)


def test_commit_span_and_counters_per_preemption():
    """Each preemption commits in one preemption.commit span, inside the
    cycle's commit time, with its victims, the nodes whose rosters changed
    and whether the re-snapshot was rebuilt; every full dry run counts one
    attempt, every preemption's victims one observation."""
    cc, commits, attempts, (n, total) = _run_counted(_short_evicts)
    assert len(cc.preemptions) == len(commits) == 2
    # each commit evicts one low pod and commits the cycle's clones: cycle
    # 1's on both nodes, cycle 2's on the node the first eviction freed
    assert [s.attrs for s in commits] == [
        {"victims": 1, "nodes_changed": 2, "rebuild": 0}] * 2
    timed = [c["commit"] for c in cc.cycle_seconds if c["commit"]]
    assert all(s.duration_s <= t for s, t in zip(commits, timed))
    assert attempts == 2                    # the third cycle's is unbuilt
    assert (n, total) == (2, 2.0)


def test_commit_span_names_a_rebuild(monkeypatch):
    """Where the incremental re-snapshot declines, the commit rebuilds the
    snapshot from the objects and says so."""
    monkeypatch.setattr(tsnap, "with_pods_by_node", lambda *a, **k: None)
    cc, commits, _attempts, _victims = _run_counted(_short_evicts)
    assert len(commits) == 2
    assert [s.attrs["rebuild"] for s in commits] == [1, 1]


def test_victims_histogram_takes_upstream_buckets():
    from cluster_capacity_tpu_torch.utils import metrics
    reg = metrics.Registry()
    for v in (3, 3, 70):
        reg.observe(metrics.PREEMPTION_VICTIMS, v,
                    buckets=metrics.PREEMPTION_VICTIM_BUCKETS)
    text = reg.render()
    assert 'scheduler_preemption_victims_bucket{le="2"} 0' in text
    assert 'scheduler_preemption_victims_bucket{le="4"} 2' in text
    assert 'scheduler_preemption_victims_bucket{le="64"} 2' in text
    assert 'scheduler_preemption_victims_bucket{le="+Inf"} 3' in text
    assert "scheduler_preemption_victims_sum 76" in text


@pytest.mark.parametrize("fixture", [_short_equal, _short_never])
def test_no_candidate_path_counts_nothing(fixture):
    """The dry run known unbuilt opens no commit span and moves neither
    counter."""
    cc, commits, attempts, victims = _run_counted(fixture)
    assert not cc.preemptions and not commits
    assert attempts == 0 and victims == (0, 0.0)

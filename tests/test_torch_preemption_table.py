"""The preemption dry run's victim table (engine/preemption_table.py)
against the oracle's filter chain (engine/preemption._filter_candidates),
on the CPU: each dry run's PreemptionOutcome (node, victims and their
order, message counts) on seeded priority clusters, a PreemptionBasic-
shaped answer preemption by preemption, hand-built nodes for every status
and tie; the table's upkeep across commits against a fresh build; and the
features that keep the oracle's path.  Tolerance: exact.  The test marked
`cuda` runs the table on the card:
`python -m pytest --noconftest -m cuda tests/test_torch_preemption_table.py`.
"""

import pytest
import torch

from cluster_capacity_tpu_torch import ClusterCapacity as TCC
from cluster_capacity_tpu_torch import obs
from cluster_capacity_tpu_torch.engine import preemption as tpre
from cluster_capacity_tpu_torch.engine import preemption_table as ptab
from cluster_capacity_tpu_torch.engine.extenders import ExtenderConfig
from cluster_capacity_tpu_torch.models.podspec import default_pod, make_clone
from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot as TSnap
from cluster_capacity_tpu_torch.utils.config import SchedulerProfile

from helpers import build_test_node, build_test_pod

GI = 1024 ** 3
MI = 1024 ** 2


def _prio(pod, value):
    pod["spec"]["priority"] = value
    return pod


def _filter_attrs():
    return [s.attrs for s in obs.default_collector.spans()
            if s.name == "preemption.filter"]


def _evaluate(snap, state_pods, pod, profile=None, table=None, **kw):
    """(outcome, the filter span's attrs) of one dry run."""
    obs.default_collector.reset()
    out = tpre.evaluate(snap, state_pods, pod, profile or SchedulerProfile(),
                        table=table, **kw)
    (attrs,) = _filter_attrs()
    return out, attrs


def _same(a, b):
    assert a.node_index == b.node_index
    assert [id(v) for v in a.victims] == [id(v) for v in b.victims]
    assert a.message_counts == b.message_counts


def _both(snap, state_pods, pod, profile=None, device="cpu"):
    """The dry run by the oracle and by a fresh table: equal outcomes;
    returns (outcome, the table run's filter attrs)."""
    profile = profile or SchedulerProfile()
    want, oracle_attrs = _evaluate(snap, state_pods, pod, profile)
    assert oracle_attrs["engine"] == "oracle"
    assert oracle_attrs["fallback"] == "no_table"
    table = ptab.VictimTable(pod, profile, device)
    got, attrs = _evaluate(snap, state_pods, pod, profile, table=table)
    _same(got, want)
    for key in ("nodes", "no_victims", "candidates"):
        assert attrs[key] == oracle_attrs[key]
    return got, attrs


def _rosters(snap):
    return [list(p) for p in snap.pods_by_node]


# --- seeded priority clusters ------------------------------------------------

@pytest.mark.parametrize("seed", range(10))
def test_priority_clusters_match_oracle(seed):
    """priority_cluster without PDBs or inter-pod terms: the table where no
    spread constraint sends the dry run to the oracle, the same outcome
    either way; then the whole answer with the table and without.  (The
    generator's module imports the JAX package, which the card's tests in
    this file do without.)"""
    from test_torch_preemption import priority_cluster
    node_list, the_pod, pods, limit, objs = priority_cluster(seed)
    objs = dict(objs, pdbs=[])
    pod = default_pod(the_pod)
    snap = TSnap.from_objects(node_list, pods, **objs)
    got, attrs = _both(snap, _rosters(snap), pod)
    spread = bool(the_pod["spec"].get("topologySpreadConstraints"))
    if spread:
        assert attrs["engine"] == "oracle"
        assert attrs["fallback"] == "spread_constraints"
    else:
        assert attrs["engine"] == "table"
        assert attrs["rows_rebuilt"] == len(node_list)
    answer = _answer(node_list, pod, pods, limit, objs, table=True)
    assert answer[:5] == \
        _answer(node_list, pod, pods, limit, objs, table=False)[:5]
    assert set(answer[5]) <= {"oracle" if spread else "table"}


def _answer(node_list, pod, pods, limit, objs=None, table=True):
    """ClusterCapacity.run with the table, or with every dry run on the
    oracle's path: (placements, fail type and message, each dry run's
    outcome, the preemptions made, the engines the filter spans name)."""
    outcomes = []
    real = tpre.evaluate
    real_reason = ptab.fallback_reason

    def recording(*a, **kw):
        out = real(*a, **kw)
        outcomes.append((out.node_index,
                         [v["metadata"]["name"] for v in out.victims],
                         out.message_counts))
        return out
    tpre.evaluate = recording
    if not table:
        ptab.fallback_reason = lambda *a, **kw: "off"
    try:
        profile = SchedulerProfile()
        profile.include_preemption_message = True
        cc = TCC(pod, max_limit=limit, profile=profile, device="cpu")
        cc.sync_with_objects(node_list, list(pods), **dict(objs or {}))
        obs.default_collector.reset()
        res = cc.run()
    finally:
        tpre.evaluate = real
        ptab.fallback_reason = real_reason
    engines = [a["engine"] for a in _filter_attrs()]
    return (res.placements, res.fail_type, res.fail_message, outcomes,
            cc.preemptions, engines if table else None)


# --- PreemptionBasic, one whole answer ---------------------------------------

def _preemption_basic(n=8):
    nodes = [build_test_node(f"n{i}", 4000, 32 * GI, 110) for i in range(n)]
    pods = [_prio(build_test_pod(f"low-{i}-{k}", 900, 500 * MI,
                                 node_name=f"n{i}"), 0)
            for i in range(n) for k in range(4)]
    return nodes, pods, _prio(build_test_pod("high", 3000, 500 * MI), 10)


def test_preemption_basic_answer_preemption_by_preemption():
    """Eight nodes of four 900m priority-0 pods, a 3000m pod of priority
    10, max_limit 8: each placement bought by one preemption of three
    victims, every dry run on the table, each outcome equal to the
    oracle's run."""
    nodes, pods, high = _preemption_basic()
    pod = default_pod(high)
    with_table = _answer(nodes, pod, pods, 8, table=True)
    without = _answer(nodes, pod, pods, 8, table=False)
    assert with_table[:5] == without[:5]
    placements, fail_type, _msg, outcomes, preemptions, engines = with_table
    assert fail_type == "LimitReached" and len(placements) == 8
    assert len(preemptions) == 8 and engines == ["table"] * 8
    assert all(len(p["victims"]) == 3 for p in preemptions)
    assert [p["node"] for p in preemptions] == [f"n{i}" for i in range(8)]
    # reprieve order: the pod list's order among equals, the last reprieved
    assert preemptions[0]["victims"] == ["low-0-1", "low-0-2", "low-0-3"]


# --- hand-built nodes, one per status ----------------------------------------

def _status_cluster():
    """One node per dry-run status, with lower-priority pods wherever the
    status is not about them."""
    nodes = [
        build_test_node("fits", 4000, 8 * GI, 10),
        build_test_node("peers-only", 1000, 8 * GI, 10),
        build_test_node("not-helpful", 1000, 8 * GI, 10),
        build_test_node("tainted", 1000, 8 * GI, 10, taints=[
            {"key": "dedicated", "value": "x", "effect": "NoSchedule"}]),
        build_test_node("cordoned", 1000, 8 * GI, 10, unschedulable=True),
        build_test_node("too-many-pods", 4000, 8 * GI, 2),
        build_test_node("victims", 1000, 8 * GI, 10),
    ]
    pods = [
        _prio(build_test_pod("peer", 800, 0, node_name="peers-only"), 10),
        _prio(build_test_pod("big", 700, 0, node_name="not-helpful"), 10),
        _prio(build_test_pod("small", 200, 0, node_name="not-helpful"), 0),
        _prio(build_test_pod("t-low", 900, 0, node_name="tainted"), 0),
        _prio(build_test_pod("c-low", 900, 0, node_name="cordoned"), 0),
        _prio(build_test_pod("pm-low", 100, 0, node_name="too-many-pods"), 0),
        _prio(build_test_pod("pm-peer", 100, 0, node_name="too-many-pods"),
              10),
        _prio(build_test_pod("v-a", 300, 0, node_name="victims"), 0),
        _prio(build_test_pod("v-b", 600, 0, node_name="victims"), 0),
    ]
    return nodes, pods


@pytest.mark.parametrize("case", ["fits", "no_fit_anywhere", "node_name",
                                  "missing_resource"])
def test_every_status_matches_oracle(case):
    """Nodes that fit already, hold no lower-priority pod, do not fit even
    with every lower pod removed, carry an untolerated taint, are
    cordoned, run out of pods, or yield victims; a pod pinned to one node
    by nodeName; a pod asking for a resource no node has."""
    nodes, pods = _status_cluster()
    if case == "no_fit_anywhere":
        nodes = nodes[1:]
    pod = _prio(build_test_pod("vip", 500, 0), 5)
    if case == "node_name":
        pod["spec"]["nodeName"] = "victims"
    if case == "missing_resource":
        pod["spec"]["containers"][0]["resources"]["requests"][
            "example.com/gpu"] = "1"
    pod = default_pod(pod)
    snap = TSnap.from_objects(nodes, pods)
    got, attrs = _both(snap, _rosters(snap), pod)
    assert attrs["engine"] == "table"
    counts = got.message_counts
    if case == "fits":
        assert counts == {tpre.MSG_NOT_HELPFUL: 3, tpre.MSG_NO_VICTIMS: 1}
    elif case == "no_fit_anywhere":
        assert counts == {tpre.MSG_NOT_HELPFUL: 3, tpre.MSG_NO_VICTIMS: 1}
        assert snap.node_names[got.node_index] == "too-many-pods"
        assert [v["metadata"]["name"] for v in got.victims] == ["pm-low"]
    elif case == "node_name":
        assert counts == {tpre.MSG_NOT_HELPFUL: 6}
        assert [v["metadata"]["name"] for v in got.victims] == ["v-b"]
    else:
        assert counts == {tpre.MSG_NOT_HELPFUL: 5,
                          tpre.MSG_NO_VICTIMS: 2} and not got.succeeded


def test_too_many_pods_alone_matches_oracle():
    """A node whose only shortage is its pod count: one lower pod goes,
    the higher-priority one stays."""
    nodes = [build_test_node("n0", 8000, 8 * GI, 2)]
    pods = [_prio(build_test_pod("keep", 100, 0, node_name="n0"), 20),
            _prio(build_test_pod("go", 100, 0, node_name="n0"), 0)]
    pod = default_pod(_prio(build_test_pod("vip", 100, 0), 5))
    snap = TSnap.from_objects(nodes, pods)
    got, _attrs = _both(snap, _rosters(snap), pod)
    assert [v["metadata"]["name"] for v in got.victims] == ["go"]


# --- ties in the reprieve order ----------------------------------------------

def test_ties_by_start_time_and_roster_order():
    """Lower pods of one priority: the earlier startTime is reprieved
    first, a pod without one counts as starting now; equals keep the
    roster's order.  Room for the pod and two of the 200m pods back."""
    nodes = [build_test_node("n0", 1200, 8 * GI, 10),
             build_test_node("n1", 1200, 8 * GI, 10)]
    pods = []
    for node in ("n0", "n1"):
        for name, start in (("late", "2026-01-03T00:00:00Z"),
                            ("never", None), ("early", "2026-01-01T00:00:00Z"),
                            ("tie-a", "2026-01-02T00:00:00Z"),
                            ("tie-b", "2026-01-02T00:00:00Z")):
            p = _prio(build_test_pod(f"{node}-{name}", 200, 0,
                                     node_name=node), 0)
            if start:
                p["status"] = {"startTime": start}
            pods.append(p)
    pods.append(_prio(build_test_pod("n1-mid", 200, 0, node_name="n1"), 3))
    pod = default_pod(_prio(build_test_pod("vip", 700, 0), 5))
    snap = TSnap.from_objects(nodes, pods)
    got, attrs = _both(snap, _rosters(snap), pod)
    assert attrs["engine"] == "table"
    assert got.node_index == 0
    assert [v["metadata"]["name"] for v in got.victims] == [
        "n0-tie-b", "n0-late", "n0-never"]
    # n1: its priority-3 pod is reprieved first, so one victim more
    table = ptab.VictimTable(pod, SchedulerProfile(), "cpu")
    table.refresh(snap, _rosters(snap))
    candidates, _counts = table.dry_run()
    assert [[v["metadata"]["name"] for v in c[1]] for c in candidates] == [
        ["n0-tie-b", "n0-late", "n0-never"],
        ["n1-tie-a", "n1-tie-b", "n1-late", "n1-never"]]


# --- clones placed in the cycle ----------------------------------------------

def test_two_clones_before_the_dry_run():
    """The first cycle places two clones, then ends Unschedulable: its dry
    run counts them on their nodes as pods of the preemptor's priority."""
    nodes = [build_test_node(f"n{i}", cpu, 8 * GI, 10)
             for i, cpu in enumerate((2000, 1600, 2000))]
    pods = [_prio(build_test_pod("low-0", 1500, 0, node_name="n0"), 0),
            _prio(build_test_pod("low-2", 900, 0, node_name="n2"), 0),
            _prio(build_test_pod("low-2b", 600, 0, node_name="n2"), 0)]
    high = default_pod(_prio(build_test_pod("high", 800, 0), 10))
    snap = TSnap.from_objects(nodes, pods)
    state = _rosters(snap)
    for k, i in enumerate((1, 1)):
        clone = make_clone(high, k)
        clone["spec"]["nodeName"] = snap.node_names[i]
        state[i].append(clone)
    got, attrs = _both(snap, state, high)
    assert attrs["engine"] == "table"
    assert got.message_counts == {tpre.MSG_NO_VICTIMS: 1}
    assert got.node_index == 0
    assert [v["metadata"]["name"] for v in got.victims] == ["low-0"]
    answer = _answer(nodes, high, pods, 0, table=True)
    assert answer[:5] == _answer(nodes, high, pods, 0, table=False)[:5]
    assert answer[0][:2] == [1, 1] and set(answer[5]) == {"table"}


# --- upkeep ------------------------------------------------------------------

def _table_state(table):
    return (table.alloc.tolist(), table.base.tolist(), table.want.tolist(),
            table.static_ok.tolist(), table.unresolvable.tolist(),
            [[id(p) for p in row] for row in table.lower],
            [row[:len(table.lower[i])] for i, row
             in enumerate(table.low.tolist())],
            [row[:len(table.lower[i])] for i, row
             in enumerate(table.valid.tolist())],
            [sum(row) for row in table.valid.tolist()])


def _ids(candidates):
    return [(i, [id(v) for v in victims], n) for i, victims, n in candidates]


def test_kept_table_equals_fresh_build(monkeypatch):
    """At every dry run of a PreemptionBasic answer, the table kept current
    by marks equals one built fresh from that dry run's rosters, and so do
    the candidates it yields; after the first, only the marked rows are
    rebuilt."""
    nodes, pods, high = _preemption_basic()
    seen = []
    real_refresh = ptab.VictimTable.refresh
    real_dry_run = ptab.VictimTable.dry_run

    def checked_refresh(self, snapshot, state_pods):
        rows = real_refresh(self, snapshot, state_pods)
        fresh = ptab.VictimTable(self.pod, self.profile, "cpu")
        real_refresh(fresh, snapshot, state_pods)
        assert _table_state(self) == _table_state(fresh)
        seen.append((rows, fresh))
        return rows

    def checked_dry_run(self):
        candidates, counts = real_dry_run(self)
        fresh_candidates, fresh_counts = real_dry_run(seen[-1][1])
        assert _ids(candidates) == _ids(fresh_candidates)
        assert counts == fresh_counts
        return candidates, counts
    monkeypatch.setattr(ptab.VictimTable, "refresh", checked_refresh)
    monkeypatch.setattr(ptab.VictimTable, "dry_run", checked_dry_run)
    cc = TCC(default_pod(high), max_limit=8, device="cpu")
    cc.sync_with_objects(nodes, pods)
    cc.run()
    assert len(cc.preemptions) == 8
    # the first dry run builds every row; the second the node evicted
    # before it, which holds the cycle's clone; each later one also the
    # node whose clone the last commit took
    assert [rows for rows, _ in seen] == [8, 1] + [2] * 6


def test_each_run_builds_its_own_table():
    """Two ClusterCapacity objects, and one of them run twice: each run's
    first dry run rebuilds every row."""
    nodes, pods, high = _preemption_basic(n=4)
    first = []
    for cc in (TCC(default_pod(high), max_limit=3, device="cpu"),
               TCC(default_pod(high), max_limit=3, device="cpu")):
        cc.sync_with_objects(nodes, pods)
        for _ in range(2):
            obs.default_collector.reset()
            cc.run()
            rows = [a["rows_rebuilt"] for a in _filter_attrs()]
            first.append(rows[0])
            assert rows[1:] == [1, 2]
    assert first == [4] * 4


# --- the oracle's path -------------------------------------------------------

def _fallback_case(feature):
    """(snapshot, pod, profile, evaluate kwargs) with one feature that
    keeps the dry run on the oracle's filter chain."""
    nodes = [build_test_node(f"n{i}", 1000, 8 * GI, 10,
                             labels={"kubernetes.io/hostname": f"n{i}",
                                     "zone": f"z{i}"}) for i in range(2)]
    pods = [_prio(build_test_pod(f"low{i}", 800, 0, node_name=f"n{i}",
                                 labels={"app": "low"}), 0)
            for i in range(2)]
    pod = _prio(build_test_pod("vip", 500, 0, labels={"app": "vip"}), 10)
    profile = SchedulerProfile()
    objs, kw = {}, {}
    if feature == "extenders":
        kw["node_ok"] = lambda name: True
    elif feature == "pdbs":
        objs["pdbs"] = [{"metadata": {"name": "pdb", "namespace": "default"},
                         "spec": {"selector": {"matchLabels": {"app": "x"}}},
                         "status": {"disruptionsAllowed": 1}}]
    elif feature == "host_ports":
        pod["spec"]["containers"][0]["ports"] = [{"hostPort": 8080}]
    elif feature == "spread_constraints":
        pod["spec"]["topologySpreadConstraints"] = [{
            "maxSkew": 1, "topologyKey": "zone",
            "whenUnsatisfiable": "DoNotSchedule",
            "labelSelector": {"matchLabels": {"app": "vip"}}}]
    elif feature in ("pod_affinity", "pod_anti_affinity"):
        kind = "podAffinity" if feature == "pod_affinity" \
            else "podAntiAffinity"
        pod["spec"]["affinity"] = {kind: {
            "requiredDuringSchedulingIgnoredDuringExecution": [{
                "topologyKey": "zone",
                "labelSelector": {"matchLabels": {"app": "low"}}}]}}
    elif feature == "resident_anti_affinity":
        pods[1]["spec"]["affinity"] = {"podAntiAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": [{
                "topologyKey": "kubernetes.io/hostname",
                "labelSelector": {"matchLabels": {"app": "other"}}}]}}
    elif feature == "fit_disabled":
        profile.filters = [f for f in profile.filters
                           if f != "NodeResourcesFit"]
    snap = TSnap.from_objects(nodes, pods, **objs)
    return snap, default_pod(pod), profile, kw


FALLBACKS = {"extenders": "extenders", "pdbs": "pdbs",
             "host_ports": "host_ports",
             "spread_constraints": "spread_constraints",
             "pod_affinity": "pod_affinity",
             "pod_anti_affinity": "pod_affinity",
             "resident_anti_affinity": "resident_anti_affinity",
             "fit_disabled": "fit_disabled"}


@pytest.mark.parametrize("feature", sorted(FALLBACKS))
def test_fallback_features_take_the_oracle(feature):
    snap, pod, profile, kw = _fallback_case(feature)
    want, _ = _evaluate(snap, _rosters(snap), pod, profile, **kw)
    table = ptab.VictimTable(pod, profile, "cpu")
    got, attrs = _evaluate(snap, _rosters(snap), pod, profile, table=table,
                           **kw)
    _same(got, want)
    assert attrs["engine"] == "oracle"
    assert attrs["fallback"] == FALLBACKS[feature]
    assert attrs["rows_rebuilt"] == snap.num_nodes


def test_extender_answer_keeps_the_oracle():
    """A profile with an extender: every dry run of the answer names the
    extenders as its reason."""
    nodes, pods, high = _preemption_basic(n=3)
    profile = SchedulerProfile()
    profile.extenders = [ExtenderConfig(
        filter_callable=lambda pod, names: {"NodeNames": list(names)})]
    cc = TCC(default_pod(high), max_limit=2, profile=profile, device="cpu")
    cc.sync_with_objects(nodes, pods)
    obs.default_collector.reset()
    cc.run()
    attrs = _filter_attrs()
    assert len(cc.preemptions) == 2 and attrs
    assert {(a["engine"], a["fallback"]) for a in attrs} == {
        ("oracle", "extenders")}


@pytest.mark.cuda
def test_table_on_card_matches_oracle():
    """The table's tensors on the card: the same outcomes as the oracle on
    a PreemptionBasic-shaped cluster and on the status cluster."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    nodes, pods, high = _preemption_basic(n=64)
    snap = TSnap.from_objects(nodes, pods)
    _both(snap, _rosters(snap), default_pod(high), device="cuda")
    nodes, pods = _status_cluster()
    snap = TSnap.from_objects(nodes, pods)
    _both(snap, _rosters(snap),
          default_pod(_prio(build_test_pod("vip", 500, 0), 5)),
          device="cuda")

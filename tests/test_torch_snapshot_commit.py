"""The roster commit (models/snapshot.replace_rosters) on the CPU.

Every caller that swaps in new per-node pod lists re-snapshots through
replace_rosters: the incremental re-snapshot where it serves, else a full
build over the snapshot's own nodes.  Either way the node axis stays as it
was, whatever order it had: name-sorted, zone round-robin, as given, or as
a checkpoint stored it.  The expected snapshot is from_objects over the
same objects in that axis (sort_nodes=False).  Tolerance: exact.
"""

import numpy as np
import pytest

from cluster_capacity_tpu_torch import ClusterCapacity as TCC
from cluster_capacity_tpu_torch.models import snapshot as tsnap
from cluster_capacity_tpu_torch.models.podspec import default_pod
from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot as TSnap
from cluster_capacity_tpu_torch.parallel import interleave as til
from cluster_capacity_tpu_torch.parallel import sweep as tsweep
from cluster_capacity_tpu_torch.serve.ingest import SnapshotStore
from cluster_capacity_tpu_torch.utils import checkpoint
from cluster_capacity_tpu_torch.utils.config import SchedulerProfile

from helpers import build_test_node, build_test_pod

ZONE = "topology.kubernetes.io/zone"


def _prio(pod, value):
    pod["spec"]["priority"] = value
    return pod


def _cluster():
    """Six nodes of unequal CPU in three zones, listed out of name order,
    each holding one priority -1 pod of 600m."""
    nodes, pods = [], []
    for k in (3, 0, 5, 1, 4, 2):
        nodes.append(build_test_node(f"n{k}", 1000 + 200 * k, int(8e9), 10,
                                     labels={ZONE: f"z{k // 2}"}))
        pods.append(_prio(build_test_pod(f"low-{k}", 600, 0,
                                         node_name=f"n{k}"), -1))
    return nodes, pods


def _axis(kind, tmp_path):
    nodes, pods = _cluster()
    if kind == "sorted":
        return TSnap.from_objects(nodes, pods)
    if kind == "zone_round_robin":
        return TSnap.from_objects(nodes, pods, node_order="zone-round-robin")
    if kind == "as_given":
        return TSnap.from_objects(nodes, pods, sort_nodes=False)
    path = str(tmp_path / "zrr.npz")
    checkpoint.save(path, TSnap.from_objects(nodes, pods,
                                             node_order="zone-round-robin"))
    return checkpoint.load(path)


AXES = {"sorted": ["n0", "n1", "n2", "n3", "n4", "n5"],
        "zone_round_robin": ["n0", "n2", "n4", "n1", "n3", "n5"],
        "as_given": ["n3", "n0", "n5", "n1", "n4", "n2"],
        "checkpoint": ["n0", "n2", "n4", "n1", "n3", "n5"]}


def _commit(snap):
    """Evict the resident of axis row 1 and place a 400m clone on rows 1
    and 4: (new rosters, changed rows)."""
    pbn = [list(p) for p in snap.pods_by_node]
    pbn[1] = []
    for i in (1, 4):
        clone = default_pod(_prio(build_test_pod(f"vip-{i}", 400, 0), 10))
        clone["spec"]["nodeName"] = snap.node_names[i]
        pbn[i].append(clone)
    return pbn, [1, 4]


def _assert_same_snapshot(got, want):
    assert got.node_names == want.node_names
    assert got.resource_names == want.resource_names
    for arr in ("allocatable", "requested", "nonzero_requested"):
        assert np.array_equal(getattr(got, arr), getattr(want, arr)), arr
    assert [[p["metadata"]["name"] for p in plist]
            for plist in got.pods_by_node] == \
        [[p["metadata"]["name"] for p in plist]
         for plist in want.pods_by_node]


def _in_axis(snap, pbn):
    """from_objects over `snap`'s nodes in its axis order and `pbn`."""
    return TSnap.from_objects(
        snap.nodes, [p for plist in pbn for p in plist], sort_nodes=False,
        **{k: getattr(snap, k) for k in tsnap.OBJECT_FIELDS})


@pytest.mark.parametrize("path", ["incremental", "rebuild"])
@pytest.mark.parametrize("axis", ["sorted", "zone_round_robin", "as_given",
                                  "checkpoint"])
def test_replace_rosters_keeps_the_axis(axis, path, tmp_path, monkeypatch):
    snap = _axis(axis, tmp_path)
    order = list(snap.node_names)
    assert order == AXES[axis]
    pbn, changed = _commit(snap)
    if path == "rebuild":
        monkeypatch.setattr(tsnap, "with_pods_by_node", lambda *a: None)
    new, rebuilt = tsnap.replace_rosters(snap, pbn, changed)
    assert rebuilt == (path == "rebuild")
    assert new.node_names == order
    _assert_same_snapshot(new, _in_axis(snap, pbn))


def _with_claims(snap, pbn):
    claim = {"metadata": {"name": "c", "namespace": "default"}, "spec": {}}
    return TSnap.from_objects(
        snap.nodes, [p for plist in snap.pods_by_node for p in plist],
        sort_nodes=False, resource_claims=[claim]), pbn


def _outside_vocabulary(snap, pbn):
    odd = default_pod(build_test_pod("odd", 100, 0))
    odd["spec"]["containers"][0]["resources"]["requests"][
        "example.com/foo"] = "1"
    odd["spec"]["nodeName"] = snap.node_names[4]
    pbn = [list(p) for p in pbn]
    pbn[4].append(odd)
    return snap, pbn


@pytest.mark.parametrize("decline", [_with_claims, _outside_vocabulary],
                         ids=["resource_claims", "outside_vocabulary"])
def test_replace_rosters_rebuilds_where_incremental_declines(decline,
                                                             tmp_path):
    """The incremental re-snapshot declines by itself: the full build keeps
    the zone round-robin axis."""
    zrr = _axis("zone_round_robin", tmp_path)
    snap, pbn = decline(zrr, _commit(zrr)[0])
    assert tsnap.with_pods_by_node(snap, pbn, [1, 4]) is None
    new, rebuilt = tsnap.replace_rosters(snap, pbn, [1, 4])
    assert rebuilt
    assert new.node_names == zrr.node_names
    _assert_same_snapshot(new, _in_axis(snap, pbn))
    if decline is _outside_vocabulary:
        assert "example.com/foo" in new.resource_names


# --- every roster commit goes through replace_rosters ------------------------

def _preemptor_study():
    """Two 2,000m nodes; a 1,500m priority-0 squatter on n0; a priority-0
    200m template and a priority-500 1,500m template that must preempt."""
    nodes = [build_test_node(f"n{i}", 2000, int(8e9), 2) for i in range(2)]
    squatter = _prio(build_test_pod("squat", 1500, 0, node_name="n0"), 0)
    hi = _prio(build_test_pod("hi", 1500, 0), 500)
    hi["spec"]["priorityClassName"] = "high"
    templates = [default_pod(build_test_pod("d", 200, 0)), default_pod(hi)]
    snap = TSnap.from_objects(nodes, [squatter], priority_classes=[
        {"metadata": {"name": "high"}, "value": 500}])
    return snap, templates


def _fields(results):
    assert results is not None, "the engine fell back"
    return [(r.placements, r.placed_count, r.fail_type, r.fail_message,
             r.fail_counts, r.rung, r.degraded) for r in results]


def _run_facade():
    nodes = [build_test_node(f"n{i}", 1000, int(1e9), 10) for i in range(2)]
    pods = [_prio(build_test_pod(f"low{i}", 600, 0, node_name=f"n{i}"), -1)
            for i in range(2)]
    cc = TCC(default_pod(_prio(build_test_pod("vip", 400, 0), 10)),
             profile=SchedulerProfile(), device="cpu")
    cc.sync_with_objects(nodes, pods)
    res = cc.run()
    return (res.placements, res.fail_type, res.fail_message, cc.preemptions)


def _run_object_loop():
    snap, templates = _preemptor_study()
    return _fields(tsweep.sweep_interleaved(snap, templates,
                                            SchedulerProfile.parity()))


def _run_tensor_engine():
    snap, templates = _preemptor_study()
    return _fields(til.solve_interleaved_tensor(
        snap, templates, SchedulerProfile.parity(), device="cpu"))


def _run_ingest():
    nodes, pods = _cluster()
    store = SnapshotStore(
        TSnap.from_objects(nodes, pods, node_order="zone-round-robin"),
        SchedulerProfile())
    assert store.apply({"op": "add_pod", "pod": default_pod(
        build_test_pod("new", 300, 0, node_name="n4"))})
    s = store.snapshot
    return (s.node_names, s.requested.tolist(), s.nonzero_requested.tolist(),
            store.full_rebuilds)


CALLERS = {"framework": _run_facade,
           "sweep_interleaved": _run_object_loop,
           "interleave_tensor": _run_tensor_engine,
           "serve_ingest": _run_ingest}


@pytest.mark.parametrize("caller", sorted(CALLERS))
def test_roster_commits_go_through_replace_rosters(caller, monkeypatch):
    plain = CALLERS[caller]()
    calls = []
    real = tsnap.replace_rosters

    def spy(*args):
        out = real(*args)
        calls.append(out[1])
        return out
    monkeypatch.setattr(tsnap, "replace_rosters", spy)
    assert CALLERS[caller]() == plain
    assert calls and not any(calls)


# --- a full rebuild in the middle of an answer keeps the axis ----------------

def _zone_answer(monkeypatch, rebuild):
    """ClusterCapacity.run on a zone round-robin snapshot installed with
    set_snapshot, where two preemptions commit: (placements by node name,
    preemptions, fail type and message, post-run rosters by node)."""
    nodes = [build_test_node(f"n{i}", 1000 + 200 * i, int(1e9), 10,
                             labels={ZONE: f"z{(i + 1) % 2}"})
             for i in range(4)]
    pods = [_prio(build_test_pod(f"low{i}", 600, 0, node_name=f"n{i}"), -1)
            for i in range(4)]
    snap = TSnap.from_objects(nodes, pods, node_order="zone-round-robin")
    assert snap.node_names == ["n1", "n0", "n3", "n2"]
    if rebuild:
        monkeypatch.setattr(tsnap, "with_pods_by_node", lambda *a: None)
    cc = TCC(default_pod(_prio(build_test_pod("vip", 400, 0), 10)),
             profile=SchedulerProfile(), device="cpu")
    cc.set_snapshot(snap)
    res = cc.run()
    after = cc.post_run_snapshot
    return ([res.node_names[i] for i in res.placements],
            cc.preemptions, res.fail_type, res.fail_message,
            {nm: sorted(p["metadata"]["name"] for p in plist)
             for nm, plist in zip(after.node_names, after.pods_by_node)})


def test_full_rebuild_keeps_an_installed_zone_round_robin_axis(monkeypatch):
    incremental = _zone_answer(monkeypatch, rebuild=False)
    assert incremental[1], "no preemption committed"
    assert _zone_answer(monkeypatch, rebuild=True) == incremental

"""The preempt cell on the CPU at its tiny cut: the port through
entries/preempt.py against reference/preempt.py, the reference on clusters
built by hand so that each of pickOneNodeForPreemption's criteria decides
once, the faults the comparison must catch, and the configuration's
objects pinned byte for byte."""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import io
import json
import time
from types import SimpleNamespace

import pytest
import torch

import portbench_tiny as pt
from portbench import check, harness, run
from portbench.reference import cluster as gen
from portbench.reference import preempt

CELL = "k8s-5000n-preempt.preempt"
SEEDS = (2 ** 31 + 41, 2 ** 40 + 3)
CPU = torch.device("cpu")
F32 = (torch.float32,)
CONTROL = (torch.float32, torch.bfloat16)

# sha256 of json.dumps(make_objects(config, mix, seed), sort_keys=True)
PINNED = [
    (1, "7b6025510aab4f3f77d79b015b94c79919790225d31719ebe2f96eba8a9320e8"),
    (2 ** 31 + 77,
     "186a1d6c32fa3cd59476a598ed262295c98a99741c8a03bb8881f16212023f9d"),
]


@pytest.mark.parametrize("seed,digest", PINNED,
                         ids=[str(s) for s, _ in PINNED])
def test_objects_are_pinned(seed, digest):
    data = gen.make_objects(harness.load_json("configs", "k8s-5000n-preempt"),
                            harness.load_json("traffic", "preempt"), seed)
    assert len(data["nodes"]) == 5000 and len(data["pods"]) == 20000
    text = json.dumps(data, sort_keys=True)
    assert hashlib.sha256(text.encode()).hexdigest() == digest


def _tiny(tmp_path):
    cell, dirs = pt.tiny_cell(tmp_path, CELL)
    entry = harness.load_module("entries", cell.traffic["entry"])
    return cell, dirs, entry


def _victims(pre):
    return [(p["node"], sorted(p["victims"])) for p in pre]


@pytest.mark.parametrize("limit", [None, 0])
@pytest.mark.parametrize("seed", SEEDS)
def test_port_equals_reference(tmp_path, seed, limit):
    """Every preemption's node and victims, every placement, and the
    report, at the tiny cut's limit and with no limit (to the end, where no
    node is a candidate any more)."""
    cell, _dirs, entry = _tiny(tmp_path)
    if limit is None:
        limit = cell.traffic["max_limit"]
    cell.traffic["max_limit"] = limit
    data = gen.make_objects(cell.config, cell.traffic, seed)
    ans = entry.answer(cell, data, limit, CPU)
    r = ans.results[0]
    placed, made, ftype = preempt.run(data["nodes"], data["pods"],
                                      data["templates"][0], limit, CPU)
    assert [r.node_names[i] for i in r.placements] == placed
    assert _victims(ans.extra["preemptions"]) == _victims(made)
    assert r.fail_type == ftype
    nodes = cell.config["nodes"]
    want = 2 if limit else nodes          # one placement per preemption
    assert len(placed) == len(made) == want
    assert all(len(p["victims"]) == 3 for p in made)
    assert [p["node"] for p in made] == sorted(
        n["metadata"]["name"] for n in data["nodes"])[:want]
    if not limit:
        assert ftype == "Unschedulable"
        assert r.fail_message == f"0/{nodes} nodes are available: " \
            f"{nodes} Insufficient cpu."
    got = entry.check_answer(cell, data, ans, CPU, CONTROL)
    assert got == {"snapshot_diff": 0, "step_diff": 0, "report_diff": 0,
                   "control_diff": 0}
    assert check.fault_of(got, CONTROL) is None


def test_tiny_cell_runs_correct(tmp_path):
    cell, dirs, _entry = _tiny(tmp_path)
    for traced in (False, True):
        res = _run(cell, dirs, traced)
        assert res["correct"] is True, res["checks"]
        assert all(v["value"] == 0 for v in res["checks"].values())
    assert set(res["metrics"]) == {m["name"] for m in cell.per_layer}
    assert all(v["value"] > 0 for v in res["metrics"].values())


# --- hand-built clusters: each criterion decides once -----------------------

def _node(name, cpu="4"):
    return {"metadata": {"name": name, "labels": {gen.HOSTNAME_KEY: name}},
            "spec": {},
            "status": {"allocatable": {"cpu": cpu, "memory": "32Gi",
                                       "pods": "110"},
                       "capacity": {"cpu": cpu, "memory": "32Gi",
                                    "pods": "110"}}}


def _pod(name, node, cpu, prio, start=None):
    p = gen.make_pod({"name": name, "cpu": cpu, "memory": "500Mi",
                      "spec": {"priority": prio}}, node_name=node)
    if start:
        p["status"]["startTime"] = start
    return p


def _fill(node, prio, starts=(None,) * 4):
    return [_pod(f"{node}-{j}", node, "900m", prio, s)
            for j, s in enumerate(starts)]


def _reprieve_keeps_higher():
    # the priority-5 pod is listed last but tried back first, and kept
    pods = [_pod(f"lo{j}", "n0", "900m", 1) for j in range(3)] + \
        [_pod("hi", "n0", "900m", 5)]
    return [_node("n0")], pods, ("n0", ["lo0", "lo1", "lo2"])


def _highest_priority():                 # criterion 2
    pods = _fill("n0", 5) + _fill("n1", 1)
    return [_node("n0"), _node("n1")], pods, ("n1", ["n1-1", "n1-2", "n1-3"])


def _priority_sum():                     # criterion 3
    pods = _fill("n0", 3) + [_pod("r1", "n1", "900m", 3),
                             _pod("r2", "n1", "900m", 1),
                             _pod("r3", "n1", "900m", 1),
                             _pod("r4", "n1", "900m", 3)]
    return [_node("n0"), _node("n1")], pods, ("n1", ["r2", "r3", "r4"])


def _victim_count():                     # criterion 4
    # n0: victims at 0 and -2**31, n1: one at 0; the offset sums are equal
    pods = [_pod("a", "n0", "2000m", 0), _pod("b", "n0", "1500m", -2 ** 31),
            _pod("big", "n1", "2000m", 0), _pod("small", "n1", "900m", 0)]
    return [_node("n0"), _node("n1")], pods, ("n1", ["big"])


def _start_time():                       # criterion 5
    day = "2024-{:02d}-{:02d}T00:00:00Z".format
    pods = _fill("n0", 0, [day(1, d) for d in (1, 2, 3, 4)]) + \
        _fill("n1", 0, [day(3, 1), day(3, 2), day(3, 3), day(1, 1)])
    return [_node("n0"), _node("n1")], pods, ("n1", ["n1-0", "n1-1", "n1-2"])


def _lowest_index():
    pods = _fill("n1", 0) + _fill("n0", 0)
    return [_node("n1"), _node("n0")], pods, ("n0", ["n0-1", "n0-2", "n0-3"])


HAND_BUILT = {"reprieve_keeps_higher": _reprieve_keeps_higher,
              "highest_priority": _highest_priority,
              "priority_sum": _priority_sum, "victim_count": _victim_count,
              "start_time": _start_time, "lowest_index": _lowest_index}


@pytest.mark.parametrize("case", sorted(HAND_BUILT))
def test_hand_built_preemption(case):
    """The reference's preemption is the one stated, and the port's."""
    from cluster_capacity_tpu_torch.framework import ClusterCapacity
    from portbench.program import profile_of
    nodes, pods, (node, victims) = HAND_BUILT[case]()
    pod = gen.make_pod({"name": "high", "cpu": "3000m", "memory": "500Mi",
                        "spec": {"priority": 10}})
    placed, made, ftype = preempt.run(nodes, pods, pod, 1, CPU)
    assert (made[0]["node"], sorted(made[0]["victims"])) == (node, victims)
    assert placed == [node] and ftype == "LimitReached"
    cc = ClusterCapacity(copy.deepcopy(pod), max_limit=1,
                         profile=profile_of({}), device=CPU)
    cc.sync_with_objects(nodes, pods)
    result = cc.run()
    assert _victims(cc.preemptions) == _victims(made)
    assert [result.node_names[i] for i in result.placements] == placed


def test_fewest_pdb_violations_decide_first():
    """Criterion 1, on the tournament alone (the reference refuses PDBs in
    the objects): the node with fewer violations wins over better
    priorities, as in the port's tournament."""
    from cluster_capacity_tpu_torch.engine import preemption as tpre
    cand = torch.tensor([True, True])
    stats = dict(highest=torch.tensor([0, 7]),
                 sum_offset=torch.tensor([2 ** 31, 2 ** 31 + 7]),
                 count=torch.tensor([1, 1]),
                 earliest=torch.tensor([0.0, 0.0], dtype=torch.float64))
    assert preempt.pick(cand, torch.tensor([1, 0]), **stats) == 1
    assert preempt.pick(cand, torch.tensor([0, 0]), **stats) == 0
    assert preempt.pick(torch.tensor([False, False]), torch.tensor([0, 0]),
                        **stats) is None
    snap = SimpleNamespace(priority_classes=[], node_names=["n0", "n1"])
    victims = [[_pod("v0", "n0", "900m", 0)], [_pod("v1", "n1", "900m", 7)]]
    for pdb, want in (([1, 0], 1), ([0, 0], 0)):
        out = tpre._pick(snap, {}, [(i, victims[i], pdb[i]) for i in (0, 1)],
                         {}, None, [])
        assert out.node_index == want


@pytest.mark.parametrize("what", ["pdbs", "priorityClassName",
                                  "preemptionPolicy", "affinity", "spread",
                                  "taints"])
def test_reference_refuses_what_it_does_not_model(what):
    nodes, pods, _want = _lowest_index()
    pod = gen.make_pod({"name": "high", "cpu": "3000m", "memory": "500Mi",
                        "spec": {"priority": 10}})
    pdbs = ()
    if what == "pdbs":
        pdbs = [{"metadata": {"name": "b"}, "spec": {"selector": {}}}]
    elif what == "taints":
        nodes[0]["spec"]["taints"] = [{"key": "k", "effect": "NoSchedule"}]
    elif what == "spread":
        pod["spec"]["topologySpreadConstraints"] = [{
            "maxSkew": 1, "topologyKey": gen.HOSTNAME_KEY,
            "whenUnsatisfiable": "DoNotSchedule", "labelSelector": {}}]
    else:
        pods[0]["spec"][what] = {"affinity": {"nodeAffinity": {}},
                                 "priorityClassName": "low",
                                 "preemptionPolicy": "Never"}[what]
    with pytest.raises(NotImplementedError):
        preempt.judge(nodes, pods, pod, [], [], 1, CPU, pdbs=pdbs)


# --- planted faults: the comparison has to fail -----------------------------

def _resident_names(snap, node):
    j = list(snap.node_names).index(node)
    return [p["metadata"]["name"] for p in snap.pods_by_node[j]]


def plant(ans, fault: str):
    """The answer with one fault planted in what the check reads (an
    answer with too few preemptions for it is returned as it is)."""
    pre = copy.deepcopy(ans.extra["preemptions"])
    snap = ans.snapshot
    final = ans.extra["final_snapshot"]
    if len(pre) < 2:
        return ans
    first = pre[0]
    if fault == "wrong_node":
        first["node"] = pre[1]["node"]
    elif fault == "victim_dropped":
        first["victims"] = first["victims"][1:]
    elif fault == "extra_victim":
        first["victims"].append(_resident_names(snap, pre[1]["node"])[0])
    elif fault == "victim_at_preemptor_priority":
        clones = [p["metadata"]["name"] for plist in final.pods_by_node
                  for p in plist if p["spec"].get("priority") == 10]
        pre[1]["victims"][0] = clones[0]
    elif fault == "all_residents_evicted":
        first["victims"] = _resident_names(snap, first["node"])
    elif fault == "preemption_missing":
        del pre[0]
    elif fault == "evicted_left_in_snapshot":
        j = list(final.node_names).index(first["node"])
        back = next(p for p in snap.pods_by_node[j]
                    if p["metadata"]["name"] == first["victims"][0])
        rosters = [list(p) for p in final.pods_by_node]
        rosters[j].append(back)
        requested = final.requested.copy()
        requested[j] += snap.requested[j] / len(snap.pods_by_node[j])
        final = dataclasses.replace(final, pods_by_node=rosters,
                                    requested=requested)
    else:
        raise ValueError(fault)
    return dataclasses.replace(ans, extra={"preemptions": pre,
                                           "final_snapshot": final})


FAULTS = {"wrong_node": "step_diff", "victim_dropped": "step_diff",
          "extra_victim": "step_diff",
          "victim_at_preemptor_priority": "step_diff",
          "all_residents_evicted": "step_diff",
          "preemption_missing": "step_diff",
          "evicted_left_in_snapshot": "snapshot_diff"}


def _run(cell, dirs, traced=False):
    out = io.StringIO()
    rc = run.run_cell(cell, 2 ** 31 + 3, 0.2, traced, CPU,
                      time.perf_counter(), dirs=dirs, out=out)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_caught(tmp_path, monkeypatch, fault):
    """Each fault shows in the number it belongs to, and a run whose
    answers carry it is not correct."""
    cell, dirs, entry = _tiny(tmp_path)
    data = gen.make_objects(cell.config, cell.traffic, SEEDS[0])
    ans = plant(entry.answer(cell, data, cell.traffic["max_limit"], CPU),
                fault)
    got = entry.check_answer(cell, data, ans, CPU, F32)
    assert got[FAULTS[fault]] > 0, got
    load = harness.load_module

    def planted(kind, name, search=None):
        mod = load(kind, name, search)
        if kind == "entries":
            real = mod.answer
            mod.answer = lambda *a: plant(real(*a), fault)
        return mod
    monkeypatch.setattr(harness, "load_module", planted)
    res = _run(cell, dirs)
    assert res["correct"] is False
    assert res["checks"][FAULTS[fault]]["value"] > 0


def test_control_diff_is_an_integer(tmp_path):
    cell, _dirs, entry = _tiny(tmp_path)
    data = gen.make_objects(cell.config, cell.traffic, SEEDS[1])
    ans = entry.answer(cell, data, cell.traffic["max_limit"], CPU)
    got = check.judge_for(entry, cell, data, CPU, CONTROL)(ans)
    assert isinstance(got["control_diff"], int)
    assert check.fault_of(got, CONTROL) is None
    assert set(check.judge_for(entry, cell, data, CPU)(ans)) == \
        set(check.JUDGED)

"""The prefanti cell on the CPU at its tiny cut: the port through
entries/affinity.py against reference/affinity.py, the reference on
clusters built by hand so that each part of upstream's InterPodAffinity
decides once (and the port with it), the faults the comparison must catch,
and the configuration's objects pinned byte for byte.  One card test runs
the tiny cut through kernel 1."""

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
from portbench.reference import affinity
from portbench.reference import cluster as gen

CELL = "k8s-5000n-prefanti.prefanti"
SEEDS = (2 ** 31 + 41, 2 ** 40 + 3)
CPU = torch.device("cpu")
F32 = (torch.float32,)
CONTROL = (torch.float32, torch.bfloat16)
HOST = gen.HOSTNAME_KEY

# sha256 of json.dumps(make_objects(config, mix, seed), sort_keys=True)
PINNED = [
    (1, "e9e844cc9eae1c95eb818114716f89299352bfff56d1a9d21e811e318fe86892"),
    (2 ** 31 + 77,
     "d517c2eb79beaf76934d3f4ee74adea4b0d85b9c9030942784b3a7e05d3615bc"),
]


@pytest.mark.parametrize("seed,digest", PINNED,
                         ids=[str(s) for s, _ in PINNED])
def test_objects_are_pinned(seed, digest):
    data = gen.make_objects(
        harness.load_json("configs", "k8s-5000n-prefanti"),
        harness.load_json("traffic", "prefanti"), seed)
    assert len(data["nodes"]) == 5000 and len(data["pods"]) == 5000
    assert {p["metadata"]["namespace"] for p in data["pods"]} == {"sched-0"}
    assert data["templates"][0]["metadata"]["namespace"] == "sched-1"
    text = json.dumps(data, sort_keys=True)
    assert hashlib.sha256(text.encode()).hexdigest() == digest


def _tiny(tmp_path):
    cell, dirs = pt.tiny_cell(tmp_path, CELL)
    entry = harness.load_module("entries", cell.traffic["entry"])
    return cell, dirs, entry


def _names(result):
    return [result.node_names[i] for i in result.placements]


@pytest.mark.parametrize("seed", SEEDS)
def test_port_equals_reference(tmp_path, seed):
    """Every placement, the count (39 more a node), the fail message and
    the four numbers of the comparison, the bfloat16 control included."""
    cell, _dirs, entry = _tiny(tmp_path)
    data = gen.make_objects(cell.config, cell.traffic, seed)
    ans = entry.answer(cell, data, 0, CPU)
    r = ans.results[0]
    assert r.rung == "fused"
    want = affinity.greedy(data["nodes"], data["pods"], data["templates"][0])
    nodes = cell.config["nodes"]
    assert _names(r) == want and len(want) == 39 * nodes
    assert r.fail_type == "Unschedulable"
    assert r.fail_message == \
        f"0/{nodes} nodes are available: {nodes} Insufficient cpu."
    got = entry.check_answer(cell, data, ans, CPU, CONTROL)
    assert check.fault_of(got, CONTROL) is None
    assert {k: v for k, v in got.items() if k != "control_diff"} == \
        {"snapshot_diff": 0, "step_diff": 0, "report_diff": 0}
    assert got["control_diff"] >= 0


def test_tiny_cell_runs_correct(tmp_path):
    cell, dirs, _entry = _tiny(tmp_path)
    for traced in (False, True):
        res = _run(cell, dirs, traced)
        assert res["correct"] is True, res["checks"]
        assert all(v["value"] == 0 for v in res["checks"].values())
    # the device's metrics read nothing on the CPU
    assert res["metrics"]["ipa_encode_ms.prefanti"]["value"] > 0
    assert set(res["metrics"]) <= {m["name"] for m in cell.per_layer}


# --- hand-built clusters: each part of InterPodAffinity decides once --------

def _node(name, cpu="4", labels=None):
    return {"metadata": {"name": name,
                         "labels": dict({HOST: name}, **(labels or {}))},
            "spec": {},
            "status": {"allocatable": {"cpu": cpu, "memory": "32Gi",
                                       "pods": "110"},
                       "capacity": {"cpu": cpu, "memory": "32Gi",
                                    "pods": "110"}}}


def _term(labels, key=HOST, namespaces=None):
    t = {"labelSelector": {"matchLabels": dict(labels)}, "topologyKey": key}
    if namespaces:
        t["namespaces"] = list(namespaces)
    return t


def _affinity(kind, required=(), preferred=()):
    section = {}
    if required:
        section["requiredDuringSchedulingIgnoredDuringExecution"] = \
            list(required)
    if preferred:
        section["preferredDuringSchedulingIgnoredDuringExecution"] = [
            {"weight": w, "podAffinityTerm": t} for w, t in preferred]
    return {kind: section}


def _pod(name, node="", labels=None, ns="default", cpu="100m", mem="500Mi",
         affinity_=None):
    spec = {"affinity": affinity_} if affinity_ else None
    return gen.make_pod({"name": name, "namespace": ns,
                         "labels": labels or {}, "cpu": cpu, "memory": mem,
                         "spec": spec}, node_name=node)


FOO = {"foo": ""}
SOFT_ANTI = _affinity("podAntiAffinity", preferred=[(1, _term(FOO))])


def _both_directions():
    # n0's resident matches the pod's term and carries it (-2), n1's only
    # matches it (-1), n2 is empty (0); zero requests leave the other
    # scores equal, so InterPodAffinity alone orders the nodes
    pods = [_pod("r0", "n0", FOO, cpu="0", mem="0", affinity_=SOFT_ANTI),
            _pod("r1", "n1", FOO, cpu="0", mem="0")]
    pod = _pod("p", labels=FOO, affinity_=SOFT_ANTI)
    return [_node(f"n{i}") for i in range(3)], pods, pod, \
        ["n2", "n1", "n0"]


def _explicit_namespaces():
    # the published template's namespaces, sched-1 and sched-0: n1's
    # resident (sched-0) scores both ways (-2); n2's, in `other`, is
    # outside the pod's namespaces but its own term lists sched-1 (-1)
    term = _term(FOO, namespaces=["sched-1", "sched-0"])
    soft = _affinity("podAntiAffinity", preferred=[(1, term)])
    pods = [_pod("r1", "n1", FOO, ns="sched-0", cpu="0", mem="0",
                 affinity_=soft),
            _pod("r2", "n2", FOO, ns="other", cpu="0", mem="0",
                 affinity_=soft)]
    pod = _pod("p", labels=FOO, ns="sched-1", affinity_=soft)
    return [_node(f"n{i}") for i in range(3)], pods, pod, ["n0", "n2"]


def _empty_label_value():
    # foo: "" matches foo: "" only: not foo: "x", not a pod without foo
    pods = [_pod("r0", "n0", {"foo": "x"}, cpu="0", mem="0"),
            _pod("r1", "n1", FOO, cpu="0", mem="0"),
            _pod("r2", "n2", {}, cpu="0", mem="0")]
    pod = _pod("p", labels={}, affinity_=SOFT_ANTI)
    return [_node(f"n{i}") for i in range(3)], pods, pod, ["n0"]


def _max_min_diff_zero():
    # every node holds one matching resident: the raw scores are equal,
    # the normalised ones 0, and LeastAllocated picks the node with room
    pods = [_pod(f"r{i}", f"n{i}", FOO, cpu=c, mem="0")
            for i, c in enumerate(("300m", "200m", "100m"))]
    pod = _pod("p", labels={}, affinity_=SOFT_ANTI)
    return [_node(f"n{i}") for i in range(3)], pods, pod, ["n2"]


def _required_affinity():
    # the only node with an app: db pod; the pod is no db itself
    req = _affinity("podAffinity", required=[_term({"app": "db"})])
    pods = [_pod("db", "n1", {"app": "db"})]
    pod = _pod("p", labels={"app": "web"}, affinity_=req)
    return [_node(f"n{i}") for i in range(3)], pods, pod, ["n1", "n1"]


def _lonely_pod():
    # no app: db pod anywhere and the pod is one: the escape lets it in
    # where the node has the key (n0 has no zone), then beside its clone
    req = _affinity("podAffinity", required=[
        _term({"app": "db"}, key="zone")])
    nodes = [_node("n0"), _node("n1", labels={"zone": "a"}),
             _node("n2", labels={"zone": "b"})]
    pod = _pod("p", labels={"app": "db"}, affinity_=req)
    return nodes, [], pod, ["n1", "n1"]


def _required_anti_affinity():
    # the pod keeps off web pods and off its own clones
    req = _affinity("podAntiAffinity", required=[_term({"app": "web"})])
    pods = [_pod("web", "n0", {"app": "web"})]
    pod = _pod("p", labels={"app": "web"}, affinity_=req)
    return [_node(f"n{i}") for i in range(3)], pods, pod, ["n1", "n2"]


def _existing_anti_affinity():
    # n1's resident keeps web pods off its node
    req = _affinity("podAntiAffinity", required=[_term({"app": "web"})])
    pods = [_pod("guard", "n0", {"app": "db"}, affinity_=req)]
    pod = _pod("p", labels={"app": "web"})
    return [_node(f"n{i}") for i in range(2)], pods, pod, ["n1", "n1"]


def _hard_pod_affinity_weight():
    # n1's resident requires pods like the pod: +1 for n1, which wins
    # over the empty n0
    req = _affinity("podAffinity", required=[_term({"app": "web"})])
    pods = [_pod("db", "n1", {"app": "db"}, cpu="0", mem="0",
                 affinity_=req)]
    pod = _pod("p", labels={"app": "web"})
    return [_node(f"n{i}") for i in range(2)], pods, pod, ["n1"]


HAND_BUILT = {"both_directions": _both_directions,
              "explicit_namespaces": _explicit_namespaces,
              "empty_label_value": _empty_label_value,
              "max_min_diff_zero": _max_min_diff_zero,
              "required_affinity": _required_affinity,
              "lonely_pod": _lonely_pod,
              "required_anti_affinity": _required_anti_affinity,
              "existing_anti_affinity": _existing_anti_affinity,
              "hard_pod_affinity_weight": _hard_pod_affinity_weight}


def _hand_cell(limit):
    return SimpleNamespace(config={}, traffic={"max_limit": limit})


def _port(nodes, pods, pod, limit, entry):
    data = {"nodes": nodes, "pods": pods, "templates": [pod]}
    return data, entry.answer(_hand_cell(limit), data, limit, CPU)


@pytest.mark.parametrize("case", sorted(HAND_BUILT))
def test_hand_built_affinity(case):
    """The reference's first placements are the ones worked by hand, the
    port's equal them, and the comparison finds nothing."""
    entry = harness.load_module("entries", "affinity")
    nodes, pods, pod, want = HAND_BUILT[case]()
    assert affinity.greedy(nodes, pods, pod, len(want), CPU) == want
    data, ans = _port(nodes, pods, pod, len(want), entry)
    assert _names(ans.results[0]) == want
    got = entry.check_answer(_hand_cell(len(want)), data, ans, CPU, F32)
    assert got == {"snapshot_diff": 0, "step_diff": 0, "report_diff": 0}


@pytest.mark.parametrize("case,reasons", [
    ("required_affinity", {affinity.REASON_AFFINITY: 2}),
    ("required_anti_affinity", {affinity.REASON_ANTI: 3}),
    ("existing_anti_affinity", {affinity.REASON_EXISTING_ANTI: 1})])
def test_filter_probe_reasons(case, reasons):
    """Each probe's reason in the fit error where the probes leave no
    node: after the placements the case makes, with the other nodes
    filled or fenced off."""
    nodes, pods, pod, _want = HAND_BUILT[case]()
    if case == "required_affinity":
        nodes = [n for n in nodes if n["metadata"]["name"] != "n1"] + \
            [_node("n1", cpu="0")]
        reasons = {affinity.REASON_AFFINITY: 2, "Insufficient cpu": 1}
    elif case == "existing_anti_affinity":
        nodes = nodes[:1]
    q = affinity.question(nodes, pods, pod, CPU)
    state = (affinity.sched.start_state(q.pb),
             torch.zeros(q.cluster.num_nodes, dtype=torch.int64))
    if case == "required_anti_affinity":
        for node in ("n1", "n2"):
            state = affinity.advance(q, state, q.cluster.index[node])
    feasible, counts = affinity.final_verdict(q, state)
    assert not feasible and counts == reasons
    entry = harness.load_module("entries", "affinity")
    _data, ans = _port(nodes, pods, pod, 0, entry)
    assert ans.results[0].fail_counts == reasons


@pytest.mark.parametrize("what", ["namespaceSelector", "matchExpressions",
                                  "nodeAffinity", "matchLabelKeys"])
def test_reference_refuses_what_it_does_not_model(what):
    nodes, pods, pod, _want = _both_directions()
    term = pod["spec"]["affinity"]["podAntiAffinity"][
        "preferredDuringSchedulingIgnoredDuringExecution"][0][
        "podAffinityTerm"]
    if what == "namespaceSelector":
        term["namespaceSelector"] = {}
    elif what == "matchExpressions":
        term["labelSelector"]["matchExpressions"] = [
            {"key": "foo", "operator": "Exists"}]
    elif what == "matchLabelKeys":
        term["matchLabelKeys"] = ["foo"]
    else:
        pod["spec"]["affinity"]["nodeAffinity"] = {}
    with pytest.raises(NotImplementedError):
        affinity.greedy(nodes, pods, pod, 1, CPU)


# --- planted faults: the comparison has to fail -----------------------------

def _normalised_over_all_nodes():
    # n2 is full (infeasible) and holds ten residents that score -20;
    # over the feasible nodes n1 (raw 0) gets 200 and n0 (raw -1) 0,
    # enough to beat n0's room; over all nodes n0 gets 190 and wins
    full = [_pod(f"f{j}", "n2", FOO, cpu="100m", mem="0",
                 affinity_=SOFT_ANTI) for j in range(10)]
    pods = [_pod("r0", "n0", FOO, cpu="0", mem="0"),
            _pod("big", "n1", {}, cpu="3500m", mem="0")] + full
    pod = _pod("p", labels=FOO, mem="100Mi", affinity_=SOFT_ANTI)
    return [_node("n0"), _node("n1"), _node("n2", cpu="1")], pods, pod


def _over_all_nodes(raw, feasible, dtype):
    return NORMALIZE(raw, torch.ones_like(feasible), dtype)


NORMALIZE = affinity.normalize


def _with_placements(ans, names):
    r = ans.results[0]
    idx = [list(r.node_names).index(nm) for nm in names]
    return dataclasses.replace(
        ans, results=[dataclasses.replace(r, placements=idx)])


def plant(ans, fault: str, data: dict, monkeypatch):
    """The answer with one fault planted in what the check reads."""
    r = ans.results[0]
    if fault == "placement_moved":
        names = _names(r)
        j = len(names) // 2
        names[j] = next(n for n in r.node_names if n != names[j])
        return _with_placements(ans, names)
    if fault == "resident_term_dropped":
        # the program run as if the residents carried no term
        pods = copy.deepcopy(data["pods"])
        for p in pods:
            p["spec"].pop("affinity", None)
        entry = harness.load_module("entries", "affinity")
        return _port(data["nodes"], pods, data["templates"][0],
                     len(r.placements), entry)[1]
    if fault == "normalised_over_all_nodes":
        with monkeypatch.context() as m:
            m.setattr(affinity, "normalize", _over_all_nodes)
            names = affinity.greedy(data["nodes"], data["pods"],
                                    data["templates"][0], len(r.placements),
                                    CPU)
        return _with_placements(ans, names)
    if fault == "ipa_sign_flipped":
        with monkeypatch.context() as m:
            m.setattr(affinity, "W_IPA", -affinity.W_IPA)
            names = affinity.greedy(data["nodes"], data["pods"],
                                    data["templates"][0], len(r.placements),
                                    CPU)
        return _with_placements(ans, names)
    raise ValueError(fault)


HAND_FAULTS = {"resident_term_dropped": (_both_directions, 3),
               "normalised_over_all_nodes": (_normalised_over_all_nodes, 1)}


@pytest.mark.parametrize("fault", sorted(HAND_FAULTS))
def test_a_planted_fault_is_caught_by_hand(monkeypatch, fault):
    """The faults that need a cluster where InterPodAffinity decides (at
    the cell's own shape it agrees with LeastAllocated at every step)."""
    entry = harness.load_module("entries", "affinity")
    make, limit = HAND_FAULTS[fault]
    nodes, pods, pod = make()[:3]
    data, ans = _port(nodes, pods, pod, limit, entry)
    assert entry.check_answer(_hand_cell(limit), data, ans, CPU, F32) == \
        {"snapshot_diff": 0, "step_diff": 0, "report_diff": 0}
    bad = plant(ans, fault, data, monkeypatch)
    assert _names(bad.results[0]) != _names(ans.results[0])
    got = entry.check_answer(_hand_cell(limit), data, bad, CPU, F32)
    assert got["step_diff"] > 0, got


CELL_FAULTS = ("placement_moved", "ipa_sign_flipped")


def _run(cell, dirs, traced=False):
    out = io.StringIO()
    rc = run.run_cell(cell, 2 ** 31 + 3, 0.2, traced, CPU,
                      time.perf_counter(), dirs=dirs, out=out)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("fault", CELL_FAULTS)
def test_a_planted_fault_is_caught(tmp_path, monkeypatch, fault):
    """At the tiny cut: the fault shows in step_diff, and a run whose
    answers carry it is not correct."""
    cell, dirs, entry = _tiny(tmp_path)
    data = gen.make_objects(cell.config, cell.traffic, SEEDS[0])
    ans = plant(entry.answer(cell, data, 0, CPU), fault, data, monkeypatch)
    got = entry.check_answer(cell, data, ans, CPU, F32)
    assert got["step_diff"] > 0, got
    load = harness.load_module

    def planted(kind, name, search=None):
        mod = load(kind, name, search)
        if kind == "entries":
            real = mod.answer
            mod.answer = lambda c, d, *a: plant(real(c, d, *a), fault, d,
                                                monkeypatch)
        return mod
    monkeypatch.setattr(harness, "load_module", planted)
    res = _run(cell, dirs)
    assert res["correct"] is False
    assert res["checks"]["step_diff"]["value"] > 0


def test_control_diff_is_an_integer(tmp_path):
    cell, _dirs, entry = _tiny(tmp_path)
    data = gen.make_objects(cell.config, cell.traffic, SEEDS[1])
    ans = entry.answer(cell, data, 0, CPU)
    got = check.judge_for(entry, cell, data, CPU, CONTROL)(ans)
    assert isinstance(got["control_diff"], int)
    assert check.fault_of(got, CONTROL) is None
    assert set(check.judge_for(entry, cell, data, CPU)(ans)) == \
        set(check.JUDGED)


@pytest.mark.cuda
def test_tiny_cut_on_the_card(tmp_path):
    """The tiny cut through kernel 1 on the card, judged there: correct."""
    from cluster_capacity_tpu_torch.engine import fused
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cell, _dirs, entry = _tiny(tmp_path)
    card = torch.device("cuda", 0)
    data = gen.make_objects(cell.config, cell.traffic, SEEDS[0])
    launches = fused.LAUNCHES
    ans = entry.answer(cell, data, 0, card)
    assert fused.LAUNCHES > launches and ans.results[0].rung == "fused"
    got = entry.check_answer(cell, data, ans, card, F32)
    assert got == {"snapshot_diff": 0, "step_diff": 0, "report_diff": 0}
    assert _names(ans.results[0]) == affinity.greedy(
        data["nodes"], data["pods"], data["templates"][0])


def test_roofline_counts_the_ipa_work():
    """The cell's step: one hostname group, the preferred planes and the
    score live; InterPodAffinity's per-node work and planes on top of
    roofline.py's step, counted from the descriptions alone."""
    from portbench.reference import roofline, roofline_ipa
    cfg = harness.load_json("configs", "k8s-5000n-prefanti")
    mix = harness.load_json("traffic", "prefanti")
    shape = roofline_ipa.ipa_shape(mix["pod"], [cfg["resident"]])
    assert shape == (1, {"preferred"}, True)
    assert roofline_ipa.ipa_ops(*shape) == 3 + 12 + 8
    assert roofline_ipa.ipa_planes(*shape) == (3, 1)
    assert roofline_ipa.ipa_shape({"name": "p"}, [{"name": "r"}]) == \
        (0, set(), False)
    req = {"spec": {"affinity": _affinity(
        "podAntiAffinity", required=[_term({"app": "web"})])}}
    assert roofline_ipa.ipa_shape(req, [{}]) == \
        (1, {"filter", "anti_affinity"}, False)
    nodes, steps = 5000, 195000
    plain = roofline.least_seconds(nodes, 3, 0, steps)
    ipa = roofline_ipa.least_seconds(nodes, 3, 0, steps, *shape)
    assert ipa["flops"] == plain["flops"] // 89 * (89 + 23)
    assert ipa["bytes"] == plain["bytes"] + 4 * nodes * 4
    assert ipa["bound"] == "operations" and ipa["seconds"] > \
        plain["seconds"]

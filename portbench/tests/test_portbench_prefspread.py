"""The prefspread cell on the CPU at its tiny cut: the port through
entries/spread_soft.py against reference/spread_soft.py, the reference on
clusters built by hand so that PodTopologySpread's score decides against
LeastAllocated (and the port with it), the float32 log weight, the faults
the comparison must catch, the roofline count, and the cell's objects
pinned byte for byte.  One card test runs the tiny cut through kernel 1."""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import math
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import portbench_tiny as pt
from portbench import check, harness, run
from portbench.reference import cluster as gen
from portbench.reference import roofline, roofline_ss, spread_soft

CELL = "k8s-5000n.prefspread"
CONFIG = "k8s-5000n-prefspread"
SEEDS = (2 ** 31 + 41, 2 ** 40 + 3)
CPU = torch.device("cpu")
F32 = (torch.float32,)
CONTROL = (torch.float32, torch.bfloat16)
HOST = gen.HOSTNAME_KEY
ZONE = "topology.kubernetes.io/zone"
BLUE = {"color": "blue"}
CLEAN = {"snapshot_diff": 0, "step_diff": 0, "report_diff": 0}

# sha256 of json.dumps(make_objects(config, mix, seed), sort_keys=True)
PINNED = [
    (1, "38e1bbac749c17eb717ee31d8c06f81b84a6ed64e0c5bd2c98b35ad8be8c3108"),
    (2 ** 31 + 77,
     "415daa7e5e44e76538504c8ab41aeb4f3f12077bcf03ddc96e11508546965b61"),
]


@pytest.mark.parametrize("seed,digest", PINNED,
                         ids=[str(s) for s, _ in PINNED])
def test_objects_are_pinned(seed, digest):
    data = gen.make_objects(harness.load_json("configs", CONFIG),
                            harness.load_json("traffic", "prefspread"), seed)
    assert len(data["nodes"]) == 5000 and len(data["pods"]) == 5000
    (c,) = data["templates"][0]["spec"]["topologySpreadConstraints"]
    assert c["whenUnsatisfiable"] == "ScheduleAnyway" and c["maxSkew"] == 5
    text = json.dumps(data, sort_keys=True)
    assert hashlib.sha256(text.encode()).hexdigest() == digest


def _tiny(tmp_path):
    cell, dirs = pt.tiny_cell(tmp_path, CELL)
    entry = harness.load_module("entries", cell.traffic["entry"])
    return cell, dirs, entry


def _names(result):
    return [result.node_names[i] for i in result.placements]


def _run(cell, dirs, traced=False):
    out = io.StringIO()
    rc = run.run_cell(cell, 2 ** 31 + 3, 0.2, traced, CPU,
                      time.perf_counter(), dirs=dirs, out=out)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("seed", SEEDS)
def test_port_equals_reference(tmp_path, seed):
    """Every placement, the count (39 more a node), the fail message and
    the four numbers of the comparison, the bfloat16 control included."""
    cell, _dirs, entry = _tiny(tmp_path)
    data = gen.make_objects(cell.config, cell.traffic, seed)
    ans = entry.answer(cell, data, 0, CPU)
    r = ans.results[0]
    assert r.rung == "fused"
    want = spread_soft.greedy(data["nodes"], data["pods"],
                              data["templates"][0])
    nodes = cell.config["nodes"]
    assert _names(r) == want and len(want) == 39 * nodes
    assert r.fail_type == "Unschedulable"
    assert r.fail_message == \
        f"0/{nodes} nodes are available: {nodes} Insufficient cpu."
    got = entry.check_answer(cell, data, ans, CPU, CONTROL)
    assert check.fault_of(got, CONTROL) is None
    assert {k: v for k, v in got.items() if k != "control_diff"} == CLEAN
    assert got["control_diff"] > 0
    # counts this small never meet upstream's float64 arithmetic apart
    q = spread_soft.question(data["nodes"], data["pods"],
                             data["templates"][0])
    census = spread_soft.census(q, spread_soft.node_sequence(
        q, r.node_names, r.placements))
    assert census == {"steps": len(want), "raw_steps": 0, "norm_steps": 0,
                      "choice_steps": 0, "norm_nodes": 0, "half_steps": 0}


def test_tiny_cell_runs_correct(tmp_path):
    cell, dirs, _entry = _tiny(tmp_path)
    for traced in (False, True):
        res = _run(cell, dirs, traced)
        assert res["correct"] is True, res["checks"]
        assert all(v["value"] == 0 for v in res["checks"].values())
    # the device's metrics read nothing on the CPU
    assert res["metrics"]["spread_encode_ms.prefspread"]["value"] > 0
    assert set(res["metrics"]) <= {m["name"] for m in cell.per_layer}


# --- hand-built clusters: the soft score decides against LeastAllocated --

def _node(name, zone=None, cpu="4"):
    labels = {HOST: name}
    if zone:
        labels[ZONE] = zone
    return {"metadata": {"name": name, "labels": labels}, "spec": {},
            "status": {"allocatable": {"cpu": cpu, "memory": "32Gi",
                                       "pods": "110"},
                       "capacity": {"cpu": cpu, "memory": "32Gi",
                                    "pods": "110"}}}


def _resident(name, node, labels=None, cpu="0"):
    return gen.make_pod({"name": name, "labels": labels or {}, "cpu": cpu,
                         "memory": "0"}, node_name=node)


def _blues(node, count):
    return [_resident(f"{node}-b{j}", node, BLUE) for j in range(count)]


def _pod(key=ZONE, skew=5, cpu="100m"):
    return gen.make_pod({
        "name": "p", "labels": BLUE, "cpu": cpu, "memory": "500Mi",
        "spec": {"topologySpreadConstraints": [{
            "maxSkew": skew, "topologyKey": key,
            "whenUnsatisfiable": "ScheduleAnyway",
            "labelSelector": {"matchExpressions": [
                {"key": "color", "operator": "In",
                 "values": ["blue"]}]}}]}})


def _unequal_zone_counts():
    # zones a, b, c hold 2, 1, 0 blue pods: raw 7, 6, 4 (log 5), so c
    # scores 100, a 57; c's node carries 2,000m more, which LeastAllocated
    # and BalancedAllocation charge 50 points, the spread 86
    nodes = [_node("n0", "a"), _node("n1", "b"), _node("n2", "c")]
    pods = _blues("n0", 2) + _blues("n1", 1) + \
        [_resident("load", "n2", cpu="2000m")]
    return nodes, pods, _pod(), ["n2"], 6


def _zone_fills():
    # room for 3, 5 and 10 pods: zone a fills first, then b, so the zones
    # among the feasible nodes fall from 3 to 2 to 1.  Every zone scores
    # 100 at first and LeastAllocated takes the largest node, n2; then c
    # scores 66 (raw 6 against 4) and the spread sends the next pods to
    # b, the larger of the two left, and then to a
    nodes = [_node("n0", "a", cpu="300m"), _node("n1", "b", cpu="500m"),
             _node("n2", "c", cpu="1")]
    return nodes, [], _pod(), ["n2", "n1", "n0"], 0


def _unlabelled_nodes():
    # n1 has no zone label: ignored, scored 0, although it is empty and
    # n0 carries a blue pod and 1,000m
    nodes = [_node("n0", "a"), _node("n1")]
    pods = _blues("n0", 1) + [_resident("load", "n0", cpu="1000m")]
    return nodes, pods, _pod(), ["n0"], 4


def _hostname_row():
    # a hostname soft row: n0's two blue pods score raw 3 (log 4), n1's
    # none 0, so n1 scores 100 and n0 0, although n1 carries 1,000m
    nodes = [_node("n0", "a"), _node("n1", "a")]
    pods = _blues("n0", 2) + [_resident("load", "n1", cpu="1000m")]
    return nodes, pods, _pod(key=HOST, skew=1), ["n1"], 4


def _max_zero():
    # maxSkew 1 and no blue pod: every raw score is 0, max is 0, every
    # node scores 100 and LeastAllocated takes the empty n1; then zone b
    # scores round(log 4) = 1 and 0, zone a 100
    nodes = [_node("n0", "a"), _node("n1", "b")]
    pods = [_resident("load", "n0", cpu="1000m")]
    return nodes, pods, _pod(skew=1), ["n1", "n0"], 4


HAND_BUILT = {"unequal_zone_counts": _unequal_zone_counts,
              "zone_fills": _zone_fills,
              "unlabelled_nodes": _unlabelled_nodes,
              "hostname_row": _hostname_row,
              "max_zero": _max_zero}


def _hand_cell(limit):
    return SimpleNamespace(config={}, traffic={"max_limit": limit})


def _port(nodes, pods, pod, limit, entry):
    data = {"nodes": nodes, "pods": pods, "templates": [pod]}
    return data, entry.answer(_hand_cell(limit), data, limit, CPU)


@pytest.mark.parametrize("case", sorted(HAND_BUILT))
def test_hand_built_soft_spread(case):
    """The reference's first placements are the ones worked by hand, the
    port's equal the reference's over the whole run (to the limit, or
    until no node fits), and the comparison finds nothing."""
    entry = harness.load_module("entries", "spread_soft")
    nodes, pods, pod, first, limit = HAND_BUILT[case]()
    want = spread_soft.greedy(nodes, pods, pod, limit, CPU)
    assert want[:len(first)] == first
    data, ans = _port(nodes, pods, pod, limit, entry)
    assert _names(ans.results[0]) == want
    assert entry.check_answer(_hand_cell(limit), data, ans, CPU, F32) == \
        CLEAN


def test_zone_fills_takes_the_domain_count_down():
    """The zones among the feasible nodes before each step, from the
    reference's own topo sizes: 3, then 2 once n0 is full, then 1."""
    nodes, pods, pod, _first, _limit = _zone_fills()
    names = spread_soft.greedy(nodes, pods, pod, 0, CPU)
    assert len(names) == 3 + 5 + 10
    q = spread_soft.question(nodes, pods, pod, CPU)
    seq = torch.as_tensor([q.cluster.index[nm] for nm in names])
    (k, used, _nz, cnt_sp, _cnt), _after = spread_soft._block(
        q, spread_soft._start(q), seq)
    feasible = spread_soft.sched._filters(q.pb, k, used, cnt_sp,
                                          torch.float32)[0]
    sizes = q.spread.topo_sizes(feasible)[0].tolist()
    assert sizes == sorted(sizes, reverse=True)
    assert set(sizes) == {3, 2, 1} and sizes[0] == 3 and sizes[-1] == 1


def test_log_weight_is_the_float64_log_rounded_once():
    """log(size + 2) at sizes 0-4 (the cell's are 1-3): the float64
    logarithm rounded once to float32."""
    sizes = torch.arange(5)
    got = spread_soft.log_weight(sizes)
    assert got.dtype == torch.float32
    want = np.array([math.log(s + 2) for s in range(5)]).astype(np.float32)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("value,want", [(2.5, 3.0), (3.5, 4.0), (4.4, 4.0),
                                        (5.0, 5.0), (-2.5, -3.0)])
def test_round_half_away_is_go_math_round(value, want):
    x = torch.tensor([value], dtype=torch.float64)
    assert float(spread_soft.round_half_away(x)[0]) == want


@pytest.mark.parametrize("what", ["matchLabelKeys", "nodeTaintsPolicy",
                                  "operator", "nodeSelector"])
def test_reference_refuses_what_it_does_not_model(what):
    nodes, pods, pod, _first, _limit = _unequal_zone_counts()
    c = pod["spec"]["topologySpreadConstraints"][0]
    if what == "matchLabelKeys":
        c["matchLabelKeys"] = ["color"]
    elif what == "nodeTaintsPolicy":
        c["nodeTaintsPolicy"] = "Honor"
    elif what == "operator":
        c["labelSelector"]["matchExpressions"][0]["operator"] = "Gt"
    else:
        pod["spec"]["nodeSelector"] = {"x": "y"}
    with pytest.raises(NotImplementedError):
        spread_soft.greedy(nodes, pods, pod, 1, CPU)


# --- planted faults: the comparison has to fail -----------------------------

def _log_size_plus_one(size):
    return torch.log(size.to(torch.float64) + 1.0).to(torch.float32)


REAL_CONSTRAINTS = spread_soft.soft_constraints
REAL_SPREAD_INIT = spread_soft.Spread.__init__


def _skew_not_minus_one(pod):
    return [dataclasses.replace(c, max_skew=c.max_skew + 1)
            for c in REAL_CONSTRAINTS(pod)]


def _ignored_scored(self, *args, **kw):
    REAL_SPREAD_INIT(self, *args, **kw)
    self.ignored = torch.zeros_like(self.ignored)


FAULTS = {"log_size_plus_one": (_unequal_zone_counts, "log_weight",
                                _log_size_plus_one),
          "max_skew_not_minus_one": (_unequal_zone_counts,
                                     "soft_constraints",
                                     _skew_not_minus_one),
          "ignored_nodes_scored": (_unlabelled_nodes, "Spread.__init__",
                                   _ignored_scored)}


def _with_placements(ans, names):
    r = ans.results[0]
    idx = [list(r.node_names).index(nm) for nm in names]
    return dataclasses.replace(
        ans, results=[dataclasses.replace(r, placements=idx)])


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_caught(monkeypatch, fault):
    """An answer whose placements follow the reference with one fault
    planted: the check finds each off the reference's node."""
    entry = harness.load_module("entries", "spread_soft")
    make, attr, fn = FAULTS[fault]
    nodes, pods, pod, _first, limit = make()
    data, ans = _port(nodes, pods, pod, limit, entry)
    assert entry.check_answer(_hand_cell(limit), data, ans, CPU, F32) == \
        CLEAN
    with monkeypatch.context() as m:
        if attr == "Spread.__init__":
            m.setattr(spread_soft.Spread, "__init__", fn)
        else:
            m.setattr(spread_soft, attr, fn)
        names = spread_soft.greedy(nodes, pods, pod, limit, CPU)
    assert names != _names(ans.results[0])
    bad = _with_placements(ans, names)
    got = entry.check_answer(_hand_cell(limit), data, bad, CPU, F32)
    assert got["step_diff"] > 0, got


def test_a_moved_placement_fails_the_run(tmp_path, monkeypatch):
    """At the tiny cut: one placement moved shows in step_diff, and a run
    whose answers carry it is not correct."""
    cell, dirs, _entry = _tiny(tmp_path)
    load = harness.load_module

    def moved(ans):
        names = _names(ans.results[0])
        j = len(names) // 2
        names[j] = next(n for n in ans.results[0].node_names
                        if n != names[j])
        return _with_placements(ans, names)

    def planted(kind, name, search=None):
        mod = load(kind, name, search)
        if kind == "entries":
            real = mod.answer
            mod.answer = lambda *a: moved(real(*a))
        return mod
    monkeypatch.setattr(harness, "load_module", planted)
    res = _run(cell, dirs)
    assert res["correct"] is False
    assert res["checks"]["step_diff"]["value"] > 0


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
    assert entry.check_answer(cell, data, ans, card, F32) == CLEAN
    assert _names(ans.results[0]) == spread_soft.greedy(
        data["nodes"], data["pods"], data["templates"][0])


def test_roofline_counts_the_soft_rows():
    """The cell's step: no hard spread, one zone row that the clone
    counts in; its per-node work and planes on top of roofline.py's
    step, counted from the pod description alone."""
    mix = harness.load_json("traffic", "prefspread")
    hard, rows = roofline_ss.spread_shape(mix["pod"])
    assert (hard, rows) == (0, [(False, True)])
    assert roofline_ss.ss_ops(rows) == 2 + 3 + 4 + 9 + 4 + 8
    assert roofline_ss.ss_planes(rows) == (5, 1)
    assert roofline_ss.spread_shape({"name": "p"}) == (0, [])
    assert roofline_ss.ss_ops([]) == 0
    spread = harness.load_json("traffic", "spread")["pod"]
    assert roofline_ss.spread_shape(spread) == (1, [])
    nodes, steps = 5000, 195000
    plain = roofline.least_seconds(nodes, 3, 0, steps)
    soft = roofline_ss.least_seconds(nodes, 3, 0, steps, rows)
    assert soft["flops"] == plain["flops"] // 89 * (89 + 30)
    assert soft["bytes"] == plain["bytes"] + 4 * nodes * 6
    assert soft["bound"] == "operations" and \
        soft["seconds"] > plain["seconds"]

"""The harness's room for a cell that is added as files alone: objects
that carry scheduler fields as data (`spec`, `node_spec`, no zones), an
entry that brings its own comparison (`check_answer`) and fills
`Answer.extra`, a file's own `tiny` cut; and the objects of the existing
configurations pinned byte for byte."""

from __future__ import annotations

import hashlib
import io
import json
import time

import pytest
import torch

import portbench_tiny as pt
from portbench import check, harness, run
from portbench.reference import cluster as gen
from portbench.reference import sched

# sha256 of json.dumps(make_objects(config, mix, seed), sort_keys=True)
PINNED = [
    ("k8s-5000n", "spread", 1,
     "1677407333c64bded606b4e086836179434b96df0848428c7fa8ea16f8e50512"),
    ("k8s-5000n", "spread", 2 ** 31 + 77,
     "c96cedeccbf6062d188186b1cb707a64e1220b6700ab53e9813aaaaf2b76f01f"),
    ("gke-10000n", "race", 1,
     "9daa6fb00d41ff18a2f0834e5aba0fa950b371f5ec57f67d3871b92cdbf153e4"),
    ("gke-10000n", "race", 2 ** 31 + 77,
     "092f0b35477c06e4aa91fecbca554d430a14c897c9de80539a9709853b75c99e"),
]


@pytest.mark.parametrize("config,mix,seed,digest", PINNED,
                         ids=[f"{c}-{m}-{s}" for c, m, s, _ in PINNED])
def test_existing_objects_are_pinned(config, mix, seed, digest):
    data = gen.make_objects(harness.load_json("configs", config),
                            harness.load_json("traffic", mix), seed)
    text = json.dumps(data, sort_keys=True)
    assert hashlib.sha256(text.encode()).hexdigest() == digest


# a preemption-shaped cell: every node nearly full of priority-0 residents,
# a priority-10 pod that fits only once three of them are evicted
CONFIG = {
    "name": "tiny-preempt", "source": "a throwaway test cell",
    "reduced": [], "nodes": 8, "node_name_prefix": "node-",
    "pools": [{"name": "default", "cpu": "4", "memory": "32Gi",
               "pods": 110}],
    "resident": {"per_node": 4, "name_prefix": "low-", "cpu": "900m",
                 "memory": "500Mi", "spec": {"priority": 0}},
    "profile": {"post_filters": ["DefaultPreemption"]}}
MIX = {"entry": "preempt_probe",
       "pod": {"name": "high", "cpu": "3000m", "memory": "500Mi",
               "spec": {"priority": 10}},
       "max_limit": 2, "warmup_limit": 2, "check_answers": 1}
ENTRY = '''
from portbench import check
from portbench.program import Answer, profile_of
from portbench.reference import cluster as gen
from portbench.reference import sched

MODE = {mode!r}


def answer(cell, data, limit, device):
    from cluster_capacity_tpu_torch.framework import ClusterCapacity
    cc = ClusterCapacity(data["templates"][0], max_limit=limit,
                         profile=profile_of(cell.config), device=device)
    cc.sync_with_objects(data["nodes"], data["pods"])
    result = cc.run()
    return Answer(results=[result], snapshot=cc.snapshot,
                  placed=result.placed_count, degraded=bool(result.degraded),
                  extra={{"preemptions": list(cc.preemptions)}})


def check_answer(cell, data, ans, device, dtypes):
    cluster = sched.Cluster(data["nodes"], data["pods"])
    pod = data["templates"][0]
    need = gen.milli(pod["spec"]["containers"][0]["resources"]["requests"]
                     ["cpu"])
    pods = {{p["metadata"]["name"]: p for p in data["pods"]}}
    step = 0
    for pre in ans.extra["preemptions"]:
        node = cluster.index[pre["node"]]
        victims = [pods.get(v) for v in pre["victims"]]
        ok = all(v is not None and v["spec"]["nodeName"] == pre["node"]
                 and v["spec"]["priority"] < pod["spec"]["priority"]
                 for v in victims)
        freed = sum(sched._requests(v)[0]["cpu"] for v in victims if v)
        free = cluster.alloc[node, sched.CPU] - cluster.used[node, sched.CPU]
        step += int(not ok or free + freed < need)
    r = ans.results[0]
    limit = int(cell.traffic["max_limit"])
    got = {{"snapshot_diff": check.snapshot_diff(ans.snapshot, cluster),
            "step_diff": step + int(len(ans.extra["preemptions"]) != limit),
            "report_diff": int(r.placed_count != limit)
            + int(r.fail_type != "LimitReached")}}
    if MODE == "diff":
        got["step_diff"] += 1
    if MODE == "missing":
        del got["report_diff"]
    return got
'''


def _preempt_cell(tmp_path, mode):
    dirs = {}
    for kind, name, text in (
            ("configs", "tiny-preempt.json", json.dumps(CONFIG)),
            ("traffic", "preempt.json", json.dumps(MIX)),
            ("entries", "preempt_probe.py", ENTRY.format(mode=mode))):
        (tmp_path / kind).mkdir()
        (tmp_path / kind / name).write_text(text)
        dirs[kind] = [str(tmp_path / kind)]
    bench = pt.bench()
    bench["configs"].append({"name": "tiny-preempt", "source": "test",
                             "file": "tiny-preempt.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "tiny-preempt.preempt",
                               "config": "tiny-preempt",
                               "traffic": "preempt", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + ["tiny-preempt.preempt"]
    return harness.load_cell(bench, "tiny-preempt.preempt", dirs), dirs


@pytest.mark.parametrize("mode", ["own_check", "diff", "missing"])
def test_a_preemption_cell_from_search_dirs(tmp_path, monkeypatch, capsys,
                                            mode):
    """A cell whose pods carry priorities, added as files in search
    directories alone, judged by its entry's own check_answer: the harness
    builds no reference cluster of its own and never calls
    check.check_answer (whose encode_template refuses priority).  A check
    that reports a diff, or leaves a number out, makes it not correct."""
    cell, dirs = _preempt_cell(tmp_path, mode)
    seed = 2 ** 31 + 41
    data = gen.make_objects(cell.config, cell.traffic, seed)
    assert {p["spec"]["priority"] for p in data["pods"]} == {0}
    assert data["templates"][0]["spec"]["priority"] == 10
    assert all(set(n["metadata"]["labels"]) == {gen.HOSTNAME_KEY}
               for n in data["nodes"])
    with pytest.raises(NotImplementedError):
        sched.encode_template(data["templates"][0])

    def refused(*_a, **_kw):
        raise AssertionError("check.check_answer called")
    built = []

    class Counted(sched.Cluster):
        def __init__(self, *a, **kw):
            built.append(1)
            super().__init__(*a, **kw)
    monkeypatch.setattr(check, "check_answer", refused)
    monkeypatch.setattr(sched, "Cluster", Counted)
    out = io.StringIO()
    rc = run.run_cell(cell, seed, 0.2, False, torch.device("cpu"),
                      time.perf_counter(), dirs=dirs, out=out)
    assert rc == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert built == [1]              # the entry's check, on one answer
    err = capsys.readouterr().err
    if mode == "own_check":
        assert res["correct"] is True, res["checks"]
        assert all(v["value"] == 0 for v in res["checks"].values())
        entry = harness.load_module("entries", "preempt_probe",
                                    dirs["entries"])
        ans = entry.answer(cell, data, 2, torch.device("cpu"))
        assert ans.placed == 2
        assert len(ans.extra["preemptions"]) == 2
        assert all(len(p["victims"]) >= 1 for p in ans.extra["preemptions"])
    elif mode == "diff":
        assert res["correct"] is False
        assert res["checks"]["step_diff"]["value"] == 1
    else:
        assert res["correct"] is False
        assert res["checks"]["malformed_checks"] == {"value": 1, "limit": 0}
        assert "lacks report_diff" in err


@pytest.mark.parametrize("got,fault", [
    ({"snapshot_diff": 0, "step_diff": 0, "report_diff": 0}, None),
    ({"snapshot_diff": 0, "step_diff": 0}, "lacks report_diff"),
    ({"snapshot_diff": 0, "step_diff": 0.0, "report_diff": 0},
     "step_diff is float, not an integer"),
    ({"snapshot_diff": 0, "step_diff": 0, "report_diff": False},
     "report_diff is bool, not an integer"),
    ({"snapshot_diff": 0, "step_diff": 0, "report_diff": 0, "x": 1},
     "holds x, which is not compared"),
    ([0, 0, 0], "returned list, not a dict"),
])
def test_an_entry_check_is_held_to_its_shape(got, fault):
    assert check.fault_of(got) == fault
    with_control = dict(got, control_diff=0) if isinstance(got, dict) \
        else got
    assert check.fault_of(with_control, (torch.float32, torch.bfloat16)) \
        == fault
    if fault is None:
        assert check.fault_of(got, (torch.float32, torch.bfloat16)) == \
            "lacks control_diff"


@pytest.mark.parametrize("kind,name,obj,want", [
    ("configs", "k8s-5000n", {"nodes": 5000}, {"nodes": 60}),
    ("configs", "gke-10000n", {"nodes": 10000}, {"nodes": 48}),
    ("configs", "new", {"nodes": 5000, "tiny": {"nodes": 8}}, {"nodes": 8}),
    ("traffic", "race", {"templates": {"count": 50, "cpu": ["1"]},
                         "max_limit": 20000},
     {"templates": {"count": 6, "cpu": ["1"]}, "max_limit": 240}),
    ("traffic", "new", {"templates": {"count": 50, "cpu": ["1"]},
                        "max_limit": 20000,
                        "tiny": {"max_limit": 64,
                                 "templates": {"count": 3}}},
     {"templates": {"count": 3, "cpu": ["1"]}, "max_limit": 64}),
])
def test_a_file_carries_its_own_tiny_cut(kind, name, obj, want):
    """A file's own `tiny` overrides; the tables for the files that carry
    none, at the sizes the existing cells' CPU tests have."""
    got = pt.tiny_copy(kind, name, obj)
    assert {k: got[k] for k in want} == want

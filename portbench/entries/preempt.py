"""Entry `preempt`: one capacity question whose pod may preempt, as
upstream's CLI asks it (framework.ClusterCapacity: sync the object lists,
run the solve and DefaultPreemption loop, the result in hand).

`Answer.extra` carries what the comparison reads beyond the result: each
preemption the loop made (`preemptions`: node, victim names, PDB
violations, in order) and the working snapshot the loop left
(`final_snapshot`: evictions made, the clones placed before the last
preemption committed).  `check_answer` holds the answer to
reference/preempt.py, the plain replay of DefaultPreemption (victims on
every node at once, pickOneNodeForPreemption's criteria, the eviction, the
greedy placement after it), each step judged from the state the program's
earlier steps left: it returns `snapshot_diff`, `step_diff` and
`report_diff`, and, under control.py's second dtype, `control_diff`, the
placements whose node bfloat16 scores would move."""

from __future__ import annotations

import time

from portbench import check
from portbench.program import Answer, marker, profile_of
from portbench.reference import preempt, sched


def answer(cell, data: dict, limit: int, device) -> Answer:
    from cluster_capacity_tpu_torch.framework import ClusterCapacity
    pod = data["templates"][0]
    cc = ClusterCapacity(pod, max_limit=limit, profile=profile_of(cell.config),
                         device=device)
    t0 = time.perf_counter()
    with marker("portbench.snapshot"):
        cc.sync_with_objects(data["nodes"], data["pods"])
    t1 = time.perf_counter()
    with marker("portbench.solve"):
        result = cc.run()
    t2 = time.perf_counter()
    phases = {"snapshot": t1 - t0, "run": t2 - t1}
    for part in ("encode", "solve", "evaluate", "commit"):
        phases[part] = sum(c[part] for c in cc.cycle_seconds)
    return Answer(results=[result], snapshot=cc.snapshot, phases=phases,
                  placed=result.placed_count, degraded=bool(result.degraded),
                  extra={"preemptions": list(cc.preemptions),
                         "final_snapshot": cc.post_run_snapshot})


def steps(ans: Answer) -> int:
    """Placements the traced answer made (one preemption each here)."""
    return ans.placed


def check_answer(cell, data: dict, ans: Answer, device, dtypes) -> dict:
    """snapshot_diff, step_diff and report_diff of one answer against the
    reference's replay (and control_diff with a second dtype).

    step_diff: placements off the reference's node and preemptions whose
    node or victim set differs from the reference's (or that name PDB
    violations), each from the state the program's earlier steps left, and
    steps missing or left over.  snapshot_diff: check.snapshot_diff of the
    snapshot built from the object lists, plus, in the working snapshot the
    loop left, the pods on a node that should not be there or are missing
    (evicted pods still held, placed pods not held) and the nodes whose
    charged requests differ from the reference's.  report_diff: as
    check.report_diff, against the reference's end."""
    from cluster_capacity_tpu_torch.utils.report import build_review
    pod = data["templates"][0]
    r = ans.results[0]
    names = list(r.node_names)
    placed = [names[i] if 0 <= i < len(names) else "?" for i in r.placements]
    verdict = preempt.judge(data["nodes"], data["pods"], pod, placed,
                            ans.extra["preemptions"],
                            int(cell.traffic.get("max_limit", 0)), device,
                            dtypes, pdbs=data.get("pdbs", ()))
    cluster = verdict.cluster
    expected = [(len(placed), sched.first_seen_counts(placed),
                 verdict.fail_type, verdict.fail_message)]
    got = {"snapshot_diff": check.snapshot_diff(ans.snapshot, cluster)
           + committed_diff(ans.extra["final_snapshot"], verdict, data),
           "step_diff": verdict.step_diff,
           "report_diff": check.report_diff(build_review([pod], [r]),
                                            expected)
           + check.result_fields_diff([r], expected)}
    if len(dtypes) > 1:
        got["control_diff"] = sum(verdict.control.values())
    return got


def committed_diff(snap, verdict, data: dict) -> int:
    """Pods held or missing, and nodes charged otherwise, in the working
    snapshot the loop left, against the reference's state after the last
    preemption."""
    residents = {p["metadata"]["name"] for p in data["pods"]}
    at = {name: j for j, name in enumerate(snap.node_names)}
    res = list(snap.resource_names)
    cols = [res.index(x) if x in res else None for x in sched.RESOURCES]
    diff = 0
    for i, name in enumerate(verdict.cluster.names):
        j = at.get(name)
        if j is None or None in cols:
            diff += 1
            continue
        held = [(p.get("metadata") or {}).get("name", "")
                for p in snap.pods_by_node[j]]
        want, clones = verdict.committed[i]
        diff += len(want.symmetric_difference(
            {x for x in held if x in residents}))
        diff += abs(clones - sum(1 for x in held if x not in residents))
        used = tuple(int(snap.requested[j, c]) for c in cols)
        nz = tuple(int(v) for v in snap.nonzero_requested[j])
        diff += int(used != tuple(int(v) for v in verdict.committed_used[i])
                    or nz != tuple(int(v)
                                   for v in verdict.committed_nonzero[i]))
    return diff

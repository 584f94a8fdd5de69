"""Entry `spread_soft`: one capacity question about a pod with soft
(ScheduleAnyway) topology spread constraints, as upstream's CLI asks it:
entry `estimate`'s `answer` and `steps` (framework.ClusterCapacity: sync
the object lists into its own snapshot, run, the result in hand).

`check_answer` holds the answer to reference/spread_soft.py, the plain
replay of the greedy loop with PodTopologySpread's Score and
NormalizeScore added to what reference/sched.py models, each step judged
from the state that the program's earlier placements left.  It returns
`snapshot_diff` (check.snapshot_diff of the snapshot built from the object
lists), `step_diff` (placements off the reference's node, or made where
no node was feasible, and a sequence that ends where the reference goes
on or goes on where it stops), `report_diff` (check.report_diff and the
result's own fail type and message against the reference's end) and,
under control.py's second dtype, `control_diff`: the placements whose
node the reference computed in that dtype would move."""

from __future__ import annotations

from portbench import check
from portbench.entries.estimate import answer, steps  # noqa: F401
from portbench.program import Answer
from portbench.reference import sched, spread_soft


def check_answer(cell, data: dict, ans: Answer, device, dtypes) -> dict:
    """snapshot_diff, step_diff and report_diff of one answer against
    reference/spread_soft.py (and control_diff with a second dtype)."""
    from cluster_capacity_tpu_torch.utils.report import build_review
    pod = data["templates"][0]
    r = ans.results[0]
    limit = int(cell.traffic.get("max_limit", 0))
    verdict = spread_soft.judge(data["nodes"], data["pods"], pod,
                                r.node_names, r.placements, limit, device,
                                dtypes)
    names = verdict.cluster.names
    placed = [names[i] if i >= 0 else "?" for i in verdict.seq_n]
    expected = [(len(placed), sched.first_seen_counts(placed),
                 verdict.fail_type, verdict.fail_message)]
    got = {"snapshot_diff": check.snapshot_diff(ans.snapshot,
                                                verdict.cluster),
           "step_diff": verdict.off[dtypes[0]] + int(not verdict.ended),
           "report_diff": check.report_diff(build_review([pod], [r]),
                                            expected)
           + check.result_fields_diff([r], expected)}
    if len(dtypes) > 1:
        got["control_diff"] = sum(verdict.off[dt] for dt in dtypes[1:])
    return got

"""The comparison that decides `correct`: the program's answers against the
plain reference (reference/sched.py), which encodes the same object lists
itself and replays the program's placements step by step.

Numbers compared, each an exact count with the limit 0:

- snapshot_diff: nodes whose place in the program's node order, whose
  allocatable (cpu, memory, pods), resident requests or non-zero requests
  differ from the reference's encoding of the same objects;
- step_diff: placements whose node is not the reference's choice from the
  state the placements before them left (or were made where no node was
  feasible), plus each template whose sequence ends where the reference
  would go on, or goes on where it would stop;
- report_diff: fields of the program's report (total replicas, each
  template's per-node replicas in first-placement order, fail type and
  fail message) that differ from what the reference expects;
- answers_diff: answers of the window whose counts or fail types differ
  from those of the answers checked in full.

An entry whose objects this reference does not model brings its own
comparison: a `check_answer(cell, data, ans, device, dtypes)` in the
entry's module, which returns the same numbers (`judge_for`); what it
returns is held to their shape (`fault_of`) before it counts.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .reference import sched

LIMITS = {"snapshot_diff": 0, "step_diff": 0, "report_diff": 0,
          "answers_diff": 0}
JUDGED = ("snapshot_diff", "step_diff", "report_diff")


@dataclass
class Judgement:
    """One placement sequence for the reference to replay: the templates it
    draws from (indices into the asked templates), per step the template and
    the reference's node index, and per template its program result and
    limit."""
    templates: List[int]
    seq_k: np.ndarray
    seq_n: np.ndarray
    results: List[object]
    limit: int
    total_limit: int = 0


def _end(pb: sched.Problem, state: sched.State, jd: Judgement,
         local: int) -> Tuple[bool, str, str]:
    """(ended where it had to, fail type, fail message) of one template.
    Under a total limit (a race) every template is still in the queue when
    the total is reached: the reference found a feasible node at each of its
    pops.  A race that stops short of the total parked templates, which
    this reference does not model: judged an error."""
    if jd.total_limit:
        ok = len(jd.seq_k) == jd.total_limit
        return (ok, "LimitReached",
                f"Maximum number of pods simulated: {jd.total_limit}")
    placed = int((jd.seq_k == local).sum())
    return sched.expected_end(pb, state, local, placed, jd.limit)


def node_index(result, cluster: sched.Cluster) -> np.ndarray:
    """The program's placements as the reference's node indices (-1 for a
    name the reference does not know)."""
    names = result.node_names
    lookup = np.array([cluster.index.get(nm, -1) for nm in names], np.int64)
    p = np.asarray(result.placements, np.int64)
    if p.size and (p.min() < 0 or p.max() >= len(names)):
        return np.full(p.shape, -1, np.int64)
    return lookup[p]


def snapshot_diff(snapshot, cluster: sched.Cluster) -> int:
    """Nodes whose position or encoded numbers differ from the
    reference's."""
    diff = sched.check_order(snapshot.node_names, cluster)
    res = list(snapshot.resource_names)
    cols = [res.index(r) if r in res else None for r in sched.RESOURCES]
    rows = sched.node_rows(cluster)
    for i, name in enumerate(snapshot.node_names):
        ref = rows.get(name)
        if ref is None or None in cols:
            diff += 1
            continue
        alloc = tuple(int(snapshot.allocatable[i, c]) for c in cols)
        used = tuple(int(snapshot.requested[i, c]) for c in cols)
        nz = tuple(int(v) for v in snapshot.nonzero_requested[i])
        if (alloc, used, nz) != ref:
            diff += 1
    return diff


def judge(pb: sched.Problem, jd: Judgement,
          dtypes=(torch.float32,)) -> Tuple[Dict, int, sched.State]:
    """({dtype: steps whose choice differs from the program's}, end
    errors, the state after the sequence) of one sequence.  For a dtype
    other than the first, the count is of steps where that dtype's choice differs from the first's: the
    lower precision put in the program's place."""
    bad = jd.seq_n < 0
    seq_n = np.where(bad, 0, jd.seq_n)
    choices, state = sched.judge(pb, jd.seq_k, seq_n, dtypes=dtypes)
    base = choices[dtypes[0]]
    out = {dtypes[0]: int(((base != seq_n) | bad).sum())}
    for dt in dtypes[1:]:
        out[dt] = int((choices[dt] != base).sum())
    ends = sum(0 if _end(pb, state, jd, local)[0] else 1
               for local in range(len(jd.results)))
    return out, ends, state


def expected_report(pb: sched.Problem, state_for, jd: Judgement,
                    cluster: sched.Cluster) -> List[tuple]:
    """Per template: (placed, per-node replicas in first-placement order,
    fail type, fail message) as the reference expects them."""
    out = []
    for local, _res in enumerate(jd.results):
        mine = jd.seq_n[jd.seq_k == local]
        names = [cluster.names[i] if i >= 0 else "?" for i in mine]
        _ok, ftype, msg = _end(pb, state_for, jd, local)
        out.append((len(mine), sched.first_seen_counts(names), ftype, msg))
    return out


def report_diff(review, expected: Sequence[tuple]) -> int:
    """Fields of the program's review that differ from the expectation."""
    diff = int(review.replicas != sum(e[0] for e in expected))
    for pod, exp in zip(review.pods, expected):
        got = [(r.node_name, r.replicas) for r in pod.replicas_on_nodes]
        diff += int(got != exp[1])
    diff += abs(len(review.pods) - len(expected))
    first = expected[0] if expected else None
    if first is not None:
        diff += int(review.fail_type != first[2])
        diff += int(review.fail_message != first[3])
    return diff


def result_fields_diff(results, expected: Sequence[tuple]) -> int:
    """Each template's own fail type and message against the expectation
    (the review carries the first template's only)."""
    return sum(int(r.fail_type != e[2]) + int(r.fail_message != e[3])
               for r, e in zip(results, expected))


def check_answer(answer, judgements: List[Judgement], asked: List[dict],
                 cluster: sched.Cluster, device,
                 dtypes=(torch.float32,)) -> Dict[str, int]:
    """snapshot_diff, step_diff and report_diff of one answer (with more
    dtypes: control_diff, the lower precision's departures)."""
    from cluster_capacity_tpu_torch.utils.report import build_review
    out = {"snapshot_diff": snapshot_diff(answer.snapshot, cluster),
           "step_diff": 0, "report_diff": 0}
    control = 0
    expected_all: List[tuple] = [None] * len(asked)
    for jd in judgements:
        templates = [sched.encode_template(asked[t]) for t in jd.templates]
        pb = sched.Problem(cluster, templates, device=device)
        diffs, ends, state = judge(pb, jd, dtypes)
        out["step_diff"] += diffs[dtypes[0]] + ends
        for dt in dtypes[1:]:
            control += diffs[dt]
        exp = expected_report(pb, state, jd, cluster)
        for t, e in zip(jd.templates, exp):
            expected_all[t] = e
        out["report_diff"] += result_fields_diff(jd.results, exp)
    review = build_review(asked, answer.results)
    out["report_diff"] += report_diff(review, expected_all)
    if len(dtypes) > 1:
        out["control_diff"] = control
    return out


def summary_of(results) -> tuple:
    """What every answer of the window is compared on."""
    return tuple((r.placed_count, r.fail_type) for r in results)


def judge_for(entry, cell, data: dict, device,
              dtypes=(torch.float32,)) -> Callable[[object], Dict[str, int]]:
    """The comparison of one cell's answers: the entry's own check_answer
    where it defines one, else check_answer above against the reference's
    encoding of the object lists."""
    own = getattr(entry, "check_answer", None)
    if own is not None:
        return lambda ans: own(cell, data, ans, device, dtypes)
    cluster = sched.Cluster(data["nodes"], data["pods"])
    return lambda ans: check_answer(
        ans, entry.judgements(cell, data, ans, cluster), data["templates"],
        cluster, device, dtypes)


def fault_of(got, dtypes=(torch.float32,)) -> Optional[str]:
    """What is wrong with a comparison's result, or None: it must hold
    exactly JUDGED (and control_diff with more than one dtype), each an
    integer."""
    if not isinstance(got, dict):
        return f"returned {type(got).__name__}, not a dict"
    want = set(JUDGED) | ({"control_diff"} if len(dtypes) > 1 else set())
    faults = [f"lacks {k}" for k in sorted(want - set(got))]
    faults += [f"holds {k}, which is not compared" for k in
               sorted(set(got) - want)]
    faults += [f"{k} is {type(got[k]).__name__}, not an integer"
               for k in sorted(want & set(got))
               if isinstance(got[k], bool)
               or not isinstance(got[k], (int, np.integer))]
    return "; ".join(faults) or None

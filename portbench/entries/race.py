"""Entry `race`: a template mix racing through one scheduling queue over
shared capacity (parallel/interleave.sweep_interleaved_auto on a snapshot
built from the object lists), up to a total number of pops."""

from __future__ import annotations

import time

import numpy as np

from portbench import check, trace
from portbench.program import Answer, marker, profile_of


def answer(cell, data: dict, limit: int, device) -> Answer:
    from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot
    from cluster_capacity_tpu_torch.parallel.interleave import \
        sweep_interleaved_auto
    t0 = time.perf_counter()
    with marker("portbench.snapshot"):
        snap = ClusterSnapshot.from_objects(data["nodes"], data["pods"])
    t1 = time.perf_counter()
    with marker("portbench.solve"):
        results = sweep_interleaved_auto(
            snap, data["templates"], profile=profile_of(cell.config),
            max_total=limit, device=device)
    t2 = time.perf_counter()
    return Answer(results=results, snapshot=snap,
                  phases={"snapshot": t1 - t0, "run": t2 - t1},
                  placed=sum(r.placed_count for r in results),
                  degraded=any(bool(r.degraded) for r in results))


def judgements(cell, data: dict, ans: Answer, cluster) -> list:
    """The queue's pop order: equal priorities, each binding puts the
    template's next clone at the tail, so while no template parks the pops
    go round the templates in order.  Pop j is template j mod T's
    (j div T)-th placement; a template with fewer placements than that
    order gives it ends the sequence there, and the reference judges the
    rest as missing."""
    results = ans.results
    t_n = len(results)
    mapped = [check.node_index(r, cluster) for r in results]
    total = sum(len(m) for m in mapped)
    seq_k, seq_n = [], []
    for j in range(total):
        t, i = j % t_n, j // t_n
        seq_k.append(t)
        seq_n.append(mapped[t][i] if i < len(mapped[t]) else -1)
    return [check.Judgement(templates=list(range(t_n)),
                            seq_k=np.asarray(seq_k, np.int64),
                            seq_n=np.asarray(seq_n, np.int64),
                            results=list(results), limit=0,
                            total_limit=int(cell.traffic.get("max_limit",
                                                             0)))]


def traced(cell, data: dict, device):
    """(Answer, TraceSummary) of one whole study of max_limit pops with the
    profiler on over a steady stretch of it: the whole chunks of the queue
    engine that start from step trace_from on, until trace_steps steps have
    run (past the snapshot, the encode and the first chunks; a study's
    whole trace is millions of kernel events).  The stretch is found by the
    chunks' lengths alone, so the hook adds no device work; the slice's
    steps are the pops the stretch made, counted once it has closed."""
    from cluster_capacity_tpu_torch.engine import simulator
    mix = cell.traffic
    start, length = int(mix["trace_from"]), int(mix["trace_steps"])
    real = simulator.run_steps
    sl = trace.Slice(solve=True)
    steps, outs = [0], []           # steps run so far; chunks in the slice

    def run_steps(step, cfg, consts, state, k):
        if sl.prof is None and sl.summary is None and steps[0] >= start:
            sl.begin()
            steps[0] = 0
        elif sl.prof is not None and steps[0] >= length:
            sl.end()
        state, out = real(step, cfg, consts, state, k)
        ts = out[0] if isinstance(out, tuple) else out
        steps[0] += int(ts.shape[0])
        if sl.prof is not None:
            outs.append(ts)
        return state, out

    simulator.run_steps = run_steps
    try:
        ans = answer(cell, data, int(mix.get("max_limit", 0)), device)
    finally:
        simulator.run_steps = real
    if sl.prof is not None:         # the study ended inside the stretch
        sl.end()
    if sl.summary is None:
        raise ValueError(f"the study ended before step {start}: no slice")
    sl.summary.steps = sum(int((ts >= 0).sum()) for ts in outs)
    return ans, sl.summary

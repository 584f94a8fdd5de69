"""Entry `estimate`: one capacity question as upstream's CLI asks it, how
many more copies of one pod fit (framework.ClusterCapacity: sync the
object lists into its own snapshot, run, the result in hand)."""

from __future__ import annotations

import time

import numpy as np

from portbench import check
from portbench.program import Answer, marker, profile_of


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
                  placed=result.placed_count, degraded=bool(result.degraded))


def judgements(cell, data: dict, ans: Answer, cluster) -> list:
    r = ans.results[0]
    seq_n = check.node_index(r, cluster)
    return [check.Judgement(templates=[0],
                            seq_k=np.zeros(len(seq_n), np.int64),
                            seq_n=seq_n, results=[r],
                            limit=int(cell.traffic.get("max_limit", 0)))]


def steps(ans: Answer) -> int:
    """Placement steps the traced answer took."""
    return ans.placed

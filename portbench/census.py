#!/usr/bin/env python3
"""Where upstream's PodTopologySpread arithmetic departs from the
program's over whole answers of a cell with soft spreads, on the card.

    python3 portbench/census.py --workload <cell> --seeds <n> [<n> ...]

From the root of a checkout.  For each seed it makes the cell's objects,
asks one whole question through the program as a run's window does, and
replays the program's placements with reference/spread_soft.census: the
steps at which upstream's float64 score, math.Round and int64
normalisation give another raw or normalised score than the float32 the
program computes, and the steps at which the choice would move.  It prints
the kernel drive's span attrs (the route and the launch plan) beside
them, one JSON line per seed.  The benchmark's own runs never run this.
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def readings(cell, seed: int, device) -> dict:
    import torch

    from cluster_capacity_tpu_torch.obs import spans as obs_spans
    from portbench import harness
    from portbench.reference import cluster as gen
    from portbench.reference import spread_soft
    entry = harness.load_module("entries", cell.traffic["entry"])
    data = gen.make_objects(cell.config, cell.traffic, seed)
    obs_spans.default_collector.reset()
    ans = entry.answer(cell, data, int(cell.traffic.get("max_limit", 0)),
                       device)
    launches = [dict(s.attrs) for s in obs_spans.default_collector.spans()
                if s.name == "fused.launch"]
    r = ans.results[0]
    t0 = time.perf_counter()
    q = spread_soft.question(data["nodes"], data["pods"],
                             data["templates"][0], device)
    seq = spread_soft.node_sequence(q, r.node_names, r.placements)
    got = spread_soft.census(q, seq)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return dict(got, seed=seed, placed=ans.placed, rung=r.rung,
                degraded=bool(ans.degraded), launches=launches,
                census_s=time.perf_counter() - t0)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench import run
    run._caches(ROOT)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    import torch

    from portbench import harness
    if not torch.cuda.is_available():
        print("census: no CUDA device", file=sys.stderr)
        return 1
    cell = harness.load_cell(bench, args.workload)
    for seed in args.seeds:
        print(json.dumps(dict(readings(cell, seed, torch.device("cuda", 0)),
                              workload=cell.name)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The readings the limits of `correct` are set from, at a cell's own size.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]

From the root of a checkout, on the card.  For each seed it makes the
cell's objects, asks one whole question through the program as a run's
window does, and judges the answer with the plain reference twice: in the
float32 arithmetic the configuration states (the program's readings:
snapshot_diff, step_diff, report_diff), and in bfloat16, the nearest
precision below, put in the program's place (control_diff: the steps whose
choice the lower precision takes elsewhere, on the same placements).  An
entry with its own check_answer is judged by it, given both dtypes.  One
JSON line per seed.  The benchmark's own runs never run this.
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def readings(cell, seed: int, device, dirs=None) -> dict:
    import torch

    from portbench import check, harness
    from portbench.reference import cluster as gen
    dirs = dirs or {}
    entry = harness.load_module("entries", cell.traffic["entry"],
                                dirs.get("entries"))
    data = gen.make_objects(cell.config, cell.traffic, seed)
    t0 = time.perf_counter()
    ans = entry.answer(cell, data, int(cell.traffic.get("max_limit", 0)),
                       device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    dtypes = (torch.float32, torch.bfloat16)
    got = check.judge_for(entry, cell, data, device, dtypes)(ans)
    fault = check.fault_of(got, dtypes)
    if fault:
        got = {"malformed": fault}
    return dict(got, seed=seed, placed=ans.placed, answer_s=t1 - t0,
                check_s=time.perf_counter() - t1,
                rungs=sorted({r.rung for r in ans.results}))


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
        print("control: no CUDA device", file=sys.stderr)
        return 1
    cell = harness.load_cell(bench, args.workload)
    for seed in args.seeds:
        print(json.dumps(dict(readings(cell, seed, torch.device("cuda", 0)),
                              workload=cell.name)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

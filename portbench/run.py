#!/usr/bin/env python3
"""Run one cell of the benchmark of cluster_capacity_tpu_torch once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up makes the cell's objects from the seed
and warms its route up; the window then asks whole questions back to back
(a closed loop of one client) for --seconds, the answer in flight running
to its end; the sampled answers are then checked against the plain
reference.  The last line of standard output is the result: with --trace 0
the cell's end-to-end metrics, with --trace 1 its per-layer metrics read
from the window's spans and from one more answer run under the profiler
(the whole answer, or the steady stretch of it that its entry picks).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PACKAGE = "cluster_capacity_tpu_torch"


def _caches(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = os.path.join(root, "build")
    os.environ["CC_TORCH_BUILD_DIR"] = os.path.join(build, "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")


def run_cell(cell, seed: int, seconds: float, traced: bool, device,
             t0: float, dirs=None, out=None) -> int:
    """Set up, run the window, trace, check and print the result line."""
    import torch

    from portbench import check, harness, trace
    from portbench.reference import cluster as gen
    from portbench.reference import sched

    dirs = dirs or {}
    out = out or sys.stdout
    log = lambda msg: print(f"portbench: {msg}", file=sys.stderr, flush=True)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    traffic = cell.traffic
    entry = harness.load_module("entries", traffic["entry"],
                                dirs.get("entries"))
    limit = int(traffic.get("max_limit", 0))

    data = gen.make_objects(cell.config, cell.traffic, seed)
    t_warm = time.perf_counter()
    warm = entry.answer(cell, data, int(traffic.get("warmup_limit", limit)),
                        device)
    sync()
    log(f"objects {t_warm - t0:.3f} s after start, warm-up answer "
        f"{time.perf_counter() - t_warm:.3f} s ({warm.placed} placements, "
        f"rungs {sorted({r.rung for r in warm.results})})")
    del warm
    gc.collect()                 # every window starts from a swept heap

    gc_s = [0.0, 0.0]            # seconds in collections, start of one

    def gc_timer(phase, _info):
        if phase == "start":
            gc_s[1] = time.perf_counter()
        else:
            gc_s[0] += time.perf_counter() - gc_s[1]
    gc.callbacks.append(gc_timer)
    start = time.perf_counter()
    setup_s = start - t0
    records = []
    sample = harness.Reservoir(int(traffic.get("check_answers", 1)), seed)
    raised = 0
    while True:
        a0 = time.perf_counter()
        try:
            ans = entry.answer(cell, data, limit, device)
        except Exception:            # an answer that raises counts, the
            ans = None               # window goes on
            raised += 1
            if raised <= 3:
                traceback.print_exc()
        a1 = time.perf_counter()
        records.append(harness.AnswerRecord(
            index=len(records), start=a0, end=a1,
            placed=ans.placed if ans else 0,
            failed=ans is None or ans.degraded,
            phases=dict(ans.phases) if ans else {},
            summary=check.summary_of(ans.results) if ans else None))
        if ans is not None:
            sample.offer((len(records) - 1, ans))
        del ans
        if a1 - start >= seconds:
            break
    window_s = records[-1].end - start
    gc.callbacks.remove(gc_timer)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    info = harness.RunInfo(cell=cell, window_s=window_s, answers=records,
                           setup_s=setup_s)
    first = data["templates"][0]
    info.shapes = {
        "nodes": len(data["nodes"]), "resources": len(sched.RESOURCES),
        "hard_spreads": len((first.get("spec") or {}).get(
            "topologySpreadConstraints") or []),
        "kind": torch.cuda.get_device_name(device) if on_card else "cpu"}
    device_rec = {"platform": "gpu" if on_card else "cpu",
                  "kind": info.shapes["kind"], "count": cell.chips,
                  "memory_peak_bytes": int(peak)}
    breakdown = None
    if traced:
        if hasattr(entry, "traced"):     # the entry picks its own slice
            tans, summary = entry.traced(cell, data, device)
        else:
            tlimit = int(traffic.get("trace_limit", limit))
            tans, summary = trace.capture(
                lambda: entry.answer(cell, data, tlimit, device))
            summary.steps = entry.steps(tans)
        del tans
        info.trace = summary
        device_rec["busy_s"] = summary.busy_s
        device_rec["window_s"] = summary.window_s
        breakdown = {"device_ops": summary.device_ops,
                     "idle_gaps": summary.idle_gaps}
        log(f"traced answer: {summary.steps} steps, busy {summary.busy_s:.6f}"
            f" of {summary.window_s:.6f} s, solve busy "
            f"{summary.solve_busy_s:.6f} s, {summary.solve_kernels} kernels")
        metrics = harness.read_metrics(cell, info, dirs.get("metrics"))
    else:
        metrics = harness.read_metrics(cell, info, dirs.get("metrics"),
                                       end_to_end=True)
    for phase in ("snapshot", "encode", "solve", "evaluate", "commit",
                  "run"):
        ms = info.phase_ms(phase)
        if ms is not None:
            log(f"mean {phase} {ms:.3f} ms per answer")
    log(f"{len(records)} answers in {window_s:.3f} s, "
        f"{sum(r.placed for r in records)} placements, {raised} raised, "
        f"{sum(r.failed for r in records)} failed, {gc_s[0]:.3f} s in the "
        f"garbage collector; answers (s): "
        f"{' '.join(f'{r.end - r.start:.3f}' for r in records)}")

    # the program's state goes before the reference runs
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    judge = check.judge_for(entry, cell, data, device)
    checks = {k: 0 for k in check.LIMITS}
    malformed = 0
    expected = None
    for i, ans in sample.items:
        got = judge(ans)
        fault = check.fault_of(got)
        if fault:
            malformed += 1
            log(f"the check of answer {i} is malformed: {fault}")
            continue
        for k, v in got.items():
            checks[k] += v
        if expected is None or not any(got.values()):
            expected = check.summary_of(ans.results)
    checks["answers_diff"] = sum(1 for r in records if r.summary is not None
                                 and r.summary != expected)
    log(f"checked {len(sample.items)} of {len(records)} answers in full "
        f"in {time.perf_counter() - t_check:.3f} s")
    correct = (bool(sample.items) and raised == 0 and malformed == 0 and
               all(checks[k] <= lim for k, lim in check.LIMITS.items()))

    found = harness.loaded_forbidden()
    if found:
        log(f"modules that must not load were loaded: {', '.join(found)}")
        return 3
    shown = {k: {"value": checks[k], "limit": lim}
             for k, lim in check.LIMITS.items()}
    if malformed:
        shown["malformed_checks"] = {"value": malformed, "limit": 0}
    for k, v in shown.items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(harness.result_line(correct, len(records),
                              sum(r.failed for r in records), metrics,
                              device_rec, shown, breakdown), file=out,
          flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, PACKAGE)):
        print(f"portbench: {PACKAGE} is not in {ROOT}: run from the root of "
              f"a full checkout", file=sys.stderr)
        return 2
    _caches(ROOT)
    sys.path.insert(0, ROOT)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    from portbench import harness
    cell = harness.load_cell(bench, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    return run_cell(cell, args.seed, args.seconds, bool(args.trace),
                    torch.device("cuda", 0), T0)


if __name__ == "__main__":
    sys.exit(main())

"""`hypercc profile`: run a named scenario under deep-profiling capture.

Two tables on stdout:

1. attribution — the site × rung × phase device-time/memory split of the
   scenario's guarded dispatches (obs/profile.py), under a torch.profiler
   trace when --profile-out is given;
2. calibration — every canonical entry of the port (obs/entries.py, the
   JAX ladder's names and shapes) driven on the device and timed
   best-of-reps, joined against the static FLOPs/live-bytes budgets
   (tools/irgate/budgets.json, read as data) into per-entry efficiency
   ratios (obs/costmodel.py).  Skipped with --no-calibrate; without the
   budgets file every entry reports "no measurement".

Scenarios are tiny synthetic clusters solved through the production guarded
path (framework / parallel sweep / resilience analyzer) on the card unless
--device cpu, so the attribution rows exercise the same sites a real run
would.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional

ENV_REPS = "CC_PROFILE_REPS"
DEFAULT_REPS = 2

SCENARIOS = ("solve", "sweep", "resilience")


def build_parser(prog: str = "profile") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=prog,
        description=("Deep profiling: run a named scenario under capture, "
                     "print the device-time/memory attribution table and "
                     "the cost-model calibration report."))
    p.add_argument("scenario", nargs="?", default="solve",
                   choices=SCENARIOS,
                   help="Named scenario to run under capture: a single "
                        "guarded solve, a multi-template sweep, or a "
                        "single-node-failure resilience sweep.")
    p.add_argument("--nodes", type=int, default=24,
                   help="Synthetic cluster size (default 24).")
    p.add_argument("--templates", type=int, default=4,
                   help="Pod templates in the sweep scenario (default 4).")
    p.add_argument("--max-limit", dest="max_limit", type=int, default=64,
                   help="Per-solve placement cap (default 64).")
    p.add_argument("--profile-out", dest="profile_out", default="",
                   metavar="DIR",
                   help="Write the torch.profiler trace plus "
                        "attribution.json and calibration.json artifacts to "
                        "DIR.")
    p.add_argument("--flight-dir", dest="flight_dir", default="",
                   metavar="DIR",
                   help="Arm the fault flight recorder for the scenario "
                        "run (obs/flight.py).")
    p.add_argument("--inject-fault", dest="inject_fault", action="append",
                   default=[], metavar="SITE:KIND[:AT[:TIMES]]",
                   help="Chaos testing: inject a deterministic fault while "
                        "profiling (runtime/faults.py syntax).")
    p.add_argument("--no-calibrate", dest="no_calibrate",
                   action="store_true",
                   help="Skip the canonical-entry calibration pass (the "
                        "scenario attribution table only).")
    p.add_argument("--calibrate-reps", dest="calibrate_reps", type=int,
                   default=0,
                   help=f"Timed repetitions per canonical entry (default "
                        f"${ENV_REPS} or {DEFAULT_REPS}; a first untimed "
                        f"run builds the kernels and captures the graphs).")
    p.add_argument("-o", "--output", default="",
                   help="Output format. One of: json (machine-readable "
                        "attribution + calibration instead of tables).")
    p.add_argument("--device", default="cuda",
                   help="Device to run on: cuda (default) or cpu.")
    return p


def _make_node(name: str, milli_cpu: int, mem: int, pods: int,
               labels: Optional[dict] = None) -> dict:
    alloc = {"cpu": f"{milli_cpu}m", "memory": str(mem), "pods": str(pods)}
    return {"metadata": {"name": name, "labels": dict(labels or {})},
            "spec": {},
            "status": {"allocatable": alloc, "capacity": dict(alloc)}}


def _make_pod(name: str, milli_cpu: int, mem: int) -> dict:
    return {"metadata": {"name": name, "namespace": "default"},
            "spec": {"containers": [{
                "name": "c0", "image": "img",
                "resources": {"requests": {"cpu": f"{milli_cpu}m",
                                           "memory": str(mem)}}}]}}


def _snapshot(n: int):
    from ..models.snapshot import ClusterSnapshot
    nodes = [_make_node(f"node-{i}", 2000 + 100 * (i % 7), int(4e9), 32,
                        labels={"zone": f"z{i % 3}"}) for i in range(n)]
    return ClusterSnapshot.from_objects(nodes, [])


def _run_scenario(name: str, args, device) -> None:
    """Drive one scenario through the production guarded path."""
    from ..models.podspec import default_pod
    from ..utils.config import SchedulerProfile
    profile = SchedulerProfile()
    snapshot = _snapshot(args.nodes)
    if name == "solve":
        from ..framework import ClusterCapacity
        cc = ClusterCapacity(default_pod(_make_pod("probe", 300, int(5e7))),
                             max_limit=args.max_limit, profile=profile,
                             device=device)
        cc.set_snapshot(snapshot)
        cc.run()
        return
    if name == "sweep":
        from ..parallel.sweep import sweep
        pods = [default_pod(_make_pod(f"probe-{i}", 200 + 100 * i, int(5e7)))
                for i in range(max(1, args.templates))]
        sweep(snapshot, pods, profile=profile, max_limit=args.max_limit,
              device=device)
        return
    from ..resilience import analyze, single_node_scenarios
    probe = default_pod(_make_pod("probe", 300, int(5e7)))
    analyze(snapshot, single_node_scenarios(snapshot), probe,
            profile=profile, max_limit=args.max_limit, device=device)


def _measure_entries(reps: int, device) -> Dict[str, Dict]:
    """Time every canonical entry on `device`: one warmup drive (kernel
    build, graph captures), then best-of-`reps` timed drives, each ending
    with a torch.cuda.synchronize() on the card.  On the card the
    allocator's peak is reset before each entry, so its watermark is the
    entry's own."""
    import torch

    from ..obs import entries
    from ..obs import profile as obs_profile
    from ..obs import recompile as rc

    def drive(spec):
        spec.driver(device)
        if device.type == "cuda":
            torch.cuda.synchronize()

    measured: Dict[str, Dict] = {}
    for spec in entries.canonical_entries():
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        # the warmup call pays the entry's build and capture cost — tally it
        # so the calibration artifact attributes compile seconds per entry
        with rc.CompileTally() as tally:
            drive(spec)
        best = None
        for _ in range(max(1, reps)):
            t0 = time.perf_counter()
            drive(spec)
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        entry: Dict = {"device_s": best, "rung": spec.rung,
                       "compile_s": round(tally.seconds, 6)}
        peak = obs_profile.sample_watermark()
        if peak is not None:
            entry["mem_peak_bytes"] = peak
        measured[spec.name] = entry
    return measured


def run(argv: Optional[List[str]] = None, prog: str = "profile") -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    args = build_parser(prog).parse_args(argv)
    if args.output not in ("", "json"):
        print(f"Error: output format {args.output!r} not recognized",
              file=sys.stderr)
        return 1

    if args.inject_fault:
        from ..runtime import faults
        try:
            faults.install_text(args.inject_fault)
        except ValueError as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1
    if args.flight_dir:
        from ..obs import flight
        flight.install(args.flight_dir, argv=prog.split() + argv)

    from ..engine.simulator import resolve_device
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1

    import torch

    from .. import obs
    from ..obs import costmodel, entries
    from ..obs import profile as obs_profile
    obs.install_recompile_hook()

    with obs_profile.capture(args.profile_out or None, memory=True):
        _run_scenario(args.scenario, args, device)
    rows = obs_profile.attribution()

    report = None
    if not args.no_calibrate:
        reps = args.calibrate_reps or int(
            os.environ.get(ENV_REPS, DEFAULT_REPS) or DEFAULT_REPS)
        measured = _measure_entries(reps, device)
        print(f"calibration: the JAX ladder's "
              f"{', '.join(sorted(entries.MISSING))} wait for later port "
              f"slices", file=sys.stderr)
        platform = (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu")
        report = costmodel.calibrate(measured, costmodel.load_budgets(),
                                     platform=platform)
        costmodel.to_registry(report)

    if args.profile_out:
        obs_profile.write_attribution(
            os.path.join(args.profile_out, "attribution.json"), rows,
            extra={"scenario": args.scenario})
        if report is not None:
            costmodel.write_calibration(
                os.path.join(args.profile_out, "calibration.json"), report)

    if args.output == "json":
        doc = {"scenario": args.scenario, "attribution": rows}
        if report is not None:
            doc["calibration"] = report
        print(json.dumps(doc, indent=2))
        return 0

    print(f"scenario: {args.scenario} ({args.nodes} nodes)\n")
    print(obs_profile.render_attribution(rows))
    if report is not None:
        print(costmodel.render_calibration(report))
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()

"""resilience CLI front-end: batched N-k failure sweeps on the card.

Offline-only (a failure sweep is a what-if study): cluster state comes from
--snapshot (YAML/JSON objects or a .npz checkpoint), scenarios from the
mode flags, and the probe template from --podspec (defaulting to a small
100m/200Mi pod — the scheduler's NonZeroRequested defaults).  Emits the
survivability report through utils/report.print_survivability in table,
json, or yaml form.  --device cpu runs the plain PyTorch versions; --mesh
BxN shards the batched scenario solves and the bracket shots over a
device mesh (parallel/mesh.py).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from ..models.podspec import default_pod, parse_pod_text, validate_pod
from ..utils.config import SchedulerProfile, load_scheduler_config
from ..utils.report import print_survivability
from ..utils.snapshot_io import load_snapshot_objects
from .cluster_capacity import _read_podspec

# the scheduler's NonZeroRequested defaults (util.DefaultMilliCPURequest /
# DefaultMemoryRequest) — a probe that fits wherever anything fits
_DEFAULT_PROBE = {
    "metadata": {"name": "resilience-probe"},
    "spec": {"containers": [{
        "name": "probe",
        "resources": {"requests": {"cpu": "100m", "memory": "200Mi"}},
    }]},
}


def build_parser(prog: str = "resilience") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=prog,
        description=("Survivability analysis: for each failure scenario, "
                     "drain + re-schedule the displaced pods onto the "
                     "survivors and measure the remaining probe headroom."))
    p.add_argument("--snapshot", default="", required=False,
                   help="Path to a cluster-snapshot YAML/JSON file or .npz "
                        "checkpoint (required).")
    p.add_argument("--podspec", default="",
                   help="Path to JSON or YAML probe pod definition "
                        "(http(s):// URLs accepted). Default: a 100m/200Mi "
                        "probe pod.")
    p.add_argument("--nodes", action="store_true",
                   help="Every single-node failure (the default mode when "
                        "no other scenario flag is given).")
    p.add_argument("--zones", nargs="?", const="topology.kubernetes.io/zone",
                   default="", metavar="LABEL_KEY",
                   help="One scenario per distinct value of a topology "
                        "label key (default key: topology.kubernetes.io/"
                        "zone).")
    p.add_argument("--random-k", dest="random_k", type=int, default=0,
                   help="Random N-k sampling: fail k nodes at a time.")
    p.add_argument("--samples", type=int, default=16,
                   help="Number of random N-k samples (with --random-k).")
    p.add_argument("--seed", type=int, default=0,
                   help="RNG seed for --random-k sampling.")
    p.add_argument("--drain", action="append", default=[],
                   help="Explicit drain list: comma-separated node names "
                        "failed together. May be repeated, one scenario "
                        "each.")
    p.add_argument("--max-limit", dest="max_limit", type=int, default=0,
                   help="Cap the per-scenario headroom count. By default "
                        "unlimited.")
    p.add_argument("--default-config", dest="default_config", default="",
                   help="Path to KubeSchedulerConfiguration file.")
    p.add_argument("--parity", action="store_true",
                   help="Bit-exact kube-scheduler score arithmetic "
                        "(float64).")
    p.add_argument("--explain", action="store_true",
                   help="Annotate every scenario with the degraded "
                        "cluster's bottleneck analysis (binding resource "
                        "dimension, remaining-capacity delta vs the intact "
                        "baseline).")
    p.add_argument("--no-dedup", dest="no_dedup", action="store_true",
                   help="Solve every scenario separately instead of "
                        "collapsing symmetric single-node failures.")
    p.add_argument("--no-bounds", dest="no_bounds", action="store_true",
                   help="Disable bound-guided pruning and budget "
                        "right-sizing (bounds/bracket.py): every scenario "
                        "runs an exact device solve even when its capacity "
                        "bracket already proves the row.")
    p.add_argument("--verbose", action="store_true", help="Verbose mode")
    p.add_argument("-o", "--output", default="",
                   help="Output format. One of: json|yaml.")
    p.add_argument("--journal", default="",
                   help="Path to a per-scenario result journal: completed "
                        "scenarios append as they finish, so a killed sweep "
                        "can continue with --resume instead of restarting.")
    p.add_argument("--resume", action="store_true",
                   help="With --journal: skip scenarios already completed "
                        "in the journal (fingerprint-checked — the probe, "
                        "node set, limit, and scenario list must match).")
    p.add_argument("--inject-fault", dest="inject_fault", action="append",
                   default=[], metavar="SITE:KIND[:AT[:TIMES]]",
                   help="Chaos testing: inject a deterministic fault at a "
                        "runtime dispatch site (runtime/faults.py), e.g. "
                        "parallel.solve_group:oom. May be repeated; the "
                        "CC_INJECT_FAULT env var takes the same specs.")
    p.add_argument("--strict", action="store_true",
                   help="Exit nonzero (status 3) when any scenario was "
                        "served by a degraded ladder rung instead of the "
                        "healthy device path.")
    p.add_argument("--metrics-dump", dest="metrics_dump", default="",
                   metavar="FILE",
                   help="Write the metrics registry (Prometheus text format, "
                        "including the cc_* site×rung telemetry and sweep "
                        "progress gauges) to FILE after the sweep "
                        "('-' = stdout).")
    p.add_argument("--trace-out", dest="trace_out", default="",
                   metavar="FILE",
                   help="Write collected telemetry spans as Chrome-trace-"
                        "event JSONL (Perfetto-loadable; a fault-injected "
                        "sweep shows its degradation path rung-by-rung) to "
                        "FILE after the sweep ('-' = stdout).")
    p.add_argument("--profile-out", dest="profile_out", default="",
                   metavar="DIR",
                   help="Deep profiling: run the sweep under torch.profiler "
                        "capture writing its Chrome trace to DIR, sample "
                        "device memory watermarks per dispatch, and write "
                        "the site×rung×phase attribution table to "
                        "DIR/attribution.json (obs/profile.py).")
    p.add_argument("--flight-dir", dest="flight_dir", default="",
                   metavar="DIR",
                   help="Arm the fault flight recorder: any RuntimeFault "
                        "crossing the dispatch guard — or a --strict "
                        "failure — dumps a self-contained triage bundle "
                        "under DIR (obs/flight.py; bounded).")
    p.add_argument("--mesh", default="",
                   help="Shard the batched scenario solves (and bracket "
                        "shots) over a device mesh: BxN (batch x node "
                        "shards, e.g. 2x4; one shard per card, or BxN "
                        "logical shards of the CPU with --device cpu), "
                        "'auto' (best mesh over every visible card; one "
                        "card stays unsharded), or 'none' (default — "
                        "unsharded).")
    p.add_argument("--device", default="cuda",
                   help="Device to run on: cuda (default) or cpu.")
    return p


def run(argv: Optional[List[str]] = None, prog: str = "resilience") -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    args = build_parser(prog).parse_args(argv)

    if not args.snapshot:
        print("Error: --snapshot is required (failure sweeps are offline "
              "what-if studies)", file=sys.stderr)
        return 1
    if args.output not in ("", "json", "yaml"):
        print(f"Error: output format {args.output!r} not recognized",
              file=sys.stderr)
        return 1
    if args.random_k < 0 or args.samples <= 0:
        print("Error: --random-k and --samples must be positive",
              file=sys.stderr)
        return 1
    if args.resume and not args.journal:
        print("Error: --resume requires --journal PATH",
              file=sys.stderr)
        return 1

    if args.inject_fault:
        from ..runtime import faults
        try:
            faults.install_text(args.inject_fault)
        except ValueError as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1

    if args.metrics_dump or args.trace_out:
        # Count compiles while telemetry output was asked for.
        from .. import obs
        obs.install_recompile_hook()

    if args.flight_dir:
        from ..obs import flight
        flight.install(args.flight_dir, argv=prog.split() + argv)

    if args.podspec:
        probe = default_pod(parse_pod_text(_read_podspec(args.podspec)))
    else:
        probe = default_pod(_DEFAULT_PROBE)
    validate_pod(probe)

    profile = (load_scheduler_config(args.default_config)
               if args.default_config else SchedulerProfile())
    if args.parity:
        profile.compute_dtype = "float64"

    if args.snapshot.endswith(".npz"):
        from ..utils.checkpoint import load as load_checkpoint
        snapshot = load_checkpoint(args.snapshot)
    else:
        from ..models.snapshot import ClusterSnapshot
        objs = load_snapshot_objects(args.snapshot)
        snapshot = ClusterSnapshot.from_objects(
            objs.pop("nodes", []), objs.pop("pods", []), **objs)

    from ..resilience import (analyze, drain_list_scenario,
                              random_nk_scenarios, single_node_scenarios,
                              zone_scenarios)
    scenarios = []
    explicit = args.zones or args.random_k or args.drain
    if args.nodes or not explicit:
        scenarios.extend(single_node_scenarios(snapshot))
    if args.zones:
        scenarios.extend(zone_scenarios(snapshot, key=args.zones))
    if args.random_k:
        try:
            scenarios.extend(random_nk_scenarios(
                snapshot, args.random_k, args.samples, seed=args.seed))
        except ValueError as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1
    for spec in args.drain:
        names = [s for s in spec.split(",") if s]
        try:
            scenarios.append(drain_list_scenario(snapshot, names))
        except ValueError as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1
    if not scenarios:
        print("Error: no scenarios (snapshot has no nodes?)",
              file=sys.stderr)
        return 1

    from ..engine.simulator import resolve_device
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1

    from ..parallel.mesh import parse_mesh
    try:
        mesh = parse_mesh(args.mesh, device=device)
    except ValueError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1

    from ..runtime.errors import CheckpointCorruption
    import contextlib
    try:
        with contextlib.ExitStack() as stack:
            if args.profile_out:
                from ..obs import profile as obs_profile
                stack.enter_context(obs_profile.capture(args.profile_out))
            report = analyze(snapshot, scenarios, probe, profile=profile,
                             max_limit=args.max_limit, mesh=mesh,
                             dedup=not args.no_dedup,
                             journal=args.journal or None, resume=args.resume,
                             explain=args.explain, bounds=not args.no_bounds,
                             device=device)
    except CheckpointCorruption as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print_survivability(report, verbose=args.verbose, fmt=args.output)
    if args.metrics_dump or args.trace_out:
        from .. import obs
        if args.metrics_dump:
            obs.write_metrics(args.metrics_dump, atomic=True)
        if args.trace_out:
            n = obs.write_trace(args.trace_out,
                                atomic=args.trace_out != "-")
            if args.trace_out != "-":
                print(f"trace: {n} span(s) written to {args.trace_out}",
                      file=sys.stderr)
    if args.profile_out:
        from ..obs import profile as obs_profile
        out_path = os.path.join(args.profile_out, "attribution.json")
        obs_profile.write_attribution(out_path)
        print(f"profile: attribution written to {out_path}", file=sys.stderr)
    if args.strict and report.degraded:
        if args.flight_dir:
            from ..obs import flight
            flight.on_strict(f"--strict: scenario served by degraded "
                             f"ladder rung {report.worst_rung or '?'}")
        print("Error: --strict and at least one scenario was served by a "
              "degraded ladder rung", file=sys.stderr)
        return 3
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()

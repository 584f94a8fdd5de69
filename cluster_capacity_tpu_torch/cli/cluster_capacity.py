"""cluster-capacity CLI front-end on the card.

The flag surface of the reference's cmd/cluster-capacity
(app/options/options.go:65-77) that this package runs: --podspec,
--snapshot (cluster state from a YAML/JSON file), --max-limit,
--exclude-nodes, --default-config, --verbose and -o/--output, the JAX
package's --parity (bit-exact kube-scheduler score arithmetic in float64,
served by the scan step), --no-bounds (no capacity-bound clamp of the step
budget; the same results), --explain (placement attribution: why-not,
why-here and the bottleneck, explain/), --inject-fault and --strict (fault
drills of the degradation ladder, runtime/), plus --device (default cuda;
cpu runs the plain PyTorch versions).  Two or more --podspec run a what-if sweep of the
templates against the snapshot (parallel/sweep.py) and print one review of
all of them.  The JAX package's other flags are refused with a message
naming the port queue.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

# Flags of the JAX package's CLI that this package does not run yet.
_LATER_FLAGS = (
    "--kubeconfig", "--save-snapshot", "--node-order",
    "--mesh", "--trace", "--metrics",
    "--metrics-dump", "--trace-out", "--profile-out", "--flight-dir",
    "--period", "--period-iterations", "--watch", "--record-golden",
    "--strict-after", "--interleave",
)


def build_parser(prog: str = "cluster-capacity") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=prog,
        description=("Cluster-capacity analysis: estimate how many instances "
                     "of a given pod the cluster can schedule."))
    p.add_argument("--snapshot", default="",
                   help="Path to a cluster-snapshot YAML/JSON file.")
    p.add_argument("--podspec", action="append", default=[],
                   help="Path to JSON or YAML file containing pod definition.")
    p.add_argument("--max-limit", dest="max_limit", type=int, default=0,
                   help="Number of instances of pod to be scheduled after "
                        "which analysis stops. By default unlimited.")
    p.add_argument("--exclude-nodes", dest="exclude_nodes", default="",
                   help="Comma-separated list of node names to exclude.")
    p.add_argument("--default-config", dest="default_config", default="",
                   help="Path to KubeSchedulerConfiguration file.")
    p.add_argument("--verbose", action="store_true", help="Verbose mode")
    p.add_argument("-o", "--output", default="",
                   help="Output format. One of: json|yaml.")
    p.add_argument("--parity", action="store_true",
                   help="Bit-exact kube-scheduler score arithmetic (float64).")
    p.add_argument("--explain", action="store_true",
                   help="Compute placement attribution on the device during "
                        "the solve: per-node why-not elimination reasons, "
                        "per-placement why-here plugin score contributions, "
                        "and the bottleneck analysis.  Surfaces in the "
                        "report's explain section (verbose/json/yaml).")
    p.add_argument("--no-bounds", dest="no_bounds", action="store_true",
                   help="Disable bound-guided step-budget right-sizing "
                        "(bounds/bracket.py): solves keep the full step "
                        "budget instead of clamping to the capacity upper "
                        "bound.  Placements are identical either way.")
    p.add_argument("--inject-fault", dest="inject_fault", action="append",
                   default=[], metavar="SITE:KIND[:AT[:TIMES]]",
                   help="Chaos testing: inject a deterministic fault at a "
                        "runtime dispatch site (runtime/faults.py), e.g. "
                        "engine.solve:oom or parallel.solve_group:hang:2. "
                        "May be repeated; the CC_INJECT_FAULT env var takes "
                        "the same comma-separated specs.")
    p.add_argument("--strict", action="store_true",
                   help="Exit nonzero (status 3) when any solve was served "
                        "by a degraded ladder rung instead of the healthy "
                        "device path.")
    p.add_argument("--device", default="cuda",
                   help="Device to run on: cuda (default) or cpu.")
    return p


def run(argv: Optional[List[str]] = None, prog: str = "cluster-capacity") -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    args, unknown = build_parser(prog).parse_known_args(argv)
    later = [a.split("=", 1)[0] for a in unknown
             if a.split("=", 1)[0] in _LATER_FLAGS]
    if later:
        print(f"Error: {later[0]} is not ported yet (ROADMAP: port queue, "
              f"later slices)", file=sys.stderr)
        return 2
    if unknown:
        build_parser(prog).error(f"unrecognized arguments: {' '.join(unknown)}")

    if not args.podspec:
        print("Error: --podspec is required", file=sys.stderr)
        return 1
    if not args.snapshot:
        print("Error: provide --snapshot (live-cluster sync is not ported "
              "yet)", file=sys.stderr)
        return 1
    if args.output not in ("", "json", "yaml"):
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

    from ..engine.simulator import resolve_device
    from ..framework import ClusterCapacity
    from ..models.podspec import default_pod, parse_pod_text, validate_pod
    from ..models.snapshot import ClusterSnapshot
    from ..parallel.sweep import sweep
    from ..utils.config import SchedulerProfile, load_scheduler_config
    from ..utils.report import build_review, print_review
    from ..utils.snapshot_io import load_snapshot_objects

    pods = []
    for path in args.podspec:
        with open(path) as f:
            pod = default_pod(parse_pod_text(f.read()))
        validate_pod(pod)
        pods.append(pod)
    profile = (load_scheduler_config(args.default_config)
               if args.default_config else SchedulerProfile())
    if args.parity:
        profile.compute_dtype = "float64"
    exclude = [s for s in args.exclude_nodes.split(",") if s]
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    objs = load_snapshot_objects(args.snapshot)
    nodes, existing = objs.pop("nodes", []), objs.pop("pods", [])
    if len(pods) == 1:
        cc = ClusterCapacity(pods[0], max_limit=args.max_limit,
                             profile=profile, exclude_nodes=exclude,
                             explain=args.explain,
                             bounds=not args.no_bounds, device=device)
        cc.sync_with_objects(nodes, existing, **objs)
        cc.run()
        review = cc.report()
    else:
        snapshot = ClusterSnapshot.from_objects(nodes, existing,
                                                exclude_nodes=exclude, **objs)
        review = build_review(pods, sweep(snapshot, pods, profile=profile,
                                          max_limit=args.max_limit,
                                          explain=args.explain,
                                          bounds=not args.no_bounds,
                                          device=device))
    print_review(review, verbose=args.verbose, fmt=args.output)
    if args.strict and review.degraded:
        print("Error: --strict and at least one solve was served by a "
              "degraded ladder rung", file=sys.stderr)
        return 3
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()

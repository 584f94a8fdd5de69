"""cluster-capacity CLI front-end on the card.

The flag surface of the reference's cmd/cluster-capacity
(app/options/options.go:65-77): --kubeconfig (a live cluster; in-cluster
with CC_INCLUSTER=true, server.go:88), --podspec (a path or an http(s)
URL), --max-limit, --exclude-nodes, --default-config, --verbose and
-o/--output, plus the JAX package's offline and analysis flags that this
package runs:

- --snapshot FILE: cluster state from a YAML/JSON file, or a .npz
  checkpoint saved with --save-snapshot (utils/checkpoint.py);
- --node-order zone-round-robin: the reference scheduler's node iteration;
- --parity (float64 score arithmetic, served by the scan step),
  --no-bounds, --explain (why-not, why-here, bottleneck);
- --period / --watch: re-run every PERIOD seconds; --watch keeps the built
  snapshot and its memoized encodes until the --snapshot file changes;
- --record-golden FILE: write the run as a replayable scenario
  (utils/golden.py);
- --inject-fault, --strict and --strict-after: fault drills of the
  degradation ladder (runtime/);
- --trace, --metrics, --metrics-dump, --trace-out, --profile-out and
  --flight-dir: telemetry (obs/): phase spans, the metrics registry,
  Chrome-trace JSONL, torch.profiler capture with the device-time
  attribution, and the fault flight recorder; --metrics-dump and
  --trace-out are rewritten every --period/--watch iteration;
- --device (default cuda; cpu runs the plain PyTorch versions).

Two or more --podspec run a what-if sweep of the templates against the
snapshot (parallel/sweep.py) and print one review of all of them; with
--interleave they race through ONE shared cluster state instead
(parallel/interleave.py).  --mesh BxN shards batchable solves, and the
--interleave race, over a device mesh (parallel/mesh.py): one shard per
card, or B×N logical shards of the CPU with --device cpu.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
import urllib.request
from typing import List, Optional

from ..utils.snapshot_io import load_snapshot_objects


def build_parser(prog: str = "cluster-capacity") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=prog,
        description=("Cluster-capacity analysis: estimate how many instances "
                     "of a given pod the cluster can schedule."))
    p.add_argument("--kubeconfig", default="",
                   help="Path to the kubeconfig file to use for the analysis.")
    p.add_argument("--snapshot", default="",
                   help="Path to a cluster-snapshot YAML/JSON file, or a "
                        ".npz checkpoint saved with --save-snapshot "
                        "(offline alternative to --kubeconfig).")
    p.add_argument("--save-snapshot", dest="save_snapshot", default="",
                   help="Save the loaded cluster state as a .npz "
                        "checkpoint for fast reuse.")
    p.add_argument("--podspec", action="append", default=[],
                   help="Path to JSON or YAML file containing pod definition. "
                        "http(s):// URLs are accepted. May be repeated: "
                        "multiple podspecs run as one batched what-if sweep.")
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
    p.add_argument("--node-order", dest="node_order", default="",
                   choices=["", "sorted", "zone-round-robin"],
                   help="Node-axis ordering: sorted (default) or the "
                        "reference scheduler's zone-round-robin iteration.")
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
    p.add_argument("--trace", action="store_true",
                   help="Print phase trace spans (snapshotting / solve) to "
                        "stderr, mirroring the reference's utiltrace spans.")
    p.add_argument("--metrics", action="store_true",
                   help="Dump scheduler metrics (Prometheus text format) to "
                        "stderr after the run.")
    p.add_argument("--metrics-dump", dest="metrics_dump", default="",
                   metavar="FILE",
                   help="Write the full metrics registry (Prometheus text "
                        "format, including the cc_* site×rung telemetry) to "
                        "FILE after the run ('-' = stdout).")
    p.add_argument("--trace-out", dest="trace_out", default="",
                   metavar="FILE",
                   help="Write collected telemetry spans as Chrome-trace-"
                        "event JSONL (loadable in Perfetto / chrome://"
                        "tracing) to FILE after the run ('-' = stdout).")
    p.add_argument("--profile-out", dest="profile_out", default="",
                   metavar="DIR",
                   help="Deep profiling: run the analysis under "
                        "torch.profiler capture (CPU and CUDA activity) "
                        "writing its Chrome trace to DIR, sample device "
                        "memory watermarks per dispatch, and write the "
                        "site×rung×phase device-time attribution table to "
                        "DIR/attribution.json (obs/profile.py).")
    p.add_argument("--flight-dir", dest="flight_dir", default="",
                   metavar="DIR",
                   help="Arm the fault flight recorder: any RuntimeFault "
                        "crossing the dispatch guard — or a --strict "
                        "failure — dumps a self-contained triage bundle "
                        "(spans, metrics, events, fault + injection specs, "
                        "kernel.txt, one-line repro) under DIR "
                        "(obs/flight.py; bounded, oldest bundles pruned).")
    p.add_argument("--period", type=float, default=0.0,
                   help="Continuous mode: re-sync and re-run the analysis "
                        "every PERIOD seconds (the reference's historical "
                        "--period flag, doc/cluster-capacity.md). 0 = run "
                        "once.")
    p.add_argument("--watch", action="store_true",
                   help="Stream mode on top of --period (default period "
                        "10s): keep the built snapshot — and every "
                        "memoized encode on it — across iterations and "
                        "just re-solve, re-syncing only when the "
                        "--snapshot file changes on disk.  Live "
                        "--kubeconfig watches re-sync every period (no "
                        "change signal).  One report per iteration.")
    p.add_argument("--period-iterations", dest="period_iterations", type=int,
                   default=0, help=argparse.SUPPRESS)  # test hook: stop after N
    p.add_argument("--record-golden", dest="record_golden", default="",
                   help="Write the run as a golden scenario JSON (cluster "
                        "objects + podspec + profile + observed outcome) "
                        "that tests/test_golden_scenarios.py replays and a "
                        "kube-scheduler machine can re-record verbatim. "
                        "Single --podspec, --snapshot runs only.")
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
                        "device path.  With --watch/--period the loop stops "
                        "at the first degraded run past the --strict-after "
                        "grace.")
    p.add_argument("--strict-after", dest="strict_after", type=int, default=0,
                   metavar="N",
                   help="With --strict: tolerate degraded runs during the "
                        "first N iterations (warmup grace); the first "
                        "degraded run AFTER iteration N exits 3.  Default "
                        "0: no grace.")
    p.add_argument("--interleave", action="store_true",
                   help="With multiple --podspec: race the templates through "
                        "ONE shared cluster state with scheduling-queue pop "
                        "semantics (PrioritySort order) instead of "
                        "independent what-if sweeps.  NOTE: --max-limit then "
                        "caps the TOTAL placements across all templates "
                        "(one queue), not each template separately.")
    p.add_argument("--mesh", default="",
                   help="Shard batched solves over a device mesh: BxN "
                        "(batch x node shards, e.g. 2x4; one shard per "
                        "card, or BxN logical shards of the CPU with "
                        "--device cpu), 'auto' (best mesh over every "
                        "visible card; one card stays unsharded), or "
                        "'none' (default — unsharded).  Applies to "
                        "multi-podspec sweeps, batchable single-pod runs, "
                        "and --interleave (the stacked-template race shards "
                        "over the same mesh); --explain stays on the "
                        "per-template path.")
    p.add_argument("--device", default="cuda",
                   help="Device to run on: cuda (default) or cpu.")
    return p


def _read_podspec(path: str) -> str:
    if path.startswith("http://") or path.startswith("https://"):
        with urllib.request.urlopen(path) as r:  # nosec - mirrors reference
            return r.read().decode()
    with open(path) as f:
        return f.read()


def _load_live_cluster(kubeconfig: str):
    try:
        from kubernetes import client, config as kubeconf  # type: ignore
    except ImportError:
        raise SystemExit(
            "live-cluster sync requires the `kubernetes` python client; "
            "use --snapshot FILE for offline analysis")
    if os.environ.get("CC_INCLUSTER") == "true":
        kubeconf.load_incluster_config()
    else:
        kubeconf.load_kube_config(config_file=kubeconfig or None)
    return client.CoreV1Api()


def run(argv: Optional[List[str]] = None, prog: str = "cluster-capacity") -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    args = build_parser(prog).parse_args(argv)

    # Validation mirrors app/server.go:83-100.
    if not args.podspec:
        print("Error: --podspec is required", file=sys.stderr)
        return 1
    if not args.snapshot and not args.kubeconfig \
            and os.environ.get("CC_INCLUSTER") != "true":
        print("Error: provide --snapshot, --kubeconfig, or set "
              "CC_INCLUSTER=true", file=sys.stderr)
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

    if args.flight_dir:
        from ..obs import flight
        flight.install(args.flight_dir, argv=prog.split() + argv)

    from ..engine.simulator import resolve_device
    from ..framework import ClusterCapacity
    from ..models.podspec import default_pod, parse_pod_text, validate_pod
    from ..models.snapshot import ClusterSnapshot
    from ..utils.config import SchedulerProfile, load_scheduler_config
    from ..utils.report import build_review, print_review

    pods = []
    for spec_path in args.podspec:
        pod = default_pod(parse_pod_text(_read_podspec(spec_path)))
        validate_pod(pod)
        pods.append(pod)

    profile = (load_scheduler_config(args.default_config)
               if args.default_config else SchedulerProfile())
    if args.parity:
        profile.compute_dtype = "float64"
    if args.trace:
        from ..utils.trace import default_tracer
        default_tracer.enable()
    if args.metrics_dump or args.trace_out:
        # compile accounting only makes sense when telemetry is surfaced
        from .. import obs
        obs.install_recompile_hook()

    exclude = [s for s in args.exclude_nodes.split(",") if s]

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

    if args.node_order == "zone-round-robin" and (
            not args.snapshot or args.snapshot.endswith(".npz")):
        print("Error: --node-order zone-round-robin requires a YAML/JSON "
              "--snapshot (checkpoints and live sync fix the node axis)",
              file=sys.stderr)
        return 1

    if args.record_golden and (
            len(pods) != 1 or not args.snapshot
            or args.snapshot.endswith(".npz")):
        print("Error: --record-golden needs exactly one --podspec and a "
              "YAML/JSON --snapshot (the scenario must carry the raw "
              "cluster objects)", file=sys.stderr)
        return 1
    if args.record_golden and profile.extenders:
        print("Error: --record-golden cannot serialize profiles with "
              "extenders", file=sys.stderr)
        return 1

    # --watch snapshot cache: the built ClusterSnapshot (with its
    # per-snapshot memoized encodes) survives iterations; a change of the
    # --snapshot file (mtime/size/inode — mtime alone misses same-tick
    # rewrites and atomic-rename replaces) triggers a fresh sync.  Plain
    # --period keeps its historical semantics (re-sync every iteration).
    snap_cache: dict = {"snap": None, "raw": None, "stat": None,
                        "options": {}}

    def _load_snapshot_fresh():
        """(snapshot, raw objects, from_objects options)."""
        if args.snapshot.endswith(".npz"):
            from ..utils.checkpoint import load as load_checkpoint
            return load_checkpoint(args.snapshot), None, {}
        objs = load_snapshot_objects(args.snapshot)
        # raw objects are only consumed by --record-golden; don't pin a
        # second full copy of the cluster for ordinary (watch) runs
        raw = {k: list(v) for k, v in objs.items()
               if isinstance(v, list)} if args.record_golden else None
        kwargs = {}
        if args.node_order == "zone-round-robin":
            kwargs["node_order"] = "zone-round-robin"
        snap = ClusterSnapshot.from_objects(
            objs.pop("nodes", []), objs.pop("pods", []),
            exclude_nodes=exclude, **objs, **kwargs)
        return snap, raw, kwargs

    def current_snapshot():
        """(snapshot, raw objects, options); (None, ...) for live sync."""
        if not args.snapshot:
            return None, None, {}
        stat_key = None
        try:
            st = os.stat(args.snapshot)
            stat_key = (st.st_mtime_ns, st.st_size, st.st_ino)
        except OSError:
            pass
        if snap_cache["snap"] is None or not args.watch \
                or stat_key != snap_cache["stat"]:
            (snap_cache["snap"], snap_cache["raw"],
             snap_cache["options"]) = _load_snapshot_fresh()
            snap_cache["stat"] = stat_key
        return snap_cache["snap"], snap_cache["raw"], snap_cache["options"]

    def one_run():
        if len(pods) == 1:
            cc = ClusterCapacity(pods[0], max_limit=args.max_limit,
                                 profile=profile, exclude_nodes=exclude,
                                 explain=args.explain,
                                 bounds=not args.no_bounds, mesh=mesh,
                                 device=device)
            snap, raw_objs, snap_opts = current_snapshot()
            if snap is not None:
                cc.set_snapshot(snap, **snap_opts)
            else:
                cc.sync_with_client(_load_live_cluster(args.kubeconfig))
            if args.save_snapshot:
                from ..utils.checkpoint import save as save_checkpoint
                save_checkpoint(args.save_snapshot, cc.snapshot)
            res = cc.run()
            if args.record_golden:
                from ..utils.golden import record_scenario
                record_scenario(args.record_golden, pods[0], raw_objs,
                                profile, args.max_limit, res,
                                exclude_nodes=exclude,
                                node_order=args.node_order)
                print(f"golden scenario written to {args.record_golden}",
                      file=sys.stderr)
            return cc.report()

        # several templates against one snapshot: a what-if sweep
        from ..parallel.sweep import sweep
        from ..utils import metrics as metrics_mod
        from ..utils.trace import SPAN_SOLVE, default_tracer
        if not args.snapshot:
            raise SystemExit("multi-podspec sweeps require --snapshot")
        snapshot, _raw, _opts = current_snapshot()
        t0 = time.perf_counter()
        with default_tracer.span(SPAN_SOLVE), default_tracer.profile():
            if args.interleave:
                # interleaved shared-state queues carry no attribution: the
                # race through one mutable state has no per-template
                # elimination story
                from ..parallel.interleave import sweep_interleaved_auto
                results = sweep_interleaved_auto(
                    snapshot, pods, profile=profile,
                    max_total=args.max_limit, mesh=mesh,
                    bounds=False if args.no_bounds else None, device=device)
            else:
                results = sweep(snapshot, pods, profile=profile,
                                max_limit=args.max_limit, mesh=mesh,
                                explain=args.explain,
                                bounds=not args.no_bounds, device=device)
        reg = metrics_mod.default_registry
        for r in results:
            reg.inc(metrics_mod.SCHEDULE_ATTEMPTS, amount=r.placed_count,
                    result="scheduled", profile=profile.name)
            if r.fail_type == "Unschedulable":
                reg.inc(metrics_mod.SCHEDULE_ATTEMPTS,
                        result="unschedulable", profile=profile.name)
        reg.observe(metrics_mod.SCHEDULING_DURATION, time.perf_counter() - t0)
        return build_review(pods, results)

    def _dump_telemetry(final: bool) -> None:
        """Telemetry dump: atomically (temp + rename) for file targets so a
        scraper can read mid-watch; '-' targets only dump at exit."""
        from .. import obs
        if args.metrics_dump and (final or args.metrics_dump != "-"):
            obs.write_metrics(args.metrics_dump,
                              atomic=args.metrics_dump != "-")
        if args.trace_out and (final or args.trace_out != "-"):
            n = obs.write_trace(args.trace_out,
                                atomic=args.trace_out != "-")
            if final and args.trace_out != "-":
                print(f"trace: {n} span(s) written to {args.trace_out}",
                      file=sys.stderr)

    if args.watch and args.period <= 0:
        args.period = 10.0
    runs = 0
    strict_violated = False
    with contextlib.ExitStack() as stack:
        if args.profile_out:
            from ..obs import profile as obs_profile
            stack.enter_context(obs_profile.capture(args.profile_out))
        while True:
            review = one_run()
            if args.flight_dir:
                from ..obs import flight
                review.flight_bundles = flight.bundle_paths()
            print_review(review, verbose=args.verbose, fmt=args.output)
            runs += 1
            # --strict-after N: degraded runs within the first N iterations
            # are warmup grace; only a degraded run past the grace violates
            if review.degraded and runs > args.strict_after:
                strict_violated = True
            if args.metrics:
                from ..utils.metrics import default_registry
                sys.stderr.write(default_registry.render())
            if args.strict and strict_violated:
                # --strict must not wait for a watch loop that may never
                # exit: the first violating run ends the loop, returns 3
                break
            if args.period <= 0:
                break
            # continuous mode: rewrite telemetry every iteration so a
            # long-running watch is scrapeable mid-flight
            _dump_telemetry(final=False)
            if args.period_iterations and runs >= args.period_iterations:
                break
            sys.stdout.flush()
            time.sleep(args.period)
    if args.metrics_dump or args.trace_out:
        _dump_telemetry(final=True)
    if args.profile_out:
        from ..obs import profile as obs_profile
        out_path = os.path.join(args.profile_out, "attribution.json")
        obs_profile.write_attribution(out_path)
        print(f"profile: attribution written to {out_path}", file=sys.stderr)
    if args.strict and strict_violated:
        if args.flight_dir:
            from ..obs import flight
            flight.on_strict(f"--strict: solve served by degraded ladder "
                             f"rung {review.rung or '?'}")
        print("Error: --strict and at least one solve was served by a "
              "degraded ladder rung", file=sys.stderr)
        return 3
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()

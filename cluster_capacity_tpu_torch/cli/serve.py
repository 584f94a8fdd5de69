"""`hypercc serve`: the crash-tolerant capacity daemon front-end.

Promotes the `cluster-capacity --watch` loop into a supervised service
(serve/supervisor.py): a snapshot is loaded once, churn arrives as small
delta events instead of full re-syncs, every template is answered each
iteration through the breaker-aware guarded ladder, and telemetry is
rewritten atomically per iteration so a scraper can watch the daemon live.

Deltas come from a JSONL script (``--deltas``): one JSON object per line in
serve/ingest.py's delta vocabulary, applied in order, one before each
iteration after the first.  A malformed delta is quarantined (counted,
event-logged, state rolled back) — it never stops the loop.

Exit codes: 0 healthy, 1 usage error (a --mesh larger than the cards
present included), 3 strict contract violated (like ``cluster-capacity
--strict``, with the same ``--strict-after`` warmup grace measured in
*answers*).  ``--device`` picks the card (default) or the CPU; ``--mesh``
shards the coalesced group solves (parallel/mesh.py).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from ..models.podspec import default_pod, parse_pod_text, validate_pod
from ..utils.config import SchedulerProfile, load_scheduler_config
from ..utils.snapshot_io import load_snapshot_objects


def build_parser(prog: str = "serve") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=prog,
        description=("Supervised capacity-serving daemon: answers template "
                     "capacity queries continuously against a churning "
                     "snapshot, surviving classified device faults."))
    p.add_argument("--snapshot", required=True,
                   help="Cluster snapshot file (YAML/JSON objects or .npz "
                        "checkpoint) — the daemon's initial world state.")
    p.add_argument("--podspec", action="append", default=[], required=True,
                   help="Pod template file answered every iteration; may be "
                        "repeated (the drain coalesces duplicates and "
                        "batches distinct templates).")
    p.add_argument("--deltas", default="",
                   help="JSONL churn script: one delta object per line "
                        "(serve/ingest.py vocabulary), applied one per "
                        "iteration after the first.")
    p.add_argument("--iterations", type=int, default=0,
                   help="Stop after N serve iterations (0 with --deltas: "
                        "run until the script is exhausted; 0 without: one "
                        "iteration).")
    p.add_argument("--period", type=float, default=0.0,
                   help="Seconds to sleep between iterations (default 0: "
                        "serve as fast as the device answers).")
    p.add_argument("--max-limit", dest="max_limit", type=int, default=0,
                   help="Per-template placement cap (0 = unlimited).")
    p.add_argument("--deadline", type=float, default=0.0,
                   help="Per-request wall-clock deadline in seconds for "
                        "every guarded device call (0 = off).")
    p.add_argument("--breaker-threshold", type=int, default=3,
                   help="Classified faults at one site within the window "
                        "that open its circuit breaker (default 3).")
    p.add_argument("--breaker-window", type=float, default=60.0,
                   help="Breaker fault-counting window, seconds.")
    p.add_argument("--breaker-cooldown", type=float, default=5.0,
                   help="Seconds an open breaker pins requests to the next "
                        "rung down before the half-open probe.")
    p.add_argument("--default-config", dest="default_config", default="",
                   help="Path to KubeSchedulerConfiguration file.")
    p.add_argument("--mesh", default="",
                   help="Shard batched group solves over a device mesh "
                        "(BxN, 'auto', or 'none' — cluster-capacity --mesh "
                        "semantics; BxN logical shards of the CPU with "
                        "--device cpu).")
    p.add_argument("--strict", action="store_true",
                   help="Exit 3 at the first degraded or error answer past "
                        "the --strict-after grace (the daemon analog of "
                        "cluster-capacity --strict).")
    p.add_argument("--strict-after", dest="strict_after", type=int,
                   default=0, metavar="N",
                   help="With --strict: tolerate non-ok answers among the "
                        "first N answers (warmup grace).  Default 0.")
    p.add_argument("--inject-fault", dest="inject_fault", action="append",
                   default=[], metavar="SITE:KIND[:AT[:TIMES]]",
                   help="Chaos testing: deterministic fault injection "
                        "(runtime/faults.py; CC_INJECT_FAULT also honored).")
    p.add_argument("--flight-dir", dest="flight_dir", default="",
                   metavar="DIR",
                   help="Arm the fault flight recorder under DIR.")
    p.add_argument("--metrics-dump", dest="metrics_dump", default="",
                   metavar="FILE",
                   help="Atomically rewrite the metrics registry "
                        "(Prometheus text) to FILE every iteration.")
    p.add_argument("--verbose", action="store_true",
                   help="One line per answer instead of one per iteration.")
    p.add_argument("--device", default="cuda",
                   help="Device to run on: cuda (default) or cpu.")
    return p


def _load_snapshot(path: str):
    if path.endswith(".npz"):
        from ..utils.checkpoint import load as load_checkpoint
        return load_checkpoint(path)
    from ..models.snapshot import ClusterSnapshot
    objs = load_snapshot_objects(path)
    return ClusterSnapshot.from_objects(
        objs.pop("nodes", []), objs.pop("pods", []), **objs)


def _load_deltas(path: str) -> List[dict]:
    out: List[dict] = []
    with open(path, encoding="utf-8") as fh:
        for ln, line in enumerate(fh, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                # malformed JSON is still a delta — an invalid one the
                # store will quarantine, preserving line accounting
                out.append({"op": "__unparseable__", "line": ln})
    return out


def run(argv: Optional[List[str]] = None, prog: str = "serve") -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    args = build_parser(prog).parse_args(argv)

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
    if args.metrics_dump:
        from .. import obs
        obs.install_recompile_hook()

    from ..parallel.mesh import parse_mesh
    try:
        mesh = parse_mesh(args.mesh, device=args.device)
    except ValueError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1

    templates = []
    for spec_path in args.podspec:
        with open(spec_path) as f:
            pod = default_pod(parse_pod_text(f.read()))
        validate_pod(pod)
        templates.append(pod)

    profile = (load_scheduler_config(args.default_config)
               if args.default_config else SchedulerProfile())
    snapshot = _load_snapshot(args.snapshot)

    deltas = _load_deltas(args.deltas) if args.deltas else []
    iterations = args.iterations
    if iterations <= 0:
        iterations = len(deltas) + 1 if deltas else 1

    from ..serve import (BreakerConfig, ServeConfig, SnapshotStore,
                         Supervisor)
    config = ServeConfig(
        deadline_s=args.deadline,
        breaker=BreakerConfig(threshold=args.breaker_threshold,
                              window_s=args.breaker_window,
                              cooldown_s=args.breaker_cooldown),
        strict=args.strict, strict_after=args.strict_after,
        device=args.device)
    sup = Supervisor(SnapshotStore(snapshot, profile), config, mesh=mesh)

    import time as time_mod

    def _dump_metrics():
        if args.metrics_dump:
            from .. import obs
            obs.write_metrics(args.metrics_dump,
                              atomic=args.metrics_dump != "-")

    delta_idx = 0
    for it in range(1, iterations + 1):
        if it > 1 and delta_idx < len(deltas):
            sup.apply_delta(deltas[delta_idx])
            delta_idx += 1
        for tpl in templates:
            sup.submit(tpl, max_limit=args.max_limit)
        answers = sup.drain()
        if args.verbose:
            for a in answers:
                placed = (a.result.placed_count
                          if a.result is not None else "-")
                print(f"[{it}] req {a.request.id}: placed={placed} "
                      f"rung={a.rung or '-'} degraded={a.degraded} "
                      f"error={a.error or '-'}")
        else:
            placed = [a.result.placed_count if a.result is not None else -1
                      for a in answers]
            worst = max((a for a in answers),
                        key=lambda a: (a.error is not None, a.degraded),
                        default=None)
            state = ("error" if worst is not None and worst.error
                     else "degraded"
                     if worst is not None and worst.degraded else "ok")
            print(f"[{it}] answers={placed} state={state} "
                  f"deltas={sup.store.applied}"
                  f"(+{sup.store.quarantined} quarantined)")
        _dump_metrics()
        sys.stdout.flush()
        if args.strict and sup.strict_tripped:
            break
        if args.period > 0 and it < iterations:
            time_mod.sleep(args.period)

    if args.strict and sup.strict_tripped:
        if args.flight_dir:
            from ..obs import flight
            flight.on_strict("--strict: daemon served a degraded or error "
                            "answer past the warmup grace")
        print("Error: --strict and the daemon served a degraded or error "
              "answer past the warmup grace", file=sys.stderr)
        return 3
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()

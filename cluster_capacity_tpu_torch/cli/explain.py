"""`explain` subcommand: placement attribution for one pod on one snapshot.

Runs a single solve with device-computed attribution (explain/) and renders
the three products:

- why not — per-node elimination table: the reason code each node carries at
  the terminal state and the step at which it left the feasible set;
- why here — per-plugin weighted score contributions for every placement
  (totals plus the first placements in the pretty view, the full
  [placements, plugins] matrix in json/yaml);
- bottleneck — the binding resource dimension per node and the cluster-level
  marginal capacity ("adding X of R per node yields +K placements").

The attribution is computed inside the solve that produced the placements
(engine/simulator.py's explain step, engine/fast_path.py) — this command
just formats what the solver already collected.  Run it as
`python -m cluster_capacity_tpu_torch.cli.explain`; --device cpu runs the
plain PyTorch versions instead of the card.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np
import yaml

from ..framework import ClusterCapacity
from ..models.podspec import default_pod, parse_pod_text, validate_pod
from ..utils.config import SchedulerProfile, load_scheduler_config
from ..utils.snapshot_io import load_snapshot_objects


def build_parser(prog: str = "explain") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=prog,
        description=("Explain a capacity solve: why each node was (not) "
                     "chosen, which plugin scores drove each placement, and "
                     "which resource dimension binds the cluster."))
    p.add_argument("--snapshot", required=True,
                   help="Path to a cluster-snapshot YAML/JSON file.")
    p.add_argument("--podspec", required=True,
                   help="Path to JSON or YAML file containing the pod "
                        "definition.")
    p.add_argument("--max-limit", dest="max_limit", type=int, default=0,
                   help="Stop the simulation after this many placements "
                        "(0 = unlimited).")
    p.add_argument("--default-config", dest="default_config", default="",
                   help="Path to KubeSchedulerConfiguration file.")
    p.add_argument("--parity", action="store_true",
                   help="Bit-exact kube-scheduler score arithmetic "
                        "(float64).")
    p.add_argument("--nodes", type=int, default=10,
                   help="Per-node rows to show in the why-not and "
                        "bottleneck tables (-1 = all, 0 = none; "
                        "default 10).")
    p.add_argument("--placements", type=int, default=5,
                   help="Per-placement why-here rows to show in the pretty "
                        "view (-1 = all, 0 = none; default 5).")
    p.add_argument("-o", "--output", default="",
                   help="Output format. One of: json|yaml.")
    p.add_argument("--device", default="cuda",
                   help="Device to run on: cuda (default) or cpu.")
    return p


def run(argv: Optional[List[str]] = None, prog: str = "explain") -> int:
    args = build_parser(prog).parse_args(argv)
    if args.output not in ("", "json", "yaml"):
        print(f"Error: output format {args.output!r} not recognized",
              file=sys.stderr)
        return 1

    from ..engine.simulator import resolve_device
    from ..models.snapshot import ClusterSnapshot
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    with open(args.podspec) as f:
        pod = default_pod(parse_pod_text(f.read()))
    validate_pod(pod)
    profile = (load_scheduler_config(args.default_config)
               if args.default_config else SchedulerProfile())
    if args.parity:
        profile.compute_dtype = "float64"

    objs = load_snapshot_objects(args.snapshot)
    snap = ClusterSnapshot.from_objects(
        objs.pop("nodes", []), objs.pop("pods", []), **objs)

    cc = ClusterCapacity(pod, max_limit=args.max_limit, profile=profile,
                         explain=True, device=device)
    cc.set_snapshot(snap)
    result = cc.run()
    expl = getattr(result, "explain", None)
    if expl is None:
        print("Error: the solve produced no attribution", file=sys.stderr)
        return 2

    # Re-derive the encoded problem for per-node reason strings and the
    # per-node bottleneck rows.
    from ..engine import encode as enc
    from ..explain.bottleneck import bottleneck_analysis
    pb = enc.encode_problem(cc.snapshot, cc.pod, profile)
    bn = bottleneck_analysis(pb, max_nodes=args.nodes)

    if args.output in ("json", "yaml"):
        doc = {
            "placed": result.placed_count,
            "failType": result.fail_type,
            "failMessage": result.fail_message,
            "rung": result.rung or expl.rung,
            "explain": expl.to_dict(),
            "nodes": _node_rows(pb, expl, limit=-1),
        }
        if bn is not None:
            doc["explain"]["bottleneck"] = bn
        if args.output == "json":
            sys.stdout.write(json.dumps(doc) + "\n")
        else:
            sys.stdout.write(yaml.safe_dump(doc, sort_keys=False,
                                            default_flow_style=False))
        return 0

    _pretty(result, expl, pb, bn, args, sys.stdout)
    return 0


def _node_rows(pb, expl, limit: int) -> List[dict]:
    """Per-node why-not rows: eliminated nodes first (earliest step first),
    then feasible nodes; `limit` rows (-1 = all)."""
    from ..explain import artifacts as _art
    if expl.final_codes is not None:
        codes = np.asarray(expl.final_codes)
        reasons = [_art.node_reason(pb, c, i) for i, c in enumerate(codes)]
    else:
        # oracle rung: reason strings only
        codes = None
        reasons = list(getattr(expl, "_oracle_reasons", [])) or [""] * len(
            pb.snapshot.node_names)
    steps = (np.asarray(expl.elim_step)
             if expl.elim_step is not None
             else np.full(len(pb.snapshot.node_names), -1, dtype=np.int32))
    order = sorted(range(len(steps)),
                   key=lambda i: (steps[i] < 0, int(steps[i]),
                                  pb.snapshot.node_names[i]))
    rows = []
    for i in order:
        rows.append({
            "node": pb.snapshot.node_names[i],
            "elimStep": int(steps[i]),
            "code": None if codes is None else int(codes[i]),
            "reason": reasons[i] if i < len(reasons) else "",
        })
    return rows if limit < 0 else rows[:limit]


def _pretty(result, expl, pb, bn, args, out) -> None:
    out.write(f"Placed {result.placed_count} instance(s); "
              f"{result.fail_type}: {result.fail_message}\n")
    out.write(f"Attribution rung: {result.rung or expl.rung or '?'}; "
              f"{expl.feasible_nodes} node(s) still feasible at the "
              f"terminal state\n")

    if expl.reason_histogram:
        out.write("\nWhy not — elimination reasons over all nodes:\n")
        for k, v in sorted(expl.reason_histogram.items(),
                           key=lambda kv: (-kv[1], kv[0])):
            out.write(f"  {k}: {v} node(s)\n")

    if args.nodes:
        rows = _node_rows(pb, expl, args.nodes)
        if rows:
            w = max(len("NODE"), *(len(r["node"]) for r in rows))
            out.write(f"\n{'NODE':<{w}}  {'ELIM@STEP':>9}  REASON\n")
            for r in rows:
                step = "-" if r["elimStep"] < 0 else str(r["elimStep"])
                out.write(f"{r['node']:<{w}}  {step:>9}  "
                          f"{r['reason'] or 'feasible'}\n")
            n = len(pb.snapshot.node_names)
            if 0 <= args.nodes < n:
                out.write(f"  ... ({n - args.nodes} more node(s); "
                          f"--nodes -1 for all)\n")

    wh = expl.why_here
    if wh is not None and len(wh):
        out.write("\nWhy here — weighted score contribution by plugin "
                  "(total over all placements):\n")
        totals = np.asarray(wh).sum(axis=0)
        for name, t in sorted(zip(expl.plugins, totals),
                              key=lambda x: -x[1]):
            if t:
                out.write(f"  {name}: {t:g}\n")
        if args.placements:
            k = len(wh) if args.placements < 0 else min(args.placements,
                                                        len(wh))
            out.write("  first placements (node ← nonzero terms):\n")
            for t in range(k):
                node = pb.snapshot.node_names[result.placements[t]]
                terms = ", ".join(
                    f"{p}={v:g}" for p, v in zip(expl.plugins, wh[t]) if v)
                out.write(f"    #{t + 1} {node} ← {terms or '0'}\n")
            if k < len(wh):
                out.write(f"    ... ({len(wh) - k} more; --placements -1 "
                          f"for all)\n")

    if bn is not None:
        out.write("\nBottleneck — remaining capacity "
                  f"{bn['totalCapacity']} placement(s); binding dimension "
                  "per node:\n")
        for k, v in bn["bindingCounts"].items():
            out.write(f"  {k}: {v} node(s)\n")
        if bn.get("marginal"):
            out.write("Marginal capacity — adding one pod's worth of R to "
                      "every node yields:\n")
            for k, m in bn["marginal"].items():
                out.write(f"  {k} (+{m['addPerNode']:g}/node): "
                          f"+{m['extraPlacements']} placement(s)\n")
        for r in bn.get("perNode") or []:
            out.write(f"  {r['node']}: binding={r['binding']} "
                      f"cap={r['cap']}\n")


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()

"""genpod CLI front-end: generate a pod spec from a namespace's LimitRanges.

Mirrors the reference's cmd/genpod/app/server.go:35-105 +
pkg/client/nspod.go:36-131: a pause-image stub pod whose requests/limits are
the per-resource minimum over all Pod-type LimitRange maxima in the namespace,
with a node selector from the `openshift.io/node-selector` annotation.
Operates on a --snapshot file (offline) or a live cluster when the kubernetes
client is installed.
"""

from __future__ import annotations

import argparse
import sys
from fractions import Fraction
from typing import List, Optional

import yaml

from ..utils.quantity import parse_quantity
from ..utils.snapshot_io import load_snapshot_objects

RESOURCE_GPU = "nvdia.com/gpu"  # sic — nspod.go:31


def retrieve_namespace_pod(namespaces: List[dict], limit_ranges: List[dict],
                           namespace: str) -> dict:
    """RetrieveNamespacePod over already-fetched objects."""
    ns_obj = next((n for n in namespaces
                   if (n.get("metadata") or {}).get("name") == namespace), None)
    if ns_obj is None:
        raise ValueError(f"Namespace {namespace} not found")

    pod = {
        "metadata": {"name": "cluster-capacity-stub-container",
                     "namespace": namespace},
        "spec": {
            "containers": [{
                "name": "cluster-capacity-stub-container",
                "image": "gcr.io/google_containers/pause:2.0",
                "imagePullPolicy": "Always",
            }],
            "restartPolicy": "OnFailure",
            "dnsPolicy": "Default",
        },
    }

    # min over Pod-type LimitRange maxima (nspod.go:60-119)
    tracked = {"memory": None, "cpu": None, RESOURCE_GPU: None}
    raw: dict = {}
    for lr in limit_ranges:
        if ((lr.get("metadata") or {}).get("namespace") or "default") != namespace:
            continue
        for item in ((lr.get("spec") or {}).get("limits")) or []:
            if item.get("type") != "Pod":
                continue
            for rname in tracked:
                amount = (item.get("max") or {}).get(rname)
                if amount is None:
                    continue
                val = parse_quantity(amount)
                if tracked[rname] is None or tracked[rname] > val:
                    tracked[rname] = val
                    raw[rname] = amount

    if any(v is not None and v != 0 for v in tracked.values()):
        res = {k: str(raw[k]) for k, v in tracked.items() if v is not None}
        pod["spec"]["containers"][0]["resources"] = {
            "limits": dict(res), "requests": dict(res)}

    annotations = (ns_obj.get("metadata") or {}).get("annotations") or {}
    selector = annotations.get("openshift.io/node-selector")
    if selector is not None:
        ns_map = {}
        for part in selector.split(","):
            if not part:
                continue
            if "=" not in part:
                raise ValueError(
                    f"Unable to parse openshift.io/node-selector in "
                    f"{selector} namespace")
            k, v = part.split("=", 1)
            ns_map[k.strip()] = v.strip()
        pod["spec"]["nodeSelector"] = ns_map
    return pod


def build_parser(prog: str = "genpod") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=prog, description="Generate pod based on namespace resource limits")
    p.add_argument("--kubeconfig", default="",
                   help="Path to the kubeconfig file to use.")
    p.add_argument("--snapshot", default="",
                   help="Path to a cluster-snapshot YAML/JSON file.")
    p.add_argument("--namespace", required=False, default="",
                   help="Namespace of the generated pod.")
    p.add_argument("-o", "--output", default="",
                   help="Output format. One of: json|yaml.")
    return p


def run(argv: Optional[List[str]] = None, prog: str = "genpod") -> int:
    args = build_parser(prog).parse_args(argv)
    if not args.namespace:
        print("Error: --namespace is required", file=sys.stderr)
        return 1
    if args.output not in ("", "json", "yaml"):
        print(f"Error: output format {args.output!r} not recognized",
              file=sys.stderr)
        return 1

    if args.snapshot:
        objs = load_snapshot_objects(args.snapshot)
        namespaces = objs.get("namespaces", [])
        limit_ranges = objs.get("limit_ranges", [])
    else:
        try:
            from kubernetes import client, config as kubeconf  # type: ignore
        except ImportError:
            print("Error: live-cluster mode requires the `kubernetes` python "
                  "client; use --snapshot FILE", file=sys.stderr)
            return 1
        import os
        if os.environ.get("CC_INCLUSTER") == "true":
            kubeconf.load_incluster_config()
        else:
            kubeconf.load_kube_config(config_file=args.kubeconfig or None)
        api = client.CoreV1Api()
        ser = client.ApiClient().sanitize_for_serialization
        namespaces = [ser(x) for x in api.list_namespace().items]
        limit_ranges = [ser(x) for x in
                        api.list_namespaced_limit_range(args.namespace).items]

    try:
        pod = retrieve_namespace_pod(namespaces, limit_ranges, args.namespace)
    except ValueError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1

    # PrintPod (pkg/utils/utils.go:47-71): yaml by default.
    import json as _json
    if args.output == "json":
        print(_json.dumps(pod, indent=2))
    else:
        print(yaml.safe_dump(pod, sort_keys=False), end="")
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()

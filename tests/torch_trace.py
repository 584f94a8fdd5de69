"""The port's trace as the JAX package records it, for the tests that hold
the port's spans to the JAX package's (test_torch_obs, test_torch_resilience).

The port records phases the JAX package does not: spans inside the
preemption dry run, the step drive and the interleave race, the trace id
and collector and compile costs charged to each span, and the
InterPodAffinity encoder's path and residents read on the span open over
an encode.  It opens the snapshot span in every
`ClusterSnapshot.from_objects`, where the JAX package opens it only
around the cluster-capacity CLI's own build.  It
names the encode span for what it wraps; the JAX package names it after
the snapshot.
"""

import dataclasses

from cluster_capacity_tpu_torch.utils.trace import SPAN_ENCODE, SPAN_SNAPSHOT

PORT_ONLY_SPANS = frozenset({
    "preemption.dryrun", "preemption.clones", "preemption.filter",
    "preemption.pick", "preemption.commit", "steps.load", "steps.replay",
    "interleave.wait", "interleave.drain", "interleave.encode"})
PORT_ONLY_ARGS = ("trace_id", "compiles", "gc_s", "gc_n", "ipa_path",
                  "ipa_residents_read")
PORT_RENAMED = {SPAN_ENCODE: SPAN_SNAPSHOT}


def _left_out(items, name, span_id, parent_id, cli_snapshot):
    """Ids of the items the JAX package does not record, and each item's
    parent id."""
    parent = {span_id(e): parent_id(e) for e in items}
    left_out = {span_id(e) for e in items if name(e) in PORT_ONLY_SPANS}
    snapshots = [e for e in items if name(e) == SPAN_SNAPSHOT]
    kept = [e for e in snapshots if parent_id(e) is None][:1] \
        if cli_snapshot else []
    left_out.update(span_id(e) for e in snapshots
                    if not any(e is k for k in kept))
    return left_out, parent


def _nearest_kept(up, left_out, parent):
    while up in left_out:
        up = parent.get(up)
    return up


def as_jax_trace(events: list, cli_snapshot: bool = False) -> list:
    """Trace events (obs.trace_events dicts) of the port as the JAX package
    records them: the port's own spans left out, their children hung from
    the nearest span kept; the port's own args dropped; the encode span
    under the JAX package's name.  Snapshot spans are left out too, but for
    the cluster-capacity CLI's (`cli_snapshot`): the first one opened
    outside any other span."""
    left_out, parent = _left_out(
        events, lambda e: e["name"], lambda e: e["args"]["span_id"],
        lambda e: e["args"].get("parent_id"), cli_snapshot)
    out = []
    for e in events:
        if e["args"]["span_id"] in left_out:
            continue
        args = {k: v for k, v in e["args"].items()
                if k not in PORT_ONLY_ARGS}
        if "parent_id" in args:
            up = _nearest_kept(args["parent_id"], left_out, parent)
            if up is None:
                del args["parent_id"]
            else:
                args["parent_id"] = up
        out.append(dict(e, name=PORT_RENAMED.get(e["name"], e["name"]),
                        args=args))
    return out


def as_jax_spans(spans: list, cli_snapshot: bool = False) -> list:
    """as_jax_trace over the collector's Span objects: copies of the spans
    the JAX package records, parented as it parents them."""
    left_out, parent = _left_out(
        spans, lambda s: s.name, lambda s: s.span_id, lambda s: s.parent_id,
        cli_snapshot)
    return [dataclasses.replace(
        s, name=PORT_RENAMED.get(s.name, s.name),
        parent_id=_nearest_kept(s.parent_id, left_out, parent))
        for s in spans if s.span_id not in left_out]

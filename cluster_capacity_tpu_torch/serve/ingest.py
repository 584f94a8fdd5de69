"""Snapshot delta ingestion: validate, apply, quarantine.

The daemon never rebuilds its world from scratch on churn.  A
``SnapshotStore`` holds the current tensorized ``ClusterSnapshot`` plus an
alive mask over the fixed node axis, and applies small delta dicts:

    {"op": "remove_node",  "node": NAME}
    {"op": "restore_node", "node": NAME}
    {"op": "add_pod",      "pod": POD}          # POD carries spec.nodeName
    {"op": "remove_pod",   "namespace": NS, "name": NAME}
    {"op": "add_node",     "node": NODE}
    {"op": "remove_pods_on", "node": NAME}      # drain a node's roster

Cost tiers, cheapest first:

- ``remove_node``/``restore_node`` flip one bit of the alive mask.  The node
  axis — and therefore every tensor shape, kernel launch plan and CUDA-graph
  key — stays fixed; encode folds the mask into the static planes (the
  resilience equivalence: masking == deletion, pinned by the _mask_exact
  parity tests).  Zero recompiles (obs/recompile: kernel builds and graph
  captures).
- ``add_pod``/``remove_pod``/``remove_pods_on`` go through
  ``models.snapshot.with_pods_by_node``: only the changed node's requested
  rows recompute, axes unchanged, built kernels and captured graphs stay
  warm.  When incremental rules don't hold (vocabulary change, shared
  claims) it falls back to a full ``from_objects`` rebuild — same axes in
  practice, but counted in ``full_rebuilds`` so the soak can see it.
- ``add_node`` rebuilds from objects: the node axis grows, shapes change,
  and the next solve may capture new step graphs.  That is the one delta
  class allowed to cost compile time, and the daemon treats it like a
  fresh snapshot.

Every delta validates BEFORE it commits.  A bad delta — unknown node,
malformed pod spec, unparseable quantity — raises
``SnapshotValidationError`` internally, and ``apply`` converts that into a
quarantine: the store rolls back to the last-good (snapshot, mask) pair,
counts it, records an event, and returns False.  The serving loop never
dies on input.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..engine import encode as enc
from ..models import snapshot as snap_mod
from ..models.snapshot import ClusterSnapshot, with_pods_by_node
from ..obs import names as obs_names
from ..runtime.errors import SnapshotValidationError
from ..utils.events import default_recorder
from ..utils.metrics import default_registry

EVENT_QUARANTINE = "DeltaQuarantined"

_OPS = ("remove_node", "restore_node", "add_pod", "remove_pod",
        "add_node", "remove_pods_on")


class SnapshotStore:
    """Current snapshot + alive mask + last-good rollback, with memoised
    encoding for the supervisor (`problems`)."""

    def __init__(self, snapshot: ClusterSnapshot, profile):
        self.snapshot = snapshot
        self.profile = profile
        self.alive = np.ones(snapshot.num_nodes, dtype=bool)
        self._last_good = (snapshot, self.alive.copy())
        self.applied = 0
        self.quarantined = 0
        self.full_rebuilds = 0
        self.generation = 0     # bumped on every applied delta

    # -- encoding ----------------------------------------------------------

    def alive_mask(self) -> Optional[np.ndarray]:
        """The mask to fold into encodes — None when every node is alive."""
        return None if bool(self.alive.all()) else self.alive

    def problems(self, templates: Sequence[dict]) -> List:
        """Encoded problems for `templates` against the current state.
        Memoised on (snapshot identity, template identity, alive bytes) via
        encode_problems_shared, so a drain re-encoding the same templates
        between deltas is a dict hit."""
        return enc.encode_problems_shared(
            self.snapshot, list(templates), self.profile,
            alive_mask=self.alive_mask())

    def invalidate(self) -> None:
        """Crash-restart hook: drop the snapshot's encode memo, so the next
        drain re-encodes from the objects.  Shapes are unchanged, so the
        re-encoded problems land on the built kernels, their launch plans
        and the captured step graphs: a cache hit, not a recompile."""
        memo = getattr(self.snapshot, "_memo", None)
        if memo is not None:
            memo.pop(("encode_problems_shared",), None)

    # -- deltas ------------------------------------------------------------

    def apply(self, delta) -> bool:
        """Validate and apply one delta.  True = applied; False = the delta
        was quarantined and the store rolled back to last-good state.  Never
        raises SnapshotValidationError."""
        op = delta.get("op") if isinstance(delta, dict) else None
        try:
            if not isinstance(delta, dict):
                raise SnapshotValidationError(
                    f"delta is {type(delta).__name__}, expected a mapping",
                    field_path="delta")
            if op not in _OPS:
                raise SnapshotValidationError(
                    f"unknown delta op {op!r}; expected one of "
                    f"{', '.join(_OPS)}", field_path="delta.op")
            getattr(self, f"_apply_{op}")(delta)
        except SnapshotValidationError as exc:
            self.snapshot, alive = self._last_good
            self.alive = alive.copy()
            self.quarantined += 1
            default_registry.inc(obs_names.SERVE_DELTAS,
                                 op=str(op), outcome="quarantined")
            default_recorder.eventf(
                "ingest", EVENT_QUARANTINE,
                f"delta {op!r} quarantined ({exc.field_path or '?'}): {exc}")
            return False
        self._last_good = (self.snapshot, self.alive.copy())
        self.applied += 1
        self.generation += 1
        default_registry.inc(obs_names.SERVE_DELTAS,
                             op=str(op), outcome="applied")
        return True

    # -- op implementations (raise SnapshotValidationError on bad input) ---

    def _node_index(self, delta, key: str = "node") -> int:
        name = delta.get(key)
        if not isinstance(name, str) or not name:
            raise SnapshotValidationError(
                f"delta.{key} must be a non-empty node name",
                field_path=f"delta.{key}")
        try:
            return self.snapshot.node_names.index(name)
        except ValueError:
            raise SnapshotValidationError(
                f"unknown node {name!r}",
                field_path=f"delta.{key}") from None

    def _apply_remove_node(self, delta) -> None:
        idx = self._node_index(delta)
        alive = self.alive.copy()
        alive[idx] = False
        if not alive.any():
            raise SnapshotValidationError(
                "delta would remove the last alive node",
                field_path="delta.node")
        self.alive = alive

    def _apply_restore_node(self, delta) -> None:
        idx = self._node_index(delta)
        alive = self.alive.copy()
        alive[idx] = True
        self.alive = alive

    def _apply_add_pod(self, delta) -> None:
        pod = delta.get("pod")
        if not isinstance(pod, dict):
            raise SnapshotValidationError(
                "delta.pod must be a pod object", field_path="delta.pod")
        node_name = (pod.get("spec") or {}).get("nodeName") or ""
        if not node_name:
            raise SnapshotValidationError(
                "delta.pod must be bound (spec.nodeName) — the daemon "
                "tracks scheduled state, it does not schedule",
                field_path="delta.pod.spec.nodeName")
        try:
            idx = self.snapshot.node_names.index(node_name)
        except ValueError:
            raise SnapshotValidationError(
                f"pod bound to unknown node {node_name!r}",
                field_path="delta.pod.spec.nodeName") from None
        # validate request quantities BEFORE touching the roster — the
        # incremental path parses them unguarded
        snap_mod._validated_pod_requests(pod, "delta.pod")
        roster = [list(p) for p in self.snapshot.pods_by_node]
        roster[idx].append(dict(pod))
        self._commit_roster(roster, changed=[idx])

    def _apply_remove_pod(self, delta) -> None:
        name = delta.get("name")
        ns = delta.get("namespace") or "default"
        if not isinstance(name, str) or not name:
            raise SnapshotValidationError(
                "delta.name must be a pod name", field_path="delta.name")
        for idx, plist in enumerate(self.snapshot.pods_by_node):
            for pi, pod in enumerate(plist):
                meta = pod.get("metadata") or {}
                if (meta.get("name") == name
                        and (meta.get("namespace") or "default") == ns):
                    roster = [list(p) for p in self.snapshot.pods_by_node]
                    del roster[idx][pi]
                    self._commit_roster(roster, changed=[idx])
                    return
        raise SnapshotValidationError(
            f"pod {ns}/{name} not present on any node",
            field_path="delta.name")

    def _apply_remove_pods_on(self, delta) -> None:
        idx = self._node_index(delta)
        if not self.snapshot.pods_by_node[idx]:
            return
        roster = [list(p) for p in self.snapshot.pods_by_node]
        roster[idx] = []
        self._commit_roster(roster, changed=[idx])

    def _apply_add_node(self, delta) -> None:
        node = delta.get("node")
        if not isinstance(node, dict):
            raise SnapshotValidationError(
                "delta.node must be a node object", field_path="delta.node")
        name = (node.get("metadata") or {}).get("name") or ""
        if not name:
            raise SnapshotValidationError(
                "delta.node must carry metadata.name",
                field_path="delta.node.metadata.name")
        if name in self.snapshot.node_names:
            raise SnapshotValidationError(
                f"node {name!r} already present",
                field_path="delta.node.metadata.name")
        nodes = [dict(n) for n in self.snapshot.nodes] + [dict(node)]
        pods = [dict(p) for plist in self.snapshot.pods_by_node
                for p in plist]
        extra = {k: list(getattr(self.snapshot, k))
                 for k in snap_mod.OBJECT_FIELDS}
        rebuilt = ClusterSnapshot.from_objects(nodes, pods, **extra)
        # the node axis changed: carry the alive bits over by name (the new
        # node starts alive), and expect the next solve to recompile
        alive_by_name = dict(zip(self.snapshot.node_names, self.alive))
        self.snapshot = rebuilt
        self.alive = np.asarray(
            [alive_by_name.get(n, True) for n in rebuilt.node_names],
            dtype=bool)
        self.full_rebuilds += 1

    def _commit_roster(self, roster: List[List[dict]],
                       changed: Sequence[int]) -> None:
        updated = with_pods_by_node(self.snapshot, roster, changed)
        if updated is None:
            # incremental rules don't hold: rebuild, preserving aux objects
            nodes = [dict(n) for n in self.snapshot.nodes]
            pods = [dict(p) for plist in roster for p in plist]
            extra = {k: list(getattr(self.snapshot, k))
                     for k in snap_mod.OBJECT_FIELDS}
            updated = ClusterSnapshot.from_objects(nodes, pods, **extra)
            self.full_rebuilds += 1
        self.snapshot = updated

"""Top-level simulation facade.

Mirrors the reference's `pkg/framework` public surface
(pkg/framework/simulator.go:107-381): construct with a pod template and a
scheduler profile, feed it cluster state, run, read the report.  `run()`
encodes the snapshot and solves it through runtime/degrade.solve_one_guarded:
the closed-form fast path when it is exact, else the fused placement kernel
on the card (engine/simulator.py), or on the CPU through the kernel's plain
PyTorch version when the caller passes device="cpu".
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from .engine.encode import encode_problem
from .engine.simulator import SolveResult, resolve_device
from .models.podspec import make_clone
from .models.snapshot import ClusterSnapshot
from .ops.priority_sort import resolve_priority
from .runtime.degrade import solve_one_guarded
from .utils.config import SchedulerProfile
from .utils.report import ClusterCapacityReview, build_review


class ClusterCapacity:
    """framework.New equivalent (simulator.go:107-158).

    device: where the solve runs — None means the card ("cuda"); pass
    "cpu" to run the kernel's plain PyTorch version.  Without a card and
    without an explicit device="cpu" the constructor raises.  explain and
    mesh are the JAX package's options; setting either raises
    NotImplementedError."""

    def __init__(self, pod: dict, max_limit: int = 0,
                 profile: Optional[SchedulerProfile] = None,
                 exclude_nodes: Sequence[str] = (),
                 device=None, explain: bool = False, mesh=None):
        if explain:
            raise NotImplementedError("explain is not ported yet (ROADMAP: "
                                      "port queue, explain/)")
        if mesh is not None:
            raise NotImplementedError("meshes are not ported yet (ROADMAP: "
                                      "port queue, parallel/mesh)")
        self.pod = pod
        self.max_limit = max_limit
        self.profile = profile or SchedulerProfile()
        self.exclude_nodes = list(exclude_nodes)
        self.device = resolve_device(device)
        self.snapshot: Optional[ClusterSnapshot] = None
        self._result: Optional[SolveResult] = None

    def sync_with_objects(self, nodes: Sequence[dict],
                          pods: Sequence[dict] = (), **extra) -> None:
        """SyncWithClient equivalent (simulator.go:176-295) over already-
        fetched objects; `extra` takes services/pvcs/pdbs/... lists."""
        self.snapshot = ClusterSnapshot.from_objects(
            nodes, pods, exclude_nodes=self.exclude_nodes, **extra)

    def set_snapshot(self, snapshot: ClusterSnapshot) -> None:
        """Install an already-built snapshot."""
        self.snapshot = snapshot

    def _refuse_preemption(self) -> None:
        """DefaultPreemption is not ported: refuse a run where it could
        evict.  With no existing pod of lower priority than the template the
        JAX package's PostFilter finds no victim and leaves the result and
        its message unchanged (framework.py preemption loop), so that run is
        served here."""
        profile = self.profile
        if "DefaultPreemption" not in profile.post_filters:
            return
        if profile.include_preemption_message:
            raise NotImplementedError(
                "include_preemption_message is not ported yet (ROADMAP: port "
                "queue, DefaultPreemption)")
        snap = self.snapshot
        mine = resolve_priority(self.pod, snap.priority_classes)
        for plist in snap.pods_by_node:
            for p in plist:
                if resolve_priority(p, snap.priority_classes) < mine:
                    raise NotImplementedError(
                        "DefaultPreemption with a possible victim (an "
                        "existing pod of lower priority) is not ported yet "
                        "(ROADMAP: port queue, DefaultPreemption)")

    def run(self) -> SolveResult:
        if self.snapshot is None:
            raise RuntimeError("call sync_with_objects first")
        profile = self.profile
        if profile.extenders:
            raise NotImplementedError("scheduler extenders are not ported "
                                      "yet (ROADMAP: port queue, extenders)")
        self._refuse_preemption()
        problem = encode_problem(self.snapshot, self.pod, profile)
        result = solve_one_guarded(problem, max_limit=self.max_limit,
                                   device=self.device)
        self._result = result
        return result

    def report(self) -> ClusterCapacityReview:
        if self._result is None:
            raise RuntimeError("call run() first")
        return build_review([self.pod], self._result)

    def scheduled_pods(self) -> List[dict]:
        """ScheduledPods equivalent (simulator.go:172): the placed clones as
        pod objects with nodeName set."""
        if self._result is None:
            return []
        out = []
        for i, idx in enumerate(self._result.placements):
            clone = make_clone(self.pod, i)
            clone["spec"]["nodeName"] = self._result.node_names[idx]
            clone.setdefault("status", {})["phase"] = "Running"
            out.append(clone)
        return out

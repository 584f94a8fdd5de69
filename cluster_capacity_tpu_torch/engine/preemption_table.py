"""The preemption dry run's victim table: DefaultPreemption's node filter
(engine/preemption._filter_candidates) as int64 tensor ops over every
node at once, for the inputs where the only part of the filter chain that
reads a node's roster is NodeResourcesFit.

`fallback_reason` names the first feature of the input that makes a
node's verdict read more than its own roster's requests, or call outside
the port: extenders, any PDB, an incoming pod with host ports,
DoNotSchedule spread constraints or required pod (anti-)affinity,
NodeResourcesFit disabled; a resident with required pod anti-affinity is
read per row by the table itself.  Where one holds, preemption.evaluate
runs the oracle's filter chain on every node as before.

One table serves one answer (framework._solve_with_preemption): built at
its first full-path dry run from the snapshot's rosters plus the cycle's
clones, kept current by rebuilding the rows the caller marks (the nodes a
commit changed, the nodes holding the cycle's clones), dropped when the
answer returns.  Per node it holds, on the answer's device:

- `alloc[N, R']`: allocatable (oracle.node_allocatable), R' being the
  pod count and each resource the incoming pod requests (want > 0);
- `base[N, R']`: the requests of the pods that do not rank below the
  incoming pod, its clones among them;
- `low[N, K, R']`, `valid[N, K]`: the lower-priority pods' requests in
  reprieve order, (-priority, start time), stable over roster order;

and on the host the lower-priority pod objects in that order, and each
node's verdict from the roster-free head of the filter chain
(oracle._static_reason), computed once.  A dry run is a pass of K
reprieve steps over all nodes and one copy to the host of each node's
status and victim mask; a node's candidate entry is made anew only where
its row was rebuilt or its verdict moved.  The candidates equal the
oracle's in node order, victims and their order, and message counts
(tests/test_torch_preemption_table.py).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from . import oracle
from .preemption import (MSG_NO_VICTIMS, MSG_NOT_HELPFUL, _is_unresolvable,
                         _pod_start_time)
from ..models import podspec as ps
from ..models.snapshot import ClusterSnapshot
from ..ops.priority_sort import resolve_priority
from ..utils.config import SchedulerProfile

# per-node status of a dry run
_FITS, _NOT_HELPFUL, _NO_VICTIMS, _CANDIDATE = 0, 1, 2, 3


def fallback_reason(snapshot: ClusterSnapshot, pod: Mapping,
                    profile: SchedulerProfile,
                    extended: bool) -> Optional[str]:
    """The first feature of the input, known before any roster is read,
    that sends the dry run to the oracle's filter chain; None where the
    table's verdicts are exact.  `extended`: extenders take part (their
    Filter veto or ProcessPreemption)."""
    if extended:
        return "extenders"
    if snapshot.pdbs:
        return "pdbs"
    if ps.pod_host_ports(pod):
        return "host_ports"
    if oracle._spread_constraints(pod, "DoNotSchedule"):
        return "spread_constraints"
    if oracle._req_terms(pod, "podAffinity") or \
            oracle._req_terms(pod, "podAntiAffinity"):
        return "pod_affinity"
    if not profile.filter_enabled("NodeResourcesFit"):
        return "fit_disabled"
    return None


class VictimTable:
    """The victim table of one answer's dry runs (module docstring)."""

    def __init__(self, pod: Mapping, profile: SchedulerProfile, device):
        self.pod = pod
        self.profile = profile
        self.device = torch.device(device)
        self._nodes = None               # the node list the rows were built on
        self._dirty: set = set()

    def mark(self, rows: Sequence[int]) -> None:
        """Rows whose roster changed since the last refresh (a commit's
        changed nodes, the nodes holding this cycle's clones)."""
        self._dirty.update(int(i) for i in rows)

    def refresh(self, snapshot: ClusterSnapshot,
                state_pods: List[List[dict]]) -> int:
        """Bring the rows up to `state_pods` (the snapshot's rosters plus
        the cycle's clones): every row where the table has none for this
        snapshot's nodes yet, else the marked rows.  Returns the rows
        rebuilt."""
        if self._nodes is not snapshot.nodes:
            self._build(snapshot)
            rows = list(range(snapshot.num_nodes))
        else:
            rows = sorted(self._dirty)
        self._dirty = set()
        if rows:
            self._set_rows(rows, state_pods)
        return len(rows)

    @property
    def resident_anti_affinity(self) -> bool:
        """A pod in some row carries required pod anti-affinity, which the
        InterPodAffinity filter reads cluster-wide: the oracle's case."""
        return any(self._anti)

    # --- building ---------------------------------------------------------

    def _build(self, snapshot: ClusterSnapshot) -> None:
        """The per-answer part: the incoming pod's columns, allocatable and
        the static verdicts; every row empty."""
        pod, profile = self.pod, self.profile
        self._pcs = snapshot.priority_classes
        self._priority = resolve_priority(pod, self._pcs)
        requests = ps.pod_requests(pod)
        self._names = [k for k, v in requests.items() if v > 0]
        n, r = snapshot.num_nodes, 1 + len(self._names)
        alloc = np.zeros((n, r), dtype=np.int64)
        static_ok = np.zeros(n, dtype=bool)
        unresolvable = np.zeros(n, dtype=bool)
        for i, node in enumerate(snapshot.nodes):
            a = oracle.node_allocatable(node)
            alloc[i] = [a.get("pods", 0)] + [a.get(k, 0) for k in self._names]
            reason = oracle._static_reason(snapshot, i, pod, profile)
            static_ok[i] = reason is None
            unresolvable[i] = _is_unresolvable(reason)
        dev = self.device
        self.want = torch.tensor([1] + [requests[k] for k in self._names],
                                 dtype=torch.int64, device=dev)
        self.alloc = torch.from_numpy(alloc).to(dev)
        self.static_ok = torch.from_numpy(static_ok).to(dev)
        self.unresolvable = torch.from_numpy(unresolvable).to(dev)
        self._nodes = snapshot.nodes
        self.lower: List[List[dict]] = [[] for _ in range(n)]
        self._anti = [False] * n
        self.base = torch.zeros((n, r), dtype=torch.int64, device=dev)
        self.low = torch.zeros((n, 0, r), dtype=torch.int64, device=dev)
        self.valid = torch.zeros((n, 0), dtype=torch.bool, device=dev)
        # the last dry run's host copy and candidate entry per row, and the
        # rows rebuilt since (their entries are recomputed)
        self._last = None
        self._entries: List[Optional[tuple]] = [None] * n
        self._stale: set = set()

    def _set_rows(self, rows: List[int], state_pods: List[List[dict]]) -> None:
        """Rebuild `rows` from their rosters: split them as
        _filter_candidates does (lower priority or not) and sort the lower
        pods into reprieve order.  Each row goes into the host arrays as it
        is read, so no per-pod object outlives its row."""
        names, pcs, priority = self._names, self._pcs, self._priority
        r = 1 + len(names)
        width = max(self.low.shape[1],
                    max(len(state_pods[i]) for i in rows))
        base = np.zeros((len(rows), r), dtype=np.int64)
        low = np.zeros((len(rows), width, r), dtype=np.int64)
        count = np.zeros(len(rows), dtype=np.int64)
        for j, i in enumerate(rows):
            row_base = [0] * r
            lower = []
            anti = False
            for p in state_pods[i]:
                req = ps.pod_requests(p)
                vec = [1] + [req.get(k, 0) for k in names]
                prio = resolve_priority(p, pcs)
                if prio < priority:
                    lower.append((-prio, _pod_start_time(p), p, vec))
                else:
                    row_base = [b + v for b, v in zip(row_base, vec)]
                anti = anti or bool(oracle._req_terms(p, "podAntiAffinity"))
            lower.sort(key=lambda t: (t[0], t[1]))
            base[j] = row_base
            if lower:
                low[j, :len(lower)] = [t[3] for t in lower]
            count[j] = len(lower)
            self.lower[i] = [t[2] for t in lower]
            self._anti[i] = anti
        self._stale.update(rows)
        k = max(self.low.shape[1], int(count.max()))
        if k > self.low.shape[1]:
            n = self.base.shape[0]
            pad = k - self.low.shape[1]
            self.low = torch.cat([self.low, torch.zeros(
                (n, pad, r), dtype=torch.int64, device=self.device)], 1)
            self.valid = torch.cat([self.valid, torch.zeros(
                (n, pad), dtype=torch.bool, device=self.device)], 1)
        idx = torch.tensor(rows, dtype=torch.int64, device=self.device)
        self.base[idx] = torch.from_numpy(base).to(self.device)
        self.low[idx] = torch.from_numpy(low[:, :k]).to(self.device)
        self.valid[idx] = torch.from_numpy(
            np.arange(k) < count[:, None]).to(self.device)

    # --- the dry run ------------------------------------------------------

    def _fits(self, used: torch.Tensor) -> torch.Tensor:
        """Nodes where the incoming pod passes the filter chain over a
        roster charging `used`: the static head, the pod count, and each
        requested resource as want > alloc - used fails (_fit_reasons)."""
        return self.static_ok & (used + self.want <= self.alloc).all(1)

    def dry_run(self) -> Tuple[list, Dict[str, int]]:
        """(candidates as (node_idx, victims, 0) in node order, message
        counts), as preemption._filter_candidates gives them."""
        valid = self.valid
        base = self.base
        low = self.low
        fits_full = self._fits(base + low.sum(1))
        fits_base = self._fits(base)
        used = base
        kept = torch.zeros_like(valid)
        for k in range(low.shape[1]):
            cand = used + low[:, k]
            ok = valid[:, k] & self._fits(cand)
            used = torch.where(ok[:, None], cand, used)
            kept[:, k] = ok
        status = (torch.full_like(fits_full, _CANDIDATE, dtype=torch.int8)
                  .masked_fill(~fits_base, _NOT_HELPFUL)
                  .masked_fill(~valid.any(1), _NO_VICTIMS)
                  .masked_fill(fits_full, _FITS)
                  .masked_fill(self.unresolvable, _NOT_HELPFUL))
        out = torch.cat([status[:, None], (valid & ~kept).to(torch.int8)], 1)
        out = out.cpu().numpy()
        st = out[:, 0]
        counts: Dict[str, int] = {}
        for msg, code in ((MSG_NOT_HELPFUL, _NOT_HELPFUL),
                          (MSG_NO_VICTIMS, _NO_VICTIMS)):
            c = int((st == code).sum())
            if c:
                counts[msg] = c
        # a row's verdict reads that row alone: an entry is made anew only
        # where the row was rebuilt or its status or victim mask moved
        if self._last is None or self._last.shape != out.shape:
            redo = np.arange(len(out))
        else:
            redo = np.union1d(
                np.flatnonzero((out != self._last).any(1)),
                np.fromiter(self._stale, dtype=np.int64))
        for i, row in zip(redo.tolist(), out[redo].tolist()):
            self._entries[i] = None if row[0] != _CANDIDATE else (
                i, [p for p, m in zip(self.lower[i], row[1:]) if m], 0)
        self._last, self._stale = out, set()
        return [e for e in self._entries if e is not None], counts

"""Plain reference of kube-scheduler's DefaultPreemption that the preempt
cell holds the program to: plain PyTorch over the object lists, importing
nothing of the program.

It replays one answer, an interleaving of placements and preemptions,
from the cluster the object lists describe.  At each point it works out
from the state that the program's earlier steps left what the scheduler
does next: where some node fits the pod, a placement on the default
profile's choice (reference/sched.py's filters and scores, highest score,
lowest node index); where none does, DefaultPreemption's dry run.  So a
program whose every step equals that expectation, and which ends where the
reference ends, made the same decisions as the reference's own run, by
induction over the steps.

The dry run runs for every node at once, as tensors on the device, with
each node's pods padded to one width:

- selectVictimsOnNode: every pod of lower priority than the preemptor
  removed; a node where the pod then fits is a candidate; the removed pods
  are tried back one by one in (-priority, start time) order, pods equal in
  both in roster order (the order the pod list gives them on their node,
  clones appended as placed), each kept where the pod still fits, else a
  victim.  The loop runs over reprieve positions across all nodes;
- pickOneNodeForPreemption: fewest PDB violations, lowest highest-victim
  priority, smallest sum of victim priorities each offset by 2**31, fewest
  victims, latest earliest start time among the highest-priority victims
  (a pod without status.startTime starts "now", after every recorded one),
  lowest node index;
- the eviction: the victims leave the node.

Fits are exact integer comparisons (NodeResourcesFit on cpu, memory and
the pod count).  Anything else a pod or node carries that bears on the
dry run (PDBs, priority classes, preemption policies, affinity, spreads on
the preemptor, taints, volumes) is refused with NotImplementedError
rather than judged wrongly.
"""

from __future__ import annotations

import copy
import datetime
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import sched

# the reference compares integers and float32 scores exactly: no TF32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BIG = 2 ** 62
_REFUSED_POD_KEYS = ("affinity", "priorityClassName", "preemptionPolicy",
                     "overhead", "volumes", "resourceClaims",
                     "schedulingGates")


def _unsupported(what: str):
    raise NotImplementedError(f"reference: {what} is not modelled")


def priority_of(pod: dict) -> int:
    """spec.priority; 0 where absent (no priority class is modelled)."""
    spec = pod.get("spec") or {}
    for key in _REFUSED_POD_KEYS:
        if spec.get(key):
            _unsupported(f"pod spec {key} in a preemption")
    return int(spec.get("priority") or 0)


def start_time(pod: dict) -> float:
    """status.startTime in epoch seconds; +inf where absent (the pod counts
    as starting now, after every recorded start)."""
    text = (pod.get("status") or {}).get("startTime")
    if not text:
        return math.inf
    return datetime.datetime.fromisoformat(
        str(text).replace("Z", "+00:00")).timestamp()


def encode_preemptor(pod: dict) -> Tuple[sched.Template, int]:
    """(the placement template sched.py judges, the pod's priority)."""
    prio = priority_of(pod)
    spec = pod.get("spec") or {}
    if spec.get("topologySpreadConstraints"):
        _unsupported("spreads on a preempting pod")
    bare = copy.deepcopy(pod)
    bare["spec"].pop("priority", None)
    return sched.encode_template(bare), prio


def fits(alloc: torch.Tensor, used: torch.Tensor,
         req: torch.Tensor) -> torch.Tensor:
    """NodeResourcesFit per node, in integers: one more pod under the pod
    count, and every requested cpu and memory within what is free."""
    ok = used[..., sched.PODS] + 1 <= alloc[..., sched.PODS]
    for r in (sched.CPU, sched.MEM):
        ok &= (req[..., r] == 0) | (req[..., r] <= alloc[..., r] - used[..., r])
    return ok


def pick(cand: torch.Tensor, pdb: torch.Tensor, highest: torch.Tensor,
         sum_offset: torch.Tensor, count: torch.Tensor,
         earliest: torch.Tensor) -> Optional[int]:
    """pickOneNodeForPreemption over per-node statistics (candidates where
    `cand`): the criteria in order, each keeping the nodes that are best by
    it, then the lowest node index."""
    m = cand.clone()
    if not bool(m.any()):
        return None
    for crit in (pdb, highest, sum_offset, count):         # smaller wins
        best = torch.where(m, crit, torch.full_like(crit, BIG)).amin()
        m &= crit == best
    best = torch.where(m, earliest, torch.full_like(earliest, -math.inf)).amax()
    m &= earliest == best                                   # latest wins
    return int(torch.nonzero(m)[0, 0])


@dataclass
class Preemption:
    node: int
    victims: List[str]


@dataclass
class Replay:
    """The cluster's state as the replay goes: per-node usage, and each
    node's pods in roster order as indices into the pod table (-1 where a
    pod has left)."""
    cluster: sched.Cluster
    pb: sched.Problem
    req: torch.Tensor                  # int64[M, 3] cpu, memory, one pod
    nz: torch.Tensor                   # int64[M, 2]
    prio: torch.Tensor                 # int64[M]
    start: torch.Tensor                # float64[M]
    names: List[str]
    resident: List[bool]               # False for the placed clones
    slots: torch.Tensor                # int64[N, P]
    used: torch.Tensor                 # int64[N, 3]
    nonzero: torch.Tensor              # int64[N, 2]
    pod_prio: int = 0
    where: Dict[str, Tuple[int, int]] = field(default_factory=dict)

    @property
    def state(self) -> sched.State:
        return sched.State(self.used, self.nonzero, self.pb.cnt0)

    def choose(self, dtype) -> int:
        """The default profile's node for the pod (-1 where none fits)."""
        k = torch.zeros(1, dtype=torch.int64, device=self.pb.device)
        feasible, _fit, _spread = sched._filters(
            self.pb, k, self.used[None], self.pb.cnt0, dtype)
        score = sched._scores(self.pb, k, self.used[None],
                              self.nonzero[None], dtype)
        keyed = torch.where(feasible, score,
                            torch.tensor(-1.0, dtype=dtype,
                                         device=self.pb.device))
        return int(sched._choose(keyed)[0]) if bool(feasible.any()) else -1

    def place(self, node: int) -> None:
        """A clone of the pod on `node`, appended to its roster."""
        dev = self.pb.device
        m = len(self.names)
        self.names.append(f"<clone {m}>")
        self.resident.append(False)
        self.req = torch.cat([self.req, self.pb.req[:1]])
        self.nz = torch.cat([self.nz, self.pb.nz_req[:1]])
        self.prio = torch.cat([self.prio, torch.tensor(
            [self.pod_prio], dtype=torch.int64, device=dev)])
        self.start = torch.cat([self.start, torch.tensor(
            [math.inf], dtype=torch.float64, device=dev)])
        held = torch.nonzero(self.slots[node] >= 0)
        col = int(held[-1, 0]) + 1 if held.numel() else 0
        if col >= self.slots.shape[1]:
            pad = torch.full((self.slots.shape[0], 1), -1, dtype=torch.int64,
                             device=dev)
            self.slots = torch.cat([self.slots, pad], 1)
        self.slots[node, col] = m
        self.where[self.names[m]] = (node, col)
        self.used[node] += self.pb.req[0]
        self.nonzero[node] += self.pb.nz_req[0]

    def evict(self, names: Sequence[str]) -> None:
        """The named pods leave their nodes (names it does not hold are
        passed over)."""
        for name in names:
            at = self.where.pop(name, None)
            if at is None:
                continue
            node, col = at
            m = int(self.slots[node, col])
            self.slots[node, col] = -1
            self.used[node] -= self.req[m]
            self.nonzero[node] -= self.nz[m]

    def dry_run(self) -> Optional[Preemption]:
        """DefaultPreemption's dry run on every node, then the node
        pickOneNodeForPreemption takes: None where no node is a
        candidate."""
        alloc = self.pb.alloc
        pod_req = self.pb.req[0]
        valid = self.slots >= 0
        idx = self.slots.clamp(min=0)
        req = self.req[idx] * valid[..., None]              # [N, P, 3]
        prio = self.prio[idx]
        start = self.start[idx]
        lower = valid & (prio < self.pod_prio)
        fits_now = fits(alloc, self.used, pod_req)
        base = self.used - (req * lower[..., None]).sum(1)
        cand = ~fits_now & lower.any(1) & fits(alloc, base, pod_req)
        # reprieve order: (-priority, start time, roster position), the
        # other pods after them
        o1 = torch.sort(start, dim=1, stable=True).indices
        key = torch.where(lower, -prio, torch.full_like(prio, BIG))
        o2 = torch.sort(key.gather(1, o1), dim=1, stable=True).indices
        order = o1.gather(1, o2)
        victim = torch.zeros_like(lower)
        for j in range(order.shape[1]):
            s = order[:, j:j + 1]
            trying = lower.gather(1, s)[:, 0] & cand
            trial = base + req.gather(
                1, s[..., None].expand(-1, 1, 3))[:, 0]
            ok = fits(alloc, trial, pod_req)
            base = torch.where((trying & ok)[:, None], trial, base)
            victim.scatter_(1, s, (trying & ~ok)[:, None])
        victim &= cand[:, None]
        count = victim.sum(1)
        vprio = torch.where(victim, prio, torch.full_like(prio, -BIG))
        highest = vprio.amax(1)
        sum_offset = torch.where(victim, prio + 2 ** 31,
                                 torch.zeros_like(prio)).sum(1)
        top = victim & (prio == highest[:, None])
        earliest = torch.where(top, start, torch.full_like(start, math.inf)
                               ).amin(1)
        node = pick(cand, torch.zeros_like(count), highest, sum_offset,
                    count, earliest)
        if node is None:
            return None
        cols = torch.nonzero(victim[node])[:, 0].tolist()
        return Preemption(node, [self.names[int(self.slots[node, c])]
                                 for c in cols])

    def rosters(self) -> List[Tuple[frozenset, int]]:
        """Per node: the names of its residents, and how many clones it
        holds."""
        out = []
        for row in self.slots.cpu().tolist():
            ms = [m for m in row if m >= 0]
            out.append((frozenset(self.names[m] for m in ms
                                  if self.resident[m]),
                        sum(1 for m in ms if not self.resident[m])))
        return out


def start_replay(nodes: Sequence[dict], pods: Sequence[dict], pod: dict,
                 device) -> Replay:
    """The replay at the cluster the object lists describe."""
    cluster = sched.Cluster(nodes, pods)
    tpl, pod_prio = encode_preemptor(pod)
    pb = sched.Problem(cluster, [tpl], device=device)
    dev = pb.device
    n = cluster.num_nodes
    per_node: List[List[int]] = [[] for _ in range(n)]
    req, nz, prio, start, names = [], [], [], [], []
    for p in pods:
        if ((p.get("status") or {}).get("phase")) in sched.TERMINAL:
            continue
        i = cluster.index.get((p.get("spec") or {}).get("nodeName"))
        if i is None:
            continue
        r, z = sched._requests(p)
        per_node[i].append(len(names))
        req.append((r.get("cpu", 0), r.get("memory", 0), 1))
        nz.append(z)
        prio.append(priority_of(p))
        start.append(start_time(p))
        names.append((p.get("metadata") or {}).get("name", ""))
    if len(set(names)) != len(names):
        _unsupported("pods that share a name")
    width = max([len(x) for x in per_node] + [1])
    slots = np.full((n, width), -1, np.int64)
    where = {}
    for i, ms in enumerate(per_node):
        slots[i, :len(ms)] = ms
        for c, m in enumerate(ms):
            where[names[m]] = (i, c)
    t = lambda a, dt, w: torch.as_tensor(np.asarray(a, dt).reshape(w),
                                         device=dev)
    return Replay(
        cluster=cluster, pb=pb, req=t(req, np.int64, (-1, 3)),
        nz=t(nz, np.int64, (-1, 2)), prio=t(prio, np.int64, -1),
        start=t(start, np.float64, -1), names=names,
        resident=[True] * len(names), slots=torch.as_tensor(slots, device=dev),
        used=pb.used0.clone(), nonzero=pb.nonzero0.clone(),
        pod_prio=pod_prio, where=where)


@dataclass
class Verdict:
    """What the replay of one answer found: steps that differ from the
    reference (placements off its node, preemptions whose node or victim
    set differs or that name PDB violations, steps missing or left over),
    the lower precisions' placement choices that differ from the first
    dtype's, the expected end, and the state after the last preemption
    (the working snapshot the program keeps)."""
    cluster: sched.Cluster
    step_diff: int
    control: Dict[torch.dtype, int]
    fail_type: str
    fail_message: str
    committed: List[Tuple[frozenset, int]]
    committed_used: np.ndarray
    committed_nonzero: np.ndarray


def judge(nodes: Sequence[dict], pods: Sequence[dict], pod: dict,
          placed: Sequence[str], preemptions: Sequence[dict], limit: int,
          device, dtypes=(torch.float32,), pdbs: Sequence[dict] = ()
          ) -> Verdict:
    """Replay the program's placements (node names, in order) and
    preemptions ({"node", "victims", "pdb_violations"}, in order), each
    judged from the state the program's earlier steps left."""
    if pdbs:
        _unsupported("PodDisruptionBudgets")
    rp = start_replay(nodes, pods, pod, device)
    n_names = rp.cluster.index
    diff = 0
    control = {dt: 0 for dt in dtypes[1:]}
    i_place = i_pre = 0
    committed = (rp.rosters(), rp.used.cpu().numpy().copy(),
                 rp.nonzero.cpu().numpy().copy())
    while not (limit and i_place >= limit):
        choice = rp.choose(dtypes[0])
        if choice >= 0:
            if i_place >= len(placed):
                diff += 1                 # stopped where a node fits
                break
            for dt in dtypes[1:]:
                control[dt] += int(rp.choose(dt) != choice)
            got = n_names.get(placed[i_place], -1)
            diff += int(got != choice)
            rp.place(got if got >= 0 else choice)
            i_place += 1
            continue
        ref = rp.dry_run()
        if ref is None:
            break                         # no candidate: Unschedulable
        if i_pre >= len(preemptions):
            diff += 1                     # stopped where a preemption is due
            break
        got = preemptions[i_pre]
        i_pre += 1
        diff += int(n_names.get(got.get("node"), -1) != ref.node
                    or sorted(got.get("victims") or []) != sorted(ref.victims)
                    or int(got.get("pdb_violations") or 0) != 0)
        rp.evict(list(got.get("victims") or []))
        committed = (rp.rosters(), rp.used.cpu().numpy().copy(),
                     rp.nonzero.cpu().numpy().copy())
    diff += (len(placed) - i_place) + (len(preemptions) - i_pre)
    if limit and i_place >= limit:
        ftype, msg = "LimitReached", \
            f"Maximum number of pods simulated: {limit}"
    else:
        _any, counts = sched.final_verdict(rp.pb, rp.state, 0)
        ftype, msg = "Unschedulable", sched.fit_error(
            rp.cluster.num_nodes, counts)
    return Verdict(rp.cluster, diff, control, ftype, msg, *committed)


def run(nodes: Sequence[dict], pods: Sequence[dict], pod: dict, limit: int,
        device, dtype=torch.float32) -> Tuple[List[str], List[dict], str]:
    """The reference's own run of the question: (placements as node names,
    preemptions as {"node", "victims", "pdb_violations"}, fail type).  The
    tests put it in the program's place."""
    rp = start_replay(nodes, pods, pod, device)
    placed: List[str] = []
    made: List[dict] = []
    while not (limit and len(placed) >= limit):
        choice = rp.choose(dtype)
        if choice >= 0:
            rp.place(choice)
            placed.append(rp.cluster.names[choice])
            continue
        ref = rp.dry_run()
        if ref is None:
            return placed, made, "Unschedulable"
        made.append({"node": rp.cluster.names[ref.node],
                     "victims": list(ref.victims), "pdb_violations": 0})
        rp.evict(ref.victims)
    return placed, made, "LimitReached"

"""Plain reference of the kube-scheduler greedy loop that the benchmark
holds the program to: plain PyTorch over the object lists, importing
nothing of the program.

It encodes the cluster itself (node order, allocatable, resident usage,
spread counts) and replays a sequence of placements (template k_t placed
on node n_t) step by step: before step t it works out the state that the
earlier placements left, filters every node, scores the feasible ones and
takes the best (highest score, lowest node index).  A program whose every
placement equals that choice, and which stops where the reference finds no
feasible node or at the limit, made the same decisions as the reference's
own greedy run from the same start, by induction over the steps.  The
steps of a block are judged at once: the state of each is the block's
start plus the placements before it.

Semantics kept (the default profile, float32 arithmetic as the profile
states; default_plugins.go weights): NodeResourcesFit filter and
LeastAllocated score on cpu and memory with the non-zero request defaults,
NodeResourcesBalancedAllocation on cpu and memory, TaintToleration's score
on untainted nodes (100 each, weight 3), ImageLocality on nodes that list
no images (0), hard PodTopologySpread (DoNotSchedule) constraints with
matchLabels selectors.  Anything else an object carries (taints, affinity,
node selectors, host ports, volumes, soft spreads, images on nodes, other
resources, priorities that allow preemption) is refused with
NotImplementedError rather than judged wrongly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .cluster import milli, units

CPU, MEM, PODS = 0, 1, 2
RESOURCES = ("cpu", "memory", "pods")
DEFAULT_CPU = 100                    # milli-cpu for a missing cpu request
DEFAULT_MEM = 200 * 1024 * 1024      # bytes for a missing memory request
W_FIT, W_BAL, W_TAINT, W_IMAGE = 1, 1, 3, 1
TERMINAL = ("Succeeded", "Failed")
SPREAD_FAIL = "node(s) didn't match pod topology spread constraints"
SPREAD_MISSING = SPREAD_FAIL + " (missing required label)"


def _unsupported(what: str):
    raise NotImplementedError(f"reference: {what} is not modelled")


def _requests(pod: dict) -> Tuple[Dict[str, int], Tuple[int, int]]:
    """(requests {resource: int}, non-zero (cpu, memory)) of a pod."""
    spec = pod.get("spec") or {}
    if spec.get("initContainers") or spec.get("overhead"):
        _unsupported("init containers or pod overhead")
    req: Dict[str, int] = {}
    nz_cpu = nz_mem = 0
    for c in spec.get("containers") or []:
        r = ((c.get("resources") or {}).get("requests")) or {}
        for name, q in r.items():
            if name not in ("cpu", "memory"):
                _unsupported(f"resource {name}")
            v = milli(q) if name == "cpu" else units(q)
            req[name] = req.get(name, 0) + v
        nz_cpu += milli(r["cpu"]) if "cpu" in r else DEFAULT_CPU
        nz_mem += units(r["memory"]) if "memory" in r else DEFAULT_MEM
        for p in c.get("ports") or []:
            if p.get("hostPort"):
                _unsupported("host ports")
    return req, (nz_cpu, nz_mem)


def _matches(selector: dict, labels: dict) -> bool:
    if set(selector) - {"matchLabels"}:
        _unsupported("label selector expressions")
    return all(labels.get(k) == v
               for k, v in (selector.get("matchLabels") or {}).items())


@dataclass
class Constraint:
    key: str
    max_skew: int
    selector: dict
    min_domains: int


@dataclass
class Template:
    name: str
    namespace: str
    labels: dict
    req: np.ndarray              # int64[3]: cpu milli, memory bytes, 1 pod
    nonzero: np.ndarray          # int64[2]
    constraints: List[Constraint]


def encode_template(pod: dict) -> Template:
    meta = pod.get("metadata") or {}
    spec = pod.get("spec") or {}
    for key in ("affinity", "nodeSelector", "nodeName", "volumes",
                "schedulingGates", "priorityClassName", "priority",
                "resourceClaims"):
        if spec.get(key):
            _unsupported(f"pod spec {key}")
    req, nz = _requests(pod)
    constraints = []
    for c in spec.get("topologySpreadConstraints") or []:
        if (c.get("whenUnsatisfiable") or "DoNotSchedule") != "DoNotSchedule":
            _unsupported("ScheduleAnyway spreads")
        if c.get("nodeTaintsPolicy") == "Honor" or c.get("matchLabelKeys"):
            _unsupported("spread taint policy or matchLabelKeys")
        constraints.append(Constraint(
            key=c.get("topologyKey") or "", max_skew=int(c.get("maxSkew", 1)),
            selector=c.get("labelSelector") or {},
            min_domains=int(c.get("minDomains") or 1)))
    return Template(
        name=meta.get("name", ""),
        namespace=meta.get("namespace") or "default",
        labels=dict(meta.get("labels") or {}),
        req=np.array([req.get("cpu", 0), req.get("memory", 0), 1], np.int64),
        nonzero=np.array(nz, np.int64), constraints=constraints)


class Cluster:
    """The reference's own encoding of the object lists: nodes sorted by
    name (the default scheduler snapshot's order in this tool), allocatable
    and resident usage per node."""

    def __init__(self, nodes: Sequence[dict], pods: Sequence[dict]):
        nodes = sorted(nodes, key=lambda n: n["metadata"]["name"])
        self.names = [n["metadata"]["name"] for n in nodes]
        self.index = {name: i for i, name in enumerate(self.names)}
        self.labels = [dict(n["metadata"].get("labels") or {})
                       for n in nodes]
        n_nodes = len(nodes)
        self.alloc = np.zeros((n_nodes, 3), np.int64)
        for i, node in enumerate(nodes):
            spec = node.get("spec") or {}
            status = node.get("status") or {}
            if spec.get("taints") or spec.get("unschedulable"):
                _unsupported("node taints or cordons")
            if status.get("images"):
                _unsupported("node images")
            alloc = status.get("allocatable") or {}
            self.alloc[i] = (milli(alloc.get("cpu", 0)),
                             units(alloc.get("memory", 0)),
                             units(alloc.get("pods", 0)))
        self.used = np.zeros((n_nodes, 3), np.int64)
        self.nonzero = np.zeros((n_nodes, 2), np.int64)
        # residents by (namespace, labels): how many on each node
        self.resident_groups: Dict[tuple, np.ndarray] = {}
        for pod in pods:
            if ((pod.get("status") or {}).get("phase")) in TERMINAL:
                continue
            i = self.index.get((pod.get("spec") or {}).get("nodeName"))
            if i is None:
                continue
            req, nz = _requests(pod)
            self.used[i] += (req.get("cpu", 0), req.get("memory", 0), 1)
            self.nonzero[i] += nz
            meta = pod.get("metadata") or {}
            key = (meta.get("namespace") or "default",
                   tuple(sorted((meta.get("labels") or {}).items())))
            self.resident_groups.setdefault(
                key, np.zeros(n_nodes, np.int64))[i] += 1

    @property
    def num_nodes(self) -> int:
        return len(self.names)


class Problem:
    """The tensors one judgement reads: the cluster and K templates, on a
    device.  Integers stay exact (int64); the score arithmetic runs in
    `dtype`."""

    def __init__(self, cluster: Cluster, templates: Sequence[Template],
                 device="cpu"):
        self.cluster = cluster
        self.templates = list(templates)
        dev = torch.device(device)
        self.device = dev
        n, k = cluster.num_nodes, len(self.templates)
        keys = sorted({c.key for t in self.templates for c in t.constraints})
        vocab = [dict() for _ in keys]
        dom = np.full((max(len(keys), 1), n), -1, np.int64)
        for ki, key in enumerate(keys):
            for i, labels in enumerate(cluster.labels):
                if key in labels:
                    dom[ki, i] = vocab[ki].setdefault(labels[key],
                                                      len(vocab[ki]))
        d_max = max([len(v) for v in vocab] + [1])
        c_max = max([len(t.constraints) for t in self.templates] + [1])
        key_of = np.zeros((k, c_max), np.int64)
        active = np.zeros((k, c_max), bool)
        skew = np.zeros((k, c_max), np.int64)
        self_match = np.zeros((k, c_max), np.int64)
        min_dom = np.ones((k, c_max), np.int64)
        # match[j, k, c]: a clone of template j counts for constraint c of k
        match = np.zeros((k, k, c_max), np.int64)
        cnt0 = np.zeros((k, c_max, d_max), np.int64)
        has_all = np.ones((k, n), bool)
        for ti, t in enumerate(self.templates):
            for ci, c in enumerate(t.constraints):
                ki = keys.index(c.key)
                key_of[ti, ci] = ki
                active[ti, ci] = True
                skew[ti, ci] = c.max_skew
                min_dom[ti, ci] = c.min_domains
                self_match[ti, ci] = _matches(c.selector, t.labels)
                has_all[ti] &= dom[ki] >= 0
                for tj, u in enumerate(self.templates):
                    match[tj, ti, ci] = (u.namespace == t.namespace and
                                         _matches(c.selector, u.labels))
            for ci, c in enumerate(t.constraints):
                ki = key_of[ti, ci]
                hits = np.zeros(n, np.int64)
                for (ns, labels), where in cluster.resident_groups.items():
                    if ns == t.namespace and _matches(c.selector,
                                                      dict(labels)):
                        hits += where
                hits = np.where(has_all[ti], hits, 0)
                cnt0[ti, ci, :d_max] += np.bincount(
                    dom[ki][hits > 0], weights=hits[hits > 0],
                    minlength=d_max).astype(np.int64)[:d_max]
        # a domain counts towards minMatchNum when a countable node has it
        valid = np.zeros((k, c_max, d_max), bool)
        for ti in range(k):
            for ci in range(c_max):
                if active[ti, ci]:
                    d = dom[key_of[ti, ci]][has_all[ti]]
                    valid[ti, ci, np.unique(d[d >= 0])] = True
        t_ = lambda a: torch.as_tensor(a, device=dev)
        self.alloc = t_(cluster.alloc)
        self.used0 = t_(cluster.used)
        self.nonzero0 = t_(cluster.nonzero)
        self.req = t_(np.stack([t.req for t in self.templates]))
        self.nz_req = t_(np.stack([t.nonzero for t in self.templates]))
        self.dom = t_(dom)
        self.key_of, self.active = t_(key_of), t_(active)
        self.skew, self.self_match = t_(skew), t_(self_match)
        self.min_dom, self.match = t_(min_dom), t_(match)
        self.cnt0, self.valid, self.has_all = t_(cnt0), t_(valid), t_(has_all)
        self.d_max, self.c_max = d_max, c_max


@dataclass
class State:
    """Cluster state after some placements: per-node usage and, per
    template and constraint, the matching pods per domain."""
    used: torch.Tensor       # int64[N, 3]
    nonzero: torch.Tensor    # int64[N, 2]
    cnt: torch.Tensor        # int64[K, C, D]


def start_state(pb: Problem) -> State:
    return State(pb.used0.clone(), pb.nonzero0.clone(), pb.cnt0.clone())


def _node_domains(pb: Problem, k: torch.Tensor) -> torch.Tensor:
    """int64[T, C, N]: the domain of every node under each constraint of
    template k_t (-1 where the node lacks the key)."""
    return pb.dom[pb.key_of[k]]


def _filters(pb: Problem, k: torch.Tensor, used, cnt, dtype):
    """Per step t (template k_t) and node: (feasible, fit parts, spread
    parts).  used: int64[T, N, 3]; cnt: int64[T, C, D]."""
    f = lambda x: x.to(dtype)
    alloc = f(pb.alloc)[None]                              # [1, N, 3]
    req = f(pb.req[k])                                     # [T, 3]
    too_many = f(used[..., PODS]) + 1.0 > alloc[..., PODS]
    free = alloc - f(used)
    insufficient = (req[:, None, :] > free) & (req[:, None, :] > 0)
    insufficient[..., PODS] = False
    fit_ok = ~(too_many | insufficient.any(-1))
    doms = _node_domains(pb, k)                            # [T, C, N]
    has_key = doms >= 0
    cnt_node = torch.gather(f(cnt), 2, doms.clamp(min=0))  # [T, C, N]
    big = torch.tensor(float(2 ** 30), dtype=dtype, device=pb.device)
    valid = pb.valid[k]                                    # [T, C, D]
    min_match = torch.where(valid, f(cnt), big).amin(-1)   # [T, C]
    n_dom = valid.sum(-1)
    min_match = torch.where(n_dom < pb.min_dom[k], 0.0, min_match)
    skew = cnt_node + f(pb.self_match[k])[..., None] - min_match[..., None]
    active = pb.active[k][..., None]
    violated = ((skew > f(pb.skew[k])[..., None]) & has_key
                & active).any(1)
    missing = (~has_key & active).any(1)
    spread_ok = ~(missing | violated)
    return fit_ok & spread_ok, (too_many, insufficient, fit_ok), \
        (missing, spread_ok)


def _scores(pb: Problem, k: torch.Tensor, used, nonzero, dtype):
    """float[T, N]: the weighted score total of template k_t on every
    node, the profile's terms summed in order."""
    f = lambda x: x.to(dtype)
    alloc = f(pb.alloc[:, :2])[None]                       # [1, N, 2]
    hundred = torch.tensor(100.0, dtype=dtype, device=pb.device)
    # LeastAllocated over cpu and memory, non-zero requests, weights 1, 1
    req_nz = f(nonzero + pb.nz_req[k][:, None, :])         # [T, N, 2]
    per = torch.where(req_nz > alloc, 0.0,
                      torch.floor((alloc - req_nz) * hundred / alloc))
    fit = torch.floor((per[..., 0] + per[..., 1]) / 2.0)
    # BalancedAllocation over cpu and memory, actual requests
    req = f(used[..., :2] + pb.req[k][:, None, :2])
    frac = torch.minimum(req / alloc, torch.ones((), dtype=dtype,
                                                 device=pb.device))
    mean = (frac[..., 0] + frac[..., 1]) / 2.0
    d0, d1 = frac[..., 0] - mean, frac[..., 1] - mean
    std = torch.sqrt((d0 * d0 + d1 * d1) / 2.0)
    bal = torch.trunc((1.0 - std) * hundred)
    taint = torch.full_like(fit, 100.0)    # no node has a taint
    image = torch.zeros_like(fit)          # no node lists an image
    total = torch.zeros_like(fit)
    for w, term in ((W_FIT, fit), (W_BAL, bal), (W_TAINT, taint),
                    (W_IMAGE, image)):
        total = total + w * term
    return total


def _block_states(pb: Problem, st: State, k: torch.Tensor, n: torch.Tensor):
    """The state before each step of a block (exclusive prefix sums of the
    block's placements onto the block's start)."""
    t_n = k.shape[0]
    rows = torch.arange(t_n, device=pb.device)
    nn = pb.cluster.num_nodes
    add = torch.zeros((t_n, nn, 3), dtype=torch.int64, device=pb.device)
    add[rows, n] = pb.req[k]
    used = st.used[None] + torch.cumsum(add, 0) - add
    addz = torch.zeros((t_n, nn, 2), dtype=torch.int64, device=pb.device)
    addz[rows, n] = pb.nz_req[k]
    nonzero = st.nonzero[None] + torch.cumsum(addz, 0) - addz
    # clone of k_s lands in domain dom[key(j, c)][n_s] for every template j
    doms = pb.dom[pb.key_of][:, :, n]                     # [K, C, T]
    hit = torch.zeros((t_n,) + tuple(pb.cnt0.shape), dtype=torch.int64,
                      device=pb.device)                  # [T, K, C, D]
    gain = pb.match[k] * (doms.permute(2, 0, 1) >= 0)     # [T, K, C]
    hit.scatter_add_(3, doms.permute(2, 0, 1).clamp(min=0)[..., None],
                     gain[..., None])
    cnt_all = st.cnt[None] + torch.cumsum(hit, 0) - hit   # [T, K, C, D]
    cnt = cnt_all[rows, k]                                # [T, C, D]
    after = State(used[-1] + add[-1], nonzero[-1] + addz[-1],
                  cnt_all[-1] + hit[-1])
    return used, nonzero, cnt, after


def _choose(keyed: torch.Tensor) -> torch.Tensor:
    """Highest score, lowest node index among equals."""
    best = keyed.amax(-1, keepdim=True)
    idx = torch.arange(keyed.shape[-1], device=keyed.device)
    return torch.where(keyed == best, idx, keyed.shape[-1]).amin(-1)


def judge(pb: Problem, seq_k: Sequence[int], seq_n: Sequence[int],
          dtypes=(torch.float32,), block_elems: int = 1 << 26):
    """Replay the sequence; for each dtype, the reference's choice before
    every step (int64[T], -1 where no node is feasible).  Returns
    ({dtype: choices}, the state after the whole sequence)."""
    k_all = torch.as_tensor(np.asarray(seq_k, np.int64), device=pb.device)
    n_all = torch.as_tensor(np.asarray(seq_n, np.int64), device=pb.device)
    total = k_all.shape[0]
    step = max(1, block_elems // max(1, pb.cluster.num_nodes * 3))
    out = {dt: [] for dt in dtypes}
    st = start_state(pb)
    for b0 in range(0, total, step):
        k = k_all[b0:b0 + step]
        n = n_all[b0:b0 + step]
        used, nonzero, cnt, after = _block_states(pb, st, k, n)
        for dt in dtypes:
            feasible, _fit, _spread = _filters(pb, k, used, cnt, dt)
            score = _scores(pb, k, used, nonzero, dt)
            keyed = torch.where(feasible, score,
                                torch.tensor(-1.0, dtype=dt,
                                             device=pb.device))
            choice = _choose(keyed)
            out[dt].append(torch.where(feasible.any(-1), choice, -1))
        st = after
    return ({dt: (torch.cat(v).cpu().numpy() if v else
                  np.zeros(0, np.int64)) for dt, v in out.items()}, st)


def final_verdict(pb: Problem, st: State, ti: int,
                  dtype=torch.float32) -> Tuple[bool, Dict[str, int]]:
    """(any node feasible for template ti, the FitError reasons histogram)
    at state st."""
    k = torch.tensor([ti], device=pb.device)
    feasible, (too_many, insufficient, fit_ok), (missing, spread_ok) = \
        _filters(pb, k, st.used[None], st.cnt[ti][None], dtype)
    counts: Dict[str, int] = {}

    def add(reason: str, v) -> None:
        v = int(v)
        if v:
            counts[reason] = counts.get(reason, 0) + v

    fit_fail = ~fit_ok[0]
    add("Too many pods", (fit_fail & too_many[0]).sum())
    for r in (CPU, MEM):
        add(f"Insufficient {RESOURCES[r]}",
            (fit_fail & insufficient[0, :, r]).sum())
    rest = fit_ok[0]
    add(SPREAD_MISSING, (rest & missing[0]).sum())
    add(SPREAD_FAIL, (rest & ~missing[0] & ~spread_ok[0]).sum())
    return bool(feasible.any()), counts


def fit_error(num_nodes: int, counts: Dict[str, int]) -> str:
    """FitError.Error(): '0/N nodes are available: ' and the sorted
    '<count> <reason>' strings."""
    parts = sorted(f"{v} {k}" for k, v in counts.items())
    msg = f"0/{num_nodes} nodes are available"
    return msg + (": " + ", ".join(parts) + "." if parts else "")


def expected_end(pb: Problem, st: State, ti: int, placed: int,
                 limit: int) -> Tuple[bool, str, str]:
    """(the sequence ended where it had to, fail type, fail message) of
    template ti after `placed` placements under `limit` (0: none)."""
    if limit and placed >= limit:
        return (placed == limit, "LimitReached",
                f"Maximum number of pods simulated: {limit}")
    any_feasible, counts = final_verdict(pb, st, ti)
    return (not any_feasible, "Unschedulable",
            fit_error(pb.cluster.num_nodes, counts))


def greedy(pb: Problem, ti: int, limit: int = 0, dtype=torch.float32
           ) -> List[int]:
    """The reference's own greedy run of template ti, one step at a time:
    the reference put in the program's place (tests, and the control in
    a lower precision)."""
    st = start_state(pb)
    k = torch.tensor([ti], device=pb.device)
    out: List[int] = []
    while not limit or len(out) < limit:
        feasible, _fit, _spread = _filters(pb, k, st.used[None],
                                           st.cnt[ti][None], dtype)
        if not bool(feasible.any()):
            break
        score = _scores(pb, k, st.used[None], st.nonzero[None], dtype)
        c = int(_choose(torch.where(feasible, score, -1.0))[0])
        out.append(c)
        st = _block_states(pb, st, k, torch.tensor([c], device=pb.device))[3]
    return out


def first_seen_counts(names: Sequence[str]) -> List[Tuple[str, int]]:
    """Per-node replicas in first-placement order (parsePodsReview)."""
    counts: Dict[str, int] = {}
    for name in names:
        counts[name] = counts.get(name, 0) + 1
    return list(counts.items())


def node_rows(cluster: Cluster) -> Dict[str, tuple]:
    """What the snapshot layer must hold per node: allocatable (cpu, memory,
    pods), resident requests (cpu, memory, pod count) and non-zero
    requests (cpu, memory), by node name."""
    return {name: (tuple(cluster.alloc[i]), tuple(cluster.used[i]),
                   tuple(cluster.nonzero[i]))
            for i, name in enumerate(cluster.names)}


def check_order(names: Sequence[str], cluster: Cluster) -> int:
    """Positions whose node differs from the reference's order."""
    ref = cluster.names
    return sum(1 for a, b in zip(names, ref) if a != b) + \
        abs(len(names) - len(ref))

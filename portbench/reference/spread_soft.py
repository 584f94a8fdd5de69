"""Plain reference of kube-scheduler's PodTopologySpread score (its
ScheduleAnyway constraints), added to the greedy loop that
reference/sched.py replays: plain PyTorch over the object lists, importing
nothing of the program.

It judges one sequence of placements of one pod (clones of it, each placed
clone an existing pod for the steps after it), block by block as sched.py
does: the state before each step is the block's start plus the placements
before it.  Each step filters every node with sched.py's filters (the pod
handed to sched.py without its ScheduleAnyway constraints), scores the
feasible ones with sched.py's scores plus PodTopologySpread's, and takes
the best (highest score, lowest node index).

PodTopologySpread's score as upstream's plugin (podtopologyspread/
scoring.go, the default profile's weight 2), for the constraints the pod
declares:

- only `whenUnsatisfiable: ScheduleAnyway` constraints score; a pod that
  declares constraints never gets the system defaults, and every node
  must carry every soft constraint's key (requireAllTopologies): a node
  that lacks one is ignored, scores 0 and counts no pod;
- a constraint's selector matches pods in the pod's own namespace, by
  matchLabels and matchExpressions (In, NotIn, Exists, DoesNotExist); no
  selector matches nothing, an empty one everything;
- counts: for a zone-like key, the matching pods on every node of the
  domain that is not ignored (feasible or not); for the hostname key, the
  matching pods on the node itself;
- topoSize: the distinct domains among the feasible nodes that are not
  ignored; for the hostname key, the count of those nodes;
- raw score: sum over the constraints the node carries of cnt *
  log(topoSize + 2) + (maxSkew - 1), rounded;
- NormalizeScore over the scored (feasible, not ignored) nodes:
  100 * (max + min - s) / max, 100 where max is 0, times the weight 2.

Departures from upstream, kept because the program keeps them (the
configuration's `guarantees` state the float32 profile): the arithmetic
runs in `dtype` (float32) in place of float64 and int64, with the log
weight computed in float64 and rounded once to float32; the raw score
rounds half to even (torch.round) where upstream's math.Round rounds half
away from zero; the normalisation is floor(((max + min) - s) * 100 / max)
in `dtype`, upstream's an int64 division.  `census` counts where these
meet a published shape.

Refused with NotImplementedError rather than judged wrongly: matchLabelKeys,
nodeTaintsPolicy Honor, nodeAffinityPolicy Ignore, pods with a
deletionTimestamp, and whatever sched.py refuses on the pod or the
cluster (node affinity and selectors, taints, host ports, ...).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import sched

# the reference compares integers and float32 scores exactly: no TF32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

W_SPREAD = 2                    # default_plugins.go: PodTopologySpread
MAX_NODE_SCORE = 100
HOSTNAME_KEY = "kubernetes.io/hostname"
SOFT = "ScheduleAnyway"
_OPERATORS = ("In", "NotIn", "Exists", "DoesNotExist")


def _unsupported(what: str):
    raise NotImplementedError(f"reference: {what} is not modelled")


def selector_matches(selector, labels: dict) -> bool:
    """A metav1.LabelSelector against a pod's labels: None matches
    nothing, {} everything."""
    if selector is None:
        return False
    if set(selector) - {"matchLabels", "matchExpressions"}:
        _unsupported(f"selector fields {sorted(selector)}")
    if any(labels.get(k) != v
           for k, v in (selector.get("matchLabels") or {}).items()):
        return False
    for e in selector.get("matchExpressions") or []:
        op, key = e.get("operator"), e.get("key")
        values = list(e.get("values") or [])
        if op not in _OPERATORS:
            _unsupported(f"selector operator {op}")
        if op == "In" and not (key in labels and labels[key] in values):
            return False
        if op == "NotIn" and key in labels and labels[key] in values:
            return False
        if op == "Exists" and key not in labels:
            return False
        if op == "DoesNotExist" and key in labels:
            return False
    return True


@dataclass
class SoftConstraint:
    key: str
    max_skew: int
    selector: dict


def soft_constraints(pod: dict) -> List[SoftConstraint]:
    out = []
    for c in (pod.get("spec") or {}).get("topologySpreadConstraints") or []:
        if (c.get("whenUnsatisfiable") or "DoNotSchedule") != SOFT:
            continue
        if c.get("matchLabelKeys"):
            _unsupported("matchLabelKeys")
        if c.get("nodeTaintsPolicy") == "Honor" or \
                c.get("nodeAffinityPolicy") == "Ignore":
            _unsupported("a node inclusion policy other than the default")
        out.append(SoftConstraint(c.get("topologyKey") or "",
                                  int(c.get("maxSkew", 1)),
                                  c.get("labelSelector")))
    return out


def bare_template(pod: dict) -> sched.Template:
    """sched.py's encoding of the pod without its ScheduleAnyway
    constraints (this module judges them)."""
    bare = copy.deepcopy(pod)
    spec = bare.setdefault("spec", {})
    kept = [c for c in spec.get("topologySpreadConstraints") or []
            if (c.get("whenUnsatisfiable") or "DoNotSchedule") != SOFT]
    if kept:
        spec["topologySpreadConstraints"] = kept
    else:
        spec.pop("topologySpreadConstraints", None)
    return sched.encode_template(bare)


def log_weight(size: torch.Tensor) -> torch.Tensor:
    """float32(log(size + 2)): the float64 logarithm rounded once."""
    return torch.log(size.to(torch.float64) + 2.0).to(torch.float32)


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Go's math.Round: the nearest integer, halves away from zero."""
    t = torch.trunc(x)
    return torch.where((x - t).abs() >= 0.5, t + torch.sign(x), t)


class Spread:
    """PodTopologySpread's side of one question, on a device: per soft
    constraint each node's domain (-1 where it lacks the key), the
    ignored nodes, what the residents give (per domain for a zone-like
    key, per node for the hostname key) and what each placed clone
    adds."""

    def __init__(self, cluster: sched.Cluster, pods: Sequence[dict],
                 pod: dict, device="cpu"):
        dev = torch.device(device)
        self.device = dev
        cons = soft_constraints(pod)
        meta = pod.get("metadata") or {}
        ns = meta.get("namespace") or "default"
        labels = dict(meta.get("labels") or {})
        n = cluster.num_nodes
        c_n = len(cons)
        self.c = c_n
        dom = np.full((max(c_n, 1), n), -1, np.int64)
        sizes = []
        for ci, c in enumerate(cons):
            vocab: Dict[str, int] = {}
            for i, node_labels in enumerate(cluster.labels):
                if c.key in node_labels:
                    dom[ci, i] = vocab.setdefault(node_labels[c.key],
                                                  len(vocab))
            sizes.append(len(vocab))
        self.d = max(sizes + [1])
        ignored = np.zeros(n, bool)
        for ci in range(c_n):
            ignored |= dom[ci] < 0
        host = np.array([c.key == HOSTNAME_KEY for c in cons] or [False])
        self_match = np.array([selector_matches(c.selector, labels)
                               for c in cons] or [False])
        # matching residents per node, per constraint
        on_node = np.zeros((max(c_n, 1), n), np.int64)
        for p in pods:
            if ((p.get("status") or {}).get("phase")) in sched.TERMINAL:
                continue
            pm = p.get("metadata") or {}
            if pm.get("deletionTimestamp"):
                _unsupported("terminating pods")
            i = cluster.index.get((p.get("spec") or {}).get("nodeName"))
            if i is None or (pm.get("namespace") or "default") != ns:
                continue
            for ci, c in enumerate(cons):
                if selector_matches(c.selector, pm.get("labels") or {}):
                    on_node[ci, i] += 1
        static_dom = np.zeros((max(c_n, 1), self.d), np.int64)
        for ci in range(c_n):
            keep = ~ignored & (dom[ci] >= 0)
            np.add.at(static_dom[ci], dom[ci][keep], on_node[ci][keep])
        t_ = lambda a: torch.as_tensor(a, device=dev)
        self.dom = t_(dom)
        self.ignored = t_(ignored)
        self.host = host[:c_n].tolist()
        self.self_match = self_match[:c_n].tolist()
        self.skew_m1 = [float(c.max_skew - 1) for c in cons]
        self.on_node = t_(on_node)
        self.static_dom = t_(static_dom)

    def counts(self, placed: torch.Tensor, seq_n: torch.Tensor
               ) -> torch.Tensor:
        """int64[C, T, N]: each constraint's count at every node before
        each step of a block, the block starting from `placed` (int64[N]
        clones per node) and placing seq_n[t] at step t: the node's
        domain's count for a zone-like key, the node's own for the
        hostname key (0 where the node lacks the key)."""
        t_n, n = seq_n.shape[0], self.dom.shape[1]
        rows = torch.arange(t_n, device=self.device)
        add = torch.zeros((t_n, n), dtype=torch.int64, device=self.device)
        add[rows, seq_n] = 1
        before = placed[None] + torch.cumsum(add, 0) - add       # [T, N]
        out = []
        for ci in range(self.c):
            dom = self.dom[ci]
            has = dom >= 0
            if self.host[ci]:
                cnt = self.on_node[ci][None].expand(t_n, n)
                if self.self_match[ci]:
                    cnt = cnt + before
                out.append(torch.where(has[None], cnt, 0))
                continue
            counted = has & ~self.ignored                        # [N]
            start = self.static_dom[ci].clone()
            if self.self_match[ci]:
                start.scatter_add_(0, dom.clamp(min=0),
                                   torch.where(counted, placed, 0))
            hit = torch.zeros((t_n, self.d), dtype=torch.int64,
                              device=self.device)
            if self.self_match[ci]:
                d_t = dom[seq_n]
                ok = counted[seq_n]
                hit[rows[ok], d_t[ok]] = 1
            per = start[None] + torch.cumsum(hit, 0) - hit       # [T, D]
            got = torch.gather(per, 1, dom.clamp(min=0)[None].expand(t_n, n))
            out.append(torch.where(has[None], got, 0))
        return torch.stack(out) if out else \
            torch.zeros((0, t_n, n), dtype=torch.int64, device=self.device)

    def topo_sizes(self, scored: torch.Tensor) -> torch.Tensor:
        """int64[C, T]: topoSize of each constraint before each step."""
        t_n = scored.shape[0]
        out = []
        for ci in range(self.c):
            if self.host[ci]:
                out.append(scored.sum(-1))
                continue
            dom = self.dom[ci]
            present = torch.zeros((t_n, self.d), dtype=torch.int64,
                                  device=self.device)
            present.scatter_add_(1, dom.clamp(min=0)[None].expand(t_n, -1),
                                 (scored & (dom >= 0)[None]).to(torch.int64))
            out.append((present > 0).sum(-1))
        return torch.stack(out) if out else \
            torch.zeros((0, t_n), dtype=torch.int64, device=self.device)

    def unrounded(self, cnt: torch.Tensor, scored: torch.Tensor, dtype,
                  upstream: bool = False) -> torch.Tensor:
        """float[T, N]: sum over the constraints the node carries of cnt *
        log(topoSize + 2) + (maxSkew - 1), before the rounding; in `dtype`
        with the float32 log weight, or in float64 (`upstream`)."""
        sizes = self.topo_sizes(scored)
        ft = torch.float64 if upstream else dtype
        zero = torch.zeros((), dtype=ft, device=self.device)
        raw = torch.zeros(scored.shape, dtype=ft, device=self.device)
        for ci in range(self.c):
            w = torch.log(sizes[ci].to(torch.float64) + 2.0) if upstream \
                else log_weight(sizes[ci]).to(dtype)
            term = cnt[ci].to(ft) * w[:, None] + \
                torch.tensor(self.skew_m1[ci], dtype=ft, device=self.device)
            raw = raw + torch.where(self.dom[ci][None] >= 0, term, zero)
        return raw

    def scores(self, cnt: torch.Tensor, feasible: torch.Tensor, dtype,
               upstream: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(raw[T, N], normalised[T, N], scored[T, N]) before each step of
        a block.  In `dtype` as the program computes them, or, with
        `upstream`, as upstream does: float64, math.Round, an int64
        normalisation (the census).  Raw scores are never negative, so
        the max over the scored nodes starts from 0 as upstream's does."""
        scored = feasible & ~self.ignored[None]
        raw = self.unrounded(cnt, scored, dtype, upstream)
        if upstream:
            raw = round_half_away(raw).to(torch.int64)
            big = torch.iinfo(torch.int64).max
        else:
            raw = torch.round(raw)
            big = torch.finfo(dtype).max
        hi = torch.where(scored, raw, 0).amax(-1, keepdim=True)
        lo = torch.where(scored, raw, big).amin(-1, keepdim=True)
        lo = torch.where(scored.any(-1, keepdim=True), lo, 0)
        if upstream:
            norm = torch.where(
                hi == 0, MAX_NODE_SCORE,
                MAX_NODE_SCORE * (hi + lo - raw)
                // torch.where(hi == 0, 1, hi)).to(torch.float64)
        else:
            hundred = torch.tensor(float(MAX_NODE_SCORE), dtype=dtype,
                                   device=self.device)
            norm = torch.where(
                hi == 0, hundred,
                torch.floor(((hi + lo) - raw) * hundred
                            / torch.where(hi == 0, hundred, hi)))
        zero = torch.zeros((), dtype=norm.dtype, device=self.device)
        return raw, torch.where(scored, norm, zero), scored


@dataclass
class Question:
    """The reference's encoding of one question: the cluster, sched.py's
    problem of the pod without its soft constraints, and this module's."""
    cluster: sched.Cluster
    pb: sched.Problem
    spread: Spread


def question(nodes: Sequence[dict], pods: Sequence[dict], pod: dict,
             device="cpu") -> Question:
    cluster = sched.Cluster(nodes, pods)
    pb = sched.Problem(cluster, [bare_template(pod)], device=device)
    return Question(cluster, pb, Spread(cluster, pods, pod, device))


def _step_choices(q: Question, used, nonzero, cnt_sp, cnt, k, dtype):
    """The reference's choice before each step of a block (-1 where no
    node is feasible)."""
    pb = q.pb
    feasible, _fit, _spread = sched._filters(pb, k, used, cnt_sp, dtype)
    score = sched._scores(pb, k, used, nonzero, dtype)
    if q.spread.c:
        _raw, norm, _scored = q.spread.scores(cnt, feasible, dtype)
        score = score + W_SPREAD * norm
    keyed = torch.where(feasible, score,
                        torch.tensor(-1.0, dtype=dtype, device=pb.device))
    return torch.where(feasible.any(-1), sched._choose(keyed), -1)


def _start(q: Question):
    """The state before the first step: (sched.State, clones per node)."""
    return (sched.start_state(q.pb),
            torch.zeros(q.cluster.num_nodes, dtype=torch.int64,
                        device=q.pb.device))


def _block(q: Question, state, n: torch.Tensor):
    """What a block of steps placing n[t] at step t reads from `state`:
    (templates, sched.py's used, nonzero and hard-spread counts, this
    module's counts), and the state after the block."""
    st, placed = state
    k = torch.zeros_like(n)
    used, nonzero, cnt_sp, after = sched._block_states(q.pb, st, k, n)
    parts = (k, used, nonzero, cnt_sp, q.spread.counts(placed, n))
    return parts, (after, placed + torch.bincount(
        n, minlength=placed.shape[0]))


def _blocks(q: Question, seq_n: Sequence[int], block_elems: int):
    """Per block of the sequence: (its steps, `_block`'s parts, the state
    after it)."""
    n_all = torch.as_tensor(np.asarray(seq_n, np.int64), device=q.pb.device)
    step = max(1, block_elems // max(1, q.cluster.num_nodes * 3))
    state = _start(q)
    for b0 in range(0, n_all.shape[0], step):
        n = n_all[b0:b0 + step]
        parts, state = _block(q, state, n)
        yield n, parts, state


def replay(q: Question, seq_n: Sequence[int], dtypes=(torch.float32,),
           block_elems: int = 1 << 26):
    """The reference's choice before every step of the sequence, for each
    dtype (int64[T], -1 where no node is feasible), and the state after
    it."""
    out = {dt: [] for dt in dtypes}
    state = _start(q)
    for _n, parts, state in _blocks(q, seq_n, block_elems):
        for dt in dtypes:
            out[dt].append(_step_choices(q, *parts[1:], parts[0], dt))
    return ({dt: (torch.cat(v).cpu().numpy() if v else
                  np.zeros(0, np.int64)) for dt, v in out.items()}, state)


def census(q: Question, seq_n: Sequence[int], dtype=torch.float32,
           block_elems: int = 1 << 26) -> Dict[str, int]:
    """Where upstream's arithmetic (float64, math.Round, an int64
    normalisation) departs from the program's (`dtype`) over the program's
    own sequence: the steps at which some scored node's raw score, or its
    normalised score, differs, those at which the choice differs, the
    nodes whose normalised score differs summed over the steps, and the
    steps at which a raw score lands on a half in `dtype`."""
    out = {"steps": 0, "raw_steps": 0, "norm_steps": 0, "choice_steps": 0,
           "norm_nodes": 0, "half_steps": 0}
    pb = q.pb
    for n, (k, used, nonzero, cnt_sp, cnt), _state in _blocks(
            q, seq_n, block_elems):
        feasible, _fit, _sp = sched._filters(pb, k, used, cnt_sp, dtype)
        base = sched._scores(pb, k, used, nonzero, dtype)
        raw_p, norm_p, scored = q.spread.scores(cnt, feasible, dtype)
        raw_u, norm_u, _s = q.spread.scores(cnt, feasible, dtype,
                                            upstream=True)
        unrounded = q.spread.unrounded(cnt, scored, dtype)
        half = ((unrounded - torch.floor(unrounded)) == 0.5) & scored
        raw_d = (raw_p.to(torch.float64) != raw_u.to(torch.float64)) & scored
        norm_d = (norm_p.to(torch.float64) != norm_u) & scored
        choice = []
        for norm in (norm_p.to(dtype), norm_u.to(dtype)):
            keyed = torch.where(feasible, base + W_SPREAD * norm,
                                torch.tensor(-1.0, dtype=dtype,
                                             device=pb.device))
            choice.append(sched._choose(keyed))
        out["steps"] += int(n.shape[0])
        out["raw_steps"] += int(raw_d.any(-1).sum())
        out["norm_steps"] += int(norm_d.any(-1).sum())
        out["norm_nodes"] += int(norm_d.sum())
        out["half_steps"] += int(half.any(-1).sum())
        out["choice_steps"] += int((choice[0] != choice[1]).sum())
    return out


@dataclass
class Verdict:
    """The judgement of one answer: the reference's cluster, the program's
    placements as its node indices (-1 for a name it does not know), per
    dtype the steps off (the first dtype: off the program's node; each
    other: off the first dtype's choice), whether the sequence ended where
    it had to, and the end's fail type and message."""
    cluster: sched.Cluster
    seq_n: np.ndarray
    off: Dict[torch.dtype, int]
    ended: bool
    fail_type: str
    fail_message: str


def node_sequence(q: Question, node_names: Sequence[str],
                  placements: Sequence[int]) -> np.ndarray:
    """The program's placements (indices into its `node_names`) as the
    reference's node indices, -1 for a name it does not know."""
    lookup = np.array([q.cluster.index.get(nm, -1) for nm in node_names] +
                      [-1], np.int64)
    p = np.asarray(placements, np.int64)
    p = np.where((p >= 0) & (p < len(node_names)), p, len(node_names))
    return lookup[p]


def judge(nodes: Sequence[dict], pods: Sequence[dict], pod: dict,
          node_names: Sequence[str], placements: Sequence[int], limit: int,
          device="cpu", dtypes=(torch.float32,)) -> Verdict:
    """Replay the program's placements and judge every step and the end
    (the soft score moves no filter: sched.py's end)."""
    q = question(nodes, pods, pod, device)
    seq_n = node_sequence(q, node_names, placements)
    bad = seq_n < 0
    choices, (st, _placed) = replay(q, np.where(bad, 0, seq_n), dtypes)
    base = choices[dtypes[0]]
    off = {dtypes[0]: int(((base != seq_n) | bad).sum())}
    for dt in dtypes[1:]:
        off[dt] = int((choices[dt] != base).sum())
    ended, ftype, msg = sched.expected_end(q.pb, st, 0, len(seq_n), limit)
    return Verdict(q.cluster, seq_n, off, ended, ftype, msg)


def greedy(nodes: Sequence[dict], pods: Sequence[dict], pod: dict,
           limit: int = 0, device="cpu", dtype=torch.float32) -> List[str]:
    """The reference's own greedy run, one step at a time: the names of
    the nodes it places the pod's clones on (tests, and the faults they
    plant)."""
    q = question(nodes, pods, pod, device)
    state = _start(q)
    probe = torch.zeros(1, dtype=torch.int64, device=q.pb.device)
    out: List[int] = []
    while not limit or len(out) < limit:
        (k, used, nonzero, cnt_sp, cnt), _after = _block(q, state, probe)
        c = int(_step_choices(q, used, nonzero, cnt_sp, cnt, k, dtype)[0])
        if c < 0:
            break
        out.append(c)
        state = _block(q, state, torch.full_like(probe, c))[1]
    return [q.cluster.names[i] for i in out]

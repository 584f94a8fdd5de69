"""Plain reference of kube-scheduler's InterPodAffinity plugin, added to the
greedy loop that reference/sched.py replays: plain PyTorch over the object
lists, importing nothing of the program.

It judges one sequence of placements of one pod (clones of it, each placed
clone an existing pod for the steps after it, with the pod's labels,
namespace and terms), block by block as sched.py does: the state before
each step is the block's start plus the placements before it.  Each step
filters every node with sched.py's filters and InterPodAffinity's, scores
the feasible ones with sched.py's scores plus InterPodAffinity's, and takes
the best (highest score, lowest node index).

InterPodAffinity as upstream's plugin (interpodaffinity/filtering.go and
scoring.go, the default profile's weight 2 and hardPodAffinityWeight 1):

- counts are kept per (topology key, value), summed over every term of
  that key (upstream's merged maps), and read at the node's own value;
- filter, in upstream's order, each node failing at the first probe:
  the pod's required affinity (every term's key on the node and a
  matching pod in each term's domain, where a matching pod is one that
  matches every term; else, the lonely-pod escape: no matching pod
  anywhere, the pod matches all its own terms and the node has every
  key), the pod's required anti-affinity (no pod matching a term in its
  domain), existing pods' required anti-affinity (no existing pod whose
  term matches the pod in any of the node's domains);
- score: the pod's preferred terms against each existing pod (+weight
  for affinity, -weight for anti-affinity), each existing pod's
  preferred terms against the pod (the same signs), and each existing
  pod's required affinity terms against the pod at hardPodAffinityWeight,
  each added at the existing pod's node's value of the term's key and
  summed into a node's score over the keys it carries; then
  NormalizeScore over the feasible nodes: int64(100 * ((s - min) /
  (max - min))), 0 where max equals min, computed in the profile's
  float arithmetic, times the weight 2;
- term matching: the term's namespaces, or the owner's namespace where it
  lists none; matchLabels against the pod's labels (an empty value is a
  value); a term without a labelSelector matches nothing, an empty one
  everything.

Departures from upstream, each refused with NotImplementedError rather
than judged wrongly: a namespaceSelector, matchExpressions, matchLabelKeys
and mismatchLabelKeys, a pod with node affinity, and whatever sched.py
refuses on the pod or the cluster (taints, node selectors, host ports,
soft spreads, ...).  IgnorePreferredTermsOfExistingPods is not modelled:
the default profile leaves it false.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import sched

# the reference compares integers and float32 scores exactly: no TF32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

W_IPA = 2                       # default_plugins.go: InterPodAffinity
HARD_POD_AFFINITY_WEIGHT = 1    # InterPodAffinityArgs' default
MAX_NODE_SCORE = 100
REASON_AFFINITY = "node(s) didn't match pod affinity rules"
REASON_ANTI = "node(s) didn't match pod anti-affinity rules"
REASON_EXISTING_ANTI = \
    "node(s) didn't satisfy existing pods anti-affinity rules"
_TERM_KEYS = {"labelSelector", "namespaces", "topologyKey",
              "namespaceSelector", "matchLabelKeys", "mismatchLabelKeys"}


def _unsupported(what: str):
    raise NotImplementedError(f"reference: {what} is not modelled")


@dataclass(frozen=True)
class Term:
    """One pod (anti-)affinity term: its topology key, the namespaces it
    selects pods in, its matchLabels (None: no labelSelector, which
    matches nothing) and, for a preferred term, its signed weight."""
    key: str
    namespaces: frozenset
    match_labels: Tuple[Tuple[str, str], ...] = None
    weight: int = 0

    def matches(self, namespace: str, labels: dict) -> bool:
        return (self.match_labels is not None
                and namespace in self.namespaces
                and all(labels.get(k) == v for k, v in self.match_labels))


def _term(raw: dict, owner_ns: str, weight: int = 0) -> Term:
    if set(raw) - _TERM_KEYS:
        _unsupported(f"term fields {sorted(set(raw) - _TERM_KEYS)}")
    if raw.get("namespaceSelector") is not None:
        _unsupported("a namespaceSelector")
    if raw.get("matchLabelKeys") or raw.get("mismatchLabelKeys"):
        _unsupported("matchLabelKeys or mismatchLabelKeys")
    sel = raw.get("labelSelector")
    labels = None
    if sel is not None:
        if set(sel) - {"matchLabels"}:
            _unsupported("label selector expressions")
        labels = tuple(sorted((sel.get("matchLabels") or {}).items()))
    return Term(key=raw.get("topologyKey") or "",
                namespaces=frozenset(raw.get("namespaces") or [owner_ns]),
                match_labels=labels, weight=weight)


@dataclass
class PodTerms:
    """A pod's namespace, labels and pod (anti-)affinity terms."""
    namespace: str
    labels: dict
    req_aff: List[Term] = field(default_factory=list)
    req_anti: List[Term] = field(default_factory=list)
    preferred: List[Term] = field(default_factory=list)   # signed weights

    def matched_by(self, term: Term) -> bool:
        return term.matches(self.namespace, self.labels)


def pod_terms(pod: dict) -> PodTerms:
    meta = pod.get("metadata") or {}
    ns = meta.get("namespace") or "default"
    out = PodTerms(ns, dict(meta.get("labels") or {}))
    aff = (pod.get("spec") or {}).get("affinity") or {}
    for kind, sign in (("podAffinity", 1), ("podAntiAffinity", -1)):
        section = aff.get(kind) or {}
        required = section.get(
            "requiredDuringSchedulingIgnoredDuringExecution") or []
        (out.req_aff if sign > 0 else out.req_anti).extend(
            _term(t, ns) for t in required)
        for t in section.get(
                "preferredDuringSchedulingIgnoredDuringExecution") or []:
            out.preferred.append(_term(t.get("podAffinityTerm") or {}, ns,
                                       sign * int(t.get("weight", 0))))
    return out


def bare_template(pod: dict) -> sched.Template:
    """sched.py's encoding of the pod, its pod (anti-)affinity taken off
    (this module judges that part); node affinity is refused."""
    spec = (pod.get("spec") or {})
    aff = spec.get("affinity") or {}
    if set(aff) - {"podAffinity", "podAntiAffinity"}:
        _unsupported("node affinity")
    bare = copy.deepcopy(pod)
    bare["spec"].pop("affinity", None)
    return sched.encode_template(bare)


class Affinity:
    """InterPodAffinity's side of one question, on a device: for every
    topology key a term names, each node's domain (-1 where the node lacks
    the key), per domain what the residents give (static counts, int64),
    and what each placed clone adds to its own node's domain."""

    def __init__(self, cluster: sched.Cluster, pods: Sequence[dict],
                 pod: dict, device="cpu"):
        me = pod_terms(pod)
        dev = torch.device(device)
        self.device = dev
        residents = []
        for p in pods:
            if ((p.get("status") or {}).get("phase")) in sched.TERMINAL:
                continue
            i = cluster.index.get((p.get("spec") or {}).get("nodeName"))
            if i is not None:
                residents.append((i, pod_terms(p)))
        keys = {t.key for t in me.req_aff + me.req_anti + me.preferred}
        for _i, r in residents:
            keys.update(t.key for t in r.req_aff + r.req_anti + r.preferred
                        if me.matched_by(t))
        self.keys = sorted(keys)
        n = cluster.num_nodes
        self.dom = np.full((max(len(self.keys), 1), n), -1, np.int64)
        sizes = []
        for ki, key in enumerate(self.keys):
            vocab: Dict[str, int] = {}
            for i, labels in enumerate(cluster.labels):
                if key in labels:
                    self.dom[ki, i] = vocab.setdefault(labels[key],
                                                       len(vocab))
            sizes.append(len(vocab))
        d = max(sizes + [1])
        kx = self.keys.index
        # per key and domain: [0] the pod's required affinity (pods that
        # match every term), [1] its required anti-affinity, [2] existing
        # pods' required anti-affinity matching the pod, [3] the score
        static = np.zeros((4, max(len(self.keys), 1), d), np.int64)

        def add(plane: int, key: str, node: int, v: int) -> None:
            dm = self.dom[kx(key), node]
            if dm >= 0:
                static[plane, kx(key), dm] += v

        for i, r in residents:
            if me.req_aff and all(r.matched_by(t) for t in me.req_aff):
                for t in me.req_aff:
                    add(0, t.key, i, 1)
            for t in me.req_anti:
                if r.matched_by(t):
                    add(1, t.key, i, 1)
            for t in r.req_anti:
                if me.matched_by(t):
                    add(2, t.key, i, 1)
            for t in me.preferred:               # the pod's terms
                if r.matched_by(t):
                    add(3, t.key, i, t.weight)
            for t in r.req_aff:                  # the resident's terms
                if me.matched_by(t):
                    add(3, t.key, i, HARD_POD_AFFINITY_WEIGHT)
            for t in r.preferred:
                if me.matched_by(t):
                    add(3, t.key, i, t.weight)
        # what one placed clone adds at its node's domain, per key: the
        # same sums with the clone (the pod itself) as the existing pod
        inc = np.zeros((4, max(len(self.keys), 1)), np.int64)
        if me.req_aff and all(me.matched_by(t) for t in me.req_aff):
            for t in me.req_aff:
                inc[0, kx(t.key)] += 1
        for t in me.req_anti:
            if me.matched_by(t):
                inc[1, kx(t.key)] += 1           # the pod's term vs clone
                inc[2, kx(t.key)] += 1           # the clone's term vs pod
        for t in me.preferred:
            if me.matched_by(t):
                inc[3, kx(t.key)] += 2 * t.weight   # both directions
        for t in me.req_aff:
            if me.matched_by(t):
                inc[3, kx(t.key)] += HARD_POD_AFFINITY_WEIGHT
        self.escape = bool(me.req_aff) and \
            all(me.matched_by(t) for t in me.req_aff)
        self.aff_keys = [kx(t.key) for t in me.req_aff]
        self.anti_keys = sorted({kx(t.key) for t in me.req_anti})
        self.static_aff_total = int(static[0].sum())
        t_ = lambda a: torch.as_tensor(a, device=dev)
        self.dom_t = t_(self.dom)
        self.static = t_(static)
        self.inc = t_(inc)
        self.d = d

    def node_counts(self, placed: torch.Tensor, seq_n: torch.Tensor
                    ) -> torch.Tensor:
        """int64[4, K, T, N]: each plane's count at every node's own
        domain before each step of a block, the block starting from
        `placed` (int64[N] clones per node) and placing seq_n[t] at step t
        (0 where the node lacks the key)."""
        k_n, n = self.dom_t.shape
        t_n = seq_n.shape[0]
        has = self.dom_t >= 0                                  # [K, N]
        dom = self.dom_t.clamp(min=0)
        out = []
        for ki in range(k_n):
            start = torch.zeros(self.d, dtype=torch.int64,
                                device=self.device)
            start.scatter_add_(0, dom[ki], torch.where(has[ki], placed, 0))
            hit = torch.zeros((t_n, self.d), dtype=torch.int64,
                              device=self.device)
            d_t = self.dom_t[ki, seq_n]                          # [T]
            rows = torch.arange(t_n, device=self.device)
            hit[rows[d_t >= 0], d_t[d_t >= 0]] = 1
            clones = start[None] + torch.cumsum(hit, 0) - hit   # [T, D]
            per = self.static[:, ki, None, :] + \
                self.inc[:, ki, None, None] * clones[None]      # [4, T, D]
            got = torch.gather(per, 2, dom[ki][None, None].expand(
                4, t_n, n))
            out.append(torch.where(has[ki][None, None], got, 0))
        return torch.stack(out, 1)

    def aff_totals(self, placed: torch.Tensor, seq_n: torch.Tensor
                   ) -> torch.Tensor:
        """int64[T]: every count of the pod's required affinity, summed,
        before each step (upstream's affinityCounts is empty where 0)."""
        has = (self.dom_t >= 0)                                 # [K, N]
        per_clone = (self.inc[0][:, None] * has).sum(0)         # [N]
        start = self.static_aff_total + (per_clone * placed).sum()
        adds = per_clone[seq_n]
        return start + torch.cumsum(adds, 0) - adds

    def at(self, placed: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """node_counts and aff_totals of the state `placed` alone (a block
        of one step)."""
        probe = torch.zeros(1, dtype=torch.int64, device=self.device)
        return self.node_counts(placed, probe), \
            self.aff_totals(placed, probe)

    def filters(self, cnt: torch.Tensor, totals: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(fails the pod's affinity, fails its anti-affinity, fails
        existing pods' anti-affinity), each bool[T, N] and each only where
        the probes before it passed."""
        has = self.dom_t >= 0
        t_n, n = cnt.shape[2], cnt.shape[3]
        if self.aff_keys:
            has_all = torch.ones(n, dtype=torch.bool, device=self.device)
            exist = torch.ones((t_n, n), dtype=torch.bool,
                               device=self.device)
            for ki in self.aff_keys:
                has_all &= has[ki]
                exist &= cnt[0, ki] > 0
            lonely = (totals == 0) & self.escape                # [T]
            aff_ok = has_all[None] & (exist | lonely[:, None])
        else:
            aff_ok = torch.ones((t_n, n), dtype=torch.bool,
                                device=self.device)
        anti = torch.zeros((t_n, n), dtype=torch.bool, device=self.device)
        for ki in self.anti_keys:
            anti |= cnt[1, ki] > 0
        eanti = (cnt[2] > 0).any(0)
        return ~aff_ok, aff_ok & anti, aff_ok & ~anti & eanti

    def raw_score(self, cnt: torch.Tensor) -> torch.Tensor:
        """int64[T, N]: the score's sum over the keys the node carries."""
        return cnt[3].sum(0)


def normalize(raw: torch.Tensor, feasible: torch.Tensor,
              dtype) -> torch.Tensor:
    """NormalizeScore over the feasible nodes of each step: int64(100 *
    ((s - min) / (max - min))), 0 where max equals min, in `dtype`."""
    big = torch.iinfo(torch.int64).max
    hi = torch.where(feasible, raw, -big).amax(-1, keepdim=True)
    lo = torch.where(feasible, raw, big).amin(-1, keepdim=True)
    diff = hi - lo
    hundred = torch.tensor(float(MAX_NODE_SCORE), dtype=dtype,
                           device=raw.device)
    frac = (raw - lo).to(dtype) / torch.where(diff > 0, diff, 1).to(dtype)
    return torch.where(diff > 0, torch.trunc(hundred * frac),
                       torch.zeros((), dtype=dtype, device=raw.device))


def _step_choices(pb: sched.Problem, aff: Affinity, used, nonzero, cnt_sp,
                  cnt_ipa, totals, k, dtype) -> torch.Tensor:
    """The reference's choice before each step of a block (-1 where no
    node is feasible)."""
    feasible, _fit, _spread = sched._filters(pb, k, used, cnt_sp, dtype)
    f_aff, f_anti, f_eanti = aff.filters(cnt_ipa, totals)
    feasible = feasible & ~(f_aff | f_anti | f_eanti)
    score = sched._scores(pb, k, used, nonzero, dtype)
    score = score + W_IPA * normalize(aff.raw_score(cnt_ipa), feasible,
                                      dtype)
    keyed = torch.where(feasible, score,
                        torch.tensor(-1.0, dtype=dtype, device=pb.device))
    return torch.where(feasible.any(-1), sched._choose(keyed), -1)


@dataclass
class Question:
    """The reference's encoding of one question: the cluster, sched.py's
    problem of the pod without its pod (anti-)affinity, and this module's."""
    cluster: sched.Cluster
    pb: sched.Problem
    aff: Affinity


def question(nodes: Sequence[dict], pods: Sequence[dict], pod: dict,
             device="cpu") -> Question:
    cluster = sched.Cluster(nodes, pods)
    pb = sched.Problem(cluster, [bare_template(pod)], device=device)
    return Question(cluster, pb, Affinity(cluster, pods, pod, device))


def replay(q: Question, seq_n: Sequence[int], dtypes=(torch.float32,),
           block_elems: int = 1 << 26):
    """The reference's choice before every step of the sequence, for
    each dtype (int64[T], -1 where no node is feasible), and the state
    after it: (sched.State, clones per node)."""
    pb, aff = q.pb, q.aff
    n_all = torch.as_tensor(np.asarray(seq_n, np.int64), device=pb.device)
    total = n_all.shape[0]
    step = max(1, block_elems // max(1, q.cluster.num_nodes * 3))
    out = {dt: [] for dt in dtypes}
    st = sched.start_state(pb)
    placed = torch.zeros(q.cluster.num_nodes, dtype=torch.int64,
                         device=pb.device)
    for b0 in range(0, total, step):
        n = n_all[b0:b0 + step]
        k = torch.zeros_like(n)
        used, nonzero, cnt_sp, after = sched._block_states(pb, st, k, n)
        cnt_ipa = aff.node_counts(placed, n)
        totals = aff.aff_totals(placed, n)
        for dt in dtypes:
            out[dt].append(_step_choices(pb, aff, used, nonzero, cnt_sp,
                                         cnt_ipa, totals, k, dt))
        st = after
        placed = placed + torch.bincount(n, minlength=placed.shape[0])
    return ({dt: (torch.cat(v).cpu().numpy() if v else
                  np.zeros(0, np.int64)) for dt, v in out.items()},
            (st, placed))


def final_verdict(q: Question, state, dtype=torch.float32
                  ) -> Tuple[bool, Dict[str, int]]:
    """(any node feasible, the FitError reasons histogram) at a state:
    sched.py's reasons, then InterPodAffinity's on the nodes that pass
    every filter before it."""
    st, placed = state
    k = torch.zeros(1, dtype=torch.int64, device=q.pb.device)
    feasible, _fit, _spread = sched._filters(q.pb, k, st.used[None],
                                             st.cnt[0][None], dtype)
    _any, counts = sched.final_verdict(q.pb, st, 0, dtype)
    fails = q.aff.filters(*q.aff.at(placed))
    for reason, f in zip((REASON_AFFINITY, REASON_ANTI,
                          REASON_EXISTING_ANTI), fails):
        v = int((feasible[0] & f[0]).sum())
        if v:
            counts[reason] = counts.get(reason, 0) + v
    ok = feasible[0] & ~(fails[0][0] | fails[1][0] | fails[2][0])
    return bool(ok.any()), counts


def expected_end(q: Question, state, placed: int, limit: int
                 ) -> Tuple[bool, str, str]:
    """(the sequence ended where it had to, fail type, fail message)
    after `placed` placements under `limit` (0: none)."""
    if limit and placed >= limit:
        return (placed == limit, "LimitReached",
                f"Maximum number of pods simulated: {limit}")
    any_feasible, counts = final_verdict(q, state)
    return (not any_feasible, "Unschedulable",
            sched.fit_error(q.cluster.num_nodes, counts))


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


def judge(nodes: Sequence[dict], pods: Sequence[dict], pod: dict,
          node_names: Sequence[str], placements: Sequence[int], limit: int,
          device="cpu", dtypes=(torch.float32,)) -> Verdict:
    """Replay the program's placements (indices into its `node_names`)
    and judge every step and the end."""
    q = question(nodes, pods, pod, device)
    lookup = np.array([q.cluster.index.get(nm, -1) for nm in node_names] +
                      [-1], np.int64)
    p = np.asarray(placements, np.int64)
    p = np.where((p >= 0) & (p < len(node_names)), p, len(node_names))
    seq_n = lookup[p]
    bad = seq_n < 0
    choices, state = replay(q, np.where(bad, 0, seq_n), dtypes)
    base = choices[dtypes[0]]
    off = {dtypes[0]: int(((base != seq_n) | bad).sum())}
    for dt in dtypes[1:]:
        off[dt] = int((choices[dt] != base).sum())
    ended, ftype, msg = expected_end(q, state, len(seq_n), limit)
    return Verdict(q.cluster, seq_n, off, ended, ftype, msg)


def greedy(nodes: Sequence[dict], pods: Sequence[dict], pod: dict,
           limit: int = 0, device="cpu", dtype=torch.float32) -> List[str]:
    """The reference's own greedy run, one step at a time: the names of
    the nodes it places the pod's clones on (tests, and the faults they
    plant)."""
    q = question(nodes, pods, pod, device)
    st = (sched.start_state(q.pb),
          torch.zeros(q.cluster.num_nodes, dtype=torch.int64,
                      device=q.pb.device))
    out: List[int] = []
    while not limit or len(out) < limit:
        c = int(replay_one(q, st, dtype))
        if c < 0:
            break
        out.append(c)
        st = advance(q, st, c)
    return [q.cluster.names[i] for i in out]


def replay_one(q: Question, state, dtype=torch.float32) -> int:
    """The reference's choice at a state (-1 where no node is feasible)."""
    st, placed = state
    k = torch.zeros(1, dtype=torch.int64, device=q.pb.device)
    return int(_step_choices(q.pb, q.aff, st.used[None], st.nonzero[None],
                             st.cnt[0][None], *q.aff.at(placed), k,
                             dtype)[0])


def advance(q: Question, state, node: int):
    """The state after one more clone on `node`."""
    st, placed = state
    n = torch.tensor([node], device=q.pb.device)
    after = sched._block_states(q.pb, st, torch.zeros_like(n), n)[3]
    placed = placed.clone()
    placed[node] += 1
    return after, placed

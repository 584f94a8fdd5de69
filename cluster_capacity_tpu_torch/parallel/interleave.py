"""The interleave engine: many templates racing through ONE shared cluster
state, on the card.

`sweep.sweep_interleaved` is the object-level queue loop for multi-template
studies (backend/queue/scheduling_queue.go pop semantics): it walks Python
lists per cycle, O(T*P*N*plugins) interpreter work.  This module runs the
same queue semantics as a step function: per-template constraint state is
carried as stacked per-node count tensors ([T, C, N]), and the effect of
template t's placement on template u's counts is a static cross-template
increment matrix (does t's clone match u's selector?) built once on the
host — so each queue pop is elementwise and reduction work on the device.
The step (`_xstep`) is plain PyTorch with no host sync; its chunks run
through simulator.run_steps: eagerly on the CPU, as replays of captured
CUDA graphs on the card.  Per chunk, the host's share runs in the spans
`interleave.wait` (the chunk's pops and halt flag copied to the host) and
`interleave.drain` (the pops recorded); the templates' encode against
the snapshot, and each rebuild of the group's tensors from it, run in
`interleave.encode`.  No CUDA kernel of this repo runs here: the JAX
package's step is an XLA scan, not a Pallas kernel.

Scope, as in the JAX package (everything else takes the object loop, which
stays this engine's differential oracle — tests/test_torch_interleave.py):

- deterministic profiles; extenders run once per template over the whole
  node axis (their verdicts must be per-(template, node) deterministic),
  the mask and bonus ride the step, and Bind verbs fire at chunk ends in
  placement order;
- priority tiers and preemption run natively (tier-ranked pops in the
  step, victim selection as a rare host event between chunks);
- host ports run natively (a [T, T] conflict matrix and the carried
  per-template clone counts give each pop's blocked nodes, in the
  diagnosis slot of simulator._feasibility's ports_blocked); inline-disk
  and RWOP self-conflicts ride per-template gate scalars (RWOP takes the
  object loop when preemption is possible);
- templates share one step specialization (sweep._group_key, the
  self-conflict flags normalized out) and the resource vocabulary;
  shared-DRA colocation takes the object loop.

Queue semantics mirrored exactly: round-robin pops among active templates
in arrival order within the highest priority tier; an Unschedulable pop
halts the chunk and the host diagnoses it with the shared state at that
moment; a template parked on an affinity/spread/ports-shaped failure
re-enters the queue at the next placement (the pod-ADD QueueingHints
analog), in the step, so the requeue order matches the object loop
placement for placement.

`bounds=True` brackets the mix first (bounds/bracket.bracket_mix): the
step budget is right-sized to the joint upper bound and templates that are
statically infeasible on every node skip straight to their diagnosis; both
keep the placements bit-identical.

On a device mesh (the JAX package's sharded runner) the template axis
rides the mesh's batch axis and the node tables its node axis: shard
(r, k) holds row r's templates and node shard k's nodes of every
[T, ..., N] plane, and every shard of the process runs each pop at once,
taking turns at the exchanges (parallel/mesh.run_grid, _MeshRace).  The
pop is a min across the rows; the row holding the popped template
decides, every row takes its decision, and each row then updates its own
templates' counts.  The sharded step runs eagerly, with no CUDA graph,
and answers bit-identically to the unsharded one.

Reference: the queue pop loop is the scheduler's core
(vendor/.../backend/queue/scheduling_queue.go:94-134); one scheduling cycle
per pop (schedule_one.go:66-150).
"""

from __future__ import annotations

import functools
import os
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..engine import encode as enc
from ..engine import simulator as sim
from ..models import podspec as ps
from ..models.snapshot import ClusterSnapshot
from ..obs import spans as obs_spans
from ..ops import inter_pod_affinity as ipa_ops
from ..ops import pod_topology_spread as spread_ops
from ..utils.config import SchedulerProfile
from . import mesh as mesh_lib
from .mesh import PLAIN, PLAIN_ROWS

# total per-template-tensor elements (T*C*N summed over the ~7 stacked count
# tensors) the engine will put on the device before falling back
MAX_ELEMS = int(os.environ.get("CC_TPU_INTERLEAVE_ELEMS", str(2 ** 26)))
CHUNK = 256
# Steps per host round trip when the steps run eagerly (on the CPU, and on
# a mesh).  The steps after a halt change nothing, so the chunk length
# moves no placement; eager steps cost the same on the host whether they
# place or not, so an eager drive stops sooner.
CPU_CHUNK = 16


class XCarry(NamedTuple):
    """Shared cluster state + per-template views, all on the device."""

    requested: torch.Tensor       # f[N, R]   shared
    nonzero: torch.Tensor         # f[N, 2]   shared
    tpl_placed: torch.Tensor      # i32[T, N] per-template clone counts; a
                                  # [1, 1] zero dummy when no ports/disk
                                  # gate reads it (needs_tpl False)
    sh_cnt: torch.Tensor          # f[T, Ch, N]
    ss_cnt: torch.Tensor          # f[T, Cs, N]
    ssh_cnt: torch.Tensor         # f[T, Cs, N] hostname-row clone counts
    aff_cnt: torch.Tensor         # f[T, G, N]
    anti_cnt: torch.Tensor        # f[T, G, N]  pods matching u's anti terms
    eanti_cnt: torch.Tensor       # f[T, G, N]  clones whose anti terms match u
    pref_cnt: torch.Tensor        # f[T, G, N]
    aff_total: torch.Tensor       # f[T]
    k: torch.Tensor               # i32[T] live per-template placed count
    active: torch.Tensor          # bool[T]
    parked_curable: torch.Tensor  # bool[T] — reactivate on next pod-ADD
    last_seq: torch.Tensor        # i32[T] queue order (min pops first)
    next_start: torch.Tensor      # i32[T] sampling rotation per template
    seq_next: torch.Tensor        # i32[] next queue sequence number
    quota: torch.Tensor           # i32[] placements remaining (max_total)
    halt: torch.Tensor            # bool[] — a pop found no feasible node
    halt_ti: torch.Tensor         # i32[] — which template halted


def _clone_matches_selector(clone: dict, sel, ns: str) -> bool:
    """countPodsMatchSelector semantics for one clone (same namespace +
    label match; clones are never terminating)."""
    meta = clone.get("metadata") or {}
    if (meta.get("namespace") or "default") != ns:
        return False
    from ..models.labels import match_label_selector
    return match_label_selector(sel, meta.get("labels") or {})


def _spread_xinc(pbs, which: str) -> np.ndarray:
    """xinc[t, u, c]: does template t's clone count under template u's
    constraint row c?  Padded rows stay 0 (inert)."""
    t_n = len(pbs)
    sets = [getattr(pb, which) for pb in pbs]
    c_rows = sets[0].node_domain.shape[0]
    out = np.zeros((t_n, t_n, c_rows))
    clones = [ps.make_clone(pb.pod, 0) for pb in pbs]
    for u, su in enumerate(sets):
        for c, sel in enumerate(su.selectors):
            for t in range(t_n):
                out[t, u, c] = float(_clone_matches_selector(
                    clones[t], sel, su.namespace))
    return out


def _ipa_xinc(pbs) -> Dict[str, np.ndarray]:
    """Cross matrices for the four carried IPA tensors, [T, T, G] each,
    [t_placing, u_observing, group-of-u].  Diagonals are overwritten with
    group_fold's self increments so a tensor run whose placements happen to
    be single-template is bit-identical to the single-template engine."""
    t_n = len(pbs)
    encs = [pb.ipa for pb in pbs]
    g_rows = encs[0].node_domain.shape[0]
    ns_labels = ipa_ops._ns_labels_map(pbs[0].snapshot)
    clones = [ps.make_clone(pb.pod, 0) for pb in pbs]
    ignore = pbs[0].profile.ignore_preferred_terms_of_existing_pods

    aff = np.zeros((t_n, t_n, g_rows))
    anti = np.zeros((t_n, t_n, g_rows))
    eanti = np.zeros((t_n, t_n, g_rows))
    pref = np.zeros((t_n, t_n, g_rows))

    def group_row(e_u, key: str) -> Optional[int]:
        try:
            return e_u.group_keys.index(key)
        except ValueError:
            return None

    for u, e_u in enumerate(encs):
        u_soft = bool(e_u.raw_soft_terms)
        for t in range(t_n):
            e_t = encs[t]
            clone_t = clones[t]
            # u's own required terms vs t's clone → aff/anti counts
            for terms, groups, mat in (
                    (e_u.raw_aff_terms, e_u.aff_group, aff),
                    (e_u.raw_anti_terms, e_u.anti_group, anti)):
                for idx, term in enumerate(terms):
                    if ipa_ops._term_matches_pod(term, e_u.owner_ns, clone_t,
                                                 ns_labels):
                        mat[t, u, int(groups[idx])] += 1.0
            # t's clone's required ANTI terms vs u's pod → eanti counts
            for term in e_t.raw_anti_terms:
                if ipa_ops._term_matches_pod(term, e_t.owner_ns, pbs[u].pod,
                                             ns_labels):
                    g = group_row(e_u, term.get("topologyKey", ""))
                    if g is not None:
                        eanti[t, u, g] += 1.0
            # preferred scoring, processExistingPod (scoring.go:81-125):
            # (a) u's soft terms vs the existing clone of t
            for term, w in e_u.raw_soft_terms:
                if ipa_ops._term_matches_pod(term, e_u.owner_ns, clone_t,
                                             ns_labels):
                    g = group_row(e_u, term.get("topologyKey", ""))
                    if g is not None:
                        pref[t, u, g] += w
            # (b) the clone's terms vs u's incoming pod (scoring.go:144-160)
            if (e_t.has_affinity_field or u_soft) and not (
                    ignore and not u_soft):
                for term in e_t.raw_aff_terms:
                    if ipa_ops._term_matches_pod(term, e_t.owner_ns,
                                                 pbs[u].pod, ns_labels):
                        g = group_row(e_u, term.get("topologyKey", ""))
                        if g is not None:
                            pref[t, u, g] += ipa_ops.HARD_POD_AFFINITY_WEIGHT
                for term, w in e_t.raw_soft_terms:
                    if ipa_ops._term_matches_pod(term, e_t.owner_ns,
                                                 pbs[u].pod, ns_labels):
                        g = group_row(e_u, term.get("topologyKey", ""))
                        if g is not None:
                            pref[t, u, g] += w
    for t, e_t in enumerate(encs):
        _gaff, _ganti, aff_ginc, anti_ginc, pref_gw = ipa_ops.group_fold(e_t)
        aff[t, t, :] = aff_ginc
        anti[t, t, :] = anti_ginc
        eanti[t, t, :] = anti_ginc      # identical clones: the two anti
        pref[t, t, :] = pref_gw         # directions coincide (simulator.py)
    return {"aff_xinc": aff, "anti_xinc": anti, "eanti_xinc": eanti,
            "pref_xinc": pref}


def _port_conflict_matrix(pbs) -> np.ndarray:
    """conflict[t, u]: does a clone of template u on a node block template
    t's clone there via host ports (NodePorts semantics: same protocol +
    port, hostIP wildcard 0.0.0.0 matches everything)?  Symmetric; the
    diagonal is True for any template with host ports (clones of one
    template always clash with themselves).  The object path reaches the
    same verdicts through oracle._filter_node over the shared pod roster."""
    ports = [ps.pod_host_ports(pb.pod) for pb in pbs]
    t_n = len(pbs)
    out = np.zeros((t_n, t_n))
    for a in range(t_n):
        for b in range(a, t_n):
            hit = any(
                ap == bp and aproto == bproto and
                (aip == "0.0.0.0" or bip == "0.0.0.0" or aip == bip)
                for (aproto, aip, ap) in ports[a]
                for (bproto, bip, bp) in ports[b])
            out[a, b] = out[b, a] = float(hit)
    return out


def union_topology_keys(templates: Sequence[dict]) -> List[str]:
    """Every topologyKey used by any template's affinity terms — the extra
    group rows each template's encoding needs so cross contributions from
    other templates' terms have a row to land in."""
    keys: List[str] = []

    def add(term):
        k = (term or {}).get("topologyKey", "")
        if k and k not in keys:
            keys.append(k)

    for t in templates:
        for kind in ("podAffinity", "podAntiAffinity"):
            for term in ipa_ops._required_terms(t, kind):
                add(term)
            for wt in ipa_ops._preferred_terms(t, kind):
                add(wt.get("podAffinityTerm"))
    return keys


# --------------------------------------------------------------------------
# eligibility
# --------------------------------------------------------------------------

def _tier_ranks(snapshot: ClusterSnapshot,
                templates: Sequence[dict]) -> np.ndarray:
    """Dense priority rank per template (0 = highest tier) for the device
    pop key; equal priorities share a rank (FIFO within the tier)."""
    from ..engine.preemption import resolve_priority
    prios = [resolve_priority(t, snapshot.priority_classes)
             for t in templates]
    order = sorted(set(prios), reverse=True)
    rank_of = {p: r for r, p in enumerate(order)}
    return np.asarray([rank_of[p] for p in prios], dtype=np.int32)


def _preempt_maybe(snapshot: ClusterSnapshot,
                   templates: Sequence[dict]) -> np.ndarray:
    """maybe[t]: could DefaultPreemption EVER find a victim for template t —
    some existing pod or some other template's clones sit STRICTLY below
    t's priority (preemption.go:200-205)?  Conservative and static: the
    pod set only loses members below t (evictions) and gains clones at
    known template priorities."""
    from ..engine.preemption import resolve_priority
    prios = [resolve_priority(t, snapshot.priority_classes)
             for t in templates]
    floor = min(prios) if prios else 0
    for plist in snapshot.pods_by_node:
        for pod in plist:
            floor = min(floor, resolve_priority(pod, snapshot.priority_classes))
    return np.asarray([p > floor for p in prios], dtype=bool)


def eligible_profile(snapshot: ClusterSnapshot, templates: Sequence[dict],
                     profile: SchedulerProfile) -> Optional[str]:
    """Profile gates checkable BEFORE the O(T*N) encode pass.  Priority
    tiers and preemption are handled natively (tier-ranked pops on device;
    victim selection as a rare host event between chunks); extenders run
    as one static host round per template."""
    if not profile.deterministic:
        return "non-deterministic tie-break"
    if profile.extenders and not profile.tensor_extenders:
        return "profile declares stateful extenders (tensor_extenders=False)"
    if profile.include_preemption_message:
        return "preemption message formatting needs the object path"
    return None


def eligible(snapshot: ClusterSnapshot, templates: Sequence[dict],
             profile: SchedulerProfile, pbs) -> Optional[str]:
    """None when the tensor engine can run this study; otherwise the reason
    for the object-path fallback."""
    from . import sweep as sweep_mod

    reason = eligible_profile(snapshot, templates, profile)
    if reason is not None:
        return reason
    solvable = [pb for pb in pbs
                if pb.pod_level_reason is None
                and not (pb.pod.get("spec") or {}).get("schedulingGates")]
    if not solvable:
        return None                     # nothing to tensor-solve; trivial
    rn = solvable[0].resource_names
    for pb in solvable:
        # host ports, inline-disk, and RWOP self-conflicts run natively
        # (the conflict matrix / per-template gate scalars × per-template
        # Carry views); anything else — today shared-DRA colocation, whose
        # cross-template claim accounting neither engine models — falls
        # back to the object path
        gates = sweep_mod._self_conflict_gates(pb)
        if gates - {"disk", "rwop"}:
            return "clone self-conflict gates (shared DRA)"
        if "rwop" in gates and "DefaultPreemption" in profile.post_filters \
                and _preempt_maybe(snapshot, templates).any():
            # the RWOP gate rides the bind-ever count (xc.k), which an
            # eviction rebuild preserves — but an EVICTED RWOP clone frees
            # the claim (the object path's live_clones goes back to 0), so
            # preemption-capable studies keep the object path's live
            # accounting
            return "RWOP with possible preemption (live-clone accounting)"
        if pb.resource_names != rn:
            return "templates disagree on the resource vocabulary"
    # _group_key keeps the lonely-pod escape statics in the key so batched
    # sweeps never merge aff-templates with different flags; here the group
    # must contain EVERY template, so normalize them out of the key and
    # check the aff-templates agree separately (_pad_group's any() merge is
    # only sound when they do).
    keys = set()
    aff_flags = set()
    for pb in solvable:
        cfg = sim.static_config(pb)
        if cfg.ipa_num_aff:
            aff_flags.add((cfg.ipa_escape_allowed, cfg.ipa_static_empty))
        k = sweep_mod._group_key(pb, cfg)
        # self-conflict flags normalize out: ports ride the conflict
        # matrix, disk/RWOP ride per-template gate scalars — none of them
        # needs its own jit specialization here
        keys.add((k[0]._replace(ipa_escape_allowed=False,
                                ipa_static_empty=False,
                                clone_has_ports=False,
                                volume_self_conflict=False,
                                rwop_self_conflict=False),) + tuple(k[1:]))
    if len(keys) > 1:
        return "templates need different jit specializations"
    if len(aff_flags) > 1:
        return "affinity templates disagree on lonely-pod escape statics"
    t_n = len(solvable)
    n = snapshot.num_nodes
    padded_c = max(pb.spread_hard.node_domain.shape[0] for pb in solvable) \
        + max(pb.spread_soft.node_domain.shape[0] for pb in solvable) * 2 \
        + max(pb.ipa.node_domain.shape[0] for pb in solvable) * 4
    if t_n * padded_c * n > MAX_ELEMS:
        return "per-template state exceeds the device budget"
    return None


# --------------------------------------------------------------------------
# the step
# --------------------------------------------------------------------------

def _idx(a: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """a[t] for a 0-d index tensor on the device (no host sync)."""
    return a.index_select(0, t.reshape(1))[0]


def _col3(a: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """a[:, :, chosen] for a 0-d index tensor."""
    return a.index_select(2, chosen.reshape(1))[:, :, 0]


class _Rows(dict):
    """Template t's row of every stacked const, taken on first read: the
    step reads a config-dependent subset, and an unread row costs no
    launch (the JAX package's XLA drops the dead slices at trace time)."""

    def __init__(self, stacked: Dict[str, torch.Tensor], t: torch.Tensor):
        super().__init__()
        self._stacked = stacked
        self._t = t

    def __missing__(self, key):
        v = _idx(self._stacked[key], self._t)
        self[key] = v
        return v

    def get(self, key, default=None):
        if dict.__contains__(self, key) or key in self._stacked:
            return self[key]
        return default


def _split_consts(consts: Dict[str, torch.Tensor]):
    """(stacked per-template consts, cross-template consts) from the flat
    dict run_steps carries ("s." / "x." key prefixes)."""
    sconsts = {k[2:]: v for k, v in consts.items() if k[:2] == "s."}
    xconsts = {k[2:]: v for k, v in consts.items() if k[:2] == "x."}
    return sconsts, xconsts


def _xdecide(cfg: sim.StaticConfig, sconsts, xconsts, xc: XCarry,
             tl: torch.Tensor, live: torch.Tensor, ports_blocked,
             track_tpl: bool, red) -> tuple:
    """The popped template's cycle on its row (`tl`: its row there):
    filter, sample, extender mask and bonus, score, choose, and the
    failure's class.  Returns (chosen node, placed, extender-emptied,
    re-park, halt, next sampling start, its request vectors)."""
    dt = sim._dt(cfg)
    dev = xc.k.device
    n_nodes = xc.requested.shape[0]

    c_t = _Rows(sconsts, tl)
    # hostname soft-spread counts ride the consts view: scoring reads
    # hostname_cnt = ss_node_existing + ss_self*placed; cross-template
    # clone counts replace the self term (simulator._score_terms)
    c_t["ss_node_existing"] = c_t["ss_node_existing"] + _idx(xc.ssh_cnt, tl)
    c_t["ss_self"] = torch.zeros_like(c_t["ss_self"])
    own_placed = _idx(xc.tpl_placed, tl) if track_tpl \
        else torch.zeros(n_nodes, dtype=torch.int32, device=dev)
    view = sim.Carry(
        requested=xc.requested, nonzero=xc.nonzero,
        placed=own_placed,               # OWN clones (single-template view)
        sh_cnt=_idx(xc.sh_cnt, tl), ss_cnt=_idx(xc.ss_cnt, tl),
        aff_cnt=_idx(xc.aff_cnt, tl), anti_cnt=_idx(xc.anti_cnt, tl),
        pref_cnt=_idx(xc.pref_cnt, tl), aff_total=_idx(xc.aff_total, tl),
        placed_count=_idx(xc.k, tl), stopped=~live,
        next_start=_idx(xc.next_start, tl), rng=None)

    feasible, parts = sim._feasibility(cfg, c_t, view,
                                       eanti_dyn=_idx(xc.eanti_cnt, tl),
                                       ports_blocked=ports_blocked, red=red)
    any_feasible = red.any(feasible)
    scorable, new_ns = sim._sample_scorable(cfg, feasible, view.next_start,
                                            red)
    # extender Filter applies to the SAMPLED window, after the in-tree
    # filters (schedule_one.go:482-565); the Prioritize bonus is ADDED to
    # the plugin sum without normalization (schedule_one.go:819-877)
    scorable = scorable & _idx(xconsts["ext_mask"], tl)
    any_scorable = red.any(scorable)
    total = sim._scores(cfg, c_t, view, scorable, red) \
        + _idx(xconsts["ext_bonus"], tl)
    # -inf sentinel: extender bonuses may push totals negative
    chosen = red.first_max(torch.where(scorable, total, -float("inf")))

    do = live & any_scorable
    fails = live & ~any_scorable
    # the object loop advances the sampling rotation BEFORE the extender
    # filter, so an extender-emptied window still rotates
    ext_failed = fails & any_feasible
    # Curability (diagnose()'s first-fail attribution): a failure is
    # pod-ADD-curable when SOME node's first failing class is one another
    # pod can change — static port conflicts, spread, inter-pod affinity.
    # Curable failures re-park in the step; the rest halt the chunk so the
    # host can diagnose with the state at exactly this moment.
    ones = torch.ones(n_nodes, dtype=torch.bool, device=dev)
    zeros = torch.zeros(n_nodes, dtype=torch.bool, device=dev)
    fit_ok = parts["fit"].mask if "fit" in parts else ones
    sm = parts.get("spread_missing", zeros)
    s_ok = parts.get("spread_ok", ones)
    if "ipa" in parts:
        f_aff, f_anti, f_eanti = parts["ipa"]
        ipa_fail = f_aff | f_anti | f_eanti
    else:
        ipa_fail = zeros
    base_ok = c_t["static_mask"] & fit_ok & c_t["volume_mask"]
    curable_node = _idx(xconsts["static_ports_fail"], tl) | \
        (base_ok & (sm | ~s_ok | ipa_fail))
    if ports_blocked is not None:
        # dynamic port conflicts attribute BEFORE fit (filter-chain order)
        curable_node = curable_node | (c_t["static_mask"] & ports_blocked)
    curable_now = red.any(curable_node)
    # A template that could preempt must halt on EVERY failure: only the
    # host can evaluate victims (the object loop runs the DefaultPreemption
    # PostFilter before parking)
    pm = _idx(xconsts["preempt_maybe"], tl)
    repark = fails & curable_now & ~pm
    halts = fails & (~curable_now | pm)
    return (chosen, do, ext_failed, repark, halts, new_ns.to(torch.int32),
            c_t["req_vec"], c_t["req_nonzero"])


def _xstep(cfg: sim.StaticConfig, consts, xc: XCarry, red=PLAIN,
           rows=PLAIN_ROWS, track_tpl: Optional[bool] = None):
    """One queue pop: the JAX package's `_xstep` op for op.  Returns
    (carry, (template placed or -1, node or -1)).

    Unsharded, `red` and `rows` are parallel/mesh.PLAIN and PLAIN_ROWS:
    the step runs exactly the plain torch ops, with no host sync.  On a
    mesh shard they are the shard's node reducer (its row's node shards)
    and template-axis reducer (its node column): the carry and consts hold
    the shard's templates and nodes, the pop is one exchange across the
    rows, the row holding the popped template decides (a host read of the
    pop; the other rows wait, and its node shards exchange alone), every
    row takes the decision, and each row updates its own templates' counts
    for the placement.  `track_tpl` says whether `xc.tpl_placed` is
    carried at full size (by default: whether its shape is [T, N])."""
    sconsts, xconsts = _split_consts(consts)
    dt = sim._dt(cfg)
    dev = xc.k.device
    t_n = xc.k.shape[0]
    n_nodes = xc.requested.shape[0]

    inf = torch.full((), 2 ** 30, dtype=torch.int32, device=dev)
    # PrioritySort pop (scheduling_queue.go activeQ + priority_sort.go):
    # highest priority tier first (tier_rank 0 = highest), FIFO by seq
    # within the tier — separate reductions instead of one composite key
    # so big budgets cannot overflow int32
    t, any_active = rows.pop(xc.active, xconsts["tier_rank"], xc.last_seq,
                             inf)
    live = any_active & ~xc.halt & (xc.quota > 0)

    # tpl_placed is carried at full [T, N] only when some gate reads it
    # (host ports / inline disks); otherwise it is a [1, 1] dummy
    if track_tpl is None:
        track_tpl = tuple(xc.tpl_placed.shape) == (t_n, n_nodes)
    # host-port conflicts from ANY template's clones (incl. own), as a
    # boolean reduction: no matmul path can round the verdict
    if track_tpl:
        conflict_row = _idx(xconsts["port_conflict"], t) > 0.5      # [T]
        ports_blocked = rows.any_rows((conflict_row[:, None]
                                       & (xc.tpl_placed > 0)).any(dim=0))
    else:
        ports_blocked = None
    decision = None
    if rows.decides(t):
        decision = _xdecide(cfg, sconsts, xconsts, xc, rows.local(t), live,
                            ports_blocked, track_tpl, red.solo())
    # every row takes the popped template's decision and its requests
    # (each row keeps its own copy of the shared node state)
    chosen, do, ext_failed, repark, halts, new_ns, req_vec, req_nonzero = \
        rows.pick(t, decision)
    gate = do.to(dt)
    onehot_t = torch.arange(rows.offset, rows.offset + t_n, device=dev) == t

    # the chosen node's row on the shard that holds it, and its domain ids
    # published from there to every node shard of the row
    row, _, row_gate = red.own(chosen, do, gate)
    col3 = lambda a: red.publish(_col3(a, row), chosen)
    requested = sim._row_add(xc.requested, row,
                             (row_gate * req_vec)[None, :])
    nonzero = sim._row_add(xc.nonzero, row,
                           (row_gate * req_nonzero)[None, :])
    node_ids = lambda: torch.arange(red.offset, red.offset + n_nodes,
                                    device=dev)
    if track_tpl:
        chosen_onehot = node_ids() == chosen
        tpl_placed = xc.tpl_placed + (onehot_t[:, None]
                                      & chosen_onehot[None, :]
                                      & do).to(torch.int32)
    else:
        tpl_placed = xc.tpl_placed

    sh_cnt, ss_cnt, ssh_cnt = xc.sh_cnt, xc.ss_cnt, xc.ssh_cnt
    if cfg.spread_hard_n > 0:
        xrow = _idx(xconsts["sh_xinc"], t)                      # [T, Ch]
        dom = sconsts["sh_dom"]
        dom_ch = col3(dom)
        inc = xrow * col3(sconsts["sh_countable"]).to(dt) * gate
        hit = (dom == dom_ch[:, :, None]) & (dom >= 0)
        sh_cnt = xc.sh_cnt + hit.to(dt) * inc[:, :, None]
    if cfg.spread_soft_n > 0:
        xrow = _idx(xconsts["ss_xinc"], t)                      # [T, Cs]
        dom = sconsts["ss_dom"]
        dom_ch = col3(dom)
        inc = xrow * col3(sconsts["ss_countable"]).to(dt) * gate
        hit = (dom == dom_ch[:, :, None]) & (dom >= 0)
        ss_cnt = xc.ss_cnt + hit.to(dt) * inc[:, :, None]
        # hostname rows: matching-clones-on-the-node counts, ungated by the
        # inclusion policy (hostname_cnt parity with _score_terms)
        node_onehot = (node_ids() == chosen).to(dt)
        inc_h = xrow * sconsts["ss_host"].to(dt) * gate          # [T, Cs]
        ssh_cnt = xc.ssh_cnt + inc_h[:, :, None] * node_onehot[None, None, :]

    aff_cnt, anti_cnt, eanti_cnt, pref_cnt = \
        xc.aff_cnt, xc.anti_cnt, xc.eanti_cnt, xc.pref_cnt
    aff_total = xc.aff_total
    if cfg.ipa_num_aff > 0 or cfg.ipa_num_anti > 0 or cfg.ipa_num_pref > 0 \
            or cfg.ipa_filter_on or cfg.ipa_score_active:
        dom = sconsts["ipa_dom"]
        dom_ch = col3(dom)                                       # [T, G]
        valid = (dom_ch >= 0).to(dt)
        hit = ((dom == dom_ch[:, :, None]) & (dom >= 0)).to(dt)

        def upd(cnt, key):
            inc = _idx(xconsts[key], t) * valid * gate
            return cnt + hit * inc[:, :, None], inc

        aff_cnt, aff_inc = upd(xc.aff_cnt, "aff_xinc")
        anti_cnt, _ = upd(xc.anti_cnt, "anti_xinc")
        eanti_cnt, _ = upd(xc.eanti_cnt, "eanti_xinc")
        pref_cnt, _ = upd(xc.pref_cnt, "pref_xinc")
        aff_total = xc.aff_total + aff_inc.sum(dim=1)

    # queue bookkeeping: the placement is a pod-ADD event — parked-curable
    # templates re-enter the queue BEFORE the placer's next clone (the
    # object loop requeues, then re-pushes the placer)
    reactivate = xc.parked_curable & do
    active = (xc.active | reactivate) & ~(onehot_t & repark)
    parked_curable = (xc.parked_curable & ~reactivate) | (onehot_t & repark)
    last_seq = torch.where(reactivate, xc.seq_next, xc.last_seq)
    last_seq = torch.where(onehot_t & do, xc.seq_next + 1, last_seq)
    seq_next = xc.seq_next + 2 * do.to(torch.int32)
    k = xc.k + (onehot_t & do).to(torch.int32)
    next_start = torch.where(onehot_t & (do | ext_failed), new_ns,
                             xc.next_start)
    t32 = t.to(torch.int32)

    out = XCarry(
        requested=requested, nonzero=nonzero, tpl_placed=tpl_placed,
        sh_cnt=sh_cnt, ss_cnt=ss_cnt, ssh_cnt=ssh_cnt,
        aff_cnt=aff_cnt, anti_cnt=anti_cnt, eanti_cnt=eanti_cnt,
        pref_cnt=pref_cnt, aff_total=aff_total,
        k=k, active=active, parked_curable=parked_curable,
        last_seq=last_seq, next_start=next_start, seq_next=seq_next,
        quota=xc.quota - do.to(torch.int32),
        halt=xc.halt | halts,
        halt_ti=torch.where(halts, t32, xc.halt_ti))
    minus = torch.full((), -1, dtype=torch.int32, device=dev)
    return out, (torch.where(do, t32, minus),
                 torch.where(do, chosen.to(torch.int32), minus))


def _template_consts(pbs, group_d: int) -> Dict[str, np.ndarray]:
    """The stacked [T, ...] host consts of the group's templates: both
    engines' arrays (simulator.host_consts + _step_host_consts), the soft
    spread's domain slots over the group's widest domain table (so every
    template's [Cs, D] presence table has one shape), and the
    per-template disk and RWOP gate scalars simulator._feasibility reads
    when the group's cfg switches a gate on (shared DRA claims never reach
    the engine: `eligible` sends them to the object loop)."""
    rows = []
    for pb in pbs:
        c = {**sim.host_consts(pb), **sim._step_host_consts(pb)}
        dom = np.asarray(pb.spread_soft.node_domain)
        c["ss_slots"] = (np.arange(dom.shape[0], dtype=np.int64)[:, None]
                         * group_d + np.clip(dom, 0, group_d - 1))
        c["ss_present0"] = np.zeros((dom.shape[0], group_d), np.int32)
        dt = c["allocatable"].dtype
        c["vol_self_gate"] = np.asarray(
            1.0 if pb.volume_self_conflict else 0.0, dtype=dt)
        c["rwop_gate"] = np.asarray(
            1.0 if pb.rwop_self_conflict else 0.0, dtype=dt)
        rows.append(c)
    return {k: np.stack([c[k] for c in rows]) for k in rows[0]}


# --------------------------------------------------------------------------
# the race on a device mesh
# --------------------------------------------------------------------------

# Cross-template consts by layout, as the JAX package shards them, but with
# the template axis on the mesh's batch axis wherever a row reads only its
# own templates: [T, N] tables (rows x nodes), the per-template vectors
# [T] (rows), and the [T_placing, T_observing, ...] increment matrices and
# the port-conflict matrix (every placing template, the row's observers).
_XCONSTS_NODE = frozenset({"ext_mask", "ext_bonus", "static_ports_fail"})
_XCONSTS_TPL = frozenset({"tier_rank", "preempt_maybe"})
_X_TT = frozenset({"sh_xinc", "ss_xinc", "port_conflict", "aff_xinc",
                   "anti_xinc", "eanti_xinc", "pref_xinc"})
# XCarry fields with a template axis (axis 0) and with a node axis (its
# position); the rest (seq_next, quota, halt, halt_ti) are replicated
_XCARRY_TPL = frozenset({"tpl_placed", "sh_cnt", "ss_cnt", "ssh_cnt",
                         "aff_cnt", "anti_cnt", "eanti_cnt", "pref_cnt",
                         "aff_total", "k", "active", "parked_curable",
                         "last_seq", "next_start"})
_XCARRY_NODE = {"requested": 0, "nonzero": 0, "tpl_placed": 1, "sh_cnt": 2,
                "ss_cnt": 2, "ssh_cnt": 2, "aff_cnt": 2, "anti_cnt": 2,
                "eanti_cnt": 2, "pref_cnt": 2}


def _quantize_templates(t_n: int, mesh) -> int:
    """Template-axis pad target on a mesh, the JAX package's (which shares
    one executable across nearby mix sizes), so a shard holds the rows the
    JAX package's does: the next power of two, then up to the mesh's
    batch-shard multiple."""
    t_pad = 1 << max(0, t_n - 1).bit_length() if t_n > 1 else 1
    nb = mesh.shape[mesh_lib.BATCH_AXIS]
    return -(-t_pad // nb) * nb


class _MeshRace:
    """The race's consts and carry on a single-process mesh: shard (r, k)
    holds mesh row r's templates (t_local of them) and node shard k's
    nodes (n_local) of every table, and the pops run on every shard at
    once in one ring (mesh.run_grid), each a `_xstep` with the shard's two
    reducers.  The host loop sees the whole carry, gathered onto the
    mesh's lead device after every chunk (padded; it cuts the pads)."""

    def __init__(self, mesh, t_pad: int, n_pad: int, track_tpl: bool):
        self.mesh = mesh
        self.nb = mesh.shape[mesh_lib.BATCH_AXIS]
        self.nn = mesh.shape[mesh_lib.NODE_AXIS]
        self.t_local = t_pad // self.nb
        self.n_local = n_pad // self.nn
        self.track_tpl = track_tpl
        self.consts: Dict[tuple, Dict[str, torch.Tensor]] = {}
        self.carries: Dict[tuple, XCarry] = {}
        self.xc: Optional[XCarry] = None

    def _shards(self):
        return [(r, k) for r in range(self.nb) for k in range(self.nn)]

    def _rows(self, r: int) -> slice:
        return slice(r * self.t_local, (r + 1) * self.t_local)

    def _nodes(self, k: int) -> slice:
        return slice(k * self.n_local, (k + 1) * self.n_local)

    def load(self, sc_pad: Dict[str, np.ndarray],
             xc_pad: Dict[str, np.ndarray]) -> None:
        """Every shard's stacked consts (`sc_pad`, padded on both axes)
        and cross-template consts (`xc_pad`)."""
        for r, k in self._shards():
            rows, dev = self._rows(r), self.mesh.devices[r, k]
            out = {"s." + key: v for key, v in mesh_lib.shard_consts(
                self.mesh, sc_pad, r, k, rows=rows).items()}
            for key, v in xc_pad.items():
                if key in _XCONSTS_NODE:
                    v = v[rows, self._nodes(k)]
                elif key in _XCONSTS_TPL:
                    v = v[rows]
                elif key in _X_TT:
                    v = v[:, rows]
                else:
                    raise ValueError(f"cross-template const {key!r} has no "
                                     f"mesh layout")
                out["x." + key] = torch.tensor(np.ascontiguousarray(v),
                                               device=dev)
            self.consts[(r, k)] = out

    def _shard(self, xc: XCarry) -> None:
        for r, k in self._shards():
            fields = []
            for f, v in zip(xc._fields, xc):
                tracked = f != "tpl_placed" or self.track_tpl
                if f in _XCARRY_TPL and tracked:
                    v = v[self._rows(r)]
                if f in _XCARRY_NODE and tracked:
                    v = v.narrow(_XCARRY_NODE[f], k * self.n_local,
                                 self.n_local)
                fields.append(v.to(self.mesh.devices[r, k]).contiguous())
            self.carries[(r, k)] = XCarry(*fields)

    def _gather(self) -> XCarry:
        lead = self.mesh.lead
        fields = []
        for i, f in enumerate(XCarry._fields):
            tracked = f != "tpl_placed" or self.track_tpl
            node = f in _XCARRY_NODE and tracked
            row_of = lambda r: (torch.cat(
                [self.carries[(r, k)][i].to(lead) for k in range(self.nn)],
                dim=_XCARRY_NODE[f]) if node
                else self.carries[(r, 0)][i].to(lead))
            if f in _XCARRY_TPL and tracked:
                fields.append(torch.cat([row_of(r) for r in range(self.nb)]))
            else:
                fields.append(row_of(0))
        return XCarry(*fields)

    def run(self, cfg: sim.StaticConfig, xc: XCarry, k: int):
        """K pops from `xc` (sharded again only when the host changed it
        since the last chunk): (the gathered carry, (templates, nodes))."""
        if xc is not self.xc:
            self._shard(xc)

        def shard(r, red, rows):
            step = functools.partial(_xstep, red=red, rows=rows,
                                     track_tpl=self.track_tpl)
            return sim._eager_steps(cfg, self.consts[(r, red.k)],
                                    self.carries[(r, red.k)], k, step)

        out = mesh_lib.run_grid(self.mesh, self.n_local, self.t_local, shard)
        self.carries = {key: v[0] for key, v in out.items()}
        self.xc = self._gather()
        return self.xc, out[(0, 0)][1]


# --------------------------------------------------------------------------
# the host loop
# --------------------------------------------------------------------------

def solve_interleaved_tensor(snapshot: ClusterSnapshot,
                             templates: Sequence[dict],
                             profile: Optional[SchedulerProfile] = None,
                             max_total: int = 0, *,
                             mesh=None, bounds: bool = False,
                             device=None
                             ) -> Optional[List[sim.SolveResult]]:
    """Run the interleaved study on `device` (default the card); None when
    ineligible (callers take sweep.sweep_interleaved, the object loop).

    mesh: shard the stacked template race over a single-process (batch,
    nodes) mesh of `device`'s type (parallel/mesh.py; a multi-process run
    takes distributed.interleave_on_mesh): the template axis pads to a
    power of two and then the batch-shard multiple (pad templates never
    pop), the node axis to the node-shard multiple (inert nodes), and the
    step runs eagerly on every shard (_MeshRace).  bounds: bracket the mix
    first and right-size the step budget / skip statically impossible
    templates.  Neither changes a placement."""
    from . import sweep as sweep_mod

    profile = profile or SchedulerProfile()
    templates = list(templates)
    n = snapshot.num_nodes
    if n == 0 or not templates:
        return None
    if eligible_profile(snapshot, templates, profile) is not None:
        return None                     # before the O(T*N) encode pass
    dev = sim.resolve_device(device)
    home = dev
    if mesh is not None:
        mesh_lib.check_device(mesh, dev)
        if mesh.multi_process:
            raise ValueError("the interleave race runs on a mesh of one "
                             "process's devices: use "
                             "distributed.interleave_on_mesh")
        home = mesh.lead

    with obs_spans.span("interleave.encode"):
        extra_keys = union_topology_keys(templates)
        pbs_all = enc.encode_problems_shared(snapshot, templates, profile,
                                             ipa_extra_keys=extra_keys)
    reason = eligible(snapshot, templates, profile, pbs_all)
    if reason is not None:
        return None

    results: List[Optional[sim.SolveResult]] = [None] * len(templates)
    solve_idx: List[int] = []
    for i, pb in enumerate(pbs_all):
        if (pb.pod.get("spec") or {}).get("schedulingGates"):
            r = enc.REASON_SCHEDULING_GATED
            results[i] = sim.SolveResult(
                placements=[], placed_count=0, fail_type="SchedulingGated",
                fail_message=f"0/{n} nodes are available: {r}.",
                fail_counts={r: n}, node_names=snapshot.node_names)
        elif pb.pod_level_reason:
            results[i] = sim.SolveResult(
                placements=[], placed_count=0,
                fail_type=sim.FAIL_UNSCHEDULABLE,
                fail_message=f"0/{n} nodes are available: "
                             f"{pb.pod_level_reason}.",
                fail_counts={pb.pod_level_reason: n},
                node_names=snapshot.node_names)
        else:
            solve_idx.append(i)
    if not solve_idx:
        return results  # type: ignore[return-value]

    solve_templates = [templates[i] for i in solve_idx]
    t_n = len(solve_idx)
    snap_cur = snapshot
    tier_rank = _tier_ranks(snapshot, solve_templates)
    maybe = _preempt_maybe(snapshot, solve_templates)
    preempt_on = "DefaultPreemption" in profile.post_filters
    preempt_capable = bool(preempt_on and maybe.any())
    preempt_budget = 10 * t_n + 100       # eviction valve (sweep_interleaved)

    # One static extender round per template: Filter over the full node
    # axis -> bool mask, Prioritize -> bonus vector.  Node objects never
    # change during a study (evictions only touch pods), so the verdicts
    # survive rebuilds.
    extenders = list(profile.extenders or [])
    has_binder = any(e.is_binder for e in extenders)
    ext_mask_np = np.ones((t_n, n), dtype=bool)
    ext_bonus_np = np.zeros((t_n, n), dtype=np.float64)
    if extenders:
        from ..engine.extenders import (run_filter_chain,
                                        run_prioritize_chain)
        node_objs = {nm: o for nm, o in zip(snapshot.node_names,
                                            snapshot.nodes)}
        all_names = list(snapshot.node_names)
        for ti, t in enumerate(solve_templates):
            surviving = set(run_filter_chain(extenders, t, all_names,
                                             node_objs))
            ext_mask_np[ti] = np.asarray(
                [nm in surviving for nm in all_names], dtype=bool)
            bonus = run_prioritize_chain(extenders, t, all_names)
            ext_bonus_np[ti] = np.asarray(
                [bonus.get(nm, 0.0) for nm in all_names])

    # Pad targets on a mesh: the node axis to the node-shard multiple with
    # inert rows (statically infeasible, domainless: trailing infeasible
    # nodes, the sampling wrap included), the template axis quantized with
    # copies of the last template that start inactive and never pop.
    # Unsharded runs keep the exact shapes.
    if mesh is not None:
        n_pad = mesh_lib.node_pad(mesh, n)
        t_pad = _quantize_templates(t_n, mesh)
    else:
        n_pad, t_pad = n, t_n
    # carry per-template clone counts at full [T, N] only when a gate
    # reads them (ports / inline disks) — otherwise a [1, 1] dummy saves a
    # full-tensor carry write on every pop
    needs_tpl = any(pbs_all[i].clone_has_host_ports
                    or pbs_all[i].volume_self_conflict
                    for i in solve_idx)
    race = None if mesh is None else _MeshRace(mesh, t_pad, n_pad,
                                               needs_tpl)
    joint_upper: Optional[int] = None

    def encode_group(snap):
        """(pbs, cfg, consts_of, consts, sc_pad, xc_np, dt) for the CURRENT
        snapshot — rebuilt after every eviction round, like the object
        loop's rebuild_after_eviction.  Everything is assembled in numpy
        and moved with one transfer per const (per shard on a mesh, which
        holds no unsharded copy: `consts_of(ti)`, template ti's consts for
        the host diagnosis, then moves its rows on demand)."""
        nonlocal joint_upper
        if snap is snapshot:
            pbs_new = [pbs_all[i] for i in solve_idx]
        else:
            pbs_new = enc.encode_problems_shared(snap, solve_templates,
                                                 profile,
                                                 ipa_extra_keys=extra_keys)
        pbs, cfg = sweep_mod._pad_group(pbs_new)
        # the host-port gate rides the conflict matrix + tpl_placed, not
        # the cfg branch (whose single-template placed>0 rule would read
        # the wrong tensor here); disk/RWOP branches switch on when ANY
        # template needs them — the per-template gate scalars keep them
        # inert for the rest
        cfg = cfg._replace(
            clone_has_ports=False,
            volume_self_conflict=any(pb.volume_self_conflict for pb in pbs),
            rwop_self_conflict=any(pb.rwop_self_conflict for pb in pbs))
        group_d = max(spread_ops.domain_slots(pb.spread_soft.node_domain,
                                              pb.spread_soft.is_hostname)[1]
                      for pb in pbs)
        sc_np = _template_consts(pbs, group_d)
        dt = sc_np["allocatable"].dtype
        f = lambda a: np.asarray(a, dtype=dt)
        xc_np = {
            "sh_xinc": f(_spread_xinc(pbs, "spread_hard")),
            "ss_xinc": f(_spread_xinc(pbs, "spread_soft")),
            # static port conflicts vs EXISTING pods carry the curable
            # ports reason string (diagnose attributes static codes first)
            "static_ports_fail": np.stack([
                np.asarray(pb.static_code) == enc.CODE_PORTS for pb in pbs]),
            "tier_rank": np.asarray(tier_rank),
            "preempt_maybe": np.asarray(
                maybe if preempt_on else np.zeros(t_n, dtype=bool)),
            "ext_mask": ext_mask_np,
            "ext_bonus": f(ext_bonus_np),
            "port_conflict": f(_port_conflict_matrix(pbs)
                               if profile.filter_enabled("NodePorts")
                               else np.zeros((t_n, t_n))),
            **{k: f(v) for k, v in _ipa_xinc(pbs).items()},
        }
        if bounds:
            # bracket the whole mix on the CURRENT snapshot: the sum of the
            # per-template solo uppers caps every future placement count,
            # so hint_budget can right-size the step budget; the guarded
            # device auction degrades to its host recomputation on fault,
            # never into this solve's fault ladder
            from ..bounds.bracket import bracket_mix
            joint, _claims, _deg = bracket_mix(pbs, mesh=mesh, device=dev)
            joint_upper = int(joint.upper)
        to_dev = lambda v, d: torch.from_numpy(np.ascontiguousarray(v)).to(d)
        if race is None:
            sc_pad, consts = sc_np, {"s." + k: to_dev(v, dev)
                                     for k, v in sc_np.items()}
            consts.update({"x." + k: to_dev(v, dev)
                           for k, v in xc_np.items()})
            stacked = {k[2:]: v for k, v in consts.items() if k[:2] == "s."}
            consts_of = lambda ti: {k: v[ti] for k, v in stacked.items()}
        else:
            consts = None
            sc_pad = {k: np.concatenate([v] + [v[-1:]] * (t_pad - t_n))
                      for k, v in sc_np.items()}
            sc_pad = mesh_lib.pad_consts(sc_pad, n_pad, lead=1)
            pad = mesh_lib._pad_axis
            xc_pad = {}
            for k, v in xc_np.items():
                v = pad(v, 0, t_pad, 0)
                if k in _X_TT:
                    v = pad(v, 1, t_pad, 0)
                elif k in _XCONSTS_NODE:
                    v = pad(v, 1, n_pad, 0)
                xc_pad[k] = v
            race.load(sc_pad, xc_pad)
            consts_of = lambda ti: {k: to_dev(v[ti], home)
                                    for k, v in sc_np.items()}
        return pbs, cfg, consts_of, consts, sc_pad, xc_np, dt

    with obs_spans.span("interleave.encode"):
        pbs, cfg, consts_of, consts, sc_pad, xc_np, dt = \
            encode_group(snap_cur)
    tdt = sim._dt(cfg)

    def _tp(a, dtype, fill=0):
        """A host queue vector padded from t_n to the template axis (pad
        templates stay inactive and never parked)."""
        a = np.asarray(a, dtype=dtype)
        return np.concatenate([a, np.full(t_pad - a.shape[0], fill, dtype)])

    def fresh_xcarry(k_counts, active_np, parked_np, last_seq_np,
                     next_start_np, seq_next_v, quota_v):
        g = pbs[0].ipa.node_domain.shape[0]
        cs = pbs[0].spread_soft.node_domain.shape[0]
        host = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(home)
        i32 = lambda a: host(_tp(a, np.int32))
        flag = lambda a: host(_tp(a, bool, False))
        zeros = lambda *shape: torch.zeros(shape, dtype=tdt, device=home)
        node_pad = lambda a: host(mesh_lib._pad_axis(
            np.asarray(a, dtype=dt), 0, n_pad, 0))
        return XCarry(
            requested=node_pad(pbs[0].init_requested),
            nonzero=node_pad(pbs[0].init_nonzero),
            # per-template clone counts start at zero even after an
            # eviction rebuild: surviving clones are baked into the
            # re-encoded snapshot (static port masks included), exactly
            # like the carried spread/affinity counts
            tpl_placed=torch.zeros((t_pad, n_pad) if needs_tpl else (1, 1),
                                   dtype=torch.int32, device=home),
            sh_cnt=host(sc_pad["sh_cnt_init"]),
            ss_cnt=host(sc_pad["ss_cnt_init"]),
            ssh_cnt=zeros(t_pad, cs, n_pad),
            aff_cnt=zeros(t_pad, g, n_pad), anti_cnt=zeros(t_pad, g, n_pad),
            eanti_cnt=zeros(t_pad, g, n_pad),
            pref_cnt=zeros(t_pad, g, n_pad),
            aff_total=zeros(t_pad),
            k=i32(k_counts), active=flag(active_np),
            parked_curable=flag(parked_np), last_seq=i32(last_seq_np),
            next_start=i32(next_start_np),
            seq_next=torch.full((), int(seq_next_v), dtype=torch.int32,
                                device=home),
            quota=torch.full((), int(quota_v), dtype=torch.int32,
                             device=home),
            halt=torch.zeros((), dtype=torch.bool, device=home),
            halt_ti=torch.zeros((), dtype=torch.int32, device=home))

    def hint_budget(total_done: int) -> int:
        """Step allowance from NOW: the fit-bound hints of the CURRENT pbs
        (evictions free capacity, so this is recomputed per rebuild).  With
        bounds on, the mix's joint upper bound right-sizes the allowance;
        every reachable total stays strictly under total_done + upper + 1,
        so the race still ends by natural halts, bit-identically."""
        b = min(total_done + sum(pb.max_steps_hint for pb in pbs) + t_n + 1,
                sim._DEFAULT_UNLIMITED_CAP)
        if joint_upper is not None:
            b = min(b, total_done + joint_upper + 1)
        if max_total:
            b = min(b, max_total)
        return b

    # Bounds-guided skip: a template that fails STATICALLY on every node
    # can never place until an eviction rebuild, and its diagnosis is
    # moment-independent — so it starts parked with its result precomputed.
    # Preemption-capable templates keep the pop (the halt runs the
    # PostFilter), and max_total runs keep it too (the race may end with the
    # queue non-empty, where the reference says LimitReached).
    skip = np.zeros(t_n, dtype=bool)
    if bounds and max_total == 0:
        for ti in range(t_n):
            if (not (preempt_on and maybe[ti])
                    and np.all(np.asarray(pbs[ti].static_code)
                               != enc.CODE_OK)):
                skip[ti] = True

    budget = hint_budget(0)
    xc = fresh_xcarry(np.zeros(t_n), ~skip,
                      np.zeros(t_n, dtype=bool), np.arange(t_n),
                      np.zeros(t_n), t_n, budget)

    def view_of(ti: int) -> sim.Carry:
        """Template ti's single-template Carry view of the shared state
        over the real node table (a mesh's node pads cut off)."""
        own = xc.tpl_placed[ti, :n] if needs_tpl \
            else torch.zeros(n, dtype=torch.int32, device=home)
        return sim.Carry(
            requested=xc.requested[:n], nonzero=xc.nonzero[:n], placed=own,
            sh_cnt=xc.sh_cnt[ti, :, :n], ss_cnt=xc.ss_cnt[ti, :, :n],
            aff_cnt=xc.aff_cnt[ti, :, :n], anti_cnt=xc.anti_cnt[ti, :, :n],
            pref_cnt=xc.pref_cnt[ti, :, :n], aff_total=xc.aff_total[ti],
            placed_count=xc.k[ti],
            stopped=torch.ones((), dtype=torch.bool, device=home),
            next_start=xc.next_start[ti], rng=None)

    def ports_blocked_of(ti: int):
        if not needs_tpl:
            return None
        conflict = xc_np["port_conflict"][ti, :t_n] > 0.5            # [T]
        live = xc.tpl_placed.cpu().numpy()[:t_n, :n] > 0             # [T, N]
        return torch.from_numpy(
            (conflict[:, None] & live).any(axis=0)).to(home)

    def park_result(ti: int):
        blocked = ports_blocked_of(ti)
        c_ti = consts_of(ti)
        eanti = xc.eanti_cnt[ti, :, :n]
        counts = sim.diagnose(pbs[ti], cfg, c_ti, view_of(ti),
                              eanti_dyn=eanti, ports_blocked=blocked)
        if extenders:
            # nodes the in-tree filters accept can only have been lost to
            # the extender Filter chain — the object loop attributes the
            # whole in-tree-feasible set to that bucket
            feas, _ = sim._feasibility(cfg, c_ti, view_of(ti),
                                       eanti_dyn=eanti,
                                       ports_blocked=blocked)
            n_feas = int(feas.sum())
            if n_feas:
                counts = dict(counts)
                from ..engine.extenders import REASON_EXTENDER_FILTER
                counts[REASON_EXTENDER_FILTER] = n_feas
        results[solve_idx[ti]] = sim.SolveResult(
            placements=list(placements[ti]),
            placed_count=len(placements[ti]),
            fail_type=sim.FAIL_UNSCHEDULABLE,
            fail_message=sim.format_fit_error(n, counts),
            fail_counts=counts, node_names=snapshot.node_names)
        return counts

    placements: List[List[int]] = [[] for _ in pbs]
    if skip.any():
        # the skipped templates' diagnoses at the initial state (equal to
        # the reference's later halt: every node carries a static code);
        # a ports-curable skip stays parked_curable so placements re-enter
        # it in the step like the reference's first re-park
        parked0 = xc.parked_curable.cpu().numpy().copy()
        redo = False
        for ti in np.flatnonzero(skip):
            counts = park_result(int(ti))
            if set(counts) & sweep_mod._add_curable_reasons():
                results[solve_idx[int(ti)]] = None
                parked0[int(ti)] = True
                redo = True
        if redo:
            xc = xc._replace(parked_curable=torch.from_numpy(parked0).to(home))
    # Host object mirror for preemption rounds: every node's pod roster
    # (snapshot pods + live clone dicts).  Clone dicts are created ONCE at
    # placement time so victim identity is stable across rounds.
    pods_by_node_cur = [list(p) for p in snapshot.pods_by_node] \
        if preempt_capable else None
    # nodes whose roster differs from snap_cur's arrays (clones placed since
    # the last rebuild + eviction sites) — replace_rosters only recomputes
    # THESE rows
    dirty_nodes: set = set()
    # whole chunks under CUDA-graph replay on the card; the eager steps (on
    # the CPU, and the mesh's) stop sooner after a halt in short ones
    chunk = CHUNK if dev.type == "cuda" and race is None else CPU_CHUNK
    front_seq = -1
    total = 0
    steps_done = 0
    # backstop far above any real run: per placement, every curable-parked
    # template may take one no-op retry pop, each of the <= t_n halts no-ops
    # the remainder of its chunk, and every eviction round can requeue the
    # whole field once
    max_steps = (budget + 1) * (t_n + 2) + CHUNK * (t_n + 2) \
        + (preempt_budget + 1) * (t_n + CHUNK)

    def try_preempt(ti: int) -> bool:
        """DefaultPreemption PostFilter for template ti's halted clone, on
        the host: evaluate victims on the current truth, evict, rebuild the
        engine from the post-eviction snapshot, requeue every parked
        template (pod-DELETE event), and put the preemptor at the front of
        its tier.  True when an eviction happened."""
        nonlocal snap_cur, pbs, cfg, consts_of, consts, sc_pad, xc_np, xc, \
            preempt_budget, front_seq, budget
        from ..engine.extenders import make_node_ok
        from ..engine.preemption import evaluate as preempt_evaluate
        from ..engine.preemption import victim_matcher
        from ..models import snapshot as snapshot_mod

        outcome = preempt_evaluate(
            snap_cur, pods_by_node_cur, solve_templates[ti], profile,
            node_ok=make_node_ok(extenders, solve_templates[ti],
                                 snapshot.node_names, snapshot.nodes),
            extenders=extenders)
        if not (outcome.succeeded and outcome.victims):
            return False
        preempt_budget -= 1
        is_victim = victim_matcher(outcome.victims)
        for i in range(n):
            kept = [p for p in pods_by_node_cur[i] if not is_victim(p)]
            if len(kept) != len(pods_by_node_cur[i]):
                dirty_nodes.add(i)
                pods_by_node_cur[i] = kept
        snap_cur, _ = snapshot_mod.replace_rosters(
            snap_cur, pods_by_node_cur, sorted(dirty_nodes))
        dirty_nodes.clear()

        # carry the queue state across the rebuild
        active_np = xc.active.cpu().numpy().copy()
        parked_np = xc.parked_curable.cpu().numpy().copy()
        last_seq_np = xc.last_seq.cpu().numpy().copy()
        next_start_np = xc.next_start.cpu().numpy().copy()
        seq_next_v = int(xc.seq_next)
        # pod-DELETE reactivates EVERY parked template, in index order
        # (scheduling_queue.go:177-193; sweep_interleaved requeue())
        for tj in range(t_n):
            host_parked = (not active_np[tj]) or parked_np[tj]
            if tj != ti and host_parked:
                active_np[tj] = True
                parked_np[tj] = False
                results[solve_idx[tj]] = None
                last_seq_np[tj] = seq_next_v
                seq_next_v += 1
        # the preemptor retries FIRST within its tier (nominatedNodeName
        # reservation analog) with a fresh sampling cycle
        active_np[ti] = True
        parked_np[ti] = False
        results[solve_idx[ti]] = None
        last_seq_np[ti] = front_seq
        front_seq -= 1
        next_start_np[ti] = 0

        with obs_spans.span("interleave.encode"):
            pbs, cfg, consts_of, consts, sc_pad, xc_np, _dt = \
                encode_group(snap_cur)
        budget = hint_budget(total)
        xc = fresh_xcarry([len(p) for p in placements], active_np,
                          parked_np, last_seq_np, next_start_np,
                          seq_next_v, budget - total)
        return True

    while steps_done < max_steps:
        if not bool(xc.active.any()) or total >= budget:
            break
        if race is None:
            xc, (ts, chs) = sim.run_steps(_xstep, cfg, consts, xc, chunk)
        else:
            xc, (ts, chs) = race.run(cfg, xc, chunk)
        # the chunk's pops reach the host; the halt flag is the chunk's
        # too (the drain below leaves xc alone)
        with obs_spans.span("interleave.wait"):
            ts, chs = ts.cpu().tolist(), chs.cpu().tolist()
            halted = bool(xc.halt)
        with obs_spans.span("interleave.drain"):
            for t_i, ch_i in zip(ts, chs):
                if t_i < 0:
                    continue
                placements[t_i].append(ch_i)
                total += 1
                if preempt_capable or has_binder:
                    clone = ps.make_clone(solve_templates[t_i],
                                          len(placements[t_i]) - 1)
                    clone["spec"]["nodeName"] = snapshot.node_names[ch_i]
                    if has_binder:
                        # chunk-end bind drain, in placement order (a bind
                        # error propagates as in sweep_interleaved)
                        from ..engine.extenders import run_bind
                        run_bind(extenders, clone,
                                 snapshot.node_names[ch_i])
                    if preempt_capable:
                        pods_by_node_cur[ch_i].append(clone)
                        dirty_nodes.add(ch_i)
        steps_done += chunk
        if halted:
            ti = int(xc.halt_ti)
            if preempt_capable and maybe[ti] and preempt_budget > 0 \
                    and try_preempt(ti):
                continue
            # preemption impossible/failed: diagnose with the state at
            # exactly this moment (the steps after the halt changed
            # nothing) and park
            counts = park_result(ti)
            active_np = xc.active.cpu().numpy().copy()
            parked_np = xc.parked_curable.cpu().numpy().copy()
            active_np[ti] = False
            # the step's curability test mirrors diagnose(); if they ever
            # drift, trust the diagnosis (requeue rather than strand)
            parked_np[ti] = bool(set(counts) &
                                 sweep_mod._add_curable_reasons())
            if parked_np[ti]:
                # re-queued after all: the diagnosis just recorded may go
                # stale — drop it so the end pass re-diagnoses
                results[solve_idx[ti]] = None
            xc = xc._replace(
                active=torch.from_numpy(active_np).to(home),
                parked_curable=torch.from_numpy(parked_np).to(home),
                halt=torch.zeros((), dtype=torch.bool, device=home))

    # End classification mirrors the object loop's break: templates still
    # IN the queue get LimitReached; curable-parked ones are diagnosed now
    # (their last in-step re-park state IS this end state).
    active_end = xc.active.cpu().numpy()
    for ti in range(t_n):
        i = solve_idx[ti]
        if bool(active_end[ti]):
            results[i] = sim.SolveResult(
                placements=list(placements[ti]),
                placed_count=len(placements[ti]),
                fail_type=sim.FAIL_LIMIT_REACHED,
                fail_message=(f"Maximum number of pods simulated: "
                              f"{max_total or budget}"),
                node_names=snapshot.node_names)
        elif results[i] is None:        # in-step curable park
            park_result(ti)
    return results  # type: ignore[return-value]


def sweep_interleaved_auto(snapshot: ClusterSnapshot,
                           templates: Sequence[dict],
                           profile: Optional[SchedulerProfile] = None,
                           max_total: int = 0, *,
                           mesh=None,
                           bounds: Optional[bool] = None,
                           device=None) -> List[sim.SolveResult]:
    """The interleave engine when eligible, the object-level queue loop
    (sweep.sweep_interleaved) otherwise, as in the JAX package.

    With `mesh` the race runs sharded over it first (guard.run at
    faults.SITE_INTERLEAVE_SHARDED, answers stamped rung
    'interleave_sharded'); a classified fault there serves the unsharded
    engine's answers, stamped 'interleave' and degraded.  The unsharded
    engine runs under guard.run at faults.SITE_INTERLEAVE and its answers
    are unstamped unless a mesh fault sent them; after a classified fault
    there the object loop serves, its answers stamped degraded on rung
    'oracle' (the JAX package serves them unstamped: the port names the
    descent).  `bounds` defaults to True on a mesh and False otherwise, as
    in the JAX package."""
    from ..runtime import degrade, faults, guard
    from ..runtime.errors import RuntimeFault
    from .sweep import sweep_interleaved

    bounds = (mesh is not None) if bounds is None else bounds
    degraded = False
    if mesh is not None:
        try:
            res = guard.run(solve_interleaved_tensor, snapshot, templates,
                            profile, max_total=max_total, mesh=mesh,
                            bounds=bounds, device=device,
                            site=faults.SITE_INTERLEAVE_SHARDED,
                            validate_nodes=snapshot.num_nodes,
                            rung=degrade.RUNG_INTERLEAVE_SHARDED,
                            batch=len(templates),
                            mesh_shape=mesh_lib.mesh_shape(mesh))
        except RuntimeFault as fault:
            degrade._record(fault, degrade.RUNG_INTERLEAVE)
            degraded = True
            res = None          # the unsharded engine serves
        if res is not None:
            return [degrade._stamp(r, degrade.RUNG_INTERLEAVE_SHARDED, False)
                    for r in res]
    try:
        res = guard.run(solve_interleaved_tensor, snapshot, templates,
                        profile, max_total=max_total, bounds=bounds,
                        device=device, site=faults.SITE_INTERLEAVE,
                        validate_nodes=snapshot.num_nodes,
                        rung=degrade.RUNG_INTERLEAVE)
    except RuntimeFault as fault:
        degrade._record(fault, degrade.RUNG_ORACLE)
        return [degrade._stamp(r, degrade.RUNG_ORACLE, True)
                for r in sweep_interleaved(snapshot, templates, profile,
                                           max_total=max_total)]
    if res is not None:
        if degraded:
            return [degrade._stamp(r, degrade.RUNG_INTERLEAVE, True)
                    for r in res]
        return res
    return sweep_interleaved(snapshot, templates, profile,
                             max_total=max_total)

"""Batched what-if sweeps: many pod templates against one snapshot.

The reference answers one podspec per process run; sweeping (the genpod use
case) costs a full simulator run per spec.  Here a sweep encodes every
template, solves one representative per behaviour class (content-hash
dedup), and routes each representative to one of three places, exactly as
the JAX package's parallel/sweep.py does:

- small-limit templates the closed form can take ride ONE batched argsort
  per group (engine/fast_path.solve_fast_batched under runtime/guard.run at
  site engine.fast_path; unstamped results, and a classified fault sends
  the group to the per-template ladder, flagged degraded);
- other batchable templates ride one batched kernel solve per group
  (runtime/degrade.solve_group_guarded -> solve_group -> _batched_solve,
  the batched CUDA kernel of engine/fused_batched.py; rung
  'fused_batched'; DeviceOOM halves the group, other classified faults
  descend to the per-template ladder).  A group the batched kernel does
  not take (float64 parity, the random tie-break, a shape outside its
  envelope) runs the scan step (engine/simulator.py) one template at a
  time under the group's step budget, the same numbers as the JAX
  package's vmapped group, and is stamped 'fused_batched' as there;
- everything else is solved alone (runtime/degrade.solve_one_guarded; rung
  'fused', or the lower rung that served after a classified fault).

Heterogeneous spread/affinity templates share a group: their constraint and
group axes pad to the group maxima with inert rows (_pad_group).  Only clone
self-conflict gates (host ports, inline disk, RWOP, shared DRA claims) and
pod-level rejections stay per template.

explain=True sends every representative through the per-template ladder
(attribution is a per-template product); solve_group(explain=True) builds
each template's why-not from its slice of the group's terminal carry.
Meshes and interleaved shared-state sweeps are not ported and raise.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..engine import encode as enc
from ..engine import simulator as sim
from ..models.snapshot import ClusterSnapshot
from ..utils.config import SchedulerProfile


def _self_conflict_gates(pb: enc.EncodedProblem) -> set:
    """Named clone self-conflict gates on a template."""
    out = set()
    if pb.volume_self_conflict:
        out.add("disk")
    if pb.rwop_self_conflict:
        out.add("rwop")
    if pb.dra_shared_colocate:
        out.add("dra")
    return out


def _batchable(pb: enc.EncodedProblem) -> bool:
    """Templates whose constraints can ride a batched group solve: all but
    the clone self-conflict gates and pod-level rejections."""
    return (not pb.clone_has_host_ports and pb.pod_level_reason is None
            and not _self_conflict_gates(pb))


def _group_key(pb: enc.EncodedProblem, cfg) -> tuple:
    """Group templates that can share ONE batched solve.  Count fields that
    padding makes uniform are normalized to any/none; everything else in
    StaticConfig must match exactly."""
    norm = cfg._replace(
        spread_hard_n=0, spread_soft_n=0,
        ipa_num_aff=0, ipa_num_anti=0, ipa_num_pref=0,
        ipa_filter_on=False, ipa_score_active=False, na_active=False,
        volume_filter_on=False,
        # the lonely-pod escape statics only matter to templates with
        # required affinity terms; others merge freely
        ipa_escape_allowed=cfg.ipa_escape_allowed if cfg.ipa_num_aff else False,
        ipa_static_empty=cfg.ipa_static_empty if cfg.ipa_num_aff else False,
    )
    return (norm, pb.req_vec.shape, pb.fit_res_idx.shape,
            pb.balanced_res_idx.shape)


def _pad_group(pbs: List[enc.EncodedProblem]) -> tuple:
    """Pad every template's constraint/group axes to the group maxima.
    Returns (padded problems, the group StaticConfig)."""
    from ..ops import inter_pod_affinity as ipa_ops
    from ..ops import pod_topology_spread as spread_ops

    ch = max(pb.spread_hard.node_domain.shape[0] for pb in pbs)
    cs = max(pb.spread_soft.node_domain.shape[0] for pb in pbs)
    g = max(pb.ipa.node_domain.shape[0] for pb in pbs)
    padded = [dataclasses.replace(
        pb,
        spread_hard=spread_ops.pad_constraints(pb.spread_hard, ch),
        spread_soft=spread_ops.pad_constraints(pb.spread_soft, cs),
        ipa=ipa_ops.pad_groups(pb.ipa, g)) for pb in pbs]

    # Uniform step config: count gates switch on when ANY template needs the
    # plugin — inert padded rows make it a no-op for the others.
    cfgs = [sim.static_config(pb) for pb in padded]
    aff_cfgs = [c for c in cfgs if c.ipa_num_aff]
    cfg = cfgs[0]._replace(
        spread_hard_n=max(c.spread_hard_n for c in cfgs),
        spread_soft_n=max(c.spread_soft_n for c in cfgs),
        ipa_num_aff=max(c.ipa_num_aff for c in cfgs),
        ipa_num_anti=max(c.ipa_num_anti for c in cfgs),
        ipa_num_pref=max(c.ipa_num_pref for c in cfgs),
        ipa_filter_on=any(c.ipa_filter_on for c in cfgs),
        ipa_score_active=any(c.ipa_score_active for c in cfgs),
        na_active=any(c.na_active for c in cfgs),
        volume_filter_on=any(c.volume_filter_on for c in cfgs),
        ipa_escape_allowed=any(c.ipa_escape_allowed for c in aff_cfgs),
        ipa_static_empty=any(c.ipa_static_empty for c in aff_cfgs),
    )
    return padded, cfg


def _refuse(what: str, item: str) -> None:
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP: port "
                              f"queue, {item})")


def sweep(snapshot: ClusterSnapshot, templates: Sequence[dict],
          profile: Optional[SchedulerProfile] = None, max_limit: int = 0,
          mesh=None, queue_sort: bool = False, explain: bool = False,
          bounds: bool = True, device=None) -> List[sim.SolveResult]:
    """Solve capacity for every template; batched where possible.  Results
    align with `templates`.

    queue_sort=True orders the templates the way the scheduling queue would
    (PrioritySort: priority desc, creation asc) before solving; results
    still align with the INPUT order.  bounds clamps step budgets to the
    capacity upper bounds (bounds/bracket.py).  device: the card unless the
    caller names the CPU.

    explain=True attaches full attribution (why-here + why-not +
    bottleneck) to every result by routing each representative through the
    per-template ladder instead of the batched kernels; dedup still applies
    and the placements are the same either way."""
    if mesh is not None:
        _refuse("sweeps over a device mesh", "parallel/mesh")
    profile = profile or SchedulerProfile()
    dev = sim.resolve_device(device)
    templates = list(templates)
    if queue_sort:
        from ..ops.priority_sort import sort_pods
        order = sort_pods(templates, snapshot.priority_classes)
        ordered = sweep(snapshot, order, profile=profile,
                        max_limit=max_limit, explain=explain, bounds=bounds,
                        device=dev)
        by_id = {id(t): r for t, r in zip(order, ordered)}
        return [by_id[id(t)] for t in templates]
    problems = [enc.encode_problem(snapshot, t, profile) for t in templates]

    from ..engine import fast_path
    from ..runtime import degrade

    results: List[Optional[sim.SolveResult]] = [None] * len(templates)

    # Behavioral dedup: solve one representative per signature class and
    # share its result.
    digest_cache: dict = {}
    sig_rep: Dict[bytes, int] = {}
    dup_of: Dict[int, int] = {}
    rep_idx: List[int] = []
    for i, pb in enumerate(problems):
        sig = _solve_signature(pb, digest_cache)
        j = sig_rep.get(sig)
        if j is None:
            sig_rep[sig] = i
            rep_idx.append(i)
        else:
            dup_of[i] = j

    groups: Dict[tuple, List[int]] = {}
    fp_groups: Dict[tuple, List[int]] = {}
    rest_idx: List[int] = []
    small_limit = bool(max_limit) and max_limit <= 4096
    for i in rep_idx:
        pb = problems[i]
        if explain:
            # attribution is a per-template product (why-here needs the
            # per-step score terms): the ladder serves every template
            rest_idx.append(i)
        elif not small_limit and fast_path.eligible(pb):
            rest_idx.append(i)
        elif small_limit and fast_path.eligible_limited(pb):
            key = _group_key(pb, sim.static_config(pb))
            fp_groups.setdefault(key, []).append(i)
        elif _batchable(pb):
            key = _group_key(pb, sim.static_config(pb))
            groups.setdefault(key, []).append(i)
        else:
            rest_idx.append(i)

    from ..runtime import faults, guard
    from ..runtime.errors import RuntimeFault

    # Sweep progress gauges (obs/names.py): how the template set split
    # across solve modes — the sequential count is set below once
    # singleton groups fold into rest_idx.
    from ..obs import names as obs_names
    from ..utils.metrics import default_registry as _registry
    _registry.set_gauge(obs_names.SWEEP_TEMPLATES, len(templates))
    _registry.set_gauge(obs_names.SWEEP_GROUPS, len(fp_groups),
                        mode="fast_path")
    _registry.set_gauge(obs_names.SWEEP_GROUPS, len(groups), mode="batched")

    for idxs in fp_groups.values():
        if len(idxs) == 1:
            rest_idx.append(idxs[0])
            continue
        try:
            batch = guard.run(
                lambda idxs=idxs: fast_path.solve_fast_batched(
                    [problems[i] for i in idxs], max_limit, device=dev),
                site=faults.SITE_FAST_PATH,
                validate_nodes=snapshot.num_nodes,
                rung=degrade.RUNG_FAST_PATH, batch=len(idxs))
        except RuntimeFault:
            # the batched closed form faulted: the per-template ladder
            # serves these, flagged degraded
            for i in idxs:
                results[i] = degrade.solve_one_guarded(
                    problems[i], max_limit=max_limit, degraded=True,
                    bounds=bounds, device=dev)
            continue
        for i, r in zip(idxs, batch):
            if r is None:
                rest_idx.append(i)        # capacity below limit / proof failed
            else:
                results[i] = r

    for idxs in groups.values():
        if len(idxs) == 1:
            rest_idx.append(idxs[0])
            continue
        batch = degrade.solve_group_guarded([problems[i] for i in idxs],
                                            max_limit=max_limit,
                                            bounds=bounds, device=dev)
        for i, r in zip(idxs, batch):
            results[i] = r

    _registry.set_gauge(obs_names.SWEEP_GROUPS, len(rest_idx),
                        mode="sequential")
    for i in rest_idx:
        results[i] = degrade.solve_one_guarded(problems[i],
                                               max_limit=max_limit,
                                               explain=explain,
                                               bounds=bounds, device=dev)
    for i, j in dup_of.items():
        # each duplicate gets its own placements/fail_counts, so a caller
        # mutating one result cannot corrupt its class siblings
        r = results[j]
        results[i] = dataclasses.replace(r, placements=list(r.placements),
                                         fail_counts=dict(r.fail_counts))
    return results  # type: ignore[return-value]


def _solve_signature(pb: enc.EncodedProblem, digest_cache: dict) -> bytes:
    """Content hash of everything the engine reads from an EncodedProblem.
    Two templates with equal signatures (against the same snapshot/profile)
    are behaviorally identical, so a sweep solves one representative per
    class.  Arrays hash once per object via the id cache."""
    h = hashlib.sha1()

    def add(v):
        if isinstance(v, np.ndarray):
            key = id(v)
            d = digest_cache.get(key)
            if d is None:
                hb = hashlib.sha1(np.ascontiguousarray(v).tobytes())
                hb.update(repr(v.shape).encode())
                hb.update(v.dtype.str.encode())
                d = hb.digest()
                digest_cache[key] = d
            h.update(d)
        elif isinstance(v, (list, tuple)) and len(v) > 256:
            # long derived lists (one entry per node): pickle in C, digest
            # once per object
            key = id(v)
            d = digest_cache.get(key)
            if d is None:
                d = hashlib.sha1(pickle.dumps(v, protocol=4)).digest()
                digest_cache[key] = d
            h.update(d)
        elif isinstance(v, (list, tuple)):
            h.update(b"(")
            for x in v:
                add(x)
            h.update(b")")
        else:
            h.update(repr(v).encode())

    # The two per-node reason LISTS are pure functions of (snapshot, a small
    # pod slice): hash the slice instead of N strings (they read only the
    # tolerations, resp. namespace + spec.volumes, of the pod).
    from ..models.podspec import pod_tolerations
    from ..ops.taint_toleration import _tols_key
    add(("taint_src", _tols_key(pod_tolerations(pb.pod))))
    spec = pb.pod.get("spec") or {}
    add(("vol_src",
         (pb.pod.get("metadata") or {}).get("namespace") or "default",
         json.dumps(spec.get("volumes"), sort_keys=True, default=str)))

    for f in dataclasses.fields(pb):
        if f.name in ("snapshot", "pod", "profile",
                      "taint_reasons", "volume_reasons"):
            continue
        v = getattr(pb, f.name)
        if dataclasses.is_dataclass(v):
            for g in dataclasses.fields(v):
                if g.name in ("raw_aff_terms", "raw_anti_terms",
                              "raw_soft_terms", "selectors"):
                    # raw labelSelector terms feed no solve path: templates
                    # whose selectors differ but encode to the same tensors
                    # place identically
                    continue
                add(getattr(v, g.name))
        else:
            add(v)
    return h.digest()


def _group_uniform(arrs: List[np.ndarray]) -> bool:
    """True when every template's array is the same value.  Object identity
    first; a content compare only for arrays big enough that B copies cost
    more than one memcmp sweep, bailing on the first mismatch."""
    a0 = arrs[0]
    rest = [a for a in arrs[1:] if a is not a0]
    if not rest:
        return True
    if a0.nbytes < (1 << 16):
        return False
    return all(np.array_equal(a, a0) for a in rest)


def _group_consts(pbs: List[enc.EncodedProblem]) -> List[dict]:
    """build_consts for every template, on the host; arrays equal across
    the whole group (the snapshot's allocatable, shared topology ids, ...)
    become ONE tensor every template's dict shares."""
    host = [sim.host_consts(pb) for pb in pbs]
    out: List[dict] = [{} for _ in pbs]
    for k in host[0]:
        arrs = [h[k] for h in host]
        if _group_uniform(arrs):
            t = torch.tensor(arrs[0])
            for d in out:
                d[k] = t
        else:
            for d, a in zip(out, arrs):
                d[k] = torch.tensor(a)
    return out


def solve_group(pbs: List[enc.EncodedProblem], max_limit: int = 0,
                device=None, mesh=None, explain: bool = False,
                bounds: bool = True) -> List[sim.SolveResult]:
    """Public batched-group entry for pre-encoded problems sharing a group
    key (_group_key) and batchable shape (_batchable).  With `explain`,
    each result carries the why-not of its template's slice of the group's
    terminal carry (no why-here: a per-template product)."""
    if mesh is not None:
        _refuse("sweeps over a device mesh", "parallel/mesh")
    return _batched_solve(list(pbs), max_limit,
                          sim.resolve_device(device), bounds, explain)


def _group_budget(pbs: List[enc.EncodedProblem], max_limit: int,
                  bounds: bool) -> int:
    """The group's step budget: it runs until its last template stops, so
    the max over the templates of min(max_steps_hint, upper bound) + 1
    (with `bounds`; else of max_steps_hint + 1), then max_limit and the
    unlimited-run cap."""
    if bounds:
        from ..bounds.bracket import upper_bound_host
        budget = max(min(pb.max_steps_hint, upper_bound_host(pb))
                     for pb in pbs) + 1
    else:
        budget = max(pb.max_steps_hint for pb in pbs) + 1
    if max_limit and max_limit > 0:
        budget = min(max_limit, budget)
    return max(1, min(budget, sim._DEFAULT_UNLIMITED_CAP))


def _explain_terminal(pb: enc.EncodedProblem, cfg, consts, carry):
    """Why-not from one template's terminal carry (the group rung's
    Explanation: codes and fit detail, no why-here)."""
    from ..explain import artifacts, attribution
    codes, insufficient, too_many = attribution.final_codes(
        cfg, attribution.explain_consts(pb, consts), carry)
    return artifacts.build_explanation(
        pb, final_codes=codes, insufficient=insufficient,
        too_many=too_many, rung="fused_batched")


def _batched_solve(pbs: List[enc.EncodedProblem], max_limit: int,
                   dev, bounds: bool = True,
                   explain: bool = False) -> List[sim.SolveResult]:
    from ..engine import fused, fused_batched

    # Segment huge groups: templates are independent, so segment results
    # concatenate losslessly.
    if len(pbs) > fused_batched.MAX_BATCH:
        out: List[sim.SolveResult] = []
        for i in range(0, len(pbs), fused_batched.MAX_BATCH):
            out.extend(_batched_solve(pbs[i:i + fused_batched.MAX_BATCH],
                                      max_limit, dev, bounds, explain))
        return out

    budget = _group_budget(pbs, max_limit, bounds)
    # the chunk length rounds up to a power of two; steps past the stop place
    # nothing and a max_limit-bound budget is re-trimmed below
    chunk = min(1024, budget)
    if chunk > 1:
        chunk = 1 << (chunk - 1).bit_length()
    padded, cfg = _pad_group(pbs)
    if not all(fused.eligible(cfg, pb) for pb in padded):
        return [_group_step_solve(pb, max_limit, dev, budget, chunk, explain)
                for pb in pbs]
    pbs = padded
    consts_list = _group_consts(pbs)
    carry_list = [sim._init_carry(pb, c) for pb, c in zip(pbs, consts_list)]

    runner = fused_batched.BatchedFusedRunner(cfg, pbs, consts_list, dev)
    state = runner.pack(carry_list)
    placements: List[List[int]] = [[] for _ in pbs]
    steps_done = 0
    while steps_done < budget:
        state, chosen, all_stopped = runner.run_packed(state, chunk)
        for b in range(len(pbs)):
            col = chosen[:, b]
            placements[b].extend(col[col >= 0].tolist())
        steps_done += chunk
        if all_stopped:
            break
    if max_limit and max_limit > 0:
        placements = [p[:max_limit] for p in placements]

    # Unpack the planes (a [B, P, S*128] device->host copy) only when some
    # template stopped short of its limit and needs diagnose(), or explain
    # needs every template's terminal codes.
    stopped = fused_batched.stopped_flags(state[1])
    carries = None
    if explain or any(bool(stopped[b])
                      and not (max_limit and len(placements[b]) >= max_limit)
                      for b in range(len(pbs))):
        carries = runner.unpack(state, carry_list)

    results = []
    for b, pb in enumerate(pbs):
        placed = len(placements[b])
        expl = _explain_terminal(pb, cfg, consts_list[b], carries[b]) \
            if explain else None
        if max_limit and placed >= max_limit:
            results.append(sim.SolveResult(
                placements=placements[b], placed_count=placed,
                fail_type=sim.FAIL_LIMIT_REACHED,
                fail_message=f"Maximum number of pods simulated: {max_limit}",
                node_names=pb.snapshot.node_names, explain=expl))
        elif stopped[b]:
            counts = sim.diagnose(pb, cfg, consts_list[b], carries[b])
            results.append(sim.SolveResult(
                placements=placements[b], placed_count=placed,
                fail_type=sim.FAIL_UNSCHEDULABLE,
                fail_message=sim.format_fit_error(pb.snapshot.num_nodes,
                                                  counts),
                fail_counts=counts, node_names=pb.snapshot.node_names,
                explain=expl))
        else:
            results.append(sim.SolveResult(
                placements=placements[b], placed_count=placed,
                fail_type=sim.FAIL_LIMIT_REACHED,
                fail_message=(f"Simulation step budget exhausted after "
                              f"{placed} placements"),
                node_names=pb.snapshot.node_names, explain=expl))
    return results


def _group_step_solve(pb: enc.EncodedProblem, max_limit: int, dev,
                      budget: int, chunk: int,
                      explain: bool = False) -> sim.SolveResult:
    """One template of a group the batched kernel does not take, through
    the scan step in chunks of `chunk` steps under the GROUP's budget —
    what the template's column of the JAX package's vmapped group computes,
    step for step.  The messages (and, with `explain`, the why-not) are the
    batched path's."""
    cfg = sim.static_config(pb)
    consts = sim.build_consts(pb, dev)
    placements, carry = sim._drive_step(cfg, consts,
                                        sim._init_carry(pb, consts), budget,
                                        chunk)
    if max_limit and max_limit > 0:
        placements = placements[:max_limit]
    placed = len(placements)
    expl = _explain_terminal(pb, cfg, consts, carry) if explain else None
    if max_limit and placed >= max_limit:
        return sim.SolveResult(
            placements=placements, placed_count=placed,
            fail_type=sim.FAIL_LIMIT_REACHED,
            fail_message=f"Maximum number of pods simulated: {max_limit}",
            node_names=pb.snapshot.node_names, explain=expl)
    if bool(carry.stopped):
        counts = sim.diagnose(pb, cfg, consts, carry)
        return sim.SolveResult(
            placements=placements, placed_count=placed,
            fail_type=sim.FAIL_UNSCHEDULABLE,
            fail_message=sim.format_fit_error(pb.snapshot.num_nodes, counts),
            fail_counts=counts, node_names=pb.snapshot.node_names,
            explain=expl)
    return sim.SolveResult(
        placements=placements, placed_count=placed,
        fail_type=sim.FAIL_LIMIT_REACHED,
        fail_message=(f"Simulation step budget exhausted after "
                      f"{placed} placements"),
        node_names=pb.snapshot.node_names, explain=expl)

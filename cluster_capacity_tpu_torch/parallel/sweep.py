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

`sweep_interleaved` is the other kind of study: templates racing through
ONE shared cluster state under the scheduling queue's pop order, on the
host over the object-level oracle.  It is the interleave engine's
differential oracle and its last rung (parallel/interleave.py).

With a device mesh (parallel/mesh.py) the small-limit closed form stays
off, as in the JAX package, and every batchable group of two or more runs
sharded: its templates split across the mesh rows and each row runs its
templates one at a time, under the group's step budget, on the
node-sharded step over the row's devices (runtime/degrade's
sharded_batched rung).
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
    profile = profile or SchedulerProfile()
    dev = sim.resolve_device(device)
    if mesh is not None:
        from . import mesh as mesh_lib
        mesh_lib.check_device(mesh, dev)
    templates = list(templates)
    if queue_sort:
        from ..ops.priority_sort import sort_pods
        order = sort_pods(templates, snapshot.priority_classes)
        ordered = sweep(snapshot, order, profile=profile,
                        max_limit=max_limit, mesh=mesh, explain=explain,
                        bounds=bounds, device=dev)
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
    # the batched closed form is single-device: under a mesh it stays off,
    # and only batchable groups of 2+ run the sharded step
    small_limit = bool(max_limit) and max_limit <= 4096 and mesh is None
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
                                            max_limit=max_limit, mesh=mesh,
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
    terminal carry (no why-here: a per-template product).  With `mesh` the
    group runs sharded (`_sharded_solve`; explain is ignored there, as in
    the JAX package)."""
    dev = sim.resolve_device(device)
    if mesh is not None:
        from . import mesh as mesh_lib
        mesh_lib.check_device(mesh, dev)
        return _sharded_solve(list(pbs), max_limit, mesh, bounds)
    return _batched_solve(list(pbs), max_limit, dev, bounds, explain)


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
    chunk = _group_chunk(budget)
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


def _group_chunk(budget: int) -> int:
    """The group's chunk length: min(1024, budget) rounded up to a power of
    two (steps past the stop place nothing; a max_limit-bound budget is
    re-trimmed after the run)."""
    chunk = min(1024, budget)
    return 1 << (chunk - 1).bit_length() if chunk > 1 else chunk


def _sharded_solve(pbs: List[enc.EncodedProblem], max_limit: int, mesh,
                   bounds: bool = True) -> List[sim.SolveResult]:
    """A group over a device mesh: the templates split across the mesh rows
    (parallel/mesh.batch_rows) and each row runs its templates one at a
    time on the node-sharded step over the row's devices, within the
    group's step budget — the numbers of the JAX package's sharded vmapped
    group.  In a multi-process mesh whose rows lie in different processes,
    every process ends with every row's results."""
    from ..engine import fused_batched
    from . import mesh as mesh_lib

    if len(pbs) > fused_batched.MAX_BATCH:
        out: List[sim.SolveResult] = []
        for i in range(0, len(pbs), fused_batched.MAX_BATCH):
            out.extend(_sharded_solve(pbs[i:i + fused_batched.MAX_BATCH],
                                      max_limit, mesh, bounds))
        return out
    budget = _group_budget(pbs, max_limit, bounds)
    rows = mesh_lib.batch_rows(mesh, len(pbs))
    runs = sim.drive_mesh(mesh, {r: [pbs[i] for i in idxs]
                                 for r, idxs in enumerate(rows)},
                          budget, _group_chunk(budget))
    results: Dict[int, sim.SolveResult] = {}
    for r, done in runs.items():
        for i, (placements, carry) in zip(rows[r], done):
            pb = pbs[i]
            results[i] = _group_result(pb, sim.static_config(pb),
                                       lambda pb=pb: sim.build_consts(
                                           pb, mesh.lead),
                                       placements, carry, max_limit)
    if mesh.multi_process and mesh.shape[mesh_lib.BATCH_AXIS] > 1:
        import torch.distributed as dist
        parts: List[dict] = [None] * dist.get_world_size()
        dist.all_gather_object(parts, results)
        for part in parts:
            results.update(part)
    return [results[i] for i in range(len(pbs))]


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
    return _group_result(pb, cfg, lambda: consts, placements, carry,
                         max_limit, explain)


def _group_result(pb: enc.EncodedProblem, cfg, consts_fn, placements,
                  carry, max_limit: int,
                  explain: bool = False) -> sim.SolveResult:
    """A group template's result from its placements and terminal carry, in
    the batched path's words; `consts_fn()` gives the template's consts for
    the diagnosis and the why-not."""
    if max_limit and max_limit > 0:
        placements = placements[:max_limit]
    placed = len(placements)
    expl = _explain_terminal(pb, cfg, consts_fn(), carry) if explain \
        else None
    if max_limit and placed >= max_limit:
        return sim.SolveResult(
            placements=placements, placed_count=placed,
            fail_type=sim.FAIL_LIMIT_REACHED,
            fail_message=f"Maximum number of pods simulated: {max_limit}",
            node_names=pb.snapshot.node_names, explain=expl)
    if bool(carry.stopped):
        counts = sim.diagnose(pb, cfg, consts_fn(), carry)
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


def _add_curable_reasons():
    """pod-ADD QueueingHints analog: failure classes a new pod can cure.
    Shared by the object queue loop and the tensor interleave engine."""
    from ..ops import inter_pod_affinity as ipa_ops
    from ..ops import node_ports as ports_ops
    from ..ops import pod_topology_spread as spread_ops
    return {ipa_ops.REASON_AFFINITY, ipa_ops.REASON_ANTI_AFFINITY,
            ipa_ops.REASON_EXISTING_ANTI, spread_ops.REASON_CONSTRAINTS,
            spread_ops.REASON_MISSING_LABEL, ports_ops.REASON}


def sweep_interleaved(snapshot: ClusterSnapshot, templates: Sequence[dict],
                      profile: Optional[SchedulerProfile] = None,
                      max_total: int = 0) -> List[sim.SolveResult]:
    """Heterogeneous templates racing through ONE shared cluster state, the
    way the reference's scheduling queue would run them.

    Queue semantics (backend/queue/scheduling_queue.go + PrioritySort,
    priority_sort.go): the activeQ pops the highest-priority pod first,
    FIFO within a priority — and because each binding enqueues the
    template's NEXT clone at the tail, equal-priority templates interleave
    round-robin (A0, B0, A1, B1, ...), each placement consuming shared
    capacity.  A template whose clone goes Unschedulable leaves the queue.

    Feature parity with single-template runs (framework.py:129-232):
    extender Filter/Prioritize/Bind run per cycle (filter after the
    sampling window, schedule_one.go:482-565 order), and an Unschedulable
    clone triggers the DefaultPreemption PostFilter (preemption.go:234) —
    victims (initial pods OR lower-priority clones placed by other
    templates) are evicted from the shared state and the preemptor retries
    at the front of its priority tier (approximating the reference's
    nominatedNodeName reservation, schedule_one.go:209: the freed capacity
    is not stolen by an equal-priority peer).  Evictions rebuild the
    working snapshot (volume verdicts included) and are pod-DELETE events:
    every parked template re-enters the queue
    (scheduling_queue.go:177-193).  Placements are pod-ADD events: parked
    templates whose failure was affinity/spread/ports-shaped re-enter too
    (the QueueingHints analog — those are the reasons a new pod can cure).
    Already-bound clones stay in their template's report even when later
    preempted, matching the reference's bind-time accounting (postBindHook
    appends and never removes, simulator.go:297-312).

    This is inherently per-pod sequential (every placement changes every
    other template's world), so it runs on the object-level oracle
    machinery — the parity path for multi-template queue studies."""
    import heapq

    from ..engine import oracle
    from ..engine.extenders import (REASON_EXTENDER_FILTER, make_node_ok,
                                    run_bind, run_filter_chain,
                                    run_prioritize_chain)
    from ..engine.preemption import (evaluate as preempt_evaluate,
                                     format_preemption_message,
                                     resolve_priority, victim_matcher)
    from ..models import podspec as ps
    from ..ops import volumes as vol_ops

    from ..models import snapshot as snapshot_mod

    profile = profile or SchedulerProfile()
    n = snapshot.num_nodes
    snap_cur = snapshot
    state = oracle.OracleState(snapshot)
    extenders = list(profile.extenders or [])
    preempt_on = "DefaultPreemption" in profile.post_filters
    node_objs = {nm: o for nm, o in zip(snapshot.node_names, snapshot.nodes)}

    results: List[Optional[sim.SolveResult]] = [None] * len(templates)
    placements: List[List[int]] = [[] for _ in templates]
    verdicts = [vol_ops.evaluate(snapshot, t, profile.filter_enabled)
                for t in templates]
    placed_per_node = [[0] * n for _ in templates]
    live_clones = [0] * len(templates)      # bound minus evicted
    clone_owner: Dict[int, int] = {}        # id(clone) -> ti
    parked: Dict[int, set] = {}             # ti -> fail-reason keys at park
    # Safety valve for pathological preempt/requeue cycles between priority
    # tiers (the reference can't hit this: it never runs multiple templates)
    preempt_budget = 10 * len(templates) + 100

    _ADD_CURABLE = _add_curable_reasons()

    heap: List[tuple] = []
    seq = 0
    for ti, t in enumerate(templates):
        heapq.heappush(heap, (-resolve_priority(
            t, snapshot.priority_classes), seq, ti))
        seq += 1

    def node_reason(ti: int, i: int) -> Optional[str]:
        t = templates[ti]
        r = oracle._filter_node(state, i, t, profile)
        if r is not None:
            return r
        v = verdicts[ti]
        if ps.pod_host_ports(t) and profile.filter_enabled("NodePorts") \
                and placed_per_node[ti][i] > 0:
            return ("node(s) didn't have free ports for the requested "
                    "pod ports")
        if not v.mask[i]:
            return v.reasons[i]
        if v.self_disk_conflict and placed_per_node[ti][i] > 0:
            return vol_ops.REASON_DISK_CONFLICT
        if v.rwop_self_conflict and live_clones[ti] > 0:
            return vol_ops.REASON_RWOP_CONFLICT
        return None

    def requeue(tis) -> None:
        nonlocal seq
        for tj in sorted(tis):
            if tj in parked:
                del parked[tj]
                results[tj] = None
                heapq.heappush(heap, (-resolve_priority(
                    templates[tj], snapshot.priority_classes), seq, tj))
                seq += 1

    def rebuild_after_eviction(changed) -> None:
        """Evictions invalidate everything derived from the pod set: the
        working snapshot, the per-template volume verdicts, and the oracle
        state.  framework._solve_with_preemption re-snapshots the same way
        (with_pods_by_node incremental, full rebuild fallback)."""
        nonlocal snap_cur, state, verdicts
        new_pbn = state.pods_by_node
        next_snap = snapshot_mod.with_pods_by_node(snap_cur, new_pbn,
                                                   sorted(changed))
        if next_snap is None:
            # keep the existing node-axis order: sort_nodes would re-sort by
            # name and desynchronize every index-based bookkeeping structure
            next_snap = ClusterSnapshot.from_objects(
                snap_cur.nodes, [p for plist in new_pbn for p in plist],
                sort_nodes=False, use_native=False,
                **{k: getattr(snap_cur, k)
                   for k in snapshot_mod.OBJECT_FIELDS})
        snap_cur = next_snap
        state = oracle.OracleState(snap_cur)
        # from_objects dict-copies pods; restore the ORIGINAL clone dicts so
        # clone_owner identity lookups survive any number of rebuilds
        state.pods_by_node = [list(p) for p in new_pbn]
        verdicts = [vol_ops.evaluate(snap_cur, t, profile.filter_enabled)
                    for t in templates]

    # deterministic sampling state per template (numFeasibleNodesToFind —
    # the queue parity path must sample exactly like single-template runs)
    from ..engine.simulator import _num_feasible_nodes_to_find
    sample_k = _num_feasible_nodes_to_find(profile, n)
    next_start = [0] * len(templates)

    total = 0
    front_seq = 0          # decreasing: pops before every same-priority peer
    while heap and (not max_total or total < max_total):
        _prio, _s, ti = heapq.heappop(heap)
        t = templates[ti]
        if (t.get("spec") or {}).get("schedulingGates"):
            # PreEnqueue: gated pods never enter a cycle (sim.solve parity)
            reason = enc.REASON_SCHEDULING_GATED
            results[ti] = sim.SolveResult(
                placements=[], placed_count=0,
                fail_type="SchedulingGated",
                fail_message=f"0/{n} nodes are available: {reason}.",
                fail_counts={reason: n},
                node_names=snapshot.node_names)
            continue
        if verdicts[ti].pod_level_reason:
            results[ti] = sim.SolveResult(
                placements=[], placed_count=0,
                fail_type=sim.FAIL_UNSCHEDULABLE,
                fail_message=f"0/{n} nodes are available: "
                             f"{verdicts[ti].pod_level_reason}.",
                fail_counts={verdicts[ti].pod_level_reason: n},
                node_names=snapshot.node_names)
            continue
        feasible = [i for i in range(n) if node_reason(ti, i) is None]
        scorable: List[int] = []
        ext_rejected = 0
        if feasible:
            scorable, next_start[ti] = oracle.sample_window(
                feasible, n, sample_k, next_start[ti])
            if extenders:
                # extender Filter chain on the SAMPLED window, after the
                # in-tree filters (findNodesThatFitPod order,
                # schedule_one.go:482-565: sample first, extenders second)
                surviving = set(run_filter_chain(
                    extenders, t,
                    [snapshot.node_names[i] for i in scorable], node_objs))
                ext_rejected = sum(1 for i in scorable
                                   if snapshot.node_names[i] not in surviving)
                scorable = [i for i in scorable
                            if snapshot.node_names[i] in surviving]
        if not scorable:
            # DefaultPreemption PostFilter (framework.py:160-221 analog):
            # victims come from the SHARED state — initial pods or other
            # templates' lower-priority clones.
            pre_msg = None
            if preempt_on and preempt_budget > 0:
                outcome = preempt_evaluate(
                    snap_cur, state.pods_by_node, t, profile,
                    node_ok=make_node_ok(extenders, t, snapshot.node_names,
                                         snapshot.nodes),
                    extenders=extenders)
                if outcome.succeeded and outcome.victims:
                    # the valve counts EVICTIONS (the only way a preempt/
                    # requeue cycle can spin); failed evaluations just park
                    preempt_budget -= 1
                    is_victim = victim_matcher(outcome.victims)
                    changed = set()
                    for i in range(n):
                        kept = []
                        for p in state.pods_by_node[i]:
                            if is_victim(p):
                                owner = clone_owner.pop(id(p), None)
                                if owner is not None:
                                    placed_per_node[owner][i] -= 1
                                    live_clones[owner] -= 1
                                changed.add(i)
                            else:
                                kept.append(p)
                        if len(kept) != len(state.pods_by_node[i]):
                            state.set_pods(i, kept)
                    rebuild_after_eviction(changed)
                    # pod-delete events reactivate every parked template
                    # (scheduling_queue.go:177-193)
                    requeue(list(parked))
                    # the preemptor retries FIRST within its tier: the
                    # nominatedNodeName reservation analog — its freed
                    # capacity must not be stolen by an equal-priority peer
                    front_seq -= 1
                    heapq.heappush(heap, (_prio, front_seq, ti))
                    next_start[ti] = 0   # fresh cycle, framework parity
                    continue
                if profile.include_preemption_message and \
                        outcome.message_counts:
                    pre_msg = format_preemption_message(
                        n, outcome.message_counts)
            reasons: Dict[str, int] = {}
            if ext_rejected:
                # every in-tree-feasible node went unused only because the
                # extender chain emptied the sampled window — attribute the
                # whole feasible set so counts sum to n (same bucket as
                # solve_with_extenders)
                reasons[REASON_EXTENDER_FILTER] = len(feasible)
            for i in range(n):
                r = node_reason(ti, i)
                if r and (r.startswith("Insufficient")
                          or r == "Too many pods"):
                    for fr in oracle._fit_reasons(state, i, t):
                        reasons[fr] = reasons.get(fr, 0) + 1
                elif r:
                    reasons[r] = reasons.get(r, 0) + 1
            msg = sim.format_fit_error(n, reasons)
            if pre_msg:
                msg += " " + pre_msg
            results[ti] = sim.SolveResult(
                placements=placements[ti],
                placed_count=len(placements[ti]),
                fail_type=sim.FAIL_UNSCHEDULABLE,
                fail_message=msg,
                fail_counts=reasons, node_names=snapshot.node_names)
            parked[ti] = set(reasons)
            continue
        totals = oracle._score_nodes(state, scorable, t, profile)
        if extenders:
            bonus = run_prioritize_chain(
                extenders, t, [snapshot.node_names[i] for i in scorable])
            for i in scorable:
                totals[i] += bonus[snapshot.node_names[i]]
        best = max(scorable, key=lambda i: (totals[i], -i))
        clone = ps.make_clone(t, len(placements[ti]))
        clone["spec"]["nodeName"] = snapshot.node_names[best]
        run_bind(extenders, clone, snapshot.node_names[best])
        placements[ti].append(best)
        placed_per_node[ti][best] += 1
        live_clones[ti] += 1
        state.add_pod(best, clone)
        clone_owner[id(clone)] = ti
        total += 1
        # pod-ADD event: requeue parked templates whose failure a new pod
        # can cure (affinity/spread/ports — the QueueingHints analog)
        requeue([tj for tj, rs in parked.items() if rs & _ADD_CURABLE])
        heapq.heappush(heap, (_prio, seq, ti))    # next clone to the tail
        seq += 1

    for ti in range(len(templates)):
        if results[ti] is None:                    # stopped by max_total
            results[ti] = sim.SolveResult(
                placements=placements[ti],
                placed_count=len(placements[ti]),
                fail_type=sim.FAIL_LIMIT_REACHED,
                fail_message=f"Maximum number of pods simulated: {max_total}",
                node_names=snapshot.node_names)
    return results


"""The greedy placement engine, driven through the fused CUDA kernel.

This replaces the reference's event pipeline — scheduling queue, watch
channels, binder plugin, assume/confirm cache (simulator.go:356-431 +
schedule_one.go:66-364) — with one batched solve: the carry is the cluster's
mutable state (requested resources, topology-domain counts), each step
computes every filter mask and the weighted score pipeline over the whole
node axis, picks the argmax host (lowest index wins ties, the deterministic
replacement for selectHost's reservoir sampling, schedule_one.go:894-946)
and commits the placement.

Every step runs inside engine/fused.py's kernel, in chunks of _FUSED_CHUNK
steps; windows of chunks are issued without a host sync and collected one
sync per window.  Nothing stands in for the kernel on the card: a build,
launch or shape error raises.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from . import encode as enc
from ..ops import inter_pod_affinity as ipa_ops
from ..ops import node_resources_fit as fit_ops
from ..ops import pod_topology_spread as spread_ops
from ..ops.volumes import REASON_DISK_CONFLICT, REASON_RWOP_CONFLICT

FAIL_LIMIT_REACHED = "LimitReached"
FAIL_UNSCHEDULABLE = "Unschedulable"

_DEFAULT_UNLIMITED_CAP = 1_000_000
# Steps per kernel launch, most chained launches per host sync, and windows
# kept in flight ahead of the one being collected.
_FUSED_CHUNK = 4096
_FUSED_PIPELINE = 16
_FUSED_INFLIGHT = 2

# Reason string of the DRA self-conflict gate (the JAX package's
# ops/dynamic_resources.py).
REASON_CANNOT_ALLOCATE = "cannot allocate all claims"
DRA_RESOURCE_PREFIX = "dra/"


class StaticConfig(NamedTuple):
    """Everything the step specializes on (the JAX package's StaticConfig,
    without the XLA scan's soft-spread one-hot switch)."""

    dtype64: bool
    deterministic: bool
    fit_filter_on: bool
    clone_has_ports: bool
    volume_filter_on: bool
    volume_self_conflict: bool
    rwop_self_conflict: bool
    dra_shared_colocate: bool
    spread_hard_n: int
    spread_soft_n: int
    ipa_filter_on: bool
    ipa_num_aff: int
    ipa_num_anti: int
    ipa_num_pref: int
    ipa_escape_allowed: bool
    ipa_score_active: bool
    na_active: bool
    weights: Tuple[Tuple[str, int], ...]
    fit_strategy_type: str
    fit_shape: Tuple[Tuple[float, ...], Tuple[float, ...]]
    fit_idx: Tuple[int, ...]
    fit_nz: Tuple[bool, ...]
    bal_idx: Tuple[int, ...]
    ipa_static_empty: bool
    sample_k: int


def _num_feasible_nodes_to_find(profile, num_all: int) -> int:
    """numFeasibleNodesToFind (schedule_one.go:697-725): 0 means score-all."""
    pct = profile.percentage_of_nodes_to_score
    if pct >= 100 and not profile.adaptive_sampling:
        return 0
    if num_all < 100:                     # minFeasibleNodesToFind
        return 0
    if profile.adaptive_sampling and pct >= 100:
        pct = max(5, 50 - num_all // 125)
    num = num_all * pct // 100
    if num < 100:
        return 100
    return num


def static_config(pb: enc.EncodedProblem) -> StaticConfig:
    profile = pb.profile
    ipa = pb.ipa
    return StaticConfig(
        dtype64=(profile.compute_dtype == "float64"),
        deterministic=profile.deterministic,
        fit_filter_on=profile.filter_enabled("NodeResourcesFit"),
        clone_has_ports=pb.clone_has_host_ports,
        volume_filter_on=bool(not pb.volume_mask.all()),
        volume_self_conflict=pb.volume_self_conflict,
        rwop_self_conflict=pb.rwop_self_conflict,
        dra_shared_colocate=pb.dra_shared_colocate,
        spread_hard_n=pb.spread_hard.num_constraints,
        spread_soft_n=pb.spread_soft.num_constraints,
        ipa_filter_on=profile.filter_enabled("InterPodAffinity") and (
            ipa.num_aff_terms > 0 or ipa.num_anti_terms > 0 or
            bool(ipa.existing_anti_static.any())),
        ipa_num_aff=ipa.num_aff_terms,
        ipa_num_anti=ipa.num_anti_terms,
        ipa_num_pref=ipa.num_pref_terms,
        ipa_escape_allowed=ipa.escape_allowed,
        ipa_score_active=ipa.has_any_score_terms,
        na_active=pb.node_affinity_active,
        weights=tuple(sorted(profile.score_weights.items())),
        fit_strategy_type=profile.fit_strategy.type,
        fit_shape=(tuple(profile.fit_strategy.shape_utilization),
                   tuple(profile.fit_strategy.shape_score)),
        fit_idx=tuple(int(j) for j in pb.fit_res_idx),
        fit_nz=tuple(bool(b) for b in pb.fit_uses_nonzero),
        bal_idx=tuple(int(j) for j in pb.balanced_res_idx),
        ipa_static_empty=bool(ipa.aff_init.sum() == 0),
        sample_k=_num_feasible_nodes_to_find(profile, pb.num_alive),
    )


class Carry(NamedTuple):
    """The cluster's mutable state, as dense per-node tensors."""

    requested: torch.Tensor         # f32[N, R]
    nonzero: torch.Tensor           # f32[N, 2]
    placed: torch.Tensor            # i32[N]
    sh_cnt: torch.Tensor            # f32[Ch, N] — hard-spread match counts
    ss_cnt: torch.Tensor            # f32[Cs, N] — soft-spread match counts
    aff_cnt: torch.Tensor           # f32[G, N] — dynamic affinity counts
    anti_cnt: torch.Tensor          # f32[G, N] — dynamic anti-affinity counts
    pref_cnt: torch.Tensor          # f32[G, N] — dynamic preferred weights
    aff_total: torch.Tensor         # f32[] — total dynamic affinity count
    placed_count: torch.Tensor      # i32[]
    stopped: torch.Tensor           # bool[]
    next_start: torch.Tensor        # i32[] — rotating sample start index


@dataclass
class SolveResult:
    placements: List[int]                    # node index per placed pod, in order
    placed_count: int
    fail_type: str
    fail_message: str
    fail_counts: Dict[str, int] = field(default_factory=dict)
    node_names: List[str] = field(default_factory=list)
    # which rung served the result and whether a fault was recovered from
    # (the JAX package's degradation-ladder stamp, runtime/degrade.py)
    rung: str = ""
    degraded: bool = False

    @property
    def per_node_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for i in self.placements:
            name = self.node_names[i]
            out[name] = out.get(name, 0) + 1
        return out


def resolve_device(device=None) -> torch.device:
    """The device a solve runs on: the card unless the caller names the
    CPU.  Asking for the card without one raises; nothing falls back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch version on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _weight(cfg: StaticConfig, name: str) -> int:
    for k, v in cfg.weights:
        if k == name:
            return v
    return 0


def _expand_counts(init_counts: np.ndarray, node_domain: np.ndarray) -> np.ndarray:
    """counts[c, dom[c, n]] per node (0 where the key is absent)."""
    if not init_counts.any():
        return np.zeros(node_domain.shape, dtype=init_counts.dtype)
    safe = np.clip(node_domain, 0, init_counts.shape[1] - 1)
    out = np.take_along_axis(init_counts, safe, axis=1)
    return np.where(node_domain >= 0, out, 0.0)


def host_consts(pb: enc.EncodedProblem) -> Dict[str, np.ndarray]:
    """The static arrays of one problem as host numpy arrays in the engine's
    dtypes (floats float32, masks bool, domain ids int32)."""
    f = lambda a: np.asarray(a, dtype=np.float32)
    b = lambda a: np.asarray(a, dtype=bool)
    i = lambda a: np.asarray(a, dtype=np.int32)
    sh, ss, ipa = pb.spread_hard, pb.spread_soft, pb.ipa
    ghas_aff, ghas_anti, _aff_ginc, _anti_ginc, _pref_gw = \
        ipa_ops.group_fold(ipa)
    return {
        "allocatable": f(pb.allocatable),
        "req_vec": f(pb.req_vec),
        "shared_req_vec": f(pb.shared_req_vec),
        "req_nonzero": f(pb.req_nonzero),
        "static_mask": b(pb.static_mask),
        "taint_raw": f(pb.taint_raw),
        "na_raw": f(pb.node_affinity_raw),
        "il_score": f(pb.image_locality_score),
        "volume_mask": b(pb.volume_mask),
        "sh_dom": i(sh.node_domain),
        "sh_countable": b(sh.node_countable),
        "sh_skew": f(sh.max_skew),
        "sh_mindom": f(sh.min_domains),
        "sh_domnum": f(sh.domain_valid.sum(axis=1)),
        "sh_self": b(sh.self_match),
        "sh_missing": b(~sh.node_has_all_keys),
        "sh_cnt_init": f(_expand_counts(sh.init_counts, sh.node_domain)),
        "ss_dom": i(ss.node_domain),
        "ss_countable": b(ss.node_countable),
        "ss_node_existing": f(ss.node_existing),
        "ss_ignored": b(pb.spread_ignored),
        "ss_cnt_init": f(_expand_counts(ss.init_counts, ss.node_domain)),
        "ipa_dom": i(ipa.node_domain),
        "ipa_ghas_aff": b(ghas_aff),
        "ipa_ghas_anti": b(ghas_anti),
        "ipa_aff_scnt": f(_expand_counts(ipa.aff_init, ipa.node_domain)),
        "ipa_anti_scnt": f(_expand_counts(ipa.anti_init, ipa.node_domain)),
        "ipa_eanti_static": b(ipa.existing_anti_static),
        "ipa_static_pref": f(ipa.static_pref_score),
    }


def build_consts(pb: enc.EncodedProblem,
                 device="cpu") -> Dict[str, torch.Tensor]:
    """Move the static arrays to `device` once, floats as float32."""
    dev = torch.device(device)
    return {k: torch.tensor(v, device=dev)
            for k, v in host_consts(pb).items()}


def _init_carry(pb: enc.EncodedProblem,
                consts: Dict[str, torch.Tensor]) -> Carry:
    dev = consts["allocatable"].device
    f32 = torch.float32
    n = pb.snapshot.num_nodes
    g = pb.ipa.node_domain.shape[0]
    zeros = lambda *shape: torch.zeros(shape, dtype=f32, device=dev)
    return Carry(
        requested=torch.tensor(np.asarray(pb.init_requested, np.float32),
                               device=dev),
        nonzero=torch.tensor(np.asarray(pb.init_nonzero, np.float32),
                             device=dev),
        placed=torch.zeros(n, dtype=torch.int32, device=dev),
        sh_cnt=consts["sh_cnt_init"],
        ss_cnt=consts["ss_cnt_init"],
        aff_cnt=zeros(g, n), anti_cnt=zeros(g, n), pref_cnt=zeros(g, n),
        aff_total=zeros(),
        placed_count=torch.zeros((), dtype=torch.int32, device=dev),
        stopped=torch.zeros((), dtype=torch.bool, device=dev),
        next_start=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _feasibility(cfg: StaticConfig, consts, carry: Carry):
    """All filter masks for the current state: (feasible, parts for
    diagnosis).  Used once per solve, by diagnose, at the stopping state."""
    feasible = consts["static_mask"]
    parts = {}
    if cfg.fit_filter_on:
        req_vec = consts["req_vec"]
        if cfg.dra_shared_colocate and int(carry.placed_count) == 0:
            req_vec = req_vec + consts["shared_req_vec"]
        fitv = fit_ops.fit_filter(consts["allocatable"], carry.requested,
                                  req_vec)
        parts["fit"] = fitv
        feasible = feasible & fitv.mask
    if cfg.clone_has_ports:
        ports_ok = ~(carry.placed > 0)
        parts["ports_dyn"] = ports_ok
        feasible = feasible & ports_ok
    if cfg.volume_filter_on:
        feasible = feasible & consts["volume_mask"]
    if cfg.volume_self_conflict:
        feasible = feasible & ~(carry.placed > 0)
    if cfg.rwop_self_conflict and int(carry.placed_count) != 0:
        feasible = feasible & False
    if cfg.dra_shared_colocate and int(carry.placed_count) != 0:
        feasible = feasible & (carry.placed > 0)
    if cfg.spread_hard_n > 0:
        sp_ok, sp_missing = spread_ops.hard_filter(
            carry.sh_cnt, consts["sh_dom"], consts["sh_countable"],
            consts["sh_skew"], consts["sh_mindom"], consts["sh_domnum"],
            consts["sh_self"], consts["sh_missing"])
        parts["spread_ok"] = sp_ok
        parts["spread_missing"] = sp_missing
        feasible = feasible & sp_ok
    if cfg.ipa_filter_on:
        map_empty = cfg.ipa_static_empty and float(carry.aff_total) == 0.0
        ok, f_aff, f_anti, f_eanti = ipa_ops.filter_all(
            consts["ipa_aff_scnt"] + carry.aff_cnt,
            consts["ipa_anti_scnt"] + carry.anti_cnt,
            carry.anti_cnt, consts["ipa_dom"],
            consts["ipa_ghas_aff"], consts["ipa_ghas_anti"],
            cfg.ipa_num_aff, cfg.ipa_num_anti, map_empty,
            cfg.ipa_escape_allowed, consts["ipa_eanti_static"])
        parts["ipa"] = (f_aff, f_anti, f_eanti)
        feasible = feasible & ok
    return feasible, parts


def solve(pb: enc.EncodedProblem, max_limit: int = 0,
          device=None) -> SolveResult:
    """Run the greedy placement loop to completion on `device` (default the
    card).  The step budget is min(max_limit, max_steps_hint + 1); kernel
    chunks always run at full length (steps after the stop change nothing)
    and placements are trimmed to the budget afterwards."""
    from . import fused

    dev = resolve_device(device)
    if pb.snapshot.num_nodes == 0:
        return SolveResult(placements=[], placed_count=0,
                           fail_type=FAIL_UNSCHEDULABLE,
                           fail_message="0/0 nodes are available",
                           node_names=[])
    if pb.pod_level_reason:
        # PreEnqueue/PreFilter pod-level rejection (types.go:788-793)
        n = pb.snapshot.num_nodes
        return SolveResult(
            placements=[], placed_count=0,
            fail_type=pb.pod_level_fail_type,
            fail_message=f"0/{n} nodes are available: {pb.pod_level_reason}.",
            fail_counts={pb.pod_level_reason: n},
            node_names=pb.snapshot.node_names)

    cfg = static_config(pb)
    fused.check_eligible(cfg, pb)
    consts = build_consts(pb, dev)
    carry = _init_carry(pb, consts)

    budget = pb.max_steps_hint + 1
    if max_limit and max_limit > 0:
        budget = min(max_limit, budget)
    budget = max(1, min(budget, _DEFAULT_UNLIMITED_CAP))
    chunk = min(_FUSED_CHUNK, budget)

    pk = fused._pack_meta(cfg, pb)
    const = fused._pack_consts(pk, consts)
    table = fused.kernel_table(pk, dev)
    planes, scalars = fused._pack_carry(pk, carry)

    # Windows of chained launches, doubling up to _FUSED_PIPELINE chunks,
    # with _FUSED_INFLIGHT windows issued ahead of the one being collected:
    # the host syncs once per window while the card runs the next one.
    placements: List[int] = []
    stopped = False
    inflight: deque = deque()
    issued = 0
    depth = 1
    last = (planes, scalars)
    while True:
        while issued < budget and not stopped \
                and len(inflight) < _FUSED_INFLIGHT:
            w = min(depth, -(-(budget - issued) // chunk))
            chunks = []
            for _ in range(w):
                planes, scalars, chosen = fused.fused_steps(
                    const, planes, scalars, table, chunk)
                chunks.append(chosen)
            inflight.append(((planes, scalars), chunks))
            issued += w * chunk
            depth = min(depth * 2, _FUSED_PIPELINE)
        if not inflight:
            break
        last, chunks = inflight.popleft()
        chosen = torch.cat(chunks).reshape(-1).cpu().numpy()
        stopped = bool(round(float(last[1][0, 1])))
        placements.extend(chosen[chosen >= 0].tolist())
    carry = fused._unpack_carry(pk, last[0], last[1], carry)

    placements = placements[:budget]
    placed = len(placements)
    stopped = bool(carry.stopped)
    if max_limit and placed >= max_limit:
        # postBindHook limit semantics (simulator.go:297-312)
        return SolveResult(placements=placements, placed_count=placed,
                           fail_type=FAIL_LIMIT_REACHED,
                           fail_message=f"Maximum number of pods simulated: {max_limit}",
                           node_names=pb.snapshot.node_names)
    if stopped:
        counts = diagnose(pb, cfg, consts, carry)
        msg = format_fit_error(pb.snapshot.num_nodes, counts)
        return SolveResult(placements=placements, placed_count=placed,
                           fail_type=FAIL_UNSCHEDULABLE, fail_message=msg,
                           fail_counts=counts,
                           node_names=pb.snapshot.node_names)
    # Internal step budget exhausted without a user limit (only reachable
    # when the fit filter is disabled, so the hint bound is not binding).
    return SolveResult(placements=placements, placed_count=placed,
                       fail_type=FAIL_LIMIT_REACHED,
                       fail_message=(f"Simulation step budget exhausted after "
                                     f"{placed} placements; set max_limit to "
                                     f"bound unlimited profiles"),
                       node_names=pb.snapshot.node_names)


def diagnose(pb: enc.EncodedProblem, cfg: StaticConfig, consts,
             carry: Carry) -> Dict[str, int]:
    """Per-reason node counts at the stopping state — the FitError reasons
    histogram (types.go:787-828).  Each infeasible node contributes the
    reason(s) of its first failing plugin in filter order; the fit plugin
    contributes every insufficient resource (fit.go:564-660)."""
    _feasible, parts = _feasibility(cfg, consts, carry)
    n = pb.snapshot.num_nodes
    host = lambda t: t.cpu().numpy()
    static_code = np.asarray(pb.static_code)

    fit = parts.get("fit")
    fit_fail = ~host(fit.mask) if fit is not None else np.zeros(n, bool)
    insufficient = host(fit.insufficient) if fit is not None else None
    too_many = host(fit.too_many_pods) if fit is not None else None
    ports_dyn_fail = ~host(parts["ports_dyn"]) if "ports_dyn" in parts \
        else np.zeros(n, bool)
    spread_ok = host(parts["spread_ok"]) if "spread_ok" in parts \
        else np.ones(n, bool)
    spread_missing = host(parts["spread_missing"]) \
        if "spread_missing" in parts else np.zeros(n, bool)
    if "ipa" in parts:
        f_aff, f_anti, f_eanti = (host(x) for x in parts["ipa"])
    else:
        f_aff = f_anti = f_eanti = np.zeros(n, bool)
    placed_np = host(carry.placed)
    placed_count = int(carry.placed_count)

    counts: Dict[str, int] = {}

    def add(reason: str, k: int = 1):
        if k:
            counts[reason] = counts.get(reason, 0) + int(k)

    remaining = np.ones(n, dtype=bool)
    static_fail = static_code != enc.CODE_OK
    for code in np.unique(static_code[static_fail]):
        idxs = np.flatnonzero(static_code == code)
        if int(code) == enc.CODE_TAINT:
            for i in idxs:
                add(pb.taint_reasons[i] or "node(s) had untolerated taint")
        else:
            add(enc.STATIC_REASONS[int(code)], len(idxs))
    remaining &= ~static_fail

    take = remaining & ports_dyn_fail
    add(enc.STATIC_REASONS[enc.CODE_PORTS], int(take.sum()))
    remaining &= ~take

    take = remaining & fit_fail
    if take.any():
        if too_many is not None:
            add("Too many pods", int((take & too_many).sum()))
        if insufficient is not None:
            dra_cols = [j for j, rn in enumerate(pb.resource_names)
                        if rn.startswith(DRA_RESOURCE_PREFIX)]
            for j, rname in enumerate(pb.resource_names):
                if j in dra_cols:
                    continue
                add(f"Insufficient {rname}",
                    int((take & insufficient[:, j]).sum()))
            if dra_cols:
                dra_any = np.logical_or.reduce(
                    [insufficient[:, j] for j in dra_cols])
                add(REASON_CANNOT_ALLOCATE, int((take & dra_any).sum()))
    remaining &= ~take

    take = remaining & ~np.asarray(pb.volume_mask)
    for i in np.flatnonzero(take):
        add(pb.volume_reasons[i] or "volume conflict")
    remaining &= ~take

    if cfg.volume_self_conflict:
        take = remaining & (placed_np > 0)
        add(REASON_DISK_CONFLICT, int(take.sum()))
        remaining &= ~take
    if cfg.rwop_self_conflict and placed_count > 0:
        add(REASON_RWOP_CONFLICT, int(remaining.sum()))
        remaining &= False
    if cfg.dra_shared_colocate and placed_count > 0:
        take = remaining & ~(placed_np > 0)
        add(REASON_CANNOT_ALLOCATE, int(take.sum()))
        remaining &= ~take

    take = remaining & spread_missing
    add(enc.STATIC_REASONS[enc.CODE_SPREAD_MISSING_LABEL], int(take.sum()))
    remaining &= ~take
    take = remaining & ~spread_ok
    add(enc.STATIC_REASONS[enc.CODE_SPREAD], int(take.sum()))
    remaining &= ~take

    for mask, code in ((f_aff, enc.CODE_IPA_AFFINITY),
                       (f_anti, enc.CODE_IPA_ANTI),
                       (f_eanti, enc.CODE_IPA_EXISTING_ANTI)):
        take = remaining & mask
        add(enc.STATIC_REASONS[code], int(take.sum()))
        remaining &= ~take
    return counts


def format_fit_error(num_nodes: int, counts: Dict[str, int]) -> str:
    """FitError.Error() (types.go:787-828): '0/N nodes are available: '
    + lexicographically-sorted '<count> <reason>' strings + '.'"""
    reason_strings = sorted(f"{v} {k}" for k, v in counts.items())
    msg = f"0/{num_nodes} nodes are available"
    if reason_strings:
        msg += ": " + ", ".join(reason_strings) + "."
    return msg

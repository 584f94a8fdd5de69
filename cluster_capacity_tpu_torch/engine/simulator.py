"""The greedy placement engine: the fused CUDA kernel, or the scan step.

This replaces the reference's event pipeline — scheduling queue, watch
channels, binder plugin, assume/confirm cache (simulator.go:356-431 +
schedule_one.go:66-364) — with one batched solve: the carry is the cluster's
mutable state (requested resources, topology-domain counts), each step
computes every filter mask and the weighted score pipeline over the whole
node axis, picks the argmax host (lowest index wins ties, the deterministic
replacement for selectHost's reservoir sampling, schedule_one.go:894-946;
or uniform among ties when profile.deterministic=False) and commits the
placement.

`solve` routes as the JAX package does, by a predicate checked before any
launch (engine/fused.py `eligible`):

- the problems kernel 1 takes (float32, deterministic, inside its shape
  envelope) run engine/fused.py's CUDA kernel in chunks of _FUSED_CHUNK
  steps; windows of chunks are issued without a host sync and collected
  one sync per window;
- every other problem — float64 parity, the random tie-break, a shape
  outside the envelope — runs `_step`, the JAX package's XLA scan step in
  plain PyTorch, op for op.  `run_chunk` runs K steps of it: eagerly on
  the CPU, and on the card as replays of CUDA graphs captured once per
  (StaticConfig, shapes, dtype), the counterpart of the jitted lax.scan.

Nothing stands in for the kernel or for the graph on the card: a build,
launch, capture or shape error raises.
"""

from __future__ import annotations

import functools
import math
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import encode as enc
from ..models.snapshot import IDX_CPU
from ..ops import inter_pod_affinity as ipa_ops
from ..ops import node_resources_fit as fit_ops
from ..ops import pod_topology_spread as spread_ops
from ..ops.dynamic_resources import (DRA_RESOURCE_PREFIX,
                                     REASON_CANNOT_ALLOCATE)
from ..ops.volumes import REASON_DISK_CONFLICT, REASON_RWOP_CONFLICT
from ..utils import prng

FAIL_LIMIT_REACHED = "LimitReached"
FAIL_UNSCHEDULABLE = "Unschedulable"

_DEFAULT_UNLIMITED_CAP = 1_000_000
# Steps per kernel launch, most chained launches per host sync, and windows
# kept in flight ahead of the one being collected.
_FUSED_CHUNK = 4096
_FUSED_PIPELINE = 16
_FUSED_INFLIGHT = 2
# The scan step's chunk length (the JAX package's solve default), the most
# steps one captured CUDA graph holds, and how many graphs stay cached.
_STEP_CHUNK = 1024
_GRAPH_STEPS = 64
_GRAPH_CACHE = 4


# The JAX package's soft-spread one-hot cap: above this many domains its
# XLA step counts distinct domains with a scatter instead of a one-hot
# matmul.  The step here always scatters; the flag stays in StaticConfig
# because the sweep's group key carries it, as the JAX package's does.
_ONEHOT_DOMAIN_CAP = 128


class StaticConfig(NamedTuple):
    """Everything the step specializes on (the JAX package's
    StaticConfig)."""

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
    ss_onehot_ok: bool
    sample_k: int


def _soft_nonhost_domains(ss) -> int:
    """Max domain cardinality across non-hostname soft constraints."""
    d_nh = 1
    for c in range(ss.num_constraints):
        if not ss.is_hostname[c] and (ss.node_domain[c] >= 0).any():
            d_nh = max(d_nh, int(ss.node_domain[c].max()) + 1)
    return d_nh


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
        ss_onehot_ok=_soft_nonhost_domains(pb.spread_soft)
        <= _ONEHOT_DOMAIN_CAP,
        sample_k=_num_feasible_nodes_to_find(profile, pb.num_alive),
    )


class Carry(NamedTuple):
    """The cluster's mutable state, as dense per-node tensors; f is the
    profile's dtype (float32, or float64 for parity)."""

    requested: torch.Tensor         # f[N, R]
    nonzero: torch.Tensor           # f[N, 2]
    placed: torch.Tensor            # i32[N]
    sh_cnt: torch.Tensor            # f[Ch, N] — hard-spread match counts
    ss_cnt: torch.Tensor            # f[Cs, N] — soft-spread match counts
    aff_cnt: torch.Tensor           # f[G, N] — dynamic affinity counts
    anti_cnt: torch.Tensor          # f[G, N] — dynamic anti-affinity counts
    pref_cnt: torch.Tensor          # f[G, N] — dynamic preferred weights
    aff_total: torch.Tensor         # f[] — total dynamic affinity count
    placed_count: torch.Tensor      # i32[]
    stopped: torch.Tensor           # bool[]
    next_start: torch.Tensor        # i32[] — rotating sample start index
    rng: torch.Tensor               # i64[2] — PRNG key (utils/prng.py)


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
    # attribution artifact (explain/artifacts.Explanation) when the solve ran
    # with explain=True; None otherwise
    explain: Optional[object] = None

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


def np_dtype(profile):
    """The numpy float dtype of a profile's arithmetic."""
    return np.float64 if profile.compute_dtype == "float64" else np.float32


def _dt(cfg: StaticConfig) -> torch.dtype:
    return torch.float64 if cfg.dtype64 else torch.float32


def host_consts(pb: enc.EncodedProblem) -> Dict[str, np.ndarray]:
    """The static arrays both engines read, as host numpy arrays in the
    engine's dtypes: floats in the profile's dtype, masks bool, domain ids
    int32."""
    dt = np_dtype(pb.profile)
    f = lambda a: np.asarray(a, dtype=dt)
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


@functools.lru_cache(maxsize=8)
def log_table64(n: int) -> np.ndarray:
    """log(size + 2) for size = 0..n in float64, from math.log (correctly
    rounded; CUDA's and the CPU vector libraries' log are not).  XLA's
    float64 log on the CPU, the JAX step's, equals it at every size up to
    70,000 (tests/test_torch_prng.py)."""
    out = np.array([math.log(k + 2) for k in range(n + 1)])
    out.flags.writeable = False
    return out


def _step_host_consts(pb: enc.EncodedProblem) -> Dict[str, np.ndarray]:
    """The static arrays only the scan step reads: the score strategies'
    request and weight vectors, the soft-spread rows, the per-group IPA
    increments and the log(size + 2) table."""
    dt = np_dtype(pb.profile)
    f = lambda a: np.asarray(a, dtype=dt)
    ss = pb.spread_soft
    _ghas_aff, _ghas_anti, aff_ginc, anti_ginc, pref_gw = \
        ipa_ops.group_fold(pb.ipa)
    slots, d = spread_ops.domain_slots(ss.node_domain, ss.is_hostname)
    n = pb.snapshot.num_nodes
    if dt is np.float64:
        log_tab = log_table64(n)
    else:
        from .fused import log_table
        log_tab = log_table(n)
    return {
        "fit_w": f(pb.fit_res_weights),
        "fit_req": f(pb.fit_req),
        "bal_req": f(pb.balanced_req),
        "ss_skew": f(ss.max_skew),
        "ss_self": np.asarray(ss.self_match, dtype=bool),
        "ss_host": np.asarray(ss.is_hostname, dtype=bool),
        "ss_slots": slots,
        "ss_present0": np.zeros((ss.node_domain.shape[0], d), np.int32),
        "ipa_aff_ginc": f(aff_ginc),
        "ipa_anti_ginc": f(anti_ginc),
        "ipa_pref_gw": f(pref_gw),
        "log_table": f(log_tab),
    }


def build_consts(pb: enc.EncodedProblem,
                 device="cpu") -> Dict[str, torch.Tensor]:
    """Move the static arrays of both engines to `device` once, floats in
    the profile's dtype."""
    dev = torch.device(device)
    arrays = {**host_consts(pb), **_step_host_consts(pb)}
    return {k: torch.tensor(v, device=dev) for k, v in arrays.items()}


def _init_carry(pb: enc.EncodedProblem,
                consts: Dict[str, torch.Tensor]) -> Carry:
    """The initial carry in the consts' float dtype, on their device; the
    PRNG key is PRNGKey(profile.seed)."""
    dev = consts["allocatable"].device
    dt = consts["allocatable"].dtype
    n = pb.snapshot.num_nodes
    g = pb.ipa.node_domain.shape[0]
    zeros = lambda *shape: torch.zeros(shape, dtype=dt, device=dev)
    return Carry(
        requested=torch.tensor(np.asarray(pb.init_requested),
                               dtype=dt, device=dev),
        nonzero=torch.tensor(np.asarray(pb.init_nonzero), dtype=dt,
                             device=dev),
        placed=torch.zeros(n, dtype=torch.int32, device=dev),
        sh_cnt=consts["sh_cnt_init"],
        ss_cnt=consts["ss_cnt_init"],
        aff_cnt=zeros(g, n), anti_cnt=zeros(g, n), pref_cnt=zeros(g, n),
        aff_total=zeros(),
        placed_count=torch.zeros((), dtype=torch.int32, device=dev),
        stopped=torch.zeros((), dtype=torch.bool, device=dev),
        next_start=torch.zeros((), dtype=torch.int32, device=dev),
        rng=prng.prng_key(pb.profile.seed, device=dev),
    )


def _col(mat: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """mat[:, chosen] for a 0-d index tensor (no host sync)."""
    return mat.index_select(1, chosen.reshape(1))[:, 0]


def _row_add(arr: torch.Tensor, idx: torch.Tensor,
             delta: torch.Tensor) -> torch.Tensor:
    """arr[idx] += delta out of place, idx a 0-d index tensor; delta carries
    the leading singleton axis ([1, ...] / [1])."""
    return arr.index_add(0, idx.reshape(1), delta)


def _feasibility(cfg: StaticConfig, consts, carry: Carry):
    """All filter masks for the current state: (feasible, parts for
    diagnosis).  No host sync: the count-dependent gates are tensor
    selects."""
    feasible = consts["static_mask"]
    parts = {}
    if cfg.fit_filter_on:
        req_vec = consts["req_vec"]
        if cfg.dra_shared_colocate:
            # unallocated shared claim: its devices are requested only by
            # the first placement (the allocation)
            req_vec = req_vec + torch.where(carry.placed_count == 0,
                                            consts["shared_req_vec"], 0.0)
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
    if cfg.rwop_self_conflict:
        feasible = feasible & (carry.placed_count == 0)
    if cfg.dra_shared_colocate:
        # shared ResourceClaim: all users share one allocation -> colocate
        feasible = feasible & ((carry.placed > 0)
                               | (carry.placed_count == 0))
    if cfg.spread_hard_n > 0:
        sp_ok, sp_missing = spread_ops.hard_filter(
            carry.sh_cnt, consts["sh_dom"], consts["sh_countable"],
            consts["sh_skew"], consts["sh_mindom"], consts["sh_domnum"],
            consts["sh_self"], consts["sh_missing"])
        parts["spread_ok"] = sp_ok
        parts["spread_missing"] = sp_missing
        feasible = feasible & sp_ok
    if cfg.ipa_filter_on:
        map_empty = (carry.aff_total == 0) if cfg.ipa_static_empty else False
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


def _default_normalize(raw: torch.Tensor, feasible: torch.Tensor,
                       reverse: bool) -> torch.Tensor:
    """helper.DefaultNormalizeScore (normalize_score.go:28-56) over the
    feasible set: floor(100*s/max); reverse subtracts from 100; max==0 ->
    all 100 when reverse else untouched raws."""
    max_s = torch.where(feasible, raw, 0.0).max()
    scaled = torch.where(max_s > 0,
                         torch.floor(100.0 * raw
                                     / torch.where(max_s > 0, max_s, 1.0)),
                         raw)
    if reverse:
        scaled = torch.where(max_s > 0, 100.0 - scaled, 100.0)
    return torch.where(feasible, scaled, 0.0)


def _score_terms(cfg: StaticConfig, consts, carry: Carry, feasible):
    """Ordered (plugin name, already-weighted [N] term) pairs for the active
    score plugins; _decide sums them in this order."""
    dt = _dt(cfg)
    terms = []

    w = _weight(cfg, "NodeResourcesFit")
    if w:
        # cpu/mem use NonZeroRequested (resource_allocation.go:85-91)
        alloc = torch.stack([consts["allocatable"][:, j]
                             for j in cfg.fit_idx], dim=1)
        req = torch.stack(
            [carry.nonzero[:, 0 if j == IDX_CPU else 1] if nz
             else carry.requested[:, j]
             for j, nz in zip(cfg.fit_idx, cfg.fit_nz)], dim=1)
        req = req + consts["fit_req"][None, :]
        if cfg.fit_strategy_type == "MostAllocated":
            s = fit_ops.most_allocated_score(alloc, req, consts["fit_w"])
        elif cfg.fit_strategy_type == "RequestedToCapacityRatio":
            s = fit_ops.requested_to_capacity_ratio_score(
                alloc, req, consts["fit_w"], cfg.fit_shape[0],
                cfg.fit_shape[1])
        else:
            s = fit_ops.least_allocated_score(alloc, req, consts["fit_w"])
        terms.append(("NodeResourcesFit", w * torch.where(feasible, s, 0.0)))

    w = _weight(cfg, "NodeResourcesBalancedAllocation")
    if w:
        alloc = torch.stack([consts["allocatable"][:, j]
                             for j in cfg.bal_idx], dim=1)
        req = torch.stack([carry.requested[:, j] for j in cfg.bal_idx],
                          dim=1) + consts["bal_req"][None, :]
        s = fit_ops.balanced_allocation_score(alloc, req)
        terms.append(("NodeResourcesBalancedAllocation",
                      w * torch.where(feasible, s, 0.0)))

    w = _weight(cfg, "TaintToleration")
    if w:
        terms.append(("TaintToleration",
                      w * _default_normalize(consts["taint_raw"], feasible,
                                             reverse=True)))

    w = _weight(cfg, "NodeAffinity")
    if w and cfg.na_active:
        terms.append(("NodeAffinity",
                      w * _default_normalize(consts["na_raw"], feasible,
                                             reverse=False)))

    w = _weight(cfg, "ImageLocality")
    if w:
        terms.append(("ImageLocality",
                      w * torch.where(feasible, consts["il_score"], 0.0)))

    w = _weight(cfg, "PodTopologySpread")
    if w and cfg.spread_soft_n > 0:
        hostname_cnt = consts["ss_node_existing"] + torch.where(
            consts["ss_self"][:, None], carry.placed[None, :].to(dt), 0.0)
        raw, scored = spread_ops.soft_score(
            carry.ss_cnt, hostname_cnt, consts["ss_dom"], consts["ss_host"],
            consts["ss_skew"], consts["ss_slots"], consts["ss_present0"],
            consts["log_table"], consts["ss_ignored"], feasible)
        terms.append(("PodTopologySpread",
                      w * spread_ops.soft_normalize(raw, scored)))

    w = _weight(cfg, "InterPodAffinity")
    if w and cfg.ipa_score_active:
        raw = ipa_ops.pref_score(carry.pref_cnt, consts["ipa_dom"],
                                 consts["ipa_static_pref"], cfg.ipa_num_pref)
        terms.append(("InterPodAffinity",
                      w * ipa_ops.normalize(raw, feasible, True)))
    return terms


def _sample_scorable(cfg: StaticConfig, feasible: torch.Tensor,
                     next_start: torch.Tensor):
    """Deterministic emulation of findNodesThatPassFilters' truncation
    (schedule_one.go:610-694): the first K feasible nodes in round-robin
    order from the rotating start index, and the index advanced past the
    last node examined.  The rotation is a gather, the K-th feasible node's
    rank a prefix sum."""
    if cfg.sample_k <= 0:
        return feasible, next_start
    n = feasible.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=feasible.device)
    rank = torch.remainder(idx - next_start, n)
    rot = feasible[torch.remainder(idx + next_start, n).long()]
    # 0/1 values summed over n <= 2**31: the int32 prefix sum cannot
    # overflow
    csum = torch.cumsum(rot.to(torch.int32), 0, dtype=torch.int32)
    reached = csum >= min(cfg.sample_k, n)
    threshold = torch.where(reached.any(),
                            torch.argmax(reached.to(torch.int32))
                            .to(torch.int32), n - 1)
    scorable = feasible & (rank <= threshold)
    return scorable, torch.remainder(next_start + threshold + 1, n)


class Decision(NamedTuple):
    """One step's decision and what led to it (see _decide)."""
    carry: Carry           # after the commit and the stop update
    chosen: torch.Tensor   # i64[]: the argmax node
    place: torch.Tensor    # bool[]: whether this step placed at `chosen`
    parts: dict            # _feasibility's per-filter parts
    terms: list            # _score_terms' (plugin, weighted term) pairs


def _decide(cfg: StaticConfig, consts, carry: Carry) -> Decision:
    """One greedy step, the JAX package's `_step` op for op: filter, sample,
    score (the terms summed in order), argmax with the tie-break, commit,
    stop.  _step keeps the carry and the chosen node; the explain step
    also reads the filters' parts and the score terms."""
    dt = _dt(cfg)
    feasible, parts = _feasibility(cfg, consts, carry)
    any_feasible = feasible.any()
    scorable, next_start = _sample_scorable(cfg, feasible, carry.next_start)
    terms = _score_terms(cfg, consts, carry, scorable)
    total = torch.zeros(consts["static_mask"].shape[0], dtype=dt,
                        device=feasible.device)
    for _name, term in terms:
        total = total + term
    keyed = torch.where(scorable, total, -1.0)
    if cfg.deterministic:
        chosen = torch.argmax(keyed)
        rng = carry.rng
    else:
        keys = prng.split(carry.rng)
        rng = keys[0]
        jitter = prng.uniform(keys[1], keyed.shape[0])
        # integer scores: +0.5*U(0,1) breaks ties uniformly (the stationary
        # equivalent of selectHost's reservoir sampling) without reordering
        # distinct scores
        chosen = torch.argmax(keyed + 0.5 * jitter.to(dt))
    place = any_feasible & ~carry.stopped
    new_carry = _apply_placement(cfg, consts, carry, chosen, place,
                                 next_start, rng)
    new_carry = new_carry._replace(stopped=carry.stopped | ~any_feasible)
    return Decision(new_carry, chosen, place, parts, terms)


def _step(cfg: StaticConfig, consts, carry: Carry):
    """One greedy step: (carry, chosen node index or -1 once stopped)."""
    d = _decide(cfg, consts, carry)
    return d.carry, torch.where(d.place, d.chosen, -1).to(torch.int32)


def _apply_placement(cfg: StaticConfig, consts, carry: Carry,
                     chosen: torch.Tensor, place: torch.Tensor,
                     next_start: torch.Tensor, rng: torch.Tensor) -> Carry:
    """Commit one placement into the carry (the binder-plugin analog,
    plugin.go:34-53): single-row adds at the chosen node, and the topology
    counts of every node sharing its domain."""
    dt = _dt(cfg)
    gate = place.to(dt)
    req_vec = consts["req_vec"]
    if cfg.dra_shared_colocate:
        req_vec = req_vec + torch.where(carry.placed_count == 0,
                                        consts["shared_req_vec"], 0.0)
    requested = _row_add(carry.requested, chosen, (gate * req_vec)[None, :])
    nonzero = _row_add(carry.nonzero, chosen,
                       (gate * consts["req_nonzero"])[None, :])
    placed = _row_add(carry.placed, chosen,
                      place.to(torch.int32).reshape(1))

    sh_cnt = carry.sh_cnt
    if cfg.spread_hard_n > 0:
        dom_ch = _col(consts["sh_dom"], chosen)
        inc = (consts["sh_self"] & _col(consts["sh_countable"], chosen)
               ).to(dt) * gate
        sh_cnt = spread_ops.dense_count_update(carry.sh_cnt,
                                               consts["sh_dom"], dom_ch, inc)
    ss_cnt = carry.ss_cnt
    if cfg.spread_soft_n > 0:
        dom_ch = _col(consts["ss_dom"], chosen)
        inc = (consts["ss_self"] & _col(consts["ss_countable"], chosen)
               ).to(dt) * gate
        ss_cnt = spread_ops.dense_count_update(carry.ss_cnt,
                                               consts["ss_dom"], dom_ch, inc)

    aff_cnt, anti_cnt, pref_cnt = carry.aff_cnt, carry.anti_cnt, \
        carry.pref_cnt
    aff_total = carry.aff_total
    if cfg.ipa_num_aff > 0 or cfg.ipa_num_anti > 0 or cfg.ipa_num_pref > 0:
        ipa_dom_ch = _col(consts["ipa_dom"], chosen)
        ipa_valid = (ipa_dom_ch >= 0).to(dt)
    if cfg.ipa_num_aff > 0:
        inc = consts["ipa_aff_ginc"] * ipa_valid * gate
        aff_cnt = spread_ops.dense_count_update(carry.aff_cnt,
                                                consts["ipa_dom"],
                                                ipa_dom_ch, inc)
        aff_total = carry.aff_total + inc.sum()
    if cfg.ipa_num_anti > 0:
        inc = consts["ipa_anti_ginc"] * ipa_valid * gate
        anti_cnt = spread_ops.dense_count_update(carry.anti_cnt,
                                                 consts["ipa_dom"],
                                                 ipa_dom_ch, inc)
    if cfg.ipa_num_pref > 0:
        # ipa_pref_gw carries the pre-folded per-placement group weight
        inc = consts["ipa_pref_gw"] * ipa_valid * gate
        pref_cnt = spread_ops.dense_count_update(carry.pref_cnt,
                                                 consts["ipa_dom"],
                                                 ipa_dom_ch, inc)

    return Carry(
        requested=requested, nonzero=nonzero, placed=placed,
        sh_cnt=sh_cnt, ss_cnt=ss_cnt,
        aff_cnt=aff_cnt, anti_cnt=anti_cnt, pref_cnt=pref_cnt,
        aff_total=aff_total,
        placed_count=carry.placed_count + place.to(torch.int32),
        stopped=carry.stopped,
        next_start=torch.where(carry.stopped, carry.next_start, next_start),
        rng=rng,
    )


# ---------------------------------------------------------------------------
# The chunk runner: K steps, eager on the CPU, CUDA-graph replays on the card
# ---------------------------------------------------------------------------

def _leaves(state) -> List[torch.Tensor]:
    """The tensors of a (possibly nested) NamedTuple state, in order."""
    out: List[torch.Tensor] = []
    for v in state:
        if isinstance(v, torch.Tensor):
            out.append(v)
        else:
            out.extend(_leaves(v))
    return out


def _tree_map(fn, state):
    """`state` with fn applied to every tensor, same NamedTuple nesting."""
    return type(state)(*(fn(v) if isinstance(v, torch.Tensor)
                         else _tree_map(fn, v) for v in state))


def _eager_steps(cfg: StaticConfig, consts, carry, k: int, step=None):
    """K steps of `step` (default the scan step `_step`) from `carry`:
    (state after them, the steps' outputs stacked on a leading [K] axis —
    one tensor, or a tuple of them when the step emits several)."""
    step = step or _step
    outs = []
    for _ in range(k):
        carry, out = step(cfg, consts, carry)
        outs.append(out)
    if isinstance(outs[0], tuple):
        return carry, tuple(torch.stack(col) for col in zip(*outs))
    return carry, torch.stack(outs)


class _StepGraph:
    """`steps` steps of `step` captured once in a CUDA graph over static
    consts and state buffers.  A replay advances the static state in place
    (the graph ends by copying its last step's state into them) and writes
    the steps' outputs into `outs`."""

    def __init__(self, step, cfg: StaticConfig, consts, state, steps: int):
        self.step, self.cfg, self.steps = step, cfg, steps
        self.consts = {k: v.clone() for k, v in consts.items()}
        self.state = _tree_map(torch.clone, state)
        self.outs = None
        self.loaded = consts
        # warm-up on a side stream (first-use initialisation and the output
        # buffers stay out of the capture), then the capture
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            outs = self._body()
        torch.cuda.current_stream().wait_stream(side)
        self.outs = tuple(o.clone() for o in outs)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self._body()

    def _body(self) -> Tuple[torch.Tensor, ...]:
        state, outs = _eager_steps(self.cfg, self.consts, self.state,
                                   self.steps, self.step)
        for dst, src in zip(_leaves(self.state), _leaves(state)):
            if dst is not src:
                dst.copy_(src)
        outs = outs if isinstance(outs, tuple) else (outs,)
        if self.outs is not None:
            for dst, src in zip(self.outs, outs):
                dst.copy_(src)
        return outs

    def load(self, consts, state) -> None:
        if consts is not self.loaded:
            for k, v in consts.items():
                self.consts[k].copy_(v)
            self.loaded = consts
        for dst, src in zip(_leaves(self.state), _leaves(state)):
            dst.copy_(src)


_graphs: "OrderedDict[tuple, _StepGraph]" = OrderedDict()


def _graph_for(step, cfg: StaticConfig, consts, state,
               steps: int) -> _StepGraph:
    """The cached graph of `steps` steps of `step` for this config and
    these shapes and dtypes, captured on first use; the least recently used
    of more than _GRAPH_CACHE graphs is dropped."""
    leaves = _leaves(state)
    key = (step.__module__, step.__qualname__, cfg, steps,
           str(leaves[0].device),
           tuple((k, tuple(v.shape), v.dtype) for k, v in consts.items()),
           tuple((tuple(t.shape), t.dtype) for t in leaves))
    g = _graphs.get(key)
    if g is None:
        g = _StepGraph(step, cfg, consts, state, steps)
        _graphs[key] = g
        while len(_graphs) > _GRAPH_CACHE:
            _graphs.popitem(last=False)
    else:
        _graphs.move_to_end(key)
    return g


def _graph_steps(step, cfg: StaticConfig, consts, state, k: int):
    outs = None
    done, g_prev = 0, None
    while done < k:
        g = _graph_for(step, cfg, consts, state, min(_GRAPH_STEPS, k - done))
        if g is not g_prev:
            g.load(consts, state if g_prev is None else g_prev.state)
            g_prev = g
        if outs is None:
            outs = tuple(torch.empty((k, *o.shape[1:]), dtype=o.dtype,
                                     device=o.device) for o in g.outs)
        while done + g.steps <= k:
            g.graph.replay()
            for dst, src in zip(outs, g.outs):
                dst[done:done + g.steps].copy_(src)
            done += g.steps
    return _tree_map(torch.clone, g_prev.state), outs


def run_steps(step, cfg: StaticConfig, consts, state, k: int):
    """K steps of `step` (a function (cfg, consts, state) -> (state, outputs)
    with no host sync) from `state`: eagerly for CPU tensors, as replays of
    captured CUDA graphs of up to _GRAPH_STEPS steps for CUDA tensors, with
    no host sync inside the chunk.  Returns (state, outputs stacked on a
    leading [K] axis)."""
    if _leaves(state)[0].device.type == "cuda":
        state, outs = _graph_steps(step, cfg, consts, state, k)
        return state, outs if len(outs) > 1 else outs[0]
    return _eager_steps(cfg, consts, state, k, step)


def run_chunk(cfg: StaticConfig, consts, carry: Carry, k: int
              ) -> Tuple[Carry, torch.Tensor]:
    """K scan steps from `carry`: (carry after them, chosen int32[K], -1
    after the stop), the JAX package's _chunk_runner (run_steps of _step)."""
    return run_steps(_step, cfg, consts, carry, k)


def step_budget(pb: enc.EncodedProblem, max_limit: int = 0,
                bounds: bool = True) -> int:
    """The steps a solve may run: min(max_limit, max_steps_hint + 1,
    _DEFAULT_UNLIMITED_CAP), clamped with `bounds` to the capacity upper
    bound + 1 (bounds/bracket.py, host float64).  The engine cannot place
    more than the bound, and the one step past it discovers exhaustion, so
    placements and messages are the same either way."""
    budget = pb.max_steps_hint + 1
    if max_limit and max_limit > 0:
        budget = min(max_limit, budget)
    budget = max(1, min(budget, _DEFAULT_UNLIMITED_CAP))
    if bounds:
        from ..bounds.bracket import upper_bound_host
        budget = max(1, min(budget, upper_bound_host(pb) + 1))
    return budget


def solve(pb: enc.EncodedProblem, max_limit: int = 0, device=None,
          bounds: bool = True, explain: bool = False) -> SolveResult:
    """Run the greedy placement loop to completion on `device` (default the
    card), within step_budget(pb, max_limit, bounds).  The route is chosen
    here, before any launch: kernel 1 when fused.eligible admits the
    problem, the scan step (chunks of _STEP_CHUNK steps) otherwise.  Chunks
    always run at full length (steps after the stop change nothing) and
    placements are trimmed to the budget afterwards.

    With `explain`, the solve runs the explain step (explain/attribution.py:
    the scan step op for op, plus outputs) instead of kernel 1, which packs
    its carry in its own layout and exposes no per-step score terms, as the
    JAX package skips its Pallas kernel; the placements are the same.  The
    result carries an explain/artifacts.Explanation: why-here per
    placement, the why-not elimination record per node, the bottleneck
    table."""
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
        expl = None
        if explain:
            from ..explain import artifacts
            expl = artifacts.build_explanation(
                pb, histogram={pb.pod_level_reason: n}, rung="scan")
        return SolveResult(
            placements=[], placed_count=0,
            fail_type=pb.pod_level_fail_type,
            fail_message=f"0/{n} nodes are available: {pb.pod_level_reason}.",
            fail_counts={pb.pod_level_reason: n},
            node_names=pb.snapshot.node_names, explain=expl)

    cfg = static_config(pb)
    budget = step_budget(pb, max_limit, bounds)
    consts = build_consts(pb, dev)
    expl = None
    if explain:
        placements, carry, expl = _drive_explain(
            cfg, pb, consts, budget, min(_STEP_CHUNK, budget))
    elif fused.eligible(cfg, pb):
        placements, carry = _drive_kernel(cfg, pb, consts, budget)
    else:
        placements, carry = _drive_step(cfg, consts, _init_carry(pb, consts),
                                        budget, min(_STEP_CHUNK, budget))

    placements = placements[:budget]
    placed = len(placements)
    stopped = bool(carry.stopped)
    if max_limit and placed >= max_limit:
        # postBindHook limit semantics (simulator.go:297-312)
        return SolveResult(placements=placements, placed_count=placed,
                           fail_type=FAIL_LIMIT_REACHED,
                           fail_message=f"Maximum number of pods simulated: {max_limit}",
                           node_names=pb.snapshot.node_names, explain=expl)
    if stopped:
        counts = diagnose(pb, cfg, consts, carry)
        msg = format_fit_error(pb.snapshot.num_nodes, counts)
        return SolveResult(placements=placements, placed_count=placed,
                           fail_type=FAIL_UNSCHEDULABLE, fail_message=msg,
                           fail_counts=counts,
                           node_names=pb.snapshot.node_names, explain=expl)
    # Internal step budget exhausted without a user limit (only reachable
    # when the fit filter is disabled, so the hint bound is not binding).
    return SolveResult(placements=placements, placed_count=placed,
                       fail_type=FAIL_LIMIT_REACHED,
                       fail_message=(f"Simulation step budget exhausted after "
                                     f"{placed} placements; set max_limit to "
                                     f"bound unlimited profiles"),
                       node_names=pb.snapshot.node_names, explain=expl)


def _drive_explain(cfg: StaticConfig, pb: enc.EncodedProblem, consts,
                   budget: int, chunk: int):
    """The explain step in chunks of `chunk` steps, one host sync per chunk
    (the stop flag, the chosen indices and their why-here rows), as
    _drive_step; then the terminal why-not.  Returns (placements, carry,
    Explanation)."""
    from ..explain import artifacts, attribution

    econsts = attribution.explain_consts(pb, consts)
    state = attribution.init_state(_init_carry(pb, consts))
    placements: List[int] = []
    why_rows: List[np.ndarray] = []
    stopped = False
    while not stopped and len(placements) < budget:
        state, (chosen, contribs) = attribution.run_chunk(cfg, econsts,
                                                          state, chunk)
        stopped = bool(state.carry.stopped)
        chosen = chosen.cpu().numpy()
        keep = chosen >= 0
        placements.extend(chosen[keep].tolist())
        why_rows.append(contribs.cpu().numpy()[keep])
    placed = min(len(placements), budget)
    carry = state.carry
    codes, insufficient, too_many = attribution.final_codes(cfg, econsts,
                                                            carry)
    why_here = np.concatenate(why_rows)[:placed] if why_rows \
        else np.zeros((0, len(artifacts.PLUGINS)))
    expl = artifacts.build_explanation(
        pb, why_here=why_here, final_codes=codes,
        elim_step=state.elim_step.cpu().numpy(),
        elim_code=state.elim_code.cpu().numpy(),
        insufficient=insufficient, too_many=too_many, rung="scan")
    return placements, carry, expl


def _drive_kernel(cfg: StaticConfig, pb: enc.EncodedProblem, consts,
                  budget: int) -> Tuple[List[int], Carry]:
    """Kernel 1 in chunks of _FUSED_CHUNK steps: windows of chained
    launches, doubling up to _FUSED_PIPELINE chunks, with _FUSED_INFLIGHT
    windows issued ahead of the one being collected, so the host syncs once
    per window while the card runs the next one."""
    from . import fused

    carry = _init_carry(pb, consts)
    dev = consts["allocatable"].device
    chunk = min(_FUSED_CHUNK, budget)
    pk = fused._pack_meta(cfg, pb)
    const = fused._pack_consts(pk, consts)
    table = fused.kernel_table(pk, dev)
    planes, scalars = fused._pack_carry(pk, carry)

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
    return placements, fused._unpack_carry(pk, last[0], last[1], carry)


def _drive_step(cfg: StaticConfig, consts, carry: Carry, budget: int,
                chunk: int) -> Tuple[List[int], Carry]:
    """The scan step in chunks of `chunk` steps, one host sync per chunk
    (the stop flag and the chunk's chosen indices), until the carry stops
    or `budget` steps have placed; steps before the stop all place, so the
    placements count the steps run until then."""
    placements: List[int] = []
    stopped = False
    while not stopped and len(placements) < budget:
        carry, chosen = run_chunk(cfg, consts, carry, chunk)
        stopped = bool(carry.stopped)
        chosen = chosen.cpu().numpy()
        placements.extend(chosen[chosen >= 0].tolist())
    return placements, carry


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

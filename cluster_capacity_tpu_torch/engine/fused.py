"""Fused multi-step placement kernel: CUDA on the card, plain torch elsewhere.

The engine's only cross-step dependency is argmax -> carry update; the
per-step work is dense elementwise math and reductions over the node axis.
`fused_steps` runs K greedy steps in ONE launch of the hand-written CUDA
kernel in csrc/fused_steps.cu: one thread-block cluster per template, the
node axis cut into one slice per CTA, the planes that fit kept in shared
memory for the whole launch, and the step loop inside the kernel.
`launch_plan` decides the cluster size, the slices and which planes are
resident.  `fused_steps_reference` is the same function in plain PyTorch,
op for op; the wrapper takes it only for tensors that lie on the CPU.

Semantics are those of the JAX package's Pallas kernel
(engine/fused.py `_build_kernel`), bit for bit in float32:

- deterministic mode, float32 only, inside the shape caps below (`eligible`;
  every other problem runs engine/simulator.py's scan step)
- NodeResourcesFit filter + Least/Most/RequestedToCapacityRatio scoring,
  balanced allocation
- TaintToleration / NodeAffinity / ImageLocality static scores + normalize
- PodTopologySpread hard constraints and soft scoring (incl. system-default
  spreading)
- InterPodAffinity: all three probes, escape hatch, preferred-term scoring
- deterministic numFeasibleNodesToFind sampling (binary-searched threshold)
- NodePorts / volume / DRA clone self-conflict gates

Array layout (the JAX kernel's): every per-node vector is one [S, 128] f32
plane, S = ceil(N/128); planes stack into [P, S, 128] const and carry
operands.  The scalars block is f32[1, 4] = (placed_count, stopped,
next_start, aff_total).  Per-template numbers are DATA, not literals: an
int32 table of flags, counts and plane indices and a float32 table of
request vectors, skews, weights and the log table (`KernelTable`), laid out
by INT_FIELDS / FLOAT_FIELDS.  One build serves every problem.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.snapshot import IDX_CPU, IDX_PODS
from ..ops.inter_pod_affinity import group_fold
from ..ops.node_resources_fit import _floor_div, piecewise_segments
from . import simulator as sim

LANES = 128
_BIG = float(2 ** 31 - 1)

# Shape caps: the JAX kernel's eligibility caps (engine/fused.py eligible)
# plus the table's fixed section widths.
MAX_NODES = 65536
MAX_R = 16
MAX_SPREAD = 4
MAX_GROUPS = 4
_SOFT_DOMAIN_CAP = 32
MAX_SEG = 16

FIT_LEAST, FIT_MOST, FIT_RTC = 0, 1, 2

# (name, length) in table order; the CUDA source reads the same offsets from
# a header generated from these lists at build time (see _layout_header).
INT_FIELDS = (
    ("n", 1), ("s", 1), ("r", 1),
    ("fit_filter_on", 1), ("clone_has_ports", 1), ("volume_filter_on", 1),
    ("volume_self_conflict", 1), ("rwop_self_conflict", 1),
    ("dra_shared_colocate", 1),
    ("ch", 1), ("cs", 1), ("g", 1),
    ("ipa_filter_on", 1), ("ipa_aff_on", 1), ("ipa_anti_on", 1),
    ("ipa_pref_on", 1), ("ipa_escape", 1),
    ("sample_k", 1), ("bs_iters", 1),
    ("fit_strategy", 1), ("n_fit", 1), ("n_bal", 1), ("n_seg", 1),
    ("w_fit", 1), ("w_bal", 1), ("w_taint", 1), ("w_na", 1), ("w_il", 1),
    ("w_spread", 1), ("w_ipa", 1),
    ("fit_idx", MAX_R), ("fit_nz", MAX_R), ("bal_idx", MAX_R),
    ("sh_self", MAX_SPREAD), ("sh_minzero", MAX_SPREAD),
    ("ss_self", MAX_SPREAD), ("ss_host", MAX_SPREAD), ("ss_dnh", MAX_SPREAD),
    ("ghas_aff", MAX_GROUPS), ("ghas_anti", MAX_GROUPS),
    # const plane indices (-1 = plane absent)
    ("c_static_mask", 1), ("c_volume_mask", 1), ("c_taint_raw", 1),
    ("c_na_raw", 1), ("c_il_score", 1), ("c_sh_missing", 1),
    ("c_ss_ignored", 1), ("c_ipa_eanti_static", 1), ("c_ipa_static_pref", 1),
    ("c_alloc", MAX_R), ("c_sh_dom", MAX_SPREAD),
    ("c_sh_countable", MAX_SPREAD), ("c_ss_dom", MAX_SPREAD),
    ("c_ss_countable", MAX_SPREAD), ("c_ss_existing", MAX_SPREAD),
    ("c_ipa_dom", MAX_GROUPS), ("c_ipa_aff_scnt", MAX_GROUPS),
    ("c_ipa_anti_scnt", MAX_GROUPS),
    # carry plane indices (-1 = plane absent)
    ("y_requested", MAX_R), ("y_nonzero0", 1), ("y_nonzero1", 1),
    ("y_placed", 1), ("y_sh_cnt", MAX_SPREAD), ("y_ss_cnt", MAX_SPREAD),
    ("y_aff_cnt", MAX_GROUPS), ("y_anti_cnt", MAX_GROUPS),
    ("y_pref_cnt", MAX_GROUPS),
)
FLOAT_FIELDS = (
    ("req_vec", MAX_R), ("shared_req_vec", MAX_R), ("req_nonzero", 2),
    ("fit_w", MAX_R), ("fit_req", MAX_R), ("bal_req", MAX_R),
    ("sh_skew", MAX_SPREAD), ("ss_skew_m1", MAX_SPREAD),
    ("aff_ginc", MAX_GROUPS), ("anti_ginc", MAX_GROUPS),
    ("pref_gw", MAX_GROUPS),
    ("seg_xlo", MAX_SEG), ("seg_xhi", MAX_SEG), ("seg_ylo", MAX_SEG),
    ("seg_dy", MAX_SEG), ("seg_dx", MAX_SEG),
    ("shape_y0", 1), ("shape_xlast", 1), ("shape_ylast", 1),
    ("log", 0),   # tail: float32(log(size + 2)) for size = 0..n
)


def _offsets(fields) -> Dict[str, int]:
    out, off = {}, 0
    for name, ln in fields:
        out[name] = off
        off += ln
    return out


IOFF = _offsets(INT_FIELDS)
FOFF = _offsets(FLOAT_FIELDS)
INT_WIDTH = sum(ln for _, ln in INT_FIELDS)
# most const / carry planes a table can index, and the kernel's per-step
# node scratch (feasible, scorable, spread raw, IPA raw)
MAX_CONST_PLANES = sum(ln for name, ln in INT_FIELDS if name.startswith("c_"))
MAX_CARRY_PLANES = sum(ln for name, ln in INT_FIELDS if name.startswith("y_"))
SCRATCH_PLANES = 4


class KernelTable(NamedTuple):
    """Per-template numbers of one problem, on the planes' device."""

    i: torch.Tensor          # int32[INT_WIDTH]
    f: torch.Tensor          # float32[FOFF["log"] + n + 1]

    def to(self, device) -> "KernelTable":
        return KernelTable(self.i.to(device), self.f.to(device))


class KernelMeta(NamedTuple):
    """The template's numbers, as the JAX kernel's KernelMeta names them."""

    n: int
    s: int
    r: int
    cfg: sim.StaticConfig
    req_vec: Tuple[float, ...]
    req_nonzero: Tuple[float, ...]
    shared_req_vec: Tuple[float, ...]
    fit_w: Tuple[float, ...]
    fit_req: Tuple[float, ...]
    bal_req: Tuple[float, ...]
    sh_skew: Tuple[float, ...]
    sh_mindom: Tuple[float, ...]
    sh_domnum: Tuple[float, ...]
    sh_self: Tuple[bool, ...]
    cs: int
    ss_skew: Tuple[float, ...]
    ss_self: Tuple[bool, ...]
    ss_host: Tuple[bool, ...]
    ss_dnh: Tuple[int, ...]
    ghas_aff: Tuple[bool, ...]
    ghas_anti: Tuple[bool, ...]
    aff_ginc: Tuple[float, ...]
    anti_ginc: Tuple[float, ...]
    pref_gw: Tuple[float, ...]
    g: int
    ch: int
    has_taint: bool
    has_na: bool
    has_il: bool
    has_static_pref: bool


def _soft_row_domains(ss, c: int) -> int:
    """Domain count of one soft-constraint row: 0 for hostname rows and for
    inert padding; else the dense vocabulary size."""
    if c >= ss.num_constraints or ss.is_hostname[c]:
        return 0
    if not (ss.node_domain[c] >= 0).any():
        return 0
    return int(ss.node_domain[c].max()) + 1


def _refusal(cfg: sim.StaticConfig, pb) -> Optional[str]:
    """Why this kernel does not take the problem, or None when it does:
    the JAX kernel's refusals (fused.eligible) plus the table's caps.  The
    JAX kernel's VMEM plane budget (vmem_ok) becomes `launch_plan`, which
    serves every shape up to MAX_NODES: planes that do not fit in shared
    memory stay in device memory."""
    if cfg.dtype64:
        return "float64 parity mode"
    if not cfg.deterministic:
        return "random tie-break (deterministic=False)"
    n = pb.snapshot.num_nodes
    if n == 0 or n > MAX_NODES:
        return f"{n} nodes: the kernel takes 1 to {MAX_NODES}"
    if len(pb.resource_names) > MAX_R:
        return f"{len(pb.resource_names)} resources exceed {MAX_R}"
    ss = pb.spread_soft
    if cfg.spread_soft_n > 0:
        if ss.node_domain.shape[0] > MAX_SPREAD:
            return f"more than {MAX_SPREAD} soft spread constraints"
        for c in range(ss.num_constraints):
            if _soft_row_domains(ss, c) > _SOFT_DOMAIN_CAP:
                return (f"a soft spread key with more than "
                        f"{_SOFT_DOMAIN_CAP} domains")
    if cfg.spread_hard_n > MAX_SPREAD:
        return f"more than {MAX_SPREAD} hard spread constraints"
    if pb.ipa.node_domain.shape[0] > MAX_GROUPS:
        return f"more than {MAX_GROUPS} inter-pod affinity topology groups"
    if len(cfg.bal_idx) > 2 and sim._weight(
            cfg, "NodeResourcesBalancedAllocation"):
        return "balanced allocation over more than 2 resources"
    if len(cfg.fit_shape[0]) - 1 > MAX_SEG:
        return f"a scoring shape of more than {MAX_SEG} segments"
    return None


def eligible(cfg: sim.StaticConfig, pb) -> bool:
    """True when this kernel takes the problem.  simulator.solve and the
    batched sweep route on it before any launch; every other problem runs
    the scan step (engine/simulator.py `run_chunk`)."""
    return _refusal(cfg, pb) is None


def check_eligible(cfg: sim.StaticConfig, pb) -> None:
    """Raise NotImplementedError for a problem this kernel does not take
    (a direct kernel call; solve routes such problems to the scan step)."""
    why = _refusal(cfg, pb)
    if why is not None:
        raise NotImplementedError(
            f"{why}: outside kernel 1's envelope (engine/simulator.py's "
            f"scan step serves it)")


# ---------------------------------------------------------------------------
# Plane packing (the JAX kernel's layout and plane order)
# ---------------------------------------------------------------------------

def _plane(vec: torch.Tensor, s: int, fill: float) -> torch.Tensor:
    vec = vec.to(torch.float32)
    pad = s * LANES - vec.shape[0]
    if pad:
        vec = torch.cat([vec, torch.full((pad,), fill, dtype=torch.float32,
                                         device=vec.device)])
    return vec.reshape(s, LANES)


class _Packing(NamedTuple):
    meta: KernelMeta
    const_names: Tuple[str, ...]
    carry_names: Tuple[str, ...]

    @property
    def const_idx(self) -> Dict[str, int]:
        return {k: i for i, k in enumerate(self.const_names)}

    @property
    def carry_idx(self) -> Dict[str, int]:
        return {k: i for i, k in enumerate(self.carry_names)}


def _pack_meta(cfg: sim.StaticConfig, pb) -> _Packing:
    n = pb.snapshot.num_nodes
    s = max(1, -(-n // LANES))
    r = len(pb.resource_names)
    ipa = pb.ipa
    g = ipa.node_domain.shape[0]
    ch = pb.spread_hard.node_domain.shape[0]
    ghas_aff, ghas_anti, aff_ginc, anti_ginc, pref_gw = (
        tuple(x.item() for x in arr) for arr in group_fold(ipa))
    sh = pb.spread_hard
    ss = pb.spread_soft
    cs = ss.node_domain.shape[0]
    meta = KernelMeta(
        n=n, s=s, r=r, cfg=cfg,
        req_vec=tuple(float(x) for x in pb.req_vec),
        req_nonzero=tuple(float(x) for x in pb.req_nonzero),
        shared_req_vec=tuple(float(x) for x in pb.shared_req_vec),
        fit_w=tuple(float(x) for x in pb.fit_res_weights),
        fit_req=tuple(float(x) for x in pb.fit_req),
        bal_req=tuple(float(x) for x in pb.balanced_req),
        sh_skew=tuple(float(x) for x in sh.max_skew),
        sh_mindom=tuple(float(x) for x in sh.min_domains),
        sh_domnum=tuple(float(x) for x in sh.domain_valid.sum(axis=1)),
        sh_self=tuple(bool(x) for x in sh.self_match),
        cs=cs,
        ss_skew=tuple(float(x) for x in ss.max_skew),
        ss_self=tuple(bool(x) for x in ss.self_match),
        ss_host=tuple(bool(x) for x in ss.is_hostname),
        ss_dnh=tuple(_soft_row_domains(ss, c) for c in range(cs)),
        ghas_aff=tuple(ghas_aff), ghas_anti=tuple(ghas_anti),
        aff_ginc=tuple(aff_ginc), anti_ginc=tuple(anti_ginc),
        pref_gw=tuple(pref_gw), g=g, ch=ch,
        has_taint=bool(sim._weight(cfg, "TaintToleration")),
        has_na=bool(sim._weight(cfg, "NodeAffinity") and cfg.na_active),
        has_il=bool(sim._weight(cfg, "ImageLocality")),
        has_static_pref=bool(cfg.ipa_score_active),
    )

    const_names = ["static_mask"]
    if cfg.volume_filter_on:
        const_names.append("volume_mask")
    if meta.has_taint:
        const_names.append("taint_raw")
    if meta.has_na:
        const_names.append("na_raw")
    if meta.has_il:
        const_names.append("il_score")
    const_names += [f"alloc{j}" for j in range(r)]
    if cfg.spread_hard_n > 0:
        const_names += [f"sh_dom{c}" for c in range(ch)]
        const_names += [f"sh_countable{c}" for c in range(ch)]
        const_names.append("sh_missing")
    if cfg.spread_soft_n > 0:
        const_names += [f"ss_dom{c}" for c in range(cs)]
        const_names += [f"ss_countable{c}" for c in range(cs)]
        const_names += [f"ss_existing{c}" for c in range(cs)]
        const_names.append("ss_ignored")
    if cfg.ipa_filter_on or cfg.ipa_num_aff or cfg.ipa_num_anti \
            or cfg.ipa_num_pref:
        const_names += [f"ipa_dom{gi}" for gi in range(g)]
    if cfg.ipa_filter_on:
        const_names += [f"ipa_aff_scnt{gi}" for gi in range(g)]
        const_names += [f"ipa_anti_scnt{gi}" for gi in range(g)]
        const_names.append("ipa_eanti_static")
    if meta.has_static_pref:
        const_names.append("ipa_static_pref")

    carry_names = [f"requested{j}" for j in range(r)]
    carry_names += ["nonzero0", "nonzero1", "placed"]
    if cfg.spread_hard_n > 0:
        carry_names += [f"sh_cnt{c}" for c in range(ch)]
    if cfg.spread_soft_n > 0:
        carry_names += [f"ss_cnt{c}" for c in range(cs)]
    if cfg.ipa_num_aff > 0 or cfg.ipa_filter_on:
        carry_names += [f"aff_cnt{gi}" for gi in range(g)]
    if cfg.ipa_num_anti > 0 or cfg.ipa_filter_on:
        carry_names += [f"anti_cnt{gi}" for gi in range(g)]
    if cfg.ipa_num_pref > 0:
        carry_names += [f"pref_cnt{gi}" for gi in range(g)]
    return _Packing(meta=meta, const_names=tuple(const_names),
                    carry_names=tuple(carry_names))


def _pack_consts(pk: _Packing, consts: Dict[str, torch.Tensor]) -> torch.Tensor:
    meta, cfg = pk.meta, pk.meta.cfg
    s = meta.s
    ci = pk.const_idx
    planes: List[Optional[torch.Tensor]] = [None] * len(ci)

    def put(name, vec, fill=0.0):
        planes[ci[name]] = _plane(vec, s, fill)

    put("static_mask", consts["static_mask"])
    if cfg.volume_filter_on:
        put("volume_mask", consts["volume_mask"])
    if meta.has_taint:
        put("taint_raw", consts["taint_raw"])
    if meta.has_na:
        put("na_raw", consts["na_raw"])
    if meta.has_il:
        put("il_score", consts["il_score"])
    for j in range(meta.r):
        put(f"alloc{j}", consts["allocatable"][:, j])
    if cfg.spread_hard_n > 0:
        for c in range(meta.ch):
            put(f"sh_dom{c}", consts["sh_dom"][c], fill=-1.0)
            put(f"sh_countable{c}", consts["sh_countable"][c])
        put("sh_missing", consts["sh_missing"], fill=1.0)
    if cfg.spread_soft_n > 0:
        for c in range(meta.cs):
            put(f"ss_dom{c}", consts["ss_dom"][c], fill=-1.0)
            put(f"ss_countable{c}", consts["ss_countable"][c])
            put(f"ss_existing{c}", consts["ss_node_existing"][c])
        put("ss_ignored", consts["ss_ignored"], fill=1.0)
    if "ipa_dom0" in ci:
        for gi in range(meta.g):
            put(f"ipa_dom{gi}", consts["ipa_dom"][gi], fill=-1.0)
    if cfg.ipa_filter_on:
        for gi in range(meta.g):
            put(f"ipa_aff_scnt{gi}", consts["ipa_aff_scnt"][gi])
            put(f"ipa_anti_scnt{gi}", consts["ipa_anti_scnt"][gi])
        put("ipa_eanti_static", consts["ipa_eanti_static"])
    if meta.has_static_pref:
        put("ipa_static_pref", consts["ipa_static_pref"])
    return torch.stack(planes).contiguous()


def _pack_carry(pk: _Packing, carry: "sim.Carry"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    meta = pk.meta
    s = meta.s
    yi = pk.carry_idx
    planes: List[Optional[torch.Tensor]] = [None] * len(yi)

    def put(name, vec):
        planes[yi[name]] = _plane(vec, s, 0.0)

    for j in range(meta.r):
        put(f"requested{j}", carry.requested[:, j])
    put("nonzero0", carry.nonzero[:, 0])
    put("nonzero1", carry.nonzero[:, 1])
    put("placed", carry.placed)
    for stem, arr, count in (("sh_cnt", carry.sh_cnt, meta.ch),
                             ("ss_cnt", carry.ss_cnt, meta.cs),
                             ("aff_cnt", carry.aff_cnt, meta.g),
                             ("anti_cnt", carry.anti_cnt, meta.g),
                             ("pref_cnt", carry.pref_cnt, meta.g)):
        if f"{stem}0" in yi:
            for i in range(count):
                put(f"{stem}{i}", arr[i])
    scalars = torch.stack([
        carry.placed_count.to(torch.float32),
        carry.stopped.to(torch.float32),
        carry.next_start.to(torch.float32),
        carry.aff_total.to(torch.float32),
    ]).reshape(1, 4)
    return torch.stack(planes).contiguous(), scalars.contiguous()


def _unpack_carry(pk: _Packing, planes: torch.Tensor, scalars: torch.Tensor,
                  template: "sim.Carry") -> "sim.Carry":
    """Write the kernel's planes back into a standard Carry."""
    meta = pk.meta
    yi = pk.carry_idx
    flat = planes.reshape(planes.shape[0], -1)[:, :meta.n]

    def rows(stem, count):
        return torch.stack([flat[yi[f"{stem}{i}"]] for i in range(count)])

    def rows_or(stem, count, default):
        return rows(stem, count) if f"{stem}0" in yi else default

    sc = scalars.reshape(-1)
    return template._replace(
        requested=rows("requested", meta.r).T.contiguous(),
        nonzero=torch.stack([flat[yi["nonzero0"]],
                             flat[yi["nonzero1"]]]).T.contiguous(),
        placed=flat[yi["placed"]].to(torch.int32),
        sh_cnt=rows_or("sh_cnt", meta.ch, template.sh_cnt),
        ss_cnt=rows_or("ss_cnt", meta.cs, template.ss_cnt),
        aff_cnt=rows_or("aff_cnt", meta.g, template.aff_cnt),
        anti_cnt=rows_or("anti_cnt", meta.g, template.anti_cnt),
        pref_cnt=rows_or("pref_cnt", meta.g, template.pref_cnt),
        placed_count=torch.round(sc[0]).to(torch.int32),
        stopped=torch.round(sc[1]) != 0,
        next_start=torch.round(sc[2]).to(torch.int32),
        aff_total=sc[3].clone(),
    )


# ---------------------------------------------------------------------------
# The per-template table
# ---------------------------------------------------------------------------

def log_table(n: int) -> np.ndarray:
    """float32(log(size + 2)) for size = 0..n, each value the float64
    logarithm rounded once to float32 (correctly rounded, so the kernel and
    the plain version read the same numbers on every device)."""
    return np.log(np.arange(n + 1, dtype=np.float64) + 2.0).astype(np.float32)


def kernel_table(pk: _Packing, device="cpu") -> KernelTable:
    meta, cfg = pk.meta, pk.meta.cfg
    ci, yi = pk.const_idx, pk.carry_idx
    it = np.full(INT_WIDTH, -1, dtype=np.int64)
    ft = np.zeros(FOFF["log"] + meta.n + 1, dtype=np.float64)

    def iput(name, vals):
        vals = list(vals) if isinstance(vals, (list, tuple)) else [vals]
        it[IOFF[name]: IOFF[name] + len(vals)] = [int(v) for v in vals]

    def fput(name, vals):
        vals = list(vals) if isinstance(vals, (list, tuple)) else [vals]
        ft[FOFF[name]: FOFF[name] + len(vals)] = [float(v) for v in vals]

    def plane(idx, name):
        return idx.get(name, -1)

    w = lambda name: sim._weight(cfg, name)
    seg = piecewise_segments(*cfg.fit_shape)
    iput("n", meta.n)
    iput("s", meta.s)
    iput("r", meta.r)
    for flag in ("fit_filter_on", "clone_has_ports", "volume_filter_on",
                 "volume_self_conflict", "rwop_self_conflict",
                 "dra_shared_colocate", "ipa_filter_on"):
        iput(flag, int(bool(getattr(cfg, flag))))
    iput("ch", meta.ch if cfg.spread_hard_n > 0 else 0)
    iput("cs", meta.cs if cfg.spread_soft_n > 0 else 0)
    iput("g", meta.g)
    iput("ipa_aff_on", int(cfg.ipa_num_aff > 0))
    iput("ipa_anti_on", int(cfg.ipa_num_anti > 0))
    iput("ipa_pref_on", int(cfg.ipa_num_pref > 0))
    iput("ipa_escape", int(cfg.ipa_escape_allowed and cfg.ipa_static_empty))
    n = meta.n
    iput("sample_k", min(cfg.sample_k, n) if cfg.sample_k > 0 else 0)
    iput("bs_iters", max(1, int(np.ceil(np.log2(max(n, 2)))) + 1))
    iput("fit_strategy", {"MostAllocated": FIT_MOST,
                          "RequestedToCapacityRatio": FIT_RTC}.get(
                              cfg.fit_strategy_type, FIT_LEAST))
    iput("n_fit", len(cfg.fit_idx))
    iput("n_bal", len(cfg.bal_idx))
    iput("n_seg", len(seg))
    iput("w_fit", w("NodeResourcesFit"))
    iput("w_bal", w("NodeResourcesBalancedAllocation"))
    iput("w_taint", w("TaintToleration"))
    iput("w_na", w("NodeAffinity") if cfg.na_active else 0)
    iput("w_il", w("ImageLocality"))
    iput("w_spread", w("PodTopologySpread") if cfg.spread_soft_n > 0 else 0)
    iput("w_ipa", w("InterPodAffinity") if cfg.ipa_score_active else 0)
    iput("fit_idx", cfg.fit_idx)
    iput("fit_nz", [int(b) for b in cfg.fit_nz])
    iput("bal_idx", cfg.bal_idx)
    iput("sh_self", [int(b) for b in meta.sh_self])
    iput("sh_minzero", [int(d < m) for d, m in zip(meta.sh_domnum,
                                                    meta.sh_mindom)])
    iput("ss_self", [int(b) for b in meta.ss_self])
    iput("ss_host", [int(b) for b in meta.ss_host])
    iput("ss_dnh", meta.ss_dnh)
    iput("ghas_aff", [int(b) for b in meta.ghas_aff])
    iput("ghas_anti", [int(b) for b in meta.ghas_anti])
    for name in ("static_mask", "volume_mask", "taint_raw", "na_raw",
                 "il_score", "sh_missing", "ss_ignored", "ipa_eanti_static",
                 "ipa_static_pref"):
        iput(f"c_{name}", plane(ci, name))
    iput("c_alloc", [plane(ci, f"alloc{j}") for j in range(meta.r)])
    for stem, count in (("sh_dom", meta.ch), ("sh_countable", meta.ch),
                        ("ss_dom", meta.cs), ("ss_countable", meta.cs),
                        ("ss_existing", meta.cs), ("ipa_dom", meta.g),
                        ("ipa_aff_scnt", meta.g), ("ipa_anti_scnt", meta.g)):
        iput(f"c_{stem}", [plane(ci, f"{stem}{i}") for i in range(count)])
    iput("y_requested", [plane(yi, f"requested{j}") for j in range(meta.r)])
    for name in ("nonzero0", "nonzero1", "placed"):
        iput(f"y_{name}", plane(yi, name))
    for stem, count in (("sh_cnt", meta.ch), ("ss_cnt", meta.cs),
                        ("aff_cnt", meta.g), ("anti_cnt", meta.g),
                        ("pref_cnt", meta.g)):
        iput(f"y_{stem}", [plane(yi, f"{stem}{i}") for i in range(count)])

    fput("req_vec", meta.req_vec)
    fput("shared_req_vec", meta.shared_req_vec)
    fput("req_nonzero", meta.req_nonzero)
    fput("fit_w", meta.fit_w)
    fput("fit_req", meta.fit_req)
    fput("bal_req", meta.bal_req)
    fput("sh_skew", meta.sh_skew)
    # (maxSkew - 1) is formed in float64 and rounded once, as the JAX step's
    # Python-float literal is
    fput("ss_skew_m1", [x - 1.0 for x in meta.ss_skew])
    fput("aff_ginc", meta.aff_ginc)
    fput("anti_ginc", meta.anti_ginc)
    fput("pref_gw", meta.pref_gw)
    for k, field in enumerate(("seg_xlo", "seg_xhi", "seg_ylo", "seg_dy",
                               "seg_dx")):
        fput(field, [row[k] for row in seg])
    xs, ys = cfg.fit_shape
    fput("shape_y0", float(ys[0]) * 10.0)
    fput("shape_xlast", float(xs[-1]))
    fput("shape_ylast", float(ys[-1]) * 10.0)
    ft[FOFF["log"]:] = log_table(n)
    return KernelTable(
        i=torch.from_numpy(it.astype(np.int32)).to(device),
        f=torch.from_numpy(ft.astype(np.float32)).to(device))


class _Ints:
    """Named read access to a host copy of the int table."""

    def __init__(self, vals: List[int]):
        self._v = vals

    def __getattr__(self, name):
        off = IOFF[name]
        ln = dict(INT_FIELDS)[name]
        return self._v[off] if ln == 1 else self._v[off: off + ln]


def reductions_per_step(table: KernelTable) -> int:
    """The cluster-wide reductions (`cluster_reduce`, `cluster_argmax` in
    csrc/fused_steps.cu) that one placing step of kernel 1 runs on this
    table: the hard-spread minimum where a hard row is live, one for the
    score normalisers or, without them, for any-feasible, `bs_iters` for
    the sampling search, the soft spread's min/max where it is weighted,
    and the argmax."""
    I = _Ints(table.i.cpu().tolist())
    return (int(I.ch > 0) + 1 + (I.bs_iters if I.sample_k > 0 else 0)
            + int(I.w_spread != 0) + 1)


def _check_args(const, carry, scalars, table, k) -> None:
    if not isinstance(table, KernelTable):
        raise TypeError("table must be a KernelTable")
    for name, t, dt in (("const", const, torch.float32),
                        ("carry", carry, torch.float32),
                        ("scalars", scalars, torch.float32),
                        ("table.i", table.i, torch.int32),
                        ("table.f", table.f, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != const.device:
            raise ValueError(f"{name} is on {t.device}, const on "
                             f"{const.device}")
    if const.dim() != 3 or const.shape[2] != LANES:
        raise ValueError(f"const must be [P, S, {LANES}], got "
                         f"{tuple(const.shape)}")
    if carry.dim() != 3 or carry.shape[1:] != const.shape[1:]:
        raise ValueError(f"carry must be [P, {const.shape[1]}, {LANES}], "
                         f"got {tuple(carry.shape)}")
    if tuple(scalars.shape) != (1, 4):
        raise ValueError(f"scalars must be [1, 4], got {tuple(scalars.shape)}")
    if table.i.shape != (INT_WIDTH,):
        raise ValueError(f"table.i must be [{INT_WIDTH}]")
    if not isinstance(k, int) or k < 1:
        raise ValueError(f"k must be a positive int, got {k!r}")


# ---------------------------------------------------------------------------
# The plain PyTorch version
# ---------------------------------------------------------------------------

def fused_steps_reference(const: torch.Tensor, carry: torch.Tensor,
                          scalars: torch.Tensor, table: KernelTable, k: int
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K fused placement steps in plain PyTorch, op for op the JAX kernel's
    `step` (engine/fused.py _build_kernel in the JAX package).  Returns
    (carry_out [Py, S, 128] f32, scalars_out [1, 4] f32, chosen [k, 1] i32,
    -1 after the stop).  Divisors are tensors, never Python numbers (CUDA
    divides by a host scalar through its reciprocal)."""
    _check_args(const, carry, scalars, table, k)
    I = _Ints(table.i.cpu().tolist())
    Fh = table.f.cpu().numpy()
    F = table.f
    dev = const.device
    f32 = torch.float32
    npad = const.shape[1] * LANES
    n = I.n
    C = const.reshape(const.shape[0], npad)
    Y = list(carry.reshape(carry.shape[0], npad).clone().unbind(0))
    sc = scalars.reshape(4).clone()
    placed_count, stopped, next_start, aff_total = sc.unbind(0)
    iota = torch.arange(npad, dtype=torch.int32, device=dev)
    real = iota < n
    zero = torch.zeros(npad, dtype=f32, device=dev)
    one = torch.ones((), dtype=f32, device=dev)
    tiny = torch.full((), 1e-30, dtype=f32, device=dev)
    fo = FOFF
    chosen_out = []

    def fv(name, i=0):
        return F[fo[name] + i]

    def default_normalize(raw, scorable, reverse):
        max_s = torch.where(scorable, raw, zero).max()
        scaled = torch.where(
            max_s > 0,
            torch.floor(100.0 * raw / torch.where(max_s > 0, max_s, one)),
            raw)
        if reverse:
            scaled = torch.where(max_s > 0, 100.0 - scaled,
                                 torch.full_like(raw, 100.0))
        return torch.where(scorable, scaled, zero)

    for _ in range(k):
        if float(stopped) > 0.5:
            # a stopped step changes nothing (place = false: every update
            # adds zero, next_start is kept); the kernel skips it too
            chosen_out.append(torch.full((), -1, dtype=torch.int32,
                                         device=dev))
            continue
        # ---- feasibility ------------------------------------------------
        feasible = C[I.c_static_mask] > 0.5
        if I.fit_filter_on:
            fit_ok = ~(Y[I.y_requested[IDX_PODS]] + 1.0
                       > C[I.c_alloc[IDX_PODS]])
            for j in range(I.r):
                if j == IDX_PODS:
                    continue
                free = C[I.c_alloc[j]] - Y[I.y_requested[j]]
                if I.dra_shared_colocate and Fh[fo["shared_req_vec"] + j]:
                    rvj = fv("req_vec", j) + torch.where(
                        placed_count == 0, fv("shared_req_vec", j),
                        torch.zeros((), dtype=f32, device=dev))
                    fit_ok &= ~(rvj > free)
                elif Fh[fo["req_vec"] + j] > 0:
                    fit_ok &= ~(fv("req_vec", j) > free)
            feasible &= fit_ok
        placed_plane = Y[I.y_placed]
        if I.clone_has_ports:
            feasible &= ~(placed_plane > 0)
        if I.volume_filter_on:
            feasible &= C[I.c_volume_mask] > 0.5
        if I.volume_self_conflict:
            feasible &= ~(placed_plane > 0)
        if I.rwop_self_conflict:
            feasible &= placed_count == 0
        if I.dra_shared_colocate:
            feasible &= (placed_plane > 0) | (placed_count == 0)

        if I.ch > 0:
            violated = torch.zeros(npad, dtype=torch.bool, device=dev)
            for c in range(I.ch):
                cnt = Y[I.y_sh_cnt[c]]
                countable = C[I.c_sh_countable[c]] > 0.5
                min_match = torch.where(countable, cnt,
                                        torch.full_like(cnt, _BIG)).min()
                if I.sh_minzero[c]:
                    min_match = torch.zeros((), dtype=f32, device=dev)
                has_key = C[I.c_sh_dom[c]] >= 0
                skew = cnt + (1.0 if I.sh_self[c] else 0.0) - min_match
                violated |= (skew > fv("sh_skew", c)) & has_key
            feasible &= ~((C[I.c_sh_missing] > 0.5) | violated)

        if I.ipa_filter_on:
            true_ = torch.ones(npad, dtype=torch.bool, device=dev)
            false_ = torch.zeros(npad, dtype=torch.bool, device=dev)
            if I.ipa_aff_on:
                pods_exist, all_keys = true_, true_
                for gi in range(I.g):
                    if not I.ghas_aff[gi]:
                        continue
                    has_key = C[I.c_ipa_dom[gi]] >= 0
                    tot = C[I.c_ipa_aff_scnt[gi]] + Y[I.y_aff_cnt[gi]]
                    pods_exist = pods_exist & has_key & (tot > 0)
                    all_keys = all_keys & has_key
                if I.ipa_escape:
                    aff_ok = pods_exist | (all_keys & (aff_total == 0))
                else:
                    aff_ok = pods_exist
            else:
                aff_ok = true_
            anti_fail, eanti_dyn = false_, false_
            if I.ipa_anti_on:
                for gi in range(I.g):
                    if not I.ghas_anti[gi]:
                        continue
                    has_key = C[I.c_ipa_dom[gi]] >= 0
                    dyn = Y[I.y_anti_cnt[gi]]
                    anti_fail = anti_fail | (
                        has_key & (C[I.c_ipa_anti_scnt[gi]] + dyn > 0))
                    eanti_dyn = eanti_dyn | (has_key & (dyn > 0))
            eanti_fail = (C[I.c_ipa_eanti_static] > 0.5) | eanti_dyn
            feasible &= aff_ok & ~anti_fail & ~eanti_fail

        any_feasible = feasible.any()

        # ---- sampling (numFeasibleNodesToFind emulation) ----------------
        scorable = feasible
        new_next_start = next_start
        if I.sample_k > 0:
            start = next_start.to(torch.int32)
            rank = torch.where(real, torch.remainder(iota - start, n),
                               torch.full_like(iota, n))
            lo = torch.zeros((), dtype=torch.int32, device=dev)
            hi = torch.full((), n - 1, dtype=torch.int32, device=dev)
            for _it in range(I.bs_iters):
                mid = torch.div(lo + hi, 2, rounding_mode="floor")
                cnt = (feasible & (rank <= mid)).sum(dtype=torch.int32)
                ok = cnt >= I.sample_k
                lo, hi = torch.where(ok, lo, mid + 1), torch.where(ok, mid, hi)
            scorable = feasible & (rank <= hi)
            new_next_start = torch.remainder(start + (hi + 1), n).to(f32)

        # ---- scores ------------------------------------------------------
        total = zero
        if I.w_fit:
            acc, wsum_n = zero, zero
            rtc = I.fit_strategy == FIT_RTC
            for k2 in range(I.n_fit):
                j = I.fit_idx[k2]
                alloc = C[I.c_alloc[j]]
                if I.fit_nz[k2]:
                    req = Y[I.y_nonzero0 if j == IDX_CPU else I.y_nonzero1]
                else:
                    req = Y[I.y_requested[j]]
                req = req + fv("fit_req", k2)
                if I.fit_strategy == FIT_MOST:
                    per = torch.where(alloc > 0, _floor_div(
                        torch.minimum(req, alloc) * 100.0, alloc), zero)
                elif rtc:
                    util = torch.where(alloc > 0,
                                       _floor_div(req * 100.0, alloc), zero)
                    per = torch.trunc(_piecewise(util, I, F))
                    per = torch.where(alloc > 0, per, zero)
                else:
                    per = torch.where(req > alloc, zero,
                                      _floor_div((alloc - req) * 100.0, alloc))
                    per = torch.where(alloc > 0, per, zero)
                acc = acc + per * fv("fit_w", k2)
                counted = (alloc > 0) & (per > 0) if rtc else alloc > 0
                wsum_n = wsum_n + torch.where(counted, fv("fit_w", k2), zero)
            if rtc:
                score = torch.where(
                    wsum_n > 0,
                    torch.floor(acc / torch.maximum(wsum_n, tiny) + 0.5),
                    zero)
            else:
                score = torch.where(wsum_n > 0, _floor_div(acc, wsum_n), zero)
            total = total + float(I.w_fit) * torch.where(scorable, score, zero)

        if I.w_bal:
            fracs, valids = [], []
            for k2 in range(I.n_bal):
                j = I.bal_idx[k2]
                alloc = C[I.c_alloc[j]]
                req = Y[I.y_requested[j]] + fv("bal_req", k2)
                valids.append(alloc > 0)
                fracs.append(torch.where(
                    valids[-1],
                    torch.minimum(req / torch.maximum(alloc, tiny), one),
                    zero))
            count = zero
            for v in valids:
                count = count + v.to(f32)
            fsum = zero
            for fr in fracs:
                fsum = fsum + fr
            mean = fsum / torch.maximum(count, one)
            vsum = zero
            for v, fr in zip(valids, fracs):
                d = fr - mean
                vsum = vsum + torch.where(v, d * d, zero)
            var = vsum / torch.maximum(count, one)
            std = torch.where(count >= 2, torch.sqrt(var), zero)
            score = torch.trunc((1.0 - std) * 100.0)
            total = total + float(I.w_bal) * torch.where(scorable, score, zero)

        if I.w_taint:
            total = total + float(I.w_taint) * default_normalize(
                C[I.c_taint_raw], scorable, True)
        if I.w_na:
            total = total + float(I.w_na) * default_normalize(
                C[I.c_na_raw], scorable, False)
        if I.w_il:
            total = total + float(I.w_il) * torch.where(
                scorable, C[I.c_il_score], zero)

        if I.w_spread:
            ssc = scorable & ~(C[I.c_ss_ignored] > 0.5)
            raw = zero
            host_size = ssc.sum()
            for c in range(I.cs):
                dom = C[I.c_ss_dom[c]]
                has_key = dom >= 0
                if I.ss_host[c]:
                    cnt = C[I.c_ss_existing[c]]
                    if I.ss_self[c]:
                        cnt = cnt + placed_plane
                    size = host_size
                else:
                    cnt = Y[I.y_ss_cnt[c]]
                    size = torch.zeros((), dtype=torch.int64, device=dev)
                    for d in range(I.ss_dnh[c]):
                        size = size + (ssc & (dom == d)).any().to(torch.int64)
                tp = F[fo["log"] + size]
                raw = raw + torch.where(
                    has_key, cnt * tp + fv("ss_skew_m1", c), zero)
            raw = torch.round(raw)
            any_sc = ssc.any()
            max_s = torch.where(ssc, raw, torch.full_like(raw, -np.inf)).max()
            min_s = torch.where(ssc, raw, torch.full_like(raw, np.inf)).min()
            max_s = torch.where(any_sc, max_s, zero[0])
            min_s = torch.where(any_sc, min_s, zero[0])
            out = torch.where(
                max_s == 0, torch.full_like(raw, 100.0),
                torch.floor(100.0 * (max_s + min_s - raw)
                            / torch.maximum(max_s, tiny)))
            total = total + float(I.w_spread) * torch.where(ssc, out, zero)

        if I.w_ipa:
            raw = C[I.c_ipa_static_pref] if I.c_ipa_static_pref >= 0 else zero
            if I.ipa_pref_on:
                for gi in range(I.g):
                    raw = raw + torch.where(C[I.c_ipa_dom[gi]] >= 0,
                                            Y[I.y_pref_cnt[gi]], zero)
            max_s = torch.where(scorable, raw,
                                torch.full_like(raw, -np.inf)).max()
            min_s = torch.where(scorable, raw,
                                torch.full_like(raw, np.inf)).min()
            diff = max_s - min_s
            norm = torch.where(
                diff > 0,
                torch.floor(100.0 * (raw - min_s)
                            / torch.where(diff > 0, diff, one)), zero)
            total = total + float(I.w_ipa) * torch.where(scorable, norm, zero)

        # ---- host selection (argmax, lowest index wins) ------------------
        keyed = torch.where(scorable, total, torch.full_like(total, -1.0))
        gmax = keyed.max()
        cand = torch.where((keyed == gmax) & real, iota,
                           torch.full_like(iota, n))
        chosen = cand.min()
        chosen = torch.where(chosen >= n, torch.zeros_like(chosen), chosen)

        place = any_feasible & ~(stopped > 0.5)
        gate = place.to(f32)
        onehot = ((iota == chosen) & real).to(f32) * gate

        # ---- commit ------------------------------------------------------
        Y2 = list(Y)
        for j in range(I.r):
            rv = Fh[fo["req_vec"] + j]
            yj = I.y_requested[j]
            if I.dra_shared_colocate and Fh[fo["shared_req_vec"] + j]:
                rvj = fv("req_vec", j) + torch.where(
                    placed_count == 0, fv("shared_req_vec", j), zero[0])
                Y2[yj] = Y[yj] + onehot * rvj
            elif rv != 0.0:
                Y2[yj] = Y[yj] + onehot * fv("req_vec", j)
        if Fh[fo["req_nonzero"]]:
            Y2[I.y_nonzero0] = Y[I.y_nonzero0] + onehot * fv("req_nonzero", 0)
        if Fh[fo["req_nonzero"] + 1]:
            Y2[I.y_nonzero1] = Y[I.y_nonzero1] + onehot * fv("req_nonzero", 1)
        Y2[I.y_placed] = Y[I.y_placed] + onehot

        for rows, doms, countables, selfs, count in (
                (I.y_sh_cnt, I.c_sh_dom, I.c_sh_countable, I.sh_self, I.ch),
                (I.y_ss_cnt, I.c_ss_dom, I.c_ss_countable, I.ss_self, I.cs)):
            for c in range(count):
                if not selfs[c]:
                    continue
                dom = C[doms[c]]
                dom_ch = (onehot * dom).sum()
                countable_ch = (onehot * C[countables[c]]).sum()
                inc = countable_ch * gate
                hit = (dom == dom_ch) & (dom >= 0)
                Y2[rows[c]] = Y[rows[c]] + hit.to(f32) * inc

        new_aff_total = aff_total
        if I.ipa_aff_on or I.ipa_anti_on or I.ipa_pref_on:
            for gi in range(I.g):
                dom = C[I.c_ipa_dom[gi]]
                dom_ch = (onehot * dom).sum() + torch.where(
                    onehot.sum() > 0, zero[0], -one)
                valid = (dom_ch >= 0).to(f32)
                hit = ((dom == dom_ch) & (dom >= 0)).to(f32)
                if I.ipa_aff_on and Fh[fo["aff_ginc"] + gi]:
                    inc = fv("aff_ginc", gi) * valid * gate
                    Y2[I.y_aff_cnt[gi]] = Y[I.y_aff_cnt[gi]] + hit * inc
                    new_aff_total = new_aff_total + inc
                if I.ipa_anti_on and Fh[fo["anti_ginc"] + gi]:
                    inc = fv("anti_ginc", gi) * valid * gate
                    Y2[I.y_anti_cnt[gi]] = Y[I.y_anti_cnt[gi]] + hit * inc
                if I.ipa_pref_on and Fh[fo["pref_gw"] + gi]:
                    inc = fv("pref_gw", gi) * valid * gate
                    Y2[I.y_pref_cnt[gi]] = Y[I.y_pref_cnt[gi]] + hit * inc

        chosen_out.append(torch.where(place, chosen,
                                      torch.full_like(chosen, -1)))
        new_stopped = torch.maximum(stopped, (~any_feasible).to(f32))
        next_start = torch.where(stopped > 0.5, next_start, new_next_start)
        Y = Y2
        placed_count = placed_count + gate
        stopped = new_stopped
        aff_total = new_aff_total

    carry_out = torch.stack(Y).reshape(carry.shape)
    scalars_out = torch.stack([placed_count, stopped, next_start,
                               aff_total]).reshape(1, 4)
    chosen = torch.stack(chosen_out).to(torch.int32).reshape(k, 1)
    return carry_out, scalars_out, chosen


def _piecewise(util: torch.Tensor, I: _Ints, F: torch.Tensor) -> torch.Tensor:
    """ops.node_resources_fit.piecewise_shape on the table's float32 shape
    constants (so the plain version reads what the kernel reads)."""
    fo = FOFF
    out = torch.zeros_like(util) + F[fo["shape_y0"]]
    for i in range(I.n_seg):
        x_lo, x_hi = F[fo["seg_xlo"] + i], F[fo["seg_xhi"] + i]
        q = F[fo["seg_dy"] + i] * (util - x_lo) / F[fo["seg_dx"] + i]
        seg = F[fo["seg_ylo"] + i] + torch.trunc(q)
        out = torch.where((util > x_lo) & (util <= x_hi), seg, out)
    return torch.where(util > F[fo["shape_xlast"]],
                       torch.zeros_like(util) + F[fo["shape_ylast"]], out)


# ---------------------------------------------------------------------------
# The launch plan (the counterpart of the JAX package's vmem_ok)
# ---------------------------------------------------------------------------

SMEM_PER_CTA = 232_448       # shared memory one CTA may use on an H100
SMEM_STATIC = 5120           # kept for the kernel's static shared memory
SMEM_DYNAMIC = SMEM_PER_CTA - SMEM_STATIC
CLUSTER_SIZES = (1, 2, 4, 8, 16)
N_SM = 132                   # a group of B clusters of C: B * C <= N_SM
MAX_THREADS = 1024
# One template's cluster size (launch_plan, b == 1), read off kernel 1's
# time per step over node counts and cluster sizes on an H100
# (tools/cluster_grid.py):
ONE_CTA_LANES = 1536         # up to this, one CTA that holds every plane
TARGET_LANES = 384           # past it, the node lanes a CTA is cut down to


class LaunchPlan(NamedTuple):
    """How one template's node axis maps onto a cluster of CTAs."""

    cluster: int             # CTAs per template
    threads: int             # threads per CTA
    lanes: int               # node lanes of a CTA's slice (multiple of 128)
    slices: Tuple[Tuple[int, int], ...]   # [start, stop) lanes per rank
    resident_scratch: int    # planes in shared memory, in this order:
    resident_carry: int      #   scratch, carry, then const
    resident_const: int
    smem_bytes: int          # dynamic shared memory per CTA

    @property
    def resident(self) -> int:
        return self.resident_scratch + self.resident_carry \
            + self.resident_const

    def describe(self) -> str:
        return (f"cluster {self.cluster} x {self.threads} threads, "
                f"{self.lanes} lanes per CTA, resident {self.resident_scratch}"
                f" scratch + {self.resident_carry} carry + "
                f"{self.resident_const} const planes, {self.smem_bytes} "
                f"bytes of dynamic shared memory per CTA")


def launch_plan(npad: int, n_const: int, n_carry: int, b: int = 1,
                cluster: Optional[int] = None,
                slots: Optional[Dict[int, int]] = None) -> LaunchPlan:
    """The cluster size, block size, node slices and resident planes for a
    problem of npad node lanes, n_const const and n_carry carry planes, in a
    group of b templates.  `slots` maps each cluster size to the clusters of
    that size the card holds at once (default N_SM // C).  Of the
    CLUSTER_SIZES that the card schedules (and, for a group of b > 1, holds
    all b at once: one wave, b * C <= N_SM), the ones at which every plane
    fits in shared memory are the resident ones.  One template (b == 1)
    keeps a single CTA where that is resident and npad is at most
    ONE_CTA_LANES: a cluster's barriers, a few of them in every step, cost
    more than the node work they would split.  Past that it takes the
    smallest resident C whose CTAs hold at most TARGET_LANES node lanes
    each: once the planes fit, a step's time follows the node work of a
    CTA's threads, which a larger cluster splits.  A group takes the
    smallest resident C, its clusters sharing the card's SMs.  Where no
    resident C is small enough, or none is resident, the largest C, with
    the planes that do not fit left in device memory.  `cluster` forces C.
    Raises NotImplementedError for a shape the kernel does not take."""
    if npad <= 0 or npad % LANES:
        raise ValueError(f"npad must be a positive multiple of {LANES}, "
                         f"got {npad}")
    if npad > MAX_NODES:
        raise NotImplementedError(
            f"{npad} node lanes exceed the kernel's MAX_NODES = {MAX_NODES}")
    if not 0 < n_const <= MAX_CONST_PLANES:
        raise NotImplementedError(
            f"{n_const} const planes: the kernel takes 1 to "
            f"MAX_CONST_PLANES = {MAX_CONST_PLANES}")
    if not 0 < n_carry <= MAX_CARRY_PLANES:
        raise NotImplementedError(
            f"{n_carry} carry planes: the kernel takes 1 to "
            f"MAX_CARRY_PLANES = {MAX_CARRY_PLANES}")
    if b < 1:
        raise ValueError(f"b must be >= 1, got {b}")
    rows = npad // LANES
    total = SCRATCH_PLANES + n_carry + n_const

    def lanes_of(c):
        return -(-rows // c) * LANES

    if slots is None:
        slots = {c: N_SM // c for c in CLUSTER_SIZES}
    if cluster is None:
        sizes = [c for c in CLUSTER_SIZES if slots.get(c, 0) >= 1
                 and (b == 1 or (b * c <= N_SM and b <= slots[c]))] or [1]
        cluster = next((c for c in sizes
                        if total * 4 * lanes_of(c) <= SMEM_DYNAMIC
                        and (b > 1 or lanes_of(c) <= TARGET_LANES
                             or c == 1 and npad <= ONE_CTA_LANES)),
                       sizes[-1])
    elif cluster not in CLUSTER_SIZES:
        raise ValueError(f"cluster must be one of {CLUSTER_SIZES}, got "
                         f"{cluster}")
    lanes = lanes_of(cluster)
    n_res = min(total, SMEM_DYNAMIC // (4 * lanes))
    res_scratch = min(SCRATCH_PLANES, n_res)
    res_carry = min(n_carry, n_res - res_scratch)
    res_const = n_res - res_scratch - res_carry
    slices = tuple((min(r * lanes, npad), min((r + 1) * lanes, npad))
                   for r in range(cluster))
    return LaunchPlan(cluster=cluster, threads=min(MAX_THREADS, lanes),
                      lanes=lanes, slices=slices,
                      resident_scratch=res_scratch, resident_carry=res_carry,
                      resident_const=res_const,
                      smem_bytes=4 * lanes * n_res)


# ---------------------------------------------------------------------------
# The CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "fused_steps.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-prec-div=true", "-prec-sqrt=true",
              "-ftz=false", "-shared", "-Xcompiler", "-fPIC")
_UNSCHEDULABLE = -1           # the launch functions' "no such cluster" code

LAUNCHES = 0          # kernel launches (not plain-version calls)
LAST_PLAN: Optional[LaunchPlan] = None    # the plan of the last launch
_lib = None
_slots: Optional[Dict[int, int]] = None
_lib_lock = threading.Lock()


def build_dir() -> str:
    """Where the shared library is built: CC_TORCH_BUILD_DIR, else build/
    at the checkout's root (listed in .gitignore)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.environ.get("CC_TORCH_BUILD_DIR",
                          os.path.join(root, "build", "kernels"))


def _layout_header() -> str:
    lines = ["// generated from engine/fused.py INT_FIELDS / FLOAT_FIELDS",
             "#pragma once",
             f"#define MAX_R {MAX_R}", f"#define MAX_SPREAD {MAX_SPREAD}",
             f"#define MAX_GROUPS {MAX_GROUPS}", f"#define MAX_SEG {MAX_SEG}",
             f"#define IDX_PODS {IDX_PODS}", f"#define IDX_CPU {IDX_CPU}",
             f"#define FIT_MOST {FIT_MOST}", f"#define FIT_RTC {FIT_RTC}",
             f"#define TABLE_INT_WIDTH {INT_WIDTH}", f"#define LANES {LANES}",
             f"#define MAX_CONST_PLANES {MAX_CONST_PLANES}",
             f"#define MAX_CARRY_PLANES {MAX_CARRY_PLANES}",
             f"#define SCRATCH_PLANES {SCRATCH_PLANES}"]
    lines += [f"#define IT_{k.upper()} {v}" for k, v in IOFF.items()]
    lines += [f"#define FT_{k.upper()} {v}" for k, v in FOFF.items()]
    return "\n".join(lines) + "\n"


def build() -> str:
    """Compile csrc/fused_steps.cu with nvcc into build_dir() when the
    source or the table layout changed; returns the library path.  The
    compiler's ptxas report is kept beside the library (`ptxas_report`)."""
    header = _layout_header()
    with open(_SRC, "rb") as f:
        src = f.read()
    digest = hashlib.sha256(src + header.encode()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = build_dir()
    lib = os.path.join(out_dir, f"libfused_steps_{digest}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "fused_layout.h"), "w") as f:
        f.write(header)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-I", out_dir, "-o", tmp, _SRC]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    with open(lib + ".ptxas.txt", "w") as f:
        f.write(proc.stderr)
    os.replace(tmp, lib)
    return lib


def ptxas_report() -> List[str]:
    """The ptxas lines of the current build: per entry, its registers,
    shared memory and spill bytes."""
    path = build() + ".ptxas.txt"
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [ln.strip() for ln in f
                if any(w in ln for w in ("Compiling entry", "registers",
                                         "spill", "smem"))]


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            from ..obs import recompile
            t0 = time.perf_counter()
            lib = ctypes.CDLL(build())
            recompile.record_compile(time.perf_counter() - t0)
            fn = lib.fused_steps_launch
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fn = lib.fused_steps_batched_launch
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            lib.fused_steps_active_clusters.argtypes = [ctypes.c_int] * 3
            lib.fused_steps_active_clusters.restype = ctypes.c_int
            lib.fused_steps_static_smem.argtypes = []
            lib.fused_steps_static_smem.restype = ctypes.c_int
            static = lib.fused_steps_static_smem()
            if static < 0:
                raise RuntimeError(f"fused_steps: CUDA error {-static} "
                                   f"reading the kernels' attributes")
            if static > SMEM_STATIC:
                raise RuntimeError(
                    f"fused_steps: the kernels use {static} bytes of static "
                    f"shared memory, more than SMEM_STATIC = {SMEM_STATIC}")
            _lib = lib
    return _lib


def cluster_slots() -> Dict[int, int]:
    """For each of CLUSTER_SIZES, the clusters of full blocks with the whole
    dynamic shared-memory budget that the card holds at once (asked once)."""
    global _slots
    lib = _load()
    if _slots is None:
        slots = {}
        for c in CLUSTER_SIZES:
            n = lib.fused_steps_active_clusters(c, MAX_THREADS, SMEM_DYNAMIC)
            if n < 0:
                raise RuntimeError(f"fused_steps: CUDA error {-n} asking the "
                                   f"card about clusters of {c} CTAs")
            slots[c] = n
        if slots[1] < 1:
            raise RuntimeError("fused_steps: the card schedules no "
                               f"{MAX_THREADS}-thread CTA with "
                               f"{SMEM_DYNAMIC} bytes of shared memory")
        _slots = slots
    return _slots


def max_cluster() -> int:
    """The largest of CLUSTER_SIZES the card schedules."""
    return max(c for c, n in cluster_slots().items() if n >= 1)


def card_plan(npad: int, n_const: int, n_carry: int, b: int = 1,
              cluster: Optional[int] = None) -> LaunchPlan:
    """launch_plan with the card's cluster slots."""
    return launch_plan(npad, n_const, n_carry, b, cluster, cluster_slots())


def _check_launch(err: int, what: str, plan: LaunchPlan) -> None:
    if err == _UNSCHEDULABLE:
        raise RuntimeError(f"{what}: the card cannot schedule {plan.describe()}")
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"({plan.describe()})")


def fused_steps(const: torch.Tensor, carry: torch.Tensor,
                scalars: torch.Tensor, table: KernelTable, k: int,
                cluster: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K fused placement steps.  CUDA tensors run the kernel (one launch on
    the current stream, no sync) on the launch plan's cluster, or on
    `cluster` CTAs where given; CPU tensors run fused_steps_reference.
    Returns (carry_out, scalars_out, chosen) as fused_steps_reference."""
    if const.device.type == "cpu":
        return fused_steps_reference(const, carry, scalars, table, k)
    if const.device.type != "cuda":
        raise ValueError(f"fused_steps: unsupported device {const.device}")
    global LAUNCHES, LAST_PLAN
    _check_args(const, carry, scalars, table, k)
    lib = _load()
    npad = const.shape[1] * LANES
    plan = card_plan(npad, const.shape[0], carry.shape[0], 1, cluster)
    carry_out = torch.empty_like(carry)
    scalars_out = torch.empty_like(scalars)
    chosen = torch.empty((k, 1), dtype=torch.int32, device=const.device)
    # per-step node scratch of the planes that are not resident
    scratch = torch.empty((SCRATCH_PLANES, npad), dtype=torch.float32,
                          device=const.device)
    stream = torch.cuda.current_stream(const.device).cuda_stream
    err = lib.fused_steps_launch(
        const.data_ptr(), carry.data_ptr(), scalars.data_ptr(),
        table.i.data_ptr(), table.f.data_ptr(), carry_out.data_ptr(),
        scalars_out.data_ptr(), chosen.data_ptr(), scratch.data_ptr(),
        int(k), int(const.shape[1]), int(const.shape[0]),
        int(carry.shape[0]), plan.cluster, plan.threads, plan.lanes,
        plan.resident, plan.smem_bytes, stream)
    _check_launch(err, "fused_steps", plan)
    LAUNCHES += 1
    LAST_PLAN = plan
    return carry_out, scalars_out, chosen

"""Closed-form fast path: the whole greedy simulation as one sort.

For the plugin configurations where a node's total score depends only on
that node's own placement count (no spread, no inter-pod affinity, no
sampling, uniform taint/node-affinity raw scores), the greedy trace is fully
determined by the score matrix S[n, k] = total score of node n when it
hosts its (k+1)-th clone:

- when every row is non-increasing in k (checked numerically), the greedy
  argmax sequence is the descending merge of the N rows, i.e. ALL (n, k)
  pairs sorted by (score desc, node asc, k asc).  The flat index is
  node-major, so a STABLE sort on -score yields exactly that order — the
  same (max score, lowest node index) rule the fused step applies;
- capacity is the number of pairs with k < cap_n (the fit bound), clipped
  by max_limit.

The JAX package's jitted score builders (_fast_solve_device,
_fast_batch_device) are plain torch functions here, run on the problem's
device; the score arithmetic is op for op theirs in the profile's dtype
(float32, or float64 under parity; ops/node_resources_fit.py), and
selection is torch.sort(stable=True), never topk (whose tie order is
unspecified).  Results equal the engine's (simulator.solve) whenever the
path answers; it returns None otherwise and the caller runs the engine.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from . import encode as enc
from . import simulator as sim
from ..models.snapshot import IDX_CPU, IDX_PODS
from ..ops import node_resources_fit as fit_ops


def _uniform_on_eligible(pb: enc.EncodedProblem, raw: np.ndarray
                         ) -> Optional[float]:
    """The single raw value `raw` takes over statically-eligible nodes, or
    None when it varies.  DefaultNormalizeScore runs over the per-step
    feasible set, which only shrinks within the static mask, so uniformity
    there makes the normalized contribution a per-step constant."""
    mask = np.asarray(pb.static_mask) & np.asarray(pb.volume_mask)
    vals = np.asarray(raw)[mask]
    if vals.size == 0:
        return 0.0
    first = float(vals[0])
    return first if bool((vals == first).all()) else None


def _structural_eligible(pb: enc.EncodedProblem) -> bool:
    """Filter/score structure the closed form can express at all (no
    carried cross-node state)."""
    profile = pb.profile
    if not profile.deterministic:
        return False
    if pb.pod_level_reason is not None:
        return False
    if pb.spread_hard.num_constraints or pb.spread_soft.num_constraints:
        return False
    if pb.ipa.active:
        return False
    if pb.clone_has_host_ports or pb.volume_self_conflict \
            or pb.rwop_self_conflict:
        return False
    if pb.dra_shared_colocate:
        return False
    if sim._num_feasible_nodes_to_find(profile, pb.num_alive) > 0:
        return False
    return True


def eligible(pb: enc.EncodedProblem) -> bool:
    """Static eligibility: every active score is a pure per-node function of
    that node's own placement count, every filter static-or-fit, and the
    taint / node-affinity raw scores uniform over the eligible nodes."""
    if not _structural_eligible(pb):
        return False
    profile = pb.profile
    if profile.score_weight("TaintToleration") \
            and _uniform_on_eligible(pb, pb.taint_raw) is None:
        return False
    if profile.score_weight("NodeAffinity") and pb.node_affinity_active \
            and _uniform_on_eligible(pb, pb.node_affinity_raw) is None:
        return False
    return True


def eligible_limited(pb: enc.EncodedProblem) -> bool:
    """Eligibility for the bounded batched solve: taint/NA raw uniformity is
    not required — _fast_batch_chunk proves per template that the
    normalized vector stays constant for the run, or falls back."""
    return _structural_eligible(pb)


def _static_normalized(raw: np.ndarray, caps: np.ndarray, budget: int,
                       reverse: bool, dt) -> Optional[np.ndarray]:
    """DefaultNormalizeScore of a STATIC raw vector, exact for a bounded run:
    the feasible max is constant while a max-raw node stays feasible, and a
    node with cap >= budget never fills within the run.  None when no
    max-raw node has cap >= budget."""
    feas = caps > 0
    raw_dt = raw.astype(dt)
    hundred = np.asarray(100.0, dtype=dt)
    m = np.max(np.where(feas, raw_dt, np.asarray(0.0, dtype=dt))) \
        if raw_dt.size else np.asarray(0.0, dtype=dt)
    if m > 0:
        holders = feas & (raw_dt == m)
        if not bool((caps[holders] >= budget).any()):
            return None
        scaled = np.floor(hundred * raw_dt / m)
        if reverse:
            scaled = hundred - scaled
    else:
        scaled = np.full_like(raw_dt, 100.0) if reverse else raw_dt
    return scaled


def _per_node_caps(pb: enc.EncodedProblem) -> np.ndarray:
    """Max clones each node can take under the fit filter (and pod slots)."""
    free = pb.allocatable - pb.init_requested
    caps = np.maximum(pb.allocatable[:, IDX_PODS]
                      - pb.init_requested[:, IDX_PODS], 0.0)
    if pb.profile.filter_enabled("NodeResourcesFit"):
        for j in range(pb.req_vec.shape[0]):
            if j != IDX_PODS and pb.req_vec[j] > 0:
                caps = np.minimum(caps, np.floor(
                    np.maximum(free[:, j], 0.0) / pb.req_vec[j]))
    else:
        caps = np.minimum(caps, 0.0)  # without fit there is no safe bound
    caps = np.where(pb.static_mask & pb.volume_mask, caps, 0.0)
    return caps.astype(np.int64)


# k-axis floor: caps are clipped to max(budget, _K_FLOOR) before the
# power-of-two rounding.  Selection is clip-independent (rows are monotone
# and the sort is stable, so a (n, k) pair is picked only after its k
# lower-k predecessors), so the first `budget` picks equal those of any
# clip value >= budget.
_K_FLOOR = 1024
_ELEM_BUDGET = 1 << 27          # max B*N*K elements materialized per chunk


def _t(a, dev, dt) -> torch.Tensor:
    """float64 host operand -> a tensor of numpy dtype dt on dev (rounded
    once)."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, dtype=np.float64).astype(dt))).to(dev)


def _fit_scores(strategy: str, fit_shape, alloc, req, fit_w):
    if strategy == "MostAllocated":
        return fit_ops.most_allocated_score(alloc, req, fit_w)
    if strategy == "RequestedToCapacityRatio":
        return fit_ops.requested_to_capacity_ratio_score(
            alloc, req, fit_w, fit_shape[0], fit_shape[1])
    return fit_ops.least_allocated_score(alloc, req, fit_w)


def _desc_order(flat: torch.Tensor) -> torch.Tensor:
    """Indices of `flat` (last axis) by score desc, index asc: a stable sort
    of -flat.  Adding 0.0 folds -0.0 into +0.0, so zeros tie as they do in
    numpy's comparison sort and a radix sort on the card agrees."""
    return torch.sort(-flat + 0.0, dim=-1, stable=True).indices


def _fast_state(pb: enc.EncodedProblem) -> dict:
    """Host-side prep for the closed-form solve: static config, per-node
    caps, the float64 operands (nonzero-substituted fit bases, folded
    taint/NA constants, resolved plugin weights)."""
    cfg = sim.static_config(pb)
    profile = pb.profile
    dt = sim.np_dtype(profile)
    _z1 = np.zeros((1,), dtype=np.float64)
    _z2 = np.zeros((1, 1), dtype=np.float64)

    w_fit = float(profile.score_weight("NodeResourcesFit") or 0.0)
    alloc_f = base_f = _z2
    inc_f = freq = fit_w = _z1
    if w_fit:
        cols = list(cfg.fit_idx)
        alloc_f = pb.allocatable[:, cols].astype(np.float64)
        base_f = pb.init_requested[:, cols].astype(np.float64)
        inc_f = pb.req_vec[cols].astype(np.float64)
        freq = np.asarray(pb.fit_req, dtype=np.float64)
        # cpu/mem columns use NonZeroRequested (resource_allocation.go:85-91)
        for k, j in enumerate(cols):
            if cfg.fit_nz[k]:
                nzc = 0 if j == IDX_CPU else 1
                base_f[:, k] = pb.init_nonzero[:, nzc]
                inc_f[k] = pb.req_nonzero[nzc]
        fit_w = np.asarray(pb.fit_res_weights, dtype=np.float64)

    w_bal = float(profile.score_weight("NodeResourcesBalancedAllocation")
                  or 0.0)
    alloc_b = base_b = _z2
    inc_b = breq = _z1
    if w_bal:
        bcols = list(cfg.bal_idx)
        alloc_b = pb.allocatable[:, bcols].astype(np.float64)
        base_b = pb.init_requested[:, bcols].astype(np.float64)
        inc_b = pb.req_vec[bcols].astype(np.float64)
        breq = np.asarray(pb.balanced_req, dtype=np.float64)

    # TaintToleration / NodeAffinity fold to per-step constants (eligible()
    # proved raw uniformity): reverse-normalized uniform r>0 -> 0, r==0 ->
    # 100; forward-normalized r>0 -> 100, r==0 -> 0.
    w_t = float(profile.score_weight("TaintToleration") or 0.0)
    comp_t = 0.0
    if w_t:
        r = _uniform_on_eligible(pb, pb.taint_raw)
        comp_t = (100.0 if not r else 0.0) * w_t
    w_na = float(profile.score_weight("NodeAffinity") or 0.0)
    add_na = bool(w_na and pb.node_affinity_active)
    comp_na = 0.0
    if add_na:
        r = _uniform_on_eligible(pb, pb.node_affinity_raw)
        comp_na = (100.0 if r else 0.0) * w_na
    w_il = float(profile.score_weight("ImageLocality") or 0.0)
    il = np.asarray(pb.image_locality_score, dtype=np.float64) if w_il \
        else _z1

    caps_full = _per_node_caps(pb)
    return {
        "cfg": cfg, "dt": dt, "caps_full": caps_full,
        "total_cap": int(caps_full.sum()),
        "w_fit": w_fit, "w_bal": w_bal, "w_il": w_il,
        "add_t": bool(w_t), "add_na": add_na,
        "alloc_f": alloc_f, "base_f": base_f, "inc_f": inc_f,
        "freq": freq, "fit_w": fit_w,
        "alloc_b": alloc_b, "base_b": base_b, "inc_b": inc_b, "breq": breq,
        "t_c": comp_t, "na_c": comp_na, "il": il,
    }


def _fast_scores(st: dict, K: int, n: int, caps: np.ndarray, dev):
    """The JAX package's _fast_solve_device in torch: the [N, K] score
    matrix's monotonicity, the masked flat scores, and the weighted fit and
    balanced components ([N, K], None when the plugin is off) that explain
    gathers."""
    dt = st["dt"]
    t = lambda a: _t(a, dev, dt)
    tdt = torch.float64 if dt is np.float64 else torch.float32
    cfg = st["cfg"]
    k_axis = torch.arange(K, dtype=tdt, device=dev)
    total = torch.zeros((n, K), dtype=tdt, device=dev)
    comp_fit = comp_bal = None
    if st["w_fit"]:
        req = t(st["base_f"])[:, None, :] \
            + t(st["inc_f"])[None, None, :] * k_axis[None, :, None] \
            + t(st["freq"])[None, None, :]
        s = _fit_scores(cfg.fit_strategy_type, cfg.fit_shape,
                        t(st["alloc_f"])[:, None, :], req, t(st["fit_w"]))
        comp_fit = st["w_fit"] * s
        total = total + comp_fit
    if st["w_bal"]:
        req = t(st["base_b"])[:, None, :] \
            + t(st["inc_b"])[None, None, :] * k_axis[None, :, None] \
            + t(st["breq"])[None, None, :]
        a3 = t(st["alloc_b"])[:, None, :]
        comp_bal = st["w_bal"] * fit_ops.balanced_allocation_score(
            a3.expand(req.shape), req)
        total = total + comp_bal
    if st["add_t"]:
        total = total + t(st["t_c"])
    if st["add_na"]:
        total = total + t(st["na_c"])
    if st["w_il"]:
        total = total + t(st["il"])[:, None] * st["w_il"]
    valid = k_axis[None, :] < t(caps)[:, None]
    mono = bool(torch.where(valid[:, 1:], total[:, 1:] <= total[:, :-1],
                            True).all())
    neg_inf = torch.tensor(-np.inf, dtype=tdt, device=dev)
    return (mono, torch.where(valid, total, neg_inf).reshape(-1), comp_fit,
            comp_bal)


def solve_fast(pb: enc.EncodedProblem, max_limit: int = 0, device=None,
               explain: bool = False) -> Optional[sim.SolveResult]:
    """A SolveResult identical to simulator.solve()'s, or None when the
    problem is outside the closed form (the caller runs the kernel).

    With `explain`, the per-plugin components of the score matrix are
    gathered at the chosen (node, k) pairs for the why-here attribution,
    and the reconstructed terminal carry feeds the why-not reason codes —
    both equal to what the explain step computes step by step."""
    if not eligible(pb):
        return None
    n = pb.snapshot.num_nodes
    if n == 0:
        return None
    st = _fast_state(pb)
    total_cap = st["total_cap"]
    if total_cap == 0:
        return None           # nothing places: the kernel diagnoses exactly
    # the engine's budget, including its unlimited-run cap
    budget = total_cap if not max_limit else min(max_limit, total_cap)
    budget = min(budget, sim._DEFAULT_UNLIMITED_CAP)
    caps = np.minimum(st["caps_full"], max(budget, _K_FLOOR))
    K = 1 << max(0, int(caps.max()) - 1).bit_length()
    dev = sim.resolve_device(device)
    mono, flat, comp_fit, comp_bal = _fast_scores(st, K, n, caps, dev)
    if not mono:
        return None

    order = _desc_order(flat)[:budget]
    chosen_nodes = (order // K).cpu().numpy().astype(np.int64)
    placements = chosen_nodes.tolist()
    placed = len(placements)

    # The terminal carry, reconstructed once: the exhausted branch
    # diagnoses from it and explain computes the why-not codes from it.
    consts = carry = counts = None
    if explain or placed >= total_cap:
        consts = sim.build_consts(pb, dev)
        counts = np.bincount(placements, minlength=n)
        fdt = lambda a: torch.from_numpy(
            np.asarray(a).astype(st["dt"])).to(dev)
        carry = sim._init_carry(pb, consts)._replace(
            requested=fdt(pb.init_requested + np.outer(counts, pb.req_vec)),
            nonzero=fdt(pb.init_nonzero + np.outer(counts, pb.req_nonzero)),
            placed=torch.from_numpy(counts.astype(np.int32)).to(dev),
            placed_count=torch.full((), placed, dtype=torch.int32,
                                    device=dev),
            stopped=torch.ones((), dtype=torch.bool, device=dev))

    expl = None
    if explain:
        comp = {"NodeResourcesFit": comp_fit,
                "NodeResourcesBalancedAllocation": comp_bal}
        if st["add_t"]:
            comp["TaintToleration"] = st["t_c"]
        if st["add_na"]:
            comp["NodeAffinity"] = st["na_c"]
        if st["w_il"]:
            dt = st["dt"]
            comp["ImageLocality"] = st["il"].astype(dt) \
                * np.asarray(st["w_il"], dtype=dt)
        expl = _explain_fast(pb, st, consts, carry, comp, order,
                             chosen_nodes, caps, counts, placements)

    if max_limit and placed >= max_limit:
        return sim.SolveResult(
            placements=placements, placed_count=placed,
            fail_type=sim.FAIL_LIMIT_REACHED,
            fail_message=f"Maximum number of pods simulated: {max_limit}",
            node_names=pb.snapshot.node_names, explain=expl)
    if placed < total_cap:
        # the _DEFAULT_UNLIMITED_CAP clamp stopped us (kernel-drive message)
        return sim.SolveResult(
            placements=placements, placed_count=placed,
            fail_type=sim.FAIL_LIMIT_REACHED,
            fail_message=(f"Simulation step budget exhausted after "
                          f"{placed} placements; set max_limit to "
                          f"bound unlimited profiles"),
            node_names=pb.snapshot.node_names, explain=expl)

    # Exhausted capacity: diagnose from the reconstructed final state.
    reason_counts = sim.diagnose(pb, st["cfg"], consts, carry)
    return sim.SolveResult(
        placements=placements, placed_count=placed,
        fail_type=sim.FAIL_UNSCHEDULABLE,
        fail_message=sim.format_fit_error(n, reason_counts),
        fail_counts=reason_counts, node_names=pb.snapshot.node_names,
        explain=expl)


def _explain_fast(pb, st, consts, carry, comp, order, chosen_nodes, caps,
                  counts, placements):
    """The closed form's Explanation: why-here gathered from the score
    components at the chosen (node, k) pairs, why-not from the
    reconstructed terminal carry, elimination steps from the per-node fill
    times (a node leaves the feasible set at the step after its cap fills
    — there is no other elimination channel in a closed-form config)."""
    from ..explain import artifacts, attribution

    n = pb.snapshot.num_nodes
    dt = st["dt"]
    budget = chosen_nodes.shape[0]
    why_cols = []
    for name in artifacts.PLUGINS:
        v = comp.get(name)
        if v is None:
            why_cols.append(np.zeros((budget,), dtype=dt))
        elif isinstance(v, torch.Tensor):         # [N, K] score component
            why_cols.append(v.reshape(-1)[order].cpu().numpy())
        elif isinstance(v, np.ndarray):           # per-node static score
            why_cols.append(v[chosen_nodes])
        else:     # folded per-step constant (taint / node affinity)
            why_cols.append(np.full((budget,), v, dtype=dt))
    why_here = np.stack(why_cols, axis=1).astype(np.float64)

    codes, insufficient, too_many = attribution.final_codes(
        st["cfg"], attribution.explain_consts(pb, consts), carry)

    # Elimination record: caps == 0 nodes were never feasible (step 0); a
    # filled node is first seen infeasible at the step AFTER its last fill.
    elim_step = np.full(n, -1, dtype=np.int32)
    elim_code = np.zeros(n, dtype=np.int32)
    eliminated = codes != enc.CODE_OK
    elim_code[eliminated] = codes[eliminated]
    elim_step[eliminated & (caps == 0)] = 0
    filled = eliminated & (caps > 0) & (counts >= caps)
    if filled.any():
        cnt = np.zeros(n, dtype=np.int64)
        for t, node in enumerate(placements):
            cnt[node] += 1
            if filled[node] and cnt[node] == caps[node]:
                elim_step[node] = t + 1

    return artifacts.build_explanation(
        pb, why_here=why_here, final_codes=codes, elim_step=elim_step,
        elim_code=elim_code, insufficient=insufficient, too_many=too_many,
        rung="fast_path")


def solve_auto(pb: enc.EncodedProblem, max_limit: int = 0,
               device=None, bounds: bool = True,
               explain: bool = False) -> sim.SolveResult:
    """The closed form when exact, the engine (simulator.solve: kernel 1
    or the scan step, the explain step with `explain`) otherwise —
    identical results."""
    result = solve_fast(pb, max_limit=max_limit, device=device,
                        explain=explain)
    if result is not None:
        return result
    return sim.solve(pb, max_limit=max_limit, device=device, bounds=bounds,
                     explain=explain)


# --------------------------------------------------------------------------
# Batched closed form: B small-limit templates, one [B, N*K] stable sort
# --------------------------------------------------------------------------

def solve_fast_batched(pbs, max_limit: int, device=None
                       ) -> List[Optional[sim.SolveResult]]:
    """Solve B eligible templates (one group key) at a small max_limit.
    Returns a list aligned with pbs; None entries mean "solve alone"
    (capacity below the limit needs the exact diagnosis, or the
    normalization/monotonicity proof failed)."""
    out: List[Optional[sim.SolveResult]] = [None] * len(pbs)
    if not max_limit or max_limit <= 0 or not pbs:
        return out
    n = pbs[0].snapshot.num_nodes
    if n == 0:
        return out
    cfg = sim.static_config(pbs[0])
    dev = sim.resolve_device(device)

    caps_list, budgets, act = [], [], []
    for b, pb in enumerate(pbs):
        caps = _per_node_caps(pb)
        tc = int(caps.sum())
        if tc < max_limit:
            continue
        budget = min(max_limit, tc, sim._DEFAULT_UNLIMITED_CAP)
        caps_list.append(np.minimum(caps, budget))
        budgets.append(budget)
        act.append(b)
    if not act:
        return out

    k_hint = int(max(c.max() for c in caps_list))
    chunk = max(1, _ELEM_BUDGET // max(1, n * k_hint))
    for s in range(0, len(act), chunk):
        res = _fast_batch_chunk(
            [pbs[i] for i in act[s:s + chunk]], caps_list[s:s + chunk],
            budgets[s:s + chunk], cfg, max_limit, dev)
        for i, r in zip(act[s:s + chunk], res):
            out[i] = r
    return out


def _unique_rows(rows, n: int, dt):
    """Dedup per-template [N] vectors by identity/constant value: returns
    (unique [U, N] dt, idx i64[B]).  Entries are ('const', v) or a numpy
    vector (snapshot-memoized objects dedup by id)."""
    uniq: list = []
    keymap: dict = {}
    idx = np.zeros(len(rows), dtype=np.int64)
    for bi, r in enumerate(rows):
        key = r if isinstance(r, tuple) else id(r)
        u = keymap.get(key)
        if u is None:
            u = len(uniq)
            keymap[key] = u
            uniq.append(np.full(n, r[1], dtype=dt) if isinstance(r, tuple)
                        else np.asarray(r, dtype=dt))
        idx[bi] = u
    return np.stack(uniq), idx


def _fast_batch_scores(cfg, K: int, n: int, w: dict, ops: dict, caps, dev):
    """The JAX package's _fast_batch_device in torch: the [B, N, K] score
    tensor from shared [N, R] inputs and per-template [B, R] vectors, the
    per-template monotonicity, and the masked flat scores [B, N*K]."""
    dt = ops["dt"]
    t = lambda a: _t(a, dev, dt)
    tdt = torch.float64 if dt is np.float64 else torch.float32
    B = caps.shape[0]
    k_axis = torch.arange(K, dtype=tdt, device=dev)
    total = torch.zeros((B, n, K), dtype=tdt, device=dev)
    if w["fit"]:
        req = t(ops["base_f"])[None, :, None, :] \
            + t(ops["inc_f"])[:, None, None, :] \
            * k_axis[None, None, :, None] \
            + t(ops["freq"])[:, None, None, :]
        s = _fit_scores(cfg.fit_strategy_type, cfg.fit_shape,
                        t(ops["alloc_f"])[None, :, None, :], req,
                        t(ops["fit_w"]))
        total = total + w["fit"] * s
    if w["bal"]:
        req = t(ops["base_b"])[None, :, None, :] \
            + t(ops["inc_b"])[:, None, None, :] \
            * k_axis[None, None, :, None] \
            + t(ops["breq"])[:, None, None, :]
        a4 = t(ops["alloc_b"])[None, :, None, :]
        total = total + w["bal"] * fit_ops.balanced_allocation_score(
            a4.expand(req.shape), req)
    for name in ("t", "na"):
        if w[name]:
            rows = w[name] * torch.from_numpy(ops[f"{name}_u"]).to(dev)
            total = total + rows[torch.from_numpy(
                ops[f"{name}_ix"]).to(dev)][:, :, None]
    if w["il"]:
        rows = torch.from_numpy(ops["il_u"]).to(dev)[torch.from_numpy(
            ops["il_ix"]).to(dev)]
        total = total + rows[:, :, None] * w["il"]
    valid = k_axis[None, None, :] < torch.from_numpy(
        caps.astype(dt)).to(dev)[:, :, None]
    mono = torch.where(valid[:, :, 1:], total[:, :, 1:] <= total[:, :, :-1],
                       True).reshape(B, -1).all(dim=1)
    neg_inf = torch.tensor(-np.inf, dtype=tdt, device=dev)
    return mono, torch.where(valid, total, neg_inf).reshape(B, n * K)


def _fast_batch_chunk(sub, caps_list, budgets, cfg, max_limit: int, dev):
    B = len(sub)
    n = sub[0].snapshot.num_nodes
    K = int(max(c.max() for c in caps_list))
    profile = sub[0].profile
    dt = sim.np_dtype(profile)
    drop = [False] * B                   # per-template fallback to solve_auto
    _z1 = np.zeros((1,), dtype=np.float64)
    _z2 = np.zeros((1, 1), dtype=np.float64)
    _zi = np.zeros(B, dtype=np.int64)
    ops = {"dt": dt, "alloc_f": _z2, "base_f": _z2, "inc_f": _z2,
           "freq": _z2, "fit_w": _z1, "alloc_b": _z2, "base_b": _z2, "inc_b": _z2,
           "breq": _z2}

    w = {"fit": float(profile.score_weight("NodeResourcesFit") or 0.0)}
    if w["fit"]:
        cols = list(cfg.fit_idx)
        if not _shared_columns(sub, cols):
            return [None] * B             # virtual-column divergence: rare
        pb0 = sub[0]
        base_f = pb0.init_requested[:, cols].astype(np.float64)
        inc_f = np.stack([pb.req_vec[cols] for pb in sub]).astype(np.float64)
        for k, j in enumerate(cols):
            if cfg.fit_nz[k]:
                nzc = 0 if j == IDX_CPU else 1
                base_f[:, k] = pb0.init_nonzero[:, nzc]
                for bi, pb in enumerate(sub):
                    inc_f[bi, k] = pb.req_nonzero[nzc]
        ops.update(
            alloc_f=pb0.allocatable[:, cols].astype(np.float64),
            base_f=base_f, inc_f=inc_f,
            freq=np.stack([pb.fit_req for pb in sub]).astype(np.float64),
            fit_w=np.asarray(pb0.fit_res_weights, dtype=np.float64))

    w["bal"] = float(profile.score_weight("NodeResourcesBalancedAllocation")
                     or 0.0)
    if w["bal"]:
        bcols = list(cfg.bal_idx)
        if not _shared_columns(sub, bcols):
            return [None] * B
        pb0 = sub[0]
        ops.update(
            alloc_b=pb0.allocatable[:, bcols].astype(np.float64),
            base_b=pb0.init_requested[:, bcols].astype(np.float64),
            inc_b=np.stack([pb.req_vec[bcols]
                            for pb in sub]).astype(np.float64),
            breq=np.stack([pb.balanced_req
                           for pb in sub]).astype(np.float64))

    # ---- static per-node score rows, deduped by identity/constant --------
    norm_cache: dict = {}

    def _row_entries(raw_of, reverse: bool, active_of):
        entries = []
        for bi, pb in enumerate(sub):
            if not active_of(pb):
                entries.append(("const", 0.0))
                continue
            raw = raw_of(pb)
            r = _uniform_on_eligible(pb, raw)
            if r is not None:
                on = (not r) if reverse else bool(r)
                entries.append(("const", 100.0 if on else 0.0))
                continue
            sn = _static_normalized(raw, caps_list[bi], budgets[bi],
                                    reverse=reverse, dt=dt)
            if sn is None:
                drop[bi] = True
                entries.append(("const", 0.0))
            else:
                key = (id(raw), reverse)
                cached = norm_cache.get(key)
                if cached is not None and np.array_equal(cached, sn):
                    sn = cached            # stable id across templates
                else:
                    norm_cache[key] = sn
                entries.append(sn)
        return entries

    w["t"] = float(profile.score_weight("TaintToleration") or 0.0)
    ops["t_u"], ops["t_ix"] = (_z2, _zi)
    if w["t"]:
        ops["t_u"], ops["t_ix"] = _unique_rows(
            _row_entries(lambda pb: pb.taint_raw, True, lambda pb: True),
            n, dt)
    w["na"] = float(profile.score_weight("NodeAffinity") or 0.0)
    ops["na_u"], ops["na_ix"] = (_z2, _zi)
    if w["na"]:
        ops["na_u"], ops["na_ix"] = _unique_rows(
            _row_entries(lambda pb: pb.node_affinity_raw, False,
                         lambda pb: pb.node_affinity_active), n, dt)
    w["il"] = float(profile.score_weight("ImageLocality") or 0.0)
    ops["il_u"], ops["il_ix"] = (_z2, _zi)
    if w["il"]:
        ops["il_u"], ops["il_ix"] = _unique_rows(
            [pb.image_locality_score for pb in sub], n, dt)

    caps = np.stack(caps_list).astype(np.int32)
    m = min(max_limit, n * K)
    # the k extent rounds up to a power of two: padded slots mask to -inf and
    # the node-major flat order is unchanged, so selection is unaffected
    K = 1 << max(0, K - 1).bit_length()
    mono, flat = _fast_batch_scores(cfg, K, n, w, ops, caps, dev)
    chosen = (_desc_order(flat)[:, :m] // K).cpu().numpy()
    mono = mono.cpu().numpy()

    results = []
    for bi, pb in enumerate(sub):
        if drop[bi] or not bool(mono[bi]) or budgets[bi] < max_limit:
            results.append(None)
            continue
        placements = chosen[bi, :budgets[bi]].astype(np.int64).tolist()
        results.append(sim.SolveResult(
            placements=placements, placed_count=len(placements),
            fail_type=sim.FAIL_LIMIT_REACHED,
            fail_message=f"Maximum number of pods simulated: {max_limit}",
            node_names=pb.snapshot.node_names))
    return results


def _shared_columns(sub, cols) -> bool:
    """True when every template's allocatable/init_requested (restricted to
    the selected strategy columns) and init_nonzero agree — the condition
    for passing them to the device once, unbatched."""
    pb0 = sub[0]
    for pb in sub[1:]:
        for fld in ("allocatable", "init_requested"):
            a, b = getattr(pb, fld), getattr(pb0, fld)
            if a is not b and not np.array_equal(a[:, cols], b[:, cols]):
                return False
        a, b = pb.init_nonzero, pb0.init_nonzero
        if a is not b and not np.array_equal(a, b):
            return False
    return True

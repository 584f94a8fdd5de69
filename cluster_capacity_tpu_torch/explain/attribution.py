"""Device-side attribution: why-not reason codes and why-here score terms
computed inside the scan step.

The explain step takes the scan step's own decision (`simulator._decide`:
filters, sampling, the summed score terms, the argmax and the commit), so
its placements equal `_step`'s by construction, and additionally emits:

- the chosen node's per-plugin weighted contribution (why-here), gathered
  from the very terms the argmax summed (no second scoring pass), and
- a sticky per-node elimination record (why-not): the reason code of each
  node's first failing plugin in diagnose() priority order, plus the step
  at which it first became infeasible.

It runs under the scan step's drive (`simulator.run_steps`): eagerly on the
CPU, as CUDA-graph replays on the card with no host sync inside a chunk.
The why-here rows and the elimination record stay on the device; the
solve reads them back at the chunk's existing sync.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..engine import encode as enc
from ..engine import simulator as sim
from .artifacts import PLUGINS


class ExplainState(NamedTuple):
    carry: sim.Carry
    elim_step: torch.Tensor   # i32[N]: step of first elimination, -1 = never
    elim_code: torch.Tensor   # i32[N]: reason code at first elimination
    step: torch.Tensor        # i32[]: global step counter


def init_state(carry: sim.Carry) -> ExplainState:
    n = carry.placed.shape[0]
    dev = carry.placed.device
    return ExplainState(
        carry=carry,
        elim_step=torch.full((n,), -1, dtype=torch.int32, device=dev),
        elim_code=torch.zeros((n,), dtype=torch.int32, device=dev),
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


def reason_codes(cfg: sim.StaticConfig, consts, carry: sim.Carry, parts,
                 static_code: torch.Tensor) -> torch.Tensor:
    """Per-node first-fail reason code, stamped in diagnose() priority
    order: static codes -> dynamic ports -> fit -> volume -> volume self
    conflict -> RWOP -> DRA colocation -> spread (missing label / skew) ->
    inter-pod affinity.  A node keeps the code of the FIRST plugin that
    rejected it (codes only stamp where the slot is still CODE_OK), exactly
    like diagnose()'s `remaining` fold — so expanding these codes on the
    host reproduces its histogram."""
    codes = static_code

    def stamp(codes, mask, code):
        return torch.where((codes == enc.CODE_OK) & mask,
                           torch.full_like(codes, code), codes)

    if "ports_dyn" in parts:
        codes = stamp(codes, ~parts["ports_dyn"], enc.CODE_PORTS)
    fit = parts.get("fit")
    if fit is not None:
        codes = stamp(codes, ~fit.mask, enc.CODE_FIT)
    codes = stamp(codes, ~consts["volume_mask"], enc.CODE_VOLUME)
    placed = carry.placed > 0
    if cfg.volume_self_conflict:
        codes = stamp(codes, placed, enc.CODE_VOLUME_SELF)
    if cfg.rwop_self_conflict:
        codes = stamp(codes, (carry.placed_count > 0).expand(codes.shape),
                      enc.CODE_RWOP)
    if cfg.dra_shared_colocate:
        codes = stamp(codes, ~placed & (carry.placed_count > 0),
                      enc.CODE_DRA)
    if "spread_missing" in parts:
        codes = stamp(codes, parts["spread_missing"],
                      enc.CODE_SPREAD_MISSING_LABEL)
    if "spread_ok" in parts:
        codes = stamp(codes, ~parts["spread_ok"], enc.CODE_SPREAD)
    if "ipa" in parts:
        f_aff, f_anti, f_eanti = parts["ipa"]
        codes = stamp(codes, f_aff, enc.CODE_IPA_AFFINITY)
        codes = stamp(codes, f_anti, enc.CODE_IPA_ANTI)
        codes = stamp(codes, f_eanti, enc.CODE_IPA_EXISTING_ANTI)
    return codes


def _gather_contribs(cfg: sim.StaticConfig, terms, chosen: torch.Tensor,
                     place: torch.Tensor) -> torch.Tensor:
    """[len(PLUGINS)] weighted contribution of the chosen node, zero for
    inactive plugins and for no-op (post-stop / infeasible) steps."""
    dt = sim._dt(cfg)
    gate = place.to(dt)
    by_name = dict(terms)
    zero = torch.zeros(1, dtype=dt, device=chosen.device)
    cols = [zero if by_name.get(name) is None
            else by_name[name].index_select(0, chosen.reshape(1)) * gate
            for name in PLUGINS]
    return torch.cat(cols)


def _explain_step(cfg: sim.StaticConfig, consts, static_code: torch.Tensor,
                  state: ExplainState):
    """simulator._step with attribution outputs: (state, (chosen or -1,
    why-here row)).  The decision is simulator._decide's, the one the scan
    step takes, so the chosen sequence is identical."""
    carry = state.carry
    d = sim._decide(cfg, consts, carry)
    codes = reason_codes(cfg, consts, carry, d.parts, static_code)
    contrib = _gather_contribs(cfg, d.terms, d.chosen, d.place)

    # Sticky elimination record: stamp nodes newly eliminated this step
    # (while the solve was still live — post-stop states are frozen).
    newly = ((state.elim_code == enc.CODE_OK) & (codes != enc.CODE_OK)
             & ~carry.stopped)
    elim_code = torch.where(newly, codes, state.elim_code)
    elim_step = torch.where(newly, state.step, state.elim_step)
    new_state = ExplainState(carry=d.carry, elim_step=elim_step,
                             elim_code=elim_code, step=state.step + 1)
    return new_state, (torch.where(d.place, d.chosen, -1).to(torch.int32),
                       contrib)


def _graph_step(cfg: sim.StaticConfig, consts, state: ExplainState):
    """_explain_step with the static codes read from consts["static_code"]
    (the signature simulator.run_steps drives)."""
    return _explain_step(cfg, consts, consts["static_code"], state)


def explain_consts(pb: enc.EncodedProblem, consts) -> dict:
    """The step's consts plus the problem's static codes (int32[N]) on the
    same device; build once per solve, so graph replays never re-copy
    them."""
    dev = consts["static_mask"].device
    return {**consts, "static_code": torch.tensor(
        pb.static_code, dtype=torch.int32, device=dev)}


def run_chunk(cfg: sim.StaticConfig, consts, state: ExplainState, k: int):
    """K explain steps from `state` (consts from explain_consts): (state,
    (chosen int32[K], why-here [K, len(PLUGINS)])).  Eager on the CPU, CUDA
    graph replays on the card, with no host sync inside the chunk."""
    return sim.run_steps(_graph_step, cfg, consts, state, k)


def final_codes(cfg: sim.StaticConfig, consts, carry: sim.Carry):
    """Terminal why-not at a stopping carry, as host arrays: reason codes
    (consts from explain_consts) plus the fit detail masks (per-resource
    insufficiency / pod-slot overflow).  Works for ANY rung's terminal
    carry — the scan step's live carry, the closed form's reconstruction,
    a template's slice of kernel 2's batched carry."""
    _feasible, parts = sim._feasibility(cfg, consts, carry)
    codes = reason_codes(cfg, consts, carry, parts, consts["static_code"])
    fit = parts.get("fit")
    n = codes.shape[0]
    if fit is not None:
        insufficient, too_many = fit.insufficient, fit.too_many_pods
    else:
        insufficient = torch.zeros((n, 1), dtype=torch.bool)
        too_many = torch.zeros((n,), dtype=torch.bool)
    return (codes.cpu().numpy(), insufficient.cpu().numpy(),
            too_many.cpu().numpy())

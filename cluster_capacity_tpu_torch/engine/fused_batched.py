"""Batched fused placement kernel: a template group, one launch.

A what-if sweep solves many templates against one snapshot.  The batched
entry of csrc/fused_steps.cu (`fused_steps_batched_kernel`) runs one
thread-block cluster per template, each cluster K fused greedy steps on its
own slab of planes with its own row of the int and float tables — the
single-template step body on a grid of B x C CTAs with cluster dims C
(engine/fused.launch_plan with b = B keeps B x C within the card's 132
SMs).  It replaces the JAX package's batched Pallas kernel
(engine/fused_batched.py `_build_batched_kernel`), whose grid program per
template reads per-template numbers from an SMEM scalar table.

The group arrives padded by parallel/sweep._pad_group under ONE group
StaticConfig (count gates ORed over the group), and every template is packed
under that cfg, so the tables switch on exactly the gates the JAX batched
kernel compiles in.  The int table carries each template's own plane
indices, so the stack pads every template's planes to the group's largest P
and needs no layout-uniformity refusal.

`fused_steps_batched_reference` is the plain PyTorch version: it loops
engine/fused.fused_steps_reference over the templates.  The wrapper takes it
only for tensors on the CPU; on the card it launches the kernel or raises.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import fused
from . import simulator as sim
from .fused import INT_WIDTH, LANES, KernelTable, _Packing

# Template-axis cap per launch: bounds the stacked const slab in device
# memory (B * P * S * 128 * 4 B); parallel/sweep._batched_solve cuts bigger
# groups into MAX_BATCH-sized segments.
MAX_BATCH = 256

LAUNCHES = 0          # batched kernel launches (not plain-version calls)
LAST_PLAN: Optional[fused.LaunchPlan] = None    # the last launch's plan


def _stack_planes(planes: Sequence[torch.Tensor]) -> torch.Tensor:
    """[P_b, S, 128] per template -> [B, max P_b, S, 128], zero-padded."""
    p = max(x.shape[0] for x in planes)
    out = planes[0].new_zeros((len(planes), p) + tuple(planes[0].shape[1:]))
    for b, x in enumerate(planes):
        out[b, :x.shape[0]] = x
    return out


def pack_group(cfg: sim.StaticConfig, pbs: List, consts_list
               ) -> Tuple[List[_Packing], torch.Tensor, KernelTable]:
    """Per-template packing under the group cfg: the packings, the stacked
    const planes [B, P, S, 128] and the stacked tables ([B, INT_WIDTH] int32,
    [B, F] float32), all on the consts' device."""
    pks = [fused._pack_meta(cfg, pb) for pb in pbs]
    const = _stack_planes([fused._pack_consts(pk, c)
                           for pk, c in zip(pks, consts_list)])
    tabs = [fused.kernel_table(pk) for pk in pks]
    dev = const.device
    tables = KernelTable(torch.stack([t.i for t in tabs]).to(dev),
                         torch.stack([t.f for t in tabs]).to(dev))
    return pks, const, tables


def _pack_carry_batched(pks: List[_Packing], carries: Sequence["sim.Carry"]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-template Carry -> planes [B, P, S, 128] + scalars [B, 4]."""
    packed = [fused._pack_carry(pk, c) for pk, c in zip(pks, carries)]
    return (_stack_planes([p for p, _s in packed]),
            torch.cat([s for _p, s in packed]).contiguous())


def _unpack_carry_batched(pks: List[_Packing], planes: torch.Tensor,
                          scalars: torch.Tensor,
                          templates: Sequence["sim.Carry"]) -> List["sim.Carry"]:
    """Kernel output -> one standard Carry per template."""
    return [fused._unpack_carry(pk, planes[b, :len(pk.carry_names)],
                                scalars[b:b + 1], templates[b])
            for b, pk in enumerate(pks)]


def stopped_flags(scalars: torch.Tensor) -> np.ndarray:
    """bool[B] per-template stopped flags from the packed scalars — no plane
    unpack (limit-reached sweeps never need the planes)."""
    return scalars[:, 1].cpu().numpy() > 0.5


def _check_batched_args(const, carry, scalars, tables, k) -> None:
    if not isinstance(tables, KernelTable):
        raise TypeError("tables must be a KernelTable")
    for name, t, dt in (("const", const, torch.float32),
                        ("carry", carry, torch.float32),
                        ("scalars", scalars, torch.float32),
                        ("tables.i", tables.i, torch.int32),
                        ("tables.f", tables.f, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != const.device:
            raise ValueError(f"{name} is on {t.device}, const on "
                             f"{const.device}")
    if const.dim() != 4 or const.shape[3] != LANES:
        raise ValueError(f"const must be [B, P, S, {LANES}], got "
                         f"{tuple(const.shape)}")
    b = const.shape[0]
    if carry.dim() != 4 or carry.shape[0] != b \
            or carry.shape[2:] != const.shape[2:]:
        raise ValueError(f"carry must be [{b}, P, {const.shape[2]}, {LANES}],"
                         f" got {tuple(carry.shape)}")
    if tuple(scalars.shape) != (b, 4):
        raise ValueError(f"scalars must be [{b}, 4], got "
                         f"{tuple(scalars.shape)}")
    if tuple(tables.i.shape) != (b, INT_WIDTH) or tables.f.dim() != 2 \
            or tables.f.shape[0] != b:
        raise ValueError(f"tables must be [{b}, {INT_WIDTH}] and [{b}, F]")
    if not isinstance(k, int) or k < 1:
        raise ValueError(f"k must be a positive int, got {k!r}")


def fused_steps_batched_reference(const: torch.Tensor, carry: torch.Tensor,
                                  scalars: torch.Tensor, tables: KernelTable,
                                  k: int
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """K fused steps for every template of the group in plain PyTorch: the
    single-template plain version on each template's slab and table row.
    Returns (carry_out [B, Py, S, 128], scalars_out [B, 4], chosen
    [B, k, 1] i32, -1 after the stop)."""
    _check_batched_args(const, carry, scalars, tables, k)
    outs = [fused.fused_steps_reference(
        const[b], carry[b], scalars[b:b + 1],
        KernelTable(tables.i[b], tables.f[b]), k)
        for b in range(const.shape[0])]
    return (torch.stack([o[0] for o in outs]),
            torch.cat([o[1] for o in outs]),
            torch.stack([o[2] for o in outs]))


def fused_steps_batched(const: torch.Tensor, carry: torch.Tensor,
                        scalars: torch.Tensor, tables: KernelTable, k: int,
                        cluster: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K fused steps for a template group.  CUDA tensors run the batched
    kernel (one launch of B clusters on the current stream, no sync) on the
    launch plan's cluster size, or on `cluster` CTAs where given; CPU
    tensors run fused_steps_batched_reference."""
    if const.device.type == "cpu":
        return fused_steps_batched_reference(const, carry, scalars, tables,
                                             k)
    if const.device.type != "cuda":
        raise ValueError(f"fused_steps_batched: unsupported device "
                         f"{const.device}")
    global LAUNCHES, LAST_PLAN
    _check_batched_args(const, carry, scalars, tables, k)
    lib = fused._load()
    b, n_const, s = const.shape[0], const.shape[1], const.shape[2]
    plan = fused.card_plan(s * LANES, n_const, carry.shape[1], b, cluster)
    carry_out = torch.empty_like(carry)
    scalars_out = torch.empty_like(scalars)
    chosen = torch.empty((b, k, 1), dtype=torch.int32, device=const.device)
    # per-template node scratch of the planes that are not resident
    scratch = torch.empty((b, fused.SCRATCH_PLANES, s * LANES),
                          dtype=torch.float32, device=const.device)
    stream = torch.cuda.current_stream(const.device).cuda_stream
    err = lib.fused_steps_batched_launch(
        const.data_ptr(), carry.data_ptr(), scalars.data_ptr(),
        tables.i.data_ptr(), tables.f.data_ptr(), carry_out.data_ptr(),
        scalars_out.data_ptr(), chosen.data_ptr(), scratch.data_ptr(),
        int(b), int(k), int(s), int(n_const), int(carry.shape[1]),
        int(tables.f.shape[1]), plan.cluster, plan.threads, plan.lanes,
        plan.resident, plan.smem_bytes, stream)
    fused._check_launch(err, "fused_steps_batched", plan)
    LAUNCHES += 1
    LAST_PLAN = plan
    return carry_out, scalars_out, chosen


class BatchedFusedRunner:
    """Drives the batched kernel over a padded template group.  consts_list
    holds each template's build_consts dict; the stacked planes and tables
    live on `device`."""

    def __init__(self, cfg: sim.StaticConfig, pbs: List, consts_list,
                 device):
        self.dev = torch.device(device)
        self.pks, const, tables = pack_group(cfg, pbs, consts_list)
        self.const = const.to(self.dev)
        self.tables = tables.to(self.dev)
        self.b = len(pbs)

    def pack(self, carries: Sequence["sim.Carry"]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        planes, scalars = _pack_carry_batched(self.pks, carries)
        return planes.to(self.dev), scalars.to(self.dev)

    def unpack(self, state, templates: Sequence["sim.Carry"]
               ) -> List["sim.Carry"]:
        dev = templates[0].requested.device
        return _unpack_carry_batched(self.pks, state[0].to(dev),
                                     state[1].to(dev), templates)

    def run_packed(self, state, k: int):
        """One chunk of k steps for the whole group, one host sync.  Returns
        (new_state, chosen int[k, B], all_stopped)."""
        yout, sout, chosen = fused_steps_batched(self.const, state[0],
                                                 state[1], self.tables, k)
        host = torch.cat([chosen.reshape(-1),
                          (sout[:, 1] > 0.5).to(torch.int32)]).cpu().numpy()
        chosen_np = host[:self.b * k].reshape(self.b, k).T
        return (yout, sout), chosen_np, bool(host[self.b * k:].all())

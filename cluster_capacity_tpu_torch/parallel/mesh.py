"""Device meshes for the capacity solve: the node axis sharded across
devices, a second axis batching templates.

The JAX package shards its jitted solve over a `jax.sharding.Mesh` and lets
XLA insert the collectives.  Here a `Mesh` is a (batch, nodes) grid of
shard slots, each a `torch.device` driven by one process (a single
controller per process, as in the JAX package):

- every node-axis tensor of a problem is padded to the node-shard multiple
  with inert rows (`pad_for_mesh`) and sliced, one contiguous block of
  nodes per shard, onto that shard's device (`shard_consts`,
  `shard_carry`);
- the step runs once per shard on its slice (engine/simulator.py, one
  thread per shard of a process) and every cross-node reduction combines
  the shards' partials through the shard's `NodeReducer`: in the process
  the shards of a row take turns, one at a time (`_RowExchange`), and
  across processes (parallel/distributed.py) the row adds
  `torch.distributed` collectives over its process group;
- templates pad to the batch-shard multiple and split across mesh rows;
  a process runs its rows one after another (`run_shards`), so in one
  process neither axis runs concurrently: the mesh shards the state, not
  the time.

A slot may repeat a device: on the CPU, `make_mesh` takes B×N logical
shards of the one CPU device (the counterpart of the JAX package's forced
virtual host devices), and an explicit `devices=` list may place several
logical shards on one card.

Layout of a per-problem consts dict (`classify_const`): allocatable
[N, R] and the per-node vectors [N] shard on axis 0, the per-constraint
node maps [C, N] on axis 1; everything else (request vectors, weights,
per-constraint scalars, the presence table, the log table) is replicated.
The carry's per-node planes shard the same way; its scalars and PRNG key
are replicated.
"""

from __future__ import annotations

import re
import threading
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

NODE_AXIS = "nodes"
BATCH_AXIS = "batch"

# Longest a shard waits for its turn at one reduction before the solve
# fails (a peer that raised aborts the wait at once).
_TURN_TIMEOUT_S = 600.0


class Mesh:
    """A (batch, nodes) grid of shard slots.  `devices[b][k]` is the
    torch.device of slot (b, k) and `ranks[b][k]` the rank of the process
    that drives it (all 0 in a single-process mesh); `rank` is this
    process's rank.  `groups[b]` is row b's torch.distributed process group
    when the row spans processes, else None."""

    axis_names = (BATCH_AXIS, NODE_AXIS)

    def __init__(self, devices: Sequence[Sequence], ranks=None,
                 rank: int = 0, groups: Optional[Dict[int, object]] = None):
        rows = [[torch.device(d) for d in row] for row in devices]
        self.devices = np.empty((len(rows), len(rows[0])), dtype=object)
        for b, row in enumerate(rows):
            for k, d in enumerate(row):
                self.devices[b, k] = d
        self.ranks = (np.zeros(self.devices.shape, dtype=np.int64)
                      if ranks is None else np.asarray(ranks, dtype=np.int64))
        self.rank = int(rank)
        self.groups = dict(groups or {})

    @property
    def shape(self) -> Dict[str, int]:
        return {BATCH_AXIS: int(self.devices.shape[0]),
                NODE_AXIS: int(self.devices.shape[1])}

    def local_shards(self, row: int) -> List[int]:
        """Node-shard indices of `row` that this process drives."""
        return [k for k in range(self.devices.shape[1])
                if self.ranks[row, k] == self.rank]

    def local_rows(self) -> List[int]:
        return [b for b in range(self.devices.shape[0])
                if self.local_shards(b)]

    @property
    def lead(self) -> torch.device:
        """The device this process gathers results on: its first slot."""
        b = self.local_rows()[0]
        return self.devices[b, self.local_shards(b)[0]]

    @property
    def multi_process(self) -> bool:
        return bool((self.ranks != self.ranks.flat[0]).any())

    def __repr__(self) -> str:
        s = self.shape
        return (f"Mesh({s[BATCH_AXIS]}x{s[NODE_AXIS]}, "
                f"devices={sorted({str(d) for d in self.devices.flat})})")


def _cards() -> List[torch.device]:
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def make_mesh(n_node_shards: Optional[int] = None, n_batch_shards: int = 1,
              devices: Optional[Sequence] = None, device=None) -> Mesh:
    """Build a (batch, nodes) mesh.  `devices` lists one device per slot
    (repeats allowed: logical shards of one device).  Without it the slots
    are the visible cards, one shard per card, unless `device` names the
    CPU, where the mesh takes B×N logical shards of the one CPU device.  A
    mesh that needs more cards than are visible raises ValueError."""
    if devices is None:
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cpu":
            n_node_shards = n_node_shards or 1
            devices = [dev] * (n_node_shards * n_batch_shards)
        elif dev.type == "cuda":
            devices = _cards()
        else:
            raise ValueError(f"unsupported mesh device {dev}")
    devs = [torch.device(d) for d in devices]
    if n_node_shards is None:
        n_node_shards = len(devs) // n_batch_shards
    used = n_node_shards * n_batch_shards
    if used > len(devs):
        raise ValueError(f"mesh {n_batch_shards}x{n_node_shards} needs {used} "
                         f"devices, have {len(devs)}")
    if used < 1:
        raise ValueError("a mesh needs at least one device")
    return Mesh([devs[b * n_node_shards:(b + 1) * n_node_shards]
                 for b in range(n_batch_shards)])


def auto_mesh(min_devices: int = 2, device=None) -> Optional[Mesh]:
    """Best (batch, nodes) mesh over every visible card, or None when fewer
    than `min_devices` are visible (on the CPU, or on one card: the
    unsharded path then serves).  An even card count splits 2 × n/2,
    odd counts put every card on the node axis."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return None
    n = torch.cuda.device_count()
    if n < min_devices:
        return None
    n_batch = 2 if n % 2 == 0 else 1
    return make_mesh(n_node_shards=n // n_batch, n_batch_shards=n_batch)


def parse_mesh(text: Optional[str], device=None) -> Optional[Mesh]:
    """CLI `--mesh` values: '' / 'none' / 'off' → None, 'auto' →
    auto_mesh(), 'BxN' → make_mesh(n_batch_shards=B, n_node_shards=N), on
    `device` (the card unless the caller names the CPU)."""
    t = (text or "").strip().lower()
    if t in ("", "none", "off"):
        return None
    if t == "auto":
        return auto_mesh(device=device)
    m = re.fullmatch(r"(\d+)x(\d+)", t)
    if not m:
        raise ValueError(f"bad mesh spec {text!r}: expected BxN (batch x "
                         f"node shards, e.g. 2x4), 'auto', or 'none'")
    return make_mesh(n_node_shards=int(m.group(2)),
                     n_batch_shards=int(m.group(1)), device=device)


def mesh_shape(mesh) -> Optional[Dict[str, int]]:
    """{'batch': B, 'nodes': N} — the telemetry form stamped on guard spans
    and report envelopes (status.mesh).  None for the unsharded path."""
    return None if mesh is None else mesh.shape


def check_device(mesh: Mesh, dev: torch.device) -> None:
    """A mesh serves only the device type the caller asked for: nothing runs
    the sharded path on the CPU when the card was asked for."""
    kinds = {d.type for d in mesh.devices.flat}
    if kinds != {dev.type}:
        raise ValueError(f"mesh devices {sorted(kinds)} do not match the "
                         f"solve's device {dev}")


# ---------------------------------------------------------------------------
# Classification of the consts keys (engine/simulator.build_consts)
# ---------------------------------------------------------------------------

NODE_MAT = frozenset({"allocatable"})
NODE_VEC = frozenset({"static_mask", "volume_mask", "taint_raw", "na_raw",
                      "il_score", "ss_ignored", "ipa_eanti_static",
                      "ipa_static_pref", "sh_missing"})
CONS_BY_NODE = frozenset({"sh_dom", "sh_countable", "sh_cnt_init",
                          "ss_dom", "ss_countable", "ss_cnt_init",
                          "ss_node_existing", "ipa_dom",
                          "ipa_aff_scnt", "ipa_anti_scnt", "ss_slots"})
# Keys with no node axis, DELIBERATELY replicated: the step reads them
# whole.  log_table stays indexed by real domain sizes (a pad node is never
# scorable, so no size counts one).
REPLICATED_OK = frozenset({
    "req_vec", "shared_req_vec", "req_nonzero", "fit_w", "fit_req",
    "bal_req",
    "sh_skew", "sh_mindom", "sh_domnum", "sh_self",
    "ss_skew", "ss_self", "ss_host", "ss_present0", "log_table",
    "ipa_ghas_aff", "ipa_ghas_anti", "ipa_aff_ginc", "ipa_anti_ginc",
    "ipa_pref_gw",
    "vol_self_gate", "rwop_gate", "dra_colo_gate",
})


def classify_const(key: str) -> Optional[str]:
    """Sharding family of a consts key: 'node_mat' | 'node_vec' |
    'cons_by_node' | 'replicated' | None.  None means the key is
    unclassified; `shard_consts` refuses it rather than replicate a node
    table by accident."""
    if key in NODE_MAT:
        return "node_mat"
    if key in NODE_VEC:
        return "node_vec"
    if key in CONS_BY_NODE:
        return "cons_by_node"
    if key in REPLICATED_OK:
        return "replicated"
    return None


# Node-axis position per consts key in the per-problem layout.
_NODE_AXIS_OF = {
    "allocatable": 0, "static_mask": 0, "volume_mask": 0, "taint_raw": 0,
    "na_raw": 0, "il_score": 0, "ss_ignored": 0, "ipa_eanti_static": 0,
    "ipa_static_pref": 0, "sh_missing": 0,
    "sh_dom": 1, "sh_countable": 1, "sh_cnt_init": 1,
    "ss_dom": 1, "ss_countable": 1, "ss_cnt_init": 1, "ss_node_existing": 1,
    "ipa_dom": 1, "ipa_aff_scnt": 1, "ipa_anti_scnt": 1, "ss_slots": 1,
}
# Pad values that make an appended node row inert: domain maps get the
# "no domain" sentinel (-1 ⇒ has_key False everywhere), missing/ignored
# masks get True, ss_slots its row's slot 0 (in range; it scatters zero),
# everything else zeros (no capacity, static_mask False).
_PAD_NEG = frozenset({"sh_dom", "ss_dom", "ipa_dom"})
_PAD_ONE = frozenset({"sh_missing", "ss_ignored"})

# Node-axis position per carry field; the rest are replicated scalars.
_CARRY_NODE_AXIS = {"requested": 0, "nonzero": 0, "placed": 0,
                    "sh_cnt": 1, "ss_cnt": 1, "aff_cnt": 1, "anti_cnt": 1,
                    "pref_cnt": 1}


def _pad_axis(a, axis: int, target: int, value):
    """`a` (numpy array or tensor) padded along `axis` to `target` with
    `value`."""
    if a.shape[axis] == target:
        return a
    if isinstance(a, torch.Tensor):
        shape = list(a.shape)
        shape[axis] = target - a.shape[axis]
        return torch.cat([a, torch.full(shape, value, dtype=a.dtype,
                                        device=a.device)], dim=axis)
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, target - a.shape[axis])
    return np.pad(a, widths, constant_values=value)


def node_pad(mesh: Mesh, n: int) -> int:
    """The node count padded to the mesh's node-shard multiple."""
    nn = mesh.shape[NODE_AXIS]
    return -(-n // nn) * nn


def pad_for_mesh(mesh: Mesh, consts: Dict[str, np.ndarray], carry):
    """Pad a per-problem consts dict (host numpy) and its carry (tensors)
    to the mesh's node-shard multiple.  Pad rows are statically infeasible,
    domainless and uncountable — behaviourally identical to trailing
    infeasible nodes, the rotating sample window included (the wrap passes
    the pad region as it passes trailing infeasible nodes)."""
    n_pad = node_pad(mesh, consts["static_mask"].shape[0])
    out = {}
    for k, v in consts.items():
        ax = _NODE_AXIS_OF.get(k)
        if ax is None or v.shape[ax] == n_pad:
            out[k] = v
        elif k == "ss_slots":
            d = consts["ss_present0"].shape[1]
            row0 = (np.arange(v.shape[0], dtype=v.dtype) * d)[:, None]
            out[k] = np.concatenate(
                [v, np.repeat(row0, n_pad - v.shape[1], axis=1)], axis=1)
        else:
            val = -1 if k in _PAD_NEG else (1 if k in _PAD_ONE else 0)
            out[k] = _pad_axis(v, ax, n_pad, val)
    carry = type(carry)(*[
        _pad_axis(v, _CARRY_NODE_AXIS[f], n_pad, 0)
        if f in _CARRY_NODE_AXIS else v
        for f, v in zip(carry._fields, carry)])
    return out, carry


def unpad_carry(carry, n_nodes: int):
    """The carry with its node axes cut back to the real node table."""
    return type(carry)(*[
        v.narrow(_CARRY_NODE_AXIS[f], 0, n_nodes)
        if f in _CARRY_NODE_AXIS else v
        for f, v in zip(carry._fields, carry)])


def batch_rows(mesh: Mesh, count: int) -> List[List[int]]:
    """Item indices per mesh row: `count` items padded to the batch-shard
    multiple (pad items would duplicate the last one; nothing reads them,
    so they are left out) and split evenly across the rows."""
    nb = mesh.shape[BATCH_AXIS]
    per = -(-count // nb)
    return [list(range(b * per, min(count, (b + 1) * per)))
            for b in range(nb)]


def _slice(v, axis: int, k: int, n_local: int):
    """Shard k's block of `v` (numpy array or tensor) along `axis`."""
    idx = [slice(None)] * v.ndim
    idx[axis] = slice(k * n_local, (k + 1) * n_local)
    return v[tuple(idx)]


def shard_consts(mesh: Mesh, consts: Dict[str, np.ndarray], row: int,
                 shard: int) -> Dict[str, torch.Tensor]:
    """Node shard `shard` of `row`'s consts on its device.  `consts` is
    padded (pad_for_mesh); node-axis keys are sliced, replicated keys
    copied whole.  An unclassified key raises."""
    n_local = consts["static_mask"].shape[0] // mesh.shape[NODE_AXIS]
    dev = mesh.devices[row, shard]
    out = {}
    for key, v in consts.items():
        fam = classify_const(key)
        if fam is None:
            raise ValueError(f"consts key {key!r} has no sharding family "
                             f"(parallel/mesh.py)")
        if fam != "replicated":
            v = np.ascontiguousarray(
                _slice(v, _NODE_AXIS_OF[key], shard, n_local))
        out[key] = torch.tensor(v, device=dev)
    return out


def shard_carry(mesh: Mesh, carry, row: int, shard: int):
    """Node shard `shard` of `row`'s carry on its device; `carry` is padded
    (pad_for_mesh)."""
    n_local = carry.placed.shape[0] // mesh.shape[NODE_AXIS]
    dev = mesh.devices[row, shard]
    return type(carry)(*[
        (_slice(v, _CARRY_NODE_AXIS[f], shard, n_local)
         if f in _CARRY_NODE_AXIS else v).to(dev).clone()
        for f, v in zip(carry._fields, carry)])


def gather_carry(mesh: Mesh, row: int, carries: Sequence, n_nodes: int):
    """The whole carry of `row` on `mesh.lead`, from its local shards'
    carries (in shard order) and, when the row spans processes, every other
    process's (one all-gather per node plane), node pads cut off."""
    lead = mesh.lead
    group = mesh.groups.get(row)
    fields = []
    for f, v in zip(carries[0]._fields, carries[0]):
        if f in _CARRY_NODE_AXIS:
            ax = _CARRY_NODE_AXIS[f]
            v = torch.cat([getattr(c, f).to(lead) for c in carries], dim=ax)
            if group is not None:
                v = torch.cat([b.to(lead) for b in _all_gather([v], group)],
                              dim=ax)
        fields.append(v.to(lead))
    return unpad_carry(type(carries[0])(*fields), n_nodes)


# ---------------------------------------------------------------------------
# The node-axis reducers
# ---------------------------------------------------------------------------

class PlainReducer:
    """The unsharded step's node-axis reductions: every method is the plain
    torch op over the whole node axis (one shard at offset 0), so a step
    run with it keeps exactly the unsharded ops.  NodeReducer has the same
    methods for one shard of a mesh row."""

    n_shards = 1
    offset = 0

    @staticmethod
    def any(x: torch.Tensor) -> torch.Tensor:
        return x.any()

    @staticmethod
    def max(x: torch.Tensor) -> torch.Tensor:
        return x.max()

    @staticmethod
    def min(x: torch.Tensor) -> torch.Tensor:
        return x.min()

    @staticmethod
    def min_rows(x: torch.Tensor) -> torch.Tensor:
        return x.min(dim=1).values

    @staticmethod
    def sum(x: torch.Tensor) -> torch.Tensor:
        return x.sum()

    @staticmethod
    def add(x: torch.Tensor) -> torch.Tensor:
        return x

    @staticmethod
    def argmax(keyed: torch.Tensor) -> torch.Tensor:
        return torch.argmax(keyed)

    @staticmethod
    def own(chosen: torch.Tensor, place: torch.Tensor, gate: torch.Tensor):
        return chosen, place, gate

    @staticmethod
    def publish(col: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
        return col


PLAIN = PlainReducer()


def _all_gather(parts: List[torch.Tensor], group) -> List[torch.Tensor]:
    """Every process's local partials of one row, in global shard order
    (processes hold contiguous shard blocks, rank order = shard order)."""
    import torch.distributed as dist

    dev = parts[0].device
    stacked = torch.stack([p.to(dev) for p in parts])
    dtype = stacked.dtype
    if dtype == torch.bool:
        stacked = stacked.to(torch.uint8)
    if dist.get_backend(group) != "nccl":
        stacked = stacked.cpu()
    out = [torch.empty_like(stacked)
           for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, stacked, group=group)
    return [t.to(dtype) for blk in out for t in blk.unbind(0)]


class MeshAborted(RuntimeError):
    """A peer shard of the row failed; this shard stops too."""


class _RowExchange:
    """What the shards of one mesh row in this process share: a slot per
    local shard for its partial, and the row's process group when the row
    spans processes.

    The local shards take turns, one at a time, in a ring (a semaphore per
    shard): a shard runs until its next reduction, leaves its partial in
    its slot and hands the turn on.  When the turn comes back, every peer
    has left its partial.  Only one shard thread is runnable at a time, so
    the threads never contend for the interpreter lock (which every torch
    op releases and takes back), and the order of work is fixed.  The last
    local shard also runs the cross-process all-gather.  Two slot buffers
    alternate: a shard writes reduction c + 2's partial only after every
    peer's turn past reduction c + 1, each of which read reduction c."""

    def __init__(self, n_local: int, group=None):
        self.n_local = n_local
        self.group = group
        self._slots = ([None] * n_local, [None] * n_local)
        self._out: List[Optional[list]] = [None, None]
        self._turn = [threading.Semaphore(0) for _ in range(n_local)]
        self._aborted = False

    def _wait_turn(self, j: int) -> None:
        if not self._turn[j].acquire(timeout=_TURN_TIMEOUT_S):
            raise MeshAborted(f"shard {j} waited {_TURN_TIMEOUT_S:.0f} s "
                              f"for its turn")
        if self._aborted:
            raise MeshAborted("a peer shard failed")

    def start(self, j: int) -> None:
        """Shard j's first turn: shard 0 starts, the others wait."""
        if j:
            self._wait_turn(j)

    def finish(self, j: int) -> None:
        """Shard j is done: hand the turn on."""
        if self.n_local > 1:
            self._turn[(j + 1) % self.n_local].release()

    def gather(self, j: int, call: int, x: torch.Tensor) -> list:
        slots = self._slots[call % 2]
        slots[j] = x
        if j == self.n_local - 1 and self.group is not None:
            self._out[call % 2] = _all_gather(list(slots), self.group)
        if self.n_local > 1:
            self._turn[(j + 1) % self.n_local].release()
            self._wait_turn(j)
        return list(slots) if self.group is None else self._out[call % 2]

    def abort(self) -> None:
        self._aborted = True
        for sem in self._turn:
            sem.release()


class NodeReducer:
    """The cross-node reductions of one shard: each takes this shard's
    partial, exchanges it with the row's other shards (`gather`, in shard
    order) and combines.  Every combine is a max, a min, an any, an integer
    sum or a selection, so the result equals the unsharded reduction bit for
    bit in any float dtype.  Node indices are global: shard k holds nodes
    [k * n_local, (k + 1) * n_local)."""

    def __init__(self, exchange: _RowExchange, j: int, k: int,
                 n_shards: int, n_local: int, device: torch.device):
        self._exchange = exchange
        self._j = j
        self._calls = 0
        self.k = k
        self.n_shards = n_shards
        self.n_local = n_local
        self.n_total = n_shards * n_local
        self.offset = k * n_local
        self.device = device

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every shard's `x` stacked on a leading [shards] axis."""
        parts = self._exchange.gather(self._j, self._calls, x)
        self._calls += 1
        return torch.stack([p.to(self.device) for p in parts])

    def any(self, x: torch.Tensor) -> torch.Tensor:
        return self.gather(x.any()).any()

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return self.gather(x.max()).max()

    def min(self, x: torch.Tensor) -> torch.Tensor:
        return self.gather(x.min()).min()

    def min_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Min over the node axis (dim 1) of a [C, N] plane."""
        return self.gather(x.min(dim=1).values).min(dim=0).values

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of an integer tensor."""
        return self.gather(x.sum()).sum()

    def add(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise sum of every shard's integer partial `x`."""
        return self.gather(x).sum(dim=0)

    def argmax(self, keyed: torch.Tensor) -> torch.Tensor:
        """Global index of the first maximum (torch.argmax's tie rule):
        the first shard holding the maximum, at its first maximum."""
        local = torch.argmax(keyed)
        vals = self.gather(keyed.max())
        idxs = self.gather(local + self.offset)
        first = torch.argmax((vals == vals.max()).to(torch.int32))
        return idxs.index_select(0, first.reshape(1))[0]

    def own(self, chosen: torch.Tensor, place: torch.Tensor,
            gate: torch.Tensor):
        """The commit's row at global node `chosen` on this shard: (its
        local index there or 0, `place` and its float `gate`, both off
        unless this shard holds the node)."""
        mine = (chosen >= self.offset) & (chosen < self.offset + self.n_local)
        row_place = place & mine
        return (torch.where(mine, chosen - self.offset, 0), row_place,
                row_place.to(gate.dtype))

    def publish(self, col: torch.Tensor, chosen: torch.Tensor
                ) -> torch.Tensor:
        """The owner shard's `col` (a column read at the chosen node's local
        index, garbage elsewhere) on every shard."""
        owner = torch.div(chosen, self.n_local, rounding_mode="floor")
        return self.gather(col).index_select(0, owner.reshape(1))[0]


def run_shards(mesh: Mesh, rows: Sequence[int], n_local: int,
               fn: Callable[[int, NodeReducer], object]) -> Dict:
    """Run `fn(row, reducer)` once per shard this process drives in each of
    `rows` (`n_local` nodes a shard) and return {(row, shard): result}.
    The rows run one after another; the shards of a row run in one thread
    each (inline when there is one), taking turns at every reduction
    (`_RowExchange`).  A shard that raises aborts its row's exchange, so its
    peers stop waiting, and its exception is re-raised here."""
    results: Dict = {}
    for r in rows:
        local = mesh.local_shards(r)
        ex = _RowExchange(len(local), mesh.groups.get(r))
        reds = [NodeReducer(ex, j, k, mesh.shape[NODE_AXIS], n_local,
                            mesh.devices[r, k]) for j, k in enumerate(local)]
        errors: List[BaseException] = []

        def one(red, r=r, ex=ex, errors=errors, threaded=len(reds) > 1):
            try:
                ex.start(red._j)
                if threaded and red.device.type == "cpu":
                    # one intra-op thread per shard thread (an OpenMP team
                    # each would oversubscribe the cores)
                    torch.set_num_threads(1)
                results[(r, red.k)] = fn(r, red)
                ex.finish(red._j)
            except BaseException as exc:  # re-raised below
                errors.append(exc)
                ex.abort()

        if len(reds) == 1:
            one(reds[0])
        else:
            threads = [threading.Thread(target=one, args=(red,), daemon=True)
                       for red in reds]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        if errors:
            real = [e for e in errors if not isinstance(e, MeshAborted)]
            raise (real or errors)[0]
    return results

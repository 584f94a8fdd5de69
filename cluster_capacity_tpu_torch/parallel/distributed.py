"""Multi-process runs: torch.distributed set-up and host-sharded snapshots.

The reference is a single-process program.  Scale-out here is the JAX
package's: every process runs one copy of the program, the processes join
one `torch.distributed` process group, the node axis of a mesh spans every
process's devices, and the solve's cross-node reductions become collectives
over the mesh row's process group (parallel/mesh.py's node-axis reducer):
gloo between CPU processes (or processes sharing a card), NCCL when each
process owns a card.

Pieces:
- initialize(): `torch.distributed.init_process_group` from arguments or
  CC_COORDINATOR (host:port) / CC_NUM_PROCESSES / CC_PROCESS_ID.
- global_mesh(): a (batch, nodes) Mesh over every process's shards, with a
  process group per mesh row that spans processes; local_mesh(): this
  process's shards only.
- split_objects()/write_sharded_snapshot()/load_shard(): deterministic
  contiguous node shards, so each process parses only its slice of a big
  snapshot.
- allgather_objects(): exchange the parsed shards once
  (`all_gather_object`), so every process builds the same snapshot.
- solve_on_mesh(): simulator.solve over the mesh — every process returns
  the same SolveResult, its carry gathered for the diagnosis.
- interleave_on_mesh(): the interleave race, each process on its own local
  mesh (replicated host control), every process with the same answers.
"""

from __future__ import annotations

import datetime
import json
import os
from typing import List, Optional, Sequence

import torch

from . import mesh as mesh_lib


def _dist():
    import torch.distributed as dist
    return dist


def process_count() -> int:
    dist = _dist()
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist.is_initialized() else 0


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout_s: float = 600.0) -> None:
    """Join the process group.  Arguments fall back to CC_COORDINATOR
    (host:port of process 0's rendezvous), CC_NUM_PROCESSES and
    CC_PROCESS_ID, so launchers configure processes uniformly; one process
    joins nothing.  `backend` defaults to NCCL when every process can own a
    card of its own, else gloo."""
    coordinator_address = coordinator_address or os.environ.get(
        "CC_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("CC_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("CC_PROCESS_ID", "0"))
    if num_processes <= 1:
        return
    if not coordinator_address:
        raise ValueError("a multi-process run needs CC_COORDINATOR "
                         "(host:port)")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() \
            and torch.cuda.device_count() >= num_processes else "gloo"
    _dist().init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))


def _local_devices(device=None, local_shards: Optional[int] = None
                   ) -> List[torch.device]:
    """This process's shard devices: `local_shards` logical shards of the
    CPU, or of the card this process owns (card rank % cards), or, in a
    single process, every visible card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return [dev] * (local_shards or 1)
    count = torch.cuda.device_count()
    if count == 0:
        raise ValueError("no CUDA device is available for the mesh")
    if process_count() == 1 and local_shards is None:
        return [torch.device("cuda", i) for i in range(count)]
    return [torch.device("cuda", process_index() % count)] * \
        (local_shards or 1)


def global_mesh(n_batch_shards: int = 1, device=None,
                local_shards: Optional[int] = None) -> mesh_lib.Mesh:
    """A (batch, nodes) mesh over every process's shards, process-major (so
    a row's node shards are contiguous blocks of whole processes, in rank
    order).  Every process must call it, with the same arguments: it
    creates one process group per row that spans several processes (the
    whole world when a row spans all of them)."""
    dist = _dist()
    local = _local_devices(device, local_shards)
    world = process_count()
    if world == 1:
        return mesh_lib.make_mesh(n_batch_shards=n_batch_shards,
                                  n_node_shards=len(local) // n_batch_shards,
                                  devices=local)
    counts: List[Optional[int]] = [None] * world
    dist.all_gather_object(counts, len(local))
    if len(set(counts)) != 1:
        raise ValueError(f"every process needs the same number of mesh "
                         f"shards, have {counts}")
    total = world * len(local)
    if total % n_batch_shards:
        raise ValueError(f"{total} shards do not split into "
                         f"{n_batch_shards} mesh rows")
    n_nodes = total // n_batch_shards
    rank = process_index()
    slots = [(p, local[i]) for p in range(world) for i in range(len(local))]
    devices = [[slots[b * n_nodes + k][1] for k in range(n_nodes)]
               for b in range(n_batch_shards)]
    ranks = [[slots[b * n_nodes + k][0] for k in range(n_nodes)]
             for b in range(n_batch_shards)]
    groups = {}
    for b, row in enumerate(ranks):
        members = sorted(set(row))
        if len(members) == 1:
            continue
        # new_group is collective: every process makes every row's group
        group = dist.group.WORLD if len(members) == world \
            else dist.new_group(members)
        if rank in members:
            groups[b] = group
    return mesh_lib.Mesh(devices, ranks=ranks, rank=rank, groups=groups)


def local_mesh(n_batch_shards: int = 1, device=None,
               local_shards: Optional[int] = None) -> mesh_lib.Mesh:
    """A (batch, nodes) mesh over THIS process's shards only."""
    local = _local_devices(device, local_shards)
    return mesh_lib.make_mesh(
        n_node_shards=max(1, len(local) // n_batch_shards),
        n_batch_shards=n_batch_shards, devices=local)


def split_objects(nodes: Sequence[dict], num_shards: int
                  ) -> List[List[dict]]:
    """Deterministic contiguous node shards (balanced sizes)."""
    n = len(nodes)
    bounds = [(n * k) // num_shards for k in range(num_shards + 1)]
    return [list(nodes[bounds[k]:bounds[k + 1]]) for k in range(num_shards)]


def write_sharded_snapshot(path: str, nodes: Sequence[dict],
                           num_shards: int, **rest) -> List[str]:
    """Split a snapshot into per-process files `<path>.<k>.json`: the node
    list shards; every other object kind rides with shard 0."""
    paths = []
    for k, shard in enumerate(split_objects(nodes, num_shards)):
        payload = {"nodes": shard}
        if k == 0:
            payload.update(rest)
        p = f"{path}.{k}.json"
        with open(p, "w") as f:
            json.dump(payload, f)
        paths.append(p)
    return paths


def load_shard(path: str, process_id: int) -> dict:
    with open(f"{path}.{process_id}.json") as f:
        return json.load(f)


def allgather_objects(local: object) -> List[object]:
    """Every process's picklable payload, in rank order, on every process
    ([local] in a single process).  Payloads come only from this program's
    own processes."""
    if process_count() == 1:
        return [local]
    out: List[object] = [None] * process_count()
    _dist().all_gather_object(out, local)
    return out


def load_snapshot_distributed(path: str):
    """Host-sharded snapshot load: this process parses only its own shard
    file, the parsed objects are exchanged once, and every process builds
    the same ClusterSnapshot (object order is shard order, so vocabularies
    and node indices agree everywhere)."""
    from ..models.snapshot import ClusterSnapshot

    if process_count() > 1:
        shards = allgather_objects(load_shard(path, process_index()))
    else:
        shards = []
        while os.path.exists(f"{path}.{len(shards)}.json"):
            shards.append(load_shard(path, len(shards)))
        if not shards:
            raise FileNotFoundError(
                f"no snapshot shards found at {path}.<k>.json")
    nodes: List[dict] = []
    rest: dict = {}
    for shard in shards:
        nodes.extend(shard.get("nodes") or [])
        for k, v in shard.items():
            if k != "nodes" and v:
                rest.setdefault(k, []).extend(v)
    return ClusterSnapshot.from_objects(nodes, **rest)


def interleave_on_mesh(snapshot, templates, profile=None, max_total: int = 0,
                       mesh: Optional[mesh_lib.Mesh] = None, device=None):
    """The interleaved multi-template race on a mesh, safe with several
    processes.  The race's host loop reads the carry back after every
    chunk, so with more than one process each runs the race on its own
    local mesh (`local_mesh`, on `device`): the host control is
    replicated, and every process computes the same answers because the
    race is deterministic.  One process takes the whole mesh (every
    visible card, or one CPU shard)."""
    from .interleave import sweep_interleaved_auto

    if mesh is None:
        mesh = (local_mesh(device=device) if process_count() > 1
                else mesh_lib.make_mesh(device=device))
    return sweep_interleaved_auto(snapshot, templates, profile,
                                  max_total=max_total, mesh=mesh,
                                  device=mesh.lead.type)


def solve_on_mesh(pb, mesh: mesh_lib.Mesh, max_limit: int = 0):
    """simulator.solve with the node axis sharded over a (multi-process)
    mesh, on the mesh's device type.  Every process returns the same
    SolveResult: the carry is gathered across the processes for the
    diagnosis."""
    from ..engine import simulator as sim

    return sim.solve(pb, max_limit=max_limit, device=mesh.lead.type,
                     mesh=mesh)

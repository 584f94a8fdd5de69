"""The canonical entries: one driver per engine path at a tiny fixed shape.

Each entry drives one path of the port on `device` at the shape and under
the name of the JAX package's canonical ladder (tools/irgate/entries.py),
so `hypercc profile`'s calibration joins the port's measured seconds
against the same static budgets (tools/irgate/budgets.json), and the
flight recorder packs the same entry for a failing site's kernel.txt:

    scan/n8, scan/n16        the scan step (engine/simulator._drive_step)
    fused/n8                 kernel 1 through simulator.solve
    fused_batched/n8b3       kernel 2 through sweep.solve_group
    solve_group/n8b3         the group's scan-step route (a template at a
                             time under the group's budget)
    sharded_group/n8b2       the group on a 1x1 device mesh (the sharded
                             step, parallel/mesh.py)
    fast_path/n8b3           the batched closed form at limit 4
    extenders/n8             one extender cycle's device pass and commit
    preemption/n2            DefaultPreemption through ClusterCapacity.run
    oracle/n4                the host oracle rung
    bounds_bracket/n8b3      the capacity bracket's device shot
    bounds_bracket_spread/n8 the same with a hard spread fold
    bounds_auction/n8t2      bracket_mix's K-round auction on a mix of two

The JAX ladder's interleave_sharded entry waits for the interleave engine
on a mesh (ROADMAP queue 1).  Fixtures are the JAX ladder's: 3-16 nodes,
the default float32 profile.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

# The JAX ladder's entries this port does not drive yet, and why.
MISSING = {
    "interleave_sharded/n8t2": "the interleave engine on a device mesh "
                               "(ROADMAP queue 1)",
}


def _node(name: str, milli_cpu: int, mem: int, pods: int,
          labels: Optional[dict] = None) -> dict:
    alloc = {"cpu": f"{milli_cpu}m", "memory": str(mem), "pods": str(pods)}
    return {
        "metadata": {"name": name, "labels": dict(labels or {})},
        "spec": {},
        "status": {"allocatable": alloc, "capacity": dict(alloc)},
    }


def _pod(name: str, milli_cpu: int, mem: int, node_name: str = "",
         labels: Optional[dict] = None) -> dict:
    return {
        "metadata": {"name": name, "namespace": "default",
                     "labels": dict(labels or {})},
        "spec": {
            "containers": [{"name": "c0", "image": "img",
                            "resources": {"requests": {
                                "cpu": f"{milli_cpu}m",
                                "memory": str(mem)}}}],
            "nodeName": node_name,
        },
    }


def _preferred_affinity(pod: dict, key: str, value: str) -> dict:
    """Non-uniform preferred node affinity: keeps the problem off the
    closed form so the engine actually runs."""
    pod["spec"]["affinity"] = {"nodeAffinity": {
        "preferredDuringSchedulingIgnoredDuringExecution": [{
            "weight": 1,
            "preference": {"matchExpressions": [
                {"key": key, "operator": "In", "values": [value]}]},
        }]}}
    return pod


def _nodes(n: int) -> List[dict]:
    out = []
    for i in range(n):
        labels = {"zone": f"z{i % 2}"}
        if i == 0:
            labels["tier"] = "gold"
        out.append(_node(f"node-{i}", 2000 + 100 * i, int(1e9), 16,
                         labels=labels))
    return out


def problem(n: int, milli_cpu: int = 300, affinity: bool = False):
    """EncodedProblem on the canonical n-node snapshot, float32 profile."""
    from ..engine import encode as enc
    from ..models.podspec import default_pod
    from ..models.snapshot import ClusterSnapshot
    from ..utils.config import SchedulerProfile

    snapshot = ClusterSnapshot.from_objects(_nodes(n), [])
    pod = _pod("probe", milli_cpu, int(5e7))
    if affinity:
        _preferred_affinity(pod, "tier", "gold")
    return enc.encode_problem(snapshot, default_pod(pod), SchedulerProfile())


def spread_problem(n: int):
    """EncodedProblem whose probe carries a hard topology-spread constraint,
    so the bracket folds it (num_constraints > 0)."""
    from ..engine import encode as enc
    from ..models.podspec import default_pod
    from ..models.snapshot import ClusterSnapshot
    from ..utils.config import SchedulerProfile

    snapshot = ClusterSnapshot.from_objects(_nodes(n), [])
    pod = _pod("probe", 300, int(5e7), labels={"app": "probe"})
    pod["spec"]["topologySpreadConstraints"] = [{
        "maxSkew": 1, "topologyKey": "zone",
        "whenUnsatisfiable": "DoNotSchedule",
        "labelSelector": {"matchLabels": {"app": "probe"}},
    }]
    return enc.encode_problem(snapshot, default_pod(pod), SchedulerProfile())


@dataclass
class EntrySpec:
    """One canonical entry: a driver taking the device, and its rung."""

    name: str
    rung: str                       # degradation-ladder rung or "aux"
    driver: Callable[[object], None]


def _drive_scan(n: int):
    def driver(device):
        from ..engine import simulator as sim
        pb = problem(n, affinity=True)
        cfg = sim.static_config(pb)
        consts = sim.build_consts(pb, sim.resolve_device(device))
        budget = sim.step_budget(pb)
        sim._drive_step(cfg, consts, sim._init_carry(pb, consts), budget,
                        min(sim._STEP_CHUNK, budget))
    return driver


def _drive_fused(device):
    from ..engine import fused
    from ..engine import simulator as sim
    pb = problem(8)
    fused.check_eligible(sim.static_config(pb), pb)
    sim.solve(pb, device=device)


def _drive_batched(b: int):
    def driver(device):
        from ..parallel import sweep as sweep_mod
        sweep_mod.solve_group([problem(8) for _ in range(b)], device=device)
    return driver


def _drive_group_step(b: int):
    def driver(device):
        from ..engine import simulator as sim
        from ..parallel import sweep as sweep_mod
        pbs = [problem(8) for _ in range(b)]
        dev = sim.resolve_device(device)
        budget = sweep_mod._group_budget(pbs, 0, True)
        for pb in pbs:
            sweep_mod._group_step_solve(pb, 0, dev, budget,
                                        min(1024, budget))
    return driver


def _drive_sharded_group(b: int):
    def driver(device):
        from ..engine import simulator as sim
        from ..parallel import mesh as mesh_lib
        from ..parallel import sweep as sweep_mod
        dev = sim.resolve_device(device)
        mesh = mesh_lib.make_mesh(n_node_shards=1, n_batch_shards=1,
                                  devices=[dev])
        sweep_mod.solve_group([problem(8) for _ in range(b)], mesh=mesh,
                              device=dev)
    return driver


def _drive_fast_path(b: int):
    def driver(device):
        from ..engine import fast_path
        # the batched closed form only engages at a positive limit
        fast_path.solve_fast_batched([problem(8) for _ in range(b)], 4,
                                     device=device)
    return driver


def _drive_extenders(device):
    import torch

    from ..engine import extenders
    from ..engine import simulator as sim
    pb = problem(8)
    dev = sim.resolve_device(device)
    cfg = sim.static_config(pb)
    consts = sim.build_consts(pb, dev)
    carry = sim._init_carry(pb, consts)
    feasible, total = extenders._compute(cfg, consts, carry)
    carry = sim._apply_placement(
        cfg, consts, carry, torch.full((), 0, dtype=torch.int64, device=dev),
        torch.ones((), dtype=torch.bool, device=dev),
        next_start=carry.next_start, rng=carry.rng)
    total.cpu()
    carry.stopped.cpu()


def _drive_preemption(device):
    from ..framework import ClusterCapacity
    from ..models.podspec import default_pod
    from ..utils.config import SchedulerProfile
    nodes = [_node("n1", 1000, int(1e9), 10, labels={"tier": "gold"}),
             _node("n2", 1000, int(1e9), 10)]
    squatter = _pod("squatter", 800, int(1e6), node_name="n1")
    squatter["spec"]["priority"] = -1
    incoming = _preferred_affinity(_pod("vip", 600, int(1e6)), "tier", "gold")
    incoming["spec"]["priority"] = 100
    cc = ClusterCapacity(default_pod(incoming), max_limit=0,
                         profile=SchedulerProfile(), device=device)
    cc.sync_with_objects(nodes, [squatter])
    cc.run()


def _drive_oracle(device):
    from ..runtime import degrade
    degrade._solve_oracle(problem(4))


def _drive_bracket(b: int):
    def driver(device):
        from ..bounds import bracket
        bracket.bracket_group([problem(8) for _ in range(b)], device=device)
    return driver


def _drive_bracket_spread(device):
    from ..bounds import bracket
    bracket.bracket_group([spread_problem(8)], device=device)


def _drive_auction(device):
    from ..bounds import bracket
    bracket.bracket_mix([problem(8), problem(8, milli_cpu=500)],
                        device=device)


def canonical_entries() -> List[EntrySpec]:
    """The port's entries, in the JAX ladder's order."""
    return [
        EntrySpec("fused_batched/n8b3", "fused_batched", _drive_batched(3)),
        EntrySpec("fused/n8", "fused", _drive_fused),
        EntrySpec("solve_group/n8b3", "fused_batched", _drive_group_step(3)),
        EntrySpec("sharded_group/n8b2", "sharded_batched",
                  _drive_sharded_group(2)),
        EntrySpec("scan/n8", "fused", _drive_scan(8)),
        EntrySpec("scan/n16", "fused", _drive_scan(16)),
        EntrySpec("fast_path/n8b3", "fast_path", _drive_fast_path(3)),
        EntrySpec("extenders/n8", "aux", _drive_extenders),
        EntrySpec("preemption/n2", "aux", _drive_preemption),
        EntrySpec("oracle/n4", "oracle", _drive_oracle),
        EntrySpec("bounds_bracket/n8b3", "bounds", _drive_bracket(3)),
        EntrySpec("bounds_bracket_spread/n8", "bounds",
                  _drive_bracket_spread),
        EntrySpec("bounds_auction/n8t2", "bounds", _drive_auction),
    ]

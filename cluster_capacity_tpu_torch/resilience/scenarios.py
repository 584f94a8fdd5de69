"""Failure-scenario enumeration and symmetric-scenario dedup.

A scenario is a set of node indices simulated as failed.  Enumeration is
pure host work over the snapshot: every single-node failure, every topology
domain of a label key (zones by default), random N-k samples, or an explicit
drain list.  The analyzer (analyzer.py) encodes each scenario as an
alive_mask and batches the survivors' headroom solve on the card.

Dedup mirrors the template dedup in parallel/sweep.py (_solve_signature):
two single-node scenarios are behaviorally identical when the failed nodes
carry identical encoded planes and host no pods — failing either leaves a
survivor set that differs only by which of two indistinguishable nodes
remains, so every permutation-invariant metric (headroom, displaced,
stranded) matches.  Placements are NOT shared: the greedy argmax tie-break
rotates between indistinguishable twins, so duplicates report metrics only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import hashlib

import numpy as np

from ..engine import encode as enc
from ..models.snapshot import ClusterSnapshot

ZONE_TOPOLOGY_KEY = "topology.kubernetes.io/zone"


@dataclass(frozen=True)
class FailureScenario:
    name: str
    kind: str                   # "node" | "zone" | "random" | "drain"
    failed: Tuple[int, ...]     # node-axis indices, ascending

    @property
    def k(self) -> int:
        return len(self.failed)

    def alive_mask(self, num_nodes: int) -> np.ndarray:
        alive = np.ones(num_nodes, dtype=bool)
        alive[list(self.failed)] = False
        return alive


def single_node_scenarios(snapshot: ClusterSnapshot) -> List[FailureScenario]:
    """Every N-1 scenario, in node-axis order."""
    return [FailureScenario(name=f"node/{snapshot.node_names[i]}",
                            kind="node", failed=(i,))
            for i in range(snapshot.num_nodes)]


def zone_scenarios(snapshot: ClusterSnapshot,
                   key: str = ZONE_TOPOLOGY_KEY) -> List[FailureScenario]:
    """One scenario per distinct value of a topology label key; nodes missing
    the key are never failed (they form no domain)."""
    node_domain, vocab = snapshot.topology_domains(key)
    out = []
    for value, d in sorted(vocab.items(), key=lambda kv: kv[1]):
        idxs = tuple(int(i) for i in np.flatnonzero(node_domain == d))
        if idxs:
            out.append(FailureScenario(name=f"zone/{value}", kind="zone",
                                       failed=idxs))
    return out


def random_nk_scenarios(snapshot: ClusterSnapshot, k: int, samples: int,
                        seed: int = 0) -> List[FailureScenario]:
    """`samples` distinct random k-subsets of the node axis (fewer when the
    subset space is smaller than the sample budget)."""
    n = snapshot.num_nodes
    if not 0 < k <= n:
        raise ValueError(f"random N-k needs 0 < k <= {n}, got k={k}")
    rng = np.random.RandomState(seed)
    seen, out = set(), []
    attempts = 0
    # bounded rejection sampling: C(n, k) may be smaller than `samples`
    while len(out) < samples and attempts < max(64, samples * 20):
        attempts += 1
        pick = tuple(sorted(int(x)
                            for x in rng.choice(n, size=k, replace=False)))
        if pick in seen:
            continue
        seen.add(pick)
        out.append(FailureScenario(name=f"random-{k}/{len(out):04d}",
                                   kind="random", failed=pick))
    return out


def drain_list_scenario(snapshot: ClusterSnapshot,
                        node_names: Sequence[str]) -> FailureScenario:
    """An explicit drain list given by node name."""
    index_of = {nm: i for i, nm in enumerate(snapshot.node_names)}
    missing = [nm for nm in node_names if nm not in index_of]
    if missing:
        raise ValueError(
            "unknown node(s) in drain list: " + ", ".join(sorted(missing)))
    failed = tuple(sorted({index_of[nm] for nm in node_names}))
    label = ",".join(snapshot.node_names[i] for i in failed)
    return FailureScenario(name=f"drain/{label}", kind="drain", failed=failed)


# --- symmetric-scenario dedup ------------------------------------------------

def _digest(h: "hashlib._Hash", a) -> None:
    a = np.ascontiguousarray(a)
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    h.update(a.tobytes())


def node_signature(pb: enc.EncodedProblem, i: int) -> bytes:
    """Content hash of every encoded plane the solvers read about node i.

    The planes are enumerated by hand rather than by matching axis lengths:
    when C == N or R == N a generic dim-match would hash the wrong axis.
    Rows of [N, ...] tensors cover per-node state; columns of [C, N]/[G, N]
    topology tensors cover domain membership — equal columns mean the two
    nodes sit in the same domain of every constraint/term.
    """
    h = hashlib.sha1()
    for a in (pb.allocatable[i], pb.init_requested[i], pb.init_nonzero[i],
              pb.static_mask[i], pb.static_code[i], pb.volume_mask[i],
              pb.taint_raw[i], pb.node_affinity_raw[i],
              pb.image_locality_score[i], pb.spread_ignored[i]):
        _digest(h, a)
    for s in (pb.spread_hard, pb.spread_soft):
        _digest(h, s.node_has_all_keys[i])
        _digest(h, s.node_domain[:, i])
        _digest(h, s.node_countable[:, i])
        _digest(h, s.node_existing[:, i])
    _digest(h, pb.ipa.existing_anti_static[i])
    _digest(h, pb.ipa.static_pref_score[i])
    _digest(h, pb.ipa.node_domain[:, i])
    h.update(repr(pb.taint_reasons[i]).encode())
    h.update(repr(pb.volume_reasons[i]).encode())
    return h.digest()


def dedup_single_node(pb: enc.EncodedProblem,
                      scenarios: Sequence[FailureScenario]) -> Dict[int, int]:
    """Map duplicate scenario index → representative scenario index.

    Only single-node scenarios whose failed node hosts no pods are eligible:
    a resident pod makes the drain outcome depend on WHICH twin failed (the
    pod objects differ), and multi-node scenarios would need set-equality of
    signatures, which single-node symmetry does not imply.
    """
    sig_rep: Dict[bytes, int] = {}
    dup_of: Dict[int, int] = {}
    for si, sc in enumerate(scenarios):
        if sc.kind != "node" or len(sc.failed) != 1:
            continue
        i = sc.failed[0]
        if pb.snapshot.pods_by_node[i]:
            continue
        sig = node_signature(pb, i)
        rep = sig_rep.get(sig)
        if rep is None:
            sig_rep[sig] = si
        else:
            dup_of[si] = rep
    return dup_of

"""NodePorts plugin: hostPort conflict filter.

Reference: vendor/k8s.io/kubernetes/pkg/scheduler/framework/plugins/nodeports/node_ports.go:157-186
and the conflict rule in framework/types.go (UsedPorts / CheckConflict): two
(protocol, hostIP, hostPort) entries conflict when ports and protocols are
equal and either IP is 0.0.0.0 or the IPs are equal.

The conflict vs. *existing* pods is static per node.  Because every simulated
clone requests the same ports, a node that receives one clone conflicts with
every later clone — the dynamic part reduces to `placed_on_node > 0` whenever
the template declares any hostPort (a template with hostPorts that conflict
among themselves is impossible to place twice on one node regardless).
"""

from __future__ import annotations

import numpy as np

from ..models.podspec import pod_host_ports
from ..models.snapshot import ClusterSnapshot

REASON = "node(s) didn't have free ports for the requested pod ports"


def _conflict(a, b) -> bool:
    (proto_a, ip_a, port_a), (proto_b, ip_b, port_b) = a, b
    if port_a != port_b or proto_a != proto_b:
        return False
    return ip_a == "0.0.0.0" or ip_b == "0.0.0.0" or ip_a == ip_b


def static_mask(snapshot: ClusterSnapshot, pod: dict) -> np.ndarray:
    """Conflict of the template's hostPorts vs ports used by existing pods."""
    want = pod_host_ports(pod)
    n = snapshot.num_nodes
    mask = np.ones(n, dtype=bool)
    if not want:
        return mask
    for i in range(n):
        used = snapshot.node_used_host_ports(i)
        if any(_conflict(w, u) for w in want for u in used):
            mask[i] = False
    return mask


def template_has_host_ports(pod: dict) -> bool:
    return bool(pod_host_ports(pod))

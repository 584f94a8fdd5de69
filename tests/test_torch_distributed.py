"""The port's multi-process pieces (parallel/distributed.py) against the JAX
package's on the CPU: host-sharded snapshots (split, write, load and the
single-process load) and a solve over a mesh that spans two processes
joined by torch.distributed over gloo — tests/test_distributed.py's proof,
held to the single-process JAX `sim.solve` exactly.

The two-process tests are marked `dist` like their JAX counterparts and
spawn this file as their workers (`python test_torch_distributed.py
--worker ...`), each under its own 60 s limit, killed when the test ends.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 60


def _cluster_objects(n_nodes=16):
    """tests/test_distributed.py's cluster: 16 nodes (or `n_nodes`) in 4
    zones and a pod with a zone DoNotSchedule spread."""
    nodes = []
    for i in range(n_nodes):
        nodes.append({
            "metadata": {"name": f"n{i:02d}",
                         "labels": {"kubernetes.io/hostname": f"n{i:02d}",
                                    "topology.kubernetes.io/zone": f"z{i % 4}"}},
            "spec": {},
            "status": {"allocatable": {"cpu": "4000m",
                                       "memory": str(8 * 1024 ** 3),
                                       "pods": "16"}}})
    pod = {"metadata": {"name": "p", "labels": {"app": "d"}},
           "spec": {"containers": [{"name": "c", "resources": {
               "requests": {"cpu": "300m", "memory": "512Mi"}}}],
               "topologySpreadConstraints": [{
                   "maxSkew": 2, "topologyKey": "topology.kubernetes.io/zone",
                   "whenUnsatisfiable": "DoNotSchedule",
                   "labelSelector": {"matchLabels": {"app": "d"}}}]}}
    return nodes, pod


def _profile(cls, pct: int, tie: str):
    """The parity profile scoring `pct` percent of the nodes."""
    prof = cls.parity()
    prof.percentage_of_nodes_to_score = pct
    prof.deterministic = tie == "deterministic"
    return prof


def _worker(base: str, out: str, limit: int, local_shards: int,
            batch_shards: int, pct: int, tie: str) -> int:
    """One process of the two-process runs: join the gloo group, load this
    process's snapshot shard, and (process 0) write the outcome.  One mesh
    row (batch_shards 1): solve the pod on the node axis over both
    processes' shards.  Two rows, one a process: solve a group of three
    pods of 300/600/900m, its templates split across the processes."""
    sys.path.insert(0, REPO)
    import torch.distributed as tdist

    from cluster_capacity_tpu_torch.engine import encode as enc
    from cluster_capacity_tpu_torch.models.podspec import default_pod
    from cluster_capacity_tpu_torch.parallel import distributed as dist
    from cluster_capacity_tpu_torch.utils.config import SchedulerProfile

    dist.initialize(timeout_s=WORKER_TIMEOUT_S)
    try:
        mesh = dist.global_mesh(batch_shards, device="cpu",
                                local_shards=local_shards)
        snapshot = dist.load_snapshot_distributed(base)
        with open(base + ".pod.json") as f:
            pod = json.load(f)
        prof = _profile(SchedulerProfile, pct, tie)
        if batch_shards == 1:
            pb = enc.encode_problem(snapshot, default_pod(pod), prof)
            results = [dist.solve_on_mesh(pb, mesh, max_limit=limit)]
        else:
            from cluster_capacity_tpu_torch.parallel import sweep
            pbs = [enc.encode_problem(snapshot, default_pod(t), prof)
                   for t in _group_templates(pod)]
            results = sweep.solve_group(pbs, max_limit=limit, mesh=mesh,
                                        device="cpu")
        if dist.process_index() == 0:
            with open(out, "w") as f:
                json.dump({"results": [[r.placements, r.fail_type,
                                        r.fail_message] for r in results],
                           "processes": dist.process_count(),
                           "mesh": mesh.shape}, f)
    finally:
        tdist.destroy_process_group()
    return 0


def _group_templates(pod):
    out = []
    for i, cpu in enumerate(("300m", "600m", "900m")):
        t = json.loads(json.dumps(pod))
        t["metadata"]["name"] = f"p{i}"
        t["spec"]["containers"][0]["resources"]["requests"]["cpu"] = cpu
        out.append(t)
    return out


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(tmp_path, base, out, limit, local_shards, batch_shards,
                 pct, tie):
    port = _free_port()
    env = dict(os.environ, CC_COORDINATOR=f"127.0.0.1:{port}",
               CC_NUM_PROCESSES="2",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + os.environ.get("PYTHONPATH", "").split(
                       os.pathsep)))
    procs, logs = [], []
    try:
        for pid in range(2):
            # log files, not pipes: a chatty worker cannot fill a pipe and
            # wedge its peer at a collective
            log = open(str(tmp_path / f"worker{pid}.log"), "w+b")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 base, out, str(limit), str(local_shards),
                 str(batch_shards), str(pct), tie],
                env=dict(env, CC_PROCESS_ID=str(pid)), stdout=log,
                stderr=log))
        for p in procs:
            try:
                p.wait(timeout=WORKER_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    tails = []
    for log in logs:
        log.seek(0)
        tails.append(log.read().decode(errors="replace")[-2000:])
        log.close()
    for pid, p in enumerate(procs):
        assert p.returncode == 0, f"worker {pid}: {tails[pid]}"


@pytest.mark.dist
@pytest.mark.parametrize("batch_shards,local_shards,n_nodes,pct,tie", [
    (1, 1, 16, 100, "deterministic"), (1, 2, 16, 100, "deterministic"),
    (2, 1, 16, 100, "deterministic"), (1, 2, 203, 30, "deterministic"),
    (1, 1, 203, 30, "random")],
    ids=["1x2", "1x4", "2x1", "1x4-sampled", "1x2-sampled-random"])
def test_two_process_sharded_solve(tmp_path, batch_shards, local_shards,
                                   n_nodes, pct, tie):
    """Two processes over gloo, each driving `local_shards` logical shards
    of its CPU and loading only its own snapshot shard.  One mesh row (1x2
    or 1x4, the node axis across both processes): the answer equals the
    single-process JAX solve.  Two rows (2x1, a row a process): a group of
    three templates split across the processes equals the single-process
    JAX group in process 0, which ran only row 0 and got row 1's results
    from the exchange.  The sampled cases score 30% of 203 nodes (padded
    to 204), so the rotating window's counts cross the processes."""
    from cluster_capacity_tpu import SchedulerProfile
    from cluster_capacity_tpu.engine import encode as jenc
    from cluster_capacity_tpu.engine import simulator as jsim
    from cluster_capacity_tpu.models.podspec import default_pod
    from cluster_capacity_tpu.models.snapshot import ClusterSnapshot
    from cluster_capacity_tpu.parallel import sweep as jsweep
    from cluster_capacity_tpu_torch.parallel import distributed as dist

    nodes, pod = _cluster_objects(n_nodes)
    limit = 40
    snap = ClusterSnapshot.from_objects(nodes)
    prof = _profile(SchedulerProfile, pct, tie)
    if batch_shards == 1:
        pb = jenc.encode_problem(snap, default_pod(pod), prof)
        if pct < 100:
            assert jsim.static_config(pb).sample_k == 100
        refs = [jsim.solve(pb, max_limit=limit)]
    else:
        refs = jsweep.solve_group(
            [jenc.encode_problem(snap, default_pod(t), prof)
             for t in _group_templates(pod)], max_limit=limit)
    base = str(tmp_path / "snap")
    dist.write_sharded_snapshot(base, nodes, num_shards=2)
    with open(base + ".pod.json", "w") as f:
        json.dump(pod, f)
    out = str(tmp_path / "out.json")
    _run_workers(tmp_path, base, out, limit, local_shards, batch_shards,
                 pct, tie)
    with open(out) as f:
        got = json.load(f)
    assert got["processes"] == 2
    assert got["mesh"] == {"batch": batch_shards,
                           "nodes": 2 * local_shards // batch_shards}
    assert got["results"] == [[r.placements, r.fail_type, r.fail_message]
                              for r in refs]


@pytest.mark.parametrize("num_shards", [1, 2, 3, 5])
def test_split_objects_matches_jax(num_shards):
    from cluster_capacity_tpu.parallel import distributed as jdist
    from cluster_capacity_tpu_torch.parallel import distributed as tdist
    nodes, _pod = _cluster_objects()
    assert tdist.split_objects(nodes, num_shards) == \
        jdist.split_objects(nodes, num_shards)


def test_shard_roundtrip(tmp_path):
    """Single-process pieces: the sharded write reproduces the object set
    in order, and the single-process load builds the snapshot the JAX
    package's loader builds from the same files."""
    from cluster_capacity_tpu.parallel import distributed as jdist
    from cluster_capacity_tpu_torch.parallel import distributed as tdist
    nodes, _pod = _cluster_objects()
    base = str(tmp_path / "s")
    paths = tdist.write_sharded_snapshot(base, nodes, num_shards=3,
                                         pods=[], services=[])
    jbase = str(tmp_path / "j")
    jpaths = jdist.write_sharded_snapshot(jbase, nodes, num_shards=3,
                                          pods=[], services=[])
    for p, q in zip(paths, jpaths):
        with open(p) as f, open(q) as g:
            assert json.load(f) == json.load(g)
    gathered = []
    for k in range(3):
        gathered.extend(tdist.load_shard(base, k)["nodes"])
    assert [n["metadata"]["name"] for n in gathered] == \
        [n["metadata"]["name"] for n in nodes]
    snap = tdist.load_snapshot_distributed(base)
    jsnap = jdist.load_snapshot_distributed(base)
    assert snap.num_nodes == jsnap.num_nodes == len(nodes)
    assert snap.node_names == jsnap.node_names
    assert np.array_equal(snap.allocatable, np.asarray(jsnap.allocatable))
    with pytest.raises(FileNotFoundError):
        tdist.load_snapshot_distributed(str(tmp_path / "missing"))


def test_single_process_pieces():
    """Without a process group: one process, rank 0, allgather returns the
    local payload, initialize() with one process joins nothing, and the
    global and local meshes are the process's own logical CPU shards."""
    from cluster_capacity_tpu_torch.parallel import distributed as tdist
    assert (tdist.process_count(), tdist.process_index()) == (1, 0)
    assert tdist.allgather_objects({"a": 1}) == [{"a": 1}]
    tdist.initialize(num_processes=1)
    assert tdist.process_count() == 1
    assert tdist.global_mesh(2, device="cpu", local_shards=4).shape == \
        {"batch": 2, "nodes": 2}
    assert tdist.local_mesh(device="cpu", local_shards=3).shape == \
        {"batch": 1, "nodes": 3}
    with pytest.raises(ValueError, match="CC_COORDINATOR"):
        tdist.initialize(coordinator_address="", num_processes=2,
                         process_id=0)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.exit(_worker(sys.argv[2], sys.argv[3], int(sys.argv[4]),
                         int(sys.argv[5]), int(sys.argv[6]),
                         int(sys.argv[7]), sys.argv[8]))

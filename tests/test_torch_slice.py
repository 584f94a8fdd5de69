"""The port end to end on the CPU against the JAX package: ClusterCapacity
placements, stop reason, message, per-reason counts and the -o json report;
the CLI's JSON output on examples/; and the inputs the port refuses.

Tolerance: exact (==) on placements, strings and counts; the JSON reports
are compared as parsed objects, without their creation timestamps.
"""

import dataclasses
import io
import json
import os

import numpy as np
import pytest

from cluster_capacity_tpu import ClusterCapacity as JCC
from cluster_capacity_tpu.cli import cluster_capacity as jcli
from cluster_capacity_tpu.models.podspec import default_pod as j_default_pod
from cluster_capacity_tpu.utils.config import SchedulerProfile as JProfile
from cluster_capacity_tpu.utils.config import \
    load_scheduler_config as j_load_scheduler_config
from cluster_capacity_tpu.utils.report import print_review as j_print_review
from cluster_capacity_tpu_torch import ClusterCapacity as TCC
from cluster_capacity_tpu_torch.cli import cluster_capacity as tcli
from cluster_capacity_tpu_torch.models.podspec import default_pod as t_default_pod
from cluster_capacity_tpu_torch.utils.config import SchedulerProfile as TProfile
from cluster_capacity_tpu_torch.utils.config import load_scheduler_config
from cluster_capacity_tpu_torch.utils.report import print_review as t_print_review

from test_torch_kernel import HOST, ZONE, spread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readme_cluster():
    the_pod = {"metadata": {"name": "p"}, "spec": {"containers": [
        {"name": "c", "resources": {"requests": {"cpu": "150m",
                                                 "memory": "100Mi"}}}]}}
    node_list = [{"metadata": {"name": f"n{i}"}, "spec": {},
                  "status": {"allocatable": {"cpu": "2", "memory": "4Gi",
                                             "pods": "110"}}}
                 for i in range(4)]
    return node_list, the_pod


def bench_shaped_cluster(n=512, zones=16, seed=0):
    """bench.py's scan cluster shape at 512 nodes, with small CPUs so the
    run ends Unschedulable after a few thousand placements."""
    rng = np.random.RandomState(seed)
    cpu = rng.choice([200, 400, 800], size=n)
    mem = rng.choice([64, 128, 256], size=n)
    node_list = [{"metadata": {"name": f"node-{i:06d}", "labels": {
                      HOST: f"node-{i:06d}", ZONE: f"zone-{i % zones}"}},
                  "spec": {},
                  "status": {"allocatable": {
                      "cpu": f"{int(cpu[i])}m",
                      "memory": str(int(mem[i]) * 1024 ** 3),
                      "pods": "110"}}}
                 for i in range(n)]
    the_pod = {"metadata": {"name": "bench-pod", "labels": {"app": "bench"}},
               "spec": {"containers": [{"name": "c0", "image": "app:v1",
                                        "resources": {"requests": {
                                            "cpu": "100m",
                                            "memory": "256Mi"}}}],
                        "topologySpreadConstraints": [
                            spread(ZONE, 16, "DoNotSchedule", "bench")]}}
    return node_list, the_pod


def profile_of(mode, seed=7):
    """A profile builder for both packages: 'default' (float32,
    deterministic), 'parity' (float64), 'random' (deterministic=False,
    seeded) or 'random_parity'."""
    def build(cls):
        p = cls.parity() if mode in ("parity", "random_parity") else cls()
        if mode.startswith("random"):
            p.deterministic = False
            p.seed = seed
        return p
    return build


def run_both(node_list, the_pod, max_limit=0, pods=(), profile=None,
             bounds=True):
    profile = profile or profile_of("default")
    jcc = JCC(j_default_pod(the_pod), max_limit=max_limit,
              profile=profile(JProfile), bounds=bounds)
    jcc.sync_with_objects(node_list, list(pods))
    jres = jcc.run()
    tcc = TCC(t_default_pod(the_pod), max_limit=max_limit,
              profile=profile(TProfile), bounds=bounds, device="cpu")
    tcc.sync_with_objects(node_list, list(pods))
    tres = tcc.run()
    return jcc, jres, tcc, tres


def report_json(cc, printer):
    buf = io.StringIO()
    printer(cc.report(), fmt="json", out=buf)
    data = json.loads(buf.getvalue())
    data["status"].pop("creationTimestamp")
    return data


def assert_same_run(jcc, jres, tcc, tres):
    assert tres.placements == jres.placements
    assert tres.fail_type == jres.fail_type
    assert tres.fail_message == jres.fail_message
    assert tres.fail_counts == jres.fail_counts
    assert (tres.rung, tres.degraded) == (jres.rung, jres.degraded)
    assert report_json(tcc, t_print_review) == report_json(jcc, j_print_review)
    assert [p["spec"]["nodeName"] for p in tcc.scheduled_pods()] == \
        [p["spec"]["nodeName"] for p in jcc.scheduled_pods()]


@pytest.mark.parametrize("max_limit", [0, 10, 52, 100])
def test_readme_demo_matches_jax(max_limit):
    node_list, the_pod = readme_cluster()
    jcc, jres, tcc, tres = run_both(node_list, the_pod, max_limit)
    assert_same_run(jcc, jres, tcc, tres)
    if max_limit in (0, 100):
        assert tres.placed_count == 52
        assert set(tres.per_node_counts.values()) == {13}
        assert tres.fail_message == \
            "0/4 nodes are available: 4 Insufficient cpu."
    else:
        assert tres.placed_count == max_limit
        assert tres.fail_type == "LimitReached"


@pytest.mark.parametrize("max_limit", [0, 1000])
def test_bench_shaped_512_nodes_matches_jax(max_limit):
    node_list, the_pod = bench_shaped_cluster()
    jcc, jres, tcc, tres = run_both(node_list, the_pod, max_limit)
    assert_same_run(jcc, jres, tcc, tres)
    if max_limit:
        assert tres.fail_type == "LimitReached"
    else:
        assert tres.fail_type == "Unschedulable" and tres.placed_count > 2000


def _cli_out(module, argv, capsys):
    assert module.run(argv) == 0
    return capsys.readouterr().out.splitlines()


def test_cli_json_matches_jax_on_examples(capsys):
    argv = ["--podspec", os.path.join(REPO, "examples", "pod.yaml"),
            "--snapshot", os.path.join(REPO, "examples",
                                       "cluster-snapshot.yaml"),
            "-o", "json"]
    want, = _cli_out(jcli, argv, capsys)
    got, = _cli_out(tcli, argv + ["--device", "cpu"], capsys)
    want, got = json.loads(want), json.loads(got)
    for data in (want, got):
        data["status"].pop("creationTimestamp")
    assert got == want
    assert got["status"]["replicas"] > 0


@pytest.mark.parametrize("fmt", [["-o", "yaml"], ["--verbose"], []],
                         ids=["yaml", "pretty-verbose", "pretty"])
def test_cli_text_output_matches_jax_on_examples(capsys, fmt):
    """yaml and pretty output, line for line (timestamps dropped)."""
    argv = ["--podspec", os.path.join(REPO, "examples", "pod.yaml"),
            "--snapshot", os.path.join(REPO, "examples",
                                       "cluster-snapshot.yaml")] + fmt
    got = _cli_out(tcli, argv + ["--device", "cpu"], capsys)
    want = _cli_out(jcli, argv, capsys)
    drop = lambda lines: [x for x in lines if "creationTimestamp" not in x]
    assert drop(got) == drop(want) and len(got) == len(want)


def test_out_of_slice_inputs_raise(tmp_path):
    """A mesh, float64 parity, the random tie-break, explain, DRA claims and
    a configuration with extenders are served and equal the JAX package
    (extender runs: tests/test_torch_extenders.py); a mesh of another
    device type than the solve's raises."""
    from cluster_capacity_tpu.parallel import mesh as jmesh
    from cluster_capacity_tpu_torch.parallel import mesh as tmesh
    node_list, base = readme_cluster()
    with pytest.raises(ValueError, match="do not match"):
        TCC(t_default_pod(base), device="cpu",
            mesh=tmesh.Mesh([["cuda:0"]]))
    jcc = JCC(j_default_pod(base), mesh=jmesh.make_mesh(2, 2))
    tcc = TCC(t_default_pod(base), device="cpu",
              mesh=tmesh.make_mesh(2, 2, device="cpu"))
    for cc in (jcc, tcc):
        cc.sync_with_objects(node_list)
    jres, tres = jcc.run(), tcc.run()
    assert_same_run(jcc, jres, tcc, tres)
    assert tres.rung == "sharded_batched"
    jcc = JCC(j_default_pod(base), explain=True)
    tcc = TCC(t_default_pod(base), explain=True, device="cpu")
    for cc in (jcc, tcc):
        cc.sync_with_objects(node_list)
    jres, tres = jcc.run(), tcc.run()
    assert_same_run(jcc, jres, tcc, tres)
    assert tres.explain.to_dict() == jres.explain.to_dict()
    for mode in ("parity", "random"):
        jcc, jres, tcc, tres = run_both(node_list, base,
                                        profile=profile_of(mode))
        assert_same_run(jcc, jres, tcc, tres)
        assert tres.placed_count == 52 and tres.fail_message == \
            "0/4 nodes are available: 4 Insufficient cpu."
    # PVCs, inline disks, DefaultPreemption with victims and DRA claims are
    # served (tests/test_torch_volumes.py, test_torch_preemption.py,
    # test_torch_dra.py): a claim no object backs fails pod-level
    dra_pod = dict(base, spec=dict(base["spec"], resourceClaims=[
        {"name": "gpu", "resourceClaimName": "c"}]))
    jcc, jres, tcc, tres = run_both(node_list, dra_pod)
    assert_same_run(jcc, jres, tcc, tres)
    assert 'resourceclaim "c" not found' in tres.fail_message
    ext = tmp_path / "ext.yaml"
    ext.write_text("apiVersion: kubescheduler.config.k8s.io/v1\n"
                   "kind: KubeSchedulerConfiguration\n"
                   "profiles:\n- schedulerName: default-scheduler\n"
                   "extenders:\n- urlPrefix: http://localhost:1\n"
                   "  filterVerb: filter\n")
    tprof = load_scheduler_config(str(ext))
    jprof = j_load_scheduler_config(str(ext))
    assert [dataclasses.asdict(e) for e in tprof.extenders] == \
        [dataclasses.asdict(e) for e in jprof.extenders]
    assert tprof.extenders[0].filter_verb == "filter"


def test_no_victim_preemption_run_is_served():
    """Equal-priority existing pods cannot be preempted: the JAX package's
    PostFilter leaves the result unchanged, and the port serves the run."""
    node_list, the_pod = readme_cluster()
    existing = [{"metadata": {"name": f"e{i}", "namespace": "default"},
                 "spec": {"nodeName": f"n{i}", "containers": [
                     {"name": "c", "resources": {"requests": {"cpu": "500m"}}}]}}
                for i in range(2)]
    jcc, jres, tcc, tres = run_both(node_list, the_pod, pods=existing)
    assert_same_run(jcc, jres, tcc, tres)


def test_cli_refuses_later_flags(capsys):
    """--parity, --no-bounds and --explain are served, byte for byte the
    JAX CLI's output (creation timestamps dropped), for one podspec and for
    a sweep; the flags of later slices stay refused by name (not
    argparse's "unrecognized arguments"); --period-iterations is served
    (tests/test_torch_cli_frontend.py holds the loop flags)."""
    base = ["--podspec", os.path.join(REPO, "examples", "pod.yaml"),
            "--snapshot", os.path.join(REPO, "examples",
                                       "cluster-snapshot.yaml")]
    drop = lambda lines: [x for x in lines if "creationTimestamp" not in x]
    sweep = ["--podspec", os.path.join(REPO, "examples", "pod-spec.yaml")]
    for extra in (["--parity", "-o", "json"], ["--parity", "--verbose"],
                  ["--no-bounds", "-o", "yaml"],
                  sweep + ["--parity", "--no-bounds", "-o", "json"],
                  ["--explain", "--verbose"],
                  sweep + ["--explain", "-o", "yaml"]):
        want = _cli_out(jcli, base + extra, capsys)
        got = _cli_out(tcli, base + extra + ["--device", "cpu"], capsys)
        assert drop(got) == drop(want) and len(got) == len(want), extra
    for flag in (["--mesh", "2x4"], ["--mesh=auto"]):
        # served: the JAX CLI's bytes ('auto' is 2x4 on the JAX package's
        # eight CPU devices and unsharded on the port's CPU)
        want = _cli_out(jcli, base + flag + ["-o", "json"], capsys)
        got = _cli_out(tcli, base + ["--device", "cpu", "-o", "json"]
                       + flag, capsys)
        assert drop(got) == drop(want) and len(got) == len(want), flag
    # --interleave is served (tests/test_torch_interleave.py holds it to
    # the JAX CLI); with one podspec it changes nothing
    assert _cli_out(tcli, base + ["--device", "cpu", "--interleave"],
                    capsys) == ["52"]
    for flag in (["--period-iterations", "3"], ["--period-iterations=3"]):
        want = _cli_out(jcli, base + flag, capsys)
        got = _cli_out(tcli, base + flag + ["--device", "cpu"], capsys)
        assert got == want == ["52"], flag

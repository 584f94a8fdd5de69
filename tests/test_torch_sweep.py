"""The port's what-if sweep on the CPU against the JAX package's sweep:
per template placements, stop reason, message, per-reason counts, rung and
degraded; the review's worst rung; the CLI with two --podspec on examples/;
and the options the port refuses.

Both packages encode the templates themselves here (the sweep encodes), so
these hold the whole slice, encoder included.  Tolerance: exact (==); JSON
reports are compared as parsed objects without their creation timestamps.
"""

import io
import json
import os

import pytest

from cluster_capacity_tpu.cli import cluster_capacity as jcli
from cluster_capacity_tpu.models.podspec import default_pod as j_default_pod
from cluster_capacity_tpu.models.snapshot import ClusterSnapshot as JSnap
from cluster_capacity_tpu.parallel import sweep as jsweep
from cluster_capacity_tpu.utils.config import SchedulerProfile as JProfile
from cluster_capacity_tpu.utils.report import build_review as j_build_review
from cluster_capacity_tpu.utils.report import print_review as j_print_review
from cluster_capacity_tpu_torch.cli import cluster_capacity as tcli
from cluster_capacity_tpu_torch.models.podspec import default_pod as t_default_pod
from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot as TSnap
from cluster_capacity_tpu_torch.parallel import sweep as tsweep
from cluster_capacity_tpu_torch.utils.config import SchedulerProfile as TProfile
from cluster_capacity_tpu_torch.utils.report import build_review as t_build_review
from cluster_capacity_tpu_torch.utils.report import print_review as t_print_review

from helpers import build_test_node, build_test_pod
from test_torch_fast_path import small_limit_mix
from test_torch_fused_batched import sweep_cluster, sweep_templates

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sweep_both(node_list, templates, max_limit, existing=(), objs=None,
               **kw):
    objs = objs or {}
    jt = [j_default_pod(t) for t in templates]
    tt = [t_default_pod(t) for t in templates]
    jres = jsweep.sweep(JSnap.from_objects(node_list, list(existing), **objs),
                        jt, profile=JProfile(), max_limit=max_limit, **kw)
    tres = tsweep.sweep(TSnap.from_objects(node_list, list(existing), **objs),
                        tt, profile=TProfile(), max_limit=max_limit,
                        device="cpu", **kw)
    return jt, jres, tt, tres


def review_json(review, printer):
    buf = io.StringIO()
    printer(review, fmt="json", out=buf)
    data = json.loads(buf.getvalue())
    data["status"].pop("creationTimestamp")
    return data


def assert_same_sweep(jt, jres, tt, tres):
    assert len(tres) == len(jres)
    for t, (a, b) in enumerate(zip(tres, jres)):
        assert a.placements == b.placements, t
        assert (a.placed_count, a.fail_type, a.fail_message, a.fail_counts,
                a.rung, a.degraded) == (b.placed_count, b.fail_type,
                                        b.fail_message, b.fail_counts,
                                        b.rung, b.degraded), t
    assert review_json(t_build_review(tt, tres), t_print_review) == \
        review_json(j_build_review(jt, jres), j_print_review)


@pytest.mark.parametrize("max_limit,n_nodes", [(40, 48), (0, 24)],
                         ids=["limit40", "unlimited"])
def test_template_mix_matches_jax(max_limit, n_nodes):
    jt, jres, tt, tres = sweep_both(sweep_cluster(n_nodes),
                                    sweep_templates(), max_limit)
    assert_same_sweep(jt, jres, tt, tres)
    assert {r.rung for r in tres} == {"fused", "fused_batched"}
    if not max_limit:
        assert any(r.fail_type == "Unschedulable" for r in tres)


@pytest.mark.parametrize("max_limit", [3, 7])
def test_small_limit_mix_matches_jax(max_limit):
    """The config-5 mix: a fast-path group (unstamped results), a batched
    kernel group and templates solved alone in one sweep."""
    nodes, templates = small_limit_mix()
    jt, jres, tt, tres = sweep_both(nodes, templates, max_limit)
    assert_same_sweep(jt, jres, tt, tres)
    assert "" in {r.rung for r in tres}


def test_worst_rung_of_mixed_sweep():
    """The first template rides a batched group, another is solved alone:
    the review reports the worst rung ('fused'), as the JAX package does."""
    by_name = {t["metadata"]["name"]: t for t in sweep_templates()}
    templates = [by_name["sp1"], by_name["sp2"], by_name["plain"]]
    jt, jres, tt, tres = sweep_both(sweep_cluster(), templates, 40)
    assert [r.rung for r in tres] == ["fused_batched", "fused_batched",
                                      "fused"]
    assert t_build_review(tt, tres).rung == "fused"
    assert_same_sweep(jt, jres, tt, tres)


def test_dedup_exactness_float32():
    """Templates identical up to their own names share one solve; a label an
    existing pod's selector references keeps its template apart."""
    nodes = [build_test_node(f"n{i}", 8000, 32 * 1024 ** 3, 110,
                             labels={"kubernetes.io/hostname": f"n{i}"})
             for i in range(4)]
    anchor = build_test_pod("anchor", 10, 10, node_name="n2",
                            labels={"role": "anchor"})
    anchor["spec"]["affinity"] = {"podAffinity": {
        "requiredDuringSchedulingIgnoredDuringExecution": [{
            "topologyKey": "kubernetes.io/hostname",
            "labelSelector": {"matchLabels": {"app": "magnet"}}}]}}
    templates = [build_test_pod(f"t{k}", 100, 1024 ** 3,
                                labels={"app": app})
                 for k, app in enumerate(["t0", "t1", "magnet", "t3"])]
    objs = {"namespaces": [{"metadata": {"name": "default"}}]}
    for max_limit in (4, 5000):
        jt, jres, tt, tres = sweep_both(nodes, templates, max_limit,
                                        existing=[anchor], objs=objs)
        assert_same_sweep(jt, jres, tt, tres)
        assert tres[0].placements == tres[1].placements == tres[3].placements
        assert tres[2].placements[0] == 2          # pulled to the anchor
        assert tres[1].placements is not tres[0].placements


def test_queue_sort_alignment():
    nodes = [build_test_node("n1", 8000, 32 * 1024 ** 3, 110)]
    low = build_test_pod("low", 100, 0)
    low["spec"]["priority"] = 0
    high = build_test_pod("high", 200, 0)
    high["spec"]["priority"] = 100
    jt, jres, tt, tres = sweep_both(nodes, [low, high], 5, queue_sort=True)
    assert_same_sweep(jt, jres, tt, tres)
    assert [r.placed_count for r in tres] == [5, 5]


def _cli(module, argv, capsys):
    assert module.run(argv) == 0
    return capsys.readouterr().out.splitlines()


EXAMPLES = ["--podspec", os.path.join(REPO, "examples", "pod.yaml"),
            "--podspec", os.path.join(REPO, "examples", "pod-spec.yaml"),
            "--snapshot", os.path.join(REPO, "examples",
                                       "cluster-snapshot.yaml")]


@pytest.mark.parametrize("fmt", [["-o", "json"], ["-o", "json",
                                                  "--max-limit", "20"],
                                 ["-o", "yaml"], ["--verbose"], []],
                         ids=["json", "json-limit20", "yaml",
                              "pretty-verbose", "pretty"])
def test_cli_sweep_matches_jax_on_examples(capsys, fmt):
    want = _cli(jcli, EXAMPLES + fmt, capsys)
    got = _cli(tcli, EXAMPLES + fmt + ["--device", "cpu"], capsys)
    if fmt[:2] == ["-o", "json"]:
        want, got = json.loads(want[0]), json.loads(got[0])
        for data in (want, got):
            data["status"].pop("creationTimestamp")
        assert len(got["status"]["pods"]) == 2
    else:
        drop = lambda lines: [x for x in lines
                              if "creationTimestamp" not in x]
        assert len(got) == len(want)
        got, want = drop(got), drop(want)
    assert got == want


def test_unported_options_raise(capsys):
    """Every sweep option is served: a mesh (the sharded group equals the
    JAX package's sharded sweep), explain, --interleave and --mesh; only
    --interleave together with --mesh stays refused by name."""
    from cluster_capacity_tpu.parallel import mesh as jmesh
    from cluster_capacity_tpu_torch.parallel import mesh as tmesh
    nodes = sweep_cluster(8)
    snap = TSnap.from_objects(nodes)
    pods = [t_default_pod(t) for t in sweep_templates()[:2]]
    want = jsweep.sweep(JSnap.from_objects(nodes),
                        [j_default_pod(t) for t in sweep_templates()[:2]],
                        max_limit=5000, mesh=jmesh.make_mesh(2, 2))
    got = tsweep.sweep(snap, pods, max_limit=5000,
                       mesh=tmesh.make_mesh(2, 2, device="cpu"),
                       device="cpu")
    assert [(r.placements, r.fail_message, r.rung) for r in got] == \
        [(r.placements, r.fail_message, r.rung) for r in want]
    # explain is served (tests/test_torch_explain.py holds it to the JAX
    # sweep): every template carries attribution
    assert all(r.explain is not None for r in
               tsweep.sweep(snap, pods, explain=True, device="cpu"))
    # interleaved sweeps are served (tests/test_torch_interleave.py), and
    # so is --mesh; the two together are not yet
    assert tcli.run(EXAMPLES + ["--interleave", "--device", "cpu"]) == 0
    capsys.readouterr()
    assert tcli.run(EXAMPLES + ["--mesh", "1x1", "--device", "cpu"]) == 0
    out_t = capsys.readouterr().out
    assert jcli.run(EXAMPLES + ["--mesh", "1x1"]) == 0
    assert out_t == capsys.readouterr().out
    assert tcli.run(EXAMPLES + ["--interleave", "--mesh", "1x1",
                                "--device", "cpu"]) == 2
    assert "not ported yet" in capsys.readouterr().err

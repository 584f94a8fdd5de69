"""The port's explain (explain/, the explain step, the closed form's and the
oracle's attribution, the group why-not, ClusterCapacity/sweep/CLI
threading) against the JAX package's, on tests/test_explain.py's problems:
fuzz seeds 7100-7105, the closed-form cluster, the examples/ snapshot.

Both packages encode the same objects themselves; every rung's
Explanation.to_dict() (why-here rows, final codes, elimination steps and
codes, the reason histogram, feasible nodes, the bottleneck table, the
rung) must be equal, with the placements, fail type, message and counts.
The CLIs' --explain and cli/explain.py output is byte-equal in pretty,
json and yaml (the review's creationTimestamp aside).  Tolerance: exact.
"""

import io
import json
import os

import numpy as np
import pytest

from cluster_capacity_tpu import ClusterCapacity as JCC
from cluster_capacity_tpu.cli import cluster_capacity as jcli
from cluster_capacity_tpu.cli import explain as jexplain_cli
from cluster_capacity_tpu.engine import encode as jenc
from cluster_capacity_tpu.engine import fast_path as jfast
from cluster_capacity_tpu.engine import simulator as jsim
from cluster_capacity_tpu.models.podspec import default_pod as j_default_pod
from cluster_capacity_tpu.models.snapshot import ClusterSnapshot as JSnap
from cluster_capacity_tpu.parallel import sweep as jsweep
from cluster_capacity_tpu.runtime import degrade as jdegrade
from cluster_capacity_tpu.runtime import faults as jfaults
from cluster_capacity_tpu.utils.config import SchedulerProfile as JProfile
from cluster_capacity_tpu.utils.report import print_review as j_print_review
from cluster_capacity_tpu_torch import ClusterCapacity as TCC
from cluster_capacity_tpu_torch.cli import cluster_capacity as tcli
from cluster_capacity_tpu_torch.cli import explain as texplain_cli
from cluster_capacity_tpu_torch.engine import encode as tenc
from cluster_capacity_tpu_torch.engine import fast_path as tfast
from cluster_capacity_tpu_torch.engine import simulator as tsim
from cluster_capacity_tpu_torch.explain import PLUGINS, Explanation
from cluster_capacity_tpu_torch.explain import attribution
from cluster_capacity_tpu_torch.models.podspec import default_pod as t_default_pod
from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot as TSnap
from cluster_capacity_tpu_torch.parallel import sweep as tsweep
from cluster_capacity_tpu_torch.runtime import degrade as tdegrade
from cluster_capacity_tpu_torch.runtime import faults as tfaults
from cluster_capacity_tpu_torch.utils.config import SchedulerProfile as TProfile
from cluster_capacity_tpu_torch.utils.report import (ClusterCapacityReview,
                                                     print_review as
                                                     t_print_review)

from helpers import build_test_node, build_test_pod
from test_fuzz import fuzz_cluster, fuzz_pod
from test_torch_fused_batched import sweep_cluster, sweep_templates

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
NS = [{"metadata": {"name": "default"}}]
SEEDS = range(7100, 7106)


def _profiles(kind):
    if kind == "parity":
        return JProfile.parity(), TProfile.parity()
    jp, tp = JProfile(), TProfile()
    if kind == "random":
        for p in (jp, tp):
            p.deterministic = False
            p.seed = 3
    return jp, tp


def _fuzz_objects(seed):
    rng = np.random.RandomState(seed)
    nodes, pods = fuzz_cluster(rng, int(rng.choice([6, 10, 16])))
    return nodes, pods, fuzz_pod(rng)


def encode_both(nodes, pods, the_pod, kind, **objs):
    jp, tp = _profiles(kind)
    jpb = jenc.encode_problem(JSnap.from_objects(nodes, pods, **objs),
                              j_default_pod(the_pod), jp)
    tpb = tenc.encode_problem(TSnap.from_objects(nodes, pods, **objs),
                              t_default_pod(the_pod), tp)
    return jpb, tpb


def assert_same_result(jres, tres):
    assert tres.placements == jres.placements
    assert tres.fail_type == jres.fail_type
    assert tres.fail_message == jres.fail_message
    assert tres.fail_counts == jres.fail_counts
    assert tres.rung == jres.rung and tres.degraded == jres.degraded
    if jres.explain is None:
        assert tres.explain is None
    else:
        assert tres.explain.to_dict() == jres.explain.to_dict()


@pytest.mark.parametrize("kind", ["default", "parity", "random"])
@pytest.mark.parametrize("seed", SEEDS)
def test_scan_explain_matches_jax(seed, kind):
    """The explain step's attribution (why-here rows, sticky elimination
    record, terminal codes) equals the JAX explain scan's."""
    jpb, tpb = encode_both(*_fuzz_objects(seed), kind, namespaces=NS)
    jres = jsim.solve(jpb, explain=True)
    tres = tsim.solve(tpb, device="cpu", explain=True)
    assert_same_result(jres, tres)
    assert tres.explain.rung == "scan"


@pytest.mark.parametrize("seed", SEEDS)
def test_scan_vs_oracle_attribution(seed):
    """The port's explain step against the port's oracle (the JAX test's
    differential): why-here, and on exhausted runs elimination steps and
    the histogram."""
    _jpb, pb = encode_both(*_fuzz_objects(seed), "parity", namespaces=NS)
    got = tsim.solve(pb, device="cpu", explain=True)
    ref = tdegrade._solve_oracle(pb, explain=True)
    assert got.placements == ref.placements
    ge, re_ = got.explain, ref.explain
    np.testing.assert_array_equal(ge.why_here, re_.why_here)
    if got.fail_type == tsim.FAIL_UNSCHEDULABLE:
        np.testing.assert_array_equal(ge.elim_step, re_.elim_step)
        assert ge.reason_histogram == re_.reason_histogram
        assert ge.feasible_nodes == re_.feasible_nodes == 0


@pytest.mark.parametrize("seed", SEEDS)
def test_histogram_equals_diagnose(seed):
    _jpb, pb = encode_both(*_fuzz_objects(seed), "parity", namespaces=NS)
    got = tsim.solve(pb, device="cpu", explain=True)
    if got.fail_type == tsim.FAIL_UNSCHEDULABLE:
        assert got.explain.reason_histogram == got.fail_counts
    plain = tsim.solve(pb, device="cpu")
    assert plain.placements == got.placements
    assert plain.fail_counts == got.fail_counts


@pytest.mark.parametrize("kind", ["default", "parity"])
@pytest.mark.parametrize("seed", SEEDS)
def test_oracle_explain_matches_jax(seed, kind):
    jpb, tpb = encode_both(*_fuzz_objects(seed), kind, namespaces=NS)
    for limit in (0, 5):
        assert_same_result(jdegrade._solve_oracle(jpb, limit, explain=True),
                           tdegrade._solve_oracle(tpb, limit, explain=True))


def _fast_objects():
    nodes = [build_test_node(f"node-{i}", 2000, 4 * 1024 ** 3, 110)
             for i in range(4)]
    return nodes, [], build_test_pod("p", 150, 100 * 1024 ** 2)


@pytest.mark.parametrize("kind", ["default", "parity"])
@pytest.mark.parametrize("max_limit", [0, 7])
def test_fast_path_explain_matches_jax(max_limit, kind):
    """The closed form's attribution (gathered why-here, synthesized
    elimination steps) equals the JAX fast path's and the port's own
    explain step's and oracle's."""
    jpb, tpb = encode_both(*_fast_objects(), kind)
    jres = jfast.solve_fast(jpb, max_limit=max_limit, explain=True)
    fast = tfast.solve_fast(tpb, max_limit=max_limit, device="cpu",
                            explain=True)
    assert fast is not None and fast.explain.rung == "fast_path"
    assert_same_result(jres, fast)
    scan = tsim.solve(tpb, max_limit=max_limit, device="cpu", explain=True)
    ref = tdegrade._solve_oracle(tpb, max_limit=max_limit, explain=True)
    assert fast.placements == scan.placements == ref.placements
    fe, se = fast.explain, scan.explain
    np.testing.assert_array_equal(fe.why_here, se.why_here)
    np.testing.assert_array_equal(fe.final_codes, se.final_codes)
    np.testing.assert_array_equal(fe.elim_step, se.elim_step)
    np.testing.assert_array_equal(fe.elim_code, se.elim_code)
    np.testing.assert_array_equal(fe.elim_step, ref.explain.elim_step)
    if kind == "parity":
        np.testing.assert_array_equal(fe.why_here, ref.explain.why_here)


def _example_objects():
    from cluster_capacity_tpu_torch.utils.snapshot_io import (
        load_snapshot_objects)
    import yaml
    objs = load_snapshot_objects(os.path.join(EXAMPLES,
                                              "cluster-snapshot.yaml"))
    with open(os.path.join(EXAMPLES, "pod.yaml")) as f:
        pod = yaml.safe_load(f)
    return objs, pod


@pytest.mark.parametrize("kind", ["default", "parity"])
def test_golden_examples_snapshot(kind):
    objs, pod = _example_objects()
    jp, tp = _profiles(kind)
    results = []
    for cc_cls, snap_cls, dp, prof, kw in (
            (JCC, JSnap, j_default_pod, jp, {}),
            (TCC, TSnap, t_default_pod, tp, {"device": "cpu"})):
        o = dict(objs)
        cc = cc_cls(dp(pod), profile=prof, explain=True, **kw)
        cc.set_snapshot(snap_cls.from_objects(o.pop("nodes", []),
                                              o.pop("pods", []), **o))
        results.append(cc.run())
    jres, tres = results
    assert_same_result(jres, tres)
    expl = tres.explain
    assert tres.placed_count == 52
    assert expl.reason_histogram == {"Insufficient cpu": 4}
    assert expl.why_here.shape == (52, len(PLUGINS))
    assert sorted(int(s) for s in expl.elim_step) == [49, 50, 51, 52]
    assert expl.bottleneck["bindingCounts"] == {"cpu": 4}


def test_explanation_roundtrip():
    _jpb, pb = encode_both(*_fuzz_objects(7100), "parity", namespaces=NS)
    got = tsim.solve(pb, device="cpu", explain=True)
    d1 = got.explain.to_dict()
    d2 = Explanation.from_dict(json.loads(json.dumps(d1))).to_dict()
    assert d1 == d2


def _review_text(cc, printer, fmt):
    buf = io.StringIO()
    printer(cc.report(), verbose=True, fmt=fmt, out=buf)
    text = buf.getvalue()
    if fmt == "json":
        data = json.loads(text)
        data["status"].pop("creationTimestamp")
        return data
    return text


def test_report_carries_reasons_and_explain():
    nodes = [build_test_node(f"n{i}", 2000, 4 * 1024 ** 3, 110)
             for i in (1, 2)]
    the_pod = build_test_pod("p", 500, 1024 ** 3)
    jcc = JCC(j_default_pod(the_pod), profile=JProfile.parity(),
              explain=True)
    tcc = TCC(t_default_pod(the_pod), profile=TProfile.parity(),
              explain=True, device="cpu")
    jcc.sync_with_objects(nodes)
    tcc.sync_with_objects(nodes)
    jcc.run()
    tcc.run()
    for fmt in ("", "json"):
        assert _review_text(tcc, t_print_review, fmt) \
            == _review_text(jcc, j_print_review, fmt)
    d1 = tcc.report().to_dict()
    pod = d1["status"]["pods"][0]
    assert pod["explain"]["reasons"] == pod["reasons"]
    d2 = ClusterCapacityReview.from_dict(
        json.loads(json.dumps(d1))).to_dict()
    assert d1 == d2
    assert "Explainability for p" in _review_text(tcc, t_print_review, "")


@pytest.mark.parametrize("kind", ["default", "parity"])
@pytest.mark.parametrize("limit", [0, 40])
def test_group_why_not_matches_jax(limit, kind):
    """solve_group(explain=True): why-not from each template's slice of the
    group's terminal carry (kernel 2's plain version on the CPU; the scan
    step per template under parity)."""
    nodes = sweep_cluster(48)
    jp, tp = _profiles(kind)
    jsnap, tsnap = JSnap.from_objects(nodes), TSnap.from_objects(nodes)
    groups = {}
    for t in sweep_templates():
        jpb = jenc.encode_problem(jsnap, j_default_pod(t), jp)
        if jsweep._batchable(jpb):
            key = jsweep._group_key(jpb, jsim.static_config(jpb))
            g = groups.setdefault(key, ([], []))
            g[0].append(jpb)
            g[1].append(tenc.encode_problem(tsnap, t_default_pod(t), tp))
    jpbs, tpbs = max(groups.values(), key=lambda g: len(g[0]))
    assert len(jpbs) >= 2
    jres = jsweep.solve_group(jpbs, max_limit=limit, explain=True)
    tres = tsweep.solve_group(tpbs, max_limit=limit, explain=True,
                              device="cpu")
    for j, t in zip(jres, tres):
        assert_same_result(j, t)
        assert t.explain.rung == "fused_batched"
        assert t.explain.why_here is None


@pytest.mark.parametrize("limit", [0, 30])
def test_sweep_explain_matches_jax(limit):
    """sweep(explain=True) routes every representative through the
    per-template ladder; duplicates share their class's result."""
    nodes = sweep_cluster(40)
    tmpls = list(sweep_templates())[:5]
    tmpls.append(tmpls[0])
    jres = jsweep.sweep(JSnap.from_objects(nodes),
                        [j_default_pod(t) for t in tmpls],
                        profile=JProfile(), max_limit=limit, explain=True)
    tres = tsweep.sweep(TSnap.from_objects(nodes),
                        [t_default_pod(t) for t in tmpls],
                        profile=TProfile(), max_limit=limit, explain=True,
                        device="cpu")
    for j, t in zip(jres, tres):
        assert_same_result(j, t)


@pytest.fixture
def _clean_faults():
    tfaults.clear()
    jfaults.clear()
    yield
    tfaults.clear()
    jfaults.clear()


@pytest.mark.parametrize("spec,rung", [
    ("", "fused"),
    ("engine.solve:oom", "fast_path"),
    ("engine.solve:oom,engine.fast_path:oom", "oracle"),
])
@pytest.mark.parametrize("spread", [False, True])
def test_ladder_explain_matches_jax(spec, rung, spread, _clean_faults):
    """Every rung of solve_one_guarded carries attribution, stamped with
    the rung that served (a spread problem skips the closed form, so its
    fast_path rung answers None and the oracle serves)."""
    nodes = [build_test_node(f"n{i}", 2000, 4 * 1024 ** 3, 8,
                             labels={"topology.kubernetes.io/zone":
                                     f"z{i % 3}"}) for i in range(5)]
    the_pod = build_test_pod("probe", 500, 0, labels={"app": "probe"})
    if spread:
        the_pod["spec"]["topologySpreadConstraints"] = [{
            "maxSkew": 1, "topologyKey": "topology.kubernetes.io/zone",
            "whenUnsatisfiable": "DoNotSchedule",
            "labelSelector": {"matchLabels": {"app": "probe"}}}]
    jpb, tpb = encode_both(nodes, [], the_pod, "parity")
    if spec:
        jfaults.install_text(spec.split(","))
        tfaults.install_text(spec.split(","))
    jres = jdegrade.solve_one_guarded(jpb, explain=True)
    tres = tdegrade.solve_one_guarded(tpb, explain=True, device="cpu")
    assert_same_result(jres, tres)
    want = "oracle" if spread and rung == "fast_path" else rung
    assert tres.rung == want and tres.explain is not None


def test_preemption_explain_matches_jax():
    """ClusterCapacity(explain=True) through the preemption loop: the
    final cycle's attribution, the worst rung."""
    from test_torch_preemption import SCENARIOS
    for name in sorted(SCENARIOS):
        nodes, the_pod, pods, limit, objs = SCENARIOS[name]()
        jcc = JCC(j_default_pod(the_pod), max_limit=limit, explain=True)
        tcc = TCC(t_default_pod(the_pod), max_limit=limit, explain=True,
                  device="cpu")
        jcc.sync_with_objects(nodes, pods, **objs)
        tcc.sync_with_objects(nodes, pods, **objs)
        assert_same_result(jcc.run(), tcc.run())


def _cli_out(run, argv, capsys):
    rc = run(argv)
    out = capsys.readouterr().out
    return rc, out


def _strip_timestamp(text, fmt):
    """The review minus its creationTimestamp (the only field that differs
    between two runs)."""
    return "\n".join(ln for ln in text.splitlines()
                     if "creationTimestamp" not in ln) \
        if fmt != "-o json" else _drop_ts(json.loads(text))


def _drop_ts(data):
    data["status"].pop("creationTimestamp")
    return json.dumps(data)


@pytest.mark.parametrize("fmt", ["", "-o json", "-o yaml"])
@pytest.mark.parametrize("podspecs", [["pod.yaml"],
                                      ["pod.yaml", "pod-spec.yaml"]])
def test_cli_explain_byte_equal(podspecs, fmt, capsys):
    argv = ["--snapshot", os.path.join(EXAMPLES, "cluster-snapshot.yaml"),
            "--explain", "--verbose"]
    for p in podspecs:
        argv += ["--podspec", os.path.join(EXAMPLES, p)]
    argv += fmt.split()
    jrc, jout = _cli_out(jcli.run, argv, capsys)
    trc, tout = _cli_out(tcli.run, argv + ["--device", "cpu"], capsys)
    assert trc == jrc == 0
    assert _strip_timestamp(tout, fmt) == _strip_timestamp(jout, fmt)
    assert "xplain" in tout


@pytest.mark.parametrize("extra", [[], ["--parity"], ["--max-limit", "9"],
                                   ["--nodes", "-1", "--placements", "-1"]])
@pytest.mark.parametrize("fmt", ["", "-o json", "-o yaml"])
def test_explain_cli_byte_equal(fmt, extra, capsys):
    """cli/explain.py against the JAX explain subcommand: the same bytes
    (its output carries no timestamp)."""
    argv = ["--snapshot", os.path.join(EXAMPLES, "cluster-snapshot.yaml"),
            "--podspec", os.path.join(EXAMPLES, "pod.yaml"),
            *extra, *fmt.split()]
    jrc, jout = _cli_out(jexplain_cli.run, argv, capsys)
    trc, tout = _cli_out(texplain_cli.run, argv + ["--device", "cpu"],
                         capsys)
    assert trc == jrc == 0
    assert tout == jout
    if not fmt and not extra:
        assert "Why not" in tout and "Why here" in tout \
            and "Bottleneck" in tout


def test_explain_cli_module_runs():
    """python -m cluster_capacity_tpu_torch.cli.explain on the CPU."""
    import subprocess
    import sys
    proc = subprocess.run(
        [sys.executable, "-m", "cluster_capacity_tpu_torch.cli.explain",
         "--snapshot", os.path.join(EXAMPLES, "cluster-snapshot.yaml"),
         "--podspec", os.path.join(EXAMPLES, "pod.yaml"), "--device",
         "cpu", "-o", "json"],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(proc.stdout)
    assert doc["placed"] == 52
    assert doc["explain"]["reasons"] == {"Insufficient cpu": 4}


def test_final_codes_on_any_terminal_carry():
    """attribution.final_codes reads the reason codes of a terminal carry
    (the closed form's reconstruction here) as host arrays whose histogram
    is diagnose()'s."""
    _jpb, pb = encode_both(*_fast_objects(), "parity")
    res = tfast.solve_fast(pb, device="cpu", explain=True)
    cfg = tsim.static_config(pb)
    consts = tsim.build_consts(pb, "cpu")
    counts = np.bincount(res.placements, minlength=pb.snapshot.num_nodes)
    carry = tsim._init_carry(pb, consts)
    import torch
    carry = carry._replace(
        requested=torch.tensor(pb.init_requested
                               + np.outer(counts, pb.req_vec)),
        nonzero=torch.tensor(pb.init_nonzero
                             + np.outer(counts, pb.req_nonzero)),
        placed=torch.tensor(counts.astype(np.int32)))
    codes, insufficient, too_many = attribution.final_codes(
        cfg, attribution.explain_consts(pb, consts), carry)
    assert isinstance(codes, np.ndarray) and codes.dtype == np.int32
    np.testing.assert_array_equal(codes, res.explain.final_codes)
    assert tsim.diagnose(pb, cfg, consts, carry) == res.fail_counts

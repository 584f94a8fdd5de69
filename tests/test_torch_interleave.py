"""The port's interleaved shared-state sweeps on the CPU against the JAX
package's: the interleave engine (parallel/interleave.py), the object-level
queue loop (parallel/sweep.sweep_interleaved), the template-mix bracket
(bounds/bracket.bracket_mix) and `cluster-capacity --interleave`.

Every case of tests/test_interleave_tensor.py runs the same fixtures
through both packages in one process: the JAX engine against the port's
(every field of every SolveResult), the JAX object loop against the port's,
and, where the JAX test holds its engine against its object loop, the
port's engine against the port's object loop.  The parity profile is the
JAX tests' own; the plain, topology and sampling mixes also run in
float32.  Tolerance: exact, fallback reason strings and CLI bytes included.
"""

import copy
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest

from cluster_capacity_tpu.bounds import bracket as jbracket
from cluster_capacity_tpu.cli import cluster_capacity as jcli
from cluster_capacity_tpu.engine import encode as jenc
from cluster_capacity_tpu.engine.extenders import ExtenderConfig as JExt
from cluster_capacity_tpu.models.podspec import default_pod as j_default_pod
from cluster_capacity_tpu.models.snapshot import ClusterSnapshot as JSnap
from cluster_capacity_tpu.parallel import interleave as jil
from cluster_capacity_tpu.parallel import sweep as jsweep
from cluster_capacity_tpu.utils.config import SchedulerProfile as JProfile
from cluster_capacity_tpu_torch.bounds import bracket as tbracket
from cluster_capacity_tpu_torch.cli import cluster_capacity as tcli
from cluster_capacity_tpu_torch.engine import encode as tenc
from cluster_capacity_tpu_torch.engine.extenders import ExtenderConfig as TExt
from cluster_capacity_tpu_torch.models.podspec import default_pod as t_default_pod
from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot as TSnap
from cluster_capacity_tpu_torch.parallel import interleave as til
from cluster_capacity_tpu_torch.parallel import sweep as tsweep
from cluster_capacity_tpu_torch.runtime import faults as tfaults
from cluster_capacity_tpu_torch.utils.config import SchedulerProfile as TProfile

from helpers import build_test_node, build_test_pod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"


# ---------------------------------------------------------------------------
# fixtures: tests/test_interleave_tensor.py's, as plain dicts
# ---------------------------------------------------------------------------

def _nodes(n, zones=3, cpus=(2000, 4000), pods=16, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        out.append({
            "metadata": {"name": f"n{i:03d}", "labels": {
                HOST: f"n{i:03d}", ZONE: f"z{i % zones}",
                "disk": "ssd" if i % 2 else "hdd"}},
            "spec": {},
            "status": {"allocatable": {
                "cpu": f"{int(rng.choice(cpus))}m",
                "memory": str(int(rng.choice([4, 8])) * 1024 ** 3),
                "pods": str(pods)}}})
    return out


def _template(name, cpu, mem_gi=0, ns="default", spread=None, soft=None,
              aff=None, anti=None, pref_anti=None, labels=None):
    req = {"cpu": f"{cpu}m"}
    if mem_gi:
        req["memory"] = f"{mem_gi}Gi"
    pod = {"metadata": {"name": name, "namespace": ns,
                        "labels": dict(labels or {"app": name})},
           "spec": {"containers": [{"name": "c", "resources": {
               "requests": req}}]}}
    tsc = []
    if spread:
        tsc.append({"maxSkew": spread[0], "topologyKey": spread[1],
                    "whenUnsatisfiable": "DoNotSchedule",
                    "labelSelector": {"matchLabels": spread[2]}})
    if soft:
        tsc.append({"maxSkew": soft[0], "topologyKey": soft[1],
                    "whenUnsatisfiable": "ScheduleAnyway",
                    "labelSelector": {"matchLabels": soft[2]}})
    if tsc:
        pod["spec"]["topologySpreadConstraints"] = tsc
    affinity = {}
    if aff:
        affinity["podAffinity"] = {
            "requiredDuringSchedulingIgnoredDuringExecution": [
                {"topologyKey": aff[0],
                 "labelSelector": {"matchLabels": aff[1]}}]}
    if anti:
        affinity.setdefault("podAntiAffinity", {})[
            "requiredDuringSchedulingIgnoredDuringExecution"] = [
            {"topologyKey": anti[0],
             "labelSelector": {"matchLabels": anti[1]}}]
    if pref_anti:
        affinity.setdefault("podAntiAffinity", {})[
            "preferredDuringSchedulingIgnoredDuringExecution"] = [
            {"weight": pref_anti[0], "podAffinityTerm": {
                "topologyKey": pref_anti[1],
                "labelSelector": {"matchLabels": pref_anti[2]}}}]
    if affinity:
        pod["spec"]["affinity"] = affinity
    return pod


def _port_template(name, cpu, port, labels=None):
    t = _template(name, cpu, labels=labels)
    t["spec"]["containers"][0]["ports"] = [{"hostPort": port,
                                            "protocol": "TCP"}]
    return t


def _victim_pod(name, node, cpu_m, priority, labels=None):
    return {"metadata": {"name": name, "namespace": "default",
                         "labels": dict(labels or {})},
            "spec": {"nodeName": node, "priority": priority,
                     "containers": [{"name": "c", "resources": {
                         "requests": {"cpu": f"{cpu_m}m"}}}]}}


_PROFILES = {"parity": (JProfile.parity, TProfile.parity),
             "float32": (JProfile, TProfile)}


class Study:
    """One study's inputs, built once per package."""

    def __init__(self, nodes, templates, pods=(), profile="parity",
                 extenders=None, **objs):
        self.jsnap = JSnap.from_objects(copy.deepcopy(nodes),
                                        copy.deepcopy(list(pods)),
                                        **copy.deepcopy(objs))
        self.tsnap = TSnap.from_objects(copy.deepcopy(nodes),
                                        copy.deepcopy(list(pods)),
                                        **copy.deepcopy(objs))
        self.jt = [j_default_pod(copy.deepcopy(t)) for t in templates]
        self.tt = [t_default_pod(copy.deepcopy(t)) for t in templates]
        jmake, tmake = _PROFILES[profile]
        self.jp, self.tp = jmake(), tmake()
        if extenders is not None:
            self.jp.extenders, self.tp.extenders = extenders

    def jax_tensor(self, **kw):
        return jil.solve_interleaved_tensor(self.jsnap, self.jt, self.jp, **kw)

    def port_tensor(self, **kw):
        return til.solve_interleaved_tensor(self.tsnap, self.tt, self.tp,
                                            device="cpu", **kw)

    def jax_object(self, max_total=0):
        return jsweep.sweep_interleaved(self.jsnap, self.jt, self.jp,
                                        max_total=max_total)

    def port_object(self, max_total=0):
        return tsweep.sweep_interleaved(self.tsnap, self.tt, self.tp,
                                        max_total=max_total)


def _fields(r):
    return (r.placements, r.placed_count, r.fail_type, r.fail_message,
            r.fail_counts, r.rung, r.degraded)


def assert_equal_results(want, got, label=""):
    """Every field of every SolveResult, exactly."""
    assert got is not None and want is not None, label
    assert len(got) == len(want), label
    for i, (a, b) in enumerate(zip(want, got)):
        assert _fields(b) == _fields(a), f"{label}[{i}]"


def assert_engine_matches_object_loop(ref, got, label=""):
    """tests/test_interleave_tensor.py's _assert_same."""
    assert got is not None, f"{label}: the engine fell back"
    for i, (r, g) in enumerate(zip(ref, got)):
        assert r.placements == g.placements, f"{label}[{i}]"
        assert r.fail_type == g.fail_type, f"{label}[{i}]"
        assert r.fail_message == g.fail_message, f"{label}[{i}]"


def check_study(study, label="", max_total=0, object_loop=True):
    """The JAX engine == the port's engine; with `object_loop`, the JAX
    object loop == the port's, and the port's engine == the port's object
    loop.  Returns (port engine results, port object loop results)."""
    jres = study.jax_tensor(max_total=max_total)
    tres = study.port_tensor(max_total=max_total)
    assert_equal_results(jres, tres, label)
    tobj = None
    if object_loop:
        tobj = study.port_object(max_total)
        assert_equal_results(study.jax_object(max_total), tobj,
                             label + "/object")
        assert_engine_matches_object_loop(tobj, tres, label)
    return tres, tobj


# ---------------------------------------------------------------------------
# tests/test_interleave_tensor.py, mirrored
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("profile", ["parity", "float32"])
def test_plain_mix_matches_object_path(profile):
    ts = [_template("a", 600), _template("b", 450, mem_gi=1),
          _template("c", 900)]
    check_study(Study(_nodes(10), ts, profile=profile), "plain")


@pytest.mark.parametrize("profile", ["parity", "float32"])
def test_topology_mix_matches_object_path(profile):
    shared = {"tier": "web"}
    ts = [
        _template("a", 500, spread=(2, ZONE, shared),
                  labels={"app": "a", "tier": "web"}),
        _template("b", 400, labels={"app": "b", "tier": "web"}),
        _template("c", 300, anti=(HOST, {"app": "c"})),
        _template("d", 350, soft=(1, ZONE, {"app": "d"})),
    ]
    check_study(Study(_nodes(12), ts, profile=profile), "topo")


def test_cross_template_affinity_and_add_requeue():
    ts = [_template("a", 400, aff=(ZONE, {"app": "b"})),
          _template("b", 700)]
    tres, _ = check_study(Study(_nodes(9), ts), "aff-requeue")
    assert tres[0].placed_count > 0          # the requeue actually fired


@pytest.mark.parametrize("profile", ["parity", "float32"])
def test_sampling_scale_matches_object_path(profile):
    study = Study(_nodes(130, zones=5, seed=3),
                  [_template("a", 800), _template("b", 650, mem_gi=1)],
                  profile=profile)
    study.jp.percentage_of_nodes_to_score = 60
    study.tp.percentage_of_nodes_to_score = 60
    check_study(study, "sampling", max_total=120)


def test_max_total_and_gated_templates():
    gated = {"metadata": {"name": "g"}, "spec": {
        "containers": [{"name": "c", "resources": {
            "requests": {"cpu": "100m"}}}],
        "schedulingGates": [{"name": "w"}]}}
    ts = [gated, _template("a", 500), _template("b", 500)]
    tres, _ = check_study(Study(_nodes(6), ts), "max-total", max_total=7)
    assert tres[0].fail_type == "SchedulingGated"
    assert sum(r.placed_count for r in tres) == 7


def _fuzz_mixed_families():
    """tests/test_interleave_tensor.py::test_fuzz_mixed_families' six
    studies, drawn from its one RandomState(11) stream in its order."""
    rng = np.random.RandomState(11)
    out = []
    for seed in range(6):
        n = int(rng.choice([8, 14, 20]))
        nodes = _nodes(n, zones=int(rng.choice([2, 3])), seed=seed)
        existing = []
        for j in range(int(rng.choice([0, 3]))):
            existing.append({
                "metadata": {"name": f"pre{j}", "namespace": "default",
                             "labels": {"tier": "web"}},
                "spec": {"containers": [{"name": "c", "resources": {
                    "requests": {"cpu": "300m"}}}],
                    "nodeName": f"n{j % n:03d}"}})
        ts = []
        for k in range(int(rng.choice([2, 4]))):
            kind = rng.choice(["plain", "spread", "soft", "anti",
                               "port", "disk", "pref"])
            cpu = int(rng.choice([300, 500, 800]))
            if kind == "plain":
                ts.append(_template(f"t{k}", cpu))
            elif kind == "spread":
                ts.append(_template(
                    f"t{k}", cpu,
                    spread=(int(rng.choice([1, 2])), ZONE, {"tier": "web"}),
                    labels={"app": f"t{k}", "tier": "web"}))
            elif kind == "soft":
                ts.append(_template(f"t{k}", cpu,
                                    soft=(1, ZONE, {"app": f"t{k}"})))
            elif kind == "anti":
                ts.append(_template(f"t{k}", cpu,
                                    anti=(HOST, {"app": f"t{k}"})))
            elif kind == "port":
                t = _template(f"t{k}", cpu)
                t["spec"]["containers"][0]["ports"] = [
                    {"hostPort": int(rng.choice([8080, 9090]))}]
                ts.append(t)
            elif kind == "disk":
                t = _template(f"t{k}", cpu)
                t["spec"]["volumes"] = [{"name": "v", "gcePersistentDisk": {
                    "pdName": f"pd-{int(rng.choice([1, 2]))}"}}]
                ts.append(t)
            else:
                ts.append(_template(
                    f"t{k}", cpu, pref_anti=(10, HOST, {"tier": "web"}),
                    labels={"app": f"t{k}", "tier": "web"}))
        out.append((nodes, existing, ts))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_mixed_families(seed):
    nodes, existing, ts = _fuzz_mixed_families()[seed]
    check_study(Study(nodes, ts, pods=existing), f"fuzz-{seed}")


def test_cross_matrix_diagonals_equal_self_increments():
    """The cross-template matrices equal the JAX package's, and xinc[t, t]
    reproduces the single-template self increments."""
    from cluster_capacity_tpu.parallel import sweep as jsweep_mod
    from cluster_capacity_tpu_torch.ops import inter_pod_affinity as ipa_ops

    ts = [
        _template("a", 400, spread=(1, ZONE, {"app": "a"})),
        _template("b", 300, spread=(2, ZONE, {"app": "b"}),
                  anti=(HOST, {"app": "b"})),
    ]
    study = Study(_nodes(8), ts)
    keys = til.union_topology_keys(study.tt)
    assert keys == jil.union_topology_keys(study.jt)
    tpbs = [tenc.encode_problem(study.tsnap, t, study.tp, ipa_extra_keys=keys)
            for t in study.tt]
    jpbs = [jenc.encode_problem(study.jsnap, t, study.jp, ipa_extra_keys=keys)
            for t in study.jt]
    tpbs, _cfg = tsweep._pad_group(tpbs)
    jpbs, _jcfg, _dnh = jsweep_mod._pad_group(jpbs)
    sh = til._spread_xinc(tpbs, "spread_hard")
    assert np.array_equal(sh, jil._spread_xinc(jpbs, "spread_hard"))
    for t, pb in enumerate(tpbs):
        got = sh[t, t, :pb.spread_hard.self_match.shape[0]]
        assert (got.astype(bool) == pb.spread_hard.self_match).all()
    x = til._ipa_xinc(tpbs)
    jx = jil._ipa_xinc(jpbs)
    assert sorted(x) == sorted(jx)
    for k in x:
        assert np.array_equal(x[k], jx[k]), k
    for t, pb in enumerate(tpbs):
        _ga, _gn, aff_g, anti_g, pref_g = ipa_ops.group_fold(pb.ipa)
        assert (x["aff_xinc"][t, t] == aff_g).all()
        assert (x["anti_xinc"][t, t] == anti_g).all()
        assert (x["pref_xinc"][t, t] == pref_g).all()
    assert np.array_equal(til._port_conflict_matrix(tpbs),
                          jil._port_conflict_matrix(jpbs))


def test_fallback_reasons():
    """Shared-DRA colocation stays on the object loop in both packages; the
    front door still answers."""
    slices = [{"metadata": {"name": "s0"},
               "spec": {"nodeName": "n000", "driver": "gpu.example.com",
                        "devices": [{"name": "d0",
                                     "deviceClassName": "gpu.example.com"}]}}]
    claim = {"metadata": {"name": "shared", "namespace": "default"},
             "spec": {"devices": {"requests": [
                 {"name": "r0", "deviceClassName": "gpu.example.com",
                  "count": 1}]}}}
    shared = _template("sh", 300)
    shared["spec"]["resourceClaims"] = [
        {"name": "gpu", "resourceClaimName": "shared"}]
    study = Study(_nodes(6), [shared], resource_slices=slices,
                  resource_claims=[claim])
    assert study.jax_tensor() is None and study.port_tensor() is None
    want = jil.sweep_interleaved_auto(study.jsnap, study.jt, study.jp,
                                      max_total=3)
    got = til.sweep_interleaved_auto(study.tsnap, study.tt, study.tp,
                                     max_total=3, device="cpu")
    assert_equal_results(want, got, "dra-auto")
    assert got[0].placed_count == 3


def _reason_cases():
    """(label, study, setup) for every fallback reason of `eligible` and
    `eligible_profile`."""
    rwop_objs = {
        "pvcs": [{"metadata": {"name": "exclusive", "namespace": "default"},
                  "spec": {"accessModes": ["ReadWriteOncePod"],
                           "volumeName": "vol1"}}],
        "pvs": [{"metadata": {"name": "vol1"},
                 "spec": {"accessModes": ["ReadWriteOncePod"]}}]}
    rwop = _template("r", 100)
    rwop["spec"]["volumes"] = [
        {"name": "v", "persistentVolumeClaim": {"claimName": "exclusive"}}]
    rwop["spec"]["priority"] = 0
    hi = _template("hi", 1800)
    hi["spec"]["priority"] = 500
    # a resource no node offers widens this template's vocabulary only
    gpu = _template("g", 100)
    gpu["spec"]["containers"][0]["resources"]["requests"][
        "example.com/gpu"] = "1"
    cases = [
        ("ok", Study(_nodes(4), [_template("a", 300)]), None),
        ("random", Study(_nodes(4), [_template("a", 300)]),
         lambda p: setattr(p, "deterministic", False)),
        ("preemption message", Study(_nodes(4), [_template("a", 300)]),
         lambda p: setattr(p, "include_preemption_message", True)),
        ("rwop", Study(_nodes(2, pods=2), [rwop, hi], **rwop_objs), None),
        ("two plain", Study(_nodes(4), [_template("a", 300),
                                        _template("b", 300)]), None),
        ("vocabulary", Study(_nodes(4), [_template("a", 300), gpu]), None),
    ]
    return cases


def test_eligible_reason_strings_match_jax(monkeypatch):
    """`eligible_profile` and `eligible` give the JAX package's reason
    strings, word for word, for every fallback reason."""
    seen = set()
    for label, study, setup in _reason_cases():
        if setup is not None:
            setup(study.jp)
            setup(study.tp)
        want = jil.eligible_profile(study.jsnap, study.jt, study.jp)
        got = til.eligible_profile(study.tsnap, study.tt, study.tp)
        assert got == want, label
        if want is None:
            keys = jil.union_topology_keys(study.jt)
            jpbs = jenc.encode_problems_shared(study.jsnap, study.jt,
                                               study.jp, ipa_extra_keys=keys)
            tpbs = tenc.encode_problems_shared(study.tsnap, study.tt,
                                               study.tp, ipa_extra_keys=keys)
            want = jil.eligible(study.jsnap, study.jt, study.jp, jpbs)
            got = til.eligible(study.tsnap, study.tt, study.tp, tpbs)
            assert got == want, label
        seen.add(got)
    # stateful extenders and the device budget
    study = Study(_nodes(4), [_template("a", 300)])
    study.jp.extenders = [JExt(filter_callable=lambda p, n: {
        "NodeNames": list(n)})]
    study.tp.extenders = [TExt(filter_callable=lambda p, n: {
        "NodeNames": list(n)})]
    study.jp.tensor_extenders = study.tp.tensor_extenders = False
    got = til.eligible_profile(study.tsnap, study.tt, study.tp)
    assert got == jil.eligible_profile(study.jsnap, study.jt, study.jp)
    seen.add(got)
    study = Study(_nodes(4), [_template("a", 300), _template("b", 200)])
    monkeypatch.setattr(til, "MAX_ELEMS", 1)
    monkeypatch.setattr(jil, "MAX_ELEMS", 1)
    jpbs = jenc.encode_problems_shared(study.jsnap, study.jt, study.jp)
    tpbs = tenc.encode_problems_shared(study.tsnap, study.tt, study.tp)
    got = til.eligible(study.tsnap, study.tt, study.tp, tpbs)
    assert got == jil.eligible(study.jsnap, study.jt, study.jp, jpbs)
    seen.add(got)
    assert seen >= {None, "non-deterministic tie-break",
                    "preemption message formatting needs the object path",
                    "RWOP with possible preemption (live-clone accounting)",
                    "templates disagree on the resource vocabulary",
                    "profile declares stateful extenders "
                    "(tensor_extenders=False)",
                    "per-template state exceeds the device budget"}


@pytest.mark.parametrize("mt", [0, 3, 5, 6, 8, 9, 12])
def test_curability_transition_matches_object_path(mt):
    nodes = [{"metadata": {"name": f"n{i}", "labels": {
                HOST: f"n{i}", ZONE: "z1"}},
              "spec": {},
              "status": {"allocatable": {"cpu": "1000m",
                                         "memory": str(8 * 1024 ** 3),
                                         "pods": "20"}}} for i in range(2)]
    ts = [_template("a", 600, aff=(ZONE, {"app": "missing-anchor"})),
          _template("b", 400), _template("c", 100)]
    check_study(Study(nodes, ts), f"transition mt={mt}", max_total=mt)


def test_priority_tiers_without_victims():
    ts = []
    for k in range(6):
        t = _template(f"t{k}", 300 + 50 * k)
        t["spec"]["priority"] = (k % 3) * 10          # three tiers
        ts.append(t)
    check_study(Study(_nodes(8, pods=6), ts), "tiers")


def test_preemption_single_eviction():
    victims = [_victim_pod(f"v{i}", f"n{i:03d}", 900, 5) for i in range(3)]
    hi = _template("hi", 800)
    hi["spec"]["priority"] = 100
    tres, _ = check_study(Study(_nodes(3, cpus=(1000,), pods=8), [hi],
                                pods=victims), "single-eviction")
    assert tres[0].placed_count == 3        # one per node after evictions


def test_preemption_tiered_templates_with_victims():
    lo = _template("lo", 600)
    lo["spec"]["priority"] = 0
    hi = _template("hi", 700)
    hi["spec"]["priority"] = 50
    check_study(Study(_nodes(4, cpus=(1000,), pods=8), [hi, lo]),
                "tiered-victims")


def test_preemption_pdb_protected_victims():
    victims = [_victim_pod("va", "n000", 900, 1, labels={"guard": "y"}),
               _victim_pod("vb", "n001", 900, 1)]
    pdb = {"metadata": {"name": "guard", "namespace": "default"},
           "spec": {"selector": {"matchLabels": {"guard": "y"}}},
           "status": {"disruptionsAllowed": 0}}
    hi = _template("hi", 800)
    hi["spec"]["priority"] = 100
    tres, _ = check_study(Study(_nodes(2, cpus=(1000,), pods=8), [hi],
                                pods=victims, pdbs=[pdb]), "pdb")
    assert tres[0].placements[0] == 1


def tiered_corpus(seed):
    """tests/test_interleave_tensor.py::test_fuzz_tiered_preemption_corpus'
    study for `seed`: (nodes, victims, templates)."""
    rng = np.random.RandomState(400 + seed)
    nodes = _nodes(int(rng.choice([5, 8])), zones=3, cpus=(2000,), pods=10,
                   seed=seed)
    victims = [_victim_pod(f"v{i}", f"n{int(rng.randint(len(nodes))):03d}",
                           int(rng.choice([500, 1500])),
                           int(rng.choice([0, 3])), labels={"app": "victim"})
               for i in range(int(rng.choice([2, 4])))]
    ts = []
    for k in range(int(rng.choice([3, 5]))):
        kind = k % 3
        if kind == 0:
            t = _template(f"t{k}", int(rng.choice([400, 700])),
                          spread=(int(rng.choice([1, 2])), ZONE,
                                  {"app": f"t{k}"}))
        elif kind == 1:
            t = _template(f"t{k}", int(rng.choice([400, 700])),
                          pref_anti=(10, HOST, {"app": f"t{k}"}))
        else:
            t = _template(f"t{k}", int(rng.choice([400, 700])))
        t["spec"]["priority"] = int(rng.choice([0, 10, 20]))
        ts.append(t)
    return nodes, victims, ts


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_tiered_preemption_corpus(seed):
    nodes, victims, ts = tiered_corpus(seed)
    check_study(Study(nodes, ts, pods=victims), f"tier-fuzz-{seed}")


# --- extenders ---------------------------------------------------------------

def _http_extender_server(filter_fn=None, prioritize_fn=None,
                          with_bind=False):
    """A local HTTP extender (extender/v1 payloads); returns
    ((JAX config, port config), calls, shutdown)."""
    calls = []

    class H(BaseHTTPRequestHandler):
        def do_POST(self):
            body = json.loads(self.rfile.read(
                int(self.headers["Content-Length"])).decode())
            verb = self.path.rsplit("/", 1)[-1]
            calls.append((verb, body))
            if verb == "filter":
                names = body.get("NodeNames") or []
                out = {"NodeNames": filter_fn(body["Pod"], names)
                       if filter_fn else list(names)}
            elif verb == "prioritize":
                names = body.get("NodeNames") or []
                out = [{"Host": n,
                        "Score": prioritize_fn(body["Pod"], n)
                        if prioritize_fn else 0}
                       for n in names]
            elif verb == "bind":
                out = {}
            else:
                out = {"Error": f"unknown verb {verb}"}
            payload = json.dumps(out).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def log_message(self, *a):
            pass

    srv = HTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    kw = dict(url_prefix=f"http://127.0.0.1:{srv.server_port}/scheduler",
              filter_verb="filter", prioritize_verb="prioritize",
              bind_verb="bind" if with_bind else "", weight=10,
              node_cache_capable=True)

    def shutdown():
        srv.shutdown()
        srv.server_close()
    return (JExt(**kw), TExt(**kw)), calls, shutdown


def test_extender_http_mix_matches_object_path():
    def filt(pod, names):
        if (pod.get("metadata") or {}).get("name") == "b":
            return [n for n in names if int(n[1:]) % 2 == 1]
        return list(names)

    def prio(pod, name):
        return 3 if int(name[1:]) % 3 == 1 else 0

    (jcfg, tcfg), _calls, shutdown = _http_extender_server(filt, prio)
    try:
        ts = [_template("a", 600, spread=(1, ZONE, {"app": "a"})),
              _template("b", 450), _template("c", 700)]
        check_study(Study(_nodes(9), ts, extenders=([jcfg], [tcfg])),
                    "http-ext")
    finally:
        shutdown()


def test_extender_empties_window_parks_with_bucket():
    from cluster_capacity_tpu_torch.engine.extenders import (
        REASON_EXTENDER_FILTER)

    def filt(pod, names):
        if (pod.get("metadata") or {}).get("name") == "blocked":
            return []
        return list(names)

    (jcfg, tcfg), _calls, shutdown = _http_extender_server(filt)
    try:
        ts = [_template("blocked", 100), _template("free", 500)]
        tres, _ = check_study(Study(_nodes(6), ts,
                                    extenders=([jcfg], [tcfg])),
                              "ext-blocked")
        assert tres[0].placed_count == 0
        assert tres[0].fail_counts.get(REASON_EXTENDER_FILTER) == 6
        assert tres[1].placed_count > 0
    finally:
        shutdown()


def test_extender_bind_drain_order():
    """Binder extenders fire once per placement, in placement order, with
    the clone as the payload — the same bind calls from both packages."""
    (jcfg, tcfg), calls, shutdown = _http_extender_server(with_bind=True)
    try:
        ts = [_template("a", 900), _template("b", 700)]
        study = Study(_nodes(4), ts, extenders=([jcfg], [tcfg]))
        binds = []
        for run in (study.jax_tensor, study.port_tensor):
            del calls[:]
            got = run(max_total=6)
            # clone uids are minted at random; the rest is the payload
            binds.append([{k: v for k, v in b.items() if k != "PodUID"}
                          for verb, b in calls if verb == "bind"])
            assert len(binds[-1]) == sum(r.placed_count for r in got) == 6
        assert binds[0] == binds[1]
        assert binds[1][0]["PodName"].startswith("a-")
        assert binds[1][1]["PodName"].startswith("b-")
    finally:
        shutdown()


def test_extender_callable_with_priority_tiers_and_preemption():
    def filt(pod, names):
        return {"NodeNames": [n for n in names if n != "n000"]}

    hi = _template("hi", 300)
    hi["spec"]["priorityClassName"] = "high"
    hi["spec"]["priority"] = 1000
    lo = _template("lo", 300)
    lo["spec"]["priority"] = 0
    study = Study(_nodes(5, pods=2), [hi, lo],
                  extenders=([JExt(filter_callable=filt)],
                             [TExt(filter_callable=filt)]),
                  priority_classes=[{"metadata": {"name": "high"},
                                     "value": 1000}])
    check_study(study, "ext-tiers")


def test_tensor_extenders_opt_out():
    keep = lambda p, names: {"NodeNames": list(names)}
    study = Study(_nodes(4), [_template("a", 300)],
                  extenders=([JExt(filter_callable=keep)],
                             [TExt(filter_callable=keep)]))
    study.jp.tensor_extenders = study.tp.tensor_extenders = False
    assert study.port_tensor() is None and study.jax_tensor() is None
    want = jil.sweep_interleaved_auto(study.jsnap, study.jt, study.jp,
                                      max_total=3)
    got = til.sweep_interleaved_auto(study.tsnap, study.tt, study.tp,
                                     max_total=3, device="cpu")
    assert_equal_results(want, got, "opt-out")
    assert got[0].placed_count == 3


# --- host ports, inline disks, RWOP ------------------------------------------

def test_host_ports_cross_template_matches_object_path():
    ts = [_port_template("a", 300, 8080), _port_template("b", 300, 8080),
          _port_template("c", 300, 9090), _template("d", 400)]
    tres, _ = check_study(Study(_nodes(5), ts), "ports")
    assert tres[0].placed_count + tres[1].placed_count == 5
    assert tres[2].placed_count == 5
    assert "free ports" in tres[0].fail_message


def test_host_ports_wildcard_ip_and_existing_pods():
    existing = {"metadata": {"name": "squatter", "namespace": "default"},
                "spec": {"nodeName": "n000",
                         "containers": [{"name": "c",
                                         "resources": {"requests": {
                                             "cpu": "100m"}},
                                         "ports": [{"hostPort": 8080,
                                                    "hostIP": "10.0.0.1"}]}]}}
    ts = [_port_template("w", 300, 8080), _template("p", 500)]
    tres, _ = check_study(Study(_nodes(4), ts, pods=[existing]),
                          "ports-wildcard")
    assert tres[0].placed_count == 3


def test_host_ports_with_preemption_rebuild():
    squatter = {"metadata": {"name": "squat", "namespace": "default"},
                "spec": {"nodeName": "n000", "priority": 0,
                         "containers": [{"name": "c",
                                         "resources": {"requests": {
                                             "cpu": "100m"}},
                                         "ports": [{"hostPort": 7070}]}]}}
    hi = _port_template("hi", 300, 7070)
    hi["spec"]["priorityClassName"] = "high"
    hi["spec"]["priority"] = 500
    study = Study(_nodes(2, pods=3), [hi, _template("free", 400)],
                  pods=[squatter],
                  priority_classes=[{"metadata": {"name": "high"},
                                     "value": 500}])
    tres, _ = check_study(study, "ports-preempt")
    assert tres[0].placed_count == 2
    assert sorted(tres[0].placements) == [0, 1]


def test_inline_disk_self_conflict_native():
    disk = _template("d", 300)
    disk["spec"]["volumes"] = [
        {"name": "v", "gcePersistentDisk": {"pdName": "pd-1"}}]
    tres, _ = check_study(Study(_nodes(4), [disk, _template("p", 500)]),
                          "disk-self")
    assert tres[0].placed_count == 4
    assert sorted(tres[0].placements) == [0, 1, 2, 3]
    assert "no available disk" in tres[0].fail_message


def _rwop_objs():
    return {"pvcs": [{"metadata": {"name": "exclusive",
                                   "namespace": "default"},
                      "spec": {"accessModes": ["ReadWriteOncePod"],
                               "volumeName": "vol1"}}],
            "pvs": [{"metadata": {"name": "vol1"},
                     "spec": {"accessModes": ["ReadWriteOncePod"]}}]}


def test_rwop_single_clone_native():
    rwop = _template("r", 300)
    rwop["spec"]["volumes"] = [
        {"name": "v", "persistentVolumeClaim": {"claimName": "exclusive"}}]
    tres, _ = check_study(Study(_nodes(3), [rwop, _template("p", 500)],
                                **_rwop_objs()), "rwop")
    assert tres[0].placed_count == 1
    assert "ReadWriteOncePod" in tres[0].fail_message


def test_disk_rwop_port_mix_with_spread():
    disk = _template("d", 250)
    disk["spec"]["volumes"] = [
        {"name": "v", "gcePersistentDisk": {"pdName": "pd-x"}}]
    ts = [disk, _port_template("q", 250, 8080),
          _template("s", 250, spread=(1, ZONE, {"app": "s"})),
          _template("p", 400)]
    check_study(Study(_nodes(6), ts), "mix-gates")


def test_disk_self_conflict_through_preemption_rebuild():
    squatter = {"metadata": {"name": "squat", "namespace": "default"},
                "spec": {"nodeName": "n000", "priority": 0,
                         "containers": [{"name": "c", "resources": {
                             "requests": {"cpu": "1500m"}}}]}}
    disk = _template("d", 200)
    disk["spec"]["volumes"] = [
        {"name": "v", "gcePersistentDisk": {"pdName": "pd-1"}}]
    hi = _template("hi", 1500)
    hi["spec"]["priorityClassName"] = "high"
    hi["spec"]["priority"] = 500
    study = Study(_nodes(2, pods=2), [disk, hi], pods=[squatter],
                  priority_classes=[{"metadata": {"name": "high"},
                                     "value": 500}])
    tres, _ = check_study(study, "disk-preempt")
    assert tres[0].placed_count >= 1
    assert len(set(tres[0].placements)) == tres[0].placed_count
    assert 0 in tres[1].placements


def test_rwop_with_preemption_falls_back():
    rwop = _template("r", 100)
    rwop["spec"]["volumes"] = [
        {"name": "v", "persistentVolumeClaim": {"claimName": "exclusive"}}]
    rwop["spec"]["priority"] = 0
    hi = _template("hi", 1800)
    hi["spec"]["priorityClassName"] = "high"
    hi["spec"]["priority"] = 500
    study = Study(_nodes(2, pods=2), [rwop, hi],
                  priority_classes=[{"metadata": {"name": "high"},
                                     "value": 500}], **_rwop_objs())
    assert study.port_tensor() is None and study.jax_tensor() is None
    want = jil.sweep_interleaved_auto(study.jsnap, study.jt, study.jp)
    got = til.sweep_interleaved_auto(study.tsnap, study.tt, study.tp,
                                     device="cpu")
    assert_equal_results(want, got, "rwop-auto")
    assert got[0].placed_count >= 1


# ---------------------------------------------------------------------------
# tests/test_sweep_batched.py and tests/test_bounds.py, mirrored
# ---------------------------------------------------------------------------

def test_interleaved_shared_state_queue():
    """sweep_interleaved: equal-priority templates round-robin through one
    shared state; the high-priority template drains first."""
    nodes = [{"metadata": {"name": f"n{i}"}, "spec": {},
              "status": {"allocatable": {"cpu": "1000m",
                                         "memory": str(4 * 1024 ** 3),
                                         "pods": "20"}}} for i in range(2)]
    a = {"metadata": {"name": "a"}, "spec": {"containers": [
        {"name": "c", "resources": {"requests": {"cpu": "500m"}}}]}}
    b = copy.deepcopy(a)
    b["metadata"]["name"] = "b"
    hi = copy.deepcopy(a)
    hi["metadata"]["name"] = "hi"
    hi["spec"]["priority"] = 10
    study = Study(nodes, [a, b])
    res = study.port_object()
    assert_equal_results(study.jax_object(), res, "round-robin")
    assert res[0].placed_count == 2 and res[1].placed_count == 2
    assert all(r.fail_type == "Unschedulable" for r in res)
    study = Study(nodes, [a, hi])
    res2 = study.port_object()
    assert_equal_results(study.jax_object(), res2, "priority")
    assert res2[1].placed_count == 4 and res2[0].placed_count == 0


def _bounds_snapshot_nodes(n, seed):
    """tests/test_bounds.py's _snapshot node list."""
    rng = np.random.RandomState(seed)
    return [build_test_node(
        f"n{i}", int(rng.choice([1000, 2000, 3000])),
        int(rng.choice([2, 4, 8])) * 1024 ** 3, 8,
        labels={"zone": f"z{i % 3}"}) for i in range(n)]


def _mix_problems(node_list, pods):
    """(JAX problems, port problems) of `pods` on one snapshot each."""
    jsnap, tsnap = JSnap.from_objects(node_list), TSnap.from_objects(node_list)
    jpbs = [jenc.encode_problem(jsnap, j_default_pod(copy.deepcopy(p)),
                                JProfile()) for p in pods]
    tpbs = [tenc.encode_problem(tsnap, t_default_pod(copy.deepcopy(p)),
                                TProfile()) for p in pods]
    return jpbs, tpbs


def _mix_tuple(mix):
    """bracket_mix's (joint, claims, degraded) as plain values (each
    package has its own CapacityBracket class)."""
    joint, claims, degraded = mix
    return ((joint.lower, joint.upper, joint.exact, joint.frac, joint.method),
            claims, degraded)


def _assert_same_mix(jpbs, tpbs):
    want = jbracket.bracket_mix(jpbs)
    got = tbracket.bracket_mix(tpbs, device="cpu")
    assert _mix_tuple(got) == _mix_tuple(want)
    assert tbracket.auction_device(tpbs, device="cpu") == \
        jbracket.auction_device(jpbs)
    return got


def test_mix_single_template_equals_solo():
    jpbs, tpbs = _mix_problems(_bounds_snapshot_nodes(6, 12),
                               [build_test_pod("probe", 300, 256 * 1024 ** 2,
                                               labels={"app": "probe"})])
    joint, claims, degraded = _assert_same_mix(jpbs, tpbs)
    solo = tbracket.bracket_host(tpbs[0])
    assert not degraded
    assert claims == [solo.lower]
    assert joint.lower == joint.upper == solo.upper
    assert joint.exact


def test_mix_claims_feasible_and_bracketed():
    pods = [build_test_pod("a", 300, 256 * 1024 ** 2, labels={"app": "a"}),
            build_test_pod("b", 700, 256 * 1024 ** 2, labels={"app": "b"})]
    jpbs, tpbs = _mix_problems(_bounds_snapshot_nodes(6, 13), pods)
    joint, claims, degraded = _assert_same_mix(jpbs, tpbs)
    assert not degraded
    assert all(c >= 0 for c in claims)
    assert joint.lower <= joint.upper <= sum(
        tbracket.bracket_host(pb).upper for pb in tpbs)
    for c, pb in zip(claims, tpbs):
        assert c <= tbracket.bracket_host(pb).upper
    assert claims == tbracket._auction_host(tpbs)


def bench_mix_templates(n_templates=50, seed=7):
    """bench.py's interleave mix: zone DoNotSchedule spread, 100/250/500m
    CPU, maxSkew 4/8, from RandomState(seed)."""
    rng = np.random.RandomState(seed)
    out = []
    for k in range(n_templates):
        out.append({
            "metadata": {"name": f"t{k}", "labels": {"app": f"t{k}"}},
            "spec": {"containers": [{
                "name": "c", "resources": {"requests": {
                    "cpu": f"{int(rng.choice([100, 250, 500]))}m"}}}],
                "topologySpreadConstraints": [{
                    "maxSkew": int(rng.choice([4, 8])),
                    "topologyKey": ZONE,
                    "whenUnsatisfiable": "DoNotSchedule",
                    "labelSelector": {"matchLabels": {"app": f"t{k}"}}}]}})
    return out


def bench_nodes(n_nodes, n_zones=8, cpus=(16000, 32000), mems=(64, 128),
                seed=7):
    """bench.py's _make_nodes."""
    rng = np.random.RandomState(seed)
    cpu_draw = rng.choice(list(cpus), size=n_nodes)
    mem_draw = rng.choice(list(mems), size=n_nodes)
    return [{"metadata": {"name": f"node-{i:06d}",
                          "labels": {HOST: f"node-{i:06d}",
                                     ZONE: f"zone-{i % n_zones}"}},
             "spec": {},
             "status": {"allocatable": {
                 "cpu": f"{int(cpu_draw[i])}m",
                 "memory": str(int(mem_draw[i]) * 1024 ** 3),
                 "pods": "110"}}} for i in range(n_nodes)]


def test_bench_mix_bracket_matches_jax():
    """bracket_mix on the bench's 50-template mix (1,000 nodes, the bench's
    own default size): joint bracket, claims and degraded equal."""
    jpbs, tpbs = _mix_problems(bench_nodes(1000), bench_mix_templates())
    joint, claims, degraded = _assert_same_mix(jpbs, tpbs)
    assert not degraded and joint.lower <= joint.upper


def test_bounds_guided_run_matches_jax():
    """bounds=True (bracket the mix, skip statically infeasible templates,
    right-size the budget) gives the unbounded run's answers in both
    packages."""
    ts = [_template("a", 600), _template("b", 450, mem_gi=1),
          _template("huge", 90000), _template("c", 900)]
    study = Study(_nodes(10), ts)
    jres = study.jax_tensor(bounds=True)
    tres = study.port_tensor(bounds=True)
    assert_equal_results(jres, tres, "bounds")
    assert_equal_results(study.port_tensor(), tres, "bounds-vs-off")


def test_bracket_mix_fault_serves_host_claims():
    """A classified fault on the device auction serves the host claims,
    degraded, as the JAX package does."""
    from cluster_capacity_tpu.runtime import faults as jfaults
    pods = [build_test_pod("a", 300, 256 * 1024 ** 2, labels={"app": "a"}),
            build_test_pod("b", 700, 256 * 1024 ** 2, labels={"app": "b"})]
    jpbs, tpbs = _mix_problems(_bounds_snapshot_nodes(6, 13), pods)
    with jfaults.inject("bounds.bracket:oom"):
        want = jbracket.bracket_mix(jpbs)
    with tfaults.inject("bounds.bracket:oom"):
        got = tbracket.bracket_mix(tpbs, device="cpu")
    assert _mix_tuple(got) == _mix_tuple(want) and got[2] is True


# ---------------------------------------------------------------------------
# the front door: guard, fault drill, mesh, CLI
# ---------------------------------------------------------------------------

def test_interleave_fault_drill_serves_object_loop_degraded():
    """parallel.interleave:oom: the object loop serves the same answers,
    stamped degraded (rung 'oracle'); the JAX package serves them
    unstamped."""
    ts = [_template("a", 600), _template("b", 450, mem_gi=1)]
    study = Study(_nodes(6), ts)
    clean = til.sweep_interleaved_auto(study.tsnap, study.tt, study.tp,
                                       max_total=9, device="cpu")
    assert {(r.rung, r.degraded) for r in clean} == {("", False)}
    from cluster_capacity_tpu.runtime import faults as jfaults
    with jfaults.inject("parallel.interleave:oom"):
        want = jil.sweep_interleaved_auto(study.jsnap, study.jt, study.jp,
                                          max_total=9)
    with tfaults.inject("parallel.interleave:oom"):
        got = til.sweep_interleaved_auto(study.tsnap, study.tt, study.tp,
                                         max_total=9, device="cpu")
    for a, b, c in zip(want, got, clean):
        assert _fields(b)[:5] == _fields(a)[:5] == _fields(c)[:5]
        assert (a.rung, a.degraded) == ("", False)
        assert (b.rung, b.degraded) == ("oracle", True)


def test_mesh_refused_by_name():
    study = Study(_nodes(4), [_template("a", 300)])
    for fn in (til.solve_interleaved_tensor, til.sweep_interleaved_auto):
        with pytest.raises(NotImplementedError, match="parallel/mesh"):
            fn(study.tsnap, study.tt, study.tp, mesh=object(), device="cpu")
    pbs = tenc.encode_problems_shared(study.tsnap, study.tt, study.tp)
    with pytest.raises(NotImplementedError, match="parallel/mesh"):
        tbracket.bracket_mix(pbs, mesh=object(), device="cpu")


def _write_cli_inputs(tmp_path):
    """Three podspecs (spread, anti-affinity, plain) and a 9-node JSON
    snapshot."""
    specs = [_template("web", 400, spread=(1, ZONE, {"app": "web"})),
             _template("cache", 600, anti=(HOST, {"app": "cache"})),
             _template("batch", 900, mem_gi=1)]
    paths = []
    for s in specs:
        p = tmp_path / f"{s['metadata']['name']}.json"
        p.write_text(json.dumps(s))
        paths.append(str(p))
    snap = tmp_path / "snap.json"
    snap.write_text(json.dumps({"nodes": _nodes(9), "pods": []}))
    argv = []
    for p in paths:
        argv += ["--podspec", p]
    return argv + ["--snapshot", str(snap), "--interleave"]


def _cli(module, argv, capsys):
    rc = module.run(argv)
    out = capsys.readouterr().out
    return rc, out


@pytest.mark.parametrize("fmt", [["-o", "json"], ["-o", "json",
                                                  "--max-limit", "11"],
                                 ["--verbose"], [], ["--no-bounds",
                                                     "-o", "yaml"]],
                         ids=["json", "json-limit11", "pretty-verbose",
                              "pretty", "yaml-no-bounds"])
def test_cli_interleave_byte_equal(tmp_path, capsys, fmt):
    argv = _write_cli_inputs(tmp_path) + fmt
    jrc, want = _cli(jcli, argv, capsys)
    trc, got = _cli(tcli, argv + ["--device", "cpu"], capsys)
    assert jrc == trc == 0
    strip = lambda text: [x for x in text.splitlines()
                          if "creationTimestamp" not in x]
    assert strip(got) == strip(want)
    assert len(got.splitlines()) == len(want.splitlines())
    if fmt[:2] == ["-o", "json"]:
        assert len(json.loads(got)["status"]["pods"]) == 3


def test_cli_interleave_with_mesh_refused(tmp_path, capsys):
    argv = _write_cli_inputs(tmp_path)
    assert tcli.run(argv + ["--mesh", "1x1", "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "--mesh is not ported yet" in err

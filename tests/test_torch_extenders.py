"""The port's scheduler extenders (engine/extenders.py, the extender branch
of framework._solve_with_preemption, the ProcessPreemption chain in
engine/preemption.evaluate and oracle.simulate_with_preemption) against the
JAX package's, on the CPU.

Every scenario of tests/test_extenders_depth.py and
tests/test_extender_http.py runs through both packages: equal placements,
fail type, FitError message, per-reason counts, the sequence of extender
calls (filter / prioritize / bind arguments, the preemption victim maps)
and equal exceptions.  Seeded clusters add the float64 parity profile, the
default float32 profile and the random tie-break (which the extender loop
does not consult, in either package).  Tolerance: exact.
"""

import copy
import dataclasses
import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest

from cluster_capacity_tpu import ClusterCapacity as JCC
from cluster_capacity_tpu.engine import encode as jenc
from cluster_capacity_tpu.engine import extenders as jext
from cluster_capacity_tpu.engine import oracle as joracle
from cluster_capacity_tpu.engine import simulator as jsim
from cluster_capacity_tpu.models.podspec import default_pod as j_default_pod
from cluster_capacity_tpu.models.snapshot import ClusterSnapshot as JSnap
from cluster_capacity_tpu.utils import config as jconfig
from cluster_capacity_tpu.utils.config import SchedulerProfile as JProfile
from cluster_capacity_tpu_torch import ClusterCapacity as TCC
from cluster_capacity_tpu_torch.engine import encode as tenc
from cluster_capacity_tpu_torch.engine import extenders as text
from cluster_capacity_tpu_torch.engine import oracle as toracle
from cluster_capacity_tpu_torch.engine import simulator as tsim
from cluster_capacity_tpu_torch.models.podspec import default_pod as t_default_pod
from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot as TSnap
from cluster_capacity_tpu_torch.utils import config as tconfig
from cluster_capacity_tpu_torch.utils.config import SchedulerProfile as TProfile

from helpers import build_test_node, build_test_pod

ZONE = "topology.kubernetes.io/zone"

# (package label, ClusterCapacity, SchedulerProfile, default_pod, snapshot
#  class, encode module, extenders module, simulator module, extra kwargs)
JAX = ("jax", JCC, JProfile, j_default_pod, JSnap, jenc, jext, jsim, {})
TORCH = ("torch", TCC, TProfile, t_default_pod, TSnap, tenc, text, tsim,
         {"device": "cpu"})
BOTH = (JAX, TORCH)


def _profile(prof_cls, mode):
    if mode == "parity":
        return prof_cls.parity()
    profile = prof_cls()
    if mode == "random":
        profile.deterministic = False
        profile.seed = 3
    return profile


def _solve(pkg, nodes, pod, exts, max_limit=0, mode="parity", pods=()):
    """solve_with_extenders of one package on a fresh encode."""
    _, _, prof_cls, default_pod, snap_cls, enc, ext, _, kw = pkg
    pb = enc.encode_problem(snap_cls.from_objects(nodes, list(pods)),
                            default_pod(pod), _profile(prof_cls, mode))
    return ext.solve_with_extenders(pb, exts, max_limit=max_limit, **kw)


def _outcome(res):
    return (list(res.placements), res.placed_count, res.fail_type,
            res.fail_message, dict(res.fail_counts or {}),
            list(res.node_names))


def _run_cc(pkg, nodes, pod, exts, pods=(), max_limit=0, mode="parity"):
    """ClusterCapacity.run of one package with `exts` in the profile."""
    _, cc_cls, prof_cls, default_pod, snap_cls, _, _, _, kw = pkg
    profile = _profile(prof_cls, mode)
    profile.extenders = exts
    cc = cc_cls(default_pod(pod), max_limit=max_limit, profile=profile, **kw)
    cc.set_snapshot(snap_cls.from_objects(nodes, list(pods)))
    res = cc.run()
    return res, cc


def _ext(pkg, **kwargs):
    return pkg[6].ExtenderConfig(**kwargs)


# ---------------------------------------------------------------------------
# tests/test_extenders_depth.py through both packages
# ---------------------------------------------------------------------------

def test_bind_verb_called_per_placement():
    nodes = [build_test_node(f"n{i}", 1000, 4 * 1024 ** 3, 5)
             for i in range(2)]
    pod = build_test_pod("p", 400, 0)
    seen = []
    for pkg in BOTH:
        bound = []
        ext = _ext(pkg, bind_callable=lambda p, node: bound.append(node) or {})
        res = _solve(pkg, nodes, pod, [ext], max_limit=3)
        assert res.placed_count == 3
        assert bound == [res.node_names[i] for i in res.placements]
        seen.append((_outcome(res), bound))
    assert seen[0] == seen[1]


def test_bind_error_fails_loudly():
    nodes = [build_test_node("n0", 1000, 4 * 1024 ** 3, 5)]
    pod = build_test_pod("p", 100, 0)
    msgs = []
    for pkg in BOTH:
        ext = _ext(pkg, bind_callable=lambda p, n: {"Error": "no capacity"})
        with pytest.raises(RuntimeError, match="extender bind failed") as ei:
            _solve(pkg, nodes, pod, [ext], max_limit=2)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_managed_resources_gates_interest():
    nodes = [build_test_node(f"n{i}", 1000, 4 * 1024 ** 3, 5,
                             extra_alloc={"example.com/gpu": "2"})
             for i in range(2)]
    plain = build_test_pod("plain", 100, 0)
    gpu = build_test_pod("gpu", 100, 0)
    gpu["spec"]["containers"][0]["resources"]["requests"][
        "example.com/gpu"] = "1"
    seen = []
    for pkg in BOTH:
        calls = []

        def deny_all(pod, names, calls=calls):
            calls.append(len(names))
            return {"NodeNames": []}

        ext = _ext(pkg, filter_callable=deny_all,
                   managed_resources=["example.com/gpu"])
        res = _solve(pkg, nodes, plain, [ext], max_limit=2)
        assert res.placed_count == 2 and not calls
        res2 = _solve(pkg, nodes, gpu, [ext], max_limit=2)
        assert res2.placed_count == 0 and calls
        seen.append((_outcome(res), _outcome(res2), calls))
    assert seen[0] == seen[1]
    # the extender-blocked bucket of the FitError
    assert "didn't pass the extender filter" in seen[1][1][3]


def _preempt_cluster(n):
    nodes = [build_test_node(f"n{i}", 1000, 4 * 1024 ** 3, 5)
             for i in range(n)]
    pods = []
    for i in range(n):
        p = build_test_pod(f"low-{i}", 900, 0, node_name=f"n{i}")
        p["spec"]["priority"] = 0
        pods.append(p)
    vip = build_test_pod("vip", 900, 0)
    vip["spec"]["priority"] = 10
    return nodes, pods, vip


def _victim_names(node_to_victims):
    return {n: [(p.get("metadata") or {}).get("name") for p in v]
            for n, v in node_to_victims.items()}


def _preempt_runs(nodes, pods, vip, make_callable, mode="parity"):
    """Both packages' ClusterCapacity.run at max_limit 1 with one
    preempt-callable extender; (outcome, victim maps the extender saw,
    post-run rosters) per package."""
    seen = []
    for pkg in BOTH:
        maps = []
        fn = make_callable()

        def recording(pod, node_to_victims, fn=fn, maps=maps):
            maps.append(_victim_names(node_to_victims))
            return fn(pod, node_to_victims)

        res, cc = _run_cc(pkg, nodes, vip,
                          [_ext(pkg, preempt_callable=recording)],
                          pods=pods, max_limit=1, mode=mode)
        rosters = [[(p.get("metadata") or {}).get("name") for p in plist]
                   for plist in cc.post_run_snapshot.pods_by_node]
        seen.append((_outcome(res), maps, rosters))
    assert seen[0] == seen[1]
    return seen[1]


def test_process_preemption_restricts_candidates():
    nodes, pods, vip = _preempt_cluster(3)
    for pkg in BOTH:
        res, _ = _run_cc(pkg, nodes, vip, [], pods=pods, max_limit=1)
        assert res.placed_count == 1 and res.placements == [0]

    def only_n2():
        return lambda pod, ntv: {n: v for n, v in ntv.items() if n == "n2"}
    out, maps, _ = _preempt_runs(nodes, pods, vip, only_n2)
    assert out[1] == 1 and out[0] == [2]
    assert maps == [{"n0": ["low-0"], "n1": ["low-1"], "n2": ["low-2"]}]


def test_added_affinity_preferred_terms_score():
    nodes = [build_test_node("big", 8000, 16 * 1024 ** 3, 50,
                             labels={"tier": "standard"}),
             build_test_node("small", 2000, 16 * 1024 ** 3, 50,
                             labels={"tier": "preferred"})]
    pod = build_test_pod("p", 100, 0)
    added = {"preferredDuringSchedulingIgnoredDuringExecution": [{
        "weight": 100, "preference": {"matchExpressions": [{
            "key": "tier", "operator": "In", "values": ["preferred"]}]}}]}
    seen = []
    for pkg in BOTH:
        _, _, prof_cls, default_pod, snap_cls, enc, _, sim, kw = pkg
        out = []
        for aff in (None, added):
            profile = prof_cls.parity()
            profile.added_affinity = aff
            pb = enc.encode_problem(snap_cls.from_objects(nodes),
                                    default_pod(pod), profile)
            out.append(_outcome(sim.solve(pb, max_limit=1, **kw)))
        assert out[0][0] == [0] and out[1][0] == [1]
        seen.append(out)
    assert seen[0] == seen[1]


_BAD_CONFIGS = (
    ("""
apiVersion: kubescheduler.config.k8s.io/v1
kind: KubeSchedulerConfiguration
profiles:
- plugins:
    score:
      enabled:
      - name: NodeResourcesFitt
""", "NodeResourcesFitt"),
    ("kind: SomethingElse\nprofiles: []\n", "kind"),
    ("profiles:\n- percentageOfNodesToScore: 250\n",
     "percentageOfNodesToScore"),
    ("""
profiles:
- plugins:
    filter:
    - name: NodeAffinity
""", None),
    ("""
profiles:
- plugins:
    score:
      enabled:
      - name: NodeResourcesFit
        weight: abc
""", "weight"),
    ("""
extenders:
- filterVerb: filter
  managedResources:
  - name: example.com/gpu
""", "urlPrefix"),
)


@pytest.mark.parametrize("text,match", _BAD_CONFIGS,
                         ids=[m or "types" for _, m in _BAD_CONFIGS])
def test_config_validation_rejects(tmp_path, text, match):
    """test_config_validation_rejects and _malformed_types: both packages
    raise ConfigValidationError with the same message."""
    path = tmp_path / "bad.yaml"
    path.write_text(text)
    msgs = []
    for cfg in (jconfig, tconfig):
        with pytest.raises(cfg.ConfigValidationError, match=match) as ei:
            cfg.load_scheduler_config(str(path))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_config_ok_and_extender_verbs_parse(tmp_path):
    ok = tmp_path / "ok.yaml"
    ok.write_text("""
apiVersion: kubescheduler.config.k8s.io/v1
kind: KubeSchedulerConfiguration
profiles:
- plugins:
    score:
      enabled:
      - name: NodeResourcesFit
        weight: 5
""")
    profs = [cfg.load_scheduler_config(str(ok)) for cfg in (jconfig, tconfig)]
    assert profs[1].score_weights["NodeResourcesFit"] == 5
    assert dataclasses.asdict(profs[0]) == dataclasses.asdict(profs[1])

    cfgf = tmp_path / "ext.yaml"
    cfgf.write_text("""
apiVersion: kubescheduler.config.k8s.io/v1
kind: KubeSchedulerConfiguration
extenders:
- urlPrefix: http://127.0.0.1:9999/scheduler
  filterVerb: filter
  bindVerb: bind
  preemptVerb: preempt
  weight: 2
  httpTimeout: 1500ms
  managedResources:
  - name: example.com/gpu
    ignoredByScheduler: true
profiles:
- plugins: {}
""")
    exts = [cfg.load_scheduler_config(str(cfgf)).extenders
            for cfg in (jconfig, tconfig)]
    assert len(exts[1]) == 1
    e = exts[1][0]
    assert e.is_binder and e.supports_preemption
    assert e.managed_resources == ["example.com/gpu"]
    assert e.http_timeout_s == 1.5
    assert dataclasses.asdict(exts[0][0]) == dataclasses.asdict(e)


def test_preempt_callable_cannot_invent_nodes():
    nodes, pods, vip = _preempt_cluster(2)

    def invent():
        def fn(pod, node_to_victims):
            out = dict(node_to_victims)
            out["ghost-node"] = []
            return out
        return fn
    out, _, _ = _preempt_runs(nodes, pods, vip, invent)
    assert out[1] == 1 and out[0] == [0]


def test_preempt_extender_json_roundtrip_victims():
    nodes = [build_test_node("n0", 1000, 4 * 1024 ** 3, 5)]
    low = build_test_pod("low", 900, 0, node_name="n0")
    low["spec"]["priority"] = 0
    vip = build_test_pod("vip", 900, 0)
    vip["spec"]["priority"] = 10

    def roundtrip():
        return lambda pod, ntv: {n: [copy.deepcopy(p) for p in v]
                                 for n, v in ntv.items()}
    out, maps, rosters = _preempt_runs(nodes, [low], vip, roundtrip)
    assert out[1] == 1 and out[0] == [0]
    assert maps == [{"n0": ["low"]}] and rosters == [[]]


# ---------------------------------------------------------------------------
# tests/test_extender_http.py through both packages
# ---------------------------------------------------------------------------

class _Handler(BaseHTTPRequestHandler):
    calls = []

    def do_POST(self):
        body = json.loads(self.rfile.read(
            int(self.headers["Content-Length"])).decode())
        verb = self.path.rsplit("/", 1)[-1]
        _Handler.calls.append((verb, body))
        if verb == "filter":
            # drop n0; cache-capable protocol returns NodeNames, the other
            # returns Nodes.items
            if "NodeNames" in body:
                out = {"NodeNames": [n for n in body["NodeNames"]
                                     if n != "n0"]}
            else:
                out = {"Nodes": {"items": [
                    n for n in body["Nodes"]["items"]
                    if n["metadata"]["name"] != "n0"]}}
        elif verb == "prioritize":
            out = [{"Host": n, "Score": 7 if n == "n2" else 0}
                   for n in body.get("NodeNames") or []]
        elif verb == "bind":
            out = {}                     # success
        elif verb == "preempt":
            # keep only the last candidate, victims as MetaVictims
            kept = sorted(body["NodeNameToVictims"])[-1:]
            out = {"NodeNameToMetaVictims": {
                n: {"Pods": [{"UID": "x"}]} for n in kept}}
        else:
            out = {"Error": f"unknown verb {verb}"}
        payload = json.dumps(out).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def log_message(self, *a):            # silence
        pass


@pytest.fixture()
def http_extender():
    _Handler.calls = []
    srv = HTTPServer(("127.0.0.1", 0), _Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_port}/scheduler"
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)
    assert not t.is_alive()


@pytest.mark.parametrize("cache_capable", [True, False])
def test_http_filter_prioritize_bind(http_extender, cache_capable):
    nodes = [build_test_node(f"n{i}", 1000, 4 * 1024 ** 3, 5)
             for i in range(3)]
    pod = build_test_pod("p", 300, 0)
    seen = []
    for pkg in BOTH:
        _Handler.calls = []
        ext = _ext(pkg, url_prefix=http_extender, filter_verb="filter",
                   prioritize_verb="prioritize", bind_verb="bind",
                   weight=100, node_cache_capable=cache_capable)
        res = _solve(pkg, nodes, pod, [ext], max_limit=2)
        assert res.placed_count == 2
        assert [res.node_names[i] for i in res.placements] == ["n2", "n2"]
        verbs = [v for v, _ in _Handler.calls]
        assert verbs.count("filter") >= 2 and verbs.count("bind") == 2
        bind_bodies = [b for v, b in _Handler.calls if v == "bind"]
        assert bind_bodies[0]["Node"] == "n2"
        assert bind_bodies[0]["PodName"] == "p"
        seen.append((_outcome(res), list(_Handler.calls)))
    assert seen[0] == seen[1]


def test_http_preempt_verb(http_extender):
    """The HTTP ProcessPreemption verb (MetaVictims keep the local victim
    lists) through both packages' ClusterCapacity and both oracles."""
    nodes, pods, vip = _preempt_cluster(3)
    seen = []
    for pkg in BOTH:
        _Handler.calls = []
        ext = _ext(pkg, url_prefix=http_extender, preempt_verb="preempt")
        res, cc = _run_cc(pkg, nodes, vip, [ext], pods=pods, max_limit=1)
        bodies = [_victim_names({n: v["Pods"] for n, v in
                                 b["NodeNameToVictims"].items()})
                  for verb, b in _Handler.calls if verb == "preempt"]
        seen.append((_outcome(res), bodies))
    assert seen[0] == seen[1]
    assert seen[1][0][0] == [2]
    assert seen[1][1] == [{"n0": ["low-0"], "n1": ["low-1"],
                           "n2": ["low-2"]}]
    # the oracles consult the same chain
    outs = []
    for pkg, oracle in ((JAX, joracle), (TORCH, toracle)):
        profile = pkg[2].parity()
        profile.extenders = [_ext(pkg, url_prefix=http_extender,
                                  preempt_verb="preempt")]
        snap = pkg[4].from_objects(nodes, pods)
        outs.append(oracle.simulate_with_preemption(
            snap, pkg[3](vip), profile, max_limit=1))
    assert outs[0] == outs[1] == ([2], {})


# ---------------------------------------------------------------------------
# Seeded clusters: profiles, limits, the ClusterCapacity path
# ---------------------------------------------------------------------------

def _seeded_cluster(seed, n=24, zones=4):
    rng = np.random.RandomState(seed)
    nodes = []
    for i in range(n):
        cpu = int(rng.choice([1000, 2000, 4000]))
        nodes.append(build_test_node(
            f"n{i:02d}", cpu, int(rng.choice([2, 4, 8])) * 1024 ** 3, 20,
            labels={ZONE: f"z{i % zones}"}))
    pod = build_test_pod("p", int(rng.choice([200, 300, 500])),
                         int(rng.choice([128, 256])) * 1024 ** 2,
                         labels={"app": "p"})
    if seed % 2:
        pod["spec"]["topologySpreadConstraints"] = [{
            "maxSkew": 2, "topologyKey": ZONE,
            "whenUnsatisfiable": "DoNotSchedule",
            "labelSelector": {"matchLabels": {"app": "p"}}}]
    return nodes, pod


def _zone_extenders(pkg, drop_every):
    """A filter dropping nodes whose index is divisible by `drop_every` and
    a prioritize giving a bonus by zone (weight 3)."""
    calls = []

    def filt(pod, names):
        calls.append(("filter", list(names)))
        return {"NodeNames": [n for n in names
                              if int(n[1:]) % drop_every]}

    def prio(pod, names):
        calls.append(("prioritize", list(names)))
        return [{"Host": n, "Score": (int(n[1:]) % 4) * 5} for n in names]
    return [_ext(pkg, filter_callable=filt),
            _ext(pkg, prioritize_callable=prio, weight=3)], calls


@pytest.mark.parametrize("mode", ["parity", "float32", "random"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_seeded_extender_runs(mode, seed):
    """solve_with_extenders and ClusterCapacity.run (the guarded branch,
    then the preemption loop's node_ok veto) of both packages on seeded
    clusters, unlimited (ends Unschedulable) and at a limit."""
    nodes, pod = _seeded_cluster(seed)
    for max_limit in (0, 7):
        seen = []
        for pkg in BOTH:
            exts, calls = _zone_extenders(pkg, 3 + seed % 3)
            res = _solve(pkg, nodes, pod, exts, max_limit=max_limit,
                         mode=mode)
            exts2, _ = _zone_extenders(pkg, 3 + seed % 3)
            cres, _ = _run_cc(pkg, nodes, pod, exts2, max_limit=max_limit,
                              mode=mode)
            seen.append((_outcome(res), calls, _outcome(cres), cres.rung,
                         cres.degraded))
        assert seen[0] == seen[1], (mode, seed, max_limit)
        assert seen[1][0][1] > 0


def test_extender_blocks_every_node():
    """A filter that rejects every in-tree-feasible node: the
    REASON_EXTENDER_FILTER bucket carries them, in both packages."""
    nodes, pod = _seeded_cluster(4, n=6)
    seen = []
    for pkg in BOTH:
        ext = _ext(pkg, filter_callable=lambda p, names: {"NodeNames": []})
        res = _solve(pkg, nodes, pod, [ext])
        seen.append(_outcome(res))
    assert seen[0] == seen[1]
    assert seen[1][1] == 0
    assert seen[1][4] == {text.REASON_EXTENDER_FILTER: 6}
    assert text.REASON_EXTENDER_FILTER == jext.REASON_EXTENDER_FILTER


def test_ignorable_extender_errors_are_skipped():
    nodes, pod = _seeded_cluster(5, n=6)

    def boom(pod, names):
        raise ConnectionError("down")
    seen = []
    for pkg in BOTH:
        res = _solve(pkg, nodes, pod,
                     [_ext(pkg, filter_callable=boom, ignorable=True)],
                     max_limit=5)
        seen.append(_outcome(res))
        with pytest.raises(ConnectionError):
            _solve(pkg, nodes, pod, [_ext(pkg, filter_callable=boom)],
                   max_limit=5)
    assert seen[0] == seen[1] and seen[1][1] == 5


def test_parse_duration_and_kept_names_match():
    for v in (None, 3, 2.5, "1500ms", "2h", "3m", "4s", "7", "bogus"):
        assert text._parse_duration(v) == jext._parse_duration(v)
    for verdict in ({"NodeNames": ["a"]}, {"Nodes": {"items": [
            {"metadata": {"name": "b"}}]}}, {}):
        assert text._kept_names(verdict) == jext._kept_names(verdict)


def test_deliberate_matches_sweep_and_explain():
    """Matches of the JAX package kept on purpose: a sweep does not consult
    the profile's extenders, and the extender path carries no
    Explanation."""
    from cluster_capacity_tpu.parallel import sweep as jsweep
    from cluster_capacity_tpu_torch.parallel import sweep as tsweep

    nodes, pod = _seeded_cluster(6)
    other = dict(pod, metadata={"name": "q"})
    seen = []
    for pkg, sweep_mod in ((JAX, jsweep), (TORCH, tsweep)):
        _, cc_cls, prof_cls, default_pod, snap_cls, _, ext, _, kw = pkg
        snap = snap_cls.from_objects(nodes)
        pods = [default_pod(pod), default_pod(other)]
        plain = sweep_mod.sweep(snap, pods, profile=prof_cls.parity(),
                                max_limit=9, **kw)
        profile = prof_cls.parity()
        profile.extenders = [ext.ExtenderConfig(
            filter_callable=lambda p, names: {"NodeNames": []})]
        with_ext = sweep_mod.sweep(snap, pods, profile=profile,
                                   max_limit=9, **kw)
        assert [_outcome(r) for r in with_ext] == \
            [_outcome(r) for r in plain]
        cc = cc_cls(default_pod(pod), max_limit=5, profile=profile,
                    explain=True, **kw)
        cc.set_snapshot(snap)
        res = cc.run()
        assert res.explain is None and res.placed_count == 0
        seen.append(([_outcome(r) for r in with_ext], _outcome(res)))
    assert seen[0] == seen[1]

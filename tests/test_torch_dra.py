"""The port's DRA (ops/dynamic_resources.py, the snapshot's dra/<class>
columns, the encoder's resourceClaims and dra/__slots__ column, the shared
claim colocation gate) against the JAX package's, through
tests/test_dra.py's 30 test functions, in the float32 and parity
profiles.

Each test function runs with its module's `ClusterCapacity` replaced by
DualCC and the JAX ops/dynamic_resources module swapped for a dual proxy
(test_torch_cel.DualModule): every ClusterCapacity the test builds runs in
both packages (the port on the CPU) under the profile of the case — the
test's own, or the same profile in float32 — and the placements, fail
type, message, counts, rung and the EncodedProblem of every field must be
equal; every direct DRA call (cel_matches, Device, _fits_k_clones) runs in
both with equal results or equal exceptions.  The JAX package's result
goes back to the test, whose assertions then hold as well.  Also: the
snapshot's DRA columns on seeded random DRA clusters, with_pods_by_node's
DRA branch, and the engines on DRA problems (the scan step and kernel 1's
plain version).  Tolerance: exact.
"""

import copy
import dataclasses
import inspect
import sys

import numpy as np
import pytest

import test_dra as jt
from cluster_capacity_tpu import ClusterCapacity as JCC
from cluster_capacity_tpu.engine import encode as jenc
from cluster_capacity_tpu.models import snapshot as jsnap_mod
from cluster_capacity_tpu.models.snapshot import ClusterSnapshot as JSnap
from cluster_capacity_tpu.ops import dynamic_resources as jdra
from cluster_capacity_tpu.utils.config import SchedulerProfile as JProfile
from cluster_capacity_tpu_torch import ClusterCapacity as TCC
from cluster_capacity_tpu_torch.engine import encode as tenc
from cluster_capacity_tpu_torch.engine import fused as tfused
from cluster_capacity_tpu_torch.engine import simulator as tsim
from cluster_capacity_tpu_torch.models import snapshot as tsnap_mod
from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot as TSnap
from cluster_capacity_tpu_torch.ops import dynamic_resources as tdra
from cluster_capacity_tpu_torch.utils import config as tconfig
from cluster_capacity_tpu_torch.utils.config import SchedulerProfile as TProfile

from helpers import build_test_node, build_test_pod
from test_torch_cel import DualModule
from test_torch_encode import assert_problems_equal

RUNS = {"n": 0}


def port_profile(jp: JProfile) -> TProfile:
    """The port's SchedulerProfile with the JAX profile's field values."""
    kw = {}
    for f in dataclasses.fields(TProfile):
        v = copy.deepcopy(getattr(jp, f.name))
        if f.name == "fit_strategy":
            v = tconfig.ScoringStrategy(**dataclasses.asdict(v))
        kw[f.name] = v
    return TProfile(**kw)


def float32_of(jp: JProfile) -> JProfile:
    p = copy.deepcopy(jp)
    p.compute_dtype = "float32"
    return p


def run_pair(pod, max_limit, jprofile, nodes, pods, extra):
    """Both packages' ClusterCapacity.run and encode_problem on one case;
    asserts them equal, returns the JAX result."""
    RUNS["n"] += 1
    jcc = JCC(copy.deepcopy(pod), max_limit=max_limit, profile=jprofile)
    tcc = TCC(copy.deepcopy(pod), max_limit=max_limit,
              profile=port_profile(jprofile), device="cpu")
    for cc in (jcc, tcc):
        cc.sync_with_objects(copy.deepcopy(list(nodes)),
                             copy.deepcopy(list(pods)),
                             **copy.deepcopy(extra))
    jpb = jenc.encode_problem(jcc.snapshot, jcc.pod, jcc.profile)
    tpb = tenc.encode_problem(tcc.snapshot, tcc.pod, tcc.profile)
    assert_problems_equal(jpb, tpb)
    jres, tres = jcc.run(), tcc.run()
    assert tres.placements == jres.placements
    assert (tres.fail_type, tres.fail_message) == \
        (jres.fail_type, jres.fail_message)
    assert tres.fail_counts == jres.fail_counts
    assert (tres.rung, tres.degraded) == (jres.rung, jres.degraded)
    return jres


def dual_cc(mode):
    """A ClusterCapacity stand-in for tests/test_dra.py: runs both packages
    under the case's profile and hands the test the JAX result."""

    class DualCC:
        def __init__(self, pod, max_limit=0, profile=None, **kw):
            assert not kw, kw
            self.pod, self.max_limit = pod, max_limit
            self.profile = profile or JProfile()

        def sync_with_objects(self, nodes, pods=(), **extra):
            self.args = (list(nodes), list(pods), dict(extra))

        def run(self):
            prof = self.profile if mode == "given" \
                else float32_of(self.profile)
            res = run_pair(self.pod, self.max_limit, prof, *self.args)
            if mode == "given":
                return res
            # the test's assertions read the result of its own profile
            jcc = JCC(copy.deepcopy(self.pod), max_limit=self.max_limit,
                      profile=self.profile)
            jcc.sync_with_objects(*copy.deepcopy(self.args[:2]),
                                  **copy.deepcopy(self.args[2]))
            return jcc.run()

    return DualCC


DRA_TESTS = sorted(n for n in dir(jt) if n.startswith("test_"))


def test_every_dra_test_is_mirrored():
    assert len(DRA_TESTS) == 30


def _call(fn):
    marks = getattr(fn, "pytestmark", [])
    params = [m for m in marks if m.name == "parametrize"]
    if not params:
        fn()
        return
    (argname, values), = [m.args for m in params]
    for v in values:
        fn(**{argname: v})


@pytest.mark.parametrize("mode", ["given", "float32"])
@pytest.mark.parametrize("name", DRA_TESTS)
def test_dra_matches_jax(name, mode, monkeypatch):
    dual = DualModule(jdra, tdra)
    monkeypatch.setattr(jt, "ClusterCapacity", dual_cc(mode))
    # `from cluster_capacity_tpu.ops.dynamic_resources import f` inside a
    # test resolves through sys.modules; the JAX encoder's own
    # `from ..ops import dynamic_resources` reads the package attribute,
    # which only a test that never builds a ClusterCapacity may swap
    fn = getattr(jt, name)
    monkeypatch.setitem(sys.modules, jdra.__name__, dual)
    if "import dynamic_resources" in inspect.getsource(fn):
        import cluster_capacity_tpu.ops as jops
        monkeypatch.setattr(jops, "dynamic_resources", dual)
    from test_torch_cel import CALLS
    before = RUNS["n"] + CALLS["n"]
    _call(fn)
    assert RUNS["n"] + CALLS["n"] > before   # the test went through both


# --- seeded random DRA clusters --------------------------------------------

def random_dra_objects(seed, n_nodes=12):
    """Nodes with per-node ResourceSlices of two device classes (some with
    CEL-visible attributes), existing pods holding devices through template
    claims, a shared claim (allocated or not), and a template pod."""
    rng = np.random.RandomState(seed)
    classes = ["gpu.example.com", "fpga.example.com"]
    nodes, pods, slices = [], [], []
    for i in range(n_nodes):
        name = f"n{i:02d}"
        nodes.append(build_test_node(
            name, int(rng.choice([4000, 8000])), 16 * 1024 ** 3, 20,
            labels={"kubernetes.io/hostname": name,
                    "topology.kubernetes.io/zone": f"z{i % 3}"}))
        for cls in classes:
            k = int(rng.randint(0, 5))
            if k:
                slices.append({
                    "metadata": {"name": f"s-{name}-{cls}"},
                    "spec": {"nodeName": name, "driver": cls, "devices": [
                        {"name": f"d{j}", "deviceClassName": cls,
                         "attributes": {f"{cls}/model": {"string": str(
                             rng.choice(["a100", "h100"]))}},
                         "capacity": {f"{cls}/memory": {"value": str(int(
                             rng.choice([40, 80]))) + "Gi"}}}
                        for j in range(k)]}})
    tmpls = [{"metadata": {"name": f"t-{cls.split('.')[0]}-{c}",
                           "namespace": "default"},
              "spec": {"spec": {"devices": {"requests": [
                  {"name": "r0", "deviceClassName": cls, "count": c}]}}}}
             for cls in classes for c in (1, 2)]
    for i in range(n_nodes):
        if rng.rand() < 0.4:
            p = build_test_pod(f"e{i}", 200, 0, node_name=f"n{i:02d}")
            p["spec"]["resourceClaims"] = [{
                "name": "g", "resourceClaimTemplateName":
                tmpls[int(rng.randint(len(tmpls)))]["metadata"]["name"]}]
            pods.append(p)
    claim = {"metadata": {"name": "shared", "namespace": "default"},
             "spec": {"devices": {"requests": [
                 {"name": "r0", "deviceClassName": classes[0],
                  "count": 1}]}}}
    if rng.rand() < 0.5:
        claim["status"] = {"allocation": {"nodeSelector": {
            "nodeSelectorTerms": [{"matchExpressions": [{
                "key": "kubernetes.io/hostname", "operator": "In",
                "values": [f"n{int(rng.randint(n_nodes)):02d}"]}]}]}}}
    if rng.rand() < 0.5:
        pods.append(dict(build_test_pod("user", 100, 0,
                                        node_name="n00")))
        pods[-1]["spec"]["resourceClaims"] = [{
            "name": "s", "resourceClaimName": "shared"}]
    pod = build_test_pod("p", int(rng.choice([100, 300])), 0)
    kind = int(rng.randint(4))
    if kind == 0:
        pod["spec"]["resourceClaims"] = [{
            "name": "g", "resourceClaimTemplateName": tmpls[0]["metadata"][
                "name"]}]
    elif kind == 1:
        pod["spec"]["resourceClaims"] = [{"name": "s",
                                          "resourceClaimName": "shared"}]
    elif kind == 2:
        sel = {"metadata": {"name": "sel", "namespace": "default"},
               "spec": {"spec": {"devices": {"requests": [{
                   "name": "r0", "deviceClassName": classes[0],
                   "count": 1, "selectors": [{"cel": {"expression":
                       'device.attributes["gpu.example.com"].model == '
                       '"h100" && device.capacity["gpu.example.com"]'
                       '.memory >= quantity("80Gi")'}}]}]}}}}
        tmpls.append(sel)
        pod["spec"]["resourceClaims"] = [{"name": "g",
                                          "resourceClaimTemplateName": "sel"}]
    else:
        pod["spec"]["resourceClaims"] = [
            {"name": "g", "resourceClaimTemplateName":
             tmpls[3]["metadata"]["name"]},
            {"name": "s", "resourceClaimName": "shared"}]
    extra = {"resource_slices": slices, "resource_claim_templates": tmpls,
             "resource_claims": [claim]}
    return nodes, pods, pod, extra


@pytest.mark.parametrize("kind", ["default", "parity"])
@pytest.mark.parametrize("seed", range(10))
def test_random_dra_clusters_match_jax(seed, kind):
    nodes, pods, pod, extra = random_dra_objects(seed)
    jp = JProfile.parity() if kind == "parity" else JProfile()
    from cluster_capacity_tpu.models.podspec import default_pod
    for limit in (0, 7):
        run_pair(default_pod(pod), limit, jp, nodes, pods, extra)


@pytest.mark.parametrize("seed", range(6))
def test_snapshot_dra_columns_match_jax(seed):
    nodes, pods, _pod, extra = random_dra_objects(seed, n_nodes=20)
    js = JSnap.from_objects(nodes, pods, **extra)
    ts = TSnap.from_objects(nodes, pods, **extra)
    assert ts.resource_names == js.resource_names
    assert any(r.startswith(tdra.DRA_RESOURCE_PREFIX)
               for r in ts.resource_names)
    for arr in ("allocatable", "requested", "nonzero_requested"):
        assert np.array_equal(getattr(ts, arr), getattr(js, arr)), arr


@pytest.mark.parametrize("seed", range(6))
def test_with_pods_by_node_dra_branch_matches_jax(seed):
    """The incremental re-snapshot charges existing pods' template claims
    as the JAX package's does (shared claims make both return None)."""
    nodes, pods, _pod, extra = random_dra_objects(seed)
    extra = dict(extra, resource_claims=[])
    pods = [p for p in pods if not any(
        r.get("resourceClaimName")
        for r in p["spec"].get("resourceClaims") or [])]
    js = JSnap.from_objects(nodes, pods, **extra)
    ts = TSnap.from_objects(nodes, pods, **extra)
    rng = np.random.RandomState(seed)
    changed = sorted(set(int(i) for i in rng.randint(0, len(nodes), 4)))
    new_j = [list(p) for p in js.pods_by_node]
    new_t = [list(p) for p in ts.pods_by_node]
    for i in changed:
        if new_j[i]:
            new_j[i].pop()
            new_t[i].pop()
    jn = jsnap_mod.with_pods_by_node(js, new_j, changed)
    tn = tsnap_mod.with_pods_by_node(ts, new_t, changed)
    assert (jn is None) == (tn is None)
    if jn is not None:
        assert np.array_equal(tn.requested, jn.requested)
        assert np.array_equal(tn.nonzero_requested, jn.nonzero_requested)
    shared = dict(extra, resource_claims=[{"metadata": {
        "name": "c", "namespace": "default"}, "spec": {}}])
    assert tsnap_mod.with_pods_by_node(
        TSnap.from_objects(nodes, pods, **shared), new_t, changed) is None


@pytest.mark.parametrize("seed", range(8))
def test_engines_on_dra_problems(seed):
    """The port's own DRA problems through its engines: kernel 1's plain
    version (float32, where fused.eligible admits the problem) and the scan
    step give the same placements and carry, shared-claim colocation
    included."""
    nodes, pods, pod, extra = random_dra_objects(seed)
    from cluster_capacity_tpu_torch.models.podspec import default_pod
    pb = tenc.encode_problem(TSnap.from_objects(nodes, pods, **extra),
                             default_pod(pod), TProfile())
    if pb.pod_level_reason:
        return
    cfg = tsim.static_config(pb)
    assert tfused.eligible(cfg, pb)
    consts = tsim.build_consts(pb, "cpu")
    k = min(64, pb.max_steps_hint + 1)
    s_carry, s_chosen = tsim.run_chunk(cfg, consts,
                                       tsim._init_carry(pb, consts), k)
    pk = tfused._pack_meta(cfg, pb)
    const = tfused._pack_consts(pk, consts)
    planes, scalars = tfused._pack_carry(pk, tsim._init_carry(pb, consts))
    planes, scalars, chosen = tfused.fused_steps(
        const, planes, scalars, tfused.kernel_table(pk, "cpu"), k)
    assert chosen.reshape(-1).tolist() == s_chosen.tolist()
    if cfg.dra_shared_colocate:
        got = [c for c in s_chosen.tolist() if c >= 0]
        assert len(set(got)) <= 1


def test_dra_refusals_are_gone():
    """ResourceSlices and resourceClaims reach the port's solve."""
    nodes, pods, pod, extra = random_dra_objects(0)
    cc = TCC(pod, device="cpu")
    cc.sync_with_objects(nodes, pods, **extra)
    assert cc.run().fail_type in ("Unschedulable", "LimitReached")

"""The port's interleave race on a device mesh (parallel/interleave.py with
`mesh=`, parallel/mesh.run_grid, bounds/bracket's sharded auction,
distributed.interleave_on_mesh) against the JAX package's on the CPU.

The fixtures are tests/test_interleave_sharded.py's, tests/
test_interleave_tensor.py's and tests/test_mesh_padding.py's, built as
plain dicts for both packages from the same numpy seeds.  The port's
meshes are B×N logical shards of the CPU at 1x1, 2x4, 4x2 and 8x1 (and 2x2
and 4x1 where the template axis pads); the JAX package's are its 8 forced
virtual CPU devices.  The tolerance is exact: placements, placed counts,
fail type, fail message, fail counts, rung and `degraded` of every
SolveResult, the auction's claims and the CLI report's bytes.  The race is
held against the JAX package's sharded answers at the same mesh where the
JAX test holds its own, and against its unsharded tensor answers (which
its sharded ones equal) elsewhere; the two-process run is held against
the JAX package's single-process tensor answers, as its own two-process
test holds its run.
"""

import copy
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from cluster_capacity_tpu.bounds import bracket as jbracket
from cluster_capacity_tpu.cli import cluster_capacity as jcli
from cluster_capacity_tpu.engine import encode as jenc
from cluster_capacity_tpu.models.podspec import default_pod as j_default_pod
from cluster_capacity_tpu.models.snapshot import ClusterSnapshot as JSnap
from cluster_capacity_tpu.parallel import interleave as jil
from cluster_capacity_tpu.parallel import mesh as jmesh
from cluster_capacity_tpu.runtime import faults as jfaults
from cluster_capacity_tpu.utils.config import SchedulerProfile as JProfile
from cluster_capacity_tpu_torch.bounds import bracket as tbracket
from cluster_capacity_tpu_torch.cli import cluster_capacity as tcli
from cluster_capacity_tpu_torch.engine import encode as tenc
from cluster_capacity_tpu_torch.parallel import interleave as til
from cluster_capacity_tpu_torch.parallel import mesh as tmesh
from cluster_capacity_tpu_torch.runtime import faults as tfaults

from test_torch_distributed import _cluster_objects, _free_port
from test_torch_interleave import (HOST, ZONE, Study, _fields, _nodes,
                                   _port_template, _template,
                                   assert_equal_results, tiered_corpus)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 60

MESHES = {"1x1": (1, 1), "2x4": (2, 4), "4x2": (4, 2), "8x1": (8, 1)}


def _jm(spec):
    b, n = MESHES[spec] if isinstance(spec, str) else spec
    return jmesh.make_mesh(n_node_shards=n, n_batch_shards=b)


def _tm(spec):
    b, n = MESHES[spec] if isinstance(spec, str) else spec
    return tmesh.make_mesh(n_node_shards=n, n_batch_shards=b, device="cpu")


def _mix(t_n, seed=0):
    """tests/test_interleave_sharded.py's _mix: shared app labels put every
    clone under the same spread / anti-affinity selectors."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(t_n):
        kw = {}
        if i % 3 == 1:
            kw["spread"] = (2, ZONE, {"team": "fuzz"})
        if i % 3 == 2:
            kw["pref_anti"] = (50, HOST, {"team": "fuzz"})
        out.append(_template(f"t{i}", int(rng.choice([300, 450, 600, 900])),
                             mem_gi=int(rng.choice([0, 1])),
                             labels={"app": f"t{i}", "team": "fuzz"}, **kw))
    return out


def _dead_nodes(n, seed=0, dead=()):
    nodes = _nodes(n, seed=seed)
    for i in dead:
        nodes[int(i)]["spec"]["unschedulable"] = True
    return nodes


def _port(study, mesh, **kw):
    return til.solve_interleaved_tensor(study.tsnap, study.tt, study.tp,
                                        mesh=_tm(mesh), device="cpu", **kw)


@functools.lru_cache(maxsize=None)
def _fuzz_study(n_nodes, t_n, profile):
    """test_sharded_interleave_fuzz's first trial: a random dead-node set
    drawn from RandomState(n_nodes)."""
    rng = np.random.RandomState(n_nodes)
    dead = tuple(rng.choice(n_nodes, size=rng.randint(0, 4), replace=False))
    study = Study(_dead_nodes(n_nodes, dead=dead), _mix(t_n, seed=t_n),
                  profile=profile)
    return study, study.jax_tensor()


@pytest.mark.parametrize("mesh,case,profile", [
    ("1x1", (37, 5), "parity"), ("2x4", (37, 5), "parity"),
    ("4x2", (21, 3), "float32"), ("8x1", (21, 3), "float32")],
    ids=["1x1-37x5-parity", "2x4-37x5-parity", "4x2-21x3-float32",
         "8x1-21x3-float32"])
def test_sharded_interleave_fuzz(mesh, case, profile):
    """Node counts that do not divide the node shards (21 and 37 nodes)
    and template counts that pad (3 -> 4, 5 -> 8; to 8 on 8 rows), random
    dead nodes, bounds on (and off at 1x1): the sharded race equals the
    JAX package's unsharded race, which its sharded race equals
    (tests/test_interleave_sharded.py), every field; at 2x4 it equals the
    JAX package's sharded race too."""
    study, want = _fuzz_study(*case, profile)
    got = _port(study, mesh, bounds=True)
    assert_equal_results(want, got, f"{mesh} bounds")
    if mesh == "2x4":
        assert_equal_results(
            jil.solve_interleaved_tensor(study.jsnap, study.jt, study.jp,
                                         mesh=_jm(mesh), bounds=True),
            got, f"{mesh} vs the JAX package's sharded race")
    if mesh == "1x1":
        assert_equal_results(want, _port(study, mesh), "1x1 no bounds")


def test_sharded_interleave_max_total_parity():
    """The pooled budget (LimitReached and its message) survives sharding:
    max_total 1 and 17 at 4x2 equal the JAX package's."""
    study = Study(_dead_nodes(21, seed=3), _mix(4, seed=4))
    for max_total in (1, 17):
        want = study.jax_tensor(max_total=max_total)
        got = _port(study, "4x2", max_total=max_total)
        assert_equal_results(want, got, f"max_total={max_total}")
        assert {r.fail_type for r in got} == {"LimitReached"}


def test_bounds_skip_static_fail_template_parity():
    """A template no node can ever take (the bracket proves upper == 0)
    skips to its diagnosis on the mesh too, byte-equal to the JAX
    package's sharded race that skips it and to its unsharded race that
    visits it."""
    study = Study(_dead_nodes(21, seed=6),
                  _mix(3, seed=7) + [_template("whale", 64000, mem_gi=1)])
    want = study.jax_tensor()
    got = _port(study, "2x4", bounds=True)
    assert_equal_results(want, got, "sharded+bounds")
    assert_equal_results(
        jil.solve_interleaved_tensor(study.jsnap, study.jt, study.jp,
                                     mesh=_jm("2x4"), bounds=True),
        got, "the JAX package's sharded+bounds")
    assert got[3].placed_count == 0


def test_chaos_drill_bit_identical_fallback():
    """parallel.interleave_sharded:oom: both packages serve the unsharded
    race's answers, stamped rung interleave and degraded, bit-identical to
    the healthy run; a clean sharded run is stamped interleave_sharded,
    not degraded, with the same answers."""
    study = Study(_dead_nodes(13, seed=8), _mix(3, seed=9))
    ref = til.sweep_interleaved_auto(study.tsnap, study.tt, study.tp,
                                     device="cpu")
    with jfaults.inject("parallel.interleave_sharded:oom"):
        want = jil.sweep_interleaved_auto(study.jsnap, study.jt, study.jp,
                                          mesh=_jm("4x2"))
    with tfaults.inject("parallel.interleave_sharded:oom"):
        got = til.sweep_interleaved_auto(study.tsnap, study.tt, study.tp,
                                         mesh=_tm("4x2"), device="cpu")
    assert_equal_results(want, got, "degraded")
    assert {(r.rung, r.degraded) for r in got} == {("interleave", True)}
    for a, b in zip(ref, got):
        assert _fields(a)[:5] == _fields(b)[:5]
    clean = til.sweep_interleaved_auto(study.tsnap, study.tt, study.tp,
                                       mesh=_tm("4x2"), device="cpu")
    assert {(r.rung, r.degraded) for r in clean} == \
        {("interleave_sharded", False)}
    for a, b in zip(ref, clean):
        assert _fields(a)[:5] == _fields(b)[:5]


def test_flight_note_for_the_mesh_site(tmp_path):
    """A fault at parallel.interleave_sharded under an armed flight
    recorder: the bundle's kernel.txt says that no hand-written kernel
    serves the mesh path and names the site's canonical entry."""
    from cluster_capacity_tpu_torch.obs import flight
    study = Study(_nodes(6), [_template("a", 600), _template("b", 450)])
    flight.install(str(tmp_path / "f"))
    try:
        with tfaults.inject("parallel.interleave_sharded:oom"):
            got = til.sweep_interleaved_auto(study.tsnap, study.tt, study.tp,
                                             mesh=_tm("1x1"), device="cpu",
                                             max_total=4)
        bundle = flight.load_bundle(flight.bundle_paths()[-1])
    finally:
        flight.uninstall()
    assert {(r.rung, r.degraded) for r in got} == {("interleave", True)}
    assert bundle["manifest"]["ir"] == {"entry": "interleave_sharded/n8t2",
                                        "file": "kernel.txt"}
    assert "site: parallel.interleave_sharded" in bundle["kernel"]
    assert "no hand-written kernel serves the mesh path" in bundle["kernel"]


def test_legacy_entrypoint_unstamped():
    """mesh=None: no rung stamp, not degraded, bounds off by default — as
    in the JAX package."""
    study = Study(_dead_nodes(10, seed=2), _mix(3, seed=2))
    want = jil.sweep_interleaved_auto(study.jsnap, study.jt, study.jp)
    got = til.sweep_interleaved_auto(study.tsnap, study.tt, study.tp,
                                     device="cpu")
    assert_equal_results(want, got, "unstamped")
    assert {(r.rung, r.degraded) for r in got} == {("", False)}


@functools.lru_cache(maxsize=None)
def _pad_study(t_n):
    """tests/test_mesh_padding.py::test_interleave_nonpow2_templates_parity's
    mix at 11 nodes (which divides no node-shard count here)."""
    ts = [_template(f"t{i}", 300 + 150 * i, mem_gi=i % 2,
                    labels={"app": f"t{i}"}) for i in range(t_n)]
    study = Study(_nodes(11, seed=t_n), ts)
    return study, study.jax_tensor()


@pytest.mark.parametrize("mesh", [(2, 2), (4, 1)], ids=["2x2", "4x1"])
@pytest.mark.parametrize("t_n", [1, 3, 5])
def test_template_pads_parity(t_n, mesh):
    """Template counts that pad on a batch of 2 and of 4 (1 -> 2 or 4,
    3 -> 4, 5 -> 8): pad templates never pop, and the race equals the JAX
    package's unsharded one."""
    study, want = _pad_study(t_n)
    assert_equal_results(want, _port(study, mesh), f"t_n={t_n}")


def test_shards_hold_their_rows_and_nodes(monkeypatch):
    """Shard (r, k) of a 2x4 mesh holds its row's 4 of the 8 padded
    templates and its 6 of the 24 padded nodes of every [T, ..., N] plane
    (carry and consts), its row's templates of every [T] vector, and the
    shared node state's 6 nodes; nothing holds a whole template axis but
    the [T, T, ...] increment matrices' placing axis."""
    seen = {}
    real_run = til._MeshRace.run

    def run(self, cfg, xc, k):
        out = real_run(self, cfg, xc, k)
        seen.setdefault("race", self)
        return out

    monkeypatch.setattr(til._MeshRace, "run", run)
    study = Study(_dead_nodes(21), [_port_template("a", 300, 8080)]
                  + _mix(4, seed=1))
    want = study.jax_tensor()
    assert_equal_results(want, _port(study, "2x4"), "ports on 2x4")
    race = seen["race"]
    assert (race.t_local, race.n_local) == (4, 6)
    assert sorted(race.carries) == [(r, k) for r in range(2)
                                    for k in range(4)]
    for (r, k), c in race.carries.items():
        assert tuple(c.tpl_placed.shape) == (4, 6)
        for f in ("sh_cnt", "ss_cnt", "ssh_cnt", "aff_cnt", "anti_cnt",
                  "eanti_cnt", "pref_cnt"):
            v = getattr(c, f)
            assert (v.shape[0], v.shape[-1]) == (4, 6), (f, v.shape)
        for f in ("aff_total", "k", "active", "last_seq", "next_start"):
            assert tuple(getattr(c, f).shape) == (4,), f
        assert c.requested.shape[0] == c.nonzero.shape[0] == 6
        consts = race.consts[(r, k)]
        assert tuple(consts["s.static_mask"].shape) == (4, 6)
        assert tuple(consts["s.allocatable"].shape[:2]) == (4, 6)
        assert consts["s.sh_dom"].shape[0] == 4
        assert consts["s.sh_dom"].shape[-1] == 6
        assert tuple(consts["x.ext_mask"].shape) == (4, 6)
        assert tuple(consts["x.tier_rank"].shape) == (4,)
        assert tuple(consts["x.port_conflict"].shape) == (8, 4)
        assert consts["x.sh_xinc"].shape[:2] == (8, 4)


@pytest.mark.parametrize("profile", ["parity", "float32"])
def test_extender_mix_on_mesh(profile):
    """Callable Filter and Prioritize extenders: the per-template mask and
    bonus shard over rows and nodes; the answers (the extender bucket of
    an emptied window included) equal the JAX package's."""
    from cluster_capacity_tpu.engine.extenders import ExtenderConfig as JExt
    from cluster_capacity_tpu_torch.engine.extenders import (
        ExtenderConfig as TExt)

    def filt(pod, names):
        name = (pod.get("metadata") or {}).get("name")
        if name == "blocked":
            return {"NodeNames": []}
        return {"NodeNames": [n for n in names if int(n[1:]) % 3 != 0]}

    def prio(pod, names):
        return [{"Host": n, "Score": 3 if int(n[1:]) % 4 == 1 else 0}
                for n in names]

    ts = [_template("a", 600, spread=(1, ZONE, {"app": "a"})),
          _template("b", 450), _template("blocked", 100)]
    study = Study(_nodes(9), ts, profile=profile, extenders=(
        [JExt(filter_callable=filt, prioritize_callable=prio, weight=2)],
        [TExt(filter_callable=filt, prioritize_callable=prio, weight=2)]))
    want = study.jax_tensor()
    assert_equal_results(want, _port(study, "2x4"), "extenders")
    assert want[2].placed_count == 0


def test_host_ports_and_disks_cross_rows():
    """Host ports and an inline disk on a 4x2 mesh, one template a row:
    tpl_placed and the ports-blocked reduction cross the rows, and the
    answers equal the JAX package's."""
    disk = _template("d", 250)
    disk["spec"]["volumes"] = [
        {"name": "v", "gcePersistentDisk": {"pdName": "pd-x"}}]
    ts = [_port_template("a", 300, 8080), _port_template("b", 300, 8080),
          disk, _template("s", 250, spread=(1, ZONE, {"app": "s"}))]
    study = Study(_nodes(5), ts)
    want = study.jax_tensor()
    got = _port(study, "4x2")
    assert_equal_results(want, got, "ports+disk")
    assert got[0].placed_count + got[1].placed_count == 5
    assert "free ports" in got[0].fail_message


@pytest.mark.parametrize("seed", [0, 1])
def test_tiered_preemption_on_mesh(seed):
    """Priority tiers with victims and preemption rebuilds (the re-encode
    re-shards every const) on a 2x4 mesh equal the JAX package's
    unsharded race."""
    nodes, victims, ts = tiered_corpus(seed)
    study = Study(nodes, ts, pods=victims)
    want = study.jax_tensor()
    assert_equal_results(want, _port(study, "2x4" if seed else "8x1"),
                         f"tiered-{seed}")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_auction_claims_on_mesh(mesh):
    """bracket_mix over each mesh: the sharded auction's claims equal the
    JAX package's sharded claims at the same mesh, the port's unsharded
    ones and the float64 host auction's; not degraded."""
    nodes = _dead_nodes(21, seed=5, dead=(3, 7))
    ts = _mix(5, seed=5)
    study = Study(nodes, ts)
    jpbs = jenc.encode_problems_shared(study.jsnap, study.jt, study.jp)
    tpbs = tenc.encode_problems_shared(study.tsnap, study.tt, study.tp)
    jjoint, jclaims, jdeg = jbracket.bracket_mix(jpbs, mesh=_jm(mesh))
    joint, claims, deg = tbracket.bracket_mix(tpbs, mesh=_tm(mesh),
                                              device="cpu")
    assert not (deg or jdeg)
    assert claims == jclaims == tbracket._auction_host(tpbs) == \
        tbracket.auction_device(tpbs, device="cpu")
    assert (joint.lower, joint.upper, joint.exact) == \
        (jjoint.lower, jjoint.upper, jjoint.exact)


def test_steady_runs_compile_nothing():
    """The port's form of the JAX zero-steady-recompiles test: the sharded
    step runs eagerly, so cc_recompiles_total stays flat across warm and
    steady sharded runs of fresh snapshots of one shape, with equal
    answers run to run."""
    from cluster_capacity_tpu_torch import obs
    from cluster_capacity_tpu_torch.obs import names as obs_names
    from cluster_capacity_tpu_torch.utils.metrics import default_registry

    obs.install_recompile_hook()
    ts = _mix(3, seed=11)
    before = default_registry.counter_total(obs_names.RECOMPILES)
    first = None
    for seed in (11, 12, 12):
        study = Study(_nodes(9, seed=seed), ts, profile="float32")
        got = til.sweep_interleaved_auto(study.tsnap, study.tt, study.tp,
                                         mesh=_tm((2, 2)), device="cpu",
                                         max_total=12)
        if seed == 12:
            first = first or got
            assert_equal_results(first, got, "steady")
    assert default_registry.counter_total(obs_names.RECOMPILES) == before


def test_cli_interleave_mesh_byte_equal(tmp_path, capsys):
    """`cluster-capacity --interleave --mesh 4x2 -o json` on three
    podspecs: the JAX CLI's bytes (creation timestamps dropped)."""
    specs = [_template("web", 400, spread=(1, ZONE, {"app": "web"})),
             _template("cache", 600, anti=(HOST, {"app": "cache"})),
             _template("batch", 900, mem_gi=1)]
    argv = []
    for s in specs:
        p = tmp_path / f"{s['metadata']['name']}.json"
        p.write_text(json.dumps(s))
        argv += ["--podspec", str(p)]
    snap = tmp_path / "snap.json"
    snap.write_text(json.dumps({"nodes": _nodes(9), "pods": []}))
    argv += ["--snapshot", str(snap), "--interleave", "--mesh", "4x2",
             "-o", "json", "--max-limit", "20"]
    outs = []
    for module, extra in ((jcli, []), (tcli, ["--device", "cpu"])):
        assert module.run(argv + extra) == 0
        outs.append([x for x in capsys.readouterr().out.splitlines()
                     if "creationTimestamp" not in x])
    assert outs[0] == outs[1]


# --- two processes -----------------------------------------------------------

def _templates(pod):
    """tests/test_distributed.py::test_two_process_interleave_smoke's three
    templates: its pod at 300, 600 and 900m."""
    out = []
    for i, cpu in enumerate(("300m", "600m", "900m")):
        t = json.loads(json.dumps(pod))
        t["metadata"]["name"] = f"p{i}"
        t["spec"]["containers"][0]["resources"]["requests"]["cpu"] = cpu
        out.append(t)
    return out


def _worker(base: str, out: str, limit: int, batch_shards: int,
            local_shards: int) -> int:
    """One process of the two-process race: join the gloo group, load this
    process's snapshot shard, run distributed.interleave_on_mesh (its own
    choice of mesh with `local_shards` 0, else a batch_shards x
    local_shards/batch_shards mesh of this process's CPU shards), and
    (process 0) write the answers."""
    sys.path.insert(0, REPO)
    import torch.distributed as tdist

    from cluster_capacity_tpu_torch.models.podspec import default_pod
    from cluster_capacity_tpu_torch.parallel import distributed as dist
    from cluster_capacity_tpu_torch.utils.config import SchedulerProfile

    dist.initialize(timeout_s=WORKER_TIMEOUT_S)
    try:
        snapshot = dist.load_snapshot_distributed(base)
        with open(base + ".templates.json") as f:
            templates = [default_pod(t) for t in json.load(f)]
        mesh = None if not local_shards else dist.local_mesh(
            batch_shards, device="cpu", local_shards=local_shards)
        results = dist.interleave_on_mesh(snapshot, templates,
                                          SchedulerProfile.parity(),
                                          max_total=limit, mesh=mesh,
                                          device="cpu")
        if dist.process_index() == 0:
            with open(out, "w") as f:
                json.dump({"interleave": [
                    [r.placements, r.fail_type, r.fail_message, r.rung,
                     r.degraded] for r in results],
                    "processes": dist.process_count()}, f)
    finally:
        tdist.destroy_process_group()
    return 0


@pytest.mark.dist
@pytest.mark.parametrize("batch_shards,local_shards", [(1, 0), (2, 4)],
                         ids=["own-mesh", "2x2-each"])
def test_two_process_interleave_on_mesh(tmp_path, batch_shards,
                                        local_shards):
    """Two processes over gloo, each loading only its snapshot shard and
    racing the templates on its own local mesh (interleave_on_mesh's
    choice, one CPU shard; or a 2x2 mesh of four logical shards): process
    0's answers equal the JAX package's single-process tensor race, rung
    interleave_sharded, not degraded.  (The JAX package's own two-process
    race raises in its sharded auction on a multi-process runtime.)"""
    from cluster_capacity_tpu_torch.parallel import distributed as dist

    nodes, pod = _cluster_objects()
    limit = 24
    templates = _templates(pod)
    ref = jil.solve_interleaved_tensor(
        JSnap.from_objects(copy.deepcopy(nodes)),
        [j_default_pod(t) for t in copy.deepcopy(templates)],
        JProfile.parity(), max_total=limit)
    base = str(tmp_path / "snap")
    dist.write_sharded_snapshot(base, nodes, num_shards=2)
    with open(base + ".templates.json", "w") as f:
        json.dump(templates, f)
    out = str(tmp_path / "out.json")
    port = _free_port()
    env = dict(os.environ, CC_COORDINATOR=f"127.0.0.1:{port}",
               CC_NUM_PROCESSES="2",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + os.environ.get("PYTHONPATH", "").split(
                       os.pathsep)))
    procs, logs = [], []
    try:
        for pid in range(2):
            log = open(str(tmp_path / f"worker{pid}.log"), "w+b")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 base, out, str(limit), str(batch_shards),
                 str(local_shards)],
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
    with open(out) as f:
        got = json.load(f)
    assert got["processes"] == 2
    assert got["interleave"] == [
        [r.placements, r.fail_type, r.fail_message, "interleave_sharded",
         False] for r in ref]
    assert sum(len(r[0]) for r in got["interleave"]) == limit


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.exit(_worker(sys.argv[2], sys.argv[3], int(sys.argv[4]),
                         int(sys.argv[5]), int(sys.argv[6])))

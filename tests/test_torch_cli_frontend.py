"""The port's front end (cli/cluster_capacity.py, cli/genpod.py,
cli/hypercc.py, utils/golden.py, utils/version.py) against the JAX
package's, on the CPU.

Each case runs both CLIs in-process on the same arguments (the port with
--device cpu) and compares exit codes, stdout and stderr: --period and
--watch with their snapshot-load counts (tests/test_cli.py:94-191), the
checkpoint round trip (--save-snapshot, an .npz --snapshot, across
packages), --node-order zone-round-robin, --strict-after, --record-golden
(a file recorded by the port equals the JAX package's byte for byte, and
each package replays the other's), --podspec over http(s), --kubeconfig and
CC_INCLUSTER without the kubernetes client, the validation messages,
hypercc dispatch and version, and genpod on examples/.  Report
creationTimestamps are dropped before comparing.  Tolerance: exact.
"""

import json
import os
import threading
import time as time_mod
from functools import partial
from http.server import HTTPServer, SimpleHTTPRequestHandler

import pytest

from cluster_capacity_tpu.cli import cluster_capacity as jcli
from cluster_capacity_tpu.cli import genpod as jgenpod
from cluster_capacity_tpu.cli import hypercc as jhypercc
from cluster_capacity_tpu.runtime import faults as jfaults
from cluster_capacity_tpu.utils import golden as jgolden
from cluster_capacity_tpu_torch.cli import cluster_capacity as tcli
from cluster_capacity_tpu_torch.cli import genpod as tgenpod
from cluster_capacity_tpu_torch.cli import hypercc as thypercc
from cluster_capacity_tpu_torch.runtime import faults as tfaults
from cluster_capacity_tpu_torch.utils import golden as tgolden
from cluster_capacity_tpu_torch.utils import version as tversion

from helpers import build_test_node

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAPSHOT = os.path.join(REPO, "examples", "cluster-snapshot.yaml")
PODSPEC = os.path.join(REPO, "examples", "pod.yaml")
PODSPEC2 = os.path.join(REPO, "examples", "pod-spec.yaml")
ZONE = "topology.kubernetes.io/zone"
POD_YAML = ("metadata:\n  name: p\nspec:\n  containers:\n"
            "  - name: c\n    resources:\n      requests:\n"
            "        cpu: 500m\n")
CLIS = ((jcli, [], jfaults), (tcli, ["--device", "cpu"], tfaults))


@pytest.fixture(autouse=True)
def _clean_faults():
    jfaults.clear()
    tfaults.clear()
    yield
    jfaults.clear()
    tfaults.clear()


def _strip(text):
    """Drop the report's creation timestamps (the run's wall clock)."""
    out = []
    for line in text.splitlines():
        if "creationTimestamp" in line:
            if line.lstrip().startswith("{"):
                data = json.loads(line)
                data["status"].pop("creationTimestamp", None)
                line = json.dumps(data)
            else:
                continue
        out.append(line)
    return out


def _both(argv, capsys, port_extra=()):
    """[(rc, stdout, stderr)] of the JAX CLI, then the port's."""
    out = []
    for module, extra, harness in CLIS:
        rc = module.run(list(argv) + extra +
                        (list(port_extra) if module is tcli else []))
        cap = capsys.readouterr()
        out.append((rc, _strip(cap.out), cap.err))
        harness.clear()
    return out


def _same(argv, capsys, rc=0):
    (jrc, jout, jerr), (trc, tout, terr) = _both(argv, capsys)
    assert jrc == trc == rc, (jrc, trc, jerr, terr)
    assert tout == jout
    assert terr == jerr
    return tout


def _snap_with_cpu(cpu):
    return {"nodes": [{"metadata": {"name": "n0"}, "spec": {},
                       "status": {"allocatable": {"cpu": cpu,
                                                  "memory": "4Gi",
                                                  "pods": "10"}}}]}


def _period_files(tmp_path):
    sp = tmp_path / "snap.json"
    sp.write_text(json.dumps(_snap_with_cpu("1")))
    podf = tmp_path / "pod.yaml"
    podf.write_text(POD_YAML)
    return sp, podf


# ---------------------------------------------------------------------------
# --period and --watch (tests/test_cli.py:94-191 through both CLIs)
# ---------------------------------------------------------------------------

def test_period_continuous_mode(tmp_path, capsys, monkeypatch):
    outs = []
    for module, extra, _ in CLIS:
        sp, podf = _period_files(tmp_path)
        real_sleep = time_mod.sleep

        def sleep_and_grow(seconds, sp=sp):
            sp.write_text(json.dumps(_snap_with_cpu("2")))
            real_sleep(0)

        monkeypatch.setattr(time_mod, "sleep", sleep_and_grow)
        rc = module.run(["--podspec", str(podf), "--snapshot", str(sp),
                         "--verbose", "--period", "0.01",
                         "--period-iterations", "2"] + extra)
        monkeypatch.setattr(time_mod, "sleep", real_sleep)
        assert rc == 0
        out = capsys.readouterr().out
        assert out.count("can schedule 2 instance(s)") == 1
        assert out.count("can schedule 4 instance(s)") == 1
        outs.append(_strip(out))
    assert outs[0] == outs[1]


def test_watch_stream_reuses_snapshot(tmp_path, capsys, monkeypatch):
    results = []
    for module, extra, _ in CLIS:
        sp, podf = _period_files(tmp_path)
        loads = []
        real_load = module.load_snapshot_objects

        def counting_load(path, loads=loads, real_load=real_load):
            loads.append(path)
            return real_load(path)

        monkeypatch.setattr(module, "load_snapshot_objects", counting_load)
        real_sleep = time_mod.sleep
        argv = ["--podspec", str(podf), "--snapshot", str(sp), "--verbose",
                "--watch", "--period", "0.01", "--period-iterations",
                "3"] + extra

        # phase 1: three unchanged iterations -> exactly one load
        monkeypatch.setattr(time_mod, "sleep", lambda s: real_sleep(0))
        assert module.run(argv) == 0
        assert len(loads) == 1, "unchanged file must be loaded once"
        out1 = capsys.readouterr().out
        assert out1.count("can schedule 2 instance(s)") == 3

        # phase 2: an mtime change mid-stream triggers exactly one re-sync
        loads.clear()
        iterations = []

        def sleep_and_grow(seconds, sp=sp, iterations=iterations):
            if not iterations:
                sp.write_text(json.dumps(_snap_with_cpu("2")))
                st = os.stat(sp)
                os.utime(sp, ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 6))
            iterations.append(1)
            real_sleep(0)

        monkeypatch.setattr(time_mod, "sleep", sleep_and_grow)
        assert module.run(argv) == 0
        assert len(loads) == 2, "one initial load + one re-sync"
        out2 = capsys.readouterr().out
        assert out2.count("can schedule 2 instance(s)") == 1
        assert out2.count("can schedule 4 instance(s)") == 2
        monkeypatch.setattr(time_mod, "sleep", real_sleep)
        monkeypatch.setattr(module, "load_snapshot_objects", real_load)
        results.append((_strip(out1), _strip(out2)))
    assert results[0] == results[1]


def test_watch_reuses_the_snapshot_memo(tmp_path, capsys, monkeypatch):
    """A --watch iteration on an unchanged file re-encodes on the same
    snapshot object, so its memoized host arrays are reused, not rebuilt."""
    from cluster_capacity_tpu_torch.framework import ClusterCapacity

    sp, podf = _period_files(tmp_path)
    seen = []
    real_set = ClusterCapacity.set_snapshot

    def recording(self, snapshot):
        seen.append((snapshot, len(getattr(snapshot, "_memo", {}))))
        return real_set(self, snapshot)

    monkeypatch.setattr(ClusterCapacity, "set_snapshot", recording)
    real_sleep = time_mod.sleep
    monkeypatch.setattr(time_mod, "sleep", lambda s: real_sleep(0))
    assert tcli.run(["--podspec", str(podf), "--snapshot", str(sp),
                     "--watch", "--period", "0.01", "--period-iterations",
                     "3", "--device", "cpu"]) == 0
    capsys.readouterr()
    snaps = [s for s, _ in seen]
    assert snaps[0] is snaps[1] is snaps[2]
    assert seen[0][1] == 0 and seen[1][1] > 0 and seen[2][1] == seen[1][1]


def test_strict_after_grace(tmp_path, capsys, monkeypatch):
    """--strict --strict-after 1 on a --period loop: the first iteration's
    degraded run is grace; the second's exits 3.  Both CLIs stop after
    the same iteration with the same output."""
    sp, podf = _period_files(tmp_path)
    real_sleep = time_mod.sleep
    monkeypatch.setattr(time_mod, "sleep", lambda s: real_sleep(0))
    base = ["--podspec", str(podf), "--snapshot", str(sp), "-o", "json",
            "--period", "0.01", "--period-iterations", "3", "--strict",
            "--inject-fault", "engine.solve:oom:1:0"]
    out = _same(base + ["--strict-after", "1"], capsys, rc=3)
    assert len(out) == 2 and all(json.loads(x)["status"]["degraded"]
                                 for x in out)
    out = _same(base + ["--strict-after", "5"], capsys, rc=0)
    assert len(out) == 3
    # a healthy loop never trips --strict
    out = _same(base[:-2] + ["--strict-after", "0"], capsys, rc=0)
    assert len(out) == 3


# ---------------------------------------------------------------------------
# checkpoints, node order, golden recordings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [(0, 1), (1, 0), (1, 1)])
def test_snapshot_checkpoint_roundtrip_cli(tmp_path, capsys, writer, reader):
    ckpt = str(tmp_path / "snap.npz")
    w_mod, w_extra, _ = CLIS[writer]
    assert w_mod.run(["--podspec", PODSPEC, "--snapshot", SNAPSHOT,
                      "--save-snapshot", ckpt] + w_extra) == 0
    assert capsys.readouterr().out.strip() == "52"
    r_mod, r_extra, _ = CLIS[reader]
    assert r_mod.run(["--podspec", PODSPEC, "--snapshot", ckpt,
                      "-o", "json"] + r_extra) == 0
    got = _strip(capsys.readouterr().out)
    assert jcli.run(["--podspec", PODSPEC, "--snapshot", SNAPSHOT,
                     "-o", "json"]) == 0
    assert got == _strip(capsys.readouterr().out)


def _zone_snapshot(tmp_path):
    nodes = [build_test_node(f"{p}{i}", 1000, 4 * 1024 ** 3, 10,
                             labels={ZONE: z})
             for i in range(2) for p, z in (("a", "za"), ("b", "zb"),
                                            ("c", "za"))]
    sp = tmp_path / "zones.json"
    sp.write_text(json.dumps({"nodes": nodes}))
    podf = tmp_path / "pod.yaml"
    podf.write_text(POD_YAML)
    return str(sp), str(podf)


def test_node_order(tmp_path, capsys):
    sp, podf = _zone_snapshot(tmp_path)
    for order in ("zone-round-robin", "sorted"):
        out = _same(["--podspec", podf, "--snapshot", sp, "-o", "json",
                     "--max-limit", "5", "--node-order", order], capsys)
        assert json.loads(out[0])["status"]["replicas"] == 5
    ckpt = str(tmp_path / "z.npz")
    assert tcli.run(["--podspec", podf, "--snapshot", sp, "--device", "cpu",
                     "--save-snapshot", ckpt]) == 0
    capsys.readouterr()
    for argv in (["--snapshot", ckpt], ["--kubeconfig", "kc"]):
        (jrc, _, jerr), (trc, _, terr) = _both(
            ["--podspec", podf, "--node-order", "zone-round-robin"] + argv,
            capsys)
        assert jrc == trc == 1 and terr == jerr
        assert "--node-order zone-round-robin requires" in terr


def test_record_golden_byte_equal_and_cross_replay(tmp_path, capsys):
    sp, podf = _zone_snapshot(tmp_path)
    files = []
    for name, (module, extra, _) in zip(("jax", "torch"), CLIS):
        path = str(tmp_path / f"{name}.json")
        assert module.run(["--podspec", podf, "--snapshot", sp,
                           "--max-limit", "7", "--exclude-nodes", "b1",
                           "--node-order", "zone-round-robin",
                           "--record-golden", path] + extra) == 0
        err = capsys.readouterr().err
        assert f"golden scenario written to {path}" in err
        files.append(path)
    assert open(files[0], "rb").read() == open(files[1], "rb").read()
    for path in files:
        for golden, kw in ((jgolden, {}), (tgolden, {"device": "cpu"})):
            data = golden.load_scenario(path)
            assert golden.compare_result(
                data, golden.run_scenario(data, **kw)) == []


@pytest.mark.parametrize("parity", [False, True])
def test_record_golden_python_api(tmp_path, parity):
    """record_scenario of both packages on one run: the same bytes, and
    each package's profile_to_dict / profile_from_dict round-trip the
    other's."""
    from cluster_capacity_tpu import ClusterCapacity as JCC
    from cluster_capacity_tpu.models.podspec import default_pod as jdp
    from cluster_capacity_tpu.utils.config import SchedulerProfile as JP
    from cluster_capacity_tpu_torch import ClusterCapacity as TCC
    from cluster_capacity_tpu_torch.models.podspec import default_pod as tdp
    from cluster_capacity_tpu_torch.utils.config import SchedulerProfile as TP

    nodes = [build_test_node(f"n{i}", 1000, 2 * 1024 ** 3, 10)
             for i in range(3)]
    pod = {"metadata": {"name": "p"}, "spec": {"containers": [
        {"name": "c", "resources": {"requests": {"cpu": "300m"}}}]}}
    paths = []
    for name, cc_cls, prof_cls, dp, golden, kw in (
            ("j", JCC, JP, jdp, jgolden, {}),
            ("t", TCC, TP, tdp, tgolden, {"device": "cpu"})):
        profile = prof_cls.parity() if parity else prof_cls()
        cc = cc_cls(dp(pod), profile=profile, **kw)
        cc.sync_with_objects(nodes)
        res = cc.run()
        path = tmp_path / f"{name}.json"
        golden.record_scenario(str(path), dp(pod), {"nodes": nodes},
                               profile, max_limit=0, res=res)
        paths.append(path)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    data = json.loads(paths[0].read_text())
    as_json = lambda d: json.loads(json.dumps(d))
    for a, b in ((jgolden, tgolden), (tgolden, jgolden)):
        prof = a.profile_from_dict(data["profile"])
        assert as_json(b.profile_to_dict(b.profile_from_dict(
            data["profile"]))) == as_json(a.profile_to_dict(prof)) == \
            data["profile"]
    with pytest.raises(ValueError, match="unknown profile fields"):
        tgolden.profile_from_dict({"bogus": 1})


def test_scheduler_profile_fields_match():
    """Both SchedulerProfiles have the same fields, defaults and order, so
    dataclasses.asdict (profile_to_dict, fingerprints) gives the same keys
    in the same order."""
    import dataclasses

    from cluster_capacity_tpu.utils.config import SchedulerProfile as JP
    from cluster_capacity_tpu_torch.utils.config import SchedulerProfile as TP

    def fields(cls):
        out = []
        for f in dataclasses.fields(cls):
            default = f.default
            if f.default_factory is not dataclasses.MISSING:
                default = f.default_factory()
            if dataclasses.is_dataclass(default):
                default = (type(default).__name__,
                           dataclasses.asdict(default))
            out.append((f.name, default))
        return out
    assert fields(TP) == fields(JP)
    assert "tensor_extenders" in [name for name, _ in fields(TP)]
    for make in (lambda c: c(), lambda c: c.parity()):
        assert list(dataclasses.asdict(make(TP)).items()) == \
            list(dataclasses.asdict(make(JP)).items())


def test_record_golden_refusals(tmp_path, capsys):
    sp, podf = _zone_snapshot(tmp_path)
    ckpt = str(tmp_path / "z.npz")
    assert tcli.run(["--podspec", podf, "--snapshot", sp, "--device", "cpu",
                     "--save-snapshot", ckpt]) == 0
    capsys.readouterr()
    cfg = tmp_path / "ext.yaml"
    cfg.write_text("apiVersion: kubescheduler.config.k8s.io/v1\n"
                   "kind: KubeSchedulerConfiguration\n"
                   "profiles:\n- schedulerName: default-scheduler\n"
                   "extenders:\n- urlPrefix: http://127.0.0.1:1\n"
                   "  filterVerb: filter\n")
    out = str(tmp_path / "g.json")
    for argv in (["--podspec", podf, "--podspec", podf, "--snapshot", sp],
                 ["--podspec", podf, "--snapshot", ckpt],
                 ["--podspec", podf, "--snapshot", sp,
                  "--default-config", str(cfg)]):
        (jrc, _, jerr), (trc, _, terr) = _both(
            argv + ["--record-golden", out], capsys)
        assert jrc == trc == 1 and terr == jerr and "--record-golden" in terr
    assert not os.path.exists(out)


# ---------------------------------------------------------------------------
# podspec URLs, live sync without the client, validation
# ---------------------------------------------------------------------------

class _QuietHandler(SimpleHTTPRequestHandler):
    def log_message(self, *a):            # silence
        pass


@pytest.fixture()
def http_root():
    handler = partial(_QuietHandler,
                      directory=os.path.join(REPO, "examples"))
    srv = HTTPServer(("127.0.0.1", 0), handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_port}"
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)
    assert not t.is_alive()


def test_podspec_url(http_root, capsys):
    for fmt in (["-o", "json"], ["--verbose"]):
        out = _same(["--podspec", f"{http_root}/pod.yaml", "--snapshot",
                     SNAPSHOT] + fmt, capsys)
        local = _same(["--podspec", PODSPEC, "--snapshot", SNAPSHOT] + fmt,
                      capsys)
        assert out == local
    # a sweep with one URL and one path
    _same(["--podspec", f"{http_root}/pod.yaml", "--podspec", PODSPEC2,
           "--snapshot", SNAPSHOT, "-o", "yaml"], capsys)


@pytest.mark.parametrize("incluster", [False, True])
def test_kubeconfig_without_the_client(capsys, monkeypatch, incluster):
    if incluster:
        monkeypatch.setenv("CC_INCLUSTER", "true")
        argv = ["--podspec", PODSPEC]
    else:
        monkeypatch.delenv("CC_INCLUSTER", raising=False)
        argv = ["--podspec", PODSPEC, "--kubeconfig", "/nonexistent"]
    msgs = []
    for module, extra, _ in CLIS:
        with pytest.raises(SystemExit) as ei:
            module.run(argv + extra)
        msgs.append(ei.value.code)
    assert msgs[0] == msgs[1]
    assert "requires the `kubernetes` python client" in msgs[1]


def test_validation_messages(capsys, monkeypatch):
    monkeypatch.delenv("CC_INCLUSTER", raising=False)
    for argv, rc, needle in (
            (["--snapshot", SNAPSHOT], 1, "--podspec is required"),
            (["--podspec", PODSPEC], 1,
             "provide --snapshot, --kubeconfig, or set CC_INCLUSTER=true"),
            (["--podspec", PODSPEC, "--snapshot", SNAPSHOT, "-o", "xml"], 1,
             "not recognized"),
            (["--podspec", PODSPEC, "--snapshot", SNAPSHOT,
              "--inject-fault", "bogus"], 1, "bad fault spec")):
        (jrc, jout, jerr), (trc, tout, terr) = _both(argv, capsys)
        assert jrc == trc == rc and tout == jout == [] and terr == jerr
        assert needle in terr, terr
    # several podspecs with no snapshot: the sweep needs one
    msgs = []
    for module, extra, _ in CLIS:
        with pytest.raises(SystemExit) as ei:
            module.run(["--podspec", PODSPEC, "--podspec", PODSPEC2,
                        "--kubeconfig", "kc"] + extra)
        msgs.append(ei.value.code)
    assert msgs == ["multi-podspec sweeps require --snapshot"] * 2


def test_later_flags_refused(capsys):
    """No flag waits for a later slice: --mesh is served (B×N logical
    shards of the CPU with --device cpu, 'auto' unsharded on the CPU) with
    the unsharded answer, and --interleave with one podspec changes
    nothing, with or without --mesh, as in the JAX CLI.  An unknown flag
    is argparse's usage error, as in the JAX CLI."""
    base = ["--podspec", PODSPEC, "--snapshot", SNAPSHOT, "--device", "cpu"]
    for flag in (["--mesh", "2x4"], ["--mesh=auto"]):
        assert tcli.run(base + flag) == 0
        assert capsys.readouterr().out == "52\n"
    assert tcli.run(base + ["--interleave"]) == 0
    assert capsys.readouterr().out == "52\n"
    assert tcli.run(base + ["--interleave", "--mesh", "1x1"]) == 0
    assert capsys.readouterr().out == "52\n"
    # a flag neither CLI knows is argparse's usage error in both
    for module in (jcli, tcli):
        with pytest.raises(SystemExit) as ei:
            module.run(base[:4] + ["--no-such-flag"])
        assert ei.value.code == 2
        assert "unrecognized arguments: --no-such-flag" in \
            capsys.readouterr().err


# ---------------------------------------------------------------------------
# hypercc, version, genpod
# ---------------------------------------------------------------------------

def test_hypercc_dispatch_and_version(capsys):
    out = []
    for hyper, extra in ((jhypercc, []), (thypercc, ["--device", "cpu"])):
        assert hyper.run(["cluster-capacity", "--podspec", PODSPEC,
                          "--snapshot", SNAPSHOT] + extra) == 0
        assert hyper.run(["genpod", "--snapshot", SNAPSHOT,
                          "--namespace", "limited"]) == 0
        for v in (["--version"], ["version"]):
            assert hyper.run(v) == 0
        out.append(capsys.readouterr().out)
    assert out[0] == out[1]
    assert out[1].startswith("52\n") and "hypercc 0.1.0\n" in out[1]
    info = tversion.get()
    assert (info.version, info.major, info.minor) == ("0.1.0", "0", "1")


def test_hypercc_explain_subcommand(capsys):
    from cluster_capacity_tpu.cli import explain as jexplain
    from cluster_capacity_tpu_torch.cli import explain as texplain

    argv = ["--podspec", PODSPEC, "--snapshot", SNAPSHOT, "-o", "json"]
    assert thypercc.run(["explain"] + argv + ["--device", "cpu"]) == 0
    via_hyper = capsys.readouterr().out
    assert texplain.run(argv + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == via_hyper
    assert jexplain.run(argv) == 0
    assert _strip(capsys.readouterr().out) == _strip(via_hyper)


def test_hypercc_refuses_later_subcommands(capsys):
    """No subcommand of the JAX package's hypercc is refused any more:
    serve dispatches like the JAX one (a missing --podspec is argparse's
    exit 2, as there), and the usage text lists the same commands."""
    for hyper in (jhypercc, thypercc):
        with pytest.raises(SystemExit) as ei:
            hyper.run(["serve", "--snapshot", SNAPSHOT])
        assert ei.value.code == 2
        assert "--podspec" in capsys.readouterr().err
    assert jhypercc.run([]) == 1
    jusage = capsys.readouterr().err
    assert thypercc.run([]) == 1
    assert capsys.readouterr().err == jusage
    assert thypercc.run([]) == 1
    assert "usage: hypercc" in capsys.readouterr().err
    assert thypercc.run(["--help"]) == 0


@pytest.mark.parametrize("fmt", [[], ["-o", "json"], ["-o", "yaml"]])
@pytest.mark.parametrize("ns", ["limited", "default", "ghost"])
def test_genpod_byte_equal(capsys, fmt, ns):
    res = []
    for mod in (jgenpod, tgenpod):
        rc = mod.run(["--snapshot", SNAPSHOT, "--namespace", ns] + fmt)
        cap = capsys.readouterr()
        res.append((rc, cap.out, cap.err))
    assert res[0] == res[1]
    if ns == "limited":
        assert res[1][0] == 0 and "cluster-capacity-stub-container" in \
            res[1][1]
        if not fmt:
            assert "region: primary" in res[1][1]


def test_genpod_errors(capsys, monkeypatch):
    monkeypatch.delenv("CC_INCLUSTER", raising=False)
    for argv in (["--snapshot", SNAPSHOT],
                 ["--snapshot", SNAPSHOT, "--namespace", "limited",
                  "-o", "xml"],
                 ["--namespace", "limited"]):
        res = []
        for mod in (jgenpod, tgenpod):
            rc = mod.run(argv)
            cap = capsys.readouterr()
            res.append((rc, cap.out, cap.err))
        assert res[0] == res[1] and res[1][0] == 1, argv

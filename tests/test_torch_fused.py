"""The port's fused step (plain PyTorch version) against the JAX package's
Pallas kernel in interpret mode, on the same packed planes.

One case per tests/test_fused.py family.  The JAX problem goes through the
port's engine via problem_from_arrays, so these compare engines, not
encoders.  Tolerance: exact — `chosen`, every carry plane and the scalars
block are compared with np.array_equal.
"""

import numpy as np
import pytest
import torch

from cluster_capacity_tpu.engine import fused as jfused
from cluster_capacity_tpu.engine import simulator as jsim
from cluster_capacity_tpu_torch.engine import fused as tfused
from cluster_capacity_tpu_torch.engine import simulator as tsim

from test_torch_encode import encode_both, port_problem_from
from test_torch_kernel import FUZZ_SEEDS, fused_families, fuzz_case, nodes, pod

K = 24           # steps per window; two windows per case


def _jax_side(monkeypatch, jpb):
    monkeypatch.setenv("CC_TPU_FUSED", "1")
    cfg = jsim.static_config(jpb)
    assert jfused.eligible(cfg, jpb), "family must be kernel-eligible"
    consts = jsim.build_consts(jpb)
    carry = jsim._init_carry(jpb, consts, 0)
    runner = jfused.FusedRunner(cfg, jpb, consts, interpret=True)
    const = np.asarray(jfused._device_const_packer(runner.pk)(consts))
    return cfg, runner, const, runner.pack(carry)


def _port_side(tpb):
    cfg = tsim.static_config(tpb)
    tfused.check_eligible(cfg, tpb)
    consts = tsim.build_consts(tpb, "cpu")
    pk = tfused._pack_meta(cfg, tpb)
    const = tfused._pack_consts(pk, consts)
    planes, scalars = tfused._pack_carry(pk, tsim._init_carry(tpb, consts))
    return cfg, pk, const, planes, scalars, tfused.kernel_table(pk)


@pytest.mark.parametrize("case", fused_families(), ids=lambda c: c[0])
def test_plain_version_matches_pallas_kernel(monkeypatch, case):
    _name, node_list, the_pod, existing, objs, settings = case
    jpb, tpb_own = encode_both(node_list, the_pod, existing, objs, settings)
    _compare_windows(monkeypatch, jpb, port_problem_from(jpb, tpb_own))


def _compare_windows(monkeypatch, jpb, tpb):
    jcfg, runner, jconst, jstate = _jax_side(monkeypatch, jpb)
    tcfg, pk, tconst, tplanes, tscalars, table = _port_side(tpb)

    # same configuration, same packing: plane order and contents
    assert tcfg._asdict() == {f: getattr(jcfg, f) for f in tcfg._fields}
    assert pk.const_names == runner.pk.const_names
    assert pk.carry_names == runner.pk.carry_names
    assert np.array_equal(tconst.numpy(), jconst)
    assert np.array_equal(tplanes.numpy(), np.asarray(jstate[0]))
    assert np.array_equal(tscalars.numpy(), np.asarray(jstate[1]))

    # two K-step windows from the JAX-packed state: initial, then later
    const = torch.from_numpy(jconst.copy())
    for window in range(2):
        planes = torch.from_numpy(np.array(jstate[0]))
        scalars = torch.from_numpy(np.array(jstate[1]))
        jstate, jchosen, _stopped = runner.run_window(jstate, K, 1)
        out_planes, out_scalars, chosen = tfused.fused_steps(
            const, planes, scalars, table, K)
        assert np.array_equal(chosen.numpy()[:, 0], jchosen), window
        assert np.array_equal(out_planes.numpy(), np.asarray(jstate[0])), \
            window
        assert np.array_equal(out_scalars.numpy(), np.asarray(jstate[1])), \
            window
    assert tfused.LAUNCHES == 0     # CPU tensors never reach the kernel


@pytest.mark.parametrize("seed", FUZZ_SEEDS)
def test_fuzz_solve_matches_jax(monkeypatch, seed):
    """Whole solves of the mixed-family fuzz seeds: the port's drive and
    diagnose (plain version on the CPU) against the JAX package's solve on
    its XLA scan step, which tests/test_fused.py holds equal to the Pallas
    kernel on the same seeds."""
    node_list, the_pod, existing, objs, settings = fuzz_case(seed)
    jpb, tpb = encode_both(node_list, the_pod, existing, objs, settings)
    monkeypatch.setenv("CC_TPU_FUSED", "0")
    jres = jsim.solve(jpb, max_limit=60, chunk_size=64)
    tres = tsim.solve(tpb, max_limit=60, device="cpu")
    assert tres.placements == jres.placements
    assert (tres.fail_type, tres.fail_message, tres.fail_counts) == \
        (jres.fail_type, jres.fail_message, jres.fail_counts)


def _volume_families():
    """Problems only the JAX encoder builds (the port's encoder refuses
    PVCs and inline disks): they reach the port's engine through
    problem_from_arrays and drive the kernel's volume gates."""
    disk = {"name": "d", "gcePersistentDisk": {"pdName": "disk-1"}}
    occupant = pod(name="occupant", cpu="100m", volumes=[disk])
    occupant["metadata"]["namespace"] = "default"
    occupant["spec"]["nodeName"] = "node-0001"
    claim = {"name": "data", "persistentVolumeClaim": {"claimName": "data"}}

    def pvc(modes):
        return {"metadata": {"name": "data", "namespace": "default"},
                "spec": {"accessModes": list(modes), "storageClassName": "",
                         "volumeName": "vol1",
                         "resources": {"requests": {"storage": "1Gi"}}}}

    def pv(hosts=None):
        out = {"metadata": {"name": "vol1", "labels": {}},
               "spec": {"capacity": {"storage": "10Gi"},
                        "accessModes": ["ReadWriteOnce"],
                        "storageClassName": ""}}
        if hosts:
            out["spec"]["nodeAffinity"] = {"required": {"nodeSelectorTerms": [{
                "matchExpressions": [{"key": "kubernetes.io/hostname",
                                      "operator": "In", "values": hosts}]}]}}
        return out

    return [
        ("inline_disk", nodes(6), pod(cpu="100m", volumes=[disk]),
         [occupant], {}),
        ("rwop_claim", nodes(6), pod(cpu="100m", volumes=[claim]), [],
         {"pvcs": [pvc(["ReadWriteOncePod"])], "pvs": [pv()]}),
        ("pv_node_affinity", nodes(8), pod(cpu="700m", volumes=[claim]), [],
         {"pvcs": [pvc(["ReadWriteOnce"])],
          "pvs": [pv(["node-0001", "node-0003", "node-0006"])]}),
    ]


@pytest.mark.parametrize("case", _volume_families(), ids=lambda c: c[0])
def test_volume_gates_match_jax(monkeypatch, case):
    """The kernel's volume mask and self-conflict gates, and diagnose's
    volume reasons, on JAX-encoded problems: the plain version against the
    Pallas kernel, then whole solves."""
    from types import SimpleNamespace
    from cluster_capacity_tpu.engine import encode as jenc
    from cluster_capacity_tpu.models.podspec import default_pod as j_pod
    from cluster_capacity_tpu.models.snapshot import ClusterSnapshot as JSnap
    from cluster_capacity_tpu.utils.config import SchedulerProfile as JProf
    from cluster_capacity_tpu_torch.models.podspec import default_pod as t_pod
    from cluster_capacity_tpu_torch.models.snapshot import \
        ClusterSnapshot as TSnap
    from cluster_capacity_tpu_torch.utils.config import \
        SchedulerProfile as TProf
    _name, node_list, the_pod, existing, objs = case
    jpb = jenc.encode_problem(JSnap.from_objects(node_list, existing, **objs),
                              j_pod(the_pod), JProf())
    holder = SimpleNamespace(
        snapshot=TSnap.from_objects(node_list, existing, **objs),
        pod=t_pod(the_pod), profile=TProf())
    tpb = port_problem_from(jpb, holder)
    cfg = tsim.static_config(tpb)
    assert cfg.volume_filter_on or cfg.volume_self_conflict \
        or cfg.rwop_self_conflict
    _compare_windows(monkeypatch, jpb, tpb)
    monkeypatch.setenv("CC_TPU_FUSED", "0")
    jres = jsim.solve(jpb, max_limit=40, chunk_size=64)
    tres = tsim.solve(tpb, max_limit=40, device="cpu")
    assert tres.placements == jres.placements
    assert (tres.fail_type, tres.fail_message, tres.fail_counts) == \
        (jres.fail_type, jres.fail_message, jres.fail_counts)


def _small_problem():
    case = fused_families()[2]       # hard spread on hostname and zone
    _name, node_list, the_pod, existing, objs, settings = case
    _jpb, tpb = encode_both(node_list, the_pod, existing, objs, settings)
    return tpb


def test_pack_unpack_roundtrip():
    tpb = _small_problem()
    _cfg, pk, const, planes, scalars, table = _port_side(tpb)
    planes, scalars, _chosen = tfused.fused_steps(const, planes, scalars,
                                                  table, 5)
    consts = tsim.build_consts(tpb, "cpu")
    template = tsim._init_carry(tpb, consts)
    carry = tfused._unpack_carry(pk, planes, scalars, template)
    again, again_sc = tfused._pack_carry(pk, carry)
    assert torch.equal(again, planes) and torch.equal(again_sc, scalars)
    assert int(carry.placed_count) == 5 and int(carry.placed.sum()) == 5
    for name in ("requested", "nonzero", "sh_cnt"):
        assert getattr(carry, name).dtype == torch.float32, name


def test_wrapper_refuses_bad_operands():
    tpb = _small_problem()
    _cfg, _pk, const, planes, scalars, table = _port_side(tpb)
    with pytest.raises(TypeError):
        tfused.fused_steps(const.double(), planes, scalars, table, 4)
    with pytest.raises(ValueError):
        tfused.fused_steps(const, planes[:, :, :64].contiguous(), scalars,
                           table, 4)
    with pytest.raises(ValueError):
        tfused.fused_steps(const, planes, scalars.reshape(4, 1), table, 4)
    with pytest.raises(TypeError):
        tfused.fused_steps(const, planes, scalars, tuple(table), 4)
    with pytest.raises(TypeError):
        tfused.fused_steps(const, planes, scalars,
                           tfused.KernelTable(table.i.long(), table.f), 4)
    with pytest.raises(ValueError):
        tfused.fused_steps(const, planes, scalars, table, 0)


def test_log_table_is_correctly_rounded():
    """The spread score's log(size + 2) comes from this table in both the
    kernel and the plain version.  It is held against float64 log rounded
    once to float32; XLA's float32 log on the CPU (the JAX reference in
    these tests) is within one ulp of it everywhere and differs at a few
    sizes (the first is size 5), which can move a spread score only when
    cnt * log lands within an ulp of a .5 rounding boundary."""
    import jax
    import jax.numpy as jnp
    n = 4096
    tab = tfused.log_table(n)
    exact = np.log(np.arange(n + 1, dtype=np.float64) + 2.0).astype(np.float32)
    assert tab.dtype == np.float32 and np.array_equal(tab, exact)
    xla = np.asarray(jax.jit(lambda v: jnp.log(v + 2.0))(
        np.arange(n + 1, dtype=np.float32)))
    ulps = np.abs(xla.view(np.int32).astype(np.int64)
                  - tab.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the CPU-only case")
    from cluster_capacity_tpu_torch import ClusterCapacity
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClusterCapacity({"metadata": {"name": "p"}, "spec": {}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsim.solve(_small_problem())

"""The port's batched fused step (plain PyTorch version) against the JAX
package's batched Pallas kernel in interpret mode, on the same padded group.

Each group is encoded by the JAX package and carried into the port through
problem_from_arrays, so these compare engines, not encoders.  The JAX
kernel runs with x64 off, as on the TPU (its SMEM row index is an int32
lax.rem that x64 mode cannot trace).  Kernel-level
cases hold `chosen`, every carry plane and the scalars block over two
windows; solve-level cases hold whole group solves (placements, stop
reasons, messages, per-reason counts).  Tolerance: exact (np.array_equal,
==).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cluster_capacity_tpu.engine import encode as jenc
from cluster_capacity_tpu.engine import fused_batched as jfb
from cluster_capacity_tpu.engine import simulator as jsim
from cluster_capacity_tpu.models.podspec import default_pod as j_default_pod
from cluster_capacity_tpu.models.snapshot import ClusterSnapshot as JSnap
from cluster_capacity_tpu.parallel import sweep as jsweep
from cluster_capacity_tpu.utils.config import SchedulerProfile as JProfile
from cluster_capacity_tpu_torch.engine import encode as tenc
from cluster_capacity_tpu_torch.engine import fused as tfused
from cluster_capacity_tpu_torch.engine import fused_batched as tfb
from cluster_capacity_tpu_torch.engine import simulator as tsim
from cluster_capacity_tpu_torch.models.podspec import default_pod as t_default_pod
from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot as TSnap
from cluster_capacity_tpu_torch.parallel import sweep as tsweep
from cluster_capacity_tpu_torch.utils.config import SchedulerProfile as TProfile

from test_torch_encode import port_problem_from
from test_torch_kernel import (rack_cluster, sampling_cluster, soft_pair,
                               sweep_cluster, sweep_templates)

K = 16           # steps per window; two windows per kernel-level case
CPU = torch.device("cpu")


def encode_groups(node_list, templates, pct=100):
    """[(JAX problems, port problems)] for every batchable group of >= 2
    templates, grouped by the JAX package's _group_key."""
    jprof = JProfile(percentage_of_nodes_to_score=pct)
    tprof = TProfile()
    tprof.percentage_of_nodes_to_score = pct
    jsnap, tsnap = JSnap.from_objects(node_list), TSnap.from_objects(node_list)
    groups = {}
    for t in templates:
        jpb = jenc.encode_problem(jsnap, j_default_pod(t), jprof)
        if not jsweep._batchable(jpb):
            continue
        tpb = port_problem_from(jpb, tenc.encode_problem(
            tsnap, t_default_pod(t), tprof))
        key = jsweep._group_key(jpb, jsim.static_config(jpb))
        groups.setdefault(key, ([], []))
        groups[key][0].append(jpb)
        groups[key][1].append(tpb)
    return [g for g in groups.values() if len(g[0]) >= 2]


def _jax_runner(monkeypatch, jpbs):
    """(group cfg, BatchedFusedRunner in interpret mode, packed state); call
    under jax.enable_x64(False)."""
    monkeypatch.setenv("CC_TPU_FUSED", "1")
    padded, cfg, dnh = jsweep._pad_group(list(jpbs))
    consts_list = [jsim.build_consts(pb, ss_dnh_min=dnh, device=False)
                   for pb in padded]
    carry = jax.tree.map(lambda *xs: jnp.asarray(np.stack(xs)), *[
        jsim._init_carry(pb, c, pb.profile.seed, device=False)
        for pb, c in zip(padded, consts_list)])
    runner = jfb.BatchedFusedRunner(cfg, padded, consts_list, dnh,
                                    interpret=True)
    return cfg, runner, runner.pack(carry)


def _port_group(tpbs):
    pbs, cfg = tsweep._pad_group(list(tpbs))
    consts_list = tsweep._group_consts(pbs)
    pks, const, tables = tfb.pack_group(cfg, pbs, consts_list)
    planes, scalars = tfb._pack_carry_batched(
        pks, [tsim._init_carry(pb, c) for pb, c in zip(pbs, consts_list)])
    return cfg, pks, const, planes, scalars, tables


def _compare_group(monkeypatch, jpbs, tpbs):
    with jax.enable_x64(False):
        jcfg, runner, jstate = _jax_runner(monkeypatch, jpbs)
    tcfg, pks, const, planes, scalars, tables = _port_group(tpbs)
    b = len(jpbs)

    # same group configuration and packing
    assert tcfg._asdict() == {f: getattr(jcfg, f) for f in tcfg._fields}
    assert all((pk.const_names, pk.carry_names)
               == (runner.pk.const_names, runner.pk.carry_names)
               for pk in pks)
    assert np.array_equal(planes.numpy(), np.asarray(jstate[0]))
    assert np.array_equal(scalars.numpy(), np.asarray(jstate[1])[:b])

    for window in range(2):
        with jax.enable_x64(False):
            jstate, jchosen, _all_stopped = runner.run_packed(jstate, K)
        if window == 0:
            assert np.array_equal(const.numpy(),
                                  np.asarray(runner.const_stack))
        planes, scalars, chosen = tfb.fused_steps_batched(
            const, planes, scalars, tables, K)
        assert chosen.shape == (b, K, 1)
        assert np.array_equal(chosen.numpy()[:, :, 0].T, jchosen), window
        assert np.array_equal(planes.numpy(), np.asarray(jstate[0])), window
        assert np.array_equal(scalars.numpy(), np.asarray(jstate[1])[:b]), \
            window
    assert tfb.LAUNCHES == 0 and tfused.LAUNCHES == 0   # CPU: plain version


KERNEL_CASES = {
    "sweep_templates_48": lambda: encode_groups(sweep_cluster(),
                                                sweep_templates()),
    "sampling_120_nodes_50pct": lambda: encode_groups(
        sampling_cluster(),
        [t for t in sweep_templates()
         if t["metadata"]["name"] in ("plain", "sp1", "soft")], pct=50),
    "soft_domain_counts_differ": lambda: encode_groups(rack_cluster(),
                                                       soft_pair()),
}


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_plain_version_matches_batched_pallas_kernel(monkeypatch, case):
    groups = KERNEL_CASES[case]()
    assert groups, "expected at least one batchable group"
    for jpbs, tpbs in groups:
        if case.startswith("sampling"):
            assert tsweep._pad_group(list(tpbs))[1].sample_k > 0
        _compare_group(monkeypatch, jpbs, tpbs)


def test_shared_templates_are_the_jax_tests_own():
    from test_sweep_batched import _templates
    assert sweep_templates() == _templates()


def _assert_same_results(tres, jres):
    assert len(tres) == len(jres)
    for t, j in zip(tres, jres):
        assert t.placements == j.placements
        assert (t.placed_count, t.fail_type, t.fail_message, t.fail_counts) \
            == (j.placed_count, j.fail_type, j.fail_message, j.fail_counts)


def _segment_templates():
    def tpl(k):
        return {"metadata": {"name": f"t{k}", "labels": {"app": f"t{k}"}},
                "spec": {"containers": [{"name": "c", "resources": {
                    "requests": {"cpu": f"{200 + 100 * (k % 3)}m",
                                 "memory": "1Gi"}}}]}}
    return [tpl(k) for k in range(7)]


SOLVE_CASES = {
    # no max_limit: every template runs to its own Unschedulable stop
    "unlimited_to_unschedulable": (lambda: encode_groups(
        sweep_cluster(24), sweep_templates())[0], 0, None),
    # groups above MAX_BATCH cut into segments of 3, 3 and 1
    "max_batch_3_segments": (lambda: encode_groups(
        sweep_cluster(24), _segment_templates())[0], 10, 3),
    "sweep_templates_limit_40": (lambda: encode_groups(
        sweep_cluster(), sweep_templates())[0], 40, None),
}


@pytest.mark.parametrize("case", sorted(SOLVE_CASES))
def test_group_solve_matches_batched_pallas_kernel(monkeypatch, case):
    make, max_limit, max_batch = SOLVE_CASES[case]
    jpbs, tpbs = make()
    monkeypatch.setenv("CC_TPU_FUSED", "1")
    if max_batch:
        monkeypatch.setattr(jfb, "MAX_BATCH", max_batch)
        monkeypatch.setattr(tfb, "MAX_BATCH", max_batch)
    calls = {"n": 0}
    orig = jfb.BatchedFusedRunner.run_packed

    def counting(self, state, k):
        out = orig(self, state, k)
        calls["n"] += 1                  # counts chunks the kernel finished
        return out

    monkeypatch.setattr(jfb.BatchedFusedRunner, "run_packed", counting)
    jfb._failed_keys.clear()
    with jax.enable_x64(False):
        jres = jsweep._batched_solve(list(jpbs), max_limit=max_limit)
    assert calls["n"] > 0 and not jfb._failed_keys, \
        "the JAX batched kernel never ran a chunk"
    tres = tsweep._batched_solve(list(tpbs), max_limit, CPU)
    _assert_same_results(tres, jres)
    if not max_limit:
        assert any(r.fail_type == "Unschedulable" for r in tres)


def _small_group():
    _jpbs, tpbs = encode_groups(sweep_cluster(24), sweep_templates())[0]
    return tpbs, _port_group(tpbs)


def test_pack_unpack_roundtrip():
    tpbs, (_cfg, pks, const, planes, scalars, tables) = _small_group()
    planes, scalars, chosen = tfb.fused_steps_batched(const, planes, scalars,
                                                      tables, 5)
    pbs, _cfg = tsweep._pad_group(list(tpbs))
    templates = [tsim._init_carry(pb, c)
                 for pb, c in zip(pbs, tsweep._group_consts(pbs))]
    carries = tfb._unpack_carry_batched(pks, planes, scalars, templates)
    again, again_sc = tfb._pack_carry_batched(pks, carries)
    assert torch.equal(again, planes) and torch.equal(again_sc, scalars)
    placed = (chosen[:, :, 0] >= 0).sum(dim=1)
    for b, c in enumerate(carries):
        assert int(c.placed_count) == int(placed[b]) == int(c.placed.sum())
    assert not tfb.stopped_flags(scalars).any()


def test_wrapper_refuses_bad_operands():
    _tpbs, (_cfg, _pks, const, planes, scalars, tables) = _small_group()
    with pytest.raises(TypeError):
        tfb.fused_steps_batched(const.double(), planes, scalars, tables, 4)
    with pytest.raises(ValueError):
        tfb.fused_steps_batched(const[0], planes, scalars, tables, 4)
    with pytest.raises(ValueError):
        tfb.fused_steps_batched(const, planes[1:].contiguous(), scalars,
                                tables, 4)
    with pytest.raises(ValueError):
        tfb.fused_steps_batched(const, planes, scalars[:, :2].contiguous(),
                                tables, 4)
    with pytest.raises(TypeError):
        tfb.fused_steps_batched(const, planes, scalars, tuple(tables), 4)
    with pytest.raises(ValueError):
        tfb.fused_steps_batched(const, planes, scalars, tfused.KernelTable(
            tables.i[:1].contiguous(), tables.f[:1].contiguous()), 4)
    with pytest.raises(TypeError):
        tfb.fused_steps_batched(const, planes, scalars, tfused.KernelTable(
            tables.i.long(), tables.f), 4)
    with pytest.raises(ValueError):
        tfb.fused_steps_batched(const, planes, scalars, tables, 0)

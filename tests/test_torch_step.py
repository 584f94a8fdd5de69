"""The port's scan step (engine/simulator.py run_chunk, plain PyTorch on the
CPU) against the JAX package's XLA scan step (_chunk_runner) on the same
encoded problems, and the float32 step against kernel 1's plain version.

Every case runs K steps from the initial carry of both packages and
compares `chosen` and every carry field, the PRNG key included: on
tests/test_fused.py's families and tests/test_fuzz.py-style generator
seeds, in float32 and float64, deterministic and with the random
tie-break, and on shapes outside kernel 1's envelope (5 hard spread
constraints, a 40-zone soft key, 3 balanced resources, 5 inter-pod
affinity groups, 17 resources, a 20-segment scoring shape).  Then whole
solves of the out-of-envelope shapes against the JAX package's solve.

The JAX problems reach the port through problem_from_arrays, so these
compare engines, not encoders.  Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from cluster_capacity_tpu.engine import simulator as jsim
from cluster_capacity_tpu_torch.engine import fused as tfused
from cluster_capacity_tpu_torch.engine import simulator as tsim

from test_torch_encode import encode_both, port_problem_from
from test_torch_kernel import (FUZZ_SEEDS, HOST, ZONE, fused_families,
                               fuzz_case, nodes, pod, profile_settings,
                               spread)

K = 32

MODES = {
    "float32": (False, True),
    "float32_random": (False, False),
    "parity": (True, True),
    "parity_random": (True, False),
}


def _with_mode(settings, mode, seed=3):
    dtype64, deterministic = MODES[mode]

    def apply(p):
        p = settings(p)
        if dtype64:
            p.compute_dtype = "float64"
        p.deterministic = deterministic
        p.seed = seed
        return p
    return apply


def problems(case, mode):
    """(JAX problem, port problem through problem_from_arrays)."""
    node_list, the_pod, existing, objs, settings = case
    jpb, tpb = encode_both(node_list, the_pod, existing, objs,
                           _with_mode(settings, mode))
    return jpb, port_problem_from(jpb, tpb)


def assert_same_carry(jcarry, tcarry, what):
    for name in tcarry._fields:
        want = np.asarray(getattr(jcarry, name))
        if name == "rng":
            want = want.astype(np.int64)
        got = getattr(tcarry, name).numpy()
        assert got.dtype == want.dtype, (what, name, got.dtype, want.dtype)
        assert np.array_equal(got, want), (what, name)


def assert_same_steps(jpb, tpb, k=K):
    """k steps of both chunk runners from both packages' initial carry."""
    jcfg, tcfg = jsim.static_config(jpb), tsim.static_config(tpb)
    assert tcfg._asdict() == {f: getattr(jcfg, f) for f in tcfg._fields}
    jconsts = jsim.build_consts(jpb)
    jcarry = jsim._init_carry(jpb, jconsts, jpb.profile.seed)
    tconsts = tsim.build_consts(tpb)
    tcarry = tsim._init_carry(tpb, tconsts)
    assert_same_carry(jcarry, tcarry, "initial carry")
    jcarry, jchosen = jsim._chunk_runner()(jcfg, jconsts, jcarry, k)
    tcarry, tchosen = tsim.run_chunk(tcfg, tconsts, tcarry, k)
    assert tchosen.dtype == torch.int32
    assert np.array_equal(tchosen.numpy(), np.asarray(jchosen))
    assert_same_carry(jcarry, tcarry, f"after {k} steps")
    return tchosen


def _family_cases():
    return [(c[0], c[1:]) for c in fused_families()]


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("case", _family_cases(), ids=lambda c: c[0])
def test_step_matches_jax_on_families(case, mode):
    assert_same_steps(*problems(case[1], mode))


@pytest.mark.parametrize("mode", ["parity", "float32_random"])
@pytest.mark.parametrize("seed", FUZZ_SEEDS)
def test_step_matches_jax_on_fuzz_seeds(seed, mode):
    assert_same_steps(*problems(fuzz_case(seed), mode))


# --- shapes outside kernel 1's envelope ------------------------------------

def _labelled(n, zones, **extra):
    out = nodes(n, zones=zones)
    for i, node in enumerate(out):
        for key, mod in extra.items():
            node["metadata"]["labels"][key] = f"{key}{i % mod}"
    return out


def envelope_cases():
    """(id, case) of problems kernel 1 refuses by shape."""
    keys = {"rack": 4, "row": 3, "pdu": 5}
    five_hard = pod(labels={"app": "h5"}, cpu="200m", topologySpreadConstraints=[
        spread(ZONE, 2, "DoNotSchedule", "h5"),
        spread(HOST, 3, "DoNotSchedule", "h5")] + [
        spread(k, 2, "DoNotSchedule", "h5") for k in keys])
    soft40 = pod(labels={"app": "s40"}, cpu="300m", topologySpreadConstraints=[
        spread(ZONE, 1, "ScheduleAnyway", "s40")])

    def balanced3(p):
        p.balanced_resources = [("cpu", 1), ("memory", 1),
                                ("example.com/gpu", 1)]
        return p
    gpu_nodes = nodes(24, zones=3)
    for i, node in enumerate(gpu_nodes):
        node["status"]["allocatable"]["example.com/gpu"] = str(2 + i % 3)
    gpu_pod = pod(cpu="300m", memory="256Mi")
    gpu_pod["spec"]["containers"][0]["resources"]["requests"][
        "example.com/gpu"] = "1"

    group_keys = [ZONE, HOST] + list(keys)
    five_groups = pod(labels={"app": "g5"}, cpu="200m", affinity={
        "podAntiAffinity": {
            "preferredDuringSchedulingIgnoredDuringExecution": [{
                "weight": 10 + i, "podAffinityTerm": {
                    "topologyKey": k,
                    "labelSelector": {"matchLabels": {"app": "g5"}}}}
                for i, k in enumerate(group_keys)]}})

    many_res_nodes = nodes(16, zones=2)
    many_res_pod = pod(cpu="100m")
    for node in many_res_nodes:
        for r in range(13):
            node["status"]["allocatable"][f"example.com/r{r}"] = "8"
    for r in range(13):
        many_res_pod["spec"]["containers"][0]["resources"]["requests"][
            f"example.com/r{r}"] = "1"

    xs = [float(x) for x in range(0, 101, 5)]
    shape = (xs, [float((i * 7) % 11) for i in range(len(xs))])
    return [
        ("five_hard_spread", (_labelled(40, 4, **keys), five_hard, [], {},
                              profile_settings())),
        ("soft_key_40_zones", (nodes(80, zones=40), soft40, [], {},
                               profile_settings())),
        ("balanced_3_resources", (gpu_nodes, gpu_pod, [], {},
                                  lambda p: balanced3(profile_settings()(p)))),
        ("five_ipa_groups", (_labelled(30, 3, **keys), five_groups, [], {},
                             profile_settings())),
        ("seventeen_resources", (many_res_nodes, many_res_pod, [], {},
                                 profile_settings())),
        ("rtc_20_segments", (nodes(20), pod(cpu="400m", memory="512Mi"), [],
                             {}, profile_settings(
                                 strategy="RequestedToCapacityRatio",
                                 shape=shape))),
    ]


@pytest.mark.parametrize("mode", ["float32", "parity_random"])
@pytest.mark.parametrize("case", envelope_cases(), ids=lambda c: c[0])
def test_step_matches_jax_outside_kernel_envelope(case, mode):
    jpb, tpb = problems(case[1], mode)
    assert not tfused.eligible(tsim.static_config(tpb), tpb)
    with pytest.raises(NotImplementedError, match="outside kernel 1"):
        tfused.check_eligible(tsim.static_config(tpb), tpb)
    chosen = assert_same_steps(jpb, tpb)
    assert int((chosen >= 0).sum()) > 0


@pytest.mark.parametrize("case", envelope_cases(), ids=lambda c: c[0])
def test_solve_matches_jax_outside_kernel_envelope(monkeypatch, case):
    """Whole solves in float32 (the JAX package's XLA step; the kernel is
    off on its CPU) against simulator.solve, which routes these to the
    scan step: placements, stop reason, message and counts."""
    monkeypatch.setenv("CC_TPU_FUSED", "0")
    jpb, tpb = problems(case[1], "float32")
    jres = jsim.solve(jpb, max_limit=150)
    launches = tfused.LAUNCHES
    tres = tsim.solve(tpb, max_limit=150, device="cpu")
    assert tfused.LAUNCHES == launches
    assert tres.placements == jres.placements
    assert (tres.fail_type, tres.fail_message, tres.fail_counts) == \
        (jres.fail_type, jres.fail_message, jres.fail_counts)


# --- the float32 step against kernel 1's plain version -----------------------

@pytest.mark.parametrize("case", _family_cases(), ids=lambda c: c[0])
def test_float32_step_matches_kernel_plain_version(case):
    """K steps of the float32 step and of fused_steps_reference (the
    kernel's plain version, which tests/test_torch_kernel.py holds equal to
    the CUDA kernel) from the same initial carry: the same chosen nodes
    and, unpacked from the kernel's planes, the same carry."""
    _jpb, tpb = problems(case[1], "float32")
    cfg = tsim.static_config(tpb)
    assert tfused.eligible(cfg, tpb)
    consts = tsim.build_consts(tpb)
    carry = tsim._init_carry(tpb, consts)
    pk = tfused._pack_meta(cfg, tpb)
    planes, scalars = tfused._pack_carry(pk, carry)
    k_planes, k_scalars, k_chosen = tfused.fused_steps_reference(
        tfused._pack_consts(pk, consts), planes, scalars,
        tfused.kernel_table(pk), K)
    s_carry, s_chosen = tsim.run_chunk(cfg, consts, carry, K)
    assert torch.equal(s_chosen, k_chosen[:, 0])
    unpacked = tfused._unpack_carry(pk, k_planes, k_scalars, carry)
    for name in s_carry._fields:
        assert torch.equal(getattr(s_carry, name), getattr(unpacked, name)), \
            name

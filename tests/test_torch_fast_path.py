"""The port's closed-form fast path against the JAX package's: eligibility,
single-template solve_fast and the batched small-limit solve_fast_batched,
on tests/test_sweep.py's small-limit template mix (plain, hard spread,
preferred anti-affinity, tolerations + preferred zone affinity, image
locality, on a cluster with non-uniform PreferNoSchedule taints) under the
three fit strategies, and in float64 (parity).

The JAX problems reach the port through problem_from_arrays, so these
compare engines, not encoders.  Tolerance: exact (==) on placements, stop
reasons, messages and counts; None (fall back to the kernel) must match
None.
"""

import pytest

from cluster_capacity_tpu.engine import encode as jenc
from cluster_capacity_tpu.engine import fast_path as jfp
from cluster_capacity_tpu.engine import simulator as jsim
from cluster_capacity_tpu.models.podspec import default_pod as j_default_pod
from cluster_capacity_tpu.models.snapshot import ClusterSnapshot as JSnap
from cluster_capacity_tpu.parallel import sweep as jsweep
from cluster_capacity_tpu.utils.config import SchedulerProfile as JProfile
from cluster_capacity_tpu_torch.engine import encode as tenc
from cluster_capacity_tpu_torch.engine import fast_path as tfp
from cluster_capacity_tpu_torch.models.podspec import default_pod as t_default_pod
from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot as TSnap
from cluster_capacity_tpu_torch.utils.config import SchedulerProfile as TProfile

from helpers import build_test_node, build_test_pod
from test_torch_encode import port_problem_from
from test_torch_kernel import profile_settings, small_limit_mix


STRATEGIES = {
    "least_allocated": profile_settings(),
    "most_allocated": profile_settings(strategy="MostAllocated"),
    "rtc_descending": profile_settings(
        strategy="RequestedToCapacityRatio",
        shape=([0.0, 100.0], [10.0, 0.0])),
    "rtc_peak": profile_settings(
        strategy="RequestedToCapacityRatio",
        shape=([0.0, 50.0, 100.0], [0.0, 10.0, 0.0])),
}


def encode_both(node_list, templates, settings):
    """[(JAX problem, port problem)], the port's through problem_from_arrays."""
    jsnap, tsnap = JSnap.from_objects(node_list), TSnap.from_objects(node_list)
    jprof, tprof = settings(JProfile()), settings(TProfile())
    out = []
    for t in templates:
        jpb = jenc.encode_problem(jsnap, j_default_pod(t), jprof)
        out.append((jpb, port_problem_from(jpb, tenc.encode_problem(
            tsnap, t_default_pod(t), tprof))))
    return out


def assert_same(tres, jres, what):
    if jres is None:
        assert tres is None, what
        return
    assert tres is not None, what
    assert tres.placements == jres.placements, what
    assert (tres.placed_count, tres.fail_type, tres.fail_message,
            tres.fail_counts) == (jres.placed_count, jres.fail_type,
                                  jres.fail_message, jres.fail_counts), what


@pytest.mark.parametrize("taints", [True, False],
                         ids=["tainted", "untainted"])
@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_eligibility_and_solve_fast_match_jax(strategy, taints):
    pairs = encode_both(*small_limit_mix(taints), STRATEGIES[strategy])
    answered = 0
    for k, (jpb, tpb) in enumerate(pairs):
        assert tfp.eligible(tpb) == jfp.eligible(jpb), k
        assert tfp.eligible_limited(tpb) == jfp.eligible_limited(jpb), k
        for limit in (0, 3, 7):
            jres = jfp.solve_fast(jpb, max_limit=limit)
            assert_same(tfp.solve_fast(tpb, max_limit=limit, device="cpu"),
                        jres, (k, limit))
            answered += jres is not None
    if not taints and strategy in ("least_allocated", "rtc_descending"):
        # falling per-node scores: the closed form answers
        assert answered > 0, "no template took the fast path"


@pytest.mark.parametrize("limit", [3, 7])
@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_solve_fast_batched_matches_jax(strategy, limit):
    pairs = encode_both(*small_limit_mix(), STRATEGIES[strategy])
    groups = {}
    for jpb, tpb in pairs:
        if jfp.eligible_limited(jpb):
            key = jsweep._group_key(jpb, jsim.static_config(jpb))
            groups.setdefault(key, []).append((jpb, tpb))
    assert groups and max(len(g) for g in groups.values()) >= 2
    for group in groups.values():
        jout = jfp.solve_fast_batched([j for j, _t in group], limit)
        tout = tfp.solve_fast_batched([t for _j, t in group], limit,
                                      device="cpu")
        assert len(tout) == len(jout)
        for k, (t, j) in enumerate(zip(tout, jout)):
            assert_same(t, j, (k, limit))


def test_capacity_exhausts_before_limit_returns_none():
    """Capacity below the limit: the batched solve hands every template
    back (None), and solve_fast diagnoses the exhausted state exactly."""
    nodes = [build_test_node(f"n{i}", 1000, 2 * 1024 ** 3, 2)
             for i in range(2)]
    templates = [build_test_pod(f"t{k}", 400, 256 * 1024 ** 2)
                 for k in range(3)]
    pairs = encode_both(nodes, templates, profile_settings())
    jout = jfp.solve_fast_batched([j for j, _t in pairs], 50)
    tout = tfp.solve_fast_batched([t for _j, t in pairs], 50, device="cpu")
    assert jout == [None] * 3 and tout == [None] * 3
    for jpb, tpb in pairs:
        jres = jfp.solve_fast(jpb, max_limit=50)
        assert jres is not None and jres.fail_type == "Unschedulable"
        assert_same(tfp.solve_fast(tpb, max_limit=50, device="cpu"), jres,
                    "exhausted")


def test_explain_and_float64_raise():
    """explain and float64 (parity) are served and equal the JAX package's
    closed form, single and batched."""
    (jpb, tpb), = encode_both(*[x[:1] for x in small_limit_mix()],
                              profile_settings())
    for limit in (0, 5):
        jres = jfp.solve_fast(jpb, max_limit=limit, explain=True)
        tres = tfp.solve_fast(tpb, max_limit=limit, explain=True,
                              device="cpu")
        assert_same(tres, jres, ("explain", limit))
        assert tres.explain.to_dict() == jres.explain.to_dict()
    pairs = encode_both(*small_limit_mix(taints=False),
                        lambda p: _parity(profile_settings()(p)))
    answered = 0
    for k, (jpb, tpb) in enumerate(pairs):
        assert tpb.profile.compute_dtype == "float64"
        for limit in (0, 5):
            jres = jfp.solve_fast(jpb, max_limit=limit)
            assert_same(tfp.solve_fast(tpb, max_limit=limit, device="cpu"),
                        jres, (k, limit))
            answered += jres is not None
    assert answered > 0, "no float64 template took the fast path"
    group = [(j, t) for j, t in pairs if jfp.eligible_limited(j)]
    jout = jfp.solve_fast_batched([j for j, _t in group], 3)
    tout = tfp.solve_fast_batched([t for _j, t in group], 3, device="cpu")
    assert any(r is not None for r in jout)
    for k, (t, j) in enumerate(zip(tout, jout)):
        assert_same(t, j, ("batched", k))


def _parity(profile):
    profile.compute_dtype = "float64"
    return profile

"""The kernels' launch plan (engine/fused.launch_plan), pure Python: no card
needed.  It is the port's counterpart of the JAX package's vmem_ok: it maps
one template's node axis onto a thread-block cluster and decides which
planes stay in shared memory."""

import pytest

from cluster_capacity_tpu_torch.engine import fused as tfused
from cluster_capacity_tpu_torch.engine.fused import (
    CLUSTER_SIZES, LANES, MAX_CARRY_PLANES, MAX_CONST_PLANES, MAX_NODES,
    N_SM, ONE_CTA_LANES, SCRATCH_PLANES, SMEM_PER_CTA, TARGET_LANES,
    launch_plan)

# (npad, n_const, n_carry, b): the scan cell, the sweep cell's group at
# B = 12 and B = 100, the largest shape, small and odd shapes
SHAPES = [
    (10_112, 10, 8, 1),
    (10_240, 10, 8, 1),
    (10_112, 13, 9, 1),
    (10_112, 10, 8, 12),
    (10_112, 10, 8, 100),
    (10_112, 10, 8, 256),
    (65_536, MAX_CONST_PLANES, MAX_CARRY_PLANES, 1),
    (65_536, MAX_CONST_PLANES, MAX_CARRY_PLANES, 8),
    (65_536, 1, 4, 1),
    (128, 1, 4, 1),
    (384, 5, 6, 3),
    (2_048, 20, 12, 1),
]


def _shape_id(shape):
    return "npad{}_c{}_y{}_b{}".format(*shape)


@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_slices_cover_npad_in_multiples_of_128(shape):
    npad, n_const, n_carry, b = shape
    plan = launch_plan(npad, n_const, n_carry, b)
    assert plan.lanes % LANES == 0
    assert len(plan.slices) == plan.cluster
    start = 0
    for lo, hi in plan.slices:
        assert lo == start and lo % LANES == 0 and hi % LANES == 0
        assert 0 <= hi - lo <= plan.lanes
        start = hi
    assert start == npad


@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_shared_memory_and_cluster_within_the_card(shape):
    npad, n_const, n_carry, b = shape
    plan = launch_plan(npad, n_const, n_carry, b)
    assert plan.smem_bytes <= SMEM_PER_CTA
    assert plan.smem_bytes + tfused.SMEM_STATIC <= SMEM_PER_CTA
    assert plan.smem_bytes == 4 * plan.lanes * plan.resident
    assert plan.cluster in CLUSTER_SIZES and plan.cluster <= 16
    if b > 1:
        assert b * plan.cluster <= N_SM or plan.cluster == 1
    assert 32 <= plan.threads <= 1024 and plan.threads % 32 == 0


@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_resident_planes_in_order_scratch_carry_const(shape):
    npad, n_const, n_carry, b = shape
    plan = launch_plan(npad, n_const, n_carry, b)
    assert plan.resident <= SCRATCH_PLANES + n_carry + n_const
    if plan.resident_carry:
        assert plan.resident_scratch == SCRATCH_PLANES
    if plan.resident_const:
        assert plan.resident_carry == n_carry
    assert 0 <= plan.resident_const <= n_const


def test_scan_shape_fully_resident_at_the_smallest_cluster():
    """The scan cell: 10 const + 8 carry + 4 scratch planes at 10,240
    lanes all live in shared memory.  Four CTAs are the smallest cluster
    that holds them, but each would walk 2,560 lanes on 1,024 threads; no
    cluster brings a CTA down to TARGET_LANES, so the plan takes the
    largest: 16 CTAs of 640 lanes."""
    plan = launch_plan(10_240, 10, 8)
    assert (plan.resident_scratch, plan.resident_carry,
            plan.resident_const) == (SCRATCH_PLANES, 8, 10)
    for c in CLUSTER_SIZES:
        at_c = launch_plan(10_240, 10, 8, cluster=c)
        assert at_c.resident == 22 or c < 4
        assert at_c.lanes > TARGET_LANES
    assert plan.cluster == 16 and plan.lanes == 640 and plan.threads == 640


# the cluster slots an H100 reported for the kernels' full blocks
H100_SLOTS = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}


def _smallest_resident(npad, n_const, n_carry, b, slots):
    """The cluster size of the rule that weighed residency alone: the
    smallest schedulable C that holds every plane, else the largest."""
    sizes = [c for c in CLUSTER_SIZES if slots.get(c, 0) >= 1
             and (b == 1 or (b * c <= N_SM and b <= slots[c]))] or [1]
    rows = npad // LANES
    total = SCRATCH_PLANES + n_const + n_carry
    fits = [c for c in sizes if total * 4 * -(-rows // c) * LANES
            <= tfused.SMEM_DYNAMIC]
    return fits[0] if fits else sizes[-1]


@pytest.mark.parametrize("n_const", [10, 9])
def test_portbench_cells_take_the_cluster_by_lanes(n_const):
    """k8s-5000n.spread (10 const planes, a hard zone spread) and
    k8s-5000n-prefanti.prefanti (9, InterPodAffinity's preferred planes):
    5,000 nodes, 5,120 lanes, 8 carry planes.  Every plane fits at two
    CTAs of 2,560 lanes; the plan takes the smallest C of at most
    TARGET_LANES lanes a CTA: 16 CTAs of 384."""
    plan = launch_plan(5_120, n_const, 8, slots=H100_SLOTS)
    assert _smallest_resident(5_120, n_const, 8, 1, H100_SLOTS) == 2
    assert (plan.cluster, plan.lanes, plan.threads) == (16, 384, 384)
    assert launch_plan(5_120, n_const, 8, cluster=8).lanes > TARGET_LANES
    assert plan.resident == SCRATCH_PLANES + n_const + 8


@pytest.mark.parametrize("npad", range(LANES, ONE_CTA_LANES + 1, LANES))
@pytest.mark.parametrize("slots", [None, H100_SLOTS])
def test_small_problem_stays_on_one_cta(npad, slots):
    """Up to ONE_CTA_LANES lanes, where one CTA holds every plane, it does
    the work: a cluster's barriers would cost more than the node work they
    split.  A CTA that cannot hold them gives way to a cluster."""
    assert launch_plan(npad, 10, 8, slots=slots).cluster == 1
    assert launch_plan(npad, 9, 8, slots=slots).cluster == 1
    big = launch_plan(npad, MAX_CONST_PLANES, MAX_CARRY_PLANES, slots=slots)
    assert big.cluster == 1 or launch_plan(
        npad, MAX_CONST_PLANES, MAX_CARRY_PLANES, cluster=1).resident \
        < SCRATCH_PLANES + MAX_CONST_PLANES + MAX_CARRY_PLANES


@pytest.mark.parametrize("npad, cluster, lanes", [
    (ONE_CTA_LANES + LANES, 8, 256), (2_560, 8, 384), (5_120, 16, 384)])
def test_past_one_cta_the_plan_splits_to_target_lanes(npad, cluster, lanes):
    plan = launch_plan(npad, 10, 8, slots=H100_SLOTS)
    assert (plan.cluster, plan.lanes) == (cluster, lanes)
    assert lanes <= TARGET_LANES < launch_plan(npad, 10, 8,
                                               cluster=cluster // 2).lanes


@pytest.mark.parametrize("npad, slots, cluster", [
    (20_096, H100_SLOTS, 16),
    (10_240, {1: 132, 2: 66, 4: 30, 8: 15, 16: 0}, 8),
    (5_120, {1: 132, 2: 66, 4: 30, 8: 0, 16: 0}, 4)])
def test_no_cluster_small_enough_takes_the_largest(npad, slots, cluster):
    """Where no schedulable C brings a CTA down to TARGET_LANES lanes, the
    plan takes the largest, every plane still resident."""
    plan = launch_plan(npad, 10, 8, slots=slots)
    assert plan.cluster == cluster and plan.lanes > TARGET_LANES
    assert plan.resident == SCRATCH_PLANES + 10 + 8


@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
@pytest.mark.parametrize("slots", [None, H100_SLOTS])
def test_groups_and_partial_residency_keep_the_smallest_resident_rule(
        shape, slots):
    """A group of b > 1 templates, and a problem whose planes no C holds,
    take the cluster size they took before lanes per CTA were weighed;
    a forced C gives the same plan whatever the rule."""
    npad, n_const, n_carry, b = shape
    plan = launch_plan(npad, n_const, n_carry, b, slots=slots)
    old = _smallest_resident(npad, n_const, n_carry, b,
                             slots or {c: N_SM // c for c in CLUSTER_SIZES})
    if b > 1 or plan.resident < SCRATCH_PLANES + n_const + n_carry:
        assert plan.cluster == old
    assert launch_plan(npad, n_const, n_carry, b, cluster=plan.cluster,
                       slots=slots) == plan


def test_largest_shape_is_partly_resident_not_refused():
    """65,536 nodes with every plane the table can index: no cluster holds
    them all, so the plan takes the largest cluster and leaves the rest in
    device memory."""
    plan = launch_plan(65_536, MAX_CONST_PLANES, MAX_CARRY_PLANES)
    assert plan.cluster == 16
    assert 0 < plan.resident < SCRATCH_PLANES + MAX_CONST_PLANES \
        + MAX_CARRY_PLANES
    assert plan.resident_scratch == SCRATCH_PLANES


def test_partial_residency_takes_the_largest_schedulable_cluster():
    slots = {1: 132, 2: 66, 4: 32, 8: 16, 16: 0}
    plan = launch_plan(65_536, MAX_CONST_PLANES, MAX_CARRY_PLANES,
                       slots=slots)
    assert plan.cluster == 8


@pytest.mark.parametrize("b, cluster", [(1, 16), (30, 4), (31, 2), (64, 2),
                                        (65, 1)])
def test_group_fits_the_cards_cluster_slots(b, cluster):
    """Where the card holds fewer clusters of C at once than N_SM // C, a
    group takes the smallest size of which it holds all b templates; one
    template takes 16 CTAs of 640 lanes."""
    slots = {1: 132, 2: 64, 4: 30, 8: 14, 16: 7}
    assert launch_plan(10_112, 10, 8, b, slots=slots).cluster == cluster


@pytest.mark.parametrize("b, cluster", [(1, 16), (12, 4), (16, 4), (33, 4),
                                        (34, 2), (66, 2), (67, 1), (100, 1),
                                        (256, 1)])
def test_group_keeps_one_wave(b, cluster):
    """A group of B templates on clusters of C runs in one wave of the
    card's 132 SMs: B * C <= 132.  At the sweep cell's B = 100, C = 1.  One
    template alone is no group: 16 CTAs of 640 lanes."""
    plan = launch_plan(10_112, 10, 8, b)
    assert plan.cluster == cluster


def test_forced_cluster():
    plan = launch_plan(10_240, 10, 8, cluster=16)
    assert plan.cluster == 16 and plan.lanes == 640 and plan.threads == 640
    assert len(plan.slices) == 16
    with pytest.raises(ValueError):
        launch_plan(10_240, 10, 8, cluster=3)


def test_more_ctas_than_lane_rows_leaves_empty_slices():
    plan = launch_plan(128, 5, 6, cluster=8)
    assert plan.slices[0] == (0, 128)
    assert all(lo == hi == 128 for lo, hi in plan.slices[1:])


def test_shape_beyond_max_nodes_raises_by_name():
    with pytest.raises(NotImplementedError, match="MAX_NODES"):
        launch_plan(MAX_NODES + LANES, 10, 8)


@pytest.mark.parametrize("n_const, n_carry, name", [
    (MAX_CONST_PLANES + 1, 8, "MAX_CONST_PLANES"),
    (10, MAX_CARRY_PLANES + 1, "MAX_CARRY_PLANES"),
])
def test_too_many_planes_raise_by_name(n_const, n_carry, name):
    with pytest.raises(NotImplementedError, match=name):
        launch_plan(10_240, n_const, n_carry)


def test_bad_lane_count_raises():
    with pytest.raises(ValueError):
        launch_plan(100, 10, 8)
    with pytest.raises(ValueError):
        launch_plan(0, 10, 8)

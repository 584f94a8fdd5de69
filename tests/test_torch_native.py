"""The port's native snapshot compiler (models/native.py, its own build of
native/ccsnap.cpp) against the port's pure-Python aggregation and the JAX
package's, on tests/test_native.py's seeded random objects, excludes and
quantity forms; and from_objects' use_native semantics (True takes the
native build and raises when it cannot build, None and False take Python;
node_order, sort_nodes=False and ResourceSlices refuse True with the JAX
package's ValueErrors).  The build tests skip only when no C++ compiler is on PATH.
Tolerance: exact.
"""

import os
import shutil

import numpy as np
import pytest

from cluster_capacity_tpu.models.snapshot import ClusterSnapshot as JSnap
from cluster_capacity_tpu_torch.models import native
from cluster_capacity_tpu_torch.models.snapshot import ClusterSnapshot as TSnap

import test_native as jt


@pytest.fixture
def built():
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no C++ compiler on PATH to build native/ccsnap.cpp")
    assert native.available(), native.build_error()


def assert_same(a, b):
    assert a.node_names == b.node_names
    assert a.resource_names == b.resource_names
    for arr in ("allocatable", "requested", "nonzero_requested"):
        assert np.array_equal(getattr(a, arr), getattr(b, arr)), arr


def three_ways(nodes, pods, **kw):
    nat = TSnap.from_objects(nodes, pods, use_native=True, **kw)
    py = TSnap.from_objects(nodes, pods, use_native=False, **kw)
    jpy = JSnap.from_objects(nodes, pods, use_native=False, **kw)
    assert_same(nat, py)
    assert_same(nat, jpy)
    return nat


@pytest.mark.parametrize("seed", range(5))
def test_native_matches_python_and_jax(seed, built):
    three_ways(*jt._random_objects(seed))


def test_native_exclude_nodes(built):
    nodes, pods = jt._random_objects(99, n_nodes=10)
    nat = three_ways(nodes, pods, exclude_nodes=["n003", "n007"])
    assert "n003" not in nat.node_names


def test_native_quantity_forms(built):
    node = {"metadata": {"name": "n1"}, "spec": {},
            "status": {"allocatable": {
                "cpu": "1500m", "memory": "1.5Gi", "pods": "1e2",
                "ephemeral-storage": "100G", "nvidia.com/gpu": "2"}}}
    pod = {"metadata": {"name": "p", "namespace": "default"},
           "spec": {"nodeName": "n1", "containers": [{
               "name": "c", "resources": {"requests": {
                   "cpu": "0.3", "memory": "100M",
                   "nvidia.com/gpu": "1"}}}]}}
    three_ways([node], [pod])


def test_default_takes_python(built, monkeypatch):
    """use_native=None aggregates in Python even when the build is there
    (the native path is slower at 10,000 nodes and stays opt-in)."""
    nodes, pods = jt._random_objects(3)
    calls = []
    real = native.compile_snapshot
    monkeypatch.setattr(native, "compile_snapshot",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    assert_same(TSnap.from_objects(nodes, pods),
                TSnap.from_objects(nodes, pods, use_native=False))
    assert calls == []
    TSnap.from_objects(nodes, pods, use_native=True)
    assert calls == [1]


def test_build_lands_in_the_checkout_build_dir(built):
    lib = native.build()
    assert os.path.dirname(lib) == native.build_dir()
    assert native.build_dir().endswith(os.path.join("build", "native"))
    # never the JAX package's library
    assert "cluster_capacity_tpu" + os.sep + "models" not in lib


def test_without_a_compiler(monkeypatch):
    """No compiler: None takes Python, True raises."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setenv("CXX", "no-such-compiler-cc")
    monkeypatch.setattr(native, "build_dir",
                        lambda: os.path.join(os.sep, "nonexistent-dir"))
    nodes, pods = jt._random_objects(1)
    assert_same(TSnap.from_objects(nodes, pods),
                JSnap.from_objects(nodes, pods, use_native=False))
    assert native.build_error() is None   # None never tries the build
    with pytest.raises(RuntimeError, match="not available"):
        TSnap.from_objects(nodes, pods, use_native=True)
    assert "no C++ compiler" in native.build_error()


def test_option_conflicts_match_jax():
    nodes, pods = jt._random_objects(2, n_nodes=6)
    slices = [{"metadata": {"name": "s"}, "spec": {
        "nodeName": "n000", "driver": "gpu.example.com",
        "devices": [{"name": "d", "deviceClassName": "gpu.example.com"}]}}]
    for kw in ({"node_order": "zone-round-robin", "use_native": True},
               {"sort_nodes": False, "use_native": True},
               {"resource_slices": slices, "use_native": True}):
        with pytest.raises(ValueError) as je:
            JSnap.from_objects(nodes, pods, **kw)
        with pytest.raises(ValueError) as te:
            TSnap.from_objects(nodes, pods, **kw)
        assert str(te.value) == str(je.value)
    for kw in ({"node_order": "zone-round-robin"},
               {"resource_slices": slices}):
        assert_same(TSnap.from_objects(nodes, pods, **kw),
                    JSnap.from_objects(nodes, pods, **kw))

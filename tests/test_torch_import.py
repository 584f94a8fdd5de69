"""The PyTorch port stands alone: importing it pulls in no jax, and no module
of it (nor chip_smoke.py) imports the JAX package."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "cluster_capacity_tpu_torch")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _port_modules():
    mods = []
    for path in _port_sources()[1:]:
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        if rel.endswith(".__main__"):
            continue
        mods.append(rel[:-len(".__init__")] if rel.endswith(".__init__")
                    else rel)
    return mods


def test_import_pulls_in_no_jax():
    """In a fresh interpreter (this test process has jax loaded through
    tests/conftest.py): import every port module and chip_smoke, then
    check sys.modules."""
    code = ("import sys, importlib\n"
            f"for m in {_port_modules()!r} + ['chip_smoke']:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'cluster_capacity_tpu' or "
            "m.startswith('cluster_capacity_tpu.'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_module_imports_the_jax_package(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "cluster_capacity_tpu"), \
                f"{os.path.relpath(path, REPO)}:{node.lineno} imports {name}"


def test_runtime_and_preemption_modules_are_checked():
    """The fault ladder, preemption, oracle and volume modules are among the
    modules the two tests above import and scan."""
    mods = set(_port_modules())
    for m in ("runtime.errors", "runtime.faults", "runtime.guard",
              "runtime.degrade", "utils.events", "ops.volumes",
              "engine.oracle", "engine.preemption", "framework"):
        assert f"cluster_capacity_tpu_torch.{m}" in mods, m


def test_step_prng_and_bounds_modules_are_checked():
    """The scan step's PRNG and the capacity bracket are among the modules
    the two tests above import and scan."""
    mods = set(_port_modules())
    for m in ("utils.prng", "bounds", "bounds.bracket", "engine.simulator"):
        assert f"cluster_capacity_tpu_torch.{m}" in mods, m


def test_dra_native_and_explain_modules_are_checked():
    """DRA (CEL, the linear-time regex, the structured allocator), the
    native snapshot compiler's bridge, explain/ and the explain CLI are
    among the modules the two tests above import and scan."""
    mods = set(_port_modules())
    for m in ("ops.relinear", "ops.cel", "ops.dynamic_resources",
              "models.native", "explain", "explain.artifacts",
              "explain.attribution", "explain.bottleneck", "cli.explain"):
        assert f"cluster_capacity_tpu_torch.{m}" in mods, m


def test_native_bridge_never_loads_the_jax_packages_library():
    """models/native.py builds and loads its own libccsnap from
    native/ccsnap.cpp into build/native/, never
    cluster_capacity_tpu/models/libccsnap.so."""
    with open(os.path.join(PKG, "models", "native.py")) as f:
        src = f.read()
    assert "cluster_capacity_tpu/" not in src
    assert '"native", "ccsnap.cpp"' in src
    assert '"build", "native"' in src


def test_frontend_and_extender_modules_are_checked():
    """The extenders, checkpoints, golden scenarios, version info and the
    hypercc/genpod front ends are among the modules the two tests above
    import and scan; hypercc reaches no module the port lacks."""
    mods = set(_port_modules())
    for m in ("engine.extenders", "utils.checkpoint", "utils.golden",
              "utils.version", "cli.hypercc", "cli.genpod",
              "cli.cluster_capacity"):
        assert f"cluster_capacity_tpu_torch.{m}" in mods, m
    with open(os.path.join(PKG, "__main__.py")) as f:
        assert "from .cli.hypercc import main" in f.read()


def test_telemetry_and_resilience_modules_are_checked():
    """obs/, the metrics and trace utilities, the resilience sweeps and
    the profile and resilience CLIs are among the modules the two tests
    above import and scan."""
    mods = set(_port_modules())
    for m in ("obs", "obs.names", "obs.spans", "obs.export", "obs.recompile",
              "obs.profile", "obs.costmodel", "obs.flight", "obs.entries",
              "utils.metrics", "utils.trace", "resilience",
              "resilience.scenarios", "resilience.analyzer", "cli.profile",
              "cli.resilience"):
        assert f"cluster_capacity_tpu_torch.{m}" in mods, m


def test_interleave_and_serve_modules_are_checked():
    """The interleave engine, the capacity daemon (breakers, the snapshot
    store, the supervisor, the soak) and the serve CLI are among the
    modules the two tests above import and scan."""
    mods = set(_port_modules())
    for m in ("parallel.interleave", "parallel.sweep", "serve",
              "serve.breaker", "serve.ingest", "serve.supervisor",
              "serve.soak", "cli.serve"):
        assert f"cluster_capacity_tpu_torch.{m}" in mods, m


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_module_imports_tools(path):
    """tools/irgate imports the JAX package, so the port imports nothing
    of tools/: the cost model reads tools/irgate/budgets.json as data."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] != "tools", \
                f"{os.path.relpath(path, REPO)}:{node.lineno} imports {name}"


def test_mesh_modules_are_checked():
    """The device mesh and the multi-process pieces are among the modules
    the two tests above import and scan, and importing them starts no
    process group."""
    mods = set(_port_modules())
    for m in ("parallel.mesh", "parallel.distributed"):
        assert f"cluster_capacity_tpu_torch.{m}" in mods, m
    code = ("import torch.distributed as d\n"
            "import cluster_capacity_tpu_torch.parallel.mesh\n"
            "import cluster_capacity_tpu_torch.parallel.distributed\n"
            "assert not d.is_initialized()\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr

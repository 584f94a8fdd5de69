"""Deterministic fault injection for chaos tests and `--inject-fault`.

A FaultSpec names an injection *site* (a dispatch boundary the guard passes
through), a fault *kind*, and when it fires: the `at`-th call to that site,
for `times` consecutive calls (times=0 ⇒ every call from `at` on).  Specs are
installed programmatically (`install`, or the `inject()` context manager used
by tests) or parsed from text — the CLI `--inject-fault` flag and the
``CC_INJECT_FAULT`` env var share the same ``site:kind[:at[:times]]`` syntax,
so a chaos run is reproducible from a single string.

Kinds:

- ``oom``      raise SimulatedDeviceError carrying the wording of PyTorch's
               CUDA out-of-memory error, so the *real* classifier path in
               guard.py is what turns it into DeviceOOM.
- ``hang``     raise SimulatedHang; the guard converts it to Compile/
               ExecuteTimeout without actually sleeping, keeping chaos tests
               deterministic and fast.
- ``corrupt``  leave the call alone and poison its *output* plane (NaN fail
               counts, negative placements) via maybe_corrupt, so validation
               — not the exception path — must catch it.
- ``error``    raise SimulatedDeviceError with a CUDA error the classifier
               does NOT recognize; the guard must propagate it raw
               (degrading would hide an engine bug), so chaos tests can
               prove unclassified errors crash.

The healthy path stays free: `fire()` is a dict-lookup early return when
nothing is installed and the env var is unset.

The JAX package's `fire` also counts each injected fault in its metrics
registry; that counter arrives with the port's obs/ slice (ROADMAP queue 1,
item 16).  The site names and the spec syntax are the JAX package's, so one
spec string drives both packages.
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional

ENV_VAR = "CC_INJECT_FAULT"

KIND_OOM = "oom"
KIND_HANG = "hang"
KIND_CORRUPT = "corrupt"
KIND_ERROR = "error"
_KINDS = (KIND_OOM, KIND_HANG, KIND_CORRUPT, KIND_ERROR)

# Injection sites: the dispatch boundaries guard.run() passes through.
SITE_SOLVE = "engine.solve"
SITE_FAST_PATH = "engine.fast_path"
SITE_ORACLE = "engine.oracle"
SITE_GROUP = "parallel.solve_group"
SITE_EXTENDERS = "engine.extenders"
SITE_INTERLEAVE = "parallel.interleave"
SITE_BOUNDS = "bounds.bracket"
SITE_SHARDED = "parallel.sharded"
SITE_INTERLEAVE_SHARDED = "parallel.interleave_sharded"
SITES = (SITE_SOLVE, SITE_FAST_PATH, SITE_ORACLE, SITE_GROUP,
         SITE_EXTENDERS, SITE_INTERLEAVE, SITE_BOUNDS, SITE_SHARDED,
         SITE_INTERLEAVE_SHARDED)


class SimulatedHang(Exception):
    """Stand-in for a wedged compile/execute; the guard converts this to a
    timeout fault instead of burning a real deadline."""


class SimulatedDeviceError(Exception):
    """Stand-in for a device error raised by PyTorch or a kernel wrapper.
    Carries a realistic CUDA message so guard.classify_device_error
    exercises its production string-matching path."""


@dataclass
class FaultSpec:
    site: str
    kind: str
    at: int = 1        # 1-based call index at which the fault starts firing
    times: int = 1     # consecutive calls affected; 0 = every call from `at`

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(
                f"unknown fault site {self.site!r}; expected one of "
                f"{', '.join(SITES)}")
        if self.kind not in _KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of "
                f"{', '.join(_KINDS)}")
        if self.at < 1:
            raise ValueError("fault `at` is a 1-based call index")
        if self.times < 0:
            raise ValueError("fault `times` must be >= 0 (0 = forever)")

    def active(self, call_index: int) -> bool:
        if call_index < self.at:
            return False
        return self.times == 0 or call_index < self.at + self.times


def parse_spec(text: str) -> FaultSpec:
    """Parse ``site:kind[:at[:times]]`` (e.g. ``parallel.solve_group:oom`` or
    ``engine.solve:hang:2:3``)."""
    parts = text.strip().split(":")
    if len(parts) < 2 or len(parts) > 4:
        raise ValueError(
            f"bad fault spec {text!r}; expected site:kind[:at[:times]]")
    site, kind = parts[0], parts[1].lower()
    try:
        at = int(parts[2]) if len(parts) > 2 else 1
        times = int(parts[3]) if len(parts) > 3 else 1
    except ValueError:
        raise ValueError(
            f"bad fault spec {text!r}: at/times must be integers") from None
    return FaultSpec(site=site, kind=kind, at=at, times=times)


@dataclass
class _State:
    specs: Dict[str, List[FaultSpec]] = field(default_factory=dict)
    calls: Dict[str, int] = field(default_factory=dict)
    env_loaded: bool = False


_state = _State()  # cc-guarded-by: _lock
_lock = threading.Lock()


def install(specs: Iterable[FaultSpec]) -> None:
    """Install fault specs (additive)."""
    with _lock:
        for spec in specs:
            _state.specs.setdefault(spec.site, []).append(spec)


def install_text(texts: Iterable[str]) -> List[FaultSpec]:
    """Parse and install a list of ``site:kind[:at[:times]]`` strings."""
    specs = [parse_spec(t) for t in texts]
    install(specs)
    return specs


def clear() -> None:
    """Remove all installed specs and reset per-site call counters."""
    with _lock:
        _state.specs.clear()
        _state.calls.clear()
        _state.env_loaded = False


@contextmanager
def suspended():
    """Disable ALL fault injection — installed specs and the env var — for
    the duration of the block, restoring specs and call counters after.

    A post-mortem that re-drives a failing entry (the JAX package's flight
    recorder, obs/flight.py) needs it: otherwise the very fault being
    triaged would re-fire inside the post-mortem and recurse."""
    with _lock:
        saved_specs = _state.specs
        saved_calls = _state.calls
        saved_env = _state.env_loaded
        _state.specs = {}
        _state.calls = {}
        _state.env_loaded = True  # blocks _load_env_locked re-reading ENV_VAR
    try:
        yield
    finally:
        with _lock:
            _state.specs = saved_specs
            _state.calls = saved_calls
            _state.env_loaded = saved_env


def _load_env_locked() -> None:  # cc-holds: _lock
    if _state.env_loaded:
        return
    _state.env_loaded = True
    raw = os.environ.get(ENV_VAR, "").strip()
    if not raw:
        return
    for part in raw.split(","):
        part = part.strip()
        if part:
            spec = parse_spec(part)
            _state.specs.setdefault(spec.site, []).append(spec)


def active_fault(site: str) -> Optional[FaultSpec]:
    """Count a call at `site`; return the spec that should fire, if any."""
    with _lock:
        _load_env_locked()
        if not _state.specs:
            return None
        index = _state.calls.get(site, 0) + 1
        _state.calls[site] = index
        for spec in _state.specs.get(site, ()):
            if spec.active(index):
                return spec
    return None


def fire(site: str) -> Optional[FaultSpec]:
    """Called by the guard at each dispatch boundary.  Raises for exception
    kinds; returns the spec for ``corrupt`` so the caller can poison the
    output plane; returns None when healthy."""
    spec = active_fault(site)
    if spec is None:
        return None
    if spec.kind == KIND_OOM:
        raise SimulatedDeviceError(
            f"CUDA out of memory. Tried to allocate memory on the device "
            f"(injected at {site})")
    if spec.kind == KIND_HANG:
        raise SimulatedHang(f"injected hang at {site}")
    if spec.kind == KIND_ERROR:
        raise SimulatedDeviceError(
            f"CUDA error: unspecified launch failure (injected unclassified "
            f"device error at {site})")
    return spec  # corrupt: handled at the output boundary


def maybe_corrupt(spec: Optional[FaultSpec], result):
    """Poison a SolveResult's output planes when a ``corrupt`` spec fired:
    placements get a negative index, fail_counts an unrepresentable NaN.
    Batched results (lists) corrupt their first present item.  Returns the
    (possibly replaced) result."""
    if spec is None or spec.kind != KIND_CORRUPT or result is None:
        return result
    import dataclasses

    if isinstance(result, (list, tuple)):
        out = list(result)
        for i, item in enumerate(out):
            if item is not None:
                out[i] = maybe_corrupt(spec, item)
                break
        return type(result)(out) if isinstance(result, tuple) else out
    if not hasattr(result, "placements"):
        return result
    placements = list(result.placements)
    if placements:
        placements[0] = -7
    fail_counts = dict(result.fail_counts)
    fail_counts["__corrupt__"] = float("nan")
    return dataclasses.replace(
        result, placements=placements, fail_counts=fail_counts)


@contextmanager
def inject(*specs_or_texts):
    """Test helper: install specs for the duration of a with-block, then
    fully reset the harness (specs AND call counters)."""
    clear()
    parsed = []
    for s in specs_or_texts:
        parsed.append(parse_spec(s) if isinstance(s, str) else s)
    install(parsed)
    try:
        yield parsed
    finally:
        clear()

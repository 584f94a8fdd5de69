"""The supervised serving core: a crash-tolerant capacity daemon loop.

``Supervisor`` promotes the one-shot hardened solve into a long-lived
request loop with four properties the CLI never needed:

- **Containment.**  Every solve runs under ``guard.run`` with the
  configured per-request deadline; a request that exhausts the whole ladder
  produces an *error answer*, never a dead process.  An unclassified
  exception (an engine bug, not a device fault) additionally restarts the
  worker state: the snapshot's encode memo is dropped and the next request
  re-encodes.  The port keeps no per-problem state on the card between
  solves (every rung builds its tensors from the problem's host arrays,
  runtime/degrade.solve_one_guarded), so nothing else is poisoned; the
  built kernels (engine/fused.py), their launch plans and the captured step
  graphs (simulator._graphs) stay, and the re-encoded problems land on them
  — a cache hit, not a recompile (obs/recompile counts both).
- **Fault-class retry.**  Before descending a rung, the supervisor retries
  the SAME rung a bounded, fault-class-keyed number of times with
  exponential backoff: an ``ExecuteTimeout`` is usually transient and worth
  re-attempting; a ``NumericCorruption`` is deterministic poison and is
  NEVER retried (see ``ServeConfig.retry_policy``).
- **Circuit breakers.**  Each rung's guard site carries a breaker
  (serve/breaker.py).  Repeated faults open it, and subsequent requests
  enter the ladder below the broken rung for the cooldown — straight to a
  healthy rung instead of re-paying the fault.  Bit-identity makes the
  pinned answer the same numbers, just served on a slower rung.
- **Coalescing.**  A drain batches every pending request: same-signature
  templates share one solve (``parallel/sweep``'s content-hash dedup), and
  distinct-but-batchable templates ride one ``solve_group`` device solve
  (kernel 2); single templates take the per-item ladder (kernel 1 or the
  closed form on the fused rung).

The strict contract mirrors ``--watch``: with ``strict`` set, the first
degraded (or error) answer AFTER the ``strict_after`` warmup grace marks
the supervisor tripped, and the CLI exits 3.  With a device mesh
(parallel/mesh.py) the group ladder starts on the sharded rung, which has
its breaker and its canary probe like every other rung.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Sequence

from ..obs import names as obs_names
from ..runtime import degrade, guard
from ..runtime.degrade import (RUNG_BATCHED, RUNG_FAST_PATH, RUNG_FUSED,
                               RUNG_ORACLE, RUNG_SHARDED)
from ..runtime.errors import RuntimeFault
from ..runtime.faults import (SITE_FAST_PATH, SITE_GROUP, SITE_ORACLE,
                              SITE_SHARDED, SITE_SOLVE)
from ..utils.events import default_recorder
from ..utils.metrics import default_registry
from .breaker import STATE_CLOSED, BreakerBoard, BreakerConfig
from .ingest import SnapshotStore

EVENT_RESTART = "WorkerRestart"

# Same-rung retry budget per fault class.  ExecuteTimeout is the transient
# one (a wedged dispatch that may succeed on re-issue); CompileTimeout and
# DeviceOOM get one more try (build caches / allocator pressure can
# clear); NumericCorruption is deterministic — retrying replays the poison.
DEFAULT_RETRY_POLICY: Mapping[str, int] = {
    "ExecuteTimeout": 2,
    "CompileTimeout": 1,
    "DeviceOOM": 1,
    "NumericCorruption": 0,
}

# The per-item serving ladder (group rungs are entered from drain()).
_ONE_LADDER = (RUNG_FUSED, RUNG_FAST_PATH, RUNG_ORACLE)


@dataclass
class ServeConfig:
    deadline_s: float = 0.0          # per-request guard deadline (0 = off)
    retry_policy: Mapping[str, int] = field(
        default_factory=lambda: dict(DEFAULT_RETRY_POLICY))
    backoff_s: float = 0.0           # base sleep before a same-rung retry
    backoff_max_s: float = 2.0
    breaker: BreakerConfig = field(default_factory=BreakerConfig)
    strict: bool = False
    strict_after: int = 0            # answers tolerated degraded (warmup)
    coalesce: bool = True
    bounds: bool = True
    device: Optional[str] = None     # the card unless "cpu"
    clock: Callable[[], float] = time.monotonic
    sleep: Callable[[float], None] = time.sleep

    def retries_for(self, code: str) -> int:
        return int(self.retry_policy.get(code, 0))


@dataclass
class Request:
    id: int
    template: dict
    max_limit: int = 0


@dataclass
class Answer:
    request: Request
    result: Optional[object]         # sim.SolveResult when served
    error: Optional[str]             # set iff the request failed entirely
    rung: str
    degraded: bool
    latency_s: float
    coalesced: int                   # requests sharing this device solve

    @property
    def ok(self) -> bool:
        return self.error is None and not self.degraded


class Supervisor:
    """Request loop over a SnapshotStore.  Concurrency contract: ``submit``
    is safe from any thread (the intake queue is lock-protected); callers
    still serialize ``drain`` — solve state (_visited, answer counters,
    breaker board, store memos) is confined to the draining thread (the
    daemon CLI and the soak harness both drive one loop)."""

    def __init__(self, store: SnapshotStore,
                 config: Optional[ServeConfig] = None, mesh=None):
        self.store = store
        self.config = config or ServeConfig()
        if mesh is not None:
            from ..engine.simulator import resolve_device
            from ..parallel import mesh as mesh_lib
            mesh_lib.check_device(mesh, resolve_device(self.config.device))
        self.mesh = mesh
        self.board = BreakerBoard(self.config.breaker,
                                  clock=self.config.clock)
        self._lock = threading.Lock()   # guards the intake queue ONLY
        self._pending: List[Request] = []  # cc-guarded-by: _lock
        self._visited: set = set()  # cc-thread-confined: drain thread (rungs attempted in the current drain)
        self._ids = itertools.count(1)
        self.answers = 0
        self.degraded_answers = 0
        self.error_answers = 0
        self.restarts = 0
        self.strict_tripped = False

    # -- request intake ----------------------------------------------------

    def submit(self, template: dict, max_limit: int = 0) -> Request:
        req = Request(id=next(self._ids), template=template,
                      max_limit=max_limit)
        with self._lock:
            self._pending.append(req)
        return req

    def serve(self, template: dict, max_limit: int = 0) -> Answer:
        req = self.submit(template, max_limit=max_limit)
        answers = {a.request.id: a for a in self.drain()}
        return answers[req.id]

    def apply_delta(self, delta) -> bool:
        return self.store.apply(delta)

    # -- the drain ---------------------------------------------------------

    def drain(self) -> List[Answer]:
        """Solve every pending request: encode against the current store
        state, coalesce, dispatch through the breaker-aware ladder, and
        answer each request.  A failure answers its requests with an error;
        it never escapes this method."""
        with self._lock:
            reqs, self._pending = self._pending, []
        if not reqs:
            return []
        t0 = self.config.clock()
        try:
            pbs = self.store.problems([r.template for r in reqs])
        except Exception as exc:  # encode failure poisons nothing: restart
            self._restart_worker(f"encode failed: {exc}")
            elapsed = self.config.clock() - t0
            return [self._answer(r, None, f"{type(exc).__name__}: {exc}",
                                 "", False, elapsed, 1) for r in reqs]

        self._visited.clear()
        classes = self._coalesce(reqs, pbs)
        results = self._dispatch(classes)
        self._probe_stale(classes)

        elapsed = self.config.clock() - t0
        answers: List[Answer] = []
        for cls, (result, err) in zip(classes, results):
            for j, (req, _pb) in enumerate(cls):
                res = result
                if res is not None and j > 0:
                    res = dataclasses.replace(result)  # independent copy
                answers.append(self._answer(
                    req, res, err,
                    getattr(result, "rung", "") if result is not None else "",
                    bool(getattr(result, "degraded", False)),
                    elapsed, len(cls)))
        shared = len(reqs) - len(classes)
        if shared > 0:
            default_registry.inc(obs_names.SERVE_COALESCED, shared)
        answers.sort(key=lambda a: a.request.id)
        return answers

    def _coalesce(self, reqs: Sequence[Request], pbs: Sequence) -> List:
        """Group (request, problem) pairs into signature classes: requests
        whose encoded tensors and max_limit match share one device solve."""
        from ..parallel import sweep as sweep_mod
        classes: List[List] = []
        if not self.config.coalesce:
            return [[(r, pb)] for r, pb in zip(reqs, pbs)]
        digest_cache: dict = {}
        by_sig: Dict[tuple, int] = {}
        for req, pb in zip(reqs, pbs):
            key = (sweep_mod._solve_signature(pb, digest_cache),
                   req.max_limit)
            if key in by_sig:
                classes[by_sig[key]].append((req, pb))
            else:
                by_sig[key] = len(classes)
                classes.append([(req, pb)])
        return classes

    def _dispatch(self, classes: List) -> List:
        """(result, error) per class — group solve when every representative
        is batchable and shares a step config, else per-item ladder."""
        reps = [cls[0][1] for cls in classes]
        limits = {cls[0][0].max_limit for cls in classes}
        if len(classes) > 1 and len(limits) == 1 and self._groupable(reps):
            try:
                return self._solve_group_supervised(
                    reps, max_limit=limits.pop())
            except Exception as exc:
                self._restart_worker(f"group solve died: {exc}")
                return [(None, f"{type(exc).__name__}: {exc}")] * len(classes)
        return [self._solve_item(cls[0][1], max_limit=cls[0][0].max_limit)
                for cls in classes]

    def _solve_item(self, pb, max_limit: int = 0, degraded: bool = False):
        """(result, error) for one problem, faults contained per item: a
        ladder-exhausting RuntimeFault or an unclassified crash answers ONLY
        this signature class, never its drain-mates."""
        try:
            return (self._solve_one_supervised(
                pb, max_limit=max_limit, degraded=degraded), None)
        except RuntimeFault as fault:
            return (None, f"{fault.code}: {fault}")
        except Exception as exc:
            self._restart_worker(f"solve died: {exc}")
            return (None, f"{type(exc).__name__}: {exc}")

    def _groupable(self, pbs: Sequence) -> bool:
        from ..engine import simulator as sim
        from ..parallel import sweep as sweep_mod
        if not all(sweep_mod._batchable(pb) for pb in pbs):
            return False
        keys = {sweep_mod._group_key(pb, sim.static_config(pb))
                for pb in pbs}
        return len(keys) == 1

    # -- supervised ladder walks -------------------------------------------

    def _rung_solvers(self, pb, max_limit: int) -> Dict[str, tuple]:
        """rung -> (site, solve) for one problem on the per-item ladder."""
        from ..engine import fast_path
        cfg = self.config
        return {
            RUNG_FUSED: (SITE_SOLVE, lambda: fast_path.solve_auto(
                pb, max_limit=max_limit, bounds=cfg.bounds,
                device=cfg.device)),
            RUNG_FAST_PATH: (SITE_FAST_PATH, lambda: fast_path.solve_fast(
                pb, max_limit=max_limit, device=cfg.device)),
            RUNG_ORACLE: (SITE_ORACLE, lambda: degrade._solve_oracle(
                pb, max_limit=max_limit)),
        }

    def _solve_one_supervised(self, pb, max_limit: int = 0,
                              degraded: bool = False):
        """Per-item ladder with breakers + fault-class retries.  Raises the
        last RuntimeFault only when every admitted rung failed."""
        n = pb.snapshot.num_nodes
        solvers = self._rung_solvers(pb, max_limit)
        last_fault: Optional[RuntimeFault] = None
        for i, rung in enumerate(_ONE_LADDER):
            is_last = i == len(_ONE_LADDER) - 1
            if not self.board.allow_rung(rung, is_last=is_last):
                degraded = True  # pinned below a broken rung
                continue
            site, fn = solvers[rung]
            br = self.board.breaker(rung)
            fault = self._attempt_rung(br, fn, site=site, rung=rung,
                                       nodes=n)
            if isinstance(fault, RuntimeFault):
                last_fault = fault
                if not is_last:
                    degrade._record(fault, _ONE_LADDER[i + 1])
                degraded = True
                continue
            result = fault  # the attempt returned a result
            if rung == RUNG_FAST_PATH and result is None:
                continue  # closed form ineligible: descend, not a fault
            return degrade._stamp(result, rung, degraded)
        raise last_fault if last_fault is not None else RuntimeError(
            "no rung served and none faulted")

    def _group_solve(self, pbs: Sequence, max_limit: int, mesh=None):
        from ..parallel import sweep as sweep_mod
        return lambda: sweep_mod.solve_group(
            list(pbs), max_limit=max_limit, mesh=mesh,
            bounds=self.config.bounds, device=self.config.device)

    def _solve_group_supervised(self, pbs: Sequence, max_limit: int = 0):
        """Group ladder: sharded (mesh) → batched (kernel 2) → per-item
        fallback.  Returns one (result, error) pair per problem — the
        per-item fallback contains each problem's faults individually, so
        one poisoned request cannot error every coalesced class in the
        drain."""
        from ..parallel import mesh as mesh_lib
        n = pbs[0].snapshot.num_nodes
        degraded = False
        if self.mesh is not None:
            if self.board.allow_rung(RUNG_SHARDED):
                fault = self._attempt_rung(
                    self.board.breaker(RUNG_SHARDED),
                    self._group_solve(pbs, max_limit, self.mesh),
                    site=SITE_SHARDED, rung=RUNG_SHARDED, nodes=n,
                    phase=guard.PHASE_COMPILE, batch=len(pbs),
                    mesh_shape=mesh_lib.mesh_shape(self.mesh))
                if not isinstance(fault, RuntimeFault):
                    return [(degrade._stamp(r, RUNG_SHARDED, False), None)
                            for r in fault]
                degrade._record(fault, RUNG_BATCHED)
            degraded = True
        if self.board.allow_rung(RUNG_BATCHED):
            br = self.board.breaker(RUNG_BATCHED)
            fault = self._attempt_rung(
                br, self._group_solve(pbs, max_limit),
                site=SITE_GROUP, rung=RUNG_BATCHED, nodes=n,
                phase=guard.PHASE_COMPILE, batch=len(pbs))
            if not isinstance(fault, RuntimeFault):
                return [(degrade._stamp(r, RUNG_BATCHED, degraded), None)
                        for r in fault]
            degrade._record(fault, RUNG_FUSED)
        return [self._solve_item(pb, max_limit=max_limit, degraded=True)
                for pb in pbs]

    def _attempt_rung(self, br, fn, *, site: str, rung: str, nodes: int,
                      phase: str = guard.PHASE_EXECUTE,
                      batch: Optional[int] = None, mesh_shape=None):
        """One rung with fault-class retries.  Returns the solve result on
        success (breaker credited) or the final RuntimeFault (breaker
        debited per fault; unclassified exceptions propagate raw)."""
        cfg = self.config
        self._visited.add(rung)
        attempts = 0
        while True:
            try:
                result = guard.run(
                    fn, site=site, deadline=cfg.deadline_s, phase=phase,
                    validate_nodes=nodes, rung=rung, batch=batch,
                    mesh_shape=mesh_shape)
                br.record_success()
                return result
            except RuntimeFault as fault:
                br.record_fault(fault)
                attempts += 1
                if (attempts > cfg.retries_for(fault.code)
                        or br.state != STATE_CLOSED):
                    # the fault may have opened the breaker (threshold hit,
                    # or a failed half-open probe): a retry would run against
                    # an open breaker, and its success could not close it
                    return fault
                if cfg.backoff_s > 0:
                    cfg.sleep(min(cfg.backoff_max_s,
                                  cfg.backoff_s * (2 ** (attempts - 1))))
            except BaseException:
                # unclassified: the caller contains it with a worker
                # restart, but the breaker must release the admitted probe
                # or it wedges half-open forever
                br.record_abort()
                raise

    def _probe_stale(self, classes: Sequence) -> None:
        """Canary probes for rungs the ladder no longer visits.  A breaker
        below the serving path sees no organic traffic once the rung above
        recovers (the ladder stops at the first success), so its half-open
        probe would starve and the breaker would stay open forever.  After
        each drain, any non-closed breaker whose rung went unvisited gets
        one probe solve — against this drain's own problems AND max_limit
        (the budget sets the chunk length), so the probe re-lands on the
        kernels and step graphs the organic path already built and
        captures nothing new.  Success closes the breaker; a fault re-opens
        it (and restarts the cooldown), exactly like an organic half-open
        probe."""
        if not classes:
            return
        req0, pb = classes[0][0]
        ml = req0.max_limit
        n = pb.snapshot.num_nodes
        probes = {rung: (site, guard.PHASE_EXECUTE, None, fn)
                  for rung, (site, fn) in
                  self._rung_solvers(pb, ml).items()}
        # the group rung only probes with the full representative set at a
        # single shared budget — the same admission rule _dispatch used to
        # size the group launch; a probe with another batch shape or budget
        # could capture or plan anew, and that cost is warmup-only
        pbs = [cls[0][1] for cls in classes]
        limits = {cls[0][0].max_limit for cls in classes}
        if len(pbs) > 1 and len(limits) == 1 and self._groupable(pbs):
            probes[RUNG_BATCHED] = (SITE_GROUP, guard.PHASE_COMPILE,
                                    len(pbs), self._group_solve(pbs, ml))
            if self.mesh is not None:
                probes[RUNG_SHARDED] = (SITE_SHARDED, guard.PHASE_COMPILE,
                                        len(pbs), self._group_solve(
                                            pbs, ml, self.mesh))
        for br in self.board.breakers():
            if br.state == STATE_CLOSED or br.rung in self._visited \
                    or br.rung not in probes:
                continue
            if not br.allow():
                continue          # cooldown still running / probe in flight
            site, phase, batch, fn = probes[br.rung]
            try:
                self._attempt_rung(br, fn, site=site, rung=br.rung,
                                   nodes=n, phase=phase, batch=batch)
            except Exception as exc:   # unclassified: contain like dispatch
                self._restart_worker(f"canary probe died: {exc}")

    # -- containment -------------------------------------------------------

    def _restart_worker(self, why: str) -> None:
        self.store.invalidate()
        self.restarts += 1
        default_registry.inc(obs_names.SERVE_RESTARTS)
        default_recorder.eventf("serve", EVENT_RESTART,
                                f"worker state restarted: {why}")

    def _answer(self, req: Request, result, err: Optional[str], rung: str,
                degraded: bool, latency_s: float, coalesced: int) -> Answer:
        self.answers += 1
        if err is not None:
            outcome = "error"
            self.error_answers += 1
        elif degraded:
            outcome = "degraded"
            self.degraded_answers += 1
        else:
            outcome = "ok"
        default_registry.inc(obs_names.SERVE_REQUESTS, outcome=outcome)
        if outcome != "ok" and self.answers > self.config.strict_after:
            # strict grace covers the first N answers (warmup degradations:
            # a cold build overruns a tight deadline, say); past the grace
            # any non-ok answer trips the strict contract
            self.strict_tripped = True
        return Answer(request=req, result=result, error=err, rung=rung,
                      degraded=degraded, latency_s=latency_s,
                      coalesced=coalesced)

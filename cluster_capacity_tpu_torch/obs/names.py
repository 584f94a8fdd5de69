"""The cc_* telemetry metric vocabulary (one place, so dashboards, tests
and the Prometheus rendering agree on names and label sets).  The names
are the JAX package's, the serve/ daemon's included.

Counters:
    cc_guard_runs_total{site,rung,phase,outcome}  every guard.run dispatch;
        outcome is "ok" or the RuntimeFault code (DeviceOOM, CompileTimeout,
        ExecuteTimeout, NumericCorruption) or the raw exception type name
    cc_guard_first_calls_total{site}              first dispatch per site —
        the compile-vs-execute split marker for cached-executable paths
    cc_degradations_total{site,fault,to_rung}     ladder transitions
        (runtime/degrade.py _record)
    cc_faults_injected_total{site,kind}           chaos harness firings
    cc_recompiles_total                           compiles: the first-use nvcc
        build of csrc/fused_steps.cu, the native libccsnap build and each
        CUDA-graph capture of the scan step (obs/recompile.record_compile;
        an eager CPU run compiles nothing, so it stays 0 there)
    cc_compile_seconds_total                      seconds of those compiles
    cc_trace_spans_dropped_total                  span-buffer overflow
    cc_explains_total{rung}                       attribution artifacts built
        per solve rung (explain/artifacts.build_explanation)
    cc_device_seconds_total{site,rung,phase}      accumulated guarded-dispatch
        seconds (obs/profile.py): host wall time inside the guard, not
        device time — it holds the host's work in the call (encodes, the
        drive loop, copies) besides the waits for the card; the name is
        the JAX package's
    cc_flight_bundles_total{code}                 flight-recorder bundles
        dumped per fault code (obs/flight.py)
    cc_serve_requests_total{outcome}              daemon answers by outcome:
        "ok", "degraded" (served off the entry rung), "error" (request
        failed but the daemon survived) — serve/supervisor.py
    cc_serve_coalesced_total                      requests answered by another
        request's device solve (same-template dedup in a drain)
    cc_serve_deltas_total{op,outcome}             snapshot deltas by op and
        "applied"/"quarantined" (serve/ingest.py)
    cc_serve_restarts_total                       worker-state crash-restarts
        after an unclassified request failure
    cc_breaker_transitions_total{site,from,to}    circuit-breaker state
        transitions (serve/breaker.py)

Gauges:
    cc_sweep_templates                    templates in the current sweep
    cc_sweep_groups{mode}                 batched/fast_path/sequential groups
    cc_resilience_scenarios{state}        total/completed scenario progress
    cc_explain_reason_nodes{reason}       nodes per terminal why-not reason
        in the most recent explained solve
    cc_device_peak_bytes                  device memory watermark from
        torch.cuda.memory_stats() (graceful no-op where the device — the CPU —
        exposes none; obs/profile.py samples it per guarded dispatch when
        memory sampling is enabled)
    cc_kernel_efficiency{entry,rung}      measured FLOPs rate / calibrated
        platform rate per canonical entry (obs/costmodel.py)
    cc_breaker_state{site,rung}           circuit-breaker state per guarded
        site: 0 closed, 1 open, 2 half-open (serve/breaker.py)

Histograms:
    cc_guard_run_duration_seconds{site,rung,phase}   per-dispatch wall time

Beside this vocabulary the registry carries the kube-scheduler series under
upstream's names (utils/metrics.py).  Of DefaultPreemption's, which only the
port records:
    scheduler_preemption_attempts_total   dry runs of the preemption loop's
        full path (framework._solve_with_preemption); upstream counts every
        PostFilter call, the port not the cycles that the no-candidate test
        fails unbuilt
    scheduler_preemption_victims          histogram of the victims of each
        preemption made, buckets 1, 2, 4, ..., 64 as upstream's
"""

GUARD_RUNS = "cc_guard_runs_total"
GUARD_FIRST_CALLS = "cc_guard_first_calls_total"
GUARD_DURATION = "cc_guard_run_duration_seconds"
DEGRADATIONS = "cc_degradations_total"
FAULTS_INJECTED = "cc_faults_injected_total"
RECOMPILES = "cc_recompiles_total"
COMPILE_SECONDS = "cc_compile_seconds_total"
SPANS_DROPPED = "cc_trace_spans_dropped_total"
SWEEP_TEMPLATES = "cc_sweep_templates"
SWEEP_GROUPS = "cc_sweep_groups"
SCENARIOS = "cc_resilience_scenarios"
EXPLAINS = "cc_explains_total"
EXPLAIN_REASON_NODES = "cc_explain_reason_nodes"
DEVICE_SECONDS = "cc_device_seconds_total"
DEVICE_PEAK_BYTES = "cc_device_peak_bytes"
KERNEL_EFFICIENCY = "cc_kernel_efficiency"
FLIGHT_BUNDLES = "cc_flight_bundles_total"
SERVE_REQUESTS = "cc_serve_requests_total"
SERVE_COALESCED = "cc_serve_coalesced_total"
SERVE_DELTAS = "cc_serve_deltas_total"
SERVE_RESTARTS = "cc_serve_restarts_total"
BREAKER_STATE = "cc_breaker_state"
BREAKER_TRANSITIONS = "cc_breaker_transitions_total"

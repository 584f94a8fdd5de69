"""The readers of the program's own spans (portbench/spans.py and the
metrics that use it) on the tiny CPU cells, and what they return where the
spans cannot be read."""

from __future__ import annotations

import io
import json
import time
from types import SimpleNamespace

import pytest
import torch

import portbench_tiny as pt
from portbench import harness, run, spans

SPAN_METRICS = {
    "k8s-5000n.spread": ["dryrun_clones_ms.pps", "dryrun_filter_ms.pps",
                         "gc_ms.pps", "compile_ms.pps"],
    "gke-10000n.race": ["gc_ms.pps", "compile_ms.pps",
                        "replay_us_per_pop.race", "wait_us_per_pop.race",
                        "race_encode_ms.pps"],
}


def _traced(tmp_path, workload, seed=2 ** 31 + 313):
    from cluster_capacity_tpu_torch.obs import spans as obs_spans
    obs_spans.default_collector.reset()
    cell, dirs = pt.tiny_cell(tmp_path, workload)
    out = io.StringIO()
    rc = run.run_cell(cell, seed, 0.5, True, torch.device("cpu"),
                      time.perf_counter(), dirs=dirs, out=out)
    assert rc == 0
    return cell, json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("workload", sorted(SPAN_METRICS))
def test_span_metrics_read_on_the_tiny_cells(tmp_path, workload):
    """Each new metric of a cell is in its traced result line, a number
    (compile time 0 on the CPU, which captures no graph)."""
    cell, res = _traced(tmp_path, workload)
    assert res["correct"] is True
    assert set(SPAN_METRICS[workload]) <= {m["name"]
                                           for m in cell.per_layer}
    for name in SPAN_METRICS[workload]:
        assert res["metrics"][name]["value"] >= 0, name
    assert res["metrics"]["compile_ms.pps"]["value"] == 0.0
    if workload == "k8s-5000n.spread":
        m = {k: v["value"] for k, v in res["metrics"].items()}
        parts = m["dryrun_clones_ms.pps"] + m["dryrun_filter_ms.pps"]
        assert 0 < parts <= m["dryrun_ms.pps"]
    else:
        assert res["metrics"]["replay_us_per_pop.race"]["value"] > 0
        assert res["metrics"]["race_encode_ms.pps"]["value"] > 0


def _info(answers, window_s=1.0):
    return harness.RunInfo(cell=None, window_s=window_s, answers=answers)


def _answer(start, end, placed=10, failed=False):
    return harness.AnswerRecord(index=0, start=start, end=end, placed=placed,
                                failed=failed, summary=None if failed else 1)


def test_span_readers_by_answer_and_pop():
    """Spans count toward the answer they lie in; a failed answer's spans
    and spans outside the window count toward nothing."""
    from cluster_capacity_tpu_torch import obs
    obs.default_collector.reset()
    answers = []
    for failed in (False, True, False):
        a0 = time.perf_counter()
        with obs.span("steps.replay") as sp:
            time.sleep(0.002)
        sp.gc_s = 0.001
        answers.append(_answer(a0, time.perf_counter(), failed=failed))
    with obs.span("steps.replay"):       # after the window
        time.sleep(0.002)
    info = _info(answers)
    inside = [s for s in obs.default_collector.spans()][:3]
    good = [inside[0], inside[2]]
    assert spans.per_answer_ms(info, ["steps.replay"]) == pytest.approx(
        sum(s.duration_s for s in good) / 2 * 1000)
    assert spans.per_pop_us(info, ["steps.replay"]) == pytest.approx(
        sum(s.duration_s for s in good) / 20 * 1e6)
    assert spans.charged_ms(info, "gc_s") == pytest.approx(1.0)
    assert spans.charged_ms(info, "compile_s") == 0.0
    assert spans.per_answer_ms(info, ["interleave.wait"]) is None


def test_span_readers_return_none_after_a_dropped_span():
    from cluster_capacity_tpu_torch import obs
    col = obs.default_collector
    col.reset()
    a0 = time.perf_counter()
    with obs.span("preemption.clones"):
        pass
    info = _info([_answer(a0, time.perf_counter())])
    assert spans.per_answer_ms(info, ["preemption.clones"]) is not None
    saved = col.max_spans
    col.max_spans = 1
    try:
        with obs.span("preemption.clones"):
            pass
    finally:
        col.max_spans = saved
    assert col.dropped == 1
    assert spans.window_spans(info) is None
    assert spans.per_answer_ms(info, ["preemption.clones"]) is None
    assert spans.charged_ms(info, "gc_s") is None
    col.reset()


def test_span_readers_return_none_without_span_clocks(monkeypatch):
    """A program whose spans keep no perf_counter times, nor gc or compile
    costs (the benchmark laid over an older checkout), gives no reading;
    no reader raises."""
    from cluster_capacity_tpu_torch.obs import spans as obs_spans
    old = SimpleNamespace(name="preemption.clones", start_s=time.time(),
                          duration_s=0.5, compile_s=0.0)
    fake = SimpleNamespace(dropped=0, spans=lambda: [old])
    monkeypatch.setattr(obs_spans, "default_collector", fake)
    info = _info([_answer(0.0, time.perf_counter() + 10)])
    assert spans.window_spans(info) is None
    for name in sorted({n for v in SPAN_METRICS.values() for n in v}):
        reader = harness.load_module("metrics", name)
        assert reader.read(info) is None, name

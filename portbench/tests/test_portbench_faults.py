"""Runs with the timed path broken underneath: `correct` must come out
false for each fault a cell can have (a step that returns its state
unchanged, an answer altered where it is produced).  One card, so no
exchange between chips exists to leave out; no cell runs a batch of
templates side by side, so none has half of one to leave out."""

from __future__ import annotations

import dataclasses
import io
import json
import time

import pytest
import torch

import portbench_tiny as pt
from portbench import run

from cluster_capacity_tpu_torch.engine import fused
from cluster_capacity_tpu_torch.parallel import interleave
from cluster_capacity_tpu_torch.runtime import degrade


def _correct(cell, dirs) -> bool:
    out = io.StringIO()
    rc = run.run_cell(cell, 2 ** 31 + 3, 0.2, False, torch.device("cpu"),
                      time.perf_counter(), dirs=dirs, out=out)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])["correct"]


def _altered(result):
    """The same result with its middle placement moved to the next node."""
    p = list(result.placements)
    if p:
        p[len(p) // 2] = (p[len(p) // 2] + 1) % len(result.node_names)
    return dataclasses.replace(result, placements=p)


def _stuck(real):
    """The kernel run one step at a time, every step returning the state it
    was given."""
    def stuck(const, carry, scalars, table, k, *a, **kw):
        chosen = [real(const, carry, scalars, table, 1, *a, **kw)[2]
                  for _ in range(k)]
        return carry, scalars, torch.cat(chosen)
    return stuck


def _state_unchanged_kernel(monkeypatch):
    monkeypatch.setattr(fused, "fused_steps", _stuck(fused.fused_steps))


def _state_unchanged_race(monkeypatch):
    real = interleave._xstep

    def stuck(cfg, consts, xc, *a, **kw):
        _xc, out = real(cfg, consts, xc, *a, **kw)
        return xc, out
    monkeypatch.setattr(interleave, "_xstep", stuck)


def _answer_altered_one(monkeypatch):
    real = degrade.solve_one_guarded
    monkeypatch.setattr(degrade, "solve_one_guarded",
                        lambda *a, **kw: _altered(real(*a, **kw)))


def _answer_altered_race(monkeypatch):
    real = interleave.solve_interleaved_tensor

    def altered(*a, **kw):
        res = real(*a, **kw)
        return None if res is None else [_altered(res[0])] + list(res[1:])
    monkeypatch.setattr(interleave, "solve_interleaved_tensor", altered)


FAULTS = [
    ("k8s-5000n.spread", _state_unchanged_kernel),
    ("k8s-5000n.spread", _answer_altered_one),
    ("gke-10000n.race", _state_unchanged_race),
    ("gke-10000n.race", _answer_altered_race),
]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w}-{f.__name__.strip('_')}"
                              for w, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch,
                                            workload, fault):
    cell, dirs = pt.tiny_cell(tmp_path, workload)
    assert _correct(cell, dirs) is True
    fault(monkeypatch)
    assert _correct(cell, dirs) is False

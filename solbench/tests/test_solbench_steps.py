"""The gradient window's per-step record on the CPU at tiny size: the
run's notes list every step of the window, ``grad_step_ms`` stays the
window's time over its steps, and the result line keeps its keys.  The
spread arithmetic of ``pairs.py``."""

import json
import re
import time

import pytest
import torch

from solbench import harness, pairs
from solbench.tests.solbench_tiny import tiny_cell

torch.set_num_threads(2)
SEED = 2**31 + 77

# The result line's keys before the window noted its steps.
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]
METRIC_KEYS = {"setup_s": {"value", "unit"},
               "grad_step_ms": {"value", "unit", "samples"}}
DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}


def _steps(notes):
    found = [json.loads(n[len(harness.STEPS):]) for n in notes
             if n.startswith(harness.STEPS)]
    assert len(found) == 1, notes
    return found[0]


def test_grad_window_notes_every_step():
    notes = []
    res = harness.run(tiny_cell("terrain1m.grad"), SEED, 1.5, False, "cpu",
                      time.perf_counter(), notes=notes)
    assert res["correct"], res["check"]
    steps = _steps(notes)
    n = res["attempted"]  # a few steps, or one on a loaded host
    assert steps["count"] == len(steps["step_ms"]) == n
    assert res["metrics"]["grad_step_ms"]["samples"] == n
    assert steps["max_ms"] >= steps["p90_ms"] >= steps["median_ms"] \
        >= steps["p10_ms"] > 0

    # grad_step_ms is the window's time (noted to the millisecond) over
    # its steps, which is no less than the steps' own times
    window_s = float(re.search(rf"{n} steps in ([0-9.]+) s",
                               " ".join(notes)).group(1))
    step_ms = res["metrics"]["grad_step_ms"]["value"]
    assert step_ms * n == pytest.approx(window_s * 1e3, abs=0.5)
    assert step_ms * n >= sum(steps["step_ms"]) - 0.001 * n

    assert list(res) == LINE_KEYS
    assert {k: set(v) for k, v in res["metrics"].items()} == METRIC_KEYS
    assert set(res["device"]) == DEVICE_KEYS


def test_step_note_sums_head_and_rest():
    ms = [30.0, 20.0, 20.0, 20.0, 10.0, 10.0, 10.0, 40.0]
    steps = json.loads(harness.step_note(ms, 1.5)[len(harness.STEPS):])
    assert (steps["count"], steps["median_ms"], steps["max_ms"]) == (8, 20.0,
                                                                     40.0)
    assert steps["head_mean_ms"] == 20.0 and steps["rest_mean_ms"] == 20.0
    assert steps["cpu_s"] == 1.5 and steps["step_ms"] == ms
    one = json.loads(harness.step_note([5.0], 0.1)[len(harness.STEPS):])
    assert one["rest_mean_ms"] is None and one["p90_ms"] == 5.0


@pytest.mark.parametrize("values,spread", [
    ([100.0, 101.0, 102.0, 103.0, 130.0], 3.0),  # the far run left out
    ([100.0, 110.0, 120.0], 10.0),
    ([100.0, 104.0], 4.0),
])
def test_check_spread_leaves_out_the_farthest_run(values, spread):
    assert pairs.check_spread(values) == spread


def test_quartile_share_follows_statistics_quantiles():
    values = [100.0, 102.0, 104.0, 106.0, 108.0, 110.0]
    q1, _, q3 = 101.5, None, 108.5
    assert pairs.quartile_share(values) == pytest.approx((q3 - q1) / 105.0)

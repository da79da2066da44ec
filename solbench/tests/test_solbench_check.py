"""The check on the CPU at tiny sizes: the program against the plain
reference under each traversal and for a gradient step; the control
(the reference in bfloat16 in the program's place) and each fault a cell
can have come out not correct; the device trace's arithmetic."""

import time

import pytest
import torch

from solbench import check, devtrace, faults, harness
from solbench.tests.solbench_tiny import tiny_cell

torch.set_num_threads(2)
SEED = 2**31 + 77


@pytest.mark.parametrize("name,traversal", [
    ("terrain1m.auto", "auto"), ("terrain1m.auto", "while"),
    ("molecule100k.auto", "auto"), ("molecule100k.auto", "while"),
    ("terrain1m.grad", "while"), ("terrain1m.grad", "auto")])
def test_program_matches_reference(name, traversal):
    res = harness.run(tiny_cell(name, traversal=traversal), SEED, 0.0, False,
                      "cpu", time.perf_counter())
    assert res["correct"], res["check"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "check"
    cell = tiny_cell(name)
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}


@pytest.mark.parametrize("name,system", [
    ("terrain1m.auto", faults.control_frames),
    ("molecule100k.auto", faults.control_frames),
    ("terrain1m.grad", faults.control_grad)])
def test_control_is_not_correct(name, system):
    res = harness.run(tiny_cell(name), SEED, 0.0, False, "cpu",
                      time.perf_counter(), make_system=system)
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("name,fault", [
    ("terrain1m.auto", "altered_tile"), ("molecule100k.auto", "half_frame"),
    ("terrain1m.grad", "state_unchanged"), ("terrain1m.grad", "half_batch"),
    ("terrain1m.grad", "altered_gradient")])
def test_fault_is_not_correct(name, fault):
    system = {**faults.FRAME_FAULTS, **faults.GRAD_FAULTS}[fault]
    res = harness.run(tiny_cell(name), SEED, 0.0, False, "cpu",
                      time.perf_counter(), make_system=system)
    assert not res["correct"], res["check"]


def test_traced_run_reads_layers():
    res = harness.run(tiny_cell("terrain1m.auto"), SEED, 0.0, True, "cpu",
                      time.perf_counter())
    assert res["correct"]
    assert "scene_build_s" in res["metrics"]
    assert res["metrics"]["net_needy_rays"]["value"] >= 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["device"]["window_s"] > 0


def test_union_and_breakdown():
    tr = devtrace.DeviceTrace(
        kernels=[("a", 0.0, 10.0), ("b", 5.0, 20.0), ("a", 30.0, 40.0)],
        activity=[("a", 0.0, 10.0), ("b", 5.0, 20.0), ("a", 30.0, 40.0),
                  ("Memcpy HtoD", 50.0, 55.0)],
        host=[("outer", 0.0, 60.0), ("aten::nonzero", 21.0, 29.0)],
        window_s=60e-6)
    assert tr.busy_s == pytest.approx(35e-6)
    bd = devtrace.breakdown(tr)
    assert bd["device_ops"][0] == ["a", pytest.approx(20e-6)]
    assert bd["idle_gaps"][0] == ["aten::nonzero", pytest.approx(10e-6)]
    assert bd["idle_gaps"][1] == ["outer", pytest.approx(10e-6)]


def test_verdict_fails_a_number_that_is_not_finite():
    ok, rows = check.verdict({"a": float("nan"), "b": 0.0},
                             {"a": 1.0, "b": 0.0})
    assert not ok and rows["a"]["value"] == 1e300 and rows["b"]["value"] == 0

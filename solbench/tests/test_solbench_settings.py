"""A frame cell's render settings reach the program, the reference, the
control and the ray count.

The accepted cells state none, and run as before: the RenderConfig of
their workload and configuration alone, one unkeyed ``render_sample``
a frame, the plain reference's ``render``, 512 x 512 x 2 bounces x
(1 + 1 light) rays a frame, and at a fixed seed the same tiny frames,
reference frames and check numbers as the harness gave before frame
cells could state settings (the values below).

``fogbox``, a scene kind of the tests alone (``kind_fogbox.py`` and
``fogbox/``), states every setting: 2 shadow samples, fog, jitter, an
ambient-occlusion pass, 2 samples per pixel and a key.  The test
registers it; nothing outside ``solbench/tests`` names it."""

import sys
import time
from pathlib import Path

import pytest
import torch

import solr_tpu_torch
from solbench import faults, harness, manifest, systems
from solbench.reference import render as ref
from solbench.tests import kind_fogbox
from solbench.tests.solbench_tiny import tiny_cell

torch.set_num_threads(2)
SEED = 2**31 + 77
HERE = Path(__file__).resolve().parent
BENCH_DIR = HERE.parent

# The tiny frames at SEED before frame cells could state settings: the
# program's digest, the reference's, and the check's numbers.
BEFORE = {
    "terrain1m.auto": (1955.0824443250895, 1956.1585564136922,
                       {"bad_px_share": 0.0009765625,
                        "mean_err": 4.447099716019643e-07,
                        "digest_gap": 0.0}),
    "molecule100k.auto": (546.6753183776901, 546.67567976026,
                          {"bad_px_share": 0.0,
                           "mean_err": 9.702418111830961e-07,
                           "digest_gap": 0.0}),
}
FRAME_CELLS = sorted(BEFORE)
# The cells accepted before frame cells could state settings; later
# cells may state them.
PLAIN_CELLS = FRAME_CELLS + ["terrain1m.grad"]


def _raising(*args, **kwargs):
    raise AssertionError("the frame took the other entry point")


def _recording(fn, calls):
    def call(*args, **kwargs):
        calls.append((args, kwargs))
        return fn(*args, **kwargs)
    return call


# --- the accepted cells -------------------------------------------------


@pytest.mark.parametrize("name", PLAIN_CELLS)
def test_accepted_cells_state_no_settings(name):
    cell = manifest.Cell(name)
    w, c = cell.workload, cell.config
    assert (cell.settings, cell.spp, cell.keyed, cell.lights) == ({}, 1,
                                                                 False, 1)
    assert systems.render_config(cell) == solr_tpu_torch.RenderConfig(
        width=w["width"], height=w["height"], max_bounces=w["bounces"],
        gradient_background=c["gradient_background"],
        traversal=w["traversal"], **c["packet"])


@pytest.mark.parametrize("name", FRAME_CELLS)
def test_accepted_frames_count_their_rays_as_before(name):
    assert harness.frame_rays(manifest.Cell(name)) == 512 * 512 * 2 * 2


@pytest.mark.parametrize("name", FRAME_CELLS)
def test_accepted_frames_are_one_unkeyed_sample(name, monkeypatch):
    calls = []
    monkeypatch.setattr(solr_tpu_torch, "render", _raising)
    monkeypatch.setattr(solr_tpu_torch, "render_sample",
                        _recording(solr_tpu_torch.render_sample, calls))
    cell = tiny_cell(name)
    raw = cell.scene_kind.make_inputs(cell.config, SEED)
    system = systems.PortFrames(cell, raw, "cpu", SEED)
    digest = harness._digest(system.frame())
    (args, kwargs), = calls
    assert len(args) == 3 and not kwargs  # no key, no samples
    assert digest == BEFORE[name][0]


@pytest.mark.parametrize("name", FRAME_CELLS)
def test_accepted_reference_is_the_plain_render(name, monkeypatch):
    calls = []
    monkeypatch.setattr(ref, "render", _recording(ref.render, calls))
    cell = tiny_cell(name)
    assert not hasattr(cell.reference_kind, "render")
    raw = cell.scene_kind.make_inputs(cell.config, SEED)
    scene = cell.reference_kind.reference_scene(raw, cell.config, "cpu",
                                                torch.float64)
    rgb = systems.reference_frame(cell, scene, SEED)
    (args, kwargs), = calls
    assert args[1:] == (cell.config["camera"], 32, 32, 2) and not kwargs
    assert rgb.shape == (32, 32, 3)
    assert float(rgb.sum()) == BEFORE[name][1]


@pytest.mark.parametrize("name", FRAME_CELLS)
def test_accepted_check_numbers_as_before(name):
    res = harness.run(tiny_cell(name), SEED, 0.0, False, "cpu",
                      time.perf_counter())
    assert {k: v["value"] for k, v in res["check"].items()} == BEFORE[name][2]


# --- a kind of the tests that states every setting ----------------------


@pytest.fixture
def fogbox(monkeypatch):
    """The ``fogbox.soft`` cell, with its kind registered as its scene
    module and its reference."""
    for role in ("scenes", "reference"):
        monkeypatch.setitem(sys.modules, f"solbench.{role}.fogbox",
                            kind_fogbox)
    monkeypatch.setattr(kind_fogbox, "CALLS", [])
    bench = {
        "configs": [{"name": "fogbox",
                     "file": "solbench/tests/fogbox/fogbox.json"}],
        "workloads": [{"name": "fogbox.soft", "config": "fogbox",
                       "traffic": "soft", "chips": 1}],
        "end_to_end": [{"name": "setup_s", "unit": "s"},
                       {"name": "rays_per_s.fogbox", "unit": "rays/s",
                        "workloads": ["fogbox.soft"]}],
        "per_layer": []}
    return tiny_cell(manifest.Cell("fogbox.soft", bench,
                                   HERE / "fogbox" / "workloads"))


def test_fogbox_frames_render_with_the_key_and_samples(fogbox, monkeypatch):
    calls = []
    monkeypatch.setattr(solr_tpu_torch, "render_sample", _raising)
    monkeypatch.setattr(solr_tpu_torch, "render",
                        _recording(solr_tpu_torch.render, calls))
    res = harness.run(fogbox, SEED, 0.0, False, "cpu", time.perf_counter())
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "rays_per_s.fogbox"}
    assert len(calls) == res["attempted"] + 1  # and the warm-up frame
    key = solr_tpu_torch.Key.seed(SEED, "cpu")
    for (scene, cam, cfg, k, spp), kwargs in calls:
        assert (k.state, k.device, spp, kwargs) == (key.state, key.device,
                                                    2, {})
        assert (cfg.shadow_samples, cfg.fog, cfg.antialias_jitter) == (
            2, True, True)
        assert cfg.postfx == solr_tpu_torch.PostFxConfig(
            solr_tpu_torch.PostFxMode.AMBIENT_OCCLUSION, 4)


def test_fogbox_frames_of_one_key_are_one_image(fogbox):
    raw = fogbox.scene_kind.make_inputs(fogbox.config, SEED)
    system = systems.PortFrames(fogbox, raw, "cpu", SEED)
    first, again = system.frame(), system.frame()
    assert torch.equal(first, again)
    other = systems.PortFrames(fogbox, raw, "cpu", SEED + 1).frame()
    assert not torch.equal(first, other)


@pytest.mark.parametrize("make_system,dtype", [
    (None, torch.float64), (faults.control_frames, torch.bfloat16)])
def test_fogbox_reference_gets_the_settings_and_seed(fogbox, make_system,
                                                     dtype):
    harness.run(fogbox, SEED, 0.0, False, "cpu", time.perf_counter(),
                make_system=make_system)
    reference = [c for c in kind_fogbox.CALLS if c["dtype"] == dtype]
    assert reference, kind_fogbox.CALLS
    for c in reference:
        assert c["settings"] == fogbox.config["render"]
        assert c["seed"] == SEED
        assert (c["workload"]["spp"], c["workload"]["keyed"]) == (2, True)


@pytest.mark.parametrize("change,rays", [
    # 32 x 32 pixels, 2 samples, 2 bounces, 1 + 1 light x 2 shadow samples
    ({}, 32 * 32 * 2 * 2 * (1 + 2)),
    # without a key: one sample, hard shadows
    ({"keyed": False}, 32 * 32 * 2 * (1 + 1)),
    ({"render": {"shadows": False}}, 32 * 32 * 2 * 2 * 1),
    ({"render": {"camera_mode": "ANAGLYPH"}}, 32 * 32 * 2 * 2 * 2 * (1 + 1)),
    ({"lights": [{}, {}, {}]}, 32 * 32 * 2 * 2 * (1 + 3 * 2)),
])
def test_fogbox_rays_follow_the_formula(fogbox, change, rays):
    for key, value in change.items():
        part = fogbox.workload if key in fogbox.workload else fogbox.config
        part[key] = value
    assert harness.frame_rays(fogbox) == rays


def test_fogbox_is_named_nowhere_outside_the_tests():
    tests = BENCH_DIR / "tests"
    outside = [p for p in BENCH_DIR.rglob("*") if p.is_file()
               and tests not in p.parents and p.suffix in (".py", ".json")]
    outside.append(BENCH_DIR.parent / "BENCHMARK.json")
    assert outside
    for path in outside:
        assert "fogbox" not in path.read_text(), path
    assert not (BENCH_DIR / "scenes" / "fogbox.py").exists()
    assert not (BENCH_DIR / "reference" / "fogbox.py").exists()

"""The textured cell (``textured_mixed.spp4``, BASELINE config #3) at a
tiny size on the CPU: its pieces found by name, its rays a frame, the
program passing the check against the kind's own reference, the control
and each fault failing it, and the reference's copy of the program's
key drawing what the program's ``Key`` draws."""

import copy
import time

import pytest
import torch

from solbench import faults, harness, manifest
from solbench.reference import textured as ref_textured
from solbench.scenes import textured
from solbench.tests.solbench_tiny import TINY_LIMITS

torch.set_num_threads(2)
CELL = "textured_mixed.spp4"
SEED = 2**31 + 77


def tiny():
    """The cell with an 8-cell ground at 32 x 18 (not whole 16 x 16
    tiles: the program walks, as at 1080p), with the tiny limits."""
    cell = manifest.Cell(CELL)
    cell.config = copy.deepcopy(cell.config)
    cell.config.update(textured.TINY)
    cell.workload = dict(copy.deepcopy(cell.workload), width=32, height=18)
    cell.workload["check"]["limits"] = dict(TINY_LIMITS["frames"])
    return cell


def test_manifest_finds_the_cell():
    cell = manifest.Cell(CELL)
    assert cell.scene_kind is textured
    assert cell.reference_kind is ref_textured
    assert callable(cell.reference_kind.render)
    assert (cell.spp, cell.keyed, cell.lights) == (4, True, 1)
    assert (cell.workload["width"], cell.workload["height"],
            cell.workload["bounces"], cell.workload["traversal"]) == (
                1920, 1080, 3, "auto")
    assert cell.settings["shadow_samples"] == 4
    assert cell.settings["sky_texture"] == \
        cell.config["texture_order"].index("sky")
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "rays_per_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "texture_ms.textured", "postfx_ms.textured", "shade_ms.textured",
        "walk_ms.textured", "walk_launches_per_frame.textured",
        "kernels_per_frame.textured", "device_idle_pct.textured"}
    for m in cell.per_layer:
        assert manifest.reader(m["name"]).MOVES == "rays_per_s"


def test_rays_a_frame():
    # 1920 x 1080 pixels, 4 samples, 3 bounces, 1 + 1 light x 4 shadow
    # samples.
    assert harness.frame_rays(manifest.Cell(CELL)) == 124_416_000
    assert harness.frame_rays(manifest.Cell(CELL)) == (
        1920 * 1080 * 4 * 1 * 3 * (1 + 1 * 4))


def test_every_seed_does_the_same_work():
    """--seed orders the terrain's faces; the textures and the scene stay."""
    cfg = tiny().config
    a, b = textured.make_inputs(cfg, 1), textured.make_inputs(cfg, 2)
    for name in cfg["texture_order"]:
        assert (a["textures"][name] == b["textures"][name]).all()
    assert (a["vertices"] == b["vertices"]).all()
    assert not (a["faces"] == b["faces"]).all()
    assert sorted(map(tuple, a["faces"])) == sorted(map(tuple, b["faces"]))


def test_program_passes_the_check():
    res = harness.run(tiny(), SEED, 0.0, False, "cpu", time.perf_counter())
    assert res["correct"], res["check"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "rays_per_s"}
    assert res["check"]["bad_px_share"]["value"] == 0.0


@pytest.mark.parametrize("system", [faults.control_frames,
                                    *faults.FRAME_FAULTS.values()],
                         ids=["control", *faults.FRAME_FAULTS])
def test_control_and_faults_fail_the_check(system):
    res = harness.run(tiny(), SEED, 0.0, False, "cpu", time.perf_counter(),
                      make_system=system)
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 77, 2**40 + 3])
def test_reference_key_draws_the_program_key(seed):
    from solr_tpu_torch import Key

    port, mine = Key.seed(seed, "cpu"), ref_textured.Key.seed(seed, "cpu")
    assert port.state == mine.state
    for p, m in zip(port.split(4) + [port.fold_in(3)],
                    mine.split(4) + [mine.fold_in(3)]):
        assert p.state == m.state
        for shape in [(36, 2), (4, 36, 1, 3), (4, 36, 1, 1)]:
            assert torch.equal(p.uniform(shape), m.uniform(shape))
            assert torch.equal(p.normal(shape), m.normal(shape))
    # The shapes a frame draws, from the keys the frame draws them from.
    sample = port.split(4)[1]
    mine = mine.split(4)[1]
    assert torch.equal(sample.split(2)[0].uniform((36, 2)),
                       mine.split(2)[0].uniform((36, 2)))
    k_dir, k_rad = sample.split(3)[2].split(2)
    m_dir, m_rad = mine.split(3)[2].split(2)
    assert torch.equal(k_dir.normal((4, 36, 1, 3)), m_dir.normal((4, 36, 1,
                                                                  3)))
    assert torch.equal(k_rad.uniform((4, 36, 1, 1)),
                       m_rad.uniform((4, 36, 1, 1)))


def test_ambient_occlusion_taps_are_the_program_taps():
    from solr_tpu_torch.ops.postfx import _taps

    for samples in (4, 16, 32):
        assert ref_textured.ao_taps(samples, 8.0) == _taps(
            samples, 8.0, torch.float32)

"""The textured frame (BASELINE config #3) of the port held to the
benchmark's plain reference, ``solbench/reference/textured.py``, on the
CPU at a tiny size: the ``textured_mixed`` configuration with an
8-cell ground (128 triangles, still a BVH), 32 x 18 pixels (not whole
16 x 16 tiles, so the port walks and traces its rays in pixel order, as
the benchmark's 1080p frame does), through the benchmark's own
hand-over and check.  And the benchmark's frozen generator of the
scene equal to the port's ``textured_scene_parts``."""

import copy

import numpy as np
import pytest
import torch

from solbench import check, manifest, systems
from solbench.reference import textured as ref
from solbench.scenes import textured as kind
from solr_tpu_torch.textured_scene import textured_scene_parts

torch.set_num_threads(2)
CELL = "textured_mixed.spp4"
SEED = 2**31 + 97
# A pixel past this is an edge flip between float32 and float64, which
# this frame (large triangles, smooth maps) does not show at this size;
# the mean error over the rest is float32 rounding.
TOLERANCE, BAD_SHARE, MEAN_ERR = 0.02, 0.0, 2e-6

# (workload keys, render settings changed from the configuration's).
CASES = {
    "unkeyed_hard_shadows": ({"keyed": False, "spp": 1}, {}),
    "keyed_spp2_soft_jitter": ({"spp": 2}, {}),
    "fog_sky_off": ({"spp": 1}, {"fog": False, "sky_texture": -1}),
    "fog_on_sky_off": ({"spp": 1}, {"sky_texture": -1}),
    "ao_off": ({"spp": 1}, {"postfx": "NONE"}),
    "glass_1_bounce": ({"spp": 1, "bounces": 1}, {}),
    "glass_3_bounces": ({"spp": 1, "bounces": 3}, {}),
}


def tiny_cell(workload=None, settings=None):
    cell = manifest.Cell(CELL)
    cell.config = copy.deepcopy(cell.config)
    cell.config.update(kind.TINY)
    cell.config["render"].update(settings or {})
    cell.workload = dict(copy.deepcopy(cell.workload), width=32, height=18)
    cell.workload.update(workload or {})
    return cell


def frames(cell, seed=SEED):
    """(the port's frame, the reference's frame), (H * W, 3) each."""
    raw = cell.scene_kind.make_inputs(cell.config, seed)
    port = systems.PortFrames(cell, raw, "cpu", seed).frame()
    scene = cell.reference_kind.reference_scene(raw, cell.config, "cpu",
                                                torch.float64)
    want = systems.reference_frame(cell, scene, seed)
    return port[..., :3].reshape(-1, 3), want.reshape(-1, 3)


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_matches_plain_reference(case):
    workload, settings = CASES[case]
    got, want = frames(tiny_cell(workload, settings))
    numbers = check.frame_numbers(got, want, [0.0], TOLERANCE)
    assert numbers["bad_px_share"] <= BAD_SHARE, numbers
    assert numbers["mean_err"] <= MEAN_ERR, numbers


@pytest.mark.parametrize("settings", [
    {"fog": False}, {"sky_texture": -1}, {"postfx": "NONE"},
    {"antialias_jitter": False}, {"shadow_samples": 1}])
def test_each_setting_changes_the_reference_frame(settings):
    """Each render setting the cell states shows in the reference's
    frame, so the agreement above covers it."""
    cell = tiny_cell({"spp": 1})
    raw = cell.scene_kind.make_inputs(cell.config, SEED)
    scene = ref.reference_scene(raw, cell.config, "cpu", torch.float64)
    base = systems.reference_frame(cell, scene, SEED)
    changed = tiny_cell({"spp": 1}, settings)
    other = systems.reference_frame(changed, scene, SEED)
    assert (base - other).abs().amax() > 1e-3


def test_frozen_generator_equals_textured_scene_parts():
    cfg = dict(manifest.Cell(CELL).config, ground_res=12)
    raw = kind.make_inputs(cfg, 0)
    want = textured_scene_parts(cfg["texture_seed"], 12)
    assert list(cfg["texture_order"]) == list(want["texture_order"])
    for name in want["texture_order"]:
        np.testing.assert_array_equal(raw["textures"][name],
                                      want["textures"][name])
    np.testing.assert_array_equal(raw["vertices"], want["vertices"])
    np.testing.assert_array_equal(raw["uvs"], want["uvs"])
    # The faces as a set: the seed orders them.
    assert sorted(map(tuple, raw["faces"])) == sorted(map(tuple,
                                                          want["faces"]))


def _plain(x):
    """Tuples as lists and dict keys as strings, as JSON holds them."""
    if isinstance(x, dict):
        return {str(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return [_plain(v) for v in x]
    return x


def test_configuration_is_the_port_textured_scene():
    from solr_tpu_torch import PostFxMode, SceneInfo

    cfg = manifest.Cell(CELL).config
    want = textured_scene_parts()
    for key in ("terrain_material", "terrain_maps", "glass_materials",
                "glass_spheres", "glass_maps", "amber_material",
                "amber_maps", "ellipsoid", "mirror_material", "mirror_maps",
                "camera"):
        assert cfg[key] == _plain(want[key]), key
    axis, origin, half = want["mirror_plane"]
    assert cfg["mirror_plane"] == {"axis": axis.name,
                                   "origin": list(origin),
                                   "half_extents": list(half)}
    light = dict(cfg["light"])
    assert light.pop("color") == [1.0, 1.0, 1.0, 1.0]  # add_light's
    assert light == _plain(want["light"])
    info = SceneInfo.create(**want["info"], device="cpu")
    for key, value in cfg["info"].items():
        assert torch.equal(getattr(info, key),
                           torch.tensor(value, dtype=torch.float32)), key
    render = dict(cfg["render"])
    assert render.pop("postfx") == want["config"]["postfx_mode"].name
    assert want["config"]["postfx_mode"] == PostFxMode.AMBIENT_OCCLUSION
    assert render.pop("sky_texture") == list(
        want["texture_order"]).index(want["sky"])
    assert render == {k: v for k, v in want["config"].items()
                      if k != "postfx_mode"}
    assert cfg["gradient_background"] is False


def test_frames_differ_by_seed_only_in_draws_and_order():
    """--seed orders the terrain's faces and keys the frame: the unkeyed
    frame is the same image at every seed, up to rounding."""
    cell = tiny_cell({"keyed": False, "spp": 1})
    a, _ = frames(cell, 1)
    b, _ = frames(cell, 2)
    assert (a - b).abs().amax() < 1e-5

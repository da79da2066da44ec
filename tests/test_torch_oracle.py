"""The port's numpy float64 oracle (solr_tpu_torch.oracle) against
solr_tpu's, and the port's renderer against the port's oracle.

* ``oracle_render`` of the port on the reference scene, converted, must
  equal ``solr_tpu.oracle.oracle_render`` exactly: both compute in
  float64 from the same float32 values, in the same order.
* ``render_sample`` on the CPU against the port's oracle, by
  tests/test_render_vs_oracle.py's criterion (``assert_images_match``).
* chip_smoke.py's BASELINE config #1 scene, built by the port's
  SceneBuilder, equals tests/scenes_fixtures.py's ``cornell_box(8)``
  array by array.
"""

import dataclasses
import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import solr_tpu as st
from solr_tpu.oracle import oracle_render as ref_oracle_render

from data.torch_reference import numpy_tree
from scenes_fixtures import cornell_box, cornell_camera
from solr_tpu_torch.convert import (camera_from_numpy,
                                    config_from_reference_fields,
                                    scene_from_numpy)
from solr_tpu_torch.oracle import oracle_render
from solr_tpu_torch.ops.render import render_sample
from test_render_vs_oracle import assert_images_match
from test_torch_pools import ORACLE_CASES
from torch_scene_helpers import assert_same_camera, assert_same_scene

# Several test workers share the cores: keep each one's intra-op pool small.
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _reference_case(name):
    """(scene, camera, config) of an ORACLE_CASES case in solr_tpu, as
    tests/test_torch_pools.py's test_oracle_cases builds it."""
    make, size, bounces, extra = ORACLE_CASES[name]
    if name.startswith("cornell"):
        jscene, jcam = make().build(), cornell_camera()
    elif name == "mesh-tri-quad":
        jscene, jcam = make().build(), st.Camera.create(position=(0, 0, -2.0))
    else:
        jscene = make().build(bvh_threshold=64)
        jcam = st.Camera.create(position=(0, 0, -6.0), fov=1.0)
    jcfg = st.RenderConfig(width=size, height=size, max_bounces=bounces,
                           **extra)
    return jscene, jcam, jcfg


@functools.lru_cache(maxsize=None)
def _case(name):
    """The reference case and its port counterpart, with the port's
    oracle frame (computed once per case)."""
    jscene, jcam, jcfg = _reference_case(name)
    scene = scene_from_numpy(numpy_tree(jscene), "cpu")
    cam = camera_from_numpy(numpy_tree(jcam), "cpu")
    cfg = config_from_reference_fields(dataclasses.asdict(jcfg))
    return (jscene, jcam, jcfg), (scene, cam, cfg), oracle_render(scene, cam,
                                                                  cfg)


@pytest.mark.parametrize("name", sorted(ORACLE_CASES))
def test_oracle_equals_reference_oracle(name):
    (jscene, jcam, jcfg), _, got = _case(name)
    want = ref_oracle_render(jscene, jcam, jcfg)
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(ORACLE_CASES))
def test_render_sample_matches_oracle(name):
    _, (scene, cam, cfg), ref = _case(name)
    with torch.no_grad():
        img = render_sample(scene, cam, cfg)[0].numpy()
    assert_images_match(img, ref)


def test_config1_scene_equals_cornell_box():
    chip_smoke = _chip_smoke()
    scene, cam, cfg = chip_smoke.config1_scene(32, 32, device="cpu")
    assert_same_scene(scene, cornell_box(n_spheres=8).build())
    assert_same_camera(cam, cornell_camera())
    assert (cfg.width, cfg.height, cfg.max_bounces) == (32, 32, 2)


def test_config1_oracle_criterion():
    """chip_smoke.py's oracle phase at 32x32 on the CPU: the port's frame
    holds to the port's oracle by the numbers the phase reports; a frame
    with its four left columns inverted does not, nor does the frame
    rounded to half precision, which meets the reference's criterion
    alone."""
    chip_smoke = _chip_smoke()
    scene, cam, cfg = chip_smoke.config1_scene(32, 32, device="cpu")
    ref = oracle_render(scene, cam, cfg)
    with torch.no_grad():
        img = render_sample(scene, cam, cfg)[0].numpy()
    m = chip_smoke.oracle_mismatch(img, ref)
    assert chip_smoke.oracle_holds(m), m
    bad = img.copy()
    bad[:, :4, :3] = 1.0 - bad[:, :4, :3]
    assert not chip_smoke.oracle_holds(chip_smoke.oracle_mismatch(bad, ref))
    half = chip_smoke.oracle_mismatch(img.astype(np.float16), ref)
    assert half["outlier_share"] == 0.0
    assert half["inlier_mean"] < chip_smoke.ORACLE_MEAN_TOL
    assert not chip_smoke.oracle_holds(half)

"""The port's demo gallery (solr_tpu_torch.scenes) against solr_tpu's.

Every registered scene, made from seed 1 by both packages, must hold the
same pools, materials, lights, BVHs and camera, exactly: the geometry is
numpy on both sides.  Its frame at the viewer's settings (3 bounces,
mono) at 32x32 takes the packets where the scene has a triangle BVH (the
port's plain sweeps on the CPU) and is held to the committed solr_tpu
frame (tests/data/torch_gallery_ref.npz, written by
tests/data/torch_reference.py gallery) at atol 1e-4 outside 0.2% of
pixels (ROADMAP C1); so are the six 64x64 frames that the card is held
to.  The knot and the neuron are held to frames rendered op by op: the
reference's jitted frames contract their cylinder arithmetic into FMAs
(ROADMAP C12; 0.9% and 2.7% of pixels at 32x32).  The fractals scene's
marble sphere hashes sin(x) * 43758.5453 into value noise, so one ulp of
sin moves a texel (by up to 3e-3, the MARBLE bound of
tests/test_torch_ops.py PROC_TOL); in this frame 5 of 1,024 pixels pass
1e-4, the largest by 3.25e-4, and it is held at atol 5e-4.
"""

import numpy as np
import pytest
import torch

from solr_tpu.scenes import SCENE_REGISTRY as REF_REGISTRY
from solr_tpu.scenes import make_scene as ref_make_scene

from data.torch_reference import (GALLERY_BOUNCES, GALLERY_CARD_SCENES,
                                  GALLERY_CARD_SIZE, GALLERY_REF_FILE,
                                  GALLERY_SEED, GALLERY_SIZE)
from torch_scene_helpers import (assert_image_close, assert_same_camera,
                                 assert_same_scene)
from solr_tpu_torch.ops.render import render, render_sample
from solr_tpu_torch.scenes import SCENE_REGISTRY, make_scene
from solr_tpu_torch.types import RenderConfig

# Several test workers share the cores: keep each one's intra-op pool small.
torch.set_num_threads(2)

NAMES = sorted(REF_REGISTRY)
# Scenes whose pixels carry the value-noise hash: an atol above the
# largest reading (fractals: 3.25e-4 at 32x32, in 5 pixels past 1e-4).
NOISE_ATOL = {"fractals": 5e-4}


@pytest.fixture(scope="module")
def gallery_ref():
    return np.load(GALLERY_REF_FILE)


def test_registry_matches_reference():
    assert sorted(SCENE_REGISTRY) == NAMES
    assert len(NAMES) == 22


@pytest.mark.parametrize("name", NAMES)
def test_scene_matches_reference(name):
    ref = ref_make_scene(name, seed=GALLERY_SEED)
    port = make_scene(name, seed=GALLERY_SEED, device="cpu")
    assert_same_scene(port.scene, ref.scene)
    assert_same_camera(port.camera, ref.camera)


@pytest.mark.parametrize("name", NAMES)
def test_frame_matches_reference(name, gallery_ref):
    demo = make_scene(name, seed=GALLERY_SEED, device="cpu")
    sizes = [GALLERY_SIZE] + (
        [GALLERY_CARD_SIZE] if name in GALLERY_CARD_SCENES else [])
    for size in sizes:
        cfg = RenderConfig(width=size, height=size,
                           max_bounces=GALLERY_BOUNCES)
        with torch.no_grad():
            img = render(demo.scene, demo.camera, cfg).numpy()
        assert img[..., :3].std() > 1e-3, f"{name}: flat image"
        key = name if size == GALLERY_SIZE else f"{name}_{size}"
        assert_image_close(img, gallery_ref[key],
                           atol=NOISE_ATOL.get(name, 1e-4))


def test_animate_produces_distinct_frames():
    demo = make_scene("cubes", seed=1, device="cpu")
    cfg = RenderConfig(width=24, height=24, max_bounces=2)
    with torch.no_grad():
        i0, _ = render_sample(*demo.animate(0), cfg)
        i5, _ = render_sample(*demo.animate(5), cfg)
    assert float((i0 - i5).abs().max()) > 1e-3
    ref = ref_make_scene("cubes", seed=1)
    assert_same_camera(demo.animate(5)[1], ref.animate(5)[1])


@pytest.mark.parametrize("name", ["water", "metaballs", "perpetual",
                                  "carpet"])
def test_rebuilt_frames_match_reference(name):
    """Scenes that rebuild per frame keep the device and the reference's
    geometry."""
    port, _ = make_scene(name, seed=1, device="cpu").animate(3)
    ref, _ = ref_make_scene(name, seed=1).animate(3)
    assert port.device == torch.device("cpu")
    assert_same_scene(port, ref)

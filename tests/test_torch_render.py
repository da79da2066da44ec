"""The slice as a whole: solr_tpu_torch.render_sample against
solr_tpu.render_sample on the CPU (the reference takes its XLA path
there), and against the committed reference frame that chip_smoke.py
checks the card with.

Images agree to atol 1e-4 outside a budget of 0.2% of pixels.  The
pixels outside are discrete hit flips at triangle edges: the
reference's CPU build contracts the Woop and cross-product chains into
FMAs, the port rounds every product, so a ray passing within an ulp of
an edge can pick the neighbouring triangle (ROADMAP C1; measured 0.1%
of pixels at 64x64 on this scene).  The budget is kept apart from the
1% the numpy oracle is allowed.
"""

import dataclasses

import numpy as np
import pytest
import torch

import solr_tpu as st
from solr_tpu.ops import packet as jpk

from data.torch_reference import (CORNELL_REF_FILE, MOL_WHILE_REF_FILE,
                                  REF_FILE, WALK_REF_FILE, numpy_tree,
                                  reference_bench_scene, reference_render)
from scenes_fixtures import random_sphere_field, tri_quad_scene
from solr_tpu_torch.bench_scene import bench_scene, bench_scene_arrays
from solr_tpu_torch.cornell_scene import cornell_scene
from solr_tpu_torch.molecule_scene import molecule_scene
from solr_tpu_torch.convert import (camera_from_numpy, scene_from_numpy,
                                    config_from_reference_fields)
from solr_tpu_torch.ops.render import accumulate, render_sample

# Several test workers share the cores: keep each one's intra-op pool small.
torch.set_num_threads(2)

ATOL = 1e-4
BUDGET = 0.002
SIZE = 64
N_TRIS = 20_000


def assert_image_close(img, ref):
    img = np.asarray(img)
    assert img.shape == ref.shape
    assert np.isfinite(img).all()
    err = np.abs(img - ref).max(-1)
    frac = (err > ATOL).mean()
    assert frac <= BUDGET, f"{frac:.3%} of pixels differ by more than {ATOL}"


@pytest.fixture(scope="module")
def bench_ref():
    arrays = bench_scene_arrays(N_TRIS)
    scene, cam, cfg = reference_bench_scene(arrays, SIZE, SIZE, 2)
    return scene, cam, cfg, reference_render(scene, cam, cfg)


def test_bench_frame_matches_reference(bench_ref):
    """The port's own builder and bench scene, same arrays."""
    *_, ref = bench_ref
    scene, cam, cfg = bench_scene(N_TRIS, block=jpk.BLOCK, width=SIZE,
                                  height=SIZE, bounces=2, device="cpu")
    img, depth = render_sample(scene, cam, cfg)
    assert depth.shape == (SIZE, SIZE)
    assert_image_close(img.numpy(), ref)


def test_converted_bench_frame_matches_reference(bench_ref):
    """The reference's own scene, camera and config carried across."""
    jscene, jcam, jcfg, ref = bench_ref
    scene = scene_from_numpy(numpy_tree(jscene), "cpu")
    cam = camera_from_numpy(numpy_tree(jcam), "cpu")
    cfg = config_from_reference_fields(dataclasses.asdict(jcfg))
    img, _ = render_sample(scene, cam, cfg)
    assert_image_close(img.numpy(), ref)


def test_committed_reference_frame():
    """The frame chip_smoke.py holds the card to, on the CPU."""
    ref = np.load(REF_FILE)
    size = int(ref["size"])
    scene, cam, cfg = bench_scene(int(ref["n_tris"]), block=int(ref["block"]),
                                  width=size, height=size,
                                  bounces=int(ref["bounces"]), device="cpu")
    assert_image_close(render_sample(scene, cam, cfg)[0].numpy(), ref["image"])


def _walk_frame(ref):
    scene, cam, cfg = bench_scene(int(ref["n_tris"]), block=int(ref["block"]),
                                  width=int(ref["size"]),
                                  height=int(ref["height"]),
                                  bounces=int(ref["bounces"]), device="cpu")
    return scene, cam, cfg


def _molecule_while_frame(ref):
    scene, cam, cfg = molecule_scene(
        int(ref["n_atoms"]), int(ref["ground_res"]), width=int(ref["size"]),
        height=int(ref["size"]), bounces=int(ref["bounces"]),
        block=int(ref["block"]), device="cpu")
    return scene, cam, dataclasses.replace(cfg, traversal=str(ref["traversal"]))


def _cornell_frame(ref):
    return cornell_scene(int(ref["size"]), int(ref["size"]),
                         int(ref["bounces"]), device="cpu")


@pytest.mark.parametrize("path,make", [
    (WALK_REF_FILE, _walk_frame), (MOL_WHILE_REF_FILE, _molecule_while_frame),
    (CORNELL_REF_FILE, _cornell_frame)], ids=["walk", "molecule-while",
                                              "cornell"])
def test_committed_walk_and_cornell_frames(path, make):
    """The frames chip_smoke.py's walk_reference and cornell phases hold
    the card to, on the CPU: the bench frame at a height that is not a
    multiple of 16 (the triangle BVH walk), the molecule frame with
    traversal="while" (all three walks) and the port's own Cornell box
    against the gallery's (planes)."""
    ref = np.load(path)
    scene, cam, cfg = make(ref)
    assert_image_close(render_sample(scene, cam, cfg)[0].numpy(), ref["image"])


@pytest.mark.parametrize("name", ["quad", "spheres"])
def test_brute_force_scenes_match_reference(name):
    """Pools under the accelerator threshold: brute-force closest hit and
    shadows, reflections off the spheres."""
    builder = tri_quad_scene() if name == "quad" else random_sphere_field(20)
    jscene = builder.build(bvh_threshold=64)
    jcam = st.Camera.create(position=(0.0, 0.5, -4.0), fov=0.9)
    jcfg = st.RenderConfig(width=32, height=32, max_bounces=3,
                           gradient_background=True)
    ref = reference_render(jscene, jcam, jcfg)
    scene = scene_from_numpy(numpy_tree(jscene), "cpu")
    assert scene.tri_accel is None
    img, _ = render_sample(scene, camera_from_numpy(numpy_tree(jcam), "cpu"),
                           config_from_reference_fields(dataclasses.asdict(jcfg)))
    assert_image_close(img.numpy(), ref)


def test_accumulate_is_a_running_mean():
    a = torch.full((2, 2, 4), 0.25)
    s = torch.full((2, 2, 4), 1.0)
    out = accumulate(a, s, 3)
    torch.testing.assert_close(out, torch.full((2, 2, 4), (0.25 * 3 + 1) / 4))

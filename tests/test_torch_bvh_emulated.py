"""The CUDA BVH walk kernels, emulated on the CPU (tests/torch_sweep_helpers.py:
csrc/bvh_walk.cu built by the host's C++ compiler, one thread per CUDA
thread), against their plain PyTorch versions: t, idx, tr, node visits
and lane tests bit-equal, as on the card.  The emulation compiles
without FMA contraction, as nvcc does with --fmad=false, and runs the
kernels' own control flow: the skip-pointer walk, the leaf loop, the
in-leaf and cross-leaf tie rules, the ordered leaf product and the
early stop of a ray in full shadow.

All six entries (closest hit and transmittance for the triangle, sphere
and cylinder pools) run on the primary rays of a small frame and on
shadow rays toward its light, with fractional transparencies and
emissive occluders.  The tie cases duplicate every primitive, so a ray
meets equal t in one leaf or in two neighbouring leaves; the first copy
must win.  The card's own runs are tests/test_torch_gpu.py."""

import pytest
import torch

from solr_tpu_torch.constants import RAY_EPS
from solr_tpu_torch.molecule_scene import molecule_scene
from solr_tpu_torch.ops import bvh
from solr_tpu_torch.ops.camera import camera_rays
from solr_tpu_torch.ops.traverse import scene_closest_hit
from solr_tpu_torch.scene import SceneBuilder
from solr_tpu_torch.types import RenderConfig
from torch_bvh_helpers import (cross_leaf_pairs, fractional_materials,
                               shadow_rays_to_light, tie_scene)
from torch_sweep_helpers import build_emulated, compiler

# Several test workers share the cores: keep each one's intra-op pool small.
torch.set_num_threads(2)

SIZE = 24  # 576 rays: 5 emulated CTAs of 128 threads per launch
BVH_OF = {"tri": "tri_bvh", "sphere": "sph_bvh", "cyl": "cyl_bvh"}


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if compiler() is None:
        pytest.skip("needs a C++17 compiler to build the emulation")
    return bvh.load_library(build_emulated(bvh._SRC,
                                           tmp_path_factory.mktemp("emu")))


def _no_stream(monkeypatch):
    class Stream:
        cuda_stream = 0
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Stream())


@pytest.fixture(scope="module")
def molecule():
    """A small ball-and-stick molecule over a ground: all three pools
    have BVHs; fractional transparencies, the light emissive."""
    scene, cam, _ = molecule_scene(300, 6, width=SIZE, height=SIZE,
                                   device="cpu")
    cfg = RenderConfig(width=SIZE, height=SIZE)
    return fractional_materials(scene), cam, cfg


def _rays(scene, cam, cfg):
    o, d = camera_rays(cam, cfg)
    hit = scene_closest_hit(scene, o, d, use_bvh=True)
    return (o, d) + shadow_rays_to_light(scene, o, d, hit)


def _closest_equal(monkeypatch, lib, scene, prim, o, d):
    _no_stream(monkeypatch)
    tree = getattr(scene, BVH_OF[prim])
    got = bvh.launch_closest(lib, scene, tree, prim, o, d, RAY_EPS)
    want = bvh.bvh_closest_hit_plain(scene, tree, prim, o, d, RAY_EPS)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    return want


@pytest.mark.parametrize("prim", bvh.PRIMS)
def test_emulated_closest(emulated, monkeypatch, molecule, prim):
    scene, cam, cfg = molecule
    o, d, _, _, _ = _rays(scene, cam, cfg)
    t, _, visits, tests = _closest_equal(monkeypatch, emulated, scene, prim,
                                         o, d)
    assert (t < 1e30).sum() > 20 and int(tests.sum()) > 0
    assert int(visits.max()) > 3


@pytest.mark.parametrize("rays", ["shadow", "camera"])
@pytest.mark.parametrize("prim", bvh.PRIMS)
def test_emulated_transmittance(emulated, monkeypatch, molecule, prim, rays):
    """Shadow rays toward the light, and camera rays to t_max = 100,
    which cross the ground and the molecule."""
    scene, cam, cfg = molecule
    o, d, so, sd, tm = _rays(scene, cam, cfg)
    if rays == "camera":
        so, sd, tm = o, d, torch.full(o.shape[:1], 100.0)
    _no_stream(monkeypatch)
    tree = getattr(scene, BVH_OF[prim])
    got = bvh.launch_transmittance(emulated, scene, tree, prim, so, sd,
                                   RAY_EPS, tm)
    want = bvh.bvh_transmittance_plain(scene, tree, prim, so, sd, RAY_EPS, tm)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    tr = want[0]
    # The ground lies under the molecule and its light: no shadow ray
    # crosses it.
    if rays == "camera" or prim != "tri":
        assert ((tr > 0.0) & (tr < 1.0)).any()


@pytest.mark.parametrize("prim", bvh.PRIMS)
def test_emulated_closest_ties(emulated, monkeypatch, prim):
    """Every primitive twice: the first copy wins, within a leaf and
    across neighbouring leaves."""
    scene, o, d = tie_scene(prim, SIZE)
    tree = getattr(scene, BVH_OF[prim])
    t, idx, _, _ = _closest_equal(monkeypatch, emulated, scene, prim, o, d)
    hit = t < 1e30
    assert hit.sum() > 50
    assert (idx[hit] % 2 == 0).all()
    assert cross_leaf_pairs(tree, idx[hit]) > 0


def test_emulated_full_shadow_stops(emulated, monkeypatch):
    """Opaque occluders: the walk stops once a ray's transmittance is
    <= 1e-6, so it visits fewer nodes than an unshadowed walk would."""
    b = SceneBuilder()
    m = b.add_material(transparency=0.0)
    for i in range(80):
        b.add_sphere((0.02 * i, 0.0, 2.0 + 0.3 * i), 0.5, m)
    scene = b.build(device="cpu")
    o = torch.zeros(64, 3)
    d = torch.tensor([0.0, 0.0, 1.0]).expand(64, 3).contiguous()
    tm = torch.full((64,), 100.0)
    _no_stream(monkeypatch)
    got = bvh.launch_transmittance(emulated, scene, scene.sph_bvh, "sphere",
                                   o, d, RAY_EPS, tm)
    want = bvh.bvh_transmittance_plain(scene, scene.sph_bvh, "sphere", o, d,
                                       RAY_EPS, tm)
    for a, b_ in zip(got, want):
        assert torch.equal(a, b_)
    assert (want[0] == 0.0).all()
    assert int(want[1].max()) < scene.sph_bvh.n_nodes


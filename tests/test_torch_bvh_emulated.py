"""The CUDA BVH walk kernels, emulated on the CPU (tests/torch_sweep_helpers.py:
csrc/bvh_walk.cu built by the host's C++ compiler, one thread per CUDA
thread), against their plain PyTorch versions: t, idx, tr, node visits
and lane tests bit-equal, as on the card.  The emulation compiles
without FMA contraction, as nvcc does with --fmad=false, and runs the
kernels' own control flow: the packed pair walk with its stack over a
triangle, sphere or cylinder leaf test (the closest hit near child
first or left child first; DFS order for the shadow walk), the leaf
loop, the in-leaf and cross-leaf tie rules, the ordered leaf product
and the early stop of a ray in full shadow.

All six entries (closest hit and transmittance for the triangle, sphere
and cylinder pools) run on the primary rays of a small frame and on
shadow rays toward its light, with fractional transparencies and
emissive occluders.  The closest hits are held to the plain walk of
their order on all four outputs and to the DFS walk on t and idx, in
the dispatch's order (bvh.walks_near_first: triangles near child first
on a fresh tree, spheres and cylinders left child first) and in the
other.  The tie cases duplicate every primitive, so a ray meets equal t
in one leaf or in two neighbouring leaves; the first copy must win,
also where the near-first walk reaches the second copy first.  The
card's own runs are tests/test_torch_gpu.py."""

import numpy as np
import pytest
import torch

from solr_tpu_torch.constants import POOL_TRIANGLE, RAY_EPS
from solr_tpu_torch.molecule_scene import molecule_scene
from solr_tpu_torch.ops import bvh
from solr_tpu_torch.ops.camera import camera_rays
from solr_tpu_torch.ops.pools import BY_PRIM
from solr_tpu_torch.ops.traverse import scene_closest_hit
from solr_tpu_torch.scene import SceneBuilder
from solr_tpu_torch.types import RenderConfig
from torch_bvh_helpers import (STALE_ROW, cross_leaf_pairs, cyl_field,
                               fractional_materials, near_second_tie_cyl_scene,
                               near_second_tie_scene, shadow_rays_to_light,
                               sphere_field, tie_scene, tri_field,
                               two_leaf_stale)
from torch_sweep_helpers import build_emulated, compiler

# Several test workers share the cores: keep each one's intra-op pool small.
torch.set_num_threads(2)

SIZE = 24  # 576 rays: 5 emulated CTAs of 128 threads per launch
BVH_OF = {"tri": "tri_bvh", "sphere": "sph_bvh", "cyl": "cyl_bvh"}


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if compiler() is None:
        pytest.skip("needs a C++17 compiler to build the emulation")
    return bvh.load_library(build_emulated(bvh.LIBRARY.src,
                                           tmp_path_factory.mktemp("emu")))


@pytest.fixture(autouse=True)
def ieee_sqrt(monkeypatch):
    """The plain walks here take a correctly rounded float32 square root,
    as torch.sqrt on the card and the kernels' sqrtf are: torch's CPU
    sqrt in float32 is one ulp off in about 0.7% of inputs (near a
    halfway case), which moves a sphere's root on one ray of
    test_emulated_sphere_field.  Through float64 the rounding is exact
    (53 >= 2 x 24 + 2 bits)."""
    sqrt = torch.sqrt

    def exact(x, *args, **kwargs):
        if x.dtype == torch.float32 and not args and not kwargs:
            return sqrt(x.double()).float()
        return sqrt(x, *args, **kwargs)

    monkeypatch.setattr(torch, "sqrt", exact)


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


def _closest_equal(monkeypatch, lib, scene, prim, o, d, tree=None,
                   near_first=None):
    """The kernel against the plain walk of its order (near child first
    or left child first; by default the dispatch's,
    bvh.walks_near_first) on all four outputs and against the DFS walk
    on t and idx; returns the plain walk's outputs."""
    _no_stream(monkeypatch)
    tree = getattr(scene, BVH_OF[prim]) if tree is None else tree
    if near_first is None:
        near_first = bvh.walks_near_first(scene, tree, prim)
    got = bvh.launch_closest(lib, scene, tree, prim, o, d, RAY_EPS,
                             near_first=near_first)
    dfs = bvh.bvh_closest_hit_plain(scene, tree, prim, o, d, RAY_EPS)
    for a, b in zip(got[:2], dfs[:2]):  # t, idx
        assert torch.equal(a, b)
    want = bvh.bvh_closest_hit_ordered_plain(scene, tree, prim, o, d,
                                             RAY_EPS, near_first=near_first)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    return want


def _trans_equal(monkeypatch, lib, scene, prim, o, d, tm, tree=None):
    """The shadow kernel against the DFS plain walk: tr, visits, tests."""
    _no_stream(monkeypatch)
    tree = getattr(scene, BVH_OF[prim]) if tree is None else tree
    got = bvh.launch_transmittance(lib, scene, tree, prim, o, d, RAY_EPS, tm)
    want = bvh.bvh_transmittance_plain(scene, tree, prim, o, d, RAY_EPS, tm)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    return want


@pytest.mark.parametrize("prim", bvh.PRIMS)
def test_emulated_closest(emulated, monkeypatch, molecule, prim):
    """In the dispatch's order and in the other."""
    scene, cam, cfg = molecule
    o, d, _, _, _ = _rays(scene, cam, cfg)
    t, _, visits, tests = _closest_equal(monkeypatch, emulated, scene, prim,
                                         o, d)
    assert (t < 1e30).sum() > 20 and int(tests.sum()) > 0
    assert int(visits.max()) > 3
    other = not bvh.walks_near_first(scene, getattr(scene, BVH_OF[prim]),
                                     prim)
    _closest_equal(monkeypatch, emulated, scene, prim, o, d,
                   near_first=other)


@pytest.mark.parametrize("rays", ["shadow", "camera"])
@pytest.mark.parametrize("prim", bvh.PRIMS)
def test_emulated_transmittance(emulated, monkeypatch, molecule, prim, rays):
    """Shadow rays toward the light, and camera rays to t_max = 100,
    which cross the ground and the molecule."""
    scene, cam, cfg = molecule
    o, d, so, sd, tm = _rays(scene, cam, cfg)
    if rays == "camera":
        so, sd, tm = o, d, torch.full(o.shape[:1], 100.0)
    tr = _trans_equal(monkeypatch, emulated, scene, prim, so, sd, tm)[0]
    # The ground lies under the molecule and its light: no shadow ray
    # crosses it.
    if rays == "camera" or prim != "tri":
        assert ((tr > 0.0) & (tr < 1.0)).any()


@pytest.mark.parametrize("prim", bvh.PRIMS)
def test_emulated_closest_ties(emulated, monkeypatch, prim):
    """Every primitive twice: the first copy wins, within a leaf and
    across neighbouring leaves, in either order."""
    scene, o, d = tie_scene(prim, SIZE)
    tree = getattr(scene, BVH_OF[prim])
    for near_first in (True, False):
        t, idx, _, _ = _closest_equal(monkeypatch, emulated, scene, prim, o,
                                      d, near_first=near_first)
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



def test_emulated_tri_tie_reached_second_first(emulated, monkeypatch):
    """The near-first walk enters the right leaf first (its box is the
    nearer), which holds the shared triangle's second copy; the tie rule
    must still give the first copy, as the DFS walk does."""
    scene, o, d = near_second_tie_scene()
    tree = scene.tri_bvh
    assert tree.first_prim.tolist() == [-1, 0, 8]
    v = scene.triangles
    assert all(torch.equal(x[7], x[8]) for x in (v.v0, v.v1, v.v2))
    lo = tree.aabb_min[1:, 2]
    assert lo[1] < lo[0]  # the right leaf's box starts nearer along +z
    t, idx, _, tests = _closest_equal(monkeypatch, emulated, scene, "tri",
                                      o, d, near_first=True)
    assert (t == 5.0).all() and (idx == 7).all()
    assert (tests == 16).all()  # both leaves tested


def test_emulated_cyl_tie_reached_second_first(emulated, monkeypatch):
    """The cylinder case of test_emulated_tri_tie_reached_second_first,
    near child first (which the dispatch does not take for cylinders):
    the shared cylinder's first copy ends the left leaf, its second
    starts the right leaf, whose box is the nearer."""
    scene, o, d = near_second_tie_cyl_scene()
    tree = scene.cyl_bvh
    assert tree.first_prim.tolist() == [-1, 0, 8]
    c = scene.cylinders
    assert all(torch.equal(x[7], x[8]) for x in (c.p0, c.p1, c.radius))
    lo = tree.aabb_min[1:, 2]
    assert lo[1] < lo[0]  # the right leaf's box starts nearer along +z
    t, idx, _, tests = _closest_equal(monkeypatch, emulated, scene, "cyl",
                                      o, d, near_first=True)
    assert (t < 1e30).all() and (idx == 7).all()
    assert (tests == 16).all()  # both leaves tested


@pytest.fixture(scope="module")
def field():
    return tri_field()


@pytest.fixture(scope="module")
def cfield():
    return cyl_field()


def test_emulated_cyl_field(emulated, monkeypatch, cfield):
    """test_emulated_tri_field on a 1,200-cylinder field (8 levels) with
    576 rays; the closest hit in both orders."""
    scene, o, d = cfield
    assert scene.cyl_bvh.max_depth >= 7
    t = _closest_equal(monkeypatch, emulated, scene, "cyl", o, d)[0]
    assert (t < 1e30).sum() > 500
    _closest_equal(monkeypatch, emulated, scene, "cyl", o, d,
                   near_first=True)
    tm = torch.full(o.shape[:1], 100.0)
    tr, vis, _ = _trans_equal(monkeypatch, emulated, scene, "cyl", o, d, tm)
    assert (tr == 0.0).sum() > 200 and ((tr > 0.0) & (tr < 1.0)).sum() > 150
    trans = scene.materials.transparency
    clear = scene.replace(materials=scene.materials.replace(
        transparency=torch.where(trans == 0.0, 0.5, trans)))
    _, vis_all, _ = _trans_equal(monkeypatch, emulated, clear, "cyl", o, d,
                                 tm)
    assert (vis[tr == 0.0] < vis_all[tr == 0.0]).float().mean() > 0.5


@pytest.mark.parametrize("prim", bvh.PRIMS)
def test_emulated_dfs_order_on_stale_tree(emulated, monkeypatch, prim):
    """A far-leaf primitive moved in front of the near leaf without a
    refit (two_leaf_stale; ROADMAP C14): the kernel in the DFS walk's
    order, the dispatch's on a stale tree, returns the DFS walk's hit,
    the moved row, and counts as the plain walk of its order; the
    near-first kernel, as its plain walk, returns the near leaf's.  Each
    tests one leaf and prunes the other."""
    scene, o, d = two_leaf_stale(prim)
    tree = getattr(scene, BVH_OF[prim])
    assert not bvh.leaf_boxes_hold(scene, tree, prim)
    assert not bvh.walks_near_first(scene, tree, prim)
    _, idx, _, tests = _closest_equal(monkeypatch, emulated, scene, prim, o,
                                      d, near_first=False)
    assert (idx == STALE_ROW).all() and (tests == 8).all()
    got = bvh.launch_closest(emulated, scene, tree, prim, o, d, RAY_EPS,
                             near_first=True)
    want = bvh.bvh_closest_hit_ordered_plain(scene, tree, prim, o, d,
                                             RAY_EPS)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (got[1] == 8).all() and (got[3] == 8).all()


def test_emulated_layouts_one_per_pool(emulated, monkeypatch, molecule):
    """The packed layouts are cached per pool, and so is the leaf-box
    check, which only the triangle tree takes: a triangle, cylinder,
    sphere, triangle, cylinder, sphere sequence packs each pool once and
    checks the triangle tree once."""
    scene, cam, cfg = molecule
    o, d = camera_rays(cam, cfg)
    packed, checked = [], []
    for name in ("pack_nodes", "pack_triangles", "pack_cylinders",
                 "pack_spheres"):
        fn = getattr(bvh, name)
        monkeypatch.setattr(bvh, name, lambda *a, _fn=fn, _n=name: (
            packed.append(_n), _fn(*a))[1])
    fn = bvh.outside_leaf_boxes
    monkeypatch.setattr(bvh, "outside_leaf_boxes", lambda *a: (
        checked.append(a[2]), fn(*a))[1])
    monkeypatch.setattr(bvh, "_DERIVED", {})
    for prim in ("tri", "cyl", "sphere") * 2:
        _closest_equal(monkeypatch, emulated, scene, prim, o, d)
        code = BY_PRIM[prim].code
        bvh.bvh_closest_hit(scene, getattr(scene, BVH_OF[prim]), code, o, d,
                            RAY_EPS)
    assert packed == ["pack_nodes", "pack_triangles", "pack_nodes",
                      "pack_cylinders", "pack_nodes", "pack_spheres"]
    assert checked == ["tri"]


@pytest.fixture(scope="module")
def sfield():
    return sphere_field()


def test_emulated_sphere_field(emulated, monkeypatch, sfield):
    """A 1,500-sphere field (8 levels), 64 of its 576 rays starting inside
    a sphere (they take its exit root): the closest hit against both
    plain walks in both orders, and the shadow walk with opaque,
    fractional and emissive occluders, where many rays stop at an
    opaque leaf, against the DFS walk with its counts.  Then the two
    most hit spheres' radii set to 0 and to minus their radius through
    Scene.replace (the tree keeps their boxes): neither hits nor
    occludes."""
    scene, o, d, inside = sfield
    assert scene.sph_bvh.max_depth >= 7
    t, idx = _closest_equal(monkeypatch, emulated, scene, "sphere", o, d)[:2]
    _closest_equal(monkeypatch, emulated, scene, "sphere", o, d,
                   near_first=True)
    assert (t < 1e30).sum() > 500
    # A ray from a centre leaves its sphere (radius <= 0.25) by t = r.
    assert (t[inside] <= 0.25).all()
    p = scene.spheres
    tm = torch.full(o.shape[:1], 100.0)
    tr, vis, _ = _trans_equal(monkeypatch, emulated, scene, "sphere", o, d,
                              tm)
    assert (tr == 0.0).sum() > 200 and ((tr > 0.0) & (tr < 1.0)).sum() > 150
    trans = scene.materials.transparency
    clear = scene.replace(materials=scene.materials.replace(
        transparency=torch.where(trans == 0.0, 0.5, trans)))
    _, vis_all, _ = _trans_equal(monkeypatch, emulated, clear, "sphere", o,
                                 d, tm)
    assert (vis[tr == 0.0] < vis_all[tr == 0.0]).float().mean() > 0.5
    # The two most hit spheres, at radius 0 and -r.
    hits, rows = torch.bincount(idx[t < 1e30]).topk(2)
    assert (hits > 1).all()
    radius = p.radius.clone()
    radius[rows] = torch.stack([torch.zeros(()), -radius[rows[1]]])
    gone = scene.replace(spheres=p.replace(radius=radius))
    t0, idx0 = _closest_equal(monkeypatch, emulated, gone, "sphere", o,
                              d)[:2]
    assert not torch.isin(idx0[t0 < 1e30], rows).any()
    was = torch.isin(idx, rows) & (t < 1e30)
    assert (t0[was] > t[was]).all()
    _trans_equal(monkeypatch, emulated, gone, "sphere", o, d, tm)


def test_emulated_tri_field(emulated, monkeypatch, field):
    """A 1,500-triangle field (8 levels): the closest hit against both
    plain walks, and the shadow walk with opaque, fractional and
    emissive occluders, where many rays stop at an opaque leaf before
    the DFS walk's end, against the DFS walk with its counts."""
    scene, o, d = field
    assert scene.tri_bvh.max_depth >= 7
    t = _closest_equal(monkeypatch, emulated, scene, "tri", o, d)[0]
    assert (t < 1e30).sum() > 1000
    tm = torch.full(o.shape[:1], 100.0)
    tr, vis, _ = _trans_equal(monkeypatch, emulated, scene, "tri", o, d, tm)
    assert (tr == 0.0).sum() > 500 and ((tr > 0.0) & (tr < 1.0)).sum() > 500
    # The stopped rays visit fewer nodes than the same walk to its end.
    trans = scene.materials.transparency
    clear = scene.replace(materials=scene.materials.replace(
        transparency=torch.where(trans == 0.0, 0.5, trans)))
    _, vis_all, _ = _trans_equal(monkeypatch, emulated, clear, "tri", o, d, tm)
    assert (vis[tr == 0.0] < vis_all[tr == 0.0]).float().mean() > 0.5


def test_emulated_tri_layouts_follow_the_scene(emulated, monkeypatch, field):
    """The kernels' packed nodes and triangles are derived again when a
    source changes: after a with_params step that moves the vertices
    (refresh_accel; the BVH keeps its boxes, ROADMAP C9), after
    bvh_refit, and after an in-place write to a vertex array, the
    emulated kernels agree with the plain walks on the moved scene: the
    near-first kernel with the near-first walk, and on the stale tree
    the DFS-order kernel with the DFS walk (on 576 of the rays)."""
    scene, o, d = field
    tm = torch.full(o.shape[:1], 100.0)
    before = _closest_equal(monkeypatch, emulated, scene, "tri", o, d)
    params = scene.params
    shift = torch.as_tensor(np.random.default_rng(4).normal(
        0.0, 0.05, params["vertices"][0].shape), dtype=torch.float32)
    params["vertices"] = tuple(v + shift for v in params["vertices"])
    moved = scene.with_params(params)
    _no_stream(monkeypatch)
    got = bvh.launch_closest(emulated, moved, moved.tri_bvh, "tri", o, d,
                             RAY_EPS)
    want = bvh.bvh_closest_hit_ordered_plain(moved, moved.tri_bvh, "tri", o,
                                             d, RAY_EPS)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not torch.equal(got[0], before[0])
    assert not bvh.leaf_boxes_hold(moved, moved.tri_bvh, "tri")
    _closest_equal(monkeypatch, emulated, moved, "tri", o[:576], d[:576],
                   near_first=False)
    _trans_equal(monkeypatch, emulated, moved, "tri", o, d, tm)
    # The boxes refitted to the moved triangles: both orders agree again.
    refit = bvh.bvh_refit(moved.tri_bvh, *(torch.as_tensor(x) for x in
                                           bvh.pool_aabbs(moved,
                                                          POOL_TRIANGLE)))
    assert bvh.leaf_boxes_hold(moved, refit, "tri")
    _closest_equal(monkeypatch, emulated, moved, "tri", o, d, tree=refit)
    _trans_equal(monkeypatch, emulated, moved, "tri", o, d, tm, tree=refit)
    # An in-place write to the same tensor (its version moves).
    v2 = moved.triangles.v2
    v2.add_(0.01)
    got = bvh.launch_closest(emulated, moved, refit, "tri", o, d, RAY_EPS)
    want = bvh.bvh_closest_hit_ordered_plain(moved, refit, "tri", o, d,
                                             RAY_EPS)
    for a, b in zip(got, want):
        assert torch.equal(a, b)

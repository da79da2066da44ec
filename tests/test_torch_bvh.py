"""The port's BVH module (solr_tpu_torch/ops/bvh.py) against solr_tpu's
on the CPU: the build, the refit, the pool bounds, both walks, and the
walk against the brute force.

Tolerances, from what differs between the two CPU builds:
* The build and the refit are exact: numpy on both sides, min and max
  are exact, and the box padding is one float32 subtraction.
* The walks share the reference's node arrays and visit order, and test
  leaves with the pool tests of tests/test_torch_ops.py.  In float32, XLA
  contracts a*b + c into FMAs and the port rounds each product: t at
  rtol 1e-6 for triangles; for spheres and capped cylinders at rtol
  5e-4, the cylinder bound of tests/test_torch_ops.py, since the walk's
  rays include grazing ones, where the roots' cancellation in
  -b -+ sqrt(disc) magnifies the last bits (measured 1.5e-5 for a
  sphere); hit/miss agreeing on more than 99.9% of the rays (a grazing
  ray may flip).  In float64 those differences vanish and both walks
  agree on every ray: idx exactly, t and the transmittance at rtol
  1e-6.
* Transmittance multiplies a leaf's factors in ascending lane order, the
  reference with jnp.prod (ROADMAP C3): rtol 1e-6 with fractional
  factors.
* A stale tree (ROADMAP C14): with_params moves triangles out of their
  leaf boxes without a refit, in both packages.  The reference walks in
  DFS order; the port must return its hit, as above.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import solr_tpu as st
from solr_tpu.ops import bvh as jbvh

from data.torch_reference import numpy_tree
from scenes_fixtures import random_sphere_field, random_tri_field
from torch_bvh_helpers import (FIELD_MATERIALS, STALE_ROW, add_two_leaves,
                               move_pool, stale_shift, tri_field_arrays,
                               two_leaf_rays)
from solr_tpu_torch.bench_scene import bench_scene_arrays
from solr_tpu_torch.constants import RAY_EPS
from solr_tpu_torch.convert import (camera_from_numpy, config_from_reference_fields,
                                    scene_from_numpy)
from solr_tpu_torch.ops import bvh
from solr_tpu_torch.ops.render import render_sample

# Several test workers share the cores: keep each one's intra-op pool small.
torch.set_num_threads(2)

FIELDS = ("aabb_min", "aabb_max", "skip", "first_prim", "prim_count",
          "depth", "leaf_center", "leaf_radius", "leaf_first", "leaf_count")
BVH_OF = {0: "sph_bvh", 1: "tri_bvh", 2: "cyl_bvh"}
PRIM_OF = {0: "sphere", 1: "tri", 2: "cyl"}
RTOL_F32 = {0: 5e-4, 1: 1e-6, 2: 5e-4}


def _assert_same_bvh(port, ref):
    for f in FIELDS:
        a, b = np.asarray(getattr(ref, f)), getattr(port, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert (port.max_depth, port.leaf_size) == (ref.max_depth, ref.leaf_size)


def _terrain_aabbs():
    a = bench_scene_arrays(20_000)
    v = a["vertices"][a["faces"]]
    return v.min(1), v.max(1)


def _random_aabbs(n):
    c = np.random.default_rng(n).uniform(-5, 5, (n, 3)).astype(np.float32)
    return c - 0.1, c + 0.3


@pytest.mark.parametrize("backend", ["numpy", "auto"])
@pytest.mark.parametrize("case", ["1", "9", "17", "777", "terrain"])
def test_build_matches_reference(case, backend):
    """Node arrays and order of the port's builder (native) and of its
    plain version (numpy) equal to both reference builders ("auto"
    takes its native LBVH)."""
    amin, amax = _terrain_aabbs() if case == "terrain" else _random_aabbs(
        int(case))
    ref, ref_order = jbvh.build_bvh(amin, amax, 8, backend=backend)
    for build in (bvh.build_bvh, bvh.build_bvh_plain):
        port, order = build(amin, amax, 8, device="cpu")
        np.testing.assert_array_equal(order, ref_order)
        _assert_same_bvh(port, ref)


def _scenes(kind, f64=False, ties=False):
    """A reference scene with a BVH on the pool of ``kind``, fractional
    transparencies and one emissive material, and the port's copy."""
    rng = np.random.default_rng(3)
    b = st.SceneBuilder()
    mats = [b.add_material(color=(0.8, 0.7, 0.6, 1.0),
                           transparency=float(rng.uniform(0.35, 0.95)),
                           emission=0.5 if i == 2 else 0.0)
            for i in range(4)]
    n = 150
    c = rng.uniform(-2.0, 2.0, (n, 3)) + [0.0, 0.0, 6.0]
    for i in range(n):
        m = mats[i % 4]
        for _ in range(2 if ties else 1):
            if kind == "tri":
                b.add_triangle(c[i], c[i] + [0.6, 0.1, 0.2],
                               c[i] + [0.1, 0.7, -0.2], m)
            elif kind == "sphere":
                b.add_sphere(c[i], 0.2 + 0.2 * (i % 3), m)
            else:
                b.add_cylinder(c[i], c[i] + [0.4, 0.5 * (i % 2), 0.2], 0.12, m)
    scene = b.build(bvh_threshold=64)
    if f64:
        scene = jax.tree.map(lambda x: x.astype(jnp.float64)
                             if jnp.issubdtype(x.dtype, jnp.floating) else x,
                             scene)
    port = scene_from_numpy(numpy_tree(scene), "cpu",
                            torch.float64 if f64 else torch.float32)
    return scene, port


def _rays(dtype, n=1500):
    """Rays from a box in front of the field into it."""
    rng = np.random.default_rng(5)
    o = rng.uniform(-1, 1, (n, 3)) + [0.0, 0.0, 1.0]
    d = rng.uniform(-2.2, 2.2, (n, 3)) + [0.0, 0.0, 6.0] - o
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(dtype), d.astype(dtype)


CASES = [(code, f64, ties) for code in (0, 1, 2) for f64 in (False, True)
         for ties in (False, True)]
IDS = [f"{PRIM_OF[c]}-{'f64' if f else 'f32'}{'-ties' if t else ''}"
       for c, f, t in CASES]


@pytest.mark.parametrize("code,f64,ties", CASES, ids=IDS)
def test_closest_walk_matches_reference(code, f64, ties):
    ref_scene, scene = _scenes(PRIM_OF[code], f64, ties)
    o, d = _rays(np.float64 if f64 else np.float32)
    jt, ji = jbvh.bvh_closest_hit(ref_scene, getattr(ref_scene, BVH_OF[code]),
                                  code, jnp.asarray(o), jnp.asarray(d),
                                  RAY_EPS, 3e38)
    t, i = bvh.bvh_closest_hit(scene, getattr(scene, BVH_OF[code]), code,
                               torch.from_numpy(o), torch.from_numpy(d),
                               RAY_EPS)
    jt, ji, t, i = np.asarray(jt), np.asarray(ji), t.numpy(), i.numpy()
    hit = jt < 1e30
    assert hit.sum() > 200
    if f64:
        np.testing.assert_array_equal(t < 1e30, hit)
        np.testing.assert_array_equal(i, ji)
        np.testing.assert_allclose(t[hit], jt[hit], rtol=1e-6)
    else:
        both = hit & (t < 1e30)
        assert (both == hit).mean() > 0.999
        np.testing.assert_allclose(t[both], jt[both], rtol=RTOL_F32[code])
    if ties:  # every primitive twice: the first copy wins
        assert (i[hit] % 2 == 0).all()


@pytest.mark.parametrize("code,f64,ties", CASES, ids=IDS)
def test_ordered_walk_matches_dfs_walk(code, f64, ties):
    """The near-first walk (the packed kernels' order, plain) returns
    the DFS walk's t and idx on every ray, ties included, and both count
    1 + 2 per entered inner node; in the DFS walk's order
    (``near_first=False``) it returns all four outputs of the DFS
    walk."""
    _, scene = _scenes(PRIM_OF[code], f64, ties)
    o, d = (torch.from_numpy(x) for x in _rays(np.float64 if f64
                                                else np.float32))
    tree = getattr(scene, BVH_OF[code])
    dfs = bvh.bvh_closest_hit_plain(scene, tree, PRIM_OF[code], o, d,
                                    RAY_EPS)
    near = bvh.bvh_closest_hit_ordered_plain(scene, tree, PRIM_OF[code], o,
                                             d, RAY_EPS)
    assert torch.equal(near[0], dfs[0]) and torch.equal(near[1], dfs[1])
    assert (dfs[0] < 1e30).sum() > 200
    assert ((near[2] - 1) % 2 == 0).all() and ((dfs[2] - 1) % 2 == 0).all()
    in_order = bvh.bvh_closest_hit_ordered_plain(
        scene, tree, PRIM_OF[code], o, d, RAY_EPS, near_first=False)
    assert all(torch.equal(a, b) for a, b in zip(in_order, dfs))


@pytest.mark.parametrize("code,f64", [(c, f) for c in (0, 1, 2)
                                      for f in (False, True)],
                         ids=[f"{PRIM_OF[c]}-{'f64' if f else 'f32'}"
                              for c in (0, 1, 2) for f in (False, True)])
def test_transmittance_walk_matches_reference(code, f64):
    """Fractional factors, and emissive occluders (factor 1)."""
    ref_scene, scene = _scenes(PRIM_OF[code], f64)
    o, d = _rays(np.float64 if f64 else np.float32)
    tm = np.random.default_rng(7).uniform(2.0, 12.0, o.shape[0]).astype(o.dtype)
    jtr = jbvh.bvh_transmittance(ref_scene, getattr(ref_scene, BVH_OF[code]),
                                 code, jnp.asarray(o), jnp.asarray(d),
                                 RAY_EPS, jnp.asarray(tm))
    tr = bvh.bvh_transmittance(scene, getattr(scene, BVH_OF[code]), code,
                               torch.from_numpy(o), torch.from_numpy(d),
                               RAY_EPS, torch.from_numpy(tm))
    jtr = np.asarray(jtr)
    assert ((jtr > 0.0) & (jtr < 1.0)).sum() > 100
    np.testing.assert_allclose(tr.numpy(), jtr, rtol=1e-6, atol=1e-7)


def _field_scene():
    """tests/torch_bvh_helpers.py tri_field, built by the reference, in
    float64 (as _scenes casts it)."""
    v, mat, o, d = tri_field_arrays()
    b = st.SceneBuilder()
    mats = [b.add_material(transparency=t, emission=e)
            for t, e in FIELD_MATERIALS]
    b.add_triangles_raw(v[:, 0], v[:, 1], v[:, 2], np.asarray(mats)[mat])
    scene = jax.tree.map(lambda x: x.astype(jnp.float64)
                         if jnp.issubdtype(x.dtype, jnp.floating) else x,
                         b.build())
    return scene, o, d


def _moved(ref_scene, prim, shift):
    """Both packages' scenes, in the reference scene's float type, after
    the same move of the pool of kind ``prim`` by ``shift`` (N, 3):
    triangles and spheres through with_params, cylinders through
    replace."""
    f64 = ref_scene.triangles.v0.dtype == jnp.float64
    port = scene_from_numpy(numpy_tree(ref_scene), "cpu",
                            torch.float64 if f64 else torch.float32)
    if prim == "tri":
        rp = ref_scene.params
        rp["vertices"] = tuple(jnp.asarray(np.asarray(v) + shift)
                               for v in rp["vertices"])
        ref = ref_scene.with_params(rp)
    elif prim == "sphere":
        rp = ref_scene.params
        rp["sphere_center"] = jnp.asarray(np.asarray(rp["sphere_center"])
                                          + shift)
        ref = ref_scene.with_params(rp)
    else:
        c = ref_scene.cylinders
        ref = dataclasses.replace(ref_scene, cylinders=dataclasses.replace(
            c, p0=c.p0 + shift, p1=c.p1 + shift))
    return ref, move_pool(port, prim, shift)


@pytest.mark.parametrize("case", ["tri", "sphere", "cyl", "drift"])
def test_stale_tree_closest_hit_matches_reference(case):
    """ROADMAP C14: after the primitives move out of their leaf boxes
    without a refit (C9), the port's closest hit is the reference's DFS
    walk's.  "tri", "sphere" and "cyl": the near leaf's box is the nearer
    (z 5) and the far leaf's starts near z 10, but one of the far leaf's
    primitives moved to z 2.1 (tests/torch_bvh_helpers.py
    two_leaf_stale); the DFS walk enters the far leaf first and returns
    it, a near-first walk would return the near leaf's hit and prune the
    far leaf: idx equal on every ray.  Triangles and spheres move
    through with_params, cylinders (which are no parameter) through
    replace.  "drift": tri_field with
    a random translation of each triangle (sd 0.2), in float64, where
    test_closest_walk_matches_reference holds idx exactly (in float32
    XLA's FMA contraction moves t by up to 2.4e-6 on this field, moved
    or not)."""
    if case == "drift":
        prim = "tri"
        ref_scene, o, d = _field_scene()
        shift = np.random.default_rng(4).normal(
            0.0, 0.2, (ref_scene.triangles.v0.shape[0], 3))
    else:
        prim = case
        b = st.SceneBuilder()
        add_two_leaves(b, prim, b.add_material(color=(0.7, 0.6, 0.5, 1.0)))
        ref_scene = b.build(bvh_threshold=16)
        o, d = two_leaf_rays()
        shift = stale_shift()
    ref, port = _moved(ref_scene, prim, shift)
    code = {"sphere": 0, "tri": 1, "cyl": 2}[prim]
    tree = getattr(port, BVH_OF[code])
    stray = bvh.outside_leaf_boxes(port, tree, prim)
    assert int(stray.sum()) > 0
    assert not bvh.leaf_boxes_hold(port, tree, prim)
    jt, ji = jbvh.bvh_closest_hit(ref, getattr(ref, BVH_OF[code]), code,
                                  jnp.asarray(o), jnp.asarray(d), RAY_EPS,
                                  3e38)
    t, i = bvh.bvh_closest_hit(port, tree, code, torch.from_numpy(o),
                               torch.from_numpy(d), RAY_EPS)
    jt, ji, t, i = np.asarray(jt), np.asarray(ji), t.numpy(), i.numpy()
    hit = jt < 1e30
    if case != "drift":
        assert stray.nonzero().flatten().tolist() == [STALE_ROW]
        assert (ji == STALE_ROW).all()
    assert hit.sum() > (1000 if case == "drift" else 63)
    np.testing.assert_array_equal(t < 1e30, hit)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(t[hit], jt[hit], rtol=1e-6)


def test_pool_aabbs_and_refit_match_reference():
    """Per-primitive bounds of each pool, and the refit after the
    primitives move."""
    for kind, code in (("tri", 1), ("sphere", 0), ("cyl", 2)):
        ref_scene, scene = _scenes(kind)
        ref_min, ref_max = jbvh.pool_aabbs(ref_scene, code)
        pmin, pmax = bvh.pool_aabbs(scene, code)
        np.testing.assert_array_equal(pmin, np.asarray(ref_min))
        np.testing.assert_array_equal(pmax, np.asarray(ref_max))
        shift = np.random.default_rng(code).uniform(
            -0.3, 0.3, pmin.shape).astype(np.float32)
        ref = jbvh.bvh_refit(getattr(ref_scene, BVH_OF[code]),
                             jnp.asarray(pmin + shift),
                             jnp.asarray(pmax + shift))
        port = bvh.bvh_refit(getattr(scene, BVH_OF[code]),
                             torch.from_numpy(pmin + shift),
                             torch.from_numpy(pmax + shift))
        _assert_same_bvh(port, ref)


def test_converted_scene_carries_the_bvhs():
    ref = random_tri_field(300).build(bvh_threshold=64)
    scene = scene_from_numpy(numpy_tree(ref), "cpu")
    _assert_same_bvh(scene.tri_bvh, ref.tri_bvh)
    assert scene.sph_bvh is None and scene.cyl_bvh is None


@pytest.mark.parametrize("field", ["spheres", "tris"])
def test_walk_render_equals_brute(field):
    """The render with the BVH walk equals the one with the brute force
    (tests/test_render_vs_oracle.py:113-134): same tests, same tie
    rules."""
    b = random_sphere_field(256) if field == "spheres" else random_tri_field(256)
    cam = camera_from_numpy(numpy_tree(st.Camera.create(
        position=(0, 0, -6.0), fov=1.0)), "cpu")
    imgs = []
    for use_bvh in (True, False):
        ref = b.build(bvh_threshold=64, use_bvh=use_bvh)
        scene = scene_from_numpy(numpy_tree(ref), "cpu")
        cfg = config_from_reference_fields(dataclasses.asdict(
            st.RenderConfig(width=32, height=32, max_bounces=2,
                            use_bvh=use_bvh, traversal="while")))
        imgs.append(render_sample(scene, cam, cfg)[0].numpy())
    np.testing.assert_allclose(imgs[0], imgs[1], atol=2e-5)

"""The port's SceneBuilder and converters against solr_tpu's.

The builders must give the same triangle, sphere and cylinder orders:
the port sorts by Morton code with numpy's stable argsort, the
reference's numpy path does the same, and the reference prefers its
native LBVH builder, whose std::stable_sort over the same float32 codes
must agree.  Pools and lights are compared exactly, the accelerators'
rows and bounds at rtol 1e-6 (see tests/test_torch_packet.py)."""

import dataclasses

import numpy as np
import pytest
import torch

import solr_tpu as st
from solr_tpu.ops import camera as jcamera
from solr_tpu.ops import packet as jpk
from solr_tpu.ops.bvh import build_bvh

from data.torch_reference import numpy_tree, reference_bench_scene
from scenes_fixtures import (random_cylinder_field, random_sphere_field,
                             random_tri_field)
from solr_tpu_torch.bench_scene import bench_scene, bench_scene_arrays
from solr_tpu_torch.convert import config_from_reference_fields, scene_from_numpy
from solr_tpu_torch.ops.render import render_sample
from solr_tpu_torch.scene import SceneBuilder
from solr_tpu_torch.types import Camera

# Several test workers share the cores: keep each one's intra-op pool small.
torch.set_num_threads(2)

POOL_FIELDS = {
    "triangles": ("v0", "v1", "v2", "n0", "n1", "n2", "uv0", "uv1", "uv2",
                  "material"),
    "spheres": ("center", "radius", "material"),
    "lights": ("position", "color", "radius"),
    "materials": ("color", "specular", "reflection", "ior", "transparency",
                  "emission", "procedural", "procedural_scale"),
}


def _field_scenes():
    """random_tri_field through both builders: the port gets the
    reference's insertion-order triangles as a mesh."""
    raw = random_tri_field(1200).build(use_bvh=False)
    n = 1200
    verts = np.stack([np.asarray(getattr(raw.triangles, k))[:n]
                      for k in ("v0", "v1", "v2")], 1).reshape(-1, 3)
    b = SceneBuilder()
    m = b.add_material(color=(0.7, 0.6, 0.5, 1.0))
    b.add_mesh(verts, np.arange(3 * n).reshape(n, 3), m)
    b.add_light((0, 10.0, 0), intensity=1.0)
    return (random_tri_field(1200).build(bvh_threshold=64),
            b.build(block=jpk.BLOCK, device="cpu"))


def _bench_scenes():
    ref, _, _ = reference_bench_scene(bench_scene_arrays(20_000), 32, 32, 2)
    port, _, _ = bench_scene(20_000, block=jpk.BLOCK, width=32, height=32,
                             device="cpu")
    return ref, port


@pytest.mark.parametrize("make", [_field_scenes, _bench_scenes],
                         ids=["field", "bench"])
def test_builder_matches_reference(make):
    ref, port = make()
    for pool, fields in POOL_FIELDS.items():
        for f in fields:
            a = np.asarray(getattr(getattr(ref, pool), f))
            b = getattr(getattr(port, pool), f).numpy()
            np.testing.assert_array_equal(b, a.astype(b.dtype),
                                          err_msg=f"{pool}.{f}")
    assert port.tri_accel is not None and port.tri_accel.block == jpk.BLOCK
    np.testing.assert_allclose(port.tri_accel.block_bounds.numpy(),
                               np.asarray(ref.tri_accel.block_bounds),
                               rtol=1e-6)


def _port_builder_from(raw):
    """A port SceneBuilder holding the reference scene ``raw`` (built
    without reordering): its materials, spheres and cylinders in
    insertion order, padding left out."""
    b = SceneBuilder()
    m = raw.materials
    b._mat.clear()
    for i in range(np.asarray(m.color).shape[0]):
        spec = np.asarray(m.specular[i])
        b.add_material(color=tuple(np.asarray(m.color[i])), specular=spec[0],
                       specular_power=spec[1],
                       reflection=float(m.reflection[i]), ior=float(m.ior[i]),
                       transparency=float(m.transparency[i]),
                       emission=float(m.emission[i]),
                       procedural=int(m.procedural[i]),
                       procedural_scale=float(m.procedural_scale[i]))
    sp = raw.spheres
    for c, r, mat in zip(*(np.asarray(x) for x in (sp.center, sp.radius,
                                                   sp.material))):
        if r > 0:
            b.add_sphere(c, float(r), int(mat))
    cy = raw.cylinders
    for p0, p1, r, mat in zip(*(np.asarray(x) for x in (
            cy.p0, cy.p1, cy.radius, cy.material))):
        if r > 0:
            b.add_cylinder(p0, p1, float(r), int(mat))
    return b


ORDER_CASES = {"spheres": (lambda: random_sphere_field(900), "sph_accel"),
               "cylinders": (lambda: random_cylinder_field(700), "cyl_accel")}


@pytest.mark.parametrize("pool", sorted(ORDER_CASES))
def test_sphere_and_cylinder_order_match_reference(pool):
    """The Morton order of a sphere or cylinder pool, its lights (taken
    before the reorder) and its accelerator, against solr_tpu's build."""
    make, key = ORDER_CASES[pool]
    ref = make().build(bvh_threshold=64)
    port = _port_builder_from(make().build(use_bvh=False)).build(
        block=jpk.BLOCK, device="cpu")
    fields = {"spheres": ("center", "radius", "material"),
              "cylinders": ("p0", "p1", "radius", "material"),
              "lights": ("position", "color", "radius")}
    for name, names in fields.items():
        for f in names:
            a = np.asarray(getattr(getattr(ref, name), f))
            b = getattr(getattr(port, name), f).numpy()
            np.testing.assert_array_equal(b, a.astype(b.dtype),
                                          err_msg=f"{name}.{f}")
    for k in ("tri_accel", "sph_accel", "cyl_accel"):
        assert (getattr(port, k) is None) == (getattr(ref, k) is None), k
    a, r = getattr(port, key), getattr(ref, key)
    np.testing.assert_allclose(a.packed.numpy(), np.asarray(r.packed),
                               rtol=1e-6)
    np.testing.assert_allclose(a.block_bounds.numpy(),
                               np.asarray(r.block_bounds), rtol=1e-6)


def test_converted_scene_carries_every_accelerator():
    ref = random_sphere_field(900).build(bvh_threshold=64)
    scene = scene_from_numpy(numpy_tree(ref), "cpu")
    np.testing.assert_array_equal(scene.sph_accel.packed.numpy(),
                                  np.asarray(ref.sph_accel.packed))
    assert scene.cyl_accel is None and scene.tri_accel is None
    assert scene.cylinders.radius.shape == (0,)


def test_native_and_numpy_orders_agree():
    """The reference's two BVH builders order the bench terrain alike,
    so the port's numpy order is the reference's whichever it used."""
    arrays = bench_scene_arrays(20_000)
    v = arrays["vertices"][arrays["faces"]]
    amin, amax = v.min(1), v.max(1)
    _, order_np = build_bvh(amin, amax, 8, backend="numpy")
    _, order_auto = build_bvh(amin, amax, 8, backend="auto")
    np.testing.assert_array_equal(order_auto, order_np)


def test_unported_parts_raise():
    """Textures, fog and a sky texture, which raised here until they were
    ported (ROADMAP A11), now carry across; what neither package renders,
    the reserved VOLUME camera mode, raises in both.  (The texture
    features themselves are held to the reference in
    tests/test_torch_textures.py and test_torch_effects.py.)"""
    textured = st.SceneBuilder()
    tid = textured.add_texture(np.zeros((4, 4, 3), np.uint8))
    textured.add_sphere((0.0, 0.0, 3.0), 1.0,
                        textured.add_material(texture_diffuse=tid))
    ref = textured.build()
    scene = scene_from_numpy(numpy_tree(ref), "cpu")
    assert scene.textures.count == 1
    np.testing.assert_array_equal(scene.textures.atlas.numpy(),
                                  np.asarray(ref.textures.atlas))
    for ref_cfg in (st.RenderConfig(fog=True),
                    st.RenderConfig(sky_texture=0)):
        cfg = config_from_reference_fields(dataclasses.asdict(ref_cfg))
        assert (cfg.fog, cfg.sky_texture) == (ref_cfg.fog, ref_cfg.sky_texture)
    volume = st.RenderConfig(width=8, height=8,
                             camera_mode=st.CameraMode.VOLUME)
    with pytest.raises(NotImplementedError):
        jcamera.camera_rays(st.Camera.create(), volume)
    with pytest.raises(NotImplementedError):
        render_sample(scene, Camera.create(device="cpu"),
                      config_from_reference_fields(dataclasses.asdict(volume)))


def test_config_carries_the_packet_fields():
    ref = st.RenderConfig(width=48, height=32, max_bounces=3,
                          gradient_background=True, packet_max_blocks=32,
                          packet_tile_cand=96, compact_rays=False)
    cfg = config_from_reference_fields(dataclasses.asdict(ref))
    for f in ("width", "height", "max_bounces", "gradient_background",
              "packet_tile_w", "packet_tile_h", "packet_max_blocks",
              "packet_tile_cand", "packet_exact", "compact_rays", "shadows",
              "shadow_samples"):
        assert getattr(cfg, f) == getattr(ref, f), f
    assert cfg.packet_rays == ref.packet_rays

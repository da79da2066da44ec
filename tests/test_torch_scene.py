"""The port's SceneBuilder and converters against solr_tpu's.

The builders must give the same triangle order: the port sorts by Morton
code with numpy's stable argsort, the reference's numpy path does the
same, and the reference prefers its native LBVH builder, whose
std::stable_sort over the same float32 codes must agree."""

import dataclasses

import numpy as np
import pytest
import torch

import solr_tpu as st
from solr_tpu.ops import packet as jpk
from solr_tpu.ops.bvh import build_bvh

from data.torch_reference import numpy_tree, reference_bench_scene
from scenes_fixtures import cornell_box, random_tri_field
from solr_tpu_torch.bench_scene import bench_scene, bench_scene_arrays
from solr_tpu_torch.convert import config_from_reference_fields, scene_from_numpy
from solr_tpu_torch.scene import SceneBuilder

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
            b.build(block=jpk.BLOCK))


def _bench_scenes():
    ref, _, _ = reference_bench_scene(bench_scene_arrays(20_000), 32, 32, 2)
    port, _, _ = bench_scene(20_000, block=jpk.BLOCK, width=32, height=32)
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
    with pytest.raises(NotImplementedError):
        scene_from_numpy(numpy_tree(cornell_box().build()), "cpu")
    for ref in (st.RenderConfig(fog=True), st.RenderConfig(traversal="while")):
        with pytest.raises(NotImplementedError):
            config_from_reference_fields(dataclasses.asdict(ref))
    b = SceneBuilder()
    for i in range(64):
        b.add_sphere((float(i), 0.0, 5.0), 0.3)
    with pytest.raises(NotImplementedError):
        b.build()


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

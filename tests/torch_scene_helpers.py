"""Scene and frame comparisons shared by the gallery, I/O and viewer
parity tests: a solr_tpu_torch scene against a solr_tpu one, array by
array, and a frame against a reference frame."""

from __future__ import annotations

import dataclasses

import numpy as np

# Frames: atol 1e-4 outside a budget of 0.2% of pixels (ROADMAP C1: a ray
# within an ulp of an edge can take the neighbouring primitive).
ATOL = 1e-4
BUDGET = 0.002

POOLS = ("spheres", "triangles", "cylinders", "ellipsoids", "planes",
         "materials", "lights", "textures", "info")
BVHS = ("tri_bvh", "sph_bvh", "cyl_bvh")
BVH_FIELDS = ("aabb_min", "aabb_max", "skip", "first_prim", "prim_count",
              "depth", "leaf_center", "leaf_radius", "leaf_first",
              "leaf_count")
ACCELS = ("tri_accel", "sph_accel", "cyl_accel")


def _same(port, ref, what):
    a = np.asarray(ref)
    b = port.detach().cpu().numpy()
    assert a.shape == b.shape, f"{what}: shape {b.shape} != {a.shape}"
    np.testing.assert_array_equal(b, a.astype(b.dtype), err_msg=what)


def assert_same_scene(port, ref, accel_rtol=1e-6):
    """Every pool, material, light, texture and scene-info array and
    every BVH array equal; the packet accelerators present alike, their
    block bounds within ``accel_rtol`` (they are computed by each
    package's own arithmetic, tests/test_torch_packet.py)."""
    for pool in POOLS:
        p, r = getattr(port, pool), getattr(ref, pool)
        for f in dataclasses.fields(p):
            _same(getattr(p, f.name), getattr(r, f.name), f"{pool}.{f.name}")
    for name in BVHS:
        p, r = getattr(port, name), getattr(ref, name)
        assert (p is None) == (r is None), name
        if p is not None:
            for f in BVH_FIELDS:
                _same(getattr(p, f), getattr(r, f), f"{name}.{f}")
            assert (p.max_depth, p.leaf_size) == (r.max_depth, r.leaf_size)
    for name in ACCELS:
        p, r = getattr(port, name), getattr(ref, name)
        assert (p is None) == (r is None), name
        if p is not None:
            assert p.packed.shape == tuple(np.asarray(r.packed).shape), name
            np.testing.assert_allclose(p.block_bounds.numpy(),
                                       np.asarray(r.block_bounds),
                                       rtol=accel_rtol, err_msg=name)


def assert_same_camera(port, ref):
    for f in dataclasses.fields(port):
        _same(getattr(port, f.name), getattr(ref, f.name), f"camera.{f.name}")


def assert_image_close(img, ref, atol=ATOL, budget=BUDGET):
    img = np.asarray(img)
    assert img.shape == ref.shape
    assert np.isfinite(img).all()
    err = np.abs(img - ref).max(-1)
    frac = (err > atol).mean()
    assert frac <= budget, (f"{frac:.3%} of pixels differ by more than "
                            f"{atol} (worst {err.max():.3g})")

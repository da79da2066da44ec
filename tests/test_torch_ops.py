"""Elementwise modules of the port against solr_tpu's on the CPU: vector
math, intersections, the pinhole camera and the procedural textures.

Tolerances, from what differs between the two CPU builds:
* XLA contracts a*b + c into FMAs and uses its own sin/cos/atan2/asin;
  PyTorch rounds each product and calls libm/SLEEF.  Plain arithmetic
  agrees to rtol 1e-6, transcendental results to atol 1e-6.
* Ray-primitive t: rtol 1e-5 (t inherits cancellation in its
  numerator); hit/miss must agree on every ray.
* Capped cylinders: hit/miss on more than 99.9% of the rays and t at
  rtol 5e-4 where both hit, the bounds tests/test_pallas_kernels.py
  holds the reference's two cylinder forms to: grazing rays (disc ~ 0,
  s ~ 0 or h2) flip between f32 evaluation orders, and the roots'
  cancellation in -b -+ sqrt(disc) is larger than a sphere's.
* Procedural textures: exact for all kinds but marble and granite,
  whose four turbulence octaves feed _hash2, which multiplies sin(.) by
  43758.5453 and keeps the fraction, so a 1-ulp difference in sin grows
  to ~1e-3 (measured 1.1e-3 for marble, 2.7e-3 for granite).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import solr_tpu as st
from solr_tpu.ops import camera as jcam
from solr_tpu.ops import intersect as jis
from solr_tpu.ops import textures as jtex
from solr_tpu.ops import vecmath as jvm

from data.torch_reference import numpy_tree
from solr_tpu_torch.convert import camera_from_numpy
from solr_tpu_torch.ops import camera as tcam
from solr_tpu_torch.ops import intersect as tis
from solr_tpu_torch.ops import textures as ttex
from solr_tpu_torch.ops import vecmath as tvm
from solr_tpu_torch.types import RenderConfig

# Several test workers share the cores: keep each one's intra-op pool small.
torch.set_num_threads(2)


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _both(fn_j, fn_t, *arrays):
    ref = fn_j(*(jnp.asarray(a) for a in arrays))
    port = fn_t(*(torch.from_numpy(a) for a in arrays))
    return ref, port


def _close(ref, port, **tol):
    if isinstance(ref, tuple):
        for a, b in zip(ref, port):
            _close(a, b, **tol)
        return
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **tol)


VEC_CASES = {
    "dot": (jvm.dot, tvm.dot, 2, {}),
    "cross": (jvm.cross, tvm.cross, 2, {}),
    "normalize": (jvm.normalize, tvm.normalize, 1, {}),
    "reflect": (jvm.reflect, tvm.reflect, 2, {}),
    "refract": (lambda i, n: jvm.refract(i, -n * jnp.sign(jvm.dot(i, n, True)),
                                         jnp.full(i.shape[:-1], 0.67, jnp.float32)),
                lambda i, n: tvm.refract(i, -n * torch.sign(tvm.dot(i, n, True)),
                                         torch.full(i.shape[:-1], 0.67)), 2, {}),
    "spherical_uv": (jvm.spherical_uv, tvm.spherical_uv, 1, {"atol": 1e-6}),
    "rotate_euler": (jvm.rotate_euler, tvm.rotate_euler, 2, {"atol": 1e-6}),
}


@pytest.mark.parametrize("name", sorted(VEC_CASES))
def test_vecmath_matches_reference(name):
    fj, ft, n_args, tol = VEC_CASES[name]
    rng = np.random.default_rng(3)
    args = [_unit(rng, 500) for _ in range(n_args)]
    ref, port = _both(fj, ft, *args)
    tol = dict({"rtol": 1e-6, "atol": 1e-7}, **tol)
    _close(ref, port, **tol)


@pytest.fixture(scope="module")
def rays_and_prims():
    rng = np.random.default_rng(4)
    n = 4000
    o = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    target = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32) + [0, 0, 5]
    d = target - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    c = (rng.uniform(-1, 1, (n, 3)) + [0, 0, 5]).astype(np.float32)
    r = rng.uniform(-0.2, 1.0, (n,)).astype(np.float32)
    v0 = (c + rng.normal(0, 0.8, (n, 3))).astype(np.float32)
    v1 = (c + rng.normal(0, 0.8, (n, 3))).astype(np.float32)
    v2 = (c + rng.normal(0, 0.8, (n, 3))).astype(np.float32)
    return o, d, c, r, v0, v1, v2


@pytest.fixture(scope="module")
def cylinders():
    """Rays from a box toward a field of capped cylinders: side, cap and
    grazing hits, misses, and padding (radius <= 0)."""
    rng = np.random.default_rng(6)
    n = 4000
    o = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    p0 = (rng.uniform(-1, 1, (n, 3)) + [0, 0, 5]).astype(np.float32)
    p1 = (p0 + rng.normal(0, 0.8, (n, 3))).astype(np.float32)
    r = rng.uniform(-0.1, 0.5, (n,)).astype(np.float32)
    target = 0.5 * (p0 + p1) + rng.normal(0, 0.3, (n, 3))
    d = target - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d, p0, p1, r


@pytest.mark.parametrize("form", ["pairwise", "matrix"])
def test_cylinder_matches_reference(cylinders, form):
    o, d, p0, p1, r = cylinders
    if form == "pairwise":
        fj, ft = jis.cylinder_t_p, tis.cylinder_t_p
    else:  # 400 rays x 600 cylinders
        o, d = o[:400], d[:400]
        p0, p1, r = p0[:600], p1[:600], r[:600]
        fj, ft = jis.cylinder_t, tis.cylinder_t
    ref, port = _both(lambda *a: fj(*a, 1e-4), lambda *a: ft(*a, 1e-4),
                      o, d, p0, p1, r)
    ref, port = np.asarray(ref), port.numpy()
    hit_r, hit_t = ref < 1e30, port < 1e30
    assert 100 < hit_r.sum() < hit_r.size
    assert (hit_r == hit_t).mean() > 0.999
    both = hit_r & hit_t
    np.testing.assert_allclose(port[both], ref[both], rtol=5e-4)


@pytest.mark.parametrize("prim", ["sphere", "triangle", "bary"])
def test_intersect_matches_reference(rays_and_prims, prim):
    o, d, c, r, v0, v1, v2 = rays_and_prims
    if prim == "bary":
        ref, port = _both(jis.triangle_bary, tis.triangle_bary, o, d, v0, v1, v2)
        # u, v are ratios of dot products: compare where the triangle is
        # not edge-on to the ray.
        det = np.abs(np.einsum("ij,ij->i", np.cross(d, v2 - v0), v1 - v0))
        ok = det > 1e-3
        for a, b in zip(ref, port):
            np.testing.assert_allclose(b.numpy()[ok], np.asarray(a)[ok],
                                       rtol=1e-4, atol=1e-5)
        return
    if prim == "sphere":
        ref, port = _both(lambda *a: jis.sphere_t_p(*a, 1e-4),
                          lambda *a: tis.sphere_t_p(*a, 1e-4), o, d, c, r)
    else:
        ref, port = _both(lambda *a: jis.triangle_t_p(*a, 1e-4),
                          lambda *a: tis.triangle_t_p(*a, 1e-4), o, d, v0, v1, v2)
    ref, port = np.asarray(ref), port.numpy()
    hit = ref < 1e30
    assert 200 < hit.sum() < hit.size
    np.testing.assert_array_equal(port < 1e30, hit)
    np.testing.assert_allclose(port[hit], ref[hit], rtol=1e-5)


def test_camera_rays_match_reference():
    jc = st.Camera.create(position=(0.0, 2.0, -4.0), angles=(0.25, 0.1, -0.05),
                          fov=1.0)
    cfg_j = st.RenderConfig(width=48, height=32)
    o_j, d_j = jcam.camera_rays(jc, cfg_j)
    o_t, d_t = tcam.camera_rays(camera_from_numpy(numpy_tree(jc), "cpu"),
                                RenderConfig(width=48, height=32))
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=1e-6)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-6)


# kind -> max abs error over the texels
PROC_TOL = {0: 1e-6, 1: 1e-6, 2: 1e-6, 3: 1e-6, 4: 1e-6, 5: 3e-3, 6: 6e-3}


@pytest.mark.parametrize("kind", sorted(PROC_TOL))
def test_procedural_color_matches_reference(kind):
    rng = np.random.default_rng(5)
    n = 2000
    uv = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    scale = rng.uniform(1.0, 8.0, (n,)).astype(np.float32)
    base = rng.uniform(0.1, 0.9, (n, 4)).astype(np.float32)
    k = np.full((n,), kind, np.int32)
    ref, port = _both(jtex.procedural_color, ttex.procedural_color,
                      k, scale, uv, base)
    err = np.abs(port.numpy() - np.asarray(ref))
    assert err.max() <= PROC_TOL[kind], (kind, err.max())

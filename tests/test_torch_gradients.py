"""Gradients through the port (ROADMAP A13): ``Scene.params`` /
``with_params``, ``loss.backward()`` held to ``jax.grad`` of solr_tpu
on the CPU, finite differences, the three traversals and the
differentiability contract.

The reference's gradients are taken eagerly (op by op), not under
``jax.jit``: under jit XLA rewrites the arithmetic of the f32 pixel
grid (rays 5.6e-8 apart) and on the f64 Cornell scene flips six pixels
where two walls meet (up to 0.66 in the image), which moves the albedo
and light gradients by 3-10%.  Eagerly, the reference's image and
gradients are the port's to 1e-12 of each leaf's largest entry.

Tolerances, elementwise per leaf: |g_port - g_ref| <= tol * max|g_ref|.
* The Cornell scene of tests/test_gradients.py, f64: tol 1e-6 on every
  leaf (measured: 1e-12 or less).
* examples/inverse.py's scene at 32x32, over the pixels outside the
  silhouette mask (a primary or bounce-1 ray meets a sphere with
  0 <= disc < 1e-2 r^2; ROADMAP C10): f64 1e-6 on every leaf; f32 1e-4
  on albedo and light position, 1e-3 on sphere geometry (measured 1e-7,
  6e-7 and 2.5e-5).
* Finite differences, f64, eps 1e-5: relative 1e-3, as
  tests/test_gradients.py.
* BVH traversals against brute force: vertex-gradient L1 totals within
  rtol 1e-3, as tests/test_gradients.py.
* The reduced textured scene (BASELINE config #3: a bump map, a normal
  map, fog and soft shadows drawn through ``JaxKey``), f64, over the
  pixels outside the silhouette mask: 1e-6 on every leaf.
* Refreshed accelerators against the reference's ``refresh_accel``:
  tests/test_torch_packet.py's tolerances for ``packed`` and the block
  bounds; against the port's own builders, equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import solr_tpu as st
from solr_tpu.ops.render import render_sample as j_render

from data.torch_reference import (numpy_tree, reference_grads,
                                  reference_inverse_case,
                                  reference_inverse_scene,
                                  reference_textured_scene, silhouette_mask)
from test_torch_packet import _rows_close
from scenes_fixtures import (cornell_box, random_cylinder_field,
                             random_sphere_field, random_tri_field)
from solr_tpu_torch.constants import POOL_TRIANGLE, RAY_EPS
from solr_tpu_torch.convert import (camera_from_numpy,
                                    config_from_reference_fields,
                                    scene_from_numpy)
from solr_tpu_torch.inverse import rgbd_loss
from solr_tpu_torch.kernel_shapes import primary_tiles, sweep_args
from solr_tpu_torch.ops import bvh, packet, sweep
from solr_tpu_torch.ops.render import render_sample
from solr_tpu_torch.scene import SceneBuilder
from solr_tpu_torch.textured_scene import textured_scene_parts
from solr_tpu_torch.types import PlaneAxis
from torch_rng_helpers import JaxKey

# Several test workers share the cores: keep each one's intra-op pool small.
torch.set_num_threads(2)

LEAVES = ("sphere_center", "sphere_radius", "albedo", "ior", "light_position")


def port_scene(jscene, dtype=torch.float32):
    """The reference scene carried across, its float leaves in ``dtype``
    but the scene info in its own: the reference draws its pixel grid in
    the info's dtype, which SceneBuilder(dtype=float64) leaves f32."""
    tree = numpy_tree(jscene)
    info_dt = (torch.float64 if tree["info"]["background_color"].dtype
               == np.float64 else torch.float32)
    return scene_from_numpy(tree, "cpu", dtype).replace(
        info=scene_from_numpy(tree, "cpu", info_dt).info)


def port_camera(jcam, dtype=torch.float32):
    return camera_from_numpy(numpy_tree(jcam), "cpu", dtype)


def port_cfg(jcfg):
    return config_from_reference_fields(dataclasses.asdict(jcfg))


def leaf_params(params):
    """Fresh leaf tensors (requires_grad) of a ``Scene.params`` tree."""
    def leaf(x):
        return torch.as_tensor(np.asarray(x)).clone().requires_grad_()

    return {k: tuple(leaf(x) for x in v) if isinstance(v, tuple) else leaf(v)
            for k, v in params.items()}


def grads_of(p):
    def g(x):
        return (np.zeros(tuple(x.shape)) if x.grad is None
                else x.grad.numpy())

    return {k: tuple(g(x) for x in v) if isinstance(v, tuple) else g(v)
            for k, v in p.items()}


def port_backward(scene, cam, cfg, loss_fn, params=None):
    """(loss, grads) of ``loss_fn(img, depth)`` at ``params`` (the
    scene's own when None)."""
    p = leaf_params(scene.params if params is None else params)
    img, depth = render_sample(scene.with_params(p), cam, cfg)
    loss = loss_fn(img, depth)
    loss.backward()
    return float(loss), grads_of(p)


def assert_leaf_close(got, want, tol, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    assert np.isfinite(got).all(), name
    scale = np.abs(want).max() if want.size else 0.0
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= tol * scale, (
        f"{name}: max |port - ref| {err:.3e} > {tol} * {scale:.3e}")


# --------------------------------------------------------------------------
# The Cornell scene of tests/test_gradients.py, f64: parity and FD
# --------------------------------------------------------------------------

CORNELL_CFG = st.RenderConfig(width=24, height=24, max_bounces=2)


@pytest.fixture(scope="module")
def cornell():
    jscene = cornell_box(n_spheres=3, reflective=True, transparent=True,
                         seed=11, dtype=np.float64).build()
    jcam = st.Camera.create(position=(0.0, 0.0, -1.6), fov=1.1,
                            dtype=jnp.float64)
    img, _ = j_render(jscene, jcam, CORNELL_CFG)
    target = img[..., :3] * 0.8  # a non-trivial residual
    scene = port_scene(jscene, torch.float64)
    cam = port_camera(jcam, torch.float64)
    cfg = port_cfg(CORNELL_CFG)
    t_target = torch.as_tensor(np.asarray(target))

    def loss_fn(img, _):
        return ((img[..., :3] - t_target) ** 2).mean()

    def loss(params):
        with torch.no_grad():
            img, depth = render_sample(scene.with_params(params), cam, cfg)
            return float(loss_fn(img, depth))

    l_port, g_port = port_backward(scene, cam, cfg, loss_fn)
    return dict(jscene=jscene, jcam=jcam, target=target, scene=scene,
                loss=loss, l_port=l_port, g_port=g_port)


@pytest.fixture(scope="module")
def cornell_ref(cornell):
    return reference_grads(cornell["jscene"], cornell["jcam"], CORNELL_CFG,
                           cornell["jscene"].params, cornell["target"])


@pytest.mark.parametrize("leaf", LEAVES + ("vertices",))
def test_cornell_grads_match_reference_f64(cornell, cornell_ref, leaf):
    l_ref, g_ref = cornell_ref
    np.testing.assert_allclose(cornell["l_port"], float(l_ref), rtol=1e-12)
    got, want = cornell["g_port"][leaf], g_ref[leaf]
    if leaf == "vertices":  # the Cornell box has no triangles
        for i, (a, b) in enumerate(zip(got, want)):
            assert_leaf_close(a, np.asarray(b), 1e-6, f"vertices[{i}]")
        return
    assert_leaf_close(got, want, 1e-6, leaf)


def _fd_check(cornell, path, indices, eps=1e-5, tol=1e-3):
    """Central finite differences of the port's own loss on selected
    entries (tests/test_gradients.py's _fd_check)."""
    scene, loss, grads = cornell["scene"], cornell["loss"], cornell["g_port"]
    params = scene.params
    for idx in indices:
        def perturbed(sign):
            x = params[path].detach().clone()
            x[idx] += sign * eps
            return loss({**params, path: x})

        fd = (perturbed(+1) - perturbed(-1)) / (2 * eps)
        an = float(grads[path][idx])
        rel = abs(fd - an) / max(abs(fd), abs(an), 1e-4)
        assert rel < tol, (f"{path}[{idx}]: analytic {an:.6e} vs FD "
                           f"{fd:.6e} (rel {rel:.2e})")


def _glass(scene):
    trans = scene.materials.transparency.numpy()
    glass = int(np.argmax(trans))
    assert trans[glass] > 0
    return [(glass,)]


@pytest.mark.parametrize("path,indices", [
    ("sphere_center", [(0, 0), (0, 1), (0, 2), (1, 0), (1, 2)]),
    ("sphere_radius", [(0,), (1,), (2,)]),
    ("albedo", [(1, 0), (1, 1), (2, 2), (4, 0)]),
    ("ior", None),
    ("light_position", [(0, 0), (0, 1), (0, 2)]),
])
def test_cornell_grads_match_finite_differences(cornell, path, indices):
    _fd_check(cornell, path, indices or _glass(cornell["scene"]))


def test_cornell_no_nans_anywhere(cornell):
    for k, v in cornell["g_port"].items():
        for x in (v if isinstance(v, tuple) else (v,)):
            assert np.isfinite(x).all(), k


# --------------------------------------------------------------------------
# examples/inverse.py's scene, with the silhouette mask
# --------------------------------------------------------------------------

INVERSE_CFG = st.RenderConfig(width=32, height=32, max_bounces=2)
# Per-leaf tolerances in f32; every leaf is held to 1e-6 in f64.
F32_TOL = {"sphere_center": 1e-3, "sphere_radius": 1e-3, "albedo": 1e-4,
           "light_position": 1e-4, "ior": 1e-4}


@pytest.fixture(scope="module", params=["f32", "f64"])
def inverse_case(request):
    """The true scene against 0.8 x its own image, plus the demo's
    depth term against the depth of its perturbed start: a gradient on
    every leaf, at a point where three pixels graze a sphere."""
    f64 = request.param == "f64"
    ref = reference_inverse_case(INVERSE_CFG, f64)
    dt = torch.float64 if f64 else torch.float32
    t_target = torch.as_tensor(np.asarray(ref["target"]))
    t_depth = torch.as_tensor(np.asarray(ref["depth"]))
    keep = torch.as_tensor(~ref["mask"])
    l_port, g_port = port_backward(
        port_scene(ref["scene"], dt), port_camera(ref["cam"], dt),
        port_cfg(INVERSE_CFG),
        lambda im, de: rgbd_loss(im, de, t_target, t_depth, True, keep))
    return dict(dtype=request.param, mask=ref["mask"],
                l_ref=float(ref["loss"]), g_ref=ref["grads"], l_port=l_port,
                g_port=g_port)


def test_inverse_silhouette_mask_is_small(inverse_case):
    mask = inverse_case["mask"]
    assert 0 < mask.sum() < 0.02 * mask.size


@pytest.mark.parametrize("leaf", LEAVES)
def test_inverse_grads_match_reference_masked(inverse_case, leaf):
    f64 = inverse_case["dtype"] == "f64"
    np.testing.assert_allclose(inverse_case["l_port"], inverse_case["l_ref"],
                               rtol=1e-12 if f64 else 1e-5)
    assert_leaf_close(inverse_case["g_port"][leaf],
                      inverse_case["g_ref"][leaf],
                      1e-6 if f64 else F32_TOL[leaf], leaf)


def test_inverse_grads_unmasked_are_finite():
    """The same gradient over every pixel, through the port alone.  Only
    finiteness is asserted: in f32 the three grazing pixels carry most
    of sphere 0's centre gradient (dt/dc ~ 1/sqrt(disc)), so the last
    bits of disc decide it; measured against solr_tpu at this point,
    sphere 0's centre gradient is 9.0% and its radius gradient 6.8%
    apart in f32 (both eager and jitted), and 6e-11 apart in f64."""
    jscene, jcam = reference_inverse_scene()
    img, _ = j_render(jscene, jcam, INVERSE_CFG)
    t_target = torch.as_tensor(np.asarray(img[..., :3] * 0.8))
    _, g = port_backward(
        port_scene(jscene), port_camera(jcam), port_cfg(INVERSE_CFG),
        lambda im, _: ((im[..., :3] - t_target) ** 2).mean())
    for k in LEAVES:
        assert np.isfinite(g[k]).all(), k
    assert np.abs(g["sphere_center"]).max() > 0


# --------------------------------------------------------------------------
# The new paths: normal and bump maps, fog, soft shadows
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def textured_case():
    """The textured scene cut to a 12-cell ground at 24x24, 2 bounces,
    2 soft-shadow samples and fog, f64, against 0.8 x its own image over
    the pixels outside the silhouette mask: eager ``jax.grad`` of
    solr_tpu with a key, and the port with the same key's draws."""
    jscene, jcam, jcfg = reference_textured_scene(
        textured_scene_parts(ground_res=12), 24, 24, 2, shadow_samples=2,
        antialias_jitter=False)
    jscene, jcam = jax.tree.map(
        lambda x: x.astype(jnp.float64)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, (jscene, jcam))
    key = jax.random.PRNGKey(1)
    img, _ = j_render(jscene, jcam, jcfg, key)
    target = img[..., :3] * 0.8
    mask = silhouette_mask(jscene, jcam, jcfg)
    keep = ~jnp.asarray(mask)
    w = keep[..., None].astype(target.dtype)

    def loss(p):
        im, _ = j_render(jscene.with_params(p), jcam, jcfg, key)
        return jnp.sum(w * (im[..., :3] - target) ** 2) / (jnp.sum(keep) * 3)

    l_ref, g_ref = jax.value_and_grad(loss)(jscene.params)
    scene, cam, cfg = (port_scene(jscene, torch.float64),
                       port_camera(jcam, torch.float64), port_cfg(jcfg))
    assert cfg.fog and cfg.shadow_samples == 2
    assert int(scene.materials.texture_bump.max()) >= 0
    t_target = torch.as_tensor(np.array(target))
    t_keep = torch.as_tensor(np.array(keep))[..., None]
    p = leaf_params(scene.params)
    im, _ = render_sample(scene.with_params(p), cam, cfg, JaxKey(key))
    lo = (t_keep * (im[..., :3] - t_target) ** 2).sum() / (t_keep.sum() * 3)
    lo.backward()
    return dict(l_ref=float(l_ref), g_ref=g_ref, l_port=float(lo.detach()),
                g_port=grads_of(p), mask=mask)


@pytest.mark.parametrize("leaf", LEAVES + ("vertices",))
def test_textured_grads_match_reference_f64(textured_case, leaf):
    assert textured_case["mask"].mean() < 0.05
    np.testing.assert_allclose(textured_case["l_port"], textured_case["l_ref"],
                               rtol=1e-12)
    got, want = textured_case["g_port"][leaf], textured_case["g_ref"][leaf]
    if leaf == "vertices":
        for i, (g, w) in enumerate(zip(got, want)):
            assert_leaf_close(g, w, 1e-6, f"v{i}")
        assert max(np.abs(g).max() for g in got) > 0
    else:
        assert_leaf_close(got, want, 1e-6, leaf)


# --------------------------------------------------------------------------
# The three traversals (tests/test_gradients.py:133-164,
# tests/test_packet.py:106-119)
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tri_field():
    b = random_tri_field(200)
    jcam = st.Camera.create(position=(0, 0, -6.0), fov=1.0)

    def vertex_l1(jscene, **cfg_kw):
        cfg = st.RenderConfig(width=16, height=16, max_bounces=2, **cfg_kw)
        _, g = port_backward(port_scene(jscene), port_camera(jcam),
                             port_cfg(cfg),
                             lambda im, _: (im[..., :3] ** 2).mean())
        for k, v in g.items():
            for x in (v if isinstance(v, tuple) else (v,)):
                assert np.isfinite(x).all(), k
        return sum(float(np.abs(x).sum()) for x in g["vertices"])

    brute = vertex_l1(b.build(use_bvh=False), use_bvh=False)
    return b, vertex_l1, brute


@pytest.mark.parametrize("traversal", ["packet", "while"])
def test_bvh_traversal_vertex_grads_match_brute(tri_field, traversal):
    """Packets (16x16 is one whole tile) and the per-ray walk both run
    detached; the recomputed t carries the vertex gradients."""
    b, vertex_l1, brute = tri_field
    jscene = b.build(bvh_threshold=64)
    assert jscene.tri_bvh is not None and jscene.tri_accel is not None
    got = vertex_l1(jscene, use_bvh=True, traversal=traversal)
    assert got > 0
    np.testing.assert_allclose(got, brute, rtol=1e-3)


# --------------------------------------------------------------------------
# The differentiability contract (tests/test_gradients.py:278-336)
# --------------------------------------------------------------------------


def _shadow_scene(n_pad_spheres, bvh_threshold):
    b = SceneBuilder()
    floor = b.add_material(color=(0.9, 0.9, 0.9, 1.0))
    glass = b.add_material(color=(1.0, 1.0, 1.0, 1.0), transparency=0.5,
                           ior=1.0)
    b.add_plane(PlaneAxis.XZ, (0.0, 0.0, 0.0), (6.0, 6.0), floor)
    b.add_sphere((0.0, 2.0, 0.0), 0.8, glass)  # between light and floor
    for i in range(n_pad_spheres):
        b.add_sphere((10.0 + i, 20.0, 10.0), 0.1, floor)
    b.add_light((0.0, 6.0, 0.0), intensity=1.0)
    return b.build(bvh_threshold=bvh_threshold, device="cpu"), glass


def _occluder_transparency_grad(scene, mat_id):
    # The camera under the occluder looks straight down: the only
    # transparency dependence in frame is the shadow attenuation.
    from solr_tpu_torch.types import Camera, RenderConfig

    cam = Camera.create(position=(0.0, 1.2, 0.0), angles=(1.5, 0.0, 0.0),
                        fov=0.8, device="cpu")
    cfg = RenderConfig(width=16, height=16, max_bounces=1)
    tr = torch.tensor(0.5, requires_grad=True)
    mats = scene.materials
    ids = torch.arange(mats.count)
    trans = torch.where(ids == mat_id, tr, mats.transparency)
    img, _ = render_sample(scene.replace(
        materials=mats.replace(transparency=trans)), cam, cfg)
    img[..., :3].sum().backward()
    return float(tr.grad) if tr.grad is not None else 0.0


def test_brute_pool_has_occluder_transparency_grad():
    scene, glass = _shadow_scene(0, bvh_threshold=1000)
    assert scene.sph_bvh is None  # brute force
    g = _occluder_transparency_grad(scene, glass)
    assert np.isfinite(g) and abs(g) > 1e-3, g


def test_accelerated_pool_grad_is_zero_by_contract():
    scene, glass = _shadow_scene(80, bvh_threshold=16)
    assert scene.sph_bvh is not None  # the BVH walk, run detached
    g = _occluder_transparency_grad(scene, glass)
    assert g == 0.0, g


@pytest.fixture(scope="module")
def tri_scene_rays():
    from solr_tpu_torch.bench_scene import bench_scene

    scene, cam, cfg = bench_scene(2000, block=128, width=32, height=32,
                                  device="cpu")
    o_t, d_t, live = primary_tiles(cam, cfg)
    return scene, cfg, o_t, d_t, live


@pytest.mark.parametrize("entry", ["sweep_closest", "sweep_transmittance",
                                   "bvh_closest_hit", "bvh_transmittance"])
def test_kernel_wrappers_refuse_inputs_that_require_grad(tri_scene_rays,
                                                         entry):
    """No kernel has a backward: each wrapper raises when handed a tensor
    that requires grad under grad mode, and runs under no_grad."""
    scene, cfg, o_t, d_t, live = tri_scene_rays
    closest = entry.endswith(("closest", "closest_hit"))
    tm_t = torch.full(o_t.shape[:2], 50.0)
    with torch.no_grad():
        args = sweep_args(scene.tri_accel, o_t, d_t, live, cfg, closest,
                          None if closest else tm_t)
    p = leaf_params(scene.params)
    grad_scene = scene.with_params(p)  # vertices require grad
    o = o_t.reshape(-1, 3)
    d = d_t.reshape(-1, 3)

    def call(rays_grad, scene_):
        o_in = o.clone().requires_grad_(rays_grad)
        if entry.startswith("sweep"):
            a = (args[0], o_in.reshape(o_t.shape)) + args[2:]
            return getattr(sweep, entry)(*a)
        walk = getattr(bvh, entry)
        if closest:
            return walk(scene_, scene_.tri_bvh, POOL_TRIANGLE, o_in, d,
                        RAY_EPS)
        return walk(scene_, scene_.tri_bvh, POOL_TRIANGLE, o_in, d, RAY_EPS,
                    torch.full(o.shape[:1], 50.0))

    with pytest.raises(RuntimeError, match="no backward"):
        call(True, scene)
    if entry.startswith("bvh"):
        with pytest.raises(RuntimeError, match="no backward"):
            call(False, grad_scene)
    with torch.no_grad():
        out = call(True, grad_scene)
    assert all(torch.isfinite(x.float()).all() for x in out)


# --------------------------------------------------------------------------
# with_params refreshes the packet accelerators (and no BVH: C9)
# --------------------------------------------------------------------------


def _moved(params, rng):
    """The params with every real vertex, sphere centre and cylinder
    moved by a seeded offset (padding rows stay zero)."""
    out = dict(params)
    v = []
    for x in params["vertices"]:
        x = np.asarray(x)
        real = np.abs(x).sum(-1, keepdims=True) > 0
        v.append(jnp.asarray(x + real * rng.normal(0, 0.05, x.shape)
                             .astype(x.dtype)))
    out["vertices"] = tuple(v)
    c = np.asarray(params["sphere_center"])
    out["sphere_center"] = jnp.asarray(
        c + rng.normal(0, 0.05, c.shape).astype(c.dtype))
    out["sphere_radius"] = params["sphere_radius"] * 1.05
    return out


@pytest.mark.parametrize("make,accel", [
    (lambda: random_tri_field(200), "tri_accel"),
    (lambda: random_sphere_field(100), "sph_accel"),
], ids=["triangles", "spheres"])
def test_with_params_refreshes_accel_as_reference(make, accel):
    jscene = make().build(bvh_threshold=64)
    moved = _moved(jscene.params, np.random.default_rng(3))
    j_new = getattr(jscene.with_params(moved), accel)
    scene = port_scene(jscene)
    p = leaf_params(moved)
    new = scene.with_params(p)
    got = getattr(new, accel)
    assert got.packed.grad_fn is None and not got.packed.requires_grad
    assert got.block_bounds.grad_fn is None
    assert got.block == getattr(scene, accel).block
    # The BVHs are not refitted (C9): the same objects.
    assert new.tri_bvh is scene.tri_bvh and new.sph_bvh is scene.sph_bvh
    # packed's tolerance of tests/test_torch_packet.py: rtol 1e-6 plus
    # 1e-6 of the row's largest magnitude (the reference contracts the
    # cross products into FMAs).
    _rows_close(np.asarray(j_new.packed), got.packed.numpy())
    np.testing.assert_allclose(got.block_bounds.numpy(),
                               np.asarray(j_new.block_bounds), rtol=1e-6,
                               atol=1e-6)
    build = {"tri_accel": (packet.build_tri_accel, new.triangles),
             "sph_accel": (packet.build_sph_accel, new.spheres)}[accel]
    fresh = build[0](build[1], new.materials, got.block)
    assert torch.equal(got.packed, fresh.packed)
    assert torch.equal(got.block_bounds, fresh.block_bounds)


def test_cylinder_accel_refresh_keeps_no_graph():
    jscene = random_cylinder_field(100).build(bvh_threshold=64)
    scene = port_scene(jscene)
    p0 = scene.cylinders.p0.clone().requires_grad_()
    moved = scene.replace(cylinders=scene.cylinders.replace(p0=p0 + 0.01))
    new = moved.refresh_accel()
    assert new.cyl_accel.packed.grad_fn is None
    fresh = packet.build_cyl_accel(moved.cylinders, moved.materials,
                                   scene.cyl_accel.block)
    assert torch.equal(new.cyl_accel.packed, fresh.packed)
    assert not torch.equal(new.cyl_accel.packed, scene.cyl_accel.packed)


# --------------------------------------------------------------------------
# The committed gradient references chip_smoke.py holds the card to
# --------------------------------------------------------------------------


def test_committed_grad_reference():
    """chip_smoke.py's grad_reference phase, run on the CPU: the inverse
    scene's masked gradients and the reduced bench frames' vertex
    gradients against tests/data/torch_grad_ref.npz (f32, written by
    solr_tpu on the CPU)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    rec = {}
    chip_smoke.phase_grad_reference(rec, "cpu")
    res = rec["grad_reference"]
    mask = res["inverse"]["masked"]
    assert 0 < mask < 0.02 * res["inverse"]["size"] ** 2
    for name in ("bench", "walk"):
        assert res[name]["rows"] > 0 and res[name]["finite"]


def test_every_pool_has_finite_grads():
    """One scene with all five pools, a mirror and a glass material: the
    gradients of every params leaf and of the cylinder and ellipsoid
    geometry are finite (every root and division of the intersections
    and normals keeps its guarded form) and reach each pool."""
    from solr_tpu_torch.types import Camera, RenderConfig

    b = SceneBuilder()
    matte = b.add_material(color=(0.7, 0.6, 0.5, 1.0), specular=0.3)
    mirror = b.add_material(color=(0.9, 0.9, 0.9, 1.0), reflection=0.6)
    glass = b.add_material(color=(0.9, 0.95, 1.0, 1.0), transparency=0.8,
                           ior=1.5)
    b.add_plane(PlaneAxis.XZ, (0.0, -1.0, 2.0), (4.0, 4.0), matte)
    b.add_sphere((-1.0, 0.0, 2.0), 0.5, glass)
    b.add_cylinder((0.3, -0.8, 1.5), (0.6, 0.6, 2.2), 0.25, mirror)
    b.add_ellipsoid((1.2, 0.0, 2.5), (0.4, 0.6, 0.3), matte)
    b.add_triangle((-0.5, 0.5, 3.0), (0.5, 0.5, 3.0), (0.0, 1.2, 3.0), matte)
    b.add_light((2.0, 3.0, -1.0), intensity=1.0)
    scene = b.build(device="cpu")
    cam = Camera.create(position=(0.0, 0.2, -2.0), fov=1.0, device="cpu")
    cfg = RenderConfig(width=24, height=24, max_bounces=2)
    p = leaf_params(scene.params)
    p0 = scene.cylinders.p0.clone().requires_grad_()
    centre = scene.ellipsoids.center.clone().requires_grad_()
    s = scene.with_params(p)
    s = s.replace(cylinders=s.cylinders.replace(p0=p0),
                  ellipsoids=s.ellipsoids.replace(center=centre))
    img, depth = render_sample(s, cam, cfg)
    ((img[..., :3] ** 2).mean() + 1e-3 * torch.where(
        depth < 1e29, depth, torch.zeros_like(depth)).mean()).backward()
    g = grads_of(p)
    for k, v in g.items():
        for x in (v if isinstance(v, tuple) else (v,)):
            assert np.isfinite(x).all(), k
    for x in (p0.grad, centre.grad):
        assert torch.isfinite(x).all() and x.abs().max() > 0
    for k in ("sphere_center", "albedo", "ior", "light_position"):
        assert np.abs(g[k]).max() > 0, k
    assert sum(np.abs(x).sum() for x in g["vertices"]) > 0

"""Soft shadows, fog, the sky texture, post-processing and whole frames
with them, in the port against solr_tpu on the CPU; the reference's
soft-shadow property tests (tests/test_soft_shadows.py) on the port
alone.

The reference's draws reach the port through ``JaxKey``
(tests/torch_rng_helpers.py), so stochastic frames are compared pixel
by pixel.

Tolerances:
* ``ball_jitter``, soft ``phong_shade`` (float64, from the same surface
  points), fog and sky frames (float64) and every ``apply_postfx`` mode:
  rtol 1e-6, atol 1e-7 (``cbrt`` is u^(1/3) in float64 rounded, one ulp
  off ``jnp.cbrt`` in 12% of float32 draws: ROADMAP C11).
* Frames: atol 1e-4 outside 0.2% of pixels (ROADMAP C1, as
  tests/test_torch_pools.py); the stochastic textured frame in float64,
  where both packages render the same arithmetic without XLA's FMA
  contraction.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import solr_tpu as st
from solr_tpu.ops import postfx as jpostfx
from solr_tpu.ops import shade as jshade
from solr_tpu.ops.render import render_sample as j_render_sample
from solr_tpu.ops.traverse import scene_closest_hit as j_hit
from solr_tpu.ops.traverse import surface_at as j_surf
from solr_tpu.scenes import make_scene

from data.torch_reference import (numpy_tree, reference_bench_scene,
                                  reference_full_render, reference_render,
                                  reference_textured_scene, stereo_config)
from scenes_fixtures import cornell_box, cornell_camera
from solr_tpu_torch.bench_scene import bench_scene_arrays
from solr_tpu_torch.convert import (camera_from_numpy,
                                    config_from_reference_fields,
                                    scene_from_numpy)
from solr_tpu_torch.ops import postfx as tpostfx
from solr_tpu_torch.ops import shade as tshade
from solr_tpu_torch.ops.render import render, render_sample
from solr_tpu_torch.ops.rng import Key
from solr_tpu_torch.ops.traverse import SurfaceInfo
from solr_tpu_torch.scene import SceneBuilder
from solr_tpu_torch.textured_scene import textured_scene_parts
from solr_tpu_torch.types import Camera, PlaneAxis, RenderConfig
from torch_rng_helpers import JaxKey

# Several test workers share the cores: keep each one's intra-op pool small.
torch.set_num_threads(2)

RTOL, ATOL = 1e-6, 1e-7
FRAME_ATOL, BUDGET = 1e-4, 0.002
F64 = {np.float32: torch.float32, np.float64: torch.float64}


def _to_f64(tree):
    return jax.tree.map(lambda x: x.astype(jnp.float64)
                        if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)


def _port(jscene, jcam, jcfg, dtype=torch.float32):
    return (scene_from_numpy(numpy_tree(jscene), "cpu", dtype),
            camera_from_numpy(numpy_tree(jcam), "cpu", dtype),
            config_from_reference_fields(dataclasses.asdict(jcfg)))


def _mismatch(img, ref):
    assert img.shape == ref.shape and np.isfinite(img).all()
    return (np.abs(img - ref).max(-1) > FRAME_ATOL).mean()


# --------------------------------------------------------------------------
# Soft shadows
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ball_jitter_matches_reference(dtype):
    key = jax.random.PRNGKey(4)
    want = jshade.ball_jitter(key, (3, 50, 2), dtype)
    got = tshade.ball_jitter(JaxKey(key), (3, 50, 2), F64[dtype])
    assert got.dtype == F64[dtype]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cbrt_matches_jnp(dtype):
    u = np.random.default_rng(0).uniform(0.0, 1.0, 100_000).astype(dtype)
    u[:3] = [0.0, 1.0, 0.125]
    got = tshade.cbrt(torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(got, np.asarray(jnp.cbrt(jnp.asarray(u))),
                               rtol=RTOL)
    assert got[0] == 0.0 and got[1] == 1.0 and got[2] == 0.5


def test_ball_jitter_bounded_and_covering():
    """tests/test_soft_shadows.py's TestBallJitter with the port's Key."""
    s = tshade.ball_jitter(Key.seed(0, "cpu"), (4096,), torch.float32).numpy()
    r = np.linalg.norm(s, axis=-1)
    assert r.max() <= 1.0 + 1e-6 and r.max() > 0.9
    np.testing.assert_allclose(np.median(r), 0.5 ** (1 / 3), atol=0.03)
    np.testing.assert_allclose(s.mean(axis=0), 0.0, atol=0.05)


def _cornell64():
    return cornell_box(n_spheres=5, seed=3, dtype=np.float64).build()


def test_soft_phong_shade_matches_reference():
    """Soft shadows (4 samples) from the same surface points and key."""
    jscene = _cornell64()
    jcfg = st.RenderConfig(width=24, height=24, shadow_samples=4)
    from solr_tpu.ops.camera import camera_rays

    o, d = camera_rays(_to_f64(cornell_camera()), jcfg, None, jnp.float64)
    surf = j_surf(jscene, j_hit(jscene, o, d), o, d)
    key = jax.random.PRNGKey(9)
    want = jshade.phong_shade(jscene, surf, d, jcfg, key)
    scene, _, cfg = _port(jscene, cornell_camera(), jcfg, torch.float64)
    tsurf = SurfaceInfo(**{k: torch.as_tensor(np.array(v)) for k, v in
                           numpy_tree(surf).items()})
    tsurf = dataclasses.replace(tsurf, material=tsurf.material.long())
    got = tshade.phong_shade(scene, tsurf, torch.as_tensor(np.array(d)), cfg,
                             JaxKey(key))
    hard = tshade.phong_shade(scene, tsurf, torch.as_tensor(np.array(d)), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert (got - hard).abs().max() > 1e-3  # the jitter moved the shadows


def _penumbra(radius):
    """tests/test_soft_shadows.py's occluder scene on the port: the share
    of floor pixels in partial shadow."""
    b = SceneBuilder()
    floor = b.add_material(color=(0.9, 0.9, 0.9, 1.0))
    occ = b.add_material(color=(0.2, 0.2, 0.2, 1.0))
    b.add_plane(PlaneAxis.XZ, (0.0, 0.0, 0.0), (12.0, 12.0), floor)
    b.add_sphere((0.0, 6.0, 0.0), 0.5, occ)
    b.add_light((0.0, 9.0, 0.0), intensity=1.0, radius=radius)
    scene = b.build(device="cpu")
    cfg = RenderConfig(width=48, height=48, max_bounces=1, shadow_samples=8)
    cam = Camera.create(position=(0.0, 7.0, -7.0), angles=(0.8, 0.0, 0.0),
                        fov=1.0, device="cpu")
    key = Key.seed(0, "cpu")
    lum = render_sample(scene, cam, cfg, key)[0][..., :3].mean(-1)
    lum_ns = render_sample(scene, cam, dataclasses.replace(cfg, shadows=False),
                           key)[0][..., :3].mean(-1)
    factor = lum / torch.clamp(lum_ns, min=1e-6)
    return float(((factor > 0.15) & (factor < 0.85) & (lum_ns > 0.05))
                 .float().mean())


def test_penumbra_widens_with_the_light_radius():
    small, large = _penumbra(0.02), _penumbra(1.2)
    assert large > small * 1.5 + 0.01, (small, large)


# --------------------------------------------------------------------------
# Fog and the sky texture
# --------------------------------------------------------------------------


def _outdoor(fog, sky):
    """A floor, a mirror, a glass and a matte sphere under an open sky,
    float64, from both builders."""
    out = []
    rng = np.random.default_rng(5)
    sky_img = rng.uniform(0.0, 1.0, (16, 32, 3))
    for b in (st.SceneBuilder(dtype=np.float64), SceneBuilder()):
        tid = b.add_texture(sky_img)
        floor = b.add_material(color=(0.7, 0.7, 0.6, 1.0))
        mirror = b.add_material(color=(0.9, 0.9, 0.9, 1.0), reflection=0.8)
        glass = b.add_material(color=(0.9, 1.0, 0.9, 1.0), transparency=0.8,
                               ior=1.4)
        matte = b.add_material(color=(0.8, 0.3, 0.2, 1.0), specular=0.5)
        axis = (st.types.PlaneAxis.XZ if isinstance(b, st.SceneBuilder)
                else PlaneAxis.XZ)
        b.add_plane(axis, (0.0, -1.0, 8.0), (30.0, 30.0), floor)
        for x, m in ((-2.2, mirror), (0.0, glass), (2.2, matte)):
            b.add_sphere((x, 0.0, 4.0), 1.0, m)
        b.add_light((3.0, 6.0, -2.0))
        out.append(b)
    jb, tb = out
    jcfg = st.RenderConfig(width=32, height=24, max_bounces=3, fog=fog,
                           sky_texture=tid if sky else -1)
    info = dict(fog_start=4.0, view_distance=20.0)
    jb.info = st.SceneInfo.create(**info)
    jscene = _to_f64(jb.build())
    jcam = _to_f64(st.Camera.create(position=(0.0, 0.5, -3.0),
                                    angles=(-0.05, 0.0, 0.0), fov=1.2))
    scene, cam, cfg = _port(jscene, jcam, jcfg, torch.float64)
    return (jscene, jcam, jcfg), (scene, cam, cfg)


@pytest.mark.parametrize("fog, sky", [(True, False), (False, True),
                                      (True, True)],
                         ids=["fog", "sky", "fog-sky"])
def test_fog_and_sky_frames_match_reference(fog, sky):
    (jscene, jcam, jcfg), (scene, cam, cfg) = _outdoor(fog, sky)
    want = np.asarray(j_render_sample(jscene, jcam, jcfg)[0])
    got = render_sample(scene, cam, cfg)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    plain = render_sample(scene, cam, dataclasses.replace(
        cfg, fog=False, sky_texture=-1))[0].numpy()
    assert np.abs(got - plain).max() > 0.05  # the feature shows


# --------------------------------------------------------------------------
# Post-processing
# --------------------------------------------------------------------------


def _frame(rng, h=24, w=32):
    img = rng.uniform(0.0, 1.0, (h, w, 4)).astype(np.float32)
    depth = np.full((h, w), 6.0, np.float32)
    depth[:, w // 2:] = 2.5
    depth[h // 3: h // 2, 4:12] = 1.0
    depth += rng.uniform(0.0, 0.05, (h, w)).astype(np.float32)
    depth[-3:, -5:] = 3.0e38  # misses
    return img, depth


@pytest.mark.parametrize("mode", ["DEPTH_OF_FIELD", "AMBIENT_OCCLUSION",
                                  "ENLIGHTMENT", "CARTOON", "NONE"])
def test_apply_postfx_matches_reference(mode):
    img, depth = _frame(np.random.default_rng(1))
    jscene = cornell_box(n_spheres=2).build()
    jcam = st.Camera.create(aperture=0.2, focal_distance=2.5)
    jcfg = st.RenderConfig(width=32, height=24, postfx=st.types.PostFxConfig(
        mode=st.types.PostFxMode[mode], samples=12))
    want = jpostfx.apply_postfx(jnp.asarray(img), jnp.asarray(depth), jscene,
                                jcam, jcfg)
    scene, cam, cfg = _port(jscene, jcam, jcfg)
    got = tpostfx.apply_postfx(torch.as_tensor(img), torch.as_tensor(depth),
                               scene, cam, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    if mode != "NONE":
        assert np.abs(got.numpy() - img).max() > 1e-3


# --------------------------------------------------------------------------
# Whole frames
# --------------------------------------------------------------------------


def test_stochastic_textured_frame_matches_reference():
    """The textured scene (BASELINE config #3) cut to a 24-cell ground
    and 40x40 pixels (no whole 16-pixel tiles: the triangle BVH walk, as
    at 1080p), through render(key, spp=2): soft shadows, antialiasing
    jitter, fog, the sky, diffuse, specular, normal, bump, reflection
    and transparency maps and ambient occlusion, float64."""
    jscene, jcam, jcfg = reference_textured_scene(
        textured_scene_parts(ground_res=24), 40, 40, 3)
    jscene, jcam = _to_f64(jscene), _to_f64(jcam)
    key = jax.random.PRNGKey(0)
    want = reference_full_render(jscene, jcam, jcfg, key, spp=2)
    scene, cam, cfg = _port(jscene, jcam, jcfg, torch.float64)
    got = render(scene, cam, cfg, JaxKey(key), spp=2).numpy()
    assert _mismatch(got.astype(np.float32), want) <= BUDGET
    hard = render(scene, cam, cfg).numpy()
    assert np.abs(got - hard).max() > 0.05  # the draws show


def test_anaglyph_cornell_matches_reference():
    demo = make_scene("anaglyph", seed=0)
    jcfg = dataclasses.replace(demo.default_config, width=40, height=40)
    want = reference_render(demo.scene, demo.camera, jcfg)
    got = render_sample(*_port(demo.scene, demo.camera, jcfg))[0].numpy()
    assert _mismatch(got, want) <= BUDGET


def test_side_by_side_bench_frame_at_32x8_tiles():
    """The reduced bench frame as BASELINE config #5's single-card frame:
    SIDE_BY_SIDE with 32x8 tiles (a strip is one pixel row), packets."""
    jscene, jcam, jcfg = reference_bench_scene(bench_scene_arrays(20_000),
                                               64, 32, 2)
    jcfg = stereo_config(jcfg, 64, 32)
    want = reference_render(jscene, jcam, jcfg)
    scene, cam, cfg = _port(jscene, jcam, jcfg)
    assert (cfg.packet_tile_w, cfg.packet_tile_h) == (32, 8)
    got = render_sample(scene, cam, cfg)[0].numpy()
    assert _mismatch(got, want) <= BUDGET

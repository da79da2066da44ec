"""Texture maps in the port against solr_tpu on the CPU: the builder's
atlas and material slots, ``convert`` of a textured scene,
``sample_texture``, ``material_map_scales``, ``tangent_basis`` and
``apply_normal_maps`` on random uvs (negative and past 1, so the
addressing wraps), and the reference's property tests of the material,
normal and bump maps (tests/test_material_maps.py, test_normal_maps.py)
on the port alone.

Tolerances: the atlas, the slots and the converted scene equal; the
sampled texels, scales, bases and perturbed normals at rtol 1e-6 with
atol 1e-7 for values near zero (the same float32 arithmetic, op by
op); the shading normals of whole hits at rtol and atol 1e-5 (the hit
distance differs by ulps, as tests/test_torch_ops.py holds it at rtol
1e-5, and the bump map's one-texel differences magnify it: 3.7e-6
seen); the property tests at the reference's own tolerances.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import solr_tpu as st
from solr_tpu.ops import textures as jtex

from data.torch_reference import numpy_tree
from solr_tpu_torch.convert import config_from_reference_fields, scene_from_numpy
from solr_tpu_torch.ops import textures as ttex
from solr_tpu_torch.ops.render import render_sample
from solr_tpu_torch.ops.traverse import scene_closest_hit, surface_at
from solr_tpu_torch.scene import SceneBuilder
from solr_tpu_torch.types import TEXTURE_SLOTS, Camera, PlaneAxis, RenderConfig

# Several test workers share the cores: keep each one's intra-op pool small.
torch.set_num_threads(2)

RTOL, ATOL = 1e-6, 1e-7
SLOTS = [f"texture_{k}" for k in TEXTURE_SLOTS]


def _images(rng):
    """Textures of several sizes and kinds: RGB float, gray uint8, RGBA
    uint8, a one-row strip."""
    return [rng.uniform(0.0, 1.0, (7, 5, 3)),
            rng.integers(0, 256, (16, 16), dtype=np.uint8),
            rng.integers(0, 256, (9, 12, 4), dtype=np.uint8),
            rng.uniform(0.0, 1.0, (1, 3, 3))]


def _build_both(rng):
    """The same textured scene from both builders: every slot of some
    material set, with each texture."""
    jb, tb = st.SceneBuilder(), SceneBuilder()
    for img in _images(rng):
        assert jb.add_texture(img) == tb.add_texture(img)
    for i in range(6):
        slots = {s: int(rng.integers(-1, 4)) for s in SLOTS}
        kw = dict(color=tuple(rng.uniform(0.2, 1.0, 3)) + (1.0,),
                  specular=0.5, reflection=0.3, transparency=0.2 * (i % 2),
                  ior=1.3, **slots)
        mj, mt = jb.add_material(**kw), tb.add_material(**kw)
        for b, m in ((jb, mj), (tb, mt)):
            b.add_sphere((float(i) - 2.5, 0.0, 3.0), 0.4, m)
    jb.add_light((0.0, 5.0, -2.0))
    tb.add_light((0.0, 5.0, -2.0))
    return jb.build(), tb.build(device="cpu")


@pytest.fixture(scope="module")
def textured():
    rng = np.random.default_rng(0)
    jscene, tscene = _build_both(rng)
    return jscene, tscene, rng


def test_builder_atlas_and_slots_equal_reference(textured):
    jscene, tscene, _ = textured
    for f in ("atlas", "offset", "width", "height"):
        got = getattr(tscene.textures, f).numpy()
        want = np.asarray(getattr(jscene.textures, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert tscene.textures.count == jscene.textures.count == 4
    for f in SLOTS:
        np.testing.assert_array_equal(
            getattr(tscene.materials, f).numpy(),
            np.asarray(getattr(jscene.materials, f)), err_msg=f)


def test_convert_carries_textures_and_slots(textured):
    jscene, tscene, _ = textured
    conv = scene_from_numpy(numpy_tree(jscene), "cpu")
    for f in ("atlas", "offset", "width", "height"):
        assert torch.equal(getattr(conv.textures, f),
                           getattr(tscene.textures, f)), f
    for f in SLOTS:
        assert torch.equal(getattr(conv.materials, f),
                           getattr(tscene.materials, f)), f


def test_convert_carries_every_config_field():
    ref = st.RenderConfig(
        width=40, height=24, max_bounces=3,
        camera_mode=st.CameraMode.FISHEYE, shadows=False, shadow_samples=6,
        gradient_background=True, sky_texture=2, fog=True,
        antialias_jitter=True, compact_rays=False,
        postfx=st.types.PostFxConfig(mode=st.types.PostFxMode.ENLIGHTMENT,
                                     samples=9),
        use_bvh=False, traversal="while", packet_tile_w=32, packet_tile_h=8,
        packet_max_blocks=16, packet_tile_cand=64, packet_exact=False)
    cfg = config_from_reference_fields(dataclasses.asdict(ref))
    for f in dataclasses.fields(ref):
        if f.name in ("ray_block", "backend"):  # the reference reads neither
            continue
        got, want = getattr(cfg, f.name), getattr(ref, f.name)
        if f.name == "postfx":
            got, want = (int(got.mode), got.samples), (int(want.mode),
                                                       want.samples)
        assert got == want, f.name
    assert {f.name for f in dataclasses.fields(cfg)} == {
        f.name for f in dataclasses.fields(ref)} - {"ray_block", "backend"}


def _uvs(rng, n=400):
    return rng.uniform(-2.5, 3.5, (n, 2)).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_sample_texture_matches_reference(textured):
    jscene, tscene, rng = textured
    uv = _uvs(rng)
    tid = rng.integers(-1, 4, uv.shape[0]).astype(np.int32)
    want = jtex.sample_texture(jscene.textures, jnp.asarray(tid),
                               jnp.asarray(uv))
    got = ttex.sample_texture(tscene.textures, torch.as_tensor(tid),
                              torch.as_tensor(uv))
    _close(got, want)
    assert (got[torch.as_tensor(tid) < 0] == 1.0).all()


def test_material_map_scales_match_reference(textured):
    jscene, tscene, rng = textured
    uv = _uvs(rng)
    mat = rng.integers(0, jscene.materials.count, uv.shape[0]).astype(np.int32)
    want = jtex.material_map_scales(jscene, jnp.asarray(mat), jnp.asarray(uv))
    got = ttex.material_map_scales(tscene, torch.as_tensor(mat),
                                   torch.as_tensor(uv))
    for g, w in zip(got, want):
        _close(g, w)


def _unit_normals(rng, n=400):
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm[:8] = [[0, 0, 1], [0, 0, -1], [0, 1, 0], [1, 0, 0], [0, -1, 0],
               [-1, 0, 0], [0.6, 0.0, -0.8], [0.0, 0.8, 0.6]]
    return nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)


def test_tangent_basis_matches_reference(textured):
    _, _, rng = textured
    n = _unit_normals(rng)
    for g, w in zip(ttex.tangent_basis(torch.as_tensor(n)),
                    jtex.tangent_basis(jnp.asarray(n))):
        _close(g, w)


def test_apply_normal_maps_matches_reference(textured):
    jscene, tscene, rng = textured
    uv = _uvs(rng)
    n = _unit_normals(rng)
    mat = rng.integers(0, jscene.materials.count, uv.shape[0]).astype(np.int32)
    want = jtex.apply_normal_maps(jscene, jnp.asarray(mat), jnp.asarray(uv),
                                  jnp.asarray(n))
    got = ttex.apply_normal_maps(tscene, torch.as_tensor(mat),
                                 torch.as_tensor(uv), torch.as_tensor(n))
    _close(got, want)


def test_surface_at_applies_normal_maps_before_the_flip(textured):
    """Hits on the textured spheres from both sides: the shading normals
    (perturbed, then made to oppose the ray) match the reference's."""
    from solr_tpu.ops.traverse import scene_closest_hit as j_hit
    from solr_tpu.ops.traverse import surface_at as j_surf

    jscene, tscene, rng = textured
    o = np.stack([rng.uniform(-3.0, 3.0, 300), rng.uniform(-0.3, 0.3, 300),
                  np.where(np.arange(300) % 2, -2.0, 8.0)], -1)
    d = np.stack([np.zeros(300), np.zeros(300),
                  np.where(np.arange(300) % 2, 1.0, -1.0)], -1)
    o, d = o.astype(np.float32), d.astype(np.float32)
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    want = j_surf(jscene, j_hit(jscene, jo, jd), jo, jd)
    to, td = torch.as_tensor(o), torch.as_tensor(d)
    got = surface_at(tscene, scene_closest_hit(tscene, to, td), to, td)
    assert got.valid.sum() > 100
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    v = got.valid.numpy()
    np.testing.assert_allclose(got.shading_normal.numpy()[v],
                               np.asarray(want.shading_normal)[v],
                               rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# The reference's property tests, on the port alone
# --------------------------------------------------------------------------

CFG = RenderConfig(width=32, height=32, max_bounces=3)
WHITE = np.full((8, 8, 3), 1.0)
BLACK = np.zeros((8, 8, 3))


def _cam():
    return Camera.create(position=(0.0, 1.0, -4.0), fov=1.0, device="cpu")


def _map_scene(tex_img=None, slot=None, **mat_kw):
    """Floor and one centred sphere of the material under test
    (tests/test_material_maps.py's scene)."""
    b = SceneBuilder()
    kw = dict(mat_kw)
    if tex_img is not None:
        kw[slot] = b.add_texture(tex_img)
    m = b.add_material(color=(0.9, 0.9, 0.9, 1.0), **kw)
    floor = b.add_material(color=(0.3, 0.35, 0.4, 1.0))
    b.add_plane(PlaneAxis.XZ, (0.0, -1.0, 0.0), (20.0, 20.0), floor)
    b.add_sphere((0.0, 0.5, 0.0), 1.0, m)
    b.add_light((4.0, 8.0, -6.0), intensity=1.0)
    return b.build(device="cpu")


def _img(scene, cfg=CFG):
    return render_sample(scene, _cam(), cfg)[0].numpy()


@pytest.mark.parametrize("slot, kw", [
    ("texture_specular", dict(specular=0.9, specular_power=20.0)),
    ("texture_reflection", dict(reflection=0.8)),
])
def test_white_map_is_identity(slot, kw):
    np.testing.assert_allclose(_img(_map_scene(WHITE, slot, **kw)),
                               _img(_map_scene(**kw)), atol=2e-2)


@pytest.mark.parametrize("slot, on, off, shadows", [
    ("texture_specular", dict(specular=0.9, specular_power=20.0),
     dict(specular=0.0), True),
    ("texture_reflection", dict(reflection=0.8), dict(reflection=0.0), True),
    ("texture_transparency", dict(transparency=0.8, ior=1.5),
     dict(transparency=0.0, ior=1.5), False),
])
def test_black_map_gates_the_channel(slot, on, off, shadows):
    """A black map turns its channel off: the gated frame is the frame
    without the channel, and differs visibly from the frame with it.
    (Shadows off for transparency: the shadow factor comes from the
    material's transparency, not the map, as in the reference.)"""
    cfg = dataclasses.replace(CFG, shadows=shadows)
    full = _img(_map_scene(**on), cfg)
    without = _img(_map_scene(**off), cfg)
    gated = _img(_map_scene(BLACK, slot, **on), cfg)
    np.testing.assert_allclose(gated, without, atol=2e-2)
    assert np.abs(full - gated).max() > 0.1


def _floor(**mat_kw):
    b = SceneBuilder()
    images = mat_kw.pop("images", [])
    tids = [b.add_texture(img) for img in images]
    m = b.add_material(color=(1.0, 1.0, 1.0, 1.0),
                       **{k: tids[v] for k, v in mat_kw.items()})
    b.add_plane(PlaneAxis.XZ, (0.0, 0.0, 0.0), (10.0, 10.0), m)
    b.add_light((0.0, 50.0, 0.0), intensity=1.0)
    return b.build(device="cpu")


def _shade_down(scene):
    o = torch.tensor([[0.3, 2.0, 0.2]])
    d = torch.tensor([[0.0, -1.0, 0.0]])
    surf = surface_at(scene, scene_closest_hit(scene, o, d), o, d)
    return surf.shading_normal[0].numpy(), bool(surf.valid[0])


def test_flat_normal_map_is_identity():
    flat = np.full((8, 8, 3), [0.5, 0.5, 1.0])  # encodes (0, 0, 1)
    n0, v0 = _shade_down(_floor())
    n1, v1 = _shade_down(_floor(images=[flat], texture_normal=0))
    assert v0 and v1
    np.testing.assert_allclose(n1, n0, atol=2.5e-2)  # uint8 quantum


def test_tilted_normal_map_tilts_by_known_angle():
    a = np.deg2rad(30.0)
    enc = np.array([np.sin(a), 0.0, np.cos(a)]) * 0.5 + 0.5
    n1, valid = _shade_down(_floor(images=[np.full((8, 8, 3), enc)],
                                   texture_normal=0))
    assert valid
    np.testing.assert_allclose(float(n1[1]), np.cos(a), atol=2e-2)


def test_unmapped_lanes_untouched():
    scene = _floor(images=[np.full((8, 8, 3), 0.3)], texture_bump=0)
    rng = np.random.default_rng(1)
    n = torch.as_tensor(_unit_normals(rng, 16))
    uv = torch.as_tensor(rng.uniform(0, 1, (16, 2)).astype(np.float32))
    mat = torch.zeros((16,), dtype=torch.int32)  # material 0: no maps
    assert torch.equal(ttex.apply_normal_maps(scene, mat, uv, n), n)


def test_constant_height_bump_is_identity():
    n0, _ = _shade_down(_floor())
    n1, valid = _shade_down(_floor(images=[np.full((8, 8, 3), 0.6)],
                                   texture_bump=0))
    assert valid
    np.testing.assert_allclose(n1, n0, atol=1e-5)


def test_ramp_bump_tilts_the_normal():
    ramp = np.tile(np.linspace(0.25, 0.75, 32)[None, :, None], (32, 1, 3))
    n0, _ = _shade_down(_floor())
    n1, valid = _shade_down(_floor(images=[ramp], texture_bump=0))
    assert valid and np.linalg.norm(n1 - n0) > 1e-3
    np.testing.assert_allclose(np.linalg.norm(n1), 1.0, rtol=1e-5)
    assert n1[1] > 0.5

"""BASELINE config #3 as one scene: glass spheres of four indices of
refraction, an amber glass ellipsoid and a mirror over a textured
terrain, 3 bounces, built without the reference package.

It joins two scenes of the reference's gallery: the glass scene
(solr_tpu/scenes/gallery.py:299-323: its glass spheres, ellipsoid,
mirror plane, light and camera) with the terrain scene's heightfield
mesh (:280-289, ``height_mesh`` of solr_tpu_torch.scenes.gallery, res
96, 18,432 triangles) in
place of its checker plane.  The mesh starts at z = -10 instead of 5,
so that it lies under the glass.  Its per-vertex uvs repeat the
textures ``UV_REPEAT`` times across it.  Seven 256x256 textures, made
with numpy from ``seed``: the terrain's diffuse, bump and specular maps,
a normal map on the amber ellipsoid, a reflection map on the mirror, a
transparency map on the third glass sphere, and the sky: every texture
slot of a material is used.  The bump and normal maps are smooth (value
noise of 4 to 16 cells): a map with detail finer than a pixel's
footprint aliases, and a pixel's value then hangs on the last bits of
its hit point (at 64x64 a pixel covers dozens of texels of the
terrain).  The frame has fog, soft shadows (4 samples),
antialiasing jitter and screen-space ambient occlusion.

``textured_scene_parts`` returns the arrays and settings, so a test can
build the same scene with ``solr_tpu.SceneBuilder``; ``textured_scene``
builds this package's scene, camera and config.
"""

from __future__ import annotations

import numpy as np

from solr_tpu_torch.scene import SceneBuilder
from solr_tpu_torch.scenes.gallery import height_mesh
from solr_tpu_torch.types import (Camera, PlaneAxis, PostFxConfig,
                                  PostFxMode, RenderConfig, SceneInfo)

__all__ = ["textured_scene_parts", "textured_scene"]

EXTENT = 20.0
Z0 = -10.0
UV_REPEAT = 2.0
TEX_SIZE = 256
GLASS_IORS = (1.1, 1.33, 1.5, 1.8)
# The glass sphere that carries the transparency map.
MAPPED_GLASS = 2


def _height(x, z):
    """The terrain gallery's height function (gallery.py:273-278)."""
    return (2.0 * np.sin(x * 0.25) * np.cos(z * 0.25)
            + 0.7 * np.sin(x * 1.1 + 2.0) * np.cos(z * 0.9) - 4.0)


def _terrain_mesh(res):
    """Vertices (V, 3), faces (F, 3) and uvs (V, 2) of the heightfield
    (the gallery's ``height_mesh`` of ``_height``)."""
    v, f = height_mesh(res, EXTENT, Z0, _height)
    uv = np.stack([(v[:, 0] + EXTENT) / (2 * EXTENT),
                   (v[:, 2] - Z0) / (2 * EXTENT)], -1)
    return v, f, (uv * UV_REPEAT).astype(np.float32)


def _noise(rng, cells, size=TEX_SIZE):
    """Tiling value noise in [0, 1]: a cells x cells grid of uniform
    values, bilinearly interpolated to size x size."""
    g = rng.uniform(0.0, 1.0, (cells, cells))
    x = np.arange(size) * (cells / size)
    i0 = np.floor(x).astype(np.int64)
    f = (x - i0)[:, None]
    i1 = (i0 + 1) % cells
    rows = g[i0] * (1.0 - f) + g[i1] * f  # interpolate along y
    return rows[:, i0] * (1.0 - f.T) + rows[:, i1] * f.T


def _normal_map(height):
    """Tangent-space normals of a tiling height field, encoded as RGB
    in [0, 1] (n * 0.5 + 0.5)."""
    gx = (np.roll(height, -1, 1) - np.roll(height, 1, 1)) * 16.0
    gy = (np.roll(height, -1, 0) - np.roll(height, 1, 0)) * 16.0
    n = np.stack([-gx, -gy, np.ones_like(gx)], -1)
    return n / np.linalg.norm(n, axis=-1, keepdims=True) * 0.5 + 0.5


def _textures(rng):
    """The seven float images in [0, 1]."""
    n = 0.6 * _noise(rng, 8) + 0.3 * _noise(rng, 32) + 0.1 * _noise(rng, 128)
    grass = np.asarray([0.35, 0.5, 0.2])
    rock = np.asarray([0.6, 0.52, 0.4])
    diffuse = grass + (rock - grass) * n[..., None]
    specular = np.clip(1.5 * n - 0.4, 0.0, 1.0)  # the rock shines
    bump = 0.6 * _noise(rng, 4) + 0.4 * _noise(rng, 16)
    normal = _normal_map(_noise(rng, 4) + 0.3 * _noise(rng, 8))
    cells = rng.uniform(0.2, 1.0, (8, 8))
    reflection = np.kron(cells, np.ones((TEX_SIZE // 8, TEX_SIZE // 8)))
    transparency = np.clip(0.2 + 1.6 * (_noise(rng, 6) - 0.3), 0.2, 1.0)
    t = np.linspace(0.0, 1.0, TEX_SIZE)[:, None, None]
    zenith, horizon = np.asarray([0.25, 0.45, 0.85]), np.asarray([0.9, 0.9, 1.0])
    clouds = np.clip(_noise(rng, 16) * 1.6 - 0.6, 0.0, 1.0)[..., None]
    sky = horizon + (zenith - horizon) * np.abs(1.0 - 2.0 * t)
    sky = sky * (1.0 - clouds) + clouds
    return dict(diffuse=diffuse, bump=bump, specular=specular, normal=normal,
                reflection=reflection, transparency=transparency, sky=sky)


def textured_scene_parts(seed: int = 0, ground_res: int = 96) -> dict:
    """The textures, the terrain mesh, the materials, primitives, light,
    camera, scene info and render settings of the textured frame.
    Build in this order: textures (in ``texture_order``), the terrain
    material and mesh, each glass material and sphere, the amber
    material and ellipsoid, the mirror material and plane, the light."""
    rng = np.random.default_rng(seed)
    vertices, faces, uvs = _terrain_mesh(ground_res)
    glass = [dict(color=(0.9, 0.95, 1.0, 1.0), transparency=0.9, ior=ior,
                  specular=0.9, specular_power=60.0) for ior in GLASS_IORS]
    return dict(
        textures=_textures(rng),
        texture_order=("diffuse", "bump", "specular", "normal", "reflection",
                       "transparency", "sky"),
        vertices=vertices, faces=faces, uvs=uvs,
        terrain_material=dict(color=(0.9, 0.9, 0.9, 1.0), specular=0.2),
        terrain_maps=dict(texture_diffuse="diffuse", texture_bump="bump",
                          texture_specular="specular"),
        glass_materials=glass,
        glass_spheres=[((-3.0 + 2.0 * i, -0.2, 1.0), 0.8)
                       for i in range(len(GLASS_IORS))],
        glass_maps={MAPPED_GLASS: dict(texture_transparency="transparency")},
        amber_material=dict(color=(1.0, 0.8, 0.4, 1.0), transparency=0.85,
                            ior=1.45),
        amber_maps=dict(texture_normal="normal"),
        ellipsoid=((0.0, -0.55, -1.5), (1.2, 0.45, 0.6)),
        mirror_material=dict(color=(0.95, 0.95, 0.95, 1.0), reflection=0.85,
                             specular=0.9),
        mirror_maps=dict(texture_reflection="reflection"),
        mirror_plane=(PlaneAxis.XY, (0.0, 2.0, 6.0), (8.0, 3.0)),
        light=dict(position=(4.0, 7.0, -4.0), intensity=1.0, radius=0.5),
        camera=dict(position=(0.0, 0.8, -6.0), fov=0.9, angles=(0.1, 0.0, 0.0)),
        info=dict(fog_start=15.0, view_distance=45.0),
        config=dict(shadow_samples=4, antialias_jitter=True, fog=True,
                    postfx_mode=PostFxMode.AMBIENT_OCCLUSION),
        sky="sky",
    )


def textured_scene(width: int = 1920, height: int = 1080, bounces: int = 3,
                   seed: int = 0, ground_res: int = 96, device="cuda"):
    """(scene, camera, config) of the textured frame on ``device``."""
    a = textured_scene_parts(seed, ground_res)
    b = SceneBuilder()
    tid = {name: b.add_texture(a["textures"][name])
           for name in a["texture_order"]}

    def maps(m):
        return {slot: tid[name] for slot, name in m.items()}

    terrain = b.add_material(**a["terrain_material"],
                             **maps(a["terrain_maps"]))
    b.add_mesh(a["vertices"], a["faces"], terrain, uvs=a["uvs"])
    for i, (mat, (c, r)) in enumerate(zip(a["glass_materials"],
                                          a["glass_spheres"])):
        g = b.add_material(**mat, **maps(a["glass_maps"].get(i, {})))
        b.add_sphere(c, r, g)
    b.add_ellipsoid(*a["ellipsoid"], b.add_material(**a["amber_material"],
                                                    **maps(a["amber_maps"])))
    mirror = b.add_material(**a["mirror_material"], **maps(a["mirror_maps"]))
    b.add_plane(*a["mirror_plane"], mirror)
    b.add_light(**a["light"])
    scene = b.build(device=device)
    scene = scene.replace(info=SceneInfo.create(**a["info"], device=device))
    c = dict(a["config"])
    cfg = RenderConfig(width=width, height=height, max_bounces=bounces,
                       sky_texture=tid[a["sky"]],
                       postfx=PostFxConfig(mode=c.pop("postfx_mode")), **c)
    return scene, Camera.create(device=device, **a["camera"]), cfg

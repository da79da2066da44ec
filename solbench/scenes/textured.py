"""The textured scene kind (BASELINE config #3): glass spheres of four
indices of refraction, an amber glass ellipsoid and a mirror plane over
a textured heightfield terrain, under a textured sky.

``make_inputs`` is a frozen copy of the program's seeded generators
(``solr_tpu_torch.textured_scene``: ``_noise``, ``_normal_map``,
``_textures`` and the terrain of ``_terrain_mesh`` through the gallery's
``height_mesh``); a test holds the copy equal to
``textured_scene_parts`` array for array.  The configuration file holds
the rest of the scene: materials and their map slots, the primitives,
the light, the camera, the scene info and the render settings.
``build_port`` hands it all to the system under test through
``SceneBuilder.add_texture``, ``add_material``, ``add_mesh(..., uvs=)``,
``add_sphere``, ``add_ellipsoid``, ``add_plane``, ``add_light``,
``.build``, ``SceneInfo.create`` and ``Camera.create``.
"""

from __future__ import annotations

import numpy as np

# The configuration keys that cut the kind to the CPU tests' size: an
# 8-cell ground (128 triangles, still over the BVH threshold).
TINY = {"ground_res": 8}


def _height(x, z):
    """The terrain gallery scene's height function."""
    return (2.0 * np.sin(x * 0.25) * np.cos(z * 0.25)
            + 0.7 * np.sin(x * 1.1 + 2.0) * np.cos(z * 0.9) - 4.0)


def height_mesh(res: int, extent: float, z0: float, fn):
    """A height field y = fn(x, z) over x in [-extent, extent], z in
    [z0, z0 + 2 extent] on a (res + 1)^2 grid: (vertices (V, 3) float32,
    faces (2 res^2, 3)), two triangles per cell."""
    xs = np.linspace(-extent, extent, res + 1, dtype=np.float32)
    zs = np.linspace(z0, z0 + 2 * extent, res + 1, dtype=np.float32)
    xg, zg = np.meshgrid(xs, zs)
    yg = fn(xg, zg).astype(np.float32)
    v = np.stack([xg, yg, zg], -1).reshape(-1, 3)
    idx = np.arange((res + 1) ** 2).reshape(res + 1, res + 1)
    q00 = idx[:-1, :-1].ravel()
    q10 = idx[:-1, 1:].ravel()
    q01 = idx[1:, :-1].ravel()
    q11 = idx[1:, 1:].ravel()
    f = np.concatenate(
        [np.stack([q00, q10, q11], -1), np.stack([q00, q11, q01], -1)])
    return v, f


def terrain_mesh(res: int, extent: float, z0: float, uv_repeat: float):
    """Vertices (V, 3), faces (F, 3) and uvs (V, 2) of the terrain: the
    uvs span [0, uv_repeat] across it, so the maps repeat uv_repeat
    times."""
    v, f = height_mesh(res, extent, z0, _height)
    uv = np.stack([(v[:, 0] + extent) / (2 * extent),
                   (v[:, 2] - z0) / (2 * extent)], -1)
    return v, f, (uv * uv_repeat).astype(np.float32)


def _noise(rng, cells: int, size: int):
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
    """Tangent-space normals of a tiling height field, encoded as RGB in
    [0, 1] (n * 0.5 + 0.5)."""
    gx = (np.roll(height, -1, 1) - np.roll(height, 1, 1)) * 16.0
    gy = (np.roll(height, -1, 0) - np.roll(height, 1, 0)) * 16.0
    n = np.stack([-gx, -gy, np.ones_like(gx)], -1)
    return n / np.linalg.norm(n, axis=-1, keepdims=True) * 0.5 + 0.5


def textures(seed: int, size: int) -> dict:
    """The seven float images in [0, 1], size x size, drawn from one
    stream seeded by ``seed``: the terrain's diffuse, bump and specular
    maps, the ellipsoid's normal map, the mirror's reflection map, the
    glass sphere's transparency map and the sky."""
    rng = np.random.default_rng(seed)

    def noise(cells):
        return _noise(rng, cells, size)

    n = 0.6 * noise(8) + 0.3 * noise(32) + 0.1 * noise(128)
    grass = np.asarray([0.35, 0.5, 0.2])
    rock = np.asarray([0.6, 0.52, 0.4])
    diffuse = grass + (rock - grass) * n[..., None]
    specular = np.clip(1.5 * n - 0.4, 0.0, 1.0)  # the rock shines
    bump = 0.6 * noise(4) + 0.4 * noise(16)
    normal = _normal_map(noise(4) + 0.3 * noise(8))
    cells = rng.uniform(0.2, 1.0, (8, 8))
    reflection = np.kron(cells, np.ones((size // 8, size // 8)))
    transparency = np.clip(0.2 + 1.6 * (noise(6) - 0.3), 0.2, 1.0)
    t = np.linspace(0.0, 1.0, size)[:, None, None]
    zenith = np.asarray([0.25, 0.45, 0.85])
    horizon = np.asarray([0.9, 0.9, 1.0])
    clouds = np.clip(noise(16) * 1.6 - 0.6, 0.0, 1.0)[..., None]
    sky = horizon + (zenith - horizon) * np.abs(1.0 - 2.0 * t)
    sky = sky * (1.0 - clouds) + clouds
    return dict(diffuse=diffuse, bump=bump, specular=specular, normal=normal,
                reflection=reflection, transparency=transparency, sky=sky)


def make_inputs(config: dict, seed: int) -> dict:
    """The raw inputs: the configuration's textures (drawn from its
    ``texture_seed``) and its terrain mesh, with the mesh's faces in an
    order drawn from ``seed``.  So every seed gives the same scene and
    the same work, and the seed still changes what the program is
    handed: the order of the terrain's triangles."""
    g = config["ground"]
    vertices, faces, uvs = terrain_mesh(int(config["ground_res"]),
                                        g["extent"], g["z0"],
                                        g["uv_repeat"])
    order = np.random.default_rng(seed).permutation(faces.shape[0])
    return dict(textures=textures(int(config["texture_seed"]),
                                  int(config["texture_size"])),
                vertices=vertices, faces=faces[order], uvs=uvs)


def build_port(raw: dict, config: dict, device):
    """(scene, camera) of the system under test: the textures in the
    configuration's ``texture_order``, then the terrain, the glass
    spheres, the amber ellipsoid, the mirror plane and the light, each
    after its material; then the scene info."""
    from solr_tpu_torch import (Camera, PlaneAxis, SceneBuilder,
                                SceneInfo)

    b = SceneBuilder()
    tid = {name: b.add_texture(raw["textures"][name])
           for name in config["texture_order"]}

    def material(mat, maps):
        return b.add_material(**mat, **{slot: tid[name]
                                        for slot, name in maps.items()})

    terrain = material(config["terrain_material"], config["terrain_maps"])
    b.add_mesh(raw["vertices"], raw["faces"], terrain, uvs=raw["uvs"])
    for i, (mat, (c, r)) in enumerate(zip(config["glass_materials"],
                                          config["glass_spheres"])):
        b.add_sphere(c, r, material(mat, config["glass_maps"].get(str(i),
                                                                  {})))
    b.add_ellipsoid(*config["ellipsoid"],
                    material(config["amber_material"], config["amber_maps"]))
    plane = config["mirror_plane"]
    b.add_plane(PlaneAxis[plane["axis"]], plane["origin"],
                plane["half_extents"],
                material(config["mirror_material"], config["mirror_maps"]))
    b.add_light(**config["light"])
    scene = b.build(block=config["block"],
                    bvh_threshold=config["bvh_threshold"], device=device)
    scene = scene.replace(info=SceneInfo.create(**config["info"],
                                                device=device))
    cam = Camera.create(device=device, **config["camera"])
    return scene, cam

"""The bench frame's scene (bench.py:66-132), built without the reference
package: a terrain heightfield of about ``n_tris`` triangles, 24 mirror
spheres and one light, seen from a camera tilted down over the terrain.

``bench_scene_arrays`` returns the raw numpy arrays and settings, so a
test can feed the same scene to ``solr_tpu.SceneBuilder``;
``bench_scene`` builds this package's scene, camera and config.
"""

from __future__ import annotations

import numpy as np

from solr_tpu_torch.scene import SceneBuilder
from solr_tpu_torch.types import Camera, RenderConfig

__all__ = ["bench_scene_arrays", "bench_scene"]

EXTENT = 40.0


def bench_scene_arrays(n_tris: int, seed: int = 42) -> dict:
    """Vertices, faces, spheres, light, materials, camera and packet
    settings of the bench frame, as bench.py makes them."""
    rng = np.random.default_rng(seed)
    gw = int(np.sqrt(n_tris / 2.0))
    gh = max(n_tris // (2 * gw), 1)
    xs = np.linspace(-EXTENT, EXTENT, gw + 1, dtype=np.float32)
    zs = np.linspace(5.0, 5.0 + 2 * EXTENT, gh + 1, dtype=np.float32)
    xg, zg = np.meshgrid(xs, zs)
    yg = (
        2.0 * np.sin(xg * 0.25) * np.cos(zg * 0.25)
        + 0.7 * np.sin(xg * 1.1 + 2.0) * np.cos(zg * 0.9)
        + 0.25 * np.sin(xg * 3.7) * np.sin(zg * 4.1)
        - 4.0
    ).astype(np.float32)
    verts = np.stack([xg, yg, zg], axis=-1).reshape(-1, 3)
    idx = np.arange((gh + 1) * (gw + 1)).reshape(gh + 1, gw + 1)
    q00 = idx[:-1, :-1].reshape(-1)
    q10 = idx[:-1, 1:].reshape(-1)
    q01 = idx[1:, :-1].reshape(-1)
    q11 = idx[1:, 1:].reshape(-1)
    faces = np.concatenate([np.stack([q00, q10, q11], axis=-1),
                            np.stack([q00, q11, q01], axis=-1)])
    centers, radii = [], []
    for _ in range(24):
        x = rng.uniform(-EXTENT * 0.8, EXTENT * 0.8)
        z = rng.uniform(10.0, 5.0 + 1.8 * EXTENT)
        centers.append((x, -1.5, z))
        radii.append(rng.uniform(0.8, 2.0))
    return dict(
        vertices=verts,
        faces=faces,
        sphere_centers=np.asarray(centers, np.float64),
        sphere_radii=np.asarray(radii, np.float64),
        light_position=(0.0, EXTENT, 10.0),
        light_intensity=1.0,
        terrain_material=dict(color=(0.55, 0.5, 0.4, 1.0), specular=0.2),
        mirror_material=dict(color=(0.9, 0.9, 0.9, 1.0), reflection=0.6,
                             specular=0.8),
        camera=dict(position=(0.0, 2.0, -4.0), angles=(0.25, 0.0, 0.0),
                    fov=1.0),
        config=dict(gradient_background=True, packet_tile_w=16,
                    packet_tile_h=16, packet_max_blocks=64,
                    packet_tile_cand=256),
        bvh_threshold=64,
    )


def bench_scene(n_tris: int = 1_000_000, block: int = 512, width: int = 512,
                height: int = 512, bounces: int = 2, seed: int = 42,
                device="cpu"):
    """(scene, camera, config) of the bench frame on ``device``."""
    a = bench_scene_arrays(n_tris, seed)
    b = SceneBuilder()
    terrain = b.add_material(**a["terrain_material"])
    mirror = b.add_material(**a["mirror_material"])
    b.add_mesh(a["vertices"], a["faces"], terrain)
    for c, r in zip(a["sphere_centers"], a["sphere_radii"]):
        b.add_sphere(tuple(c), float(r), mirror)
    b.add_light(a["light_position"], intensity=a["light_intensity"])
    scene = b.build(block=block, bvh_threshold=a["bvh_threshold"],
                    device=device)
    cam = Camera.create(device=device, **a["camera"])
    cfg = RenderConfig(width=width, height=height, max_bounces=bounces,
                       **a["config"])
    return scene, cam, cfg

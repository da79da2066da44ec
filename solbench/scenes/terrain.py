"""The terrain scene kind: a heightfield of about ``n_tris`` triangles,
mirror spheres and one point light, as the bench frame makes them.

``bench_arrays`` is a frozen copy of the program's seeded generator
(``solr_tpu_torch.bench_scene.bench_scene_arrays``), so a later change
to the program cannot move the yardstick; a test holds the two equal.
``build_port`` hands the raw inputs to the system under test through
its public API.
"""

from __future__ import annotations

import numpy as np


def bench_arrays(n_tris: int, extent: float, n_spheres: int, seed: int):
    """The bench frame's terrain (fixed) and mirror spheres (drawn from
    ``seed``), as the program's ``bench_scene_arrays`` makes them."""
    rng = np.random.default_rng(seed)
    gw = int(np.sqrt(n_tris / 2.0))
    gh = max(n_tris // (2 * gw), 1)
    xs = np.linspace(-extent, extent, gw + 1, dtype=np.float32)
    zs = np.linspace(5.0, 5.0 + 2 * extent, gh + 1, dtype=np.float32)
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
    for _ in range(n_spheres):
        x = rng.uniform(-extent * 0.8, extent * 0.8)
        z = rng.uniform(10.0, 5.0 + 1.8 * extent)
        centers.append((x, -1.5, z))
        radii.append(rng.uniform(0.8, 2.0))
    return dict(vertices=verts, faces=faces,
                sphere_centers=np.asarray(centers, np.float64),
                sphere_radii=np.asarray(radii, np.float64))


def make_inputs(config: dict, seed: int) -> dict:
    """The raw inputs: the bench frame with its spheres placed by the
    configuration's ``sphere_seed``, and handed over in an order drawn
    from ``seed``.  So every seed gives the same work (where the spheres
    stand moves the exactness net's work by a third), and the seed still
    changes what the program is handed."""
    raw = bench_arrays(int(config["n_tris"]), float(config["extent"]),
                       int(config["n_spheres"]), int(config["sphere_seed"]))
    order = np.random.default_rng(seed).permutation(config["n_spheres"])
    raw["sphere_centers"] = raw["sphere_centers"][order]
    raw["sphere_radii"] = raw["sphere_radii"][order]
    return raw


def build_port(raw: dict, config: dict, device):
    """(scene, camera) of the system under test, built from ``raw``
    through ``SceneBuilder``, ``.build`` and ``Camera.create``."""
    from solr_tpu_torch import Camera, SceneBuilder

    mats = config["materials"]
    b = SceneBuilder()
    terrain = b.add_material(**mats["terrain"])
    mirror = b.add_material(**mats["mirror"])
    b.add_mesh(raw["vertices"], raw["faces"], terrain)
    for c, r in zip(raw["sphere_centers"], raw["sphere_radii"]):
        b.add_sphere(tuple(c), float(r), mirror)
    light = config["light"]
    b.add_light(tuple(light["position"]), color=tuple(light["color"]),
                intensity=light["intensity"], radius=light["radius"])
    scene = b.build(block=config["block"],
                    bvh_threshold=config["bvh_threshold"], device=device)
    cam = Camera.create(device=device, **config["camera"])
    return scene, cam

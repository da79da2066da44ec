"""Inputs of the BVH walk tests, shared by the CPU, emulated and card
tests (no JAX here): fractional and emissive materials, shadow rays
toward a scene's light, scenes with every primitive twice, and a count
of the tied pairs that straddle two leaves."""

from __future__ import annotations

import numpy as np
import torch

from solr_tpu_torch.kernel_shapes import shadow_rays
from solr_tpu_torch.scene import SceneBuilder
from solr_tpu_torch.types import Camera, RenderConfig
from solr_tpu_torch.ops.camera import camera_rays


def fractional_materials(scene, seed: int = 0):
    """``scene`` with every material's transparency drawn in
    [0.35, 0.95) and every third non-emissive material made emissive,
    so the shadow walks meet fractional factors and emissive occluders
    (whose factor is 1)."""
    mats = scene.materials
    rng = np.random.default_rng(seed)
    n = mats.count
    trans = torch.as_tensor(rng.uniform(0.35, 0.95, n), dtype=torch.float32,
                            device=mats.color.device)
    emis = mats.emission.clone()
    plain = (emis <= 0).nonzero().squeeze(1)
    emis[plain[1::3]] = 0.5
    return scene.replace(materials=mats.replace(transparency=trans,
                                                emission=emis))


def shadow_rays_to_light(scene, o, d, hit):
    """Shadow rays (R, 3) toward the first light from the hits of rays
    o, d (R, 3), misses parked: (so, sd, t_max)."""
    so, sd, tm, _ = shadow_rays(scene, o[None], d[None], hit)
    return so[0], sd[0], tm[0]


def tie_scene(prim: str, size: int, n: int = 120, seed: int = 1,
              device="cpu"):
    """A field of ``n`` random primitives of kind ``prim``, each added
    twice in a row, in front of a camera at the origin; returns (scene,
    o, d) with the size x size frame's rays.  The Morton order is stable,
    so the two copies of a primitive sit at pool rows 2k and 2k + 1."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-2.0, 2.0, (n, 3)) + [0.0, 0.0, 6.0]
    b = SceneBuilder()
    m = b.add_material(color=(0.7, 0.6, 0.5, 1.0))
    if prim == "tri":
        v = np.repeat(c[:, None] + rng.normal(0.0, 0.5, (n, 3, 3)), 2, 0)
        b.add_triangles_raw(v[:, 0], v[:, 1], v[:, 2], m)
    for i in range(n if prim != "tri" else 0):
        for _ in range(2):
            if prim == "sphere":
                b.add_sphere(c[i], 0.15 + 0.3 * (i % 3) / 3.0, m)
            else:
                b.add_cylinder(c[i], c[i] + [0.3, 0.4 * (i % 2), 0.2], 0.1, m)
    scene = b.build(device=device)  # no light: it would join the spheres
    o, d = camera_rays(Camera.create(position=(0.0, 0.0, 0.0), fov=1.2,
                                     device=device),
                       RenderConfig(width=size, height=size))
    return scene, o, d


def cross_leaf_pairs(tree, idx) -> int:
    """How many of the hit rows ``idx`` (each the first copy of a pair)
    have their second copy in another leaf of ``tree``."""
    first = tree.first_prim.cpu().numpy()
    count = tree.prim_count.cpu().numpy()
    leaf = first >= 0
    n = int((first[leaf] + count[leaf]).max())
    leaf_of = np.empty(n, np.int64)
    for k, (f, c) in enumerate(zip(first[leaf], count[leaf])):
        leaf_of[f:f + c] = k
    i = idx.cpu().numpy().astype(np.int64)
    return int((leaf_of[i] != leaf_of[np.minimum(i + 1, n - 1)]).sum())

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


def tri_field(n: int = 1500, seed: int = 2, device="cpu"):
    """A field of ``n`` random triangles in front of the origin, each with
    one of five materials: opaque (transparency 0), three fractional
    ones and an emissive one, so shadow rays stop early in some walks
    and multiply fractional factors in others.  Returns (scene, o, d)
    with 4,096 rays from a small box near the origin into the field."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    mats = [b.add_material(transparency=0.0),
            b.add_material(transparency=0.4), b.add_material(transparency=0.7),
            b.add_material(transparency=0.9),
            b.add_material(transparency=0.2, emission=0.5)]
    c = rng.uniform(-3.0, 3.0, (n, 3)) + [0.0, 0.0, 8.0]
    v = c[:, None] + rng.normal(0.0, 0.35, (n, 3, 3))
    b.add_triangles_raw(v[:, 0], v[:, 1], v[:, 2],
                        np.asarray(mats)[rng.integers(0, 5, n)])
    scene = b.build(device=device)
    o = rng.uniform(-0.5, 0.5, (4096, 3))
    d = rng.uniform(-3.0, 3.0, (4096, 3)) + [0.0, 0.0, 8.0] - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (scene,) + tuple(torch.as_tensor(x, dtype=torch.float32,
                                            device=device) for x in (o, d))


def near_second_tie_scene(device="cpu"):
    """Two leaves of 8 triangles that share one triangle: its first copy
    is the last row of the left leaf (row 7), its second the first row
    of the right leaf (row 8).  The left leaf's other triangles lie
    behind the shared one (z 6.5-9), the right leaf's in front of it (z
    1-4), both off the rays, so the right leaf's box is the nearer one:
    a near-first walk finds the second copy first, and only the tie
    rule gives row 7.  The Morton order puts the left leaf's triangles
    first (x about -3), then the shared one (x 0.3, y -0.2), then the
    right leaf's (x about 3, y about 1.2).  Returns (scene, o, d) with
    64 rays along +z, which all hit the shared triangle at z = 5."""
    b = SceneBuilder()
    m = b.add_material(color=(0.7, 0.6, 0.5, 1.0))
    shared = np.array([[-0.3, -0.6, 5.0], [0.9, -0.6, 5.0], [0.3, 0.6, 5.0]])
    tri = [shared, shared]
    for i in range(7):
        tri.append(np.array([[-3.2 + 0.05 * i, -1.5, 6.5 + 0.3 * i],
                             [-3.0 + 0.05 * i, -1.0, 7.0 + 0.3 * i],
                             [-3.1 + 0.05 * i, -1.2, 7.5 + 0.3 * i]]))
        tri.append(np.array([[2.9 + 0.05 * i, 1.0, 1.0 + 0.3 * i],
                             [3.1 + 0.05 * i, 1.5, 1.5 + 0.3 * i],
                             [3.0 + 0.05 * i, 1.2, 2.0 + 0.3 * i]]))
    v = np.stack(tri)
    b.add_triangles_raw(v[:, 0], v[:, 1], v[:, 2], m)
    scene = b.build(bvh_threshold=16, device=device)
    g = (np.arange(8) - 3.5) * 0.04
    gx, gy = np.meshgrid(g + 0.3, g - 0.1, indexing="ij")
    o = np.stack([gx, gy, np.zeros_like(gx)], -1).reshape(-1, 3)
    d = np.tile([0.0, 0.0, 1.0], (o.shape[0], 1))
    return (scene,) + tuple(torch.as_tensor(x, dtype=torch.float32,
                                            device=device) for x in (o, d))

"""Inputs of the BVH walk tests, shared by the CPU, emulated and card
tests (no JAX here): fractional and emissive materials, shadow rays
toward a scene's light, scenes with every primitive twice, a count of
the tied pairs that straddle two leaves, random fields, and trees made
stale by moving a primitive out of its leaf box."""

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


# tri_field's materials: (transparency, emission) of an opaque, three
# fractional and an emissive one.
FIELD_MATERIALS = ((0.0, 0.0), (0.4, 0.0), (0.7, 0.0), (0.9, 0.0), (0.2, 0.5))


def tri_field_arrays(n: int = 1500, seed: int = 2):
    """tri_field's inputs in numpy: vertices (n, 3, 3), each triangle's
    index into FIELD_MATERIALS (n,), and the rays o, d (4096, 3)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-3.0, 3.0, (n, 3)) + [0.0, 0.0, 8.0]
    v = c[:, None] + rng.normal(0.0, 0.35, (n, 3, 3))
    mat = rng.integers(0, len(FIELD_MATERIALS), n)
    o = rng.uniform(-0.5, 0.5, (4096, 3))
    d = rng.uniform(-3.0, 3.0, (4096, 3)) + [0.0, 0.0, 8.0] - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return v, mat, o, d


def tri_field(n: int = 1500, seed: int = 2, device="cpu"):
    """A field of ``n`` random triangles in front of the origin, each with
    one of five materials: opaque (transparency 0), three fractional
    ones and an emissive one, so shadow rays stop early in some walks
    and multiply fractional factors in others.  Returns (scene, o, d)
    with 4,096 rays from a small box near the origin into the field."""
    v, mat, o, d = tri_field_arrays(n, seed)
    b = SceneBuilder()
    mats = [b.add_material(transparency=t, emission=e)
            for t, e in FIELD_MATERIALS]
    b.add_triangles_raw(v[:, 0], v[:, 1], v[:, 2], np.asarray(mats)[mat])
    scene = b.build(device=device)
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


def near_second_tie_cyl_scene(device="cpu"):
    """near_second_tie_scene with cylinders: two leaves of 8 that share
    one cylinder (along x, radius 0.3, at z 5), its first copy the last
    row of the left leaf (row 7), its second the first row of the right
    leaf (row 8).  The left leaf's other cylinders lie behind it (z
    6.5-9, x about -3), the right leaf's in front of it (z 1-4, x about
    3, y about 1.2), both off the rays, so the right leaf's box is the
    nearer one.  Returns (scene, o, d) with 64 rays along +z, which all
    hit the shared cylinder's side near z = 4.7."""
    b = SceneBuilder()
    m = b.add_material(color=(0.7, 0.6, 0.5, 1.0))
    for i in range(7):
        z = 6.5 + 0.3 * i
        b.add_cylinder((-3.3 + 0.05 * i, -1.2, z), (-2.9 + 0.05 * i, -1.2, z),
                       0.1, m)
    for _ in range(2):
        b.add_cylinder((-0.3, -0.1, 5.0), (0.9, -0.1, 5.0), 0.3, m)
    for i in range(7):
        z = 1.0 + 0.3 * i
        b.add_cylinder((2.8 + 0.05 * i, 1.2, z), (3.2 + 0.05 * i, 1.2, z),
                       0.1, m)
    scene = b.build(bvh_threshold=16, device=device)
    g = (np.arange(8) - 3.5) * 0.03
    gx, gy = np.meshgrid(g + 0.3, g - 0.1, indexing="ij")
    o = np.stack([gx, gy, np.zeros_like(gx)], -1).reshape(-1, 3)
    d = np.tile([0.0, 0.0, 1.0], (o.shape[0], 1))
    return (scene,) + tuple(torch.as_tensor(x, dtype=torch.float32,
                                            device=device) for x in (o, d))


def cyl_field(n: int = 1200, seed: int = 6, device="cpu"):
    """A field of ``n`` random short cylinders in front of the origin,
    each with one of FIELD_MATERIALS, so shadow rays stop early in some
    walks and multiply fractional factors in others.  Returns (scene, o,
    d) with 576 rays from a small box near the origin into the field."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    mats = [b.add_material(transparency=t, emission=e)
            for t, e in FIELD_MATERIALS]
    c = rng.uniform(-3.0, 3.0, (n, 3)) + [0.0, 0.0, 8.0]
    axis = rng.normal(0.0, 0.4, (n, 3))
    rad = rng.uniform(0.05, 0.25, n)
    mat = np.asarray(mats)[rng.integers(0, len(mats), n)]
    for i in range(n):
        b.add_cylinder(c[i], c[i] + axis[i], rad[i], mat[i])
    scene = b.build(device=device)
    o = rng.uniform(-0.5, 0.5, (576, 3))
    d = rng.uniform(-3.0, 3.0, (576, 3)) + [0.0, 0.0, 8.0] - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (scene,) + tuple(torch.as_tensor(x, dtype=torch.float32,
                                            device=device) for x in (o, d))


def sphere_field(n: int = 1500, seed: int = 8, device="cpu"):
    """A field of ``n`` random spheres (radius 0.05-0.25) in front of the
    origin, each with one of FIELD_MATERIALS, so shadow rays stop early
    in some walks and multiply fractional factors in others.  Returns
    (scene, o, d, inside) with 576 rays: 512 from a small box near the
    origin into the field, and 64 (``inside``, a bool mask) that start
    at the centres of spheres 0, 7, 14, ... in random directions."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    mats = [b.add_material(transparency=t, emission=e)
            for t, e in FIELD_MATERIALS]
    c = rng.uniform(-3.0, 3.0, (n, 3)) + [0.0, 0.0, 8.0]
    rad = rng.uniform(0.05, 0.25, n)
    mat = np.asarray(mats)[rng.integers(0, len(mats), n)]
    for i in range(n):
        b.add_sphere(c[i], rad[i], mat[i])
    scene = b.build(device=device)
    o = rng.uniform(-0.5, 0.5, (512, 3))
    d = rng.uniform(-3.0, 3.0, (512, 3)) + [0.0, 0.0, 8.0] - o
    o = np.concatenate([o, c[:7 * 64:7]])
    d = np.concatenate([d, rng.normal(0.0, 1.0, (64, 3))])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    inside = torch.arange(576, device=device) >= 512
    return (scene,) + tuple(torch.as_tensor(x, dtype=torch.float32,
                                            device=device)
                            for x in (o, d)) + (inside,)


# The far leaf's row that two_leaf_stale moves, and by how much along z.
STALE_ROW, STALE_DZ = 3, -8.5


def add_two_leaves(b, prim: str, m: int):
    """16 primitives of kind "tri", "sphere" or "cyl" in two leaves of 8,
    added to a SceneBuilder (either package's) with material ``m``: the
    far leaf's (x about -0.5, Morton first) at z 10-11.4, the near
    leaf's (x about 0.5) at z 5-6.4, each across the rays of
    two_leaf_rays.  Build with bvh_threshold=16."""
    z = [10.0 + 0.2 * i for i in range(8)] + [5.0 + 0.2 * i for i in range(8)]
    dx = [0.0] * 8 + [1.0] * 8
    if prim == "tri":
        tri = np.array([[-1.5, -1.0, 0.0], [0.5, -1.0, 0.0], [-0.5, 1.5, 0.0]])
        v = np.stack([tri + [x, 0.0, zi] for x, zi in zip(dx, z)])
        b.add_triangles_raw(v[:, 0], v[:, 1], v[:, 2], m)
        return
    for x, zi in zip(dx, z):
        if prim == "sphere":
            b.add_sphere((-0.5 + x, 0.0, zi), 0.6, m)
        else:
            b.add_cylinder((-1.5 + x, 0.0, zi), (0.5 + x, 0.0, zi), 0.3, m)


def two_leaf_rays():
    """64 rays along +z from a small square at the origin (numpy f32)."""
    g = (np.arange(8) - 3.5) * 0.012
    gx, gy = np.meshgrid(g, g, indexing="ij")
    o = np.stack([gx, gy, np.zeros_like(gx)], -1).reshape(-1, 3)
    d = np.tile([0.0, 0.0, 1.0], (o.shape[0], 1))
    return o.astype(np.float32), d.astype(np.float32)


def stale_shift(n: int = 16):
    """(n, 3) f32: STALE_DZ along z on STALE_ROW, 0 elsewhere."""
    shift = np.zeros((n, 3), np.float32)
    shift[STALE_ROW, 2] = STALE_DZ
    return shift


def move_pool(scene, prim: str, shift):
    """The port's scene with the pool of kind ``prim`` moved by ``shift``
    (N, 3) per row: triangles and spheres through with_params (no
    refit), cylinders through Scene.replace (they are no parameter)."""
    shift = torch.as_tensor(shift, dtype=torch.float32, device=scene.device)
    params = scene.params
    if prim == "tri":
        params["vertices"] = tuple(v + shift for v in params["vertices"])
        return scene.with_params(params)
    if prim == "sphere":
        params["sphere_center"] = params["sphere_center"] + shift
        return scene.with_params(params)
    c = scene.cylinders
    return scene.replace(cylinders=c.replace(p0=c.p0 + shift,
                                             p1=c.p1 + shift))


def two_leaf_stale(prim: str, device="cpu"):
    """The two-leaf scene of ``prim`` with the far leaf's STALE_ROW moved
    to z 2.1, in front of the near leaf's hits, without a refit: the DFS
    walk enters the far leaf first and returns that row; a near-first
    walk enters the near leaf first, returns its hit near z 5 and prunes
    the far leaf (its box starts near z 10).  Returns (scene, o, d)."""
    b = SceneBuilder()
    add_two_leaves(b, prim, b.add_material(color=(0.7, 0.6, 0.5, 1.0)))
    scene = move_pool(b.build(bvh_threshold=16, device=device), prim,
                      stale_shift())
    return (scene,) + tuple(torch.as_tensor(x, device=device)
                            for x in two_leaf_rays())

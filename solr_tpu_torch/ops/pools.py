"""The scene's primitive pools, one record each.

A scene holds five typed pools: spheres, triangles, capped cylinders,
ellipsoids and planes.  Traversal visits them in the order of their
codes (``constants.POOL_*``), and the strict ``<`` across pools makes
the earlier pool win a tie, so ``POOLS`` keeps that order and
``POOLS[code]`` is the pool of ``code``.  A record says what the other
modules need to know of its pool: its name (the key of
``traverse.BRUTE_CALLS``), the ``Scene`` attribute that holds it, its
geometry fields and the tests of :mod:`solr_tpu_torch.ops.intersect`
that take them, in that order.

The three accelerated pools (spheres, triangles, cylinders) also name
the ``Scene`` attributes of their BVH and packet accelerator, and bound
each primitive by an AABB.  Their kernels take the pool's name as the
primitive kind (``prim``), whose code is its place in ``PRIMS``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from solr_tpu_torch.constants import (POOL_CYLINDER, POOL_ELLIPSOID,
                                      POOL_PLANE, POOL_SPHERE, POOL_TRIANGLE)
from solr_tpu_torch.ops import intersect as isect

__all__ = ["BY_PRIM", "POOLS", "PRIMS", "Pool", "shadow_factor"]

# The primitive kinds in the order of their codes in csrc/sweep.cu and
# csrc/bvh_walk.cu: a wrapper passes PRIMS.index(prim) to the kernel.
PRIMS = ("tri", "sphere", "cyl")


@dataclasses.dataclass(frozen=True)
class Pool:
    """One pool: ``t`` (rays (..., 3), the pool's fields (N, ...),
    t_min) -> (..., N) is its brute-force test and ``t_p`` its
    broadcasting, differentiable one; ``bounds`` (the fields) -> (min,
    max) (N, 3) each, for an accelerated pool."""
    code: int
    name: str
    attr: str
    fields: tuple
    t: Callable
    t_p: Callable
    bvh_attr: Optional[str] = None
    accel_attr: Optional[str] = None
    bounds: Optional[Callable] = None

    def of(self, scene):
        return getattr(scene, self.attr)

    def size(self, scene) -> int:
        return getattr(self.of(scene), self.fields[0]).shape[0]

    def geometry(self, scene) -> tuple:
        p = self.of(scene)
        return tuple(getattr(p, f) for f in self.fields)

    def bvh(self, scene):
        """The pool's BVH, None without one."""
        return getattr(scene, self.bvh_attr) if self.bvh_attr else None

    def accel(self, scene):
        """The pool's packet accelerator, None without one."""
        return getattr(scene, self.accel_attr) if self.accel_attr else None

    def aabbs(self, scene):
        """Per-primitive AABBs (min, max), (N, 3) tensors each."""
        return self.bounds(*self.geometry(scene))


def _sphere_bounds(center, radius):
    r = radius[:, None]
    return center - r, center + r


def _triangle_bounds(v0, v1, v2):
    return (torch.minimum(torch.minimum(v0, v1), v2),
            torch.maximum(torch.maximum(v0, v1), v2))


def _cylinder_bounds(p0, p1, radius):
    r = radius[:, None]
    return torch.minimum(p0, p1) - r, torch.maximum(p0, p1) + r


POOLS = (
    Pool(POOL_SPHERE, "sphere", "spheres", ("center", "radius"),
         isect.sphere_t, isect.sphere_t_p, "sph_bvh", "sph_accel",
         _sphere_bounds),
    Pool(POOL_TRIANGLE, "tri", "triangles", ("v0", "v1", "v2"),
         isect.triangle_t, isect.triangle_t_p, "tri_bvh", "tri_accel",
         _triangle_bounds),
    Pool(POOL_CYLINDER, "cyl", "cylinders", ("p0", "p1", "radius"),
         isect.cylinder_t, isect.cylinder_t_p, "cyl_bvh", "cyl_accel",
         _cylinder_bounds),
    Pool(POOL_ELLIPSOID, "ellipsoid", "ellipsoids", ("center", "radii"),
         isect.ellipsoid_t, isect.ellipsoid_t_p),
    Pool(POOL_PLANE, "plane", "planes", ("axis", "origin", "half_extents"),
         isect.plane_t, isect.plane_t_p),
)

# The accelerated pools by primitive kind.
BY_PRIM = {p.name: p for p in POOLS if p.bvh_attr}


def shadow_factor(material, materials):
    """Each primitive's factor on a shadow ray through it, in the
    materials' dtype: 1 for an emissive material (the lights never
    occlude), else its transparency."""
    m = material.long()
    return torch.where(materials.emission[m] > 0.0,
                       torch.ones_like(materials.transparency[m]),
                       materials.transparency[m])

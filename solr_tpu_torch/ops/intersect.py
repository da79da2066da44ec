"""Ray-primitive intersection for spheres, triangles, capped cylinders,
axis-aligned ellipsoids and planes, and the BVH node's slab test
(counterpart of solr_tpu/ops/intersect.py).

``*_t_p`` take broadcast-compatible (..., 3) rays and primitives;
``*_t`` take rays (..., 3) and a pool (N, ...) and return the (..., N)
t-matrix.  Both return the smallest t > t_min, else T_FAR; padding
(radius, radii or half extents <= 0, degenerate triangles) never hits.
A ray that starts inside a closed primitive gets the exit hit.
"""

from __future__ import annotations

import torch

from solr_tpu_torch.constants import INTERSECT_EPS, T_FAR
from solr_tpu_torch.ops.packet import cyl_core
from solr_tpu_torch.ops.vecmath import cross, dot, safe_inv

__all__ = ["sphere_t_p", "sphere_t", "triangle_t_p", "triangle_t",
           "cylinder_t_p", "cylinder_t", "ellipsoid_t_p", "ellipsoid_t",
           "plane_t_p", "plane_t", "triangle_bary", "aabb_slab", "aabb_hit"]


def _far(x):
    return torch.full_like(x, T_FAR)


def _pick_root(t1, t2, valid, t_min):
    """Smallest root > t_min among (t1, t2) where valid, else T_FAR."""
    t1 = torch.where(valid & (t1 > t_min), t1, _far(t1))
    t2 = torch.where(valid & (t2 > t_min), t2, _far(t2))
    return torch.minimum(t1, t2)


def sphere_t_p(o, d, center, radius, t_min):
    oc = o - center
    b = dot(oc, d)
    c = dot(oc, oc) - radius * radius
    disc = b * b - c
    valid = (disc > 0.0) & (radius > 0.0)
    sq = torch.sqrt(torch.where(valid, disc, torch.ones_like(disc)))
    return _pick_root(-b - sq, -b + sq, valid, t_min)


def triangle_t_p(o, d, v0, v1, v2, t_min):
    """Two-sided Moller-Trumbore."""
    e1 = v1 - v0
    e2 = v2 - v0
    p = cross(d, e2)
    det = dot(p, e1)
    inv_det = safe_inv(det, det.abs() > INTERSECT_EPS)
    tvec = o - v0
    u = dot(tvec, p) * inv_det
    q = cross(tvec, e1)
    v = dot(q, d) * inv_det
    t = dot(q, e2) * inv_det
    valid = (det.abs() > INTERSECT_EPS) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return torch.where(valid & (t > t_min), t, _far(t))


def cylinder_t_p(o, d, p0, p1, radius, t_min):
    """Capped cylinder p0 -> p1: the side surface plus both end disks,
    two-sided: :func:`packet.cyl_core` on the rows ``cylinder_pack``
    stores (p0, radius, axis, |axis|^2), so the pool test and the block
    test share one formula (the reference writes it out twice)."""
    axis = p1 - p0
    rows = [p0[..., 0], p0[..., 1], p0[..., 2], radius,
            axis[..., 0], axis[..., 1], axis[..., 2], dot(axis, axis)]
    return cyl_core(lambda i: o[..., i] if i < 3 else d[..., i - 4],
                    rows.__getitem__, t_min)


def ellipsoid_t_p(o, d, center, radii, t_min):
    """Axis-aligned ellipsoid, scaled to the unit sphere; t is along the
    world-space ray."""
    inv_r = 1.0 / torch.clamp(radii, min=INTERSECT_EPS)
    oc = (o - center) * inv_r
    dd = d * inv_r
    a = dot(dd, dd)
    b = dot(oc, dd)
    c = dot(oc, oc) - 1.0
    disc = b * b - a * c
    valid = (disc > 0.0) & (radii > 0.0).all(-1)
    sq = torch.sqrt(torch.where(valid, disc, torch.ones_like(disc)))
    safe_a = torch.clamp(a, min=INTERSECT_EPS)
    return _pick_root((-b - sq) / safe_a, (-b + sq) / safe_a, valid, t_min)


def _expand_half_extents(axis, half_extents):
    """(...,) normal axis and (..., 2) in-plane half extents -> (..., 3)
    bound per axis; the normal axis gets T_FAR (the hit point's
    deviation along it is about 0)."""
    ar = torch.arange(3, device=axis.device)
    axis_b = axis[..., None].long()
    slot = (ar > axis_b).long()  # 0 below the normal axis, 1 above
    he = torch.gather(half_extents, -1, slot.expand(
        half_extents.shape[:-1] + (3,)))
    return torch.where(ar == axis_b, torch.full_like(he, T_FAR), he)


def plane_t_p(o, d, axis, origin, half_extents, t_min):
    """Axis-aligned bounded rectangle, two-sided: o, d (..., 3); axis
    (...,) int; origin (..., 3); half_extents (..., 2)."""
    nmask = torch.arange(3, device=axis.device) == axis[..., None].long()

    def along(x):  # the normal-axis component (the other two add 0)
        return torch.where(nmask, x, torch.zeros_like(x)).sum(-1)

    d_n, o_n, c_n = along(d), along(o), along(origin)
    safe = d_n.abs() > INTERSECT_EPS
    t = torch.where(safe, c_n - o_n, torch.zeros_like(d_n)) \
        / torch.where(safe, d_n, torch.ones_like(d_n))
    p = o + t[..., None] * d
    dev = (p - origin).abs()
    dev = torch.where(nmask, torch.zeros_like(dev), dev)
    inside = (dev <= _expand_half_extents(axis, half_extents)).all(-1)
    valid = safe & inside & (half_extents > 0.0).all(-1)
    return torch.where(valid & (t > t_min), t, _far(t))


def aabb_slab(o, inv_d, bmin, bmax):
    """Entry and exit distances (tn, tf) of rays o, inv_d (..., 3)
    through boxes (..., 3).  torch.minimum and maximum keep a NaN, so a
    NaN slab never hits."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
    tn = torch.maximum(torch.maximum(lo[..., 0], lo[..., 1]), lo[..., 2])
    tf = torch.minimum(torch.minimum(hi[..., 0], hi[..., 1]), hi[..., 2])
    return tn, tf


def aabb_hit(o, inv_d, bmin, bmax, t_min, t_max):
    """Slab test of boxes (..., 3) against rays o, inv_d (..., 3): whether
    [tn, tf] overlaps [t_min, t_max]."""
    tn, tf = aabb_slab(o, inv_d, bmin, bmax)
    return (tn <= tf) & (tf >= t_min) & (tn <= t_max)


def sphere_t(o, d, center, radius, t_min):
    return sphere_t_p(o[..., None, :], d[..., None, :], center, radius, t_min)


def triangle_t(o, d, v0, v1, v2, t_min):
    return triangle_t_p(o[..., None, :], d[..., None, :], v0, v1, v2, t_min)


def cylinder_t(o, d, p0, p1, radius, t_min):
    return cylinder_t_p(o[..., None, :], d[..., None, :], p0, p1, radius, t_min)


def ellipsoid_t(o, d, center, radii, t_min):
    return ellipsoid_t_p(o[..., None, :], d[..., None, :], center, radii, t_min)


def plane_t(o, d, axis, origin, half_extents, t_min):
    return plane_t_p(o[..., None, :], d[..., None, :], axis, origin,
                     half_extents, t_min)


def triangle_bary(o, d, v0, v1, v2):
    """Barycentric (u, v) of the ray-plane hit for matched ray/triangle
    pairs."""
    e1 = v1 - v0
    e2 = v2 - v0
    p = cross(d, e2)
    det = dot(p, e1)
    inv_det = safe_inv(det, det.abs() > INTERSECT_EPS)
    tvec = o - v0
    u = dot(tvec, p) * inv_det
    v = dot(cross(tvec, e1), d) * inv_det
    return u, v

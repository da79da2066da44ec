"""Ray-primitive intersection for spheres and triangles (counterpart of
solr_tpu/ops/intersect.py).

``*_t_p`` take broadcast-compatible (..., 3) rays and primitives;
``*_t`` take rays (..., 3) and a pool (N, ...) and return the (..., N)
t-matrix.  Both return the smallest t > t_min, else T_FAR; padding
(radius <= 0, degenerate triangles) never hits.
"""

from __future__ import annotations

import torch

from solr_tpu_torch.constants import INTERSECT_EPS, T_FAR
from solr_tpu_torch.ops.vecmath import cross, dot, safe_inv

__all__ = ["sphere_t_p", "sphere_t", "triangle_t_p", "triangle_t",
           "triangle_bary"]


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


def sphere_t(o, d, center, radius, t_min):
    return sphere_t_p(o[..., None, :], d[..., None, :], center, radius, t_min)


def triangle_t(o, d, v0, v1, v2, t_min):
    return triangle_t_p(o[..., None, :], d[..., None, :], v0, v1, v2, t_min)


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

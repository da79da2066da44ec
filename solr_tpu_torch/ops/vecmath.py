"""Vector math on (..., 3) tensors (counterpart of
solr_tpu/ops/vecmath.py).  Guards use ``torch.where`` so gradients stay
finite on masked lanes, as in the reference."""

from __future__ import annotations

import math

import torch

from solr_tpu_torch.constants import NORMAL_EPS

__all__ = ["dot", "cross", "norm", "normalize", "safe_inv", "reflect",
           "refract", "spherical_uv", "rotate_euler"]


def dot(a, b, keepdim: bool = False):
    return (a * b).sum(-1, keepdim=keepdim)


def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], -1
    )


def norm(v, keepdim: bool = False):
    return torch.sqrt(torch.clamp(dot(v, v, keepdim=keepdim), min=NORMAL_EPS))


def normalize(v):
    return v / norm(v, keepdim=True)


def safe_inv(x, ok):
    """1 / x where ``ok``, else 0; the denominator is replaced first, so
    no lane divides by zero and gradients stay finite."""
    one = torch.ones_like(x)
    return torch.where(ok, one, torch.zeros_like(x)) / torch.where(ok, x, one)


def reflect(incident, normal):
    """r = i - 2 (i.n) n."""
    return incident - 2.0 * dot(incident, normal, keepdim=True) * normal


def refract(incident, normal, eta):
    """Snell refraction with the total-internal-reflection fallback.

    ``normal`` opposes the incident ray; ``eta`` (...,) or (..., 1) is
    n_incident / n_transmitted.  Returns (unit direction, tir mask)."""
    if eta.dim() == incident.dim() - 1:
        eta = eta[..., None]
    cos_i = -dot(incident, normal, keepdim=True)
    sin2_t = eta * eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    tir = sin2_t > 1.0
    cos_t = torch.sqrt(torch.where(tir, torch.ones_like(sin2_t), 1.0 - sin2_t))
    refr = eta * incident + (eta * cos_i - cos_t) * normal
    out = torch.where(tir, reflect(incident, normal), refr)
    return normalize(out), tir.squeeze(-1)


def spherical_uv(n):
    """Longitude/latitude UV of a unit direction, nudged off the poles so
    arcsin and atan2 keep finite gradients."""
    eps = 1e-6
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    at_pole = (x.abs() < eps) & (z.abs() < eps)
    e = torch.full_like(x, eps)
    u = 0.5 + torch.atan2(torch.where(at_pole, e, z),
                          torch.where(at_pole, e, x)) / (2.0 * math.pi)
    v = 0.5 - torch.asin(torch.clamp(y, -1.0 + eps, 1.0 - eps)) / math.pi
    return torch.stack([u, v], -1)


def rotate_euler(v, angles):
    """Rotate (..., 3) vectors by Euler angles (rx, ry, rz), applied X
    then Y then Z."""
    ax, ay, az = angles[..., 0], angles[..., 1], angles[..., 2]
    cx, sx = torch.cos(ax), torch.sin(ax)
    cy, sy = torch.cos(ay), torch.sin(ay)
    cz, sz = torch.cos(az), torch.sin(az)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    y, z = cx * y - sx * z, sx * y + cx * z
    x, z = cy * x + sy * z, -sy * x + cy * z
    x, y = cz * x - sz * y, sz * x + cz * y
    return torch.stack([x, y, z], -1)

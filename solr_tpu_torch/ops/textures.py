"""Procedural textures and material map scales (counterpart of
solr_tpu/ops/textures.py).  Image textures are not ported yet (ROADMAP
A11): the texture-map paths raise when a scene has textures."""

from __future__ import annotations

import torch

__all__ = ["material_map_scales", "procedural_color", "mandelbrot", "julia",
           "value_noise", "turbulence"]

_MANDEL_ITERS = 32


def material_map_scales(scene, material, uv):
    """Per-hit (specular, reflection, transparency) scales from the
    material's texture slots: 1 everywhere when the scene has no
    textures."""
    if scene.textures.count > 0:
        raise NotImplementedError("texture maps are not ported")
    one = torch.ones(uv.shape[:-1], dtype=uv.dtype, device=uv.device)
    return one, one, one


def _escape_time(c_re, c_im, z_re, z_im, iters: int):
    """Escape-time iteration count / iters in [0, 1]."""
    zr, zi = z_re, z_im
    count = torch.zeros_like(z_re)
    alive = torch.ones_like(z_re, dtype=torch.bool)
    for _ in range(iters):
        zr2 = zr * zr - zi * zi + c_re
        zi2 = 2.0 * zr * zi + c_im
        alive = alive & (zr2 * zr2 + zi2 * zi2 < 4.0)
        count = count + alive.to(zr.dtype)
        zr = torch.where(alive, zr2, zr)
        zi = torch.where(alive, zi2, zi)
    return count / iters


def mandelbrot(uv, scale):
    re = (uv[..., 0] - 0.6) * 2.6 * scale
    im = (uv[..., 1] - 0.5) * 2.4 * scale
    return _escape_time(re, im, torch.zeros_like(re), torch.zeros_like(im),
                        _MANDEL_ITERS)


def julia(uv, scale):
    re = (uv[..., 0] - 0.5) * 3.0 * scale
    im = (uv[..., 1] - 0.5) * 3.0 * scale
    return _escape_time(torch.full_like(re, -0.70176),
                        torch.full_like(im, -0.3842), re, im, _MANDEL_ITERS)


def _hash2(x, y):
    """Cheap deterministic [0, 1) hash of integer lattice points."""
    h = torch.sin(x * 127.1 + y * 311.7) * 43758.5453
    return h - torch.floor(h)


def value_noise(p, scale):
    """Smooth 2-D value noise in [0, 1]."""
    q = p * scale[..., None]
    xi = torch.floor(q[..., 0])
    yi = torch.floor(q[..., 1])
    fx = q[..., 0] - xi
    fy = q[..., 1] - yi
    sx = fx * fx * (3.0 - 2.0 * fx)
    sy = fy * fy * (3.0 - 2.0 * fy)
    a = _hash2(xi, yi)
    b = _hash2(xi + 1.0, yi)
    c = _hash2(xi, yi + 1.0)
    d = _hash2(xi + 1.0, yi + 1.0)
    return (a * (1 - sx) + b * sx) * (1 - sy) + (c * (1 - sx) + d * sx) * sy


def turbulence(p, scale, octaves: int = 4):
    out = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    amp, freq = 0.5, 1.0
    for _ in range(octaves):
        out = out + amp * value_noise(p, scale * freq)
        amp *= 0.5
        freq *= 2.0
    return out


def procedural_color(kind, scale, uv, base_color):
    """Procedural albedo by ProceduralKind code.  Every kind is computed
    and the material's kind selected, as in the reference.

    kind (R,) int; scale (R,); uv (R, 2); base_color (R, 4) -> (R, 4).
    """
    checker = torch.remainder(
        torch.floor(uv[..., 0] * scale) + torch.floor(uv[..., 1] * scale), 2.0)
    mand = mandelbrot(uv, scale)
    jul = julia(uv, scale)
    noise = value_noise(uv, scale)
    marble = 0.5 + 0.5 * torch.sin(
        uv[..., 0] * scale * 6.28318 + 4.0 * turbulence(uv, scale))
    granite = torch.clamp(turbulence(uv, scale * 4.0) * 1.4, 0.0, 1.0)

    def tint(f):
        return base_color * f[..., None]

    palette = torch.stack([
        base_color,
        tint(mand),
        tint(jul),
        torch.where((checker > 0.5)[..., None], base_color, 1.0 - base_color),
        tint(noise),
        tint(marble),
        tint(granite),
    ], 0)  # (7, R, 4)
    k = kind.long().clamp(0, palette.shape[0] - 1)
    out = torch.gather(palette, 0, k[None, ..., None].expand(
        (1,) + base_color.shape))[0]
    return torch.cat([out[..., :3], base_color[..., 3:4]], -1)

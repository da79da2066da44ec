"""Texture sampling, material maps, normal and bump maps, and procedural
textures (counterpart of solr_tpu/ops/textures.py).

The atlas is one (N, 4) uint8 tensor; each texture's (offset, width,
height) addresses it.  Sampling is a bilinear four-texel gather with
repeat addressing, over all rays at once."""

from __future__ import annotations

import torch

from solr_tpu_torch.utils.profiling import render_phase

__all__ = ["sample_texture", "material_map_scales", "tangent_basis",
           "apply_normal_maps", "procedural_color", "mandelbrot", "julia",
           "value_noise", "turbulence", "BUMP_STRENGTH"]

# The bump map's height-gradient gain.
BUMP_STRENGTH = 2.0

_MANDEL_ITERS = 32


def sample_texture(tex, tex_id, uv):
    """Bilinear RGBA in [0, 1], (R, 4): tex_id (R,) int (-1 gives
    white), uv (R, 2), wrapped (repeat addressing)."""
    if tex.count == 0:
        return torch.ones(uv.shape[:-1] + (4,), dtype=uv.dtype,
                          device=uv.device)
    with render_phase("texture"):
        tid = tex_id.clamp(0, tex.count - 1).long()
        wi, hi = tex.width[tid], tex.height[tid]
        off = tex.offset[tid]
        u = uv[..., 0] - torch.floor(uv[..., 0])
        v = uv[..., 1] - torch.floor(uv[..., 1])
        x = u * wi.to(uv.dtype) - 0.5
        y = v * hi.to(uv.dtype) - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx = (x - x0)[..., None]
        fy = (y - y0)[..., None]

        def texel(xi, yi):
            # Floor modulo, as jnp.mod: texel -1 wraps to the last column.
            xi = torch.remainder(xi.to(torch.int32), wi.clamp(min=1))
            yi = torch.remainder(yi.to(torch.int32), hi.clamp(min=1))
            return tex.atlas[(off + yi * wi + xi).long()].to(uv.dtype) \
                / 255.0

        c00 = texel(x0, y0)
        c10 = texel(x0 + 1, y0)
        c01 = texel(x0, y0 + 1)
        c11 = texel(x0 + 1, y0 + 1)
        top = c00 * (1 - fx) + c10 * fx
        bot = c01 * (1 - fx) + c11 * fx
        rgba = top * (1 - fy) + bot * fy
        return torch.where((tex_id >= 0)[..., None], rgba,
                           torch.ones_like(rgba))


def _luminance(rgba):
    return 0.299 * rgba[..., 0] + 0.587 * rgba[..., 1] + 0.114 * rgba[..., 2]


def material_map_scales(scene, material, uv):
    """Per-hit (specular, reflection, transparency) scales, each (R,):
    the luminance of the material's map in that slot at the hit's UV, 1
    where the slot is unset (a white map is the identity, a black map
    turns the channel off).  material (R,) int; uv (R, 2)."""
    tex = scene.textures
    if tex.count == 0:
        one = torch.ones(uv.shape[:-1], dtype=uv.dtype, device=uv.device)
        return one, one, one
    with render_phase("texture"):
        mats = scene.materials

        def scale(tid_per_mat):
            tid = tid_per_mat[material]
            lum = _luminance(sample_texture(tex, tid, uv))
            return torch.where(tid >= 0, lum, torch.ones_like(lum))

        return (scale(mats.texture_specular), scale(mats.texture_reflection),
                scale(mats.texture_transparency))


def tangent_basis(n):
    """Orthonormal (tangent, bitangent) of unit normals (..., 3),
    branchless (Frisvad's frame with the sign fix; continuous but across
    n_z = 0)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0.0, torch.ones_like(nz), -torch.ones_like(nz))
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], -1)
    bt = torch.stack([b, sign + ny * ny * a, -ny], -1)
    return t, bt


def _unit(v):
    return v / torch.sqrt(torch.clamp((v * v).sum(-1, keepdim=True),
                                      min=1e-12))


def apply_normal_maps(scene, material, uv, n):
    """Shading normals (R, 3) perturbed by the material's maps: the
    normal map's RGB * 2 - 1 in the (tangent, bitangent, normal) frame;
    the bump map tilts the normal against the central-difference
    gradient (one texel each way) of its luminance, by BUMP_STRENGTH.
    Unchanged where neither slot is set."""
    tex = scene.textures
    if tex.count == 0:
        return n
    with render_phase("texture"):
        mats = scene.materials
        tn = mats.texture_normal[material]
        tb = mats.texture_bump[material]
        t, bt = tangent_basis(n)

        rgb = sample_texture(tex, tn, uv)[..., :3] * 2.0 - 1.0
        nm = _unit(rgb[..., 0:1] * t + rgb[..., 1:2] * bt + rgb[..., 2:3] * n)
        out = torch.where((tn >= 0)[..., None], nm, n)

        tid = tb.clamp(0, tex.count - 1).long()
        du = 1.0 / torch.clamp(tex.width[tid].to(uv.dtype), min=1.0)
        dv = 1.0 / torch.clamp(tex.height[tid].to(uv.dtype), min=1.0)

        def height(uv_s):
            return _luminance(sample_texture(tex, tb, uv_s))

        zero = torch.zeros_like(du)
        step_u = torch.stack([du, zero], -1)
        step_v = torch.stack([zero, dv], -1)
        gu = (height(uv + step_u) - height(uv - step_u)) / (2.0 * du)
        gv = (height(uv + step_v) - height(uv - step_v)) / (2.0 * dv)
        bumped = _unit(n - BUMP_STRENGTH * (gu[..., None] * t
                                            + gv[..., None] * bt))
        return torch.where((tb >= 0)[..., None], bumped, out)


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

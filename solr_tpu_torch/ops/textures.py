"""Texture sampling, material maps, normal and bump maps, and procedural
textures (counterpart of solr_tpu/ops/textures.py).

The atlas is one (N, 4) uint8 tensor; each texture's (offset, width,
height) addresses it.  Sampling is a bilinear four-texel gather with
repeat addressing, over all rays at once.

:func:`procedural_color` dispatches on the device of its tensors
(``cudalib.on_card``): CPU tensors take :func:`procedural_color_plain`,
which computes all seven kinds for every ray and selects each ray's own,
as the reference does; CUDA tensors take ``csrc/procedural.cu``
(``LIBRARY``, built at first use by ``ops.cudalib``), one launch that
computes each ray's own kind alone, bit-equal to the plain version on
the card.  With grad mode on and ``scale``, ``uv`` or ``base_color``
requiring grad, the launch is an autograd Function whose backward is the
library's second kernel.  A build or launch failure raises, and so does
a call the kernels do not take (neither float32 nor float64, kinds not
int32); nothing falls back to the plain version."""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from solr_tpu_torch.ops import cudalib
from solr_tpu_torch.ops.cudalib import ptr, raise_on
from solr_tpu_torch.utils.profiling import render_phase

__all__ = ["sample_texture", "material_map_scales", "tangent_basis",
           "apply_normal_maps", "procedural_color", "procedural_color_plain",
           "mandelbrot", "julia", "value_noise", "turbulence",
           "BUMP_STRENGTH", "LAUNCHES", "LIBRARY", "build", "launch",
           "launch_bwd", "load_library"]

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


def procedural_color_plain(kind, scale, uv, base_color):
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


# Kernel launches since the caller last zeroed this.
LAUNCHES = {"procedural_color": 0, "procedural_color_bwd": 0}

_DTYPES = (torch.float32, torch.float64)


def load_library(path):
    """Load a compiled procedural library and declare its C entry
    points."""
    lib = ctypes.CDLL(str(path))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.solr_procedural_fwd.argtypes = [vp, vp, vp, vp, i64, i32, vp, vp]
    lib.solr_procedural_fwd.restype = i32
    lib.solr_procedural_bwd.argtypes = [vp, vp, vp, vp, vp, i64, i32, vp, vp,
                                        vp, vp]
    lib.solr_procedural_bwd.restype = i32
    return lib


# csrc/procedural.cu, compiled for sm_90a at first use; ``build`` reports
# the compiler's output.
LIBRARY = cudalib.library("procedural.cu", load_library)
build = LIBRARY.build


def _inputs(kind, scale, uv, base_color):
    """The kernels' inputs, contiguous, after the checks of what they
    take: kind (R,) int32, scale (R,), uv (R, 2) and base_color (R, 4)
    of one float type, on one device."""
    shape = kind.shape
    if (scale.shape != shape or uv.shape != shape + (2,)
            or base_color.shape != shape + (4,)):
        raise ValueError(
            f"procedural_color takes kind and scale of one shape, uv and "
            f"base_color of that shape + (2,) and + (4,); got "
            f"{tuple(shape)}, {tuple(scale.shape)}, {tuple(uv.shape)}, "
            f"{tuple(base_color.shape)}")
    if kind.dtype != torch.int32 or uv.dtype not in _DTYPES or not (
            scale.dtype == base_color.dtype == uv.dtype):
        raise ValueError(
            f"procedural_color takes int32 kinds and float32 or float64 "
            f"values of one type; got {kind.dtype}, {scale.dtype}, "
            f"{uv.dtype}, {base_color.dtype}")
    if not all(x.device == uv.device for x in (kind, scale, base_color)):
        raise ValueError("procedural_color takes tensors of one device")
    return tuple(x.contiguous() for x in (kind, scale, uv, base_color))


def launch(lib, kind, scale, uv, base_color):
    """One launch of ``lib``'s forward kernel: what
    :func:`procedural_color_plain` returns (on the CPU, the emulated
    kernel of the tests)."""
    kind, scale, uv, base_color = _inputs(kind, scale, uv, base_color)
    out = torch.empty_like(base_color)
    err = lib.solr_procedural_fwd(
        ptr(kind), ptr(scale), ptr(uv), ptr(base_color), kind.numel(),
        uv.element_size(), ptr(out), cudalib.stream(uv.device))
    raise_on(err, "procedural_color")
    return out


def launch_bwd(lib, kind, scale, uv, base_color, grad, need=(True,) * 3):
    """One launch of ``lib``'s backward kernel: the gradients (of uv, of
    scale, of base_color) of the forward at these inputs from ``grad``
    (R, 4); ``need`` says which of the three to compute (None for the
    others)."""
    kind, scale, uv, base_color = _inputs(kind, scale, uv, base_color)
    if grad.shape != base_color.shape or grad.dtype != uv.dtype:
        raise ValueError(f"procedural_color_bwd takes a gradient of the "
                         f"output's shape and type; got {grad.dtype} "
                         f"{tuple(grad.shape)}")
    grad = grad.contiguous()
    outs = [torch.empty_like(x) if n else None
            for x, n in zip((uv, scale, base_color), need)]
    err = lib.solr_procedural_bwd(
        ptr(kind), ptr(scale), ptr(uv), ptr(base_color), ptr(grad),
        kind.numel(), uv.element_size(),
        *(ctypes.c_void_p(None) if x is None else ptr(x) for x in outs),
        cudalib.stream(uv.device))
    raise_on(err, "procedural_color_bwd")
    return tuple(outs)


def _fwd(kind, scale, uv, base_color):
    out = launch(LIBRARY.load(), kind, scale, uv, base_color)
    LAUNCHES["procedural_color"] += 1
    return out


def _bwd(kind, scale, uv, base_color, grad, need):
    outs = launch_bwd(LIBRARY.load(), kind, scale, uv, base_color, grad,
                      need)
    LAUNCHES["procedural_color_bwd"] += 1
    return outs


class _ProceduralColor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kind, scale, uv, base_color):
        ctx.save_for_backward(kind, scale, uv, base_color)
        return _fwd(kind, scale, uv, base_color)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        need = ctx.needs_input_grad
        g_uv, g_scale, g_base = _bwd(
            *ctx.saved_tensors, grad, (need[2], need[1], need[3]))
        return None, g_scale, g_uv, g_base


def procedural_color(kind, scale, uv, base_color):
    """Procedural albedo by ProceduralKind code: kind (R,) int (int32 on
    the card); scale (R,); uv (R, 2); base_color (R, 4) -> (R, 4).  CPU
    tensors take :func:`procedural_color_plain`; CUDA tensors the
    kernel, which computes each ray's own kind alone (with grad mode on
    and any of scale, uv or base_color requiring grad, an autograd
    Function whose backward is the backward kernel, :func:`launch_bwd`);
    any other device raises ValueError."""
    if not cudalib.on_card(uv, "procedural_color"):
        return procedural_color_plain(kind, scale, uv, base_color)
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (scale, uv, base_color)):
        return _ProceduralColor.apply(kind, scale, uv, base_color)
    return _fwd(kind, scale, uv, base_color)

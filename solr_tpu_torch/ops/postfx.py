"""Post-processing passes over the rendered frame (counterpart of
solr_tpu/ops/postfx.py): depth of field, screen-space ambient
occlusion, cartoon and enlightment, as gathers over the (H, W, 4) image
and its (H, W) primary-hit depth.  The reference's ``vmap`` over the
gather taps is a loop here that sums the taps in order."""

from __future__ import annotations

import math

import torch

from solr_tpu_torch.types import Camera, PostFxMode, RenderConfig, Scene
from solr_tpu_torch.utils.profiling import render_phase

__all__ = ["apply_postfx", "depth_of_field", "ambient_occlusion", "cartoon",
           "enlightment"]


def _disk_offsets(samples: int, dtype, device):
    """Deterministic golden-angle spiral over the unit disk, (S, 2)."""
    i = torch.arange(samples, dtype=dtype, device=device) + 0.5
    r = torch.sqrt(i / samples)
    theta = i * (math.pi * (3.0 - math.sqrt(5.0)))
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], -1)


def _grid(img):
    h, w = img.shape[:2]
    return (torch.arange(h, device=img.device)[:, None],
            torch.arange(w, device=img.device)[None, :])


def _gather_px(img, yy, xx):
    """img[y, x] with the coordinates clamped to the frame."""
    h, w = img.shape[:2]
    return img[yy.clamp(0, h - 1), xx.clamp(0, w - 1)]


def _taps(samples: int, radius: float, dtype):
    """The disk offsets times ``radius``, rounded half to even to whole
    pixels, as Python ints (computed on the CPU: no device sync)."""
    offs = (_disk_offsets(samples, dtype, "cpu") * radius).tolist()
    return [(round(dy), round(dx)) for dx, dy in offs]


def _round_px(x):
    """Round half to even, to an integer pixel offset."""
    return torch.round(x).to(torch.int64)


def depth_of_field(img, depth, focus, strength, samples: int = 16):
    """Gather blur whose radius in pixels is |depth - focus| * strength,
    at most 32."""
    coc = torch.clamp((depth - focus).abs() * strength, 0.0, 32.0)
    ys, xs = _grid(img)
    acc = None
    for off in _disk_offsets(samples, img.dtype, img.device):
        c = _gather_px(img, ys + _round_px(off[1] * coc),
                       xs + _round_px(off[0] * coc))
        acc = c if acc is None else acc + c
    return acc / samples


def ambient_occlusion(img, depth, strength, radius: float = 8.0,
                      samples: int = 16):
    """Darken each pixel by ``strength`` times the share of its disk
    neighbours that are closer to the camera by more than 5% of its
    depth; alpha is kept."""
    ys, xs = _grid(img)
    occ = None
    for dy, dx in _taps(samples, radius, img.dtype):
        dz = _gather_px(depth, ys + dy, xs + dx)
        closer = ((depth - dz) > 0.05 * depth.abs()).to(img.dtype)
        occ = closer if occ is None else occ + closer
    factor = torch.clamp(1.0 - strength * (occ / samples), 0.0, 1.0)[..., None]
    return torch.cat([(img * factor)[..., :3], img[..., 3:4]], -1)


def cartoon(img, depth, levels: float = 4.0, edge_strength: float = 1.0):
    """Posterize, and darken where the depth jumps to the next pixel
    right or down."""
    quant = torch.floor(img[..., :3] * levels) / levels
    dzx = torch.diff(depth, dim=1, append=depth[:, -1:]).abs()
    dzy = torch.diff(depth, dim=0, append=depth[-1:, :]).abs()
    edge = torch.clamp((dzx + dzy) * edge_strength, 0.0, 1.0)[..., None]
    return torch.cat([quant * (1.0 - edge), img[..., 3:4]], -1)


def enlightment(img, depth, strength: float = 0.6, radius: float = 24.0,
                samples: int = 32):
    """Screen-space irradiance bleeding: add ``strength / 2`` times the
    depth-weighted mean radiance of the disk neighbours (weight
    exp(-(dz / (0.08 |depth| + 1e-3))^2)), so light bleeds along
    continuous surfaces only."""
    ys, xs = _grid(img)
    z_scale = 0.08 * depth.abs() + 1e-3
    cs = ws = None
    for dy, dx in _taps(samples, radius, img.dtype):
        yy, xx = ys + dy, xs + dx
        z = _gather_px(depth, yy, xx)
        wgt = torch.exp(-((z - depth) / z_scale) ** 2)
        c = _gather_px(img, yy, xx) * wgt[..., None]
        cs = c if cs is None else cs + c
        ws = wgt if ws is None else ws + wgt
    indirect = cs / (ws[..., None] + 1e-6)
    rgb = img[..., :3] + strength * 0.5 * indirect[..., :3]
    return torch.cat([rgb, img[..., 3:4]], -1)


def apply_postfx(img, depth, scene: Scene, camera: Camera, cfg: RenderConfig,
                 key=None):
    """The pass ``cfg.postfx.mode`` selects.  ``key`` is unused: every
    pass is deterministic, as in the reference."""
    mode = cfg.postfx.mode
    if mode == PostFxMode.NONE:
        return img
    with render_phase("postfx"):
        if mode == PostFxMode.DEPTH_OF_FIELD:
            return depth_of_field(img, depth, camera.focal_distance,
                                  torch.clamp(camera.aperture, min=0.05) * 8.0,
                                  cfg.postfx.samples)
        if mode == PostFxMode.AMBIENT_OCCLUSION:
            return ambient_occlusion(img, depth, scene.info.shadow_intensity,
                                     samples=cfg.postfx.samples)
        if mode == PostFxMode.CARTOON:
            return cartoon(img, depth)
        if mode == PostFxMode.ENLIGHTMENT:
            return enlightment(img, depth, samples=cfg.postfx.samples)
        raise NotImplementedError(mode)

"""Primary rays for the pinhole MONO camera (counterpart of
solr_tpu/ops/camera.py).  Other camera modes, lens jitter and
antialiasing jitter are not ported yet (ROADMAP A11) and raise."""

from __future__ import annotations

import torch

from solr_tpu_torch.ops.vecmath import normalize, rotate_euler
from solr_tpu_torch.types import Camera, CameraMode, RenderConfig

__all__ = ["pixel_grid", "camera_rays"]


def pixel_grid(cfg: RenderConfig, device, dtype=torch.float32):
    """Pixel centers as (R, 2) [x, y] in pixel units, row-major."""
    ys, xs = torch.meshgrid(
        torch.arange(cfg.height, dtype=dtype, device=device),
        torch.arange(cfg.width, dtype=dtype, device=device),
        indexing="ij",
    )
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], -1)


def _ndc(pix, cfg: RenderConfig):
    """Pixel coords -> [-aspect, aspect] x [1, -1] image plane."""
    x = pix[..., 0] + 0.5
    y = pix[..., 1] + 0.5
    u = (2.0 * x / cfg.width - 1.0) * (cfg.width / cfg.height)
    v = 1.0 - 2.0 * y / cfg.height
    return u, v


def _make_rays(camera: Camera, u, v):
    """Pinhole rays (aperture 0): every origin is the eye."""
    if float(camera.aperture) > 0.0:
        raise NotImplementedError("thin-lens depth of field is not ported")
    scale = torch.tan(0.5 * camera.fov)
    d_cam = torch.stack([u * scale, v * scale, torch.ones_like(u)], -1)
    d = normalize(rotate_euler(d_cam, camera.angles))
    o = camera.position.expand_as(d)
    return o, d


def camera_rays(camera: Camera, cfg: RenderConfig, dtype=None):
    """Primary rays ((R, 3), (R, 3)) in row-major pixel order.  The
    image-plane coordinates are computed in ``dtype`` (the camera's when
    None) and then widened to the camera's, as the reference computes
    them in the scene info's dtype (render.py:306, :322)."""
    if cfg.camera_mode != CameraMode.MONO:
        raise NotImplementedError(f"camera mode {cfg.camera_mode!r}")
    dev, cam_dt = camera.position.device, camera.position.dtype
    u, v = _ndc(pixel_grid(cfg, dev, cam_dt if dtype is None else dtype), cfg)
    wide = torch.promote_types(u.dtype, cam_dt)
    return _make_rays(camera, u.to(wide), v.to(wide))


"""Camera models and primary rays (counterpart of
solr_tpu/ops/camera.py): the pinhole and thin-lens camera, antialiasing
jitter, and the MONO, SIDE_BY_SIDE, ANAGLYPH and FISHEYE modes.  Every
mode gives flat (R, 3) origins and directions, R = width * height in
row-major pixel order.

Image-plane coordinates, jitter and lens draws are computed in the
pixel grid's dtype and then widened to the camera's, where the
reference's type promotion widens them (a 0-dim camera field does not
widen a tensor in PyTorch, so the port widens explicitly).
"""

from __future__ import annotations

import math

import torch

from solr_tpu_torch.ops.vecmath import normalize, rotate_euler
from solr_tpu_torch.types import Camera, CameraMode, RenderConfig

__all__ = ["pixel_grid", "camera_rays", "rays_from_pixels", "eye_rays"]


def pixel_grid(cfg: RenderConfig, device, dtype=torch.float32):
    """Pixel centers as (R, 2) [x, y] in pixel units, row-major."""
    ys, xs = torch.meshgrid(
        torch.arange(cfg.height, dtype=dtype, device=device),
        torch.arange(cfg.width, dtype=dtype, device=device),
        indexing="ij",
    )
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], -1)


def _ndc(pix, cfg: RenderConfig, jitter):
    """Pixel coords -> [-aspect, aspect] x [1, -1] image plane."""
    x = pix[..., 0] + 0.5 + jitter[..., 0]
    y = pix[..., 1] + 0.5 + jitter[..., 1]
    u = (2.0 * x / cfg.width - 1.0) * (cfg.width / cfg.height)
    v = 1.0 - 2.0 * y / cfg.height
    return u, v


def _lens_offsets(key, n, dtype, device):
    """Samples on the unit lens disk, (n, 2); zeros without a key."""
    if key is None:
        return torch.zeros((n, 2), dtype=dtype, device=device)
    r = key.uniform((n, 2), dtype)
    ang = r[:, 0] * 2.0 * math.pi
    rad = torch.sqrt(r[:, 1])
    return torch.stack([torch.cos(ang) * rad, torch.sin(ang) * rad], -1)


def _make_rays(camera: Camera, u, v, eye, key):
    """Thin-lens rays with the eye shifted by ``eye`` (n, 1: -1, 0 or +1)
    times ``eye_separation`` along the camera's right axis.  With
    aperture 0 the pinhole rays are selected by ``where``, so their
    gradients do not pass through the lens terms."""
    dt = u.dtype
    wide = torch.promote_types(dt, camera.position.dtype)
    u, v = u.to(wide), v.to(wide)
    eye_shift = eye.to(wide) * camera.eye_separation
    scale = torch.tan(0.5 * camera.fov)
    d_cam = torch.stack([u * scale, v * scale, torch.ones_like(u)], -1)
    d_world = normalize(rotate_euler(d_cam, camera.angles))
    axes = torch.eye(3, dtype=wide, device=u.device)
    right = rotate_euler(axes[0], camera.angles)
    up = rotate_euler(axes[1], camera.angles)
    pinhole = camera.position + eye_shift * right

    lens = _lens_offsets(key, u.shape[0], dt, u.device).to(wide) \
        * camera.aperture
    focal = pinhole + d_world * camera.focal_distance
    o = pinhole + right * lens[:, 0:1] + up * lens[:, 1:2]
    d = normalize(focal - o)
    thin = camera.aperture > 0.0
    return torch.where(thin, o, pinhole), torch.where(thin, d, d_world)


def _jitter(key, cfg: RenderConfig, n, dtype, device):
    """(sub-pixel jitter (n, 2), lens key): the key splits into a jitter
    key and a lens key when ``antialias_jitter`` is on."""
    if key is not None and cfg.antialias_jitter:
        kj, kl = key.split(2)
        return kj.uniform((n, 2), dtype) - 0.5, kl
    return torch.zeros((n, 2), dtype=dtype, device=device), key


def camera_rays(camera: Camera, cfg: RenderConfig, key=None, dtype=None):
    """Primary rays ((R, 3), (R, 3)) of the configured mode, the pixel
    grid drawn in ``dtype`` (the camera's when None; the renderer passes
    the scene info's, as the reference does)."""
    dev = camera.position.device
    dtype = camera.position.dtype if dtype is None else dtype
    return rays_from_pixels(camera, cfg, pixel_grid(cfg, dev, dtype), key)


def rays_from_pixels(camera: Camera, cfg: RenderConfig, pix, key=None):
    """Rays for any pixel subset ``pix`` (R, 2), in its dtype: each
    device of a sharded render passes its own pixels.  ANAGLYPH gives
    the cyclopean rays (the renderer traces each eye with
    :func:`eye_rays`); SIDE_BY_SIDE takes the left eye in the left half
    of the frame and the right eye in the right half, each half spanning
    the whole field of view; FISHEYE maps the radial pixel distance
    linearly to the angle from the view axis (equidistant)."""
    n, dt, dev = pix.shape[0], pix.dtype, pix.device
    jitter, kl = _jitter(key, cfg, n, dt, dev)
    u, v = _ndc(pix, cfg, jitter)
    mode = cfg.camera_mode
    if mode in (CameraMode.MONO, CameraMode.ANAGLYPH):
        return _make_rays(camera, u, v,
                          torch.zeros((n, 1), dtype=dt, device=dev), kl)

    if mode == CameraMode.SIDE_BY_SIDE:
        half = cfg.width / 2.0
        x = pix[..., 0]
        left = x < half
        xloc = torch.where(left, x, x - half)
        u = (2.0 * (xloc + 0.5 + jitter[..., 0]) / half - 1.0) * (
            half / cfg.height)
        one = torch.ones_like(u)
        return _make_rays(camera, u, v, torch.where(left, -one, one)[..., None],
                          kl)

    if mode == CameraMode.FISHEYE:
        r = torch.sqrt(u * u + v * v)
        wide = torch.promote_types(dt, camera.position.dtype)
        theta = (r / (cfg.width / cfg.height)).to(wide) * camera.fov
        phi = torch.atan2(v, u)
        sin_t = torch.sin(theta)
        d_cam = torch.stack([sin_t * torch.cos(phi).to(wide),
                             sin_t * torch.sin(phi).to(wide),
                             torch.cos(theta)], -1)
        d = normalize(rotate_euler(d_cam, camera.angles))
        return camera.position.expand_as(d), d

    raise NotImplementedError(f"camera mode {mode!r}")


def eye_rays(camera: Camera, cfg: RenderConfig, eye: float, key=None,
             dtype=None):
    """Full-frame rays of one eye (ANAGLYPH), ``eye`` -1.0 (left) or
    +1.0 (right), the pixel grid in ``dtype`` (the camera's when None)."""
    dev = camera.position.device
    dtype = camera.position.dtype if dtype is None else dtype
    pix = pixel_grid(cfg, dev, dtype)
    n = pix.shape[0]
    jitter, kl = _jitter(key, cfg, n, dtype, dev)
    u, v = _ndc(pix, cfg, jitter)
    return _make_rays(camera, u, v,
                      torch.full((n, 1), eye, dtype=dtype, device=dev), kl)

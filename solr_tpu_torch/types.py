"""Core data model: scene state as frozen dataclasses of tensors
(counterpart of solr_tpu/types.py).

Every pool is a structure of arrays padded with inert entries, as in the
reference.  Anything that changes the shape of the work (resolution,
bounce cap, packet widths) lives in the plain-Python ``RenderConfig``;
everything continuously variable is a tensor field.

Only the parts the bench frame uses are here: spheres and triangles,
materials without texture maps, point lights, and the triangle packet
accelerator.  Cylinders, ellipsoids, planes and textures are not ported
yet (ROADMAP A10-A11).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch

__all__ = [
    "CameraMode",
    "ProceduralKind",
    "Camera",
    "SceneInfo",
    "RenderConfig",
    "Materials",
    "Spheres",
    "Triangles",
    "Lights",
    "Textures",
    "TriAccel",
    "Scene",
]


def _frozen(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **kw: dataclasses.replace(self, **kw)
    return cls


class CameraMode(enum.IntEnum):
    MONO = 0
    ANAGLYPH = 1
    SIDE_BY_SIDE = 2
    FISHEYE = 3
    VOLUME = 4  # reserved


class ProceduralKind(enum.IntEnum):
    NONE = 0
    MANDELBROT = 1
    JULIA = 2
    CHECKER = 3
    NOISE = 4
    MARBLE = 5
    GRANITE = 6


def _vec(x, device, dtype=torch.float32):
    return torch.as_tensor(x, dtype=dtype, device=device)


@_frozen
class Camera:
    """Pinhole camera: rays leave the eye toward +z in camera space and
    ``angles`` (rx, ry, rz) rotate camera space into world space."""

    position: torch.Tensor  # (3,)
    angles: torch.Tensor  # (3,) Euler angles, applied X then Y then Z
    fov: torch.Tensor  # () vertical field of view in radians
    aperture: torch.Tensor  # () lens radius (only 0 is ported)
    focal_distance: torch.Tensor  # ()
    eye_separation: torch.Tensor  # ()

    @staticmethod
    def create(position=(0.0, 0.0, -4.0), angles=(0.0, 0.0, 0.0), fov=0.7,
               aperture=0.0, focal_distance=4.0, eye_separation=0.06,
               device="cpu") -> "Camera":
        return Camera(
            position=_vec(position, device), angles=_vec(angles, device),
            fov=_vec(fov, device), aperture=_vec(aperture, device),
            focal_distance=_vec(focal_distance, device),
            eye_separation=_vec(eye_separation, device),
        )


@_frozen
class SceneInfo:
    background_color: torch.Tensor  # (4,)
    ambient: torch.Tensor  # ()
    shadow_intensity: torch.Tensor  # () 0 = no darkening, 1 = black
    view_distance: torch.Tensor  # ()
    fog_start: torch.Tensor  # ()
    soft_shadow_radius: torch.Tensor  # ()
    gradient_sky_zenith: torch.Tensor  # (4,)
    gradient_sky_horizon: torch.Tensor  # (4,)

    @staticmethod
    def create(background_color=(0.0, 0.0, 0.0, 1.0), ambient=0.15,
               shadow_intensity=0.8, view_distance=1e4, fog_start=1e4,
               soft_shadow_radius=1.0,
               gradient_sky_zenith=(0.3, 0.5, 0.8, 1.0),
               gradient_sky_horizon=(0.9, 0.9, 1.0, 1.0),
               device="cpu") -> "SceneInfo":
        return SceneInfo(
            background_color=_vec(background_color, device),
            ambient=_vec(ambient, device),
            shadow_intensity=_vec(shadow_intensity, device),
            view_distance=_vec(view_distance, device),
            fog_start=_vec(fog_start, device),
            soft_shadow_radius=_vec(soft_shadow_radius, device),
            gradient_sky_zenith=_vec(gradient_sky_zenith, device),
            gradient_sky_horizon=_vec(gradient_sky_horizon, device),
        )


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Shape-defining render settings.  The packet fields are the
    reference's: 16x16-pixel tiles, per-strip list width K
    (``packet_max_blocks``), tile prefilter width Kt
    (``packet_tile_cand``) and the exactness net switch."""

    width: int = 256
    height: int = 256
    max_bounces: int = 2
    camera_mode: CameraMode = CameraMode.MONO
    shadows: bool = True
    shadow_samples: int = 1
    gradient_background: bool = False
    compact_rays: bool = True
    packet_tile_w: int = 16
    packet_tile_h: int = 16
    packet_max_blocks: int = 64
    packet_tile_cand: int = 256
    packet_exact: bool = True

    @property
    def packet_rays(self) -> int:
        return self.packet_tile_w * self.packet_tile_h

    @property
    def n_pixels(self) -> int:
        return self.width * self.height


@_frozen
class Materials:
    color: torch.Tensor  # (M, 4)
    specular: torch.Tensor  # (M, 2) [strength, power]
    reflection: torch.Tensor  # (M,)
    ior: torch.Tensor  # (M,)
    transparency: torch.Tensor  # (M,)
    emission: torch.Tensor  # (M,) > 0 marks a light source
    procedural: torch.Tensor  # (M,) int32 ProceduralKind
    procedural_scale: torch.Tensor  # (M,)

    @property
    def count(self) -> int:
        return self.color.shape[0]


@_frozen
class Spheres:
    center: torch.Tensor  # (N, 3)
    radius: torch.Tensor  # (N,) padding < 0
    material: torch.Tensor  # (N,) int32


@_frozen
class Triangles:
    v0: torch.Tensor  # (N, 3) padding: all-zero vertices
    v1: torch.Tensor
    v2: torch.Tensor
    n0: torch.Tensor  # (N, 3) vertex normals
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor  # (N, 2)
    uv1: torch.Tensor
    uv2: torch.Tensor
    material: torch.Tensor  # (N,) int32


@_frozen
class Lights:
    position: torch.Tensor  # (L, 3)
    color: torch.Tensor  # (L, 4) rgb * intensity
    radius: torch.Tensor  # (L,)


@_frozen
class Textures:
    """Texture atlas.  Only the empty atlas is ported; the texture
    sampling paths raise until ROADMAP A11."""

    count: int = 0


@_frozen
class TriAccel:
    """Per-block packed Woop rows and block bounds for the packet path.

    ``packed`` (NB, 16, block): rows 0..11 the Woop world->unit-triangle
    transform, rows 12..14 zero, row 15 the shadow factor.
    ``block_bounds`` (NB, 8): [cx cy cz hx hy hz 0 0]; NB is a multiple
    of 128 and padding blocks park at +1e30.
    """

    packed: torch.Tensor
    block_bounds: torch.Tensor
    block: int


@_frozen
class Scene:
    spheres: Spheres
    triangles: Triangles
    materials: Materials
    lights: Lights
    textures: Textures
    info: SceneInfo
    tri_accel: Optional[TriAccel] = None

    @property
    def device(self) -> torch.device:
        return self.materials.color.device

"""Core data model: scene state as frozen dataclasses of tensors
(counterpart of solr_tpu/types.py).

Every pool is a structure of arrays padded with inert entries, as in the
reference.  Anything that changes the shape of the work (resolution,
bounce cap, packet widths) lives in the plain-Python ``RenderConfig``;
everything continuously variable is a tensor field.

All five primitive pools are here (spheres, triangles, capped
cylinders, axis-aligned ellipsoids and planes), materials with their six
texture slots, the texture atlas, point lights, and the two accelerators
of the sphere, triangle and cylinder pools: the per-ray BVH and the
packet blocks.

Entry points put their tensors on the card unless the caller asks for
another device.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch

from solr_tpu_torch.utils.profiling import render_phase

__all__ = [
    "CameraMode",
    "PostFxMode",
    "PlaneAxis",
    "ProceduralKind",
    "Camera",
    "SceneInfo",
    "PostFxConfig",
    "RenderConfig",
    "Materials",
    "TEXTURE_SLOTS",
    "Spheres",
    "Triangles",
    "Cylinders",
    "Ellipsoids",
    "Planes",
    "Lights",
    "Textures",
    "BVH",
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


class PostFxMode(enum.IntEnum):
    NONE = 0
    DEPTH_OF_FIELD = 1
    AMBIENT_OCCLUSION = 2
    ENLIGHTMENT = 3
    CARTOON = 4


class PlaneAxis(enum.IntEnum):
    """Axis-aligned plane orientation: the value is the index of the
    normal axis."""

    YZ = 0
    XZ = 1
    XY = 2


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
    """Pinhole or thin-lens camera: rays leave the eye toward +z in
    camera space and ``angles`` (rx, ry, rz) rotate camera space into
    world space.  With ``aperture`` > 0 the origins spread over a lens
    of that radius and the rays meet at ``focal_distance``; the stereo
    modes shift each eye by ``eye_separation`` along the camera's
    right axis."""

    position: torch.Tensor  # (3,)
    angles: torch.Tensor  # (3,) Euler angles, applied X then Y then Z
    fov: torch.Tensor  # () vertical field of view in radians
    aperture: torch.Tensor  # () lens radius, 0 for a pinhole
    focal_distance: torch.Tensor  # ()
    eye_separation: torch.Tensor  # ()

    @staticmethod
    def create(position=(0.0, 0.0, -4.0), angles=(0.0, 0.0, 0.0), fov=0.7,
               aperture=0.0, focal_distance=4.0, eye_separation=0.06,
               device="cuda") -> "Camera":
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
               device="cuda") -> "SceneInfo":
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
class PostFxConfig:
    """The post-processing pass and its gather samples (depth of field,
    ambient occlusion, enlightment)."""

    mode: PostFxMode = PostFxMode.NONE
    samples: int = 16


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Shape-defining render settings.  ``use_bvh`` lets the sphere,
    triangle and cylinder pools use their BVHs; ``traversal`` picks how
    rays walk them: "auto" and "packet" take the packet path where the
    frame comes in whole tiles and the scene has a triangle BVH, "while"
    always takes the per-ray walk.  The packet fields are the
    reference's: 16x16-pixel tiles, per-strip list width K
    (``packet_max_blocks``), tile prefilter width Kt
    (``packet_tile_cand``) and the exactness net switch.
    ``shadow_samples`` > 1 jitters the light within its radius when the
    renderer is given a key (soft shadows); ``sky_texture`` is the
    texture id of a spherical sky (-1: none); ``fog`` fades shading with
    the distance travelled between ``SceneInfo.fog_start`` and
    ``view_distance``; ``antialias_jitter`` jitters each pixel's ray
    within the pixel when the renderer is given a key."""

    width: int = 256
    height: int = 256
    max_bounces: int = 2
    camera_mode: CameraMode = CameraMode.MONO
    shadows: bool = True
    shadow_samples: int = 1
    gradient_background: bool = False
    sky_texture: int = -1
    fog: bool = False
    antialias_jitter: bool = False
    compact_rays: bool = True
    postfx: PostFxConfig = PostFxConfig()
    use_bvh: bool = True
    traversal: str = "auto"  # "auto" | "packet" | "while"
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
    # Texture ids (int32, -1 for none).  The diffuse map multiplies the
    # color, the normal and bump maps perturb the shading normal, and the
    # luminance of the specular, reflection and transparency maps scales
    # those weights.
    texture_diffuse: torch.Tensor  # (M,)
    texture_normal: torch.Tensor  # (M,)
    texture_bump: torch.Tensor  # (M,)
    texture_specular: torch.Tensor  # (M,)
    texture_reflection: torch.Tensor  # (M,)
    texture_transparency: torch.Tensor  # (M,)
    procedural: torch.Tensor  # (M,) int32 ProceduralKind
    procedural_scale: torch.Tensor  # (M,)

    @property
    def count(self) -> int:
        return self.color.shape[0]


# The material's texture slots, each the field ``texture_<slot>``.
TEXTURE_SLOTS = ("diffuse", "normal", "bump", "specular", "reflection",
                 "transparency")


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
class Cylinders:
    p0: torch.Tensor  # (N, 3) axis start
    p1: torch.Tensor  # (N, 3) axis end
    radius: torch.Tensor  # (N,) padding < 0
    material: torch.Tensor  # (N,) int32


@_frozen
class Ellipsoids:
    center: torch.Tensor  # (N, 3)
    radii: torch.Tensor  # (N, 3) semi-axes; padding < 0
    material: torch.Tensor  # (N,) int32


@_frozen
class Planes:
    """Axis-aligned bounded rectangles."""

    axis: torch.Tensor  # (N,) int32 PlaneAxis, the normal axis
    origin: torch.Tensor  # (N, 3) rectangle centre
    half_extents: torch.Tensor  # (N, 2) along the two in-plane axes in
    #                             ascending order; padding < 0
    material: torch.Tensor  # (N,) int32


@_frozen
class Lights:
    position: torch.Tensor  # (L, 3)
    color: torch.Tensor  # (L, 4) rgb * intensity
    radius: torch.Tensor  # (L,)


@_frozen
class Textures:
    """Flat texture atlas: every texture's RGBA8 texels, row by row,
    one after another; texture t starts at texel ``offset[t]``."""

    atlas: torch.Tensor  # (N, 4) uint8
    offset: torch.Tensor  # (T,) int32
    width: torch.Tensor  # (T,) int32
    height: torch.Tensor  # (T,) int32

    @property
    def count(self) -> int:
        return self.offset.shape[0]


@_frozen
class BVH:
    """Median-split BVH over a Morton-ordered pool, flattened in DFS
    preorder with skip pointers.  For node i a hit continues at i + 1
    (first child or leaf payload) and a miss jumps to ``skip[i]``
    (``n_nodes`` when the walk is done).  A leaf covers the pool rows
    ``first_prim .. first_prim + prim_count``.  The leaf view lists the
    leaves alone, padded to a multiple of 128 with count-0 entries
    parked at +1e30."""

    aabb_min: torch.Tensor  # (K, 3) float32
    aabb_max: torch.Tensor  # (K, 3)
    skip: torch.Tensor  # (K,) int32
    first_prim: torch.Tensor  # (K,) int32, -1 for inner nodes
    prim_count: torch.Tensor  # (K,) int32, 0 for inner nodes
    depth: torch.Tensor  # (K,) int32
    leaf_center: torch.Tensor  # (L, 3) leaf bounding-sphere centres
    leaf_radius: torch.Tensor  # (L,)
    leaf_first: torch.Tensor  # (L,) int32
    leaf_count: torch.Tensor  # (L,) int32, 0 for padding
    max_depth: int
    leaf_size: int

    @property
    def n_nodes(self) -> int:
        return self.skip.shape[0]


@_frozen
class TriAccel:
    """Per-block packed rows and block bounds for the packet path, for
    any of the three pools (the reference's name is kept).

    ``packed`` (NB, 16, block): the primitive rows (packet.block_pack,
    sphere_pack, cylinder_pack), row 15 the shadow factor.
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
    cylinders: Cylinders
    ellipsoids: Ellipsoids
    planes: Planes
    materials: Materials
    lights: Lights
    textures: Textures
    info: SceneInfo
    tri_bvh: Optional[BVH] = None
    sph_bvh: Optional[BVH] = None
    cyl_bvh: Optional[BVH] = None
    tri_accel: Optional[TriAccel] = None
    sph_accel: Optional[TriAccel] = None
    cyl_accel: Optional[TriAccel] = None

    @property
    def device(self) -> torch.device:
        return self.materials.color.device

    # ---- the parameters inverse rendering optimizes ----

    @property
    def params(self) -> dict:
        """The gradient targets, with the reference's keys and structure:
        sphere centres and radii, triangle vertices as (v0, v1, v2),
        material colors (albedo) and IoR, light positions."""
        return {
            "sphere_center": self.spheres.center,
            "sphere_radius": self.spheres.radius,
            "vertices": (self.triangles.v0, self.triangles.v1,
                         self.triangles.v2),
            "albedo": self.materials.color,
            "ior": self.materials.ior,
            "light_position": self.lights.position,
        }

    def with_params(self, params: dict) -> "Scene":
        """The scene with the fields of :attr:`params` replaced by
        ``params`` (same structure), its packet accelerators refreshed
        from the new values.  The BVHs are not refitted, as in the
        reference (ROADMAP C9)."""
        v0, v1, v2 = params["vertices"]
        scene = self.replace(
            spheres=self.spheres.replace(center=params["sphere_center"],
                                         radius=params["sphere_radius"]),
            triangles=self.triangles.replace(v0=v0, v1=v1, v2=v2),
            materials=self.materials.replace(color=params["albedo"],
                                             ior=params["ior"]),
            lights=self.lights.replace(position=params["light_position"]),
        )
        return scene.refresh_accel()

    def refresh_accel(self) -> "Scene":
        """Rebuild the packet accelerators that the scene has from its
        pools and materials, each with its own ``block``.  The builders
        run under ``torch.no_grad``: the accelerators are detached
        traversal data and carry no graph."""
        from solr_tpu_torch.ops.packet import (build_cyl_accel,
                                               build_sph_accel,
                                               build_tri_accel)

        with render_phase("refresh"):
            updates = {}
            if self.tri_accel is not None:
                updates["tri_accel"] = build_tri_accel(
                    self.triangles, self.materials, self.tri_accel.block)
            if self.sph_accel is not None:
                updates["sph_accel"] = build_sph_accel(
                    self.spheres, self.materials, self.sph_accel.block)
            if self.cyl_accel is not None:
                updates["cyl_accel"] = build_cyl_accel(
                    self.cylinders, self.materials, self.cyl_accel.block)
            return self.replace(**updates) if updates else self

"""Scene files (counterpart of solr_tpu/io/irt.py): the reference's
versioned ``.irt`` format, so that a file saved by either package loads
in the other.

A file is a zip of ``header.json`` (version, whether a camera is
stored, which pools had a BVH, the leaf size) and ``arrays.npz`` (every
pool, material, light, texture and scene-info array as
``<group>.<field>``, and ``camera.<field>``).  BVHs are derived state:
on load each one is rebuilt over the pool's non-padding prefix, which
puts that prefix in the new build's order, as the reference does.
Version-1 files predate the specular, reflection and transparency
texture slots, which load as -1 (unset).

Like the reference, ``load_scene`` restores the BVHs but not the packet
accelerators: the frame then takes the reference's dispatch for such a
scene (the triangle accelerator derived on every frame, spheres and
cylinders on their BVH walks; ROADMAP C16).
"""

from __future__ import annotations

import io as _io
import json
import zipfile
from typing import Optional, Tuple

import numpy as np
import torch

from solr_tpu_torch.constants import BVH_LEAF_SIZE
from solr_tpu_torch.ops.bvh import build_bvh
from solr_tpu_torch.types import (Camera, Cylinders, Ellipsoids, Lights,
                                  Materials, Planes, Scene, SceneInfo, Spheres,
                                  Textures, Triangles)

IRT_VERSION = 2  # v2: specular / reflection / transparency texture slots

__all__ = ["save_scene", "load_scene", "IRT_VERSION"]

_POOLS = {
    "spheres": (Spheres, ("center", "radius", "material")),
    "triangles": (Triangles, ("v0", "v1", "v2", "n0", "n1", "n2", "uv0",
                              "uv1", "uv2", "material")),
    "cylinders": (Cylinders, ("p0", "p1", "radius", "material")),
    "ellipsoids": (Ellipsoids, ("center", "radii", "material")),
    "planes": (Planes, ("axis", "origin", "half_extents", "material")),
    "materials": (Materials, (
        "color", "specular", "reflection", "ior", "transparency", "emission",
        "texture_diffuse", "texture_normal", "texture_bump",
        "texture_specular", "texture_reflection", "texture_transparency",
        "procedural", "procedural_scale")),
    "lights": (Lights, ("position", "color", "radius")),
    "textures": (Textures, ("atlas", "offset", "width", "height")),
    "info": (SceneInfo, (
        "background_color", "ambient", "shadow_intensity", "view_distance",
        "fog_start", "soft_shadow_radius", "gradient_sky_zenith",
        "gradient_sky_horizon")),
}
_CAMERA_FIELDS = ("position", "angles", "fov", "aperture", "focal_distance",
                  "eye_separation")


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def save_scene(path: str, scene: Scene, camera: Optional[Camera] = None
               ) -> None:
    """Write ``scene`` (and ``camera``, when given) to ``path``."""
    arrays = {}
    for group, (_, fields) in _POOLS.items():
        obj = getattr(scene, group)
        for f in fields:
            arrays[f"{group}.{f}"] = _np(getattr(obj, f))
    if camera is not None:
        for f in _CAMERA_FIELDS:
            arrays[f"camera.{f}"] = _np(getattr(camera, f))
    header = {
        "version": IRT_VERSION,
        "has_camera": camera is not None,
        "bvh": {"tri": scene.tri_bvh is not None,
                "sph": scene.sph_bvh is not None,
                "cyl": scene.cyl_bvh is not None},
        "leaf_size": (scene.tri_bvh.leaf_size if scene.tri_bvh is not None
                      else BVH_LEAF_SIZE),
    }
    buf = _io.BytesIO()
    np.savez_compressed(buf, **arrays)
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("header.json", json.dumps(header))
        z.writestr("arrays.npz", buf.getvalue())


def _permute(pool, perm: np.ndarray):
    """The pool with every array's rows in ``perm`` order."""
    p = torch.as_tensor(perm, device=pool.material.device)
    return type(pool)(**{f: getattr(pool, f)[p]
                         for f in pool.__dataclass_fields__})


def _rebuild(pool, amin, amax, n_real, leaf_size, dev):
    """(BVH over the first n_real rows, the pool in its order)."""
    bvh, order = build_bvh(amin[:n_real], amax[:n_real], leaf_size,
                           device=dev)
    perm = np.concatenate([order, np.arange(n_real, amin.shape[0])])
    return bvh, _permute(pool, perm)


def load_scene(path: str, device="cuda") -> Tuple[Scene, Optional[Camera]]:
    """(scene, camera or None) from ``path``, on ``device``, with the
    BVHs rebuilt and no packet accelerators."""
    dev = torch.device(device)
    with zipfile.ZipFile(path) as z:
        header = json.loads(z.read("header.json"))
        if header["version"] > IRT_VERSION:
            raise ValueError(f"irt version {header['version']} > supported "
                             f"{IRT_VERSION}")
        data = dict(np.load(_io.BytesIO(z.read("arrays.npz"))))

    def group(name):
        cls, fields = _POOLS[name]
        kwargs = {}
        for f in fields:
            key = f"{name}.{f}"
            if key in data:
                arr = data[key]
            elif name == "materials" and f.startswith("texture_"):
                arr = np.full(data["materials.color"].shape[:1], -1, np.int32)
            else:
                raise KeyError(key)
            kwargs[f] = torch.as_tensor(np.array(arr), device=dev)
        return cls(**kwargs)

    pools = {name: group(name) for name in _POOLS}
    leaf_size = int(header.get("leaf_size", BVH_LEAF_SIZE))
    bvhs = {"tri_bvh": None, "sph_bvh": None, "cyl_bvh": None}
    if header["bvh"]["tri"]:
        t = pools["triangles"]
        v0, v1, v2 = (_np(getattr(t, k)) for k in ("v0", "v1", "v2"))
        n_real = int((~np.all((v0 == 0) & (v1 == 0) & (v2 == 0), -1)).sum())
        if n_real:
            bvhs["tri_bvh"], pools["triangles"] = _rebuild(
                t, np.minimum(np.minimum(v0, v1), v2),
                np.maximum(np.maximum(v0, v1), v2), n_real, leaf_size, dev)
    if header["bvh"]["sph"]:
        s = pools["spheres"]
        c, r = _np(s.center), _np(s.radius)
        n_real = int((r > 0).sum())
        if n_real:
            bvhs["sph_bvh"], pools["spheres"] = _rebuild(
                s, c - r[:, None], c + r[:, None], n_real, leaf_size, dev)
    if header["bvh"]["cyl"]:
        cy = pools["cylinders"]
        p0, p1, r = _np(cy.p0), _np(cy.p1), _np(cy.radius)
        n_real = int((r > 0).sum())
        if n_real:
            bvhs["cyl_bvh"], pools["cylinders"] = _rebuild(
                cy, np.minimum(p0, p1) - r[:, None],
                np.maximum(p0, p1) + r[:, None], n_real, leaf_size, dev)
    scene = Scene(**pools, **bvhs)

    camera = None
    if header["has_camera"]:
        camera = Camera(**{f: torch.as_tensor(data[f"camera.{f}"], device=dev)
                           for f in _CAMERA_FIELDS})
    return scene, camera

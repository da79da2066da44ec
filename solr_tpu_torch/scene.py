"""SceneBuilder: scene construction (counterpart of solr_tpu/scene.py):
materials with texture slots, textures, spheres, triangle meshes and
soups, capped cylinders, axis-aligned ellipsoids and planes, and
emissive-sphere lights.

``build`` freezes the host-side numpy state into a :class:`Scene` on the
requested device (the card unless the caller asks for another).  With
``use_bvh``, each sphere, triangle or cylinder pool of at least
``bvh_threshold`` primitives gets its BVH (``ops.bvh.build_bvh``), which
puts the pool in Morton order, and its packet accelerator.  Ellipsoids
and planes are always brute-forced, as in the reference.

The order is the stable argsort of the 30-bit Morton codes of the
primitives' AABB centroids, the numpy path of
``solr_tpu.ops.bvh.build_bvh`` (bvh.py:110-111), with the reference's
AABBs: a triangle's vertex min/max, a sphere's c -+ r, a cylinder's
min/max(p0, p1) -+ r (reference scene.py:426-448).  The reference
prefers its native LBVH builder (native/src/lbvh.cc:79-88), which
computes the same float32 codes and sorts them with ``std::stable_sort``,
so it gives the same order and node arrays; tests/test_torch_scene.py
and tests/test_torch_bvh.py hold the builders to that.  Lights are
collected from the emissive spheres and then the emissive ellipsoids
before the reorder, as in the reference.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from solr_tpu_torch.constants import DEFAULT_BLOCK, PAD_ALIGN
from solr_tpu_torch.ops.bvh import build_bvh, morton_codes, morton_order
from solr_tpu_torch.ops.packet import (build_cyl_accel, build_sph_accel,
                                       build_tri_accel)
from solr_tpu_torch.types import (TEXTURE_SLOTS, Cylinders, Ellipsoids,
                                  Lights, Materials, PlaneAxis, Planes,
                                  ProceduralKind, Scene, SceneInfo, Spheres,
                                  Textures, Triangles)

__all__ = ["SceneBuilder", "morton_codes", "morton_order"]

_F32 = np.float32


def _pad_to(n: int, align: int = PAD_ALIGN) -> int:
    return 0 if n == 0 else ((n + align - 1) // align) * align


def _pad_rows(arr: np.ndarray, n_pad: int, fill) -> np.ndarray:
    if n_pad == arr.shape[0]:
        return arr
    pad = np.full((n_pad - arr.shape[0],) + arr.shape[1:], fill, arr.dtype)
    return np.concatenate([arr, pad], 0)


class SceneBuilder:
    """Accumulates materials and primitives and freezes a Scene.  Ids
    follow the reference: material 0 is the default material."""

    def __init__(self):
        self._mat = []
        self._spheres = []
        self._triangles = []  # bulk blocks of per-triangle arrays
        self._cylinders = []
        self._ellipsoids = []
        self._planes = []
        self._tex_data = []  # (H, W, 4) uint8 images
        self.add_material(color=(0.8, 0.8, 0.8, 1.0))

    def add_material(self, color=(0.8, 0.8, 0.8, 1.0), specular: float = 0.0,
                     specular_power: float = 50.0, reflection: float = 0.0,
                     ior: float = 1.0, transparency: float = 0.0,
                     emission: float = 0.0, texture_diffuse: int = -1,
                     texture_normal: int = -1, texture_bump: int = -1,
                     texture_specular: int = -1, texture_reflection: int = -1,
                     texture_transparency: int = -1,
                     procedural: ProceduralKind = ProceduralKind.NONE,
                     procedural_scale: float = 8.0) -> int:
        """A material; each ``texture_*`` is a texture id from
        :meth:`add_texture` or -1 for none."""
        self._mat.append(dict(
            color=np.asarray(color, _F32),
            specular=np.asarray([specular, specular_power], _F32),
            reflection=float(reflection), ior=float(ior),
            transparency=float(transparency), emission=float(emission),
            texture_diffuse=int(texture_diffuse),
            texture_normal=int(texture_normal),
            texture_bump=int(texture_bump),
            texture_specular=int(texture_specular),
            texture_reflection=int(texture_reflection),
            texture_transparency=int(texture_transparency),
            procedural=int(procedural),
            procedural_scale=float(procedural_scale),
        ))
        return len(self._mat) - 1

    def add_texture(self, image) -> int:
        """An (H, W), (H, W, 3) or (H, W, 4) image, uint8 or float in
        [0, 1] (scaled by 255 and truncated); gray becomes RGB and a
        missing alpha 255.  Returns its texture id."""
        img = np.asarray(image)
        if img.dtype != np.uint8:
            img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        if img.shape[-1] == 3:
            img = np.concatenate(
                [img, np.full(img.shape[:2] + (1,), 255, np.uint8)], -1)
        self._tex_data.append(img)
        return len(self._tex_data) - 1

    def add_sphere(self, center, radius: float, material: int = 0) -> int:
        self._spheres.append((np.asarray(center, _F32), float(radius),
                              int(material)))
        return len(self._spheres) - 1

    def add_triangle(self, v0, v1, v2, material: int = 0, normals=None,
                     uvs=None) -> int:
        """One triangle; optional per-vertex normals (3 x (3,)) and uvs
        (3 x (2,)).  Returns its id."""
        n = None if normals is None else np.stack(
            [np.asarray(x, _F32) for x in normals])[None]
        u = None if uvs is None else np.stack(
            [np.asarray(x, _F32) for x in uvs])[None]
        return self.add_triangles_raw(*(np.asarray(v, _F32)[None]
                                        for v in (v0, v1, v2)),
                                      material=material, normals=n, uvs=u)

    def add_triangles_raw(self, v0, v1, v2, material=0,
                          normals: Optional[np.ndarray] = None,
                          uvs: Optional[np.ndarray] = None) -> int:
        """Triangle soup: (K, 3) vertex arrays, a scalar or (K,) material,
        optional per-vertex normals (K, 3, 3) and uvs (K, 3, 2); without
        normals each triangle gets its geometric normal.  Returns the id
        of the first triangle."""
        v0, v1, v2 = (np.atleast_2d(np.asarray(v, _F32))
                      for v in (v0, v1, v2))
        k = v0.shape[0]
        if normals is None:
            gn = np.cross(v1 - v0, v2 - v0)
            gn = gn / np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True),
                                 1e-12)
            n0 = n1 = n2 = gn.astype(_F32)
        else:
            normals = np.asarray(normals, _F32)
            n0, n1, n2 = normals[:, 0], normals[:, 1], normals[:, 2]
        if uvs is None:
            u0 = u1 = u2 = np.zeros((k, 2), _F32)
        else:
            uvs = np.asarray(uvs, _F32)
            u0, u1, u2 = uvs[:, 0], uvs[:, 1], uvs[:, 2]
        mat = np.broadcast_to(np.asarray(material, np.int32), (k,)).astype(np.int32)
        first = sum(blk[0].shape[0] for blk in self._triangles)
        self._triangles.append((v0, v1, v2, n0, n1, n2, u0, u1, u2, mat))
        return first

    def add_mesh(self, vertices, faces, material: int = 0, normals=None,
                 uvs=None) -> int:
        """Indexed mesh: (V, 3) vertices, (F, 3) faces; optional
        per-vertex normals (V, 3) and uvs (V, 2).  Returns the id of the
        first triangle."""
        vertices = np.asarray(vertices, _F32)
        faces = np.asarray(faces, np.int64)
        v0, v1, v2 = (vertices[faces[:, i]] for i in range(3))
        n = u = None
        if normals is not None:
            normals = np.asarray(normals, _F32)
            n = np.stack([normals[faces[:, i]] for i in range(3)], 1)
        if uvs is not None:
            uvs = np.asarray(uvs, _F32)
            u = np.stack([uvs[faces[:, i]] for i in range(3)], 1)
        return self.add_triangles_raw(v0, v1, v2, material, n, u)

    def add_cylinder(self, p0, p1, radius: float, material: int = 0) -> int:
        """Capped cylinder from p0 to p1."""
        self._cylinders.append((np.asarray(p0, _F32), np.asarray(p1, _F32),
                                float(radius), int(material)))
        return len(self._cylinders) - 1

    def add_ellipsoid(self, center, radii, material: int = 0) -> int:
        """Axis-aligned ellipsoid with semi-axes ``radii`` (3,)."""
        self._ellipsoids.append((np.asarray(center, _F32),
                                 np.asarray(radii, _F32), int(material)))
        return len(self._ellipsoids) - 1

    def add_plane(self, axis: PlaneAxis, origin, half_extents,
                  material: int = 0) -> int:
        """Axis-aligned rectangle normal to ``axis``, centred at
        ``origin``, with half sizes (2,) along the two other axes in
        ascending order."""
        self._planes.append((int(axis), np.asarray(origin, _F32),
                             np.asarray(half_extents, _F32), int(material)))
        return len(self._planes) - 1

    def add_light(self, position, color=(1.0, 1.0, 1.0, 1.0),
                  intensity: float = 1.0, radius: float = 0.1) -> int:
        """Emissive-sphere light: lights are the primitives whose
        material emits."""
        mat = self.add_material(color=color, emission=float(intensity))
        return self.add_sphere(position, radius, mat)

    def build(self, block: int = DEFAULT_BLOCK, use_bvh: bool = True,
              bvh_threshold: int = 64, device="cuda") -> Scene:
        """Freeze into a Scene on ``device``.  ``block`` is the packet
        accelerators' primitives per block."""
        dt = _F32
        dev = torch.device(device)

        def ten(x, dtype=torch.float32):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                                   device=dev)

        def rows(items, i, shape):
            return (np.stack([np.asarray(it[i], dt) for it in items]) if items
                    else np.zeros((0,) + shape, dt))

        def ids(items, i):
            return np.asarray([it[i] for it in items], np.int32)

        mats = self._mat
        materials = Materials(
            color=ten(np.stack([m["color"] for m in mats])),
            specular=ten(np.stack([m["specular"] for m in mats])),
            reflection=ten([m["reflection"] for m in mats]),
            ior=ten([m["ior"] for m in mats]),
            transparency=ten([m["transparency"] for m in mats]),
            emission=ten([m["emission"] for m in mats]),
            **{f"texture_{k}": ten([m[f"texture_{k}"] for m in mats],
                                   torch.int32) for k in TEXTURE_SLOTS},
            procedural=ten([m["procedural"] for m in mats], torch.int32),
            procedural_scale=ten([m["procedural_scale"] for m in mats]),
        )
        # The atlas: every texture's texels, row by row, in id order.
        sizes = [img.shape[0] * img.shape[1] for img in self._tex_data]
        textures = Textures(
            atlas=ten(np.concatenate([img.reshape(-1, 4)
                                      for img in self._tex_data])
                      if sizes else np.zeros((0, 4), np.uint8), torch.uint8),
            offset=ten(np.cumsum([0] + sizes[:-1]) if sizes else [],
                       torch.int32),
            width=ten([img.shape[1] for img in self._tex_data], torch.int32),
            height=ten([img.shape[0] for img in self._tex_data],
                       torch.int32))

        sph_c = rows(self._spheres, 0, (3,))
        sph_r = np.asarray([s[1] for s in self._spheres], dt)
        sph_m = ids(self._spheres, 2)
        cyl = [rows(self._cylinders, 0, (3,)), rows(self._cylinders, 1, (3,)),
               np.asarray([c[2] for c in self._cylinders], dt),
               ids(self._cylinders, 3)]
        ell_c, ell_r = rows(self._ellipsoids, 0, (3,)), rows(self._ellipsoids, 1, (3,))
        ell_m = ids(self._ellipsoids, 2)

        if self._triangles:
            tri = [np.concatenate([blk[i] for blk in self._triangles])
                   for i in range(10)]
        else:
            tri = [np.zeros((0, 3), dt)] * 6 + [np.zeros((0, 2), dt)] * 3 \
                + [np.zeros((0,), np.int32)]
        n_sph, n_tri, n_cyl = len(sph_r), tri[0].shape[0], len(cyl[2])

        # Lights from emissive spheres, then emissive ellipsoids (their
        # mean semi-axis as the radius), in insertion order.
        emis = np.asarray([m["emission"] for m in mats], dt)
        colors = np.stack([m["color"] for m in mats])
        lp, lc, lr = [], [], []
        for c, r, m in list(zip(sph_c, sph_r, sph_m)) + [
                (c, float(np.mean(r3)), m)
                for c, r3, m in zip(ell_c, ell_r, ell_m)]:
            if emis[m] > 0:
                lp.append(c)
                lc.append(colors[m] * emis[m])
                lr.append(r)
        lights = Lights(
            position=ten(np.stack(lp) if lp else np.zeros((0, 3), dt)),
            color=ten(np.stack(lc) if lc else np.zeros((0, 4), dt)),
            radius=ten(np.asarray(lr, dt)),
        )

        # The BVH of each large pool, which puts the pool in its order.
        def bvh(n, amin, amax):
            if not use_bvh or n < bvh_threshold:
                return None, None
            return build_bvh(amin, amax, device=dev)

        v0, v1, v2 = tri[:3]
        tri_bvh, order = bvh(n_tri, np.minimum(np.minimum(v0, v1), v2),
                             np.maximum(np.maximum(v0, v1), v2))
        if order is not None:
            tri = [a[order] for a in tri]
        sph_bvh, order = bvh(n_sph, sph_c - sph_r[:, None],
                             sph_c + sph_r[:, None])
        if order is not None:
            sph_c, sph_r, sph_m = sph_c[order], sph_r[order], sph_m[order]
        p0, p1, r = cyl[0], cyl[1], cyl[2][:, None]
        cyl_bvh, order = bvh(n_cyl, np.minimum(p0, p1) - r,
                             np.maximum(p0, p1) + r)
        if order is not None:
            cyl = [a[order] for a in cyl]

        ns, nt, nc = _pad_to(n_sph), _pad_to(n_tri), _pad_to(n_cyl)
        ne, npl = _pad_to(len(self._ellipsoids)), _pad_to(len(self._planes))
        spheres = Spheres(center=ten(_pad_rows(sph_c, ns, 0.0)),
                          radius=ten(_pad_rows(sph_r, ns, -1.0)),
                          material=ten(_pad_rows(sph_m, ns, 0), torch.int32))
        triangles = Triangles(
            *(ten(_pad_rows(a, nt, 0.0)) for a in tri[:9]),
            material=ten(_pad_rows(tri[9], nt, 0), torch.int32))
        cylinders = Cylinders(p0=ten(_pad_rows(cyl[0], nc, 0.0)),
                              p1=ten(_pad_rows(cyl[1], nc, 0.0)),
                              radius=ten(_pad_rows(cyl[2], nc, -1.0)),
                              material=ten(_pad_rows(cyl[3], nc, 0), torch.int32))
        ellipsoids = Ellipsoids(
            center=ten(_pad_rows(ell_c, ne, 0.0)),
            radii=ten(_pad_rows(ell_r, ne, -1.0)),
            material=ten(_pad_rows(ell_m, ne, 0), torch.int32))
        planes = Planes(
            axis=ten(_pad_rows(ids(self._planes, 0), npl, 0), torch.int32),
            origin=ten(_pad_rows(rows(self._planes, 1, (3,)), npl, 0.0)),
            half_extents=ten(_pad_rows(rows(self._planes, 2, (2,)), npl, -1.0)),
            material=ten(_pad_rows(ids(self._planes, 3), npl, 0), torch.int32))
        return Scene(
            spheres=spheres, triangles=triangles, cylinders=cylinders,
            ellipsoids=ellipsoids, planes=planes, materials=materials,
            lights=lights, textures=textures,
            info=SceneInfo.create(device=dev),
            tri_bvh=tri_bvh, sph_bvh=sph_bvh, cyl_bvh=cyl_bvh,
            tri_accel=(build_tri_accel(triangles, materials, block)
                       if tri_bvh is not None else None),
            sph_accel=(build_sph_accel(spheres, materials, block)
                       if sph_bvh is not None else None),
            cyl_accel=(build_cyl_accel(cylinders, materials, block)
                       if cyl_bvh is not None else None))

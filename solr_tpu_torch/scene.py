"""SceneBuilder: scene construction (counterpart of solr_tpu/scene.py,
for the pools the port has: materials, spheres, triangle meshes and
emissive-sphere lights).

``build`` freezes the host-side numpy state into a :class:`Scene` on the
requested device.  A triangle pool of at least ``bvh_threshold``
triangles is put in Morton order and gets the packet accelerator; BVH
node arrays are not built, since the packet path needs only the order.

The order is the stable argsort of the 30-bit Morton codes of the
triangles' AABB centroids, the numpy path of
``solr_tpu.ops.bvh.build_bvh`` (bvh.py:110-111).  The reference prefers
its native LBVH builder (native/src/lbvh.cc:79-88), which computes the
same float32 codes and sorts them with ``std::stable_sort``, so it gives
the same order; tests/test_torch_scene.py holds the two builders to
that.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from solr_tpu_torch.constants import PAD_ALIGN
from solr_tpu_torch.ops.packet import build_tri_accel
from solr_tpu_torch.types import (Lights, Materials, ProceduralKind, Scene,
                                  SceneInfo, Spheres, Textures, Triangles)

__all__ = ["SceneBuilder", "morton_codes"]

_F32 = np.float32


def _pad_to(n: int, align: int = PAD_ALIGN) -> int:
    return 0 if n == 0 else ((n + align - 1) // align) * align


def _pad_rows(arr: np.ndarray, n_pad: int, fill) -> np.ndarray:
    if n_pad == arr.shape[0]:
        return arr
    pad = np.full((n_pad - arr.shape[0],) + arr.shape[1:], fill, arr.dtype)
    return np.concatenate([arr, pad], 0)


def _expand_bits(v: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of v to every 3rd bit."""
    v = v.astype(np.uint64)
    v = (v * np.uint64(0x00010001)) & np.uint64(0xFF0000FF)
    v = (v * np.uint64(0x00000101)) & np.uint64(0x0F00F00F)
    v = (v * np.uint64(0x00000011)) & np.uint64(0xC30C30C3)
    v = (v * np.uint64(0x00000005)) & np.uint64(0x49249249)
    return v


def morton_codes(centroids: np.ndarray) -> np.ndarray:
    """30-bit 3-D Morton codes of points quantized into a 1024^3 grid."""
    lo = centroids.min(axis=0)
    hi = centroids.max(axis=0)
    span = np.maximum(hi - lo, 1e-12)
    q = np.clip(((centroids - lo) / span) * 1023.0, 0, 1023).astype(np.uint32)
    return ((_expand_bits(q[:, 0]) << np.uint64(2))
            | (_expand_bits(q[:, 1]) << np.uint64(1))
            | _expand_bits(q[:, 2]))


class SceneBuilder:
    """Accumulates materials and primitives and freezes a Scene.  Ids
    follow the reference: material 0 is the default material."""

    def __init__(self):
        self._mat = []
        self._spheres = []
        self._triangles = []  # bulk blocks of per-triangle arrays
        self.add_material(color=(0.8, 0.8, 0.8, 1.0))

    def add_material(self, color=(0.8, 0.8, 0.8, 1.0), specular: float = 0.0,
                     specular_power: float = 50.0, reflection: float = 0.0,
                     ior: float = 1.0, transparency: float = 0.0,
                     emission: float = 0.0,
                     procedural: ProceduralKind = ProceduralKind.NONE,
                     procedural_scale: float = 8.0) -> int:
        self._mat.append(dict(
            color=np.asarray(color, _F32),
            specular=np.asarray([specular, specular_power], _F32),
            reflection=float(reflection), ior=float(ior),
            transparency=float(transparency), emission=float(emission),
            procedural=int(procedural),
            procedural_scale=float(procedural_scale),
        ))
        return len(self._mat) - 1

    def add_sphere(self, center, radius: float, material: int = 0) -> int:
        self._spheres.append((np.asarray(center, _F32), float(radius),
                              int(material)))
        return len(self._spheres) - 1

    def _add_triangles(self, v0, v1, v2, material=0,
                       normals: Optional[np.ndarray] = None,
                       uvs: Optional[np.ndarray] = None) -> int:
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
        return self._add_triangles(v0, v1, v2, material, n, u)

    def add_light(self, position, color=(1.0, 1.0, 1.0, 1.0),
                  intensity: float = 1.0, radius: float = 0.1) -> int:
        """Emissive-sphere light: lights are the primitives whose
        material emits."""
        mat = self.add_material(color=color, emission=float(intensity))
        return self.add_sphere(position, radius, mat)

    def build(self, block: int = 256, bvh_threshold: int = 64,
              device="cpu") -> Scene:
        """Freeze into a Scene on ``device``.  ``block`` is the packet
        accelerator's triangles per block."""
        dt = _F32
        dev = torch.device(device)

        def ten(x, dtype=torch.float32):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                                   device=dev)

        mats = self._mat
        materials = Materials(
            color=ten(np.stack([m["color"] for m in mats])),
            specular=ten(np.stack([m["specular"] for m in mats])),
            reflection=ten([m["reflection"] for m in mats]),
            ior=ten([m["ior"] for m in mats]),
            transparency=ten([m["transparency"] for m in mats]),
            emission=ten([m["emission"] for m in mats]),
            procedural=ten([m["procedural"] for m in mats], torch.int32),
            procedural_scale=ten([m["procedural_scale"] for m in mats]),
        )

        n_sph = len(self._spheres)
        if n_sph >= bvh_threshold:
            raise NotImplementedError(
                "sphere pools of >= bvh_threshold spheres take the sphere "
                "sweep kernels, which are not ported yet")
        sph_c = (np.stack([s[0] for s in self._spheres]) if n_sph
                 else np.zeros((0, 3), dt))
        sph_r = np.asarray([s[1] for s in self._spheres], dt)
        sph_m = np.asarray([s[2] for s in self._spheres], np.int32)

        if self._triangles:
            tri = [np.concatenate([blk[i] for blk in self._triangles])
                   for i in range(10)]
        else:
            tri = [np.zeros((0, 3), dt)] * 6 + [np.zeros((0, 2), dt)] * 3 \
                + [np.zeros((0,), np.int32)]
        n_tri = tri[0].shape[0]
        accelerate = n_tri >= bvh_threshold
        if accelerate:
            v0, v1, v2 = tri[0], tri[1], tri[2]
            amin = np.minimum(np.minimum(v0, v1), v2)
            amax = np.maximum(np.maximum(v0, v1), v2)
            order = np.argsort(morton_codes(0.5 * (amin + amax)), kind="stable")
            tri = [a[order] for a in tri]

        # Lights from emissive spheres.
        emis = np.asarray([m["emission"] for m in mats], dt)
        colors = np.stack([m["color"] for m in mats])
        lp, lc, lr = [], [], []
        for c, r, m in zip(sph_c, sph_r, sph_m):
            if emis[m] > 0:
                lp.append(c)
                lc.append(colors[m] * emis[m])
                lr.append(r)
        lights = Lights(
            position=ten(np.stack(lp) if lp else np.zeros((0, 3), dt)),
            color=ten(np.stack(lc) if lc else np.zeros((0, 4), dt)),
            radius=ten(np.asarray(lr, dt)),
        )

        ns, nt = _pad_to(n_sph), _pad_to(n_tri)
        spheres = Spheres(center=ten(_pad_rows(sph_c, ns, 0.0)),
                          radius=ten(_pad_rows(sph_r, ns, -1.0)),
                          material=ten(_pad_rows(sph_m, ns, 0), torch.int32))
        triangles = Triangles(
            *(ten(_pad_rows(a, nt, 0.0)) for a in tri[:9]),
            material=ten(_pad_rows(tri[9], nt, 0), torch.int32))
        scene = Scene(spheres=spheres, triangles=triangles,
                      materials=materials, lights=lights, textures=Textures(),
                      info=SceneInfo.create(device=dev))
        if accelerate:
            scene = scene.replace(
                tri_accel=build_tri_accel(triangles, materials, block))
        return scene

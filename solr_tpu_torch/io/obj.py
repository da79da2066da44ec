"""Wavefront OBJ + MTL import (counterpart of solr_tpu/io/obj.py).

``load_obj`` parses geometry with the native C++ parser
(``solr_tpu_torch.native.obj_load``), as the reference does by default;
``parse_obj`` is its plain Python and numpy version, with the same
output, which the tests hold the native parser to.  Polygons
fan-triangulate, indices resolve 1-based and negative ones against the
elements read so far, faces group by ``usemtl`` slot (slots numbered by
first appearance of each material name, faces before any ``usemtl``
taking the default material), and each group becomes one bulk triangle
block, in slot order, with the group's normals and uvs when its first
face carries them.  The model is centred on its bounding box and, with
``scale``, scaled so that its largest |coordinate| is ``scale``.  MTL
materials come first, with ``map_Kd`` and the other maps loaded through
``add_texture``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from solr_tpu_torch import native
from solr_tpu_torch.io.image import load_image

__all__ = ["load_obj", "parse_mtl", "parse_obj"]

_MAPS = ("map_kd", "map_ks", "map_d", "map_refl", "map_bump", "norm")


def parse_mtl(path: str, builder, texture_dir: Optional[str] = None):
    """Parse an MTL library into builder materials; returns
    {material name: material id}.  Kd is the colour, max(Ks) the
    specular strength with Ns its power, d (or 1 - Tr) the opacity, Ni
    the IoR, illum >= 3 a reflection of 0.4; map_Kd, norm, map_bump (or
    bump), map_Ks, map_refl (or refl) and map_d are textures looked up in
    ``texture_dir``."""
    mats: Dict[str, int] = {}
    if not os.path.exists(path):
        return mats
    name = None
    props: Dict[str, object] = {}

    def load_map(key):
        if key in props and texture_dir is not None:
            tex_path = os.path.join(texture_dir, str(props[key]))
            if os.path.exists(tex_path):
                return builder.add_texture(load_image(tex_path))
        return -1

    def flush():
        if name is None:
            return
        kd = props.get("kd", (0.8, 0.8, 0.8))
        illum = int(props.get("illum", 2))
        mats[name] = builder.add_material(
            color=(kd[0], kd[1], kd[2], 1.0),
            specular=float(np.max(props.get("ks", (0.0, 0.0, 0.0)))),
            specular_power=float(props.get("ns", 50.0)),
            reflection=0.4 if illum >= 3 else 0.0,
            ior=float(props.get("ni", 1.0)),
            transparency=1.0 - float(props.get("d", 1.0)),
            texture_diffuse=load_map("map_kd"),
            texture_normal=load_map("norm"),
            texture_bump=load_map("map_bump"),
            texture_specular=load_map("map_ks"),
            texture_reflection=load_map("map_refl"),
            texture_transparency=load_map("map_d"),
        )

    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0].lower()
            if key == "newmtl":
                flush()
                name, props = parts[1], {}
            elif key in ("kd", "ks"):
                props[key] = tuple(float(x) for x in parts[1:4])
            elif key in ("ns", "ni", "d"):
                props[key] = float(parts[1])
            elif key == "tr":
                props["d"] = 1.0 - float(parts[1])
            elif key == "illum":
                props["illum"] = int(parts[1])
            elif key in _MAPS:
                props[key] = parts[-1]
            elif key == "bump":  # a synonym many exporters write
                props["map_bump"] = parts[-1]
            elif key == "refl":
                props["map_refl"] = parts[-1]
    flush()
    return mats


def _index(text: str, count: int) -> int:
    """A 1-based OBJ index, negative from the end of the ``count``
    elements read so far; -1 when absent."""
    if not text:
        return -1
    i = int(text)
    return i - 1 if i > 0 else (count + i if i < 0 else -1)


def _floats(rows, width: int) -> np.ndarray:
    out = np.zeros((len(rows), width), np.float32)
    for i, r in enumerate(rows):
        vals = [float(x) for x in r[:width]]
        out[i, :len(vals)] = vals
    return out


def parse_obj(path: str) -> dict:
    """The geometry of an OBJ file, parsed in Python (the plain version
    of ``native.obj_load``): ``v`` (nv, 3), ``vt`` (nvt, 2) and
    ``vn`` (nvn, 3) float32; per triangle ``f_v``, ``f_vt``, ``f_vn``
    (ntris, 3) int32, 0-based, -1 where absent, and ``f_slot`` (ntris,)
    int32 (-1 before any usemtl); ``mtllibs`` and the slot-ordered
    ``usemtls``."""
    v, vt, vn = [], [], []
    f_idx, f_slot = [], []
    slots: Dict[str, int] = {}
    mtllibs = []
    cur = -1
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            key = parts[0]
            if key == "v":
                v.append(parts[1:4])
            elif key == "vt":
                vt.append(parts[1:3])
            elif key == "vn":
                vn.append(parts[1:4])
            elif key == "f":
                refs = []
                for p in parts[1:]:
                    c = p.split("/")
                    refs.append((
                        _index(c[0], len(v)),
                        _index(c[1] if len(c) > 1 else "", len(vt)),
                        _index(c[2] if len(c) > 2 else "", len(vn))))
                for a in range(1, len(refs) - 1):
                    f_idx.append((refs[0], refs[a], refs[a + 1]))
                    f_slot.append(cur)
            elif key == "usemtl" and len(parts) > 1:
                cur = slots.setdefault(parts[1], len(slots))
            elif key == "mtllib" and len(parts) > 1:
                mtllibs.append(parts[1])
    tri = np.asarray(f_idx, np.int32).reshape(-1, 3, 3)
    return {"v": _floats(v, 3), "vt": _floats(vt, 2), "vn": _floats(vn, 3),
            "f_v": np.ascontiguousarray(tri[..., 0]),
            "f_vt": np.ascontiguousarray(tri[..., 1]),
            "f_vn": np.ascontiguousarray(tri[..., 2]),
            "f_slot": np.asarray(f_slot, np.int32), "mtllibs": mtllibs,
            "usemtls": list(slots)}


def load_obj(path: str, builder, material: Optional[int] = None,
             scale: Optional[float] = None, center: bool = True,
             load_materials: bool = True):
    """Import an OBJ file into ``builder``; returns the first triangle
    id, or None for a file without vertices.  ``material`` overrides the
    MTL materials when given.  The geometry is parsed by
    ``native.obj_load``."""
    parsed = native.obj_load(path)
    obj_dir = os.path.dirname(os.path.abspath(path))
    v = parsed["v"]
    if v.shape[0] == 0:
        return None
    if center:
        v = v - 0.5 * (v.min(axis=0) + v.max(axis=0))
    if scale is not None:
        extent = float(np.abs(v).max())
        if extent > 0:
            v = v * (scale / extent)

    mtl_map = {}
    if load_materials and material is None:
        for lib in parsed["mtllibs"]:
            mtl_map.update(parse_mtl(os.path.join(obj_dir, lib), builder,
                                     obj_dir))
    if material is not None:
        slot_mat = {s: material for s in range(-1, len(parsed["usemtls"]))}
    else:
        slot_mat = {-1: 0}
        for s, name in enumerate(parsed["usemtls"]):
            slot_mat[s] = mtl_map.get(name, 0)

    vn, vt = parsed["vn"], parsed["vt"]
    first = None
    for slot in np.unique(parsed["f_slot"]).tolist():
        sel = parsed["f_slot"] == slot
        fv = parsed["f_v"][sel]
        normals = uvs = None
        fn, ft = parsed["f_vn"][sel], parsed["f_vt"][sel]
        if len(vn) and (fn[0] >= 0).all():
            fn = np.clip(fn, 0, len(vn) - 1)
            normals = np.stack([vn[fn[:, i]] for i in range(3)], axis=1)
        if len(vt) and (ft[0] >= 0).all():
            ft = np.clip(ft, 0, len(vt) - 1)
            uvs = np.stack([vt[ft[:, i]] for i in range(3)], axis=1)
        tid = builder.add_triangles_raw(
            v[fv[:, 0]], v[fv[:, 1]], v[fv[:, 2]],
            material=slot_mat.get(slot, 0), normals=normals, uvs=uvs)
        first = tid if first is None else first
    return first

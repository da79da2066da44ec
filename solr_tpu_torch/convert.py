"""Carry the reference package's state across: turn a ``solr_tpu``
Scene, Camera or RenderConfig, flattened to nested dicts of numpy
arrays, into this package's objects leaf by leaf.

The caller flattens (a dataclass becomes a dict of its fields, an array
becomes a numpy array); this module takes numpy only and imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from solr_tpu_torch.types import (BVH, TEXTURE_SLOTS, Camera, CameraMode,
                                  Cylinders, Ellipsoids, Lights, Materials,
                                  Planes, PostFxConfig, PostFxMode,
                                  RenderConfig, Scene, SceneInfo, Spheres,
                                  Textures, Triangles, TriAccel)

__all__ = ["scene_from_numpy", "camera_from_numpy",
           "config_from_reference_fields"]


def _t(x, device, dtype=None):
    a = np.asarray(x)
    if dtype is None:
        dtype = torch.int32 if np.issubdtype(a.dtype, np.integer) else torch.float32
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def scene_from_numpy(tree: dict, device, dtype=torch.float32) -> Scene:
    """Build a Scene from the reference's Scene flattened to numpy.

    ``tree`` has the reference's field names: the spheres, triangles,
    cylinders, ellipsoids and planes pools, materials, lights, textures,
    info, tri_bvh, sph_bvh and cyl_bvh (each None
    or a BVH), and tri_accel, sph_accel and cyl_accel (each None or an
    accelerator).  Float leaves become ``dtype`` (float64 for the f64
    parity runs), integer leaves int32.
    """
    dev = torch.device(device)

    def fl(x):
        return _t(x, dev, dtype)

    def ix(x):
        return _t(x, dev, torch.int32)

    tex = tree["textures"]
    textures = Textures(atlas=_t(tex["atlas"], dev, torch.uint8),
                        offset=ix(tex["offset"]), width=ix(tex["width"]),
                        height=ix(tex["height"]))

    m = tree["materials"]
    materials = Materials(
        color=fl(m["color"]), specular=fl(m["specular"]),
        reflection=fl(m["reflection"]), ior=fl(m["ior"]),
        transparency=fl(m["transparency"]),
        emission=fl(m["emission"]),
        **{f"texture_{k}": ix(m[f"texture_{k}"]) for k in TEXTURE_SLOTS},
        procedural=ix(m["procedural"]),
        procedural_scale=fl(m["procedural_scale"]),
    )
    s = tree["spheres"]
    spheres = Spheres(center=fl(s["center"]), radius=fl(s["radius"]),
                      material=ix(s["material"]))
    tr = tree["triangles"]
    triangles = Triangles(**{k: fl(tr[k]) for k in (
        "v0", "v1", "v2", "n0", "n1", "n2", "uv0", "uv1", "uv2")},
        material=ix(tr["material"]))
    c = tree["cylinders"]
    cylinders = Cylinders(p0=fl(c["p0"]), p1=fl(c["p1"]),
                          radius=fl(c["radius"]),
                          material=ix(c["material"]))
    e = tree["ellipsoids"]
    ellipsoids = Ellipsoids(center=fl(e["center"]),
                            radii=fl(e["radii"]),
                            material=ix(e["material"]))
    pl = tree["planes"]
    planes = Planes(axis=ix(pl["axis"]),
                    origin=fl(pl["origin"]),
                    half_extents=fl(pl["half_extents"]),
                    material=ix(pl["material"]))
    li = tree["lights"]
    lights = Lights(position=fl(li["position"]),
                    color=fl(li["color"]), radius=fl(li["radius"]))
    info = SceneInfo(**{k: fl(v) for k, v in tree["info"].items()})

    def accel(key):
        a = tree.get(key)
        if a is None:
            return None
        return TriAccel(packed=fl(a["packed"]),
                        block_bounds=fl(a["block_bounds"]),
                        block=int(a["block"]))

    def bvh(key):
        b = tree.get(key)
        if b is None:
            return None
        return BVH(**{k: ix(v) if np.issubdtype(np.asarray(v).dtype,
                                                 np.integer) else fl(v)
                      for k, v in b.items()
                      if k not in ("max_depth", "leaf_size")},
                   max_depth=int(b["max_depth"]),
                   leaf_size=int(b["leaf_size"]))

    return Scene(spheres=spheres, triangles=triangles, cylinders=cylinders,
                 ellipsoids=ellipsoids, planes=planes, materials=materials,
                 lights=lights, textures=textures, info=info,
                 tri_bvh=bvh("tri_bvh"), sph_bvh=bvh("sph_bvh"),
                 cyl_bvh=bvh("cyl_bvh"), tri_accel=accel("tri_accel"),
                 sph_accel=accel("sph_accel"), cyl_accel=accel("cyl_accel"))


def camera_from_numpy(tree: dict, device, dtype=torch.float32) -> Camera:
    """Camera from the reference's Camera flattened to numpy."""
    return Camera(**{k: _t(v, device, dtype) for k, v in tree.items()})


def config_from_reference_fields(fields: dict) -> RenderConfig:
    """RenderConfig from the reference RenderConfig's fields (a dict, as
    ``dataclasses.asdict`` gives it).  ``ray_block`` and ``backend`` are
    never read by the reference and are dropped."""
    fields = dict(fields)
    for name in ("ray_block", "backend"):
        fields.pop(name, None)
    postfx = fields.pop("postfx", None)
    if postfx is not None:
        if not isinstance(postfx, dict):
            postfx = {"mode": postfx.mode, "samples": postfx.samples}
        fields["postfx"] = PostFxConfig(mode=PostFxMode(int(postfx["mode"])),
                                        samples=int(postfx["samples"]))
    fields["camera_mode"] = CameraMode(int(fields.get("camera_mode", 0)))
    return RenderConfig(**fields)

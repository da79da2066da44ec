"""Carry the reference package's state across: turn a ``solr_tpu``
Scene, Camera or RenderConfig, flattened to nested dicts of numpy
arrays, into this package's objects leaf by leaf.

The caller flattens (a dataclass becomes a dict of its fields, an array
becomes a numpy array); this module takes numpy only and imports no JAX.
Parts of the reference the port does not have yet raise
``NotImplementedError`` when they are not empty.
"""

from __future__ import annotations

import numpy as np
import torch

from solr_tpu_torch.types import (Camera, CameraMode, Lights, Materials,
                                  RenderConfig, Scene, SceneInfo, Spheres,
                                  Textures, Triangles, TriAccel)

__all__ = ["scene_from_numpy", "camera_from_numpy",
           "config_from_reference_fields"]


def _t(x, device, dtype=None):
    a = np.asarray(x)
    if dtype is None:
        dtype = torch.int32 if np.issubdtype(a.dtype, np.integer) else torch.float32
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def _empty(tree, key) -> bool:
    pool = tree.get(key)
    if pool is None:
        return True
    first = next(iter(pool.values()))
    return np.asarray(first).shape[0] == 0


def scene_from_numpy(tree: dict, device) -> Scene:
    """Build a Scene from the reference's Scene flattened to numpy.

    ``tree`` has the reference's field names: spheres, triangles,
    materials, lights, textures, info, tri_accel (or None), and the
    cylinders/ellipsoids/planes pools, which must be empty.  The BVH
    node arrays are ignored: the packet path needs only the accelerator.
    """
    dev = torch.device(device)
    for key in ("cylinders", "ellipsoids", "planes"):
        if not _empty(tree, key):
            raise NotImplementedError(f"the {key} pool is not ported")
    if not _empty(tree, "textures") and np.asarray(
            tree["textures"]["offset"]).shape[0] > 0:
        raise NotImplementedError("textures are not ported")
    for key in ("sph_accel", "cyl_accel"):
        if tree.get(key) is not None:
            raise NotImplementedError(f"{key}: sphere and cylinder sweeps "
                                      "are not ported")

    m = tree["materials"]
    materials = Materials(
        color=_t(m["color"], dev), specular=_t(m["specular"], dev),
        reflection=_t(m["reflection"], dev), ior=_t(m["ior"], dev),
        transparency=_t(m["transparency"], dev),
        emission=_t(m["emission"], dev),
        procedural=_t(m["procedural"], dev, torch.int32),
        procedural_scale=_t(m["procedural_scale"], dev),
    )
    s = tree["spheres"]
    spheres = Spheres(center=_t(s["center"], dev), radius=_t(s["radius"], dev),
                      material=_t(s["material"], dev, torch.int32))
    tr = tree["triangles"]
    triangles = Triangles(**{k: _t(tr[k], dev) for k in (
        "v0", "v1", "v2", "n0", "n1", "n2", "uv0", "uv1", "uv2")},
        material=_t(tr["material"], dev, torch.int32))
    li = tree["lights"]
    lights = Lights(position=_t(li["position"], dev),
                    color=_t(li["color"], dev), radius=_t(li["radius"], dev))
    info = SceneInfo(**{k: _t(v, dev) for k, v in tree["info"].items()})
    accel = None
    if tree.get("tri_accel") is not None:
        a = tree["tri_accel"]
        accel = TriAccel(packed=_t(a["packed"], dev),
                         block_bounds=_t(a["block_bounds"], dev),
                         block=int(a["block"]))
    return Scene(spheres=spheres, triangles=triangles, materials=materials,
                 lights=lights, textures=Textures(), info=info,
                 tri_accel=accel)


def camera_from_numpy(tree: dict, device) -> Camera:
    """Camera from the reference's Camera flattened to numpy."""
    return Camera(**{k: _t(v, device, torch.float32) for k, v in tree.items()})


# Reference RenderConfig fields the port does not have, with the only
# value it supports for each.
_UNPORTED_DEFAULTS = {
    "sky_texture": -1,
    "fog": False,
    "antialias_jitter": False,
    "use_bvh": True,
}


def config_from_reference_fields(fields: dict) -> RenderConfig:
    """RenderConfig from the reference RenderConfig's fields (a dict, as
    ``dataclasses.asdict`` gives it).  Fields the port does not have must
    hold their default; ``ray_block`` and ``backend`` are never read by
    the reference and are dropped."""
    fields = dict(fields)
    for name in ("ray_block", "backend"):
        fields.pop(name, None)
    postfx = fields.pop("postfx", None)
    if postfx is not None:
        mode = postfx["mode"] if isinstance(postfx, dict) else postfx.mode
        if int(mode) != 0:
            raise NotImplementedError("post-processing is not ported")
    for name, default in _UNPORTED_DEFAULTS.items():
        if name in fields and fields.pop(name) != default:
            raise NotImplementedError(f"RenderConfig.{name} is not ported")
    # The packet path is the port's only triangle traversal.
    traversal = fields.pop("traversal", "auto")
    if traversal not in ("auto", "packet"):
        raise NotImplementedError(f"traversal={traversal!r} is not ported")
    fields["camera_mode"] = CameraMode(int(fields.get("camera_mode", 0)))
    return RenderConfig(**fields)

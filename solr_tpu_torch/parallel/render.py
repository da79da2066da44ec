"""Row-sharded forward rendering over a mesh of ranks (counterpart of
solr_tpu/parallel/render.py).

The reference shards the pixel grid over a ``jax.sharding.Mesh`` from
one controller.  Here every rank of the mesh calls the same function:
rank i traces the i-th of N equal runs of the row-major pixel grid (row
band i when N divides the height) through the same tiled packet path as
the one-device renderer, folds i into the key, and all-gathers colour
and depth, so every rank returns the whole frame.  The scene is
replicated: one rank builds it and :func:`broadcast_scene` sends it to
the others.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import torch
import torch.distributed as dist

from solr_tpu_torch import types as T
from solr_tpu_torch.ops.camera import _make_rays, _ndc, pixel_grid, \
    rays_from_pixels
from solr_tpu_torch.ops.render import trace_rays, trace_rays_tiled
from solr_tpu_torch.parallel import collectives as C
from solr_tpu_torch.parallel.mesh import (linear_index, make_mesh,
                                          mesh_size)
from solr_tpu_torch.types import Camera, CameraMode, RenderConfig, Scene

__all__ = ["shard_render", "broadcast_scene", "default_mesh", "band"]


def default_mesh(device):
    """The mesh of every rank when a process group is up, else the
    one-process mesh (None)."""
    if dist.is_available() and dist.is_initialized():
        return make_mesh(device_type=torch.device(device).type)
    return None


def band(mesh, n_items: int, what: str = "pixels"):
    """(linear index i, slice of the i-th of N equal runs of
    ``n_items``).  Raises ValueError, before any collective, when N does
    not divide ``n_items`` or this rank is not in the mesh."""
    n = mesh_size(mesh)
    if n_items % n:
        raise ValueError(f"{n_items} {what} not divisible by {n} devices")
    i = linear_index(mesh)
    if i is None:
        raise ValueError("this rank is not in the mesh")
    per = n_items // n
    return i, slice(i * per, (i + 1) * per)


def _anaglyph_eye(scene, camera, cfg, pix, eye, key):
    """One eye's rays for this rank's pixels, as the reference's
    sharded anaglyph makes them (render.py:111-134): no antialiasing
    jitter, the key (already folded) drives the lens, no packets."""
    n = pix.shape[0]
    u, v = _ndc(pix, cfg, torch.zeros((n, 2), dtype=pix.dtype,
                                      device=pix.device))
    o, d = _make_rays(camera, u, v, torch.full((n, 1), eye, dtype=pix.dtype,
                                               device=pix.device), key)
    return trace_rays(scene, o, d, cfg, key)


def shard_render(scene: Scene, camera: Camera, cfg: RenderConfig, mesh=None,
                 key=None):
    """(image (H, W, 4), depth (H, W)) with the pixel grid sharded over
    the mesh (every rank by default); every rank of the mesh calls it
    and gets the whole frame.

    Needs ``cfg.n_pixels`` divisible by the mesh size (ValueError on
    every rank otherwise, before any collective).  Rank i folds i into
    ``key``.  ANAGLYPH splits the key per eye first and traces each eye
    without packets, as the reference does.
    """
    if mesh is None:
        mesh = default_mesh(scene.device)
    i, mine = band(mesh, cfg.n_pixels)
    dtype = scene.info.background_color.dtype
    pix = pixel_grid(cfg, scene.device, dtype)[mine]

    if cfg.camera_mode == CameraMode.ANAGLYPH:
        kl, kr = ((None, None) if key is None
                  else (k.fold_in(i) for k in key.split(2)))
        cl, t = _anaglyph_eye(scene, camera, cfg, pix, -1.0, kl)
        cr, _ = _anaglyph_eye(scene, camera, cfg, pix, 1.0, kr)
        color = torch.stack([cl[..., 0], cr[..., 1], cr[..., 2],
                             torch.ones_like(cl[..., 0])], -1)
    else:
        key = None if key is None else key.fold_in(i)
        o, d = rays_from_pixels(camera, cfg, pix, key)
        color, t = trace_rays_tiled(scene, o, d, cfg, key)
    both = C.all_gather(torch.cat([color, t[:, None]], -1), mesh)
    return (both[:, :4].reshape(cfg.height, cfg.width, 4),
            both[:, 4].reshape(cfg.height, cfg.width))


# ---------------------------------------------------------------------------
# Scene replication
# ---------------------------------------------------------------------------

_TYPES = {name: getattr(T, name) for name in T.__all__
          if dataclasses.is_dataclass(getattr(T, name))}


def _skeleton(obj, tensors):
    """JSON-able structure of a tree of the types' dataclasses, its
    tensors replaced by their shape and dtype (appended to
    ``tensors``)."""
    if isinstance(obj, torch.Tensor):
        tensors.append(obj)
        return {"tensor": list(obj.shape), "dtype": str(obj.dtype)[6:]}
    if dataclasses.is_dataclass(obj):
        name = type(obj).__name__
        if _TYPES.get(name) is not type(obj):
            raise TypeError(f"cannot broadcast a {name}")
        return {"type": name, "fields": {
            f.name: _skeleton(getattr(obj, f.name), tensors)
            for f in dataclasses.fields(obj)}}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"cannot broadcast a {type(obj).__name__}")


def _build(skel, tensors, device):
    if isinstance(skel, dict) and "tensor" in skel:
        t = torch.empty(skel["tensor"], dtype=getattr(torch, skel["dtype"]),
                        device=device)
        tensors.append(t)
        return t
    if isinstance(skel, dict):
        return _TYPES[skel["type"]](**{k: _build(v, tensors, device)
                                       for k, v in skel["fields"].items()})
    return skel


def broadcast_scene(scene: Optional[Scene], src: int = 0, mesh=None,
                    device="cuda"):
    """``scene`` as rank ``src`` of the mesh holds it, on every rank of
    the mesh: the reference replicates the scene over its mesh; here
    rank ``src`` (a linear index) sends its structure, then every
    tensor.  The other ranks pass None (or a scene, which is replaced)
    and receive on ``device``.  Works for any tree of the types'
    dataclasses (a Camera too).  A one-rank mesh returns ``scene``."""
    tensors = []
    skeleton = None if scene is None else _skeleton(scene, tensors)
    if mesh is None:
        mesh = default_mesh(tensors[0].device if tensors else device)
    if mesh_size(mesh) == 1:
        return scene
    if linear_index(mesh) == src:
        text = json.dumps(skeleton).encode()
        device = tensors[0].device
        C.broadcast(torch.tensor([len(text)], device=device), src, mesh)
        C.broadcast(torch.tensor(list(text), dtype=torch.uint8,
                                 device=device), src, mesh)
    else:
        n = C.broadcast(torch.zeros(1, dtype=torch.int64, device=device),
                        src, mesh)
        raw = C.broadcast(torch.empty(int(n), dtype=torch.uint8,
                                      device=device), src, mesh)
        tensors = []
        scene = _build(json.loads(raw.cpu().numpy().tobytes()), tensors,
                       device)
    for t in tensors:
        C.broadcast(t, src, mesh)
    return scene

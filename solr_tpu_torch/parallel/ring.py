"""Geometry-sharded ring traversal (counterpart of
solr_tpu/parallel/ring.py): the renderer's sequence-parallel axis.

For a triangle pool too large to replicate, each rank keeps 1/N of it
and its band of the rays; the triangle shards rotate around the ring N
times (``batch_isend_irecv``, the reference's ``ppermute``) while the
rays stay put, as ring attention rotates keys past stationary queries.
After the last step every rank has folded the closest hit of its rays
against every shard.  Each shard is intersected by brute force
(``ops.intersect.triangle_t``), as in the reference: the mode exists
for capacity, not speed; the replicated tile-sharded path
(``parallel.render``) is the fast one whenever the scene fits.

Numerical contract: equal to one brute-force sweep of the whole pool,
hit ids bit for bit (a tie between shards goes to the shard the rank
met first, as the reference's strict ``<`` does).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from solr_tpu_torch.constants import RAY_EPS, T_FAR
from solr_tpu_torch.ops import intersect as isect
from solr_tpu_torch.parallel import collectives as C
from solr_tpu_torch.parallel.mesh import mesh_size
from solr_tpu_torch.parallel.render import band, default_mesh

__all__ = ["ring_closest_hit", "shard_triangles"]

# Largest (rays x triangles) block of t values computed at once.
_BLOCK_ELEMS = 1 << 22


def shard_triangles(triangles, n_dev: int):
    """(v0, v1, v2), each padded with degenerate (all-zero, never hit)
    triangles to a multiple of ``n_dev`` rows, ready to split into
    ``n_dev`` contiguous shards."""
    pad = (-triangles.v0.shape[0]) % n_dev
    return tuple(F.pad(v, (0, 0, 0, pad)) if pad else v
                 for v in (triangles.v0, triangles.v1, triangles.v2))


def _closest(o, d, v0, v1, v2, t_min):
    """(t, index within the shard) of the closest hit of each ray, the
    rays taken in blocks so that one block's t matrix stays bounded."""
    rows = max(1, _BLOCK_ELEMS // max(1, v0.shape[0]))
    ts, ids = [], []
    for s in range(0, o.shape[0], rows):
        t = isect.triangle_t(o[s:s + rows], d[s:s + rows], v0, v1, v2, t_min)
        tmin, arg = t.min(-1)
        ts.append(tmin)
        ids.append(arg)
    return torch.cat(ts), torch.cat(ids)


@torch.no_grad()
def ring_closest_hit(scene, o, d, mesh=None, t_min=RAY_EPS):
    """Closest triangle hit with the triangle pool sharded over the mesh.

    ``o``, ``d``: the (R, 3) rays, the same on every rank; rank i keeps
    the i-th of N bands of them and the i-th of N shards of the pool.
    Returns (t (R,), triangle index (R,) int32) on every rank, with
    global indices, equal to a brute-force sweep of the whole pool
    (t = T_FAR, index -1 where nothing is hit).
    """
    if mesh is None:
        mesh = default_mesh(o.device)
    n = mesh_size(mesh)
    i, mine = band(mesh, o.shape[0], "rays")
    shards = torch.stack(shard_triangles(scene.triangles, n))
    shard_n = shards.shape[1] // n
    held = shards[:, i * shard_n:(i + 1) * shard_n].contiguous()
    o, d = o[mine], d[mine]
    best_t = torch.full(o.shape[:1], T_FAR, dtype=o.dtype, device=o.device)
    best_i = torch.full(o.shape[:1], -1, dtype=torch.int32, device=o.device)
    for k in range(n):
        owner = (i + k) % n  # the shard held now started at rank i + k
        t, arg = _closest(o, d, held[0], held[1], held[2], t_min)
        better = t < best_t
        best_t = torch.where(better, t, best_t)
        best_i = torch.where(better, (owner * shard_n + arg).to(torch.int32),
                             best_i)
        if k + 1 < n:
            held = C.ring_shift(held, mesh)
    return C.all_gather(best_t, mesh), C.all_gather(best_i, mesh)

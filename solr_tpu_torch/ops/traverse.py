"""Scene-level closest-hit and shadow queries (counterpart of
solr_tpu/ops/traverse.py).

The scene is split into typed pools: spheres, triangles, capped
cylinders, ellipsoids and planes, visited in that code order (the strict
``<`` across pools makes the earlier pool win a tie).  Each pool takes
one of three paths, as in the reference (traverse.py:290-313 for the
closest hit, :790-812 for shadows):

* the packet path, where the pool has a BVH and its packet accelerator
  and the rays come in whole tiles: per-strip interval selection
  (:mod:`solr_tpu_torch.ops.packet`), the sweep kernels of its primitive
  kind (:mod:`solr_tpu_torch.ops.sweep`) and the union-block exactness
  net for the rays whose drop certificate fails;
* else the per-ray BVH walk (:mod:`solr_tpu_torch.ops.bvh`), where the
  pool has a BVH;
* else brute force over the whole pool (small pools, ellipsoids and
  planes).

Two phases, as in the reference: traversal runs detached under
``torch.no_grad``, then the hit ``t`` of the selected primitive is
recomputed analytically with autograd, so gradients reach rays and
geometry at fixed topology.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from solr_tpu_torch.constants import (PARK_THRESHOLD, POOL_CYLINDER,
                                      POOL_ELLIPSOID, POOL_PLANE, POOL_SPHERE,
                                      POOL_TRIANGLE, RAY_EPS, T_FAR)
from solr_tpu_torch.ops import bvh as bvh_mod
from solr_tpu_torch.ops import intersect as isect
from solr_tpu_torch.ops import packet as pk
from solr_tpu_torch.ops import sweep
from solr_tpu_torch.ops.textures import apply_normal_maps
from solr_tpu_torch.ops.vecmath import cross, dot, normalize, spherical_uv
from solr_tpu_torch.types import Scene

__all__ = ["Hit", "SurfaceInfo", "POOL_SPHERE", "POOL_TRIANGLE",
           "POOL_CYLINDER", "POOL_ELLIPSOID", "POOL_PLANE", "BRUTE_CALLS",
           "scene_closest_hit", "scene_transmittance", "surface_at"]

# The sweep kernels' primitive kind of each accelerated pool.
_POOL_PRIM = {POOL_SPHERE: "sphere", POOL_TRIANGLE: "tri",
              POOL_CYLINDER: "cyl"}
_PRIM_POOL = {p: c for c, p in _POOL_PRIM.items()}
_POOL_NAME = {**_POOL_PRIM, POOL_ELLIPSOID: "ellipsoid",
              POOL_PLANE: "plane"}

# Brute-force sweeps over a whole pool since the caller last zeroed
# these, closest-hit and shadow together, by pool.
BRUTE_CALLS = {name: 0 for name in _POOL_NAME.values()}

# Brute-force sweeps take the primitives in chunks of at least
# _PRIM_CHUNK, and of as many more as keep the (rays x chunk) matrices
# near _CHUNK_ELEMS elements: one eager op per chunk and step, so few
# large chunks, not the reference's fixed 512 (a TPU VMEM size).
_PRIM_CHUNK = 512
_CHUNK_ELEMS = 1 << 24


def _prim_chunk(n_rays: int, n: int) -> int:
    return min(n, max(_PRIM_CHUNK, _CHUNK_ELEMS // max(n_rays, 1)))


# Union-net candidate width: a chunk whose block union is wider falls
# back to the full pool brute, so exactness never depends on it.
_NET_UCAP = 512

# What the exactness net did since the caller last zeroed these: net
# calls, needy rays, chunks, the chunks' union widths in blocks, and the
# chunks whose union overflowed into the whole-pool brute force.
NET_STATS = {"calls": 0, "needy_rays": 0, "chunks": 0, "union_blocks": 0,
             "overflows": 0}


@dataclasses.dataclass(frozen=True)
class Hit:
    t: Any  # (R,) distance, T_FAR on a miss
    pool: Any  # (R,) int32 pool code, -1 on a miss
    idx: Any  # (R,) int32 index within the pool

    @property
    def valid(self):
        return self.t < T_FAR * 0.5


@dataclasses.dataclass(frozen=True)
class SurfaceInfo:
    point: Any  # (R, 3)
    normal: Any  # (R, 3) geometric normal, opposing the ray
    shading_normal: Any  # (R, 3) interpolated normal, opposing the ray
    uv: Any  # (R, 2)
    material: Any  # (R,) int64
    backface: Any  # (R,) bool
    valid: Any  # (R,) bool


def _pool_sizes(scene: Scene):
    return {POOL_SPHERE: scene.spheres.radius.shape[0],
            POOL_TRIANGLE: scene.triangles.v0.shape[0],
            POOL_CYLINDER: scene.cylinders.radius.shape[0],
            POOL_ELLIPSOID: scene.ellipsoids.center.shape[0],
            POOL_PLANE: scene.planes.axis.shape[0]}


def _pool(scene: Scene, code: int):
    return {POOL_SPHERE: scene.spheres, POOL_TRIANGLE: scene.triangles,
            POOL_CYLINDER: scene.cylinders, POOL_ELLIPSOID: scene.ellipsoids,
            POOL_PLANE: scene.planes}[code]


def _pool_accel(scene: Scene, code: int):
    return {POOL_SPHERE: scene.sph_accel, POOL_TRIANGLE: scene.tri_accel,
            POOL_CYLINDER: scene.cyl_accel}.get(code)


def _pool_bvh(scene: Scene, code: int, use_bvh: bool):
    if not use_bvh:
        return None
    return {POOL_SPHERE: scene.sph_bvh, POOL_TRIANGLE: scene.tri_bvh,
            POOL_CYLINDER: scene.cyl_bvh}.get(code)


def _chunked_min(t_fn, n: int, r_shape, like):
    """Fold (best_t, best_idx) over primitive chunks.  The last partial
    chunk's start clamps to n - chunk; re-testing the overlap is
    idempotent under min and the clamped start is the index base.  The
    first minimum wins within a chunk and a later chunk only on a strict
    <, so the result does not depend on the chunk size."""
    chunk = _prim_chunk(like[..., 0].numel(), n)
    best_t = torch.full(r_shape, T_FAR, dtype=like.dtype, device=like.device)
    best_i = torch.zeros(r_shape, dtype=torch.int32, device=like.device)
    for ci in range((n + chunk - 1) // chunk):
        start = min(ci * chunk, n - chunk)
        c_min, c_arg = t_fn(start, chunk).min(-1)
        better = c_min < best_t
        best_t = torch.where(better, c_min, best_t)
        best_i = torch.where(better, (c_arg + start).to(torch.int32), best_i)
    return best_t, best_i


def _pool_t_chunk(scene: Scene, code: int, o, d, start, chunk, t_min):
    rows = slice(start, start + chunk)
    if code == POOL_SPHERE:
        p = scene.spheres
        return isect.sphere_t(o, d, p.center[rows], p.radius[rows], t_min)
    if code == POOL_CYLINDER:
        p = scene.cylinders
        return isect.cylinder_t(o, d, p.p0[rows], p.p1[rows], p.radius[rows],
                                t_min)
    if code == POOL_ELLIPSOID:
        p = scene.ellipsoids
        return isect.ellipsoid_t(o, d, p.center[rows], p.radii[rows], t_min)
    if code == POOL_PLANE:
        p = scene.planes
        return isect.plane_t(o, d, p.axis[rows], p.origin[rows],
                             p.half_extents[rows], t_min)
    p = scene.triangles
    return isect.triangle_t(o, d, p.v0[rows], p.v1[rows], p.v2[rows], t_min)


def _pool_material(scene: Scene, code: int, idx):
    return _pool(scene, code).material[idx].long()


def _pool_closest(o, d, scene: Scene, code: int, t_min, t_max):
    """Brute-force closest hit within one pool: (best_t, best_idx)."""
    n = _pool_sizes(scene)[code]
    r_shape = o.shape[:-1]
    if n == 0:
        return (torch.full(r_shape, T_FAR, dtype=o.dtype, device=o.device),
                torch.zeros(r_shape, dtype=torch.int32, device=o.device))
    BRUTE_CALLS[_POOL_NAME[code]] += 1
    best_t, best_i = _chunked_min(
        lambda s, c: _pool_t_chunk(scene, code, o, d, s, c, t_min),
        n, r_shape, o)
    far = torch.full_like(best_t, T_FAR)
    return torch.where(best_t <= t_max, best_t, far), best_i


def scene_closest_hit(scene: Scene, o, d, t_min=RAY_EPS, t_max=T_FAR,
                      use_bvh: bool = True, packet=None) -> Hit:
    """Closest hit across every pool.  ``use_bvh`` lets accelerated
    pools use their BVHs; ``packet`` = (tile_rays, K, Kt, exact) when the
    rays come in tile-coherent groups of tile_rays."""
    with torch.no_grad():
        raw = _scene_closest_hit_raw(scene, o.detach(), d.detach(), t_min,
                                     t_max, use_bvh, packet)
    t = _recompute_t(scene, o, d, raw.pool, raw.idx, t_min)
    # Keep the traversal t on a miss and on rare recompute disagreements
    # (f32 tangency); the two agree whenever both hit.
    t = torch.where(raw.valid & (t < T_FAR * 0.5), t, raw.t)
    return Hit(t=t, pool=raw.pool, idx=raw.idx)


def _recompute_t(scene: Scene, o, d, pool, idx, t_min):
    """Differentiable hit distance for the already-selected primitive."""
    sizes = _pool_sizes(scene)
    t = torch.full(o.shape[:-1], T_FAR, dtype=o.dtype, device=o.device)
    if sizes[POOL_SPHERE]:
        p = scene.spheres
        i = idx.clamp(0, sizes[POOL_SPHERE] - 1).long()
        t = torch.where(pool == POOL_SPHERE, isect.sphere_t_p(
            o, d, p.center[i], p.radius[i], t_min), t)
    if sizes[POOL_TRIANGLE]:
        p = scene.triangles
        i = idx.clamp(0, sizes[POOL_TRIANGLE] - 1).long()
        t = torch.where(pool == POOL_TRIANGLE, isect.triangle_t_p(
            o, d, p.v0[i], p.v1[i], p.v2[i], t_min), t)
    if sizes[POOL_CYLINDER]:
        p = scene.cylinders
        i = idx.clamp(0, sizes[POOL_CYLINDER] - 1).long()
        t = torch.where(pool == POOL_CYLINDER, isect.cylinder_t_p(
            o, d, p.p0[i], p.p1[i], p.radius[i], t_min), t)
    if sizes[POOL_ELLIPSOID]:
        p = scene.ellipsoids
        i = idx.clamp(0, sizes[POOL_ELLIPSOID] - 1).long()
        t = torch.where(pool == POOL_ELLIPSOID, isect.ellipsoid_t_p(
            o, d, p.center[i], p.radii[i], t_min), t)
    if sizes[POOL_PLANE]:
        p = scene.planes
        i = idx.clamp(0, sizes[POOL_PLANE] - 1).long()
        t = torch.where(pool == POOL_PLANE, isect.plane_t_p(
            o, d, p.axis[i], p.origin[i], p.half_extents[i], t_min), t)
    return t


def _packet_ok(scene: Scene, code: int, o, packet, bvh) -> bool:
    """Whether the pool takes the packet path, as in the reference: it
    has a BVH (``bvh``, None without one or without use_bvh) and its
    packet accelerator, and the rays come in whole tiles.  (The
    reference derives a missing triangle accelerator on the fly; the
    port's builder and converter always carry one with the BVH.)"""
    return (bvh is not None and packet is not None
            and _pool_accel(scene, code) is not None
            and o.shape[0] % packet[0] == 0)


def _scene_closest_hit_raw(scene: Scene, o, d, t_min, t_max, use_bvh,
                           packet) -> Hit:
    r_shape = o.shape[:-1]
    best_t = torch.full(r_shape, T_FAR, dtype=o.dtype, device=o.device)
    best_pool = torch.full(r_shape, -1, dtype=torch.int32, device=o.device)
    best_idx = torch.zeros(r_shape, dtype=torch.int32, device=o.device)
    for code, size in _pool_sizes(scene).items():
        if size == 0:
            continue
        bvh = _pool_bvh(scene, code, use_bvh)
        if _packet_ok(scene, code, o, packet, bvh) and o.dim() == 2:
            t, i = _tri_packet_closest(scene, o, d, t_min, packet,
                                       _POOL_PRIM[code])
        elif bvh is not None:
            t, i = bvh_mod.bvh_closest_hit(scene, bvh, code, o, d, t_min,
                                           t_max)
        else:
            t, i = _pool_closest(o, d, scene, code, t_min, t_max)
        better = t < best_t
        best_t = torch.where(better, t, best_t)
        best_pool = torch.where(better, torch.full_like(best_pool, code),
                                best_pool)
        best_idx = torch.where(better, i, best_idx)
    return Hit(t=best_t, pool=best_pool, idx=best_idx)


def _scene_box(accel):
    """Scene AABB from the real (non-padding) block bounds."""
    bb = accel.block_bounds
    real = (bb[:, 0] < 1e29)[:, None]
    lo, hi = bb[:, 0:3] - bb[:, 3:6], bb[:, 0:3] + bb[:, 3:6]
    bmin = torch.where(real, lo, torch.full_like(lo, float("inf"))).amin(0)
    bmax = torch.where(real, hi, torch.full_like(hi, float("-inf"))).amax(0)
    return bmin, bmax


def _net_capacity(r: int) -> int:
    """Compacted exactness-net chunk size: lane-aligned, capped at 2048
    rays so the per-chunk (rays x blocks) slab matrices stay small."""
    return min(r, max(512, min(2048, -(-r // 64 // 128) * 128)))


def _ray_block_slabs(o, d, block_bounds, t_min):
    """Per-(ray, block) slab test: (entry (R, B), hit (R, B)); entry is
    clamped to 0, a lower bound on any hit t inside the block."""
    entry, hit = pk.slab_entries_g(o[None], d[None], block_bounds[None], t_min)
    return entry[0], hit[0]


def _union_candidates(hitm, n_blocks):
    """The chunk's union of hit blocks as an ascending id list, and
    whether it overflows the net's width."""
    union = hitm.any(0)
    width = int(union.sum())
    overflow = width > min(_NET_UCAP, n_blocks)
    NET_STATS["chunks"] += 1
    NET_STATS["union_blocks"] += width
    NET_STATS["overflows"] += int(overflow)
    return union.nonzero().squeeze(1).to(torch.int32), overflow


def _windowed_sweep(o_c, d_c, cand, accel, t_min, prim, tm_c=None):
    """Sweep one chunk of needy rays over its union candidate list with
    the block mirrors (the reference runs the same fold in 64-wide
    windows under lax.cond; here the list is already exactly as long as
    it needs to be)."""
    counts = torch.full((1,), cand.shape[0], dtype=torch.int32,
                        device=o_c.device)
    if tm_c is None:
        t, i = pk.tri_blocks_closest(accel.packed, o_c[None], d_c[None],
                                     cand[None], counts, t_min, prim)
        return t[0], i[0]
    return pk.tri_blocks_transmittance(accel.packed, o_c[None], d_c[None],
                                       tm_c[None], cand[None], counts,
                                       t_min, prim)[0]


def _block_net_closest(scene, accel, code, o_c, d_c, t_best, t_min):
    """Exact closest hit for one chunk of needy rays: sweep only the
    union of the blocks the rays' slabs enter before their current best
    (blocks partition the pool), or brute-force the pool when the union
    overflows."""
    entry, hitm = _ray_block_slabs(o_c, d_c, accel.block_bounds, t_min)
    hitm = hitm & (entry <= t_best[:, None])
    cand, overflow = _union_candidates(hitm, accel.packed.shape[0])
    if overflow:
        return _pool_closest(o_c, d_c, scene, code, t_min, t_best)
    return _windowed_sweep(o_c, d_c, cand, accel, t_min, _POOL_PRIM[code])


def _block_net_transmittance(scene, accel, code, o_c, d_c, tm_c, t_min):
    """Exact shadow transmittance for one chunk of needy rays (see
    :func:`_block_net_closest`); occluders live only in blocks whose slab
    interval starts before the light."""
    entry, hitm = _ray_block_slabs(o_c, d_c, accel.block_bounds, t_min)
    hitm = hitm & (entry <= tm_c[:, None])
    cand, overflow = _union_candidates(hitm, accel.packed.shape[0])
    if overflow:
        return _pool_transmittance_brute(scene, code, o_c, d_c, tm_c, t_min)
    return _windowed_sweep(o_c, d_c, cand, accel, t_min, _POOL_PRIM[code],
                           tm_c)


def _spatial_keys(p, bmin, bmax):
    """Coarse Morton key (64 cells per axis) of positions p (R, 3) in the
    box; sorts needy rays into spatially tight net chunks."""
    span = torch.clamp(bmax - bmin, min=1e-6)
    q = torch.clamp((p - bmin) / span * 64.0, 0.0, 63.0).to(torch.int32)

    def spread(x):  # interleave 6 bits -> every 3rd bit
        x = (x | (x << 8)) & 0x0300F
        x = (x | (x << 4)) & 0x030C3
        x = (x | (x << 2)) & 0x09249
        return x

    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


def _compacted_net(need, carry, walk_chunk, sort_key=None):
    """Run the exactness net over only the rays in ``need`` (R,), in
    chunks of :func:`_net_capacity` rays, sorted by ``sort_key`` so each
    chunk is spatially tight.  ``walk_chunk(idx, carry)`` updates the
    carry for the rays ``idx``.

    Counting ``need`` is a host sync; it replaces the reference's
    ``lax.cond``."""
    n_need = int(need.sum())
    NET_STATS["calls"] += 1
    NET_STATS["needy_rays"] += n_need
    if n_need == 0:
        return carry
    cap = _net_capacity(need.shape[0])
    idx_all = need.nonzero().squeeze(1)
    if sort_key is not None:
        order = torch.argsort(sort_key[idx_all].to(torch.float32), stable=True)
        idx_all = idx_all[order]
    for c0 in range(0, idx_all.shape[0], cap):
        carry = walk_chunk(idx_all[c0:c0 + cap], carry)
    return carry


def _tri_packet_closest(scene: Scene, o, d, t_min, packet, prim="tri"):
    """Packet closest hit over the pool of kind ``prim``: strip interval
    lists -> front-to-back sweep -> exactness net for rays whose drop
    certificate fails."""
    tile_rays, ks, kt, exact = packet
    r = o.shape[0]
    code = _PRIM_POOL[prim]
    accel = _pool_accel(scene, code)
    o_t = o.reshape(-1, tile_rays, 3)
    d_t = d.reshape(-1, tile_rays, 3)
    live = o_t[..., 0] < PARK_THRESHOLD
    cand, counts, nearb, dropped = pk.strip_interval_select(
        o_t, d_t, live, accel, kt, ks, t_min)
    # Per-ray scene-box exit: an upper bound on any possible hit, so
    # miss rays neither stall the early-out nor trip the net.
    bmin, bmax = _scene_box(accel)
    t_cap = pk.ray_box_exit(o_t, d_t, bmin, bmax)
    bt, bi, _ = sweep.sweep_closest(accel.packed, o_t, d_t, t_cap, live,
                                    cand, counts, nearb, t_min, prim)
    bt, bi = bt.reshape(r), bi.reshape(r)
    if not exact:
        return bt, bi
    need = (live & (torch.minimum(bt.reshape(t_cap.shape), t_cap) > dropped)
            ).reshape(r)
    t_mid = 0.5 * torch.minimum(bt, t_cap.reshape(r))
    net_key = _spatial_keys(o + d * t_mid[:, None], bmin, bmax)

    def walk_chunk(idx, carry):
        bt_c, bi_c = carry
        t2, i2 = _block_net_closest(scene, accel, code, o[idx], d[idx],
                                    bt_c[idx], t_min)
        better = t2 < bt_c[idx]
        bt_c[idx] = torch.where(better, t2, bt_c[idx])
        bi_c[idx] = torch.where(better, i2, bi_c[idx])
        return bt_c, bi_c

    return _compacted_net(need, (bt, bi), walk_chunk, sort_key=net_key)


def scene_transmittance(scene: Scene, o, d, t_max, t_min=RAY_EPS,
                        use_bvh: bool = True, packet=None):
    """Shadow-ray transmittance in [0, 1]: the product over occluding
    primitives of their material transparency (emissive primitives are
    the lights and never occlude).  o/d (R, 3) or (R, L, 3)."""
    trans = torch.ones(o.shape[:-1], dtype=o.dtype, device=o.device)
    for code, size in _pool_sizes(scene).items():
        if size == 0:
            continue
        bvh = _pool_bvh(scene, code, use_bvh)
        if _packet_ok(scene, code, o, packet, bvh):
            # Detached inputs: the accelerated pool's occluder
            # transparency carries no gradient, as in the reference.
            with torch.no_grad():
                trans = trans * _tri_packet_transmittance(
                    scene, o.detach(), d.detach(), t_max.detach(), t_min,
                    packet, _POOL_PRIM[code])
            continue
        if bvh is not None:
            with torch.no_grad():
                trans = trans * bvh_mod.bvh_transmittance(
                    scene, bvh, code, o.detach(), d.detach(), t_min,
                    t_max.detach())
            continue
        trans = trans * _pool_transmittance_brute(scene, code, o, d, t_max,
                                                  t_min)
    return trans


def _tri_packet_transmittance(scene: Scene, o, d, t_max, t_min, packet,
                              prim="tri"):
    """Packet shadow transmittance over the pool of kind ``prim``; lights
    unroll as a Python loop over the (R, L, 3) rays."""
    tile_rays, ks, kt, exact = packet
    code = _PRIM_POOL[prim]
    accel = _pool_accel(scene, code)

    def one_light(o2, d2, tm2):
        o_t = o2.reshape(-1, tile_rays, 3)
        d_t = d2.reshape(-1, tile_rays, 3)
        tm_t = tm2.reshape(-1, tile_rays)
        live = o_t[..., 0] < PARK_THRESHOLD
        cand, counts, _, dropped = pk.strip_interval_select(
            o_t, d_t, live, accel, kt, ks, t_min, tm_t=tm_t)
        tr, _ = sweep.sweep_transmittance(accel.packed, o_t, d_t, tm_t, live,
                                          cand, counts, t_min, prim)
        tr = tr.reshape(-1)
        if not exact:
            return tr
        # A dropped block occludes a ray only if its interval can start
        # before the ray's light distance.
        need = (live & (dropped < torch.clamp(tm_t, max=T_FAR * 0.5))
                ).reshape(-1)
        bmin, bmax = _scene_box(accel)

        def walk_chunk(idx, carry):
            (tr_c,) = carry
            tr_c[idx] = _block_net_transmittance(
                scene, accel, code, o2[idx], d2[idx], tm2[idx], t_min)
            return (tr_c,)

        return _compacted_net(need, (tr,), walk_chunk,
                              sort_key=_spatial_keys(o2, bmin, bmax))[0]

    tm = t_max.expand(o.shape[:-1])
    if o.dim() == 3:
        return torch.stack([one_light(o[:, l], d[:, l], tm[:, l])
                            for l in range(o.shape[1])], 1)
    return one_light(o, d, tm)


def _pool_transmittance_brute(scene: Scene, code: int, o, d, t_max,
                              t_min=RAY_EPS):
    """Brute-force transmittance over one pool, chunk by chunk.  The last
    partial chunk clamps its start and masks the rows already covered, so
    every factor applies exactly once."""
    size = _pool_sizes(scene)[code]
    trans = torch.ones(o.shape[:-1], dtype=o.dtype, device=o.device)
    if size == 0:
        return trans
    BRUTE_CALLS[_POOL_NAME[code]] += 1
    mats = scene.materials
    chunk = _prim_chunk(o[..., 0].numel(), size)
    for ci in range((size + chunk - 1) // chunk):
        start = min(ci * chunk, size - chunk)
        t = _pool_t_chunk(scene, code, o, d, start, chunk, t_min)
        idx = start + torch.arange(chunk, device=o.device)
        occ = (t < t_max[..., None]) & (idx >= ci * chunk)
        mat = _pool_material(scene, code, idx)
        f = torch.where(mats.emission[mat] > 0.0,
                        torch.ones_like(mats.transparency[mat]),
                        mats.transparency[mat])
        trans = trans * torch.where(occ, f, torch.ones_like(t)).prod(-1)
    return trans


def surface_at(scene: Scene, hit: Hit, o, d) -> SurfaceInfo:
    """Point, normals, UV and material at the selected hits.  The
    material's normal and bump maps perturb the shading normal before
    the normals are flipped to oppose the ray, so the flip still holds
    for the perturbed normal."""
    t = torch.where(hit.valid, hit.t, torch.ones_like(hit.t))
    point = o + t[..., None] * d
    r_shape = o.shape[:-1]
    normal = torch.zeros_like(o)
    normal[..., 2] = -1.0
    shading = normal
    uv = torch.zeros(r_shape + (2,), dtype=o.dtype, device=o.device)
    material = torch.zeros(r_shape, dtype=torch.int64, device=o.device)
    sizes = _pool_sizes(scene)

    def blend(mask, n_new, sn_new, uv_new, m_new):
        m3 = mask[..., None]
        return (torch.where(m3, n_new, normal), torch.where(m3, sn_new, shading),
                torch.where(m3, uv_new, uv), torch.where(mask, m_new, material))

    if sizes[POOL_SPHERE]:
        p = scene.spheres
        i = hit.idx.clamp(0, sizes[POOL_SPHERE] - 1).long()
        r = torch.clamp(p.radius[i], min=1e-6)
        n = normalize((point - p.center[i]) / r[..., None])
        normal, shading, uv, material = blend(
            hit.pool == POOL_SPHERE, n, n, spherical_uv(n),
            p.material[i].long())

    if sizes[POOL_TRIANGLE]:
        p = scene.triangles
        i = hit.idx.clamp(0, sizes[POOL_TRIANGLE] - 1).long()
        v0, v1, v2 = p.v0[i], p.v1[i], p.v2[i]
        gn = normalize(cross(v1 - v0, v2 - v0))
        bu, bv = isect.triangle_bary(o, d, v0, v1, v2)
        bw = 1.0 - bu - bv
        sn = (bw[..., None] * p.n0[i] + bu[..., None] * p.n1[i]
              + bv[..., None] * p.n2[i])
        has_sn = dot(sn, sn) > 1e-12
        sn = normalize(torch.where(has_sn[..., None], sn, gn))
        uvt = (bw[..., None] * p.uv0[i] + bu[..., None] * p.uv1[i]
               + bv[..., None] * p.uv2[i])
        normal, shading, uv, material = blend(
            hit.pool == POOL_TRIANGLE, gn, sn, uvt, p.material[i].long())

    if sizes[POOL_CYLINDER]:
        p = scene.cylinders
        i = hit.idx.clamp(0, sizes[POOL_CYLINDER] - 1).long()
        p0 = p.p0[i]
        axis = p.p1[i] - p0
        h2 = torch.clamp(dot(axis, axis), min=1e-12)
        s = dot(point - p0, axis) / h2
        n_side = normalize(point - (p0 + s[..., None] * axis))
        # End-cap hits pin s to 0 or 1; their normal is the axis.
        a_hat = axis / torch.sqrt(h2)[..., None]
        n = torch.where((s < 1e-4)[..., None], -a_hat,
                        torch.where((s > 1.0 - 1e-4)[..., None], a_hat, n_side))
        uvc = torch.stack([spherical_uv(n_side)[..., 0], s], -1)
        normal, shading, uv, material = blend(
            hit.pool == POOL_CYLINDER, n, n, uvc, p.material[i].long())

    if sizes[POOL_ELLIPSOID]:
        p = scene.ellipsoids
        i = hit.idx.clamp(0, sizes[POOL_ELLIPSOID] - 1).long()
        rad = torch.clamp(p.radii[i], min=1e-6)
        local = (point - p.center[i]) / rad
        n = normalize(local / rad)
        normal, shading, uv, material = blend(
            hit.pool == POOL_ELLIPSOID, n, n, spherical_uv(local),
            p.material[i].long())

    if sizes[POOL_PLANE]:
        p = scene.planes
        i = hit.idx.clamp(0, sizes[POOL_PLANE] - 1).long()
        ax = p.axis[i].long()
        n = torch.eye(3, dtype=o.dtype, device=o.device)[ax]
        # The two in-plane axes, ascending: UV across the rectangle.
        in_plane = torch.tensor([[1, 2], [0, 2], [0, 1]],
                                device=o.device)[ax]
        pu = torch.gather(point - p.origin[i], -1, in_plane)
        uvp = 0.5 + 0.5 * pu / torch.clamp(p.half_extents[i], min=1e-6)
        normal, shading, uv, material = blend(
            hit.pool == POOL_PLANE, n, n, uvp, p.material[i].long())

    if scene.textures.count > 0:
        shading = apply_normal_maps(scene, material, uv, shading)

    # Flip normals to oppose the incoming ray; record backface hits.
    backface = dot(d, normal) > 0.0
    one = torch.ones_like(backface, dtype=o.dtype)
    normal = normal * torch.where(backface, -one, one)[..., None]
    shading = shading * torch.where(dot(d, shading) > 0.0, -one, one)[..., None]
    return SurfaceInfo(point=point, normal=normal, shading_normal=shading,
                       uv=uv, material=material, backface=backface,
                       valid=hit.valid)

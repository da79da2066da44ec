"""Scene-level closest-hit and shadow queries (counterpart of
solr_tpu/ops/traverse.py).

The scene is split into typed pools (:mod:`solr_tpu_torch.ops.pools`):
spheres, triangles, capped cylinders, ellipsoids and planes, visited in
that code order (the strict ``<`` across pools makes the earlier pool
win a tie).  Each pool takes
one of three paths, as in the reference (traverse.py:290-313 for the
closest hit, :790-812 for shadows):

* the packet path, where the pool has a BVH and its packet accelerator
  and the rays come in whole tiles: per-strip interval selection
  (:mod:`solr_tpu_torch.ops.packet`), the sweep kernels of its primitive
  kind (:mod:`solr_tpu_torch.ops.sweep`) and the exactness net for the
  rays whose drop certificate fails: every 32-ray strip of those rays
  gets its own list of the blocks its rays can hit, swept by the same
  kernels;
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
from solr_tpu_torch.ops import cudalib
from solr_tpu_torch.ops import intersect as isect
from solr_tpu_torch.ops import packet as pk
from solr_tpu_torch.ops import sweep
from solr_tpu_torch.ops.gather import gather_rows
from solr_tpu_torch.ops.pools import POOLS, shadow_factor
from solr_tpu_torch.ops.sweep import STRIP
from solr_tpu_torch.ops.textures import apply_normal_maps
from solr_tpu_torch.ops.vecmath import (cross, dot, masked_max, normalize,
                                        spherical_uv)
from solr_tpu_torch.types import Scene
from solr_tpu_torch.utils.profiling import render_phase

__all__ = ["Hit", "SurfaceInfo", "POOL_SPHERE", "POOL_TRIANGLE",
           "POOL_CYLINDER", "POOL_ELLIPSOID", "POOL_PLANE", "BRUTE_CALLS",
           "scene_closest_hit", "scene_transmittance", "spatial_keys",
           "surface_at"]

# Brute-force sweeps over a whole pool since the caller last zeroed
# these, closest-hit and shadow together, by pool name.
BRUTE_CALLS = {pool.name: 0 for pool in POOLS}

# Brute-force sweeps take the primitives in chunks of at least
# _PRIM_CHUNK, and of as many more as keep the (rays x chunk) matrices
# near _CHUNK_ELEMS elements: one eager op per chunk and step, so few
# large chunks, not the reference's fixed 512 (a TPU VMEM size).
_PRIM_CHUNK = 512
_CHUNK_ELEMS = 1 << 24


def _prim_chunk(n_rays: int, n: int) -> int:
    return min(n, max(_PRIM_CHUNK, _CHUNK_ELEMS // max(n_rays, 1)))


# Strips of 32 rays per tile of the net's needy rays, as the sweep
# kernels take them: (S, 32 * _NET_STRIPS, 3).
_NET_STRIPS = 8

# Blocks per sweep launch over the net's strip lists.  Every launch first
# runs the launch-order kernel, whose shared memory is 4 (K + 1) 33
# bytes for lists of up to K blocks (csrc/sweep.cu order_smem); the card
# allows SMEM_LIMIT bytes a CTA, so K is at most 1,759.  A wider list is
# swept in successive windows of this width, in list order.
_NET_WINDOW = cudalib.SMEM_LIMIT // (4 * 33) - 1

# What the exactness net did since the caller last zeroed these: net
# calls; needy rays; "strips", the 32-ray strips of needy rays, each
# swept over its own block list; "strip_blocks", the sum of those
# lists' lengths; "windows", the sweep launches over them (one per
# _NET_WINDOW blocks of the widest list of a call).  The needy rays
# again by query and bounce: closest hit or shadow, on the primary
# bounce (0) or a later one; the four add up to "needy_rays".
NET_STATS = {"calls": 0, "needy_rays": 0, "strips": 0, "strip_blocks": 0,
             "windows": 0, "needy_primary_closest": 0,
             "needy_primary_shadow": 0, "needy_later_closest": 0,
             "needy_later_shadow": 0}

# The bounce that the queries now running belong to (render.trace_rays
# sets it); the net files its needy rays under it.
_bounce = 0


def set_bounce(bounce: int):
    """File the net's needy rays from now on under ``bounce`` (0, the
    primary rays, or a later bounce)."""
    global _bounce
    _bounce = bounce


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


def _pool_t_chunk(scene: Scene, pool, o, d, start, chunk, t_min):
    rows = slice(start, start + chunk)
    return pool.t(o, d, *(x[rows] for x in pool.geometry(scene)), t_min)


def _pool_closest(o, d, scene: Scene, pool, t_min, t_max):
    """Brute-force closest hit within one pool: (best_t, best_idx)."""
    n = pool.size(scene)
    r_shape = o.shape[:-1]
    if n == 0:
        return (torch.full(r_shape, T_FAR, dtype=o.dtype, device=o.device),
                torch.zeros(r_shape, dtype=torch.int32, device=o.device))
    BRUTE_CALLS[pool.name] += 1
    with render_phase("brute"):
        best_t, best_i = _chunked_min(
            lambda s, c: _pool_t_chunk(scene, pool, o, d, s, c, t_min),
            n, r_shape, o)
        far = torch.full_like(best_t, T_FAR)
        return torch.where(best_t <= t_max, best_t, far), best_i


def scene_closest_hit(scene: Scene, o, d, t_min=RAY_EPS, t_max=T_FAR,
                      use_bvh: bool = True, packet=None) -> Hit:
    """Closest hit across every pool.  ``use_bvh`` lets accelerated
    pools use their BVHs; ``packet`` = (tile_rays, K, Kt, exact) when the
    rays come in tile-coherent groups of tile_rays."""
    with render_phase("closest"):
        with torch.no_grad():
            raw = _scene_closest_hit_raw(scene, o.detach(), d.detach(), t_min,
                                         t_max, use_bvh, packet)
        t = _recompute_t(scene, o, d, raw.pool, raw.idx, t_min)
        # Keep the traversal t on a miss and on rare recompute disagreements
        # (f32 tangency); the two agree whenever both hit.
        t = torch.where(raw.valid & (t < T_FAR * 0.5), t, raw.t)
        return Hit(t=t, pool=raw.pool, idx=raw.idx)


def _hit_rows(scene: Scene, code: int, idx, *fields):
    """The rows of pool ``code``'s ``fields`` at ``idx`` clamped into the
    pool: a ray on another pool, or on none, gathers a don't-care row
    that its caller's ``torch.where`` drops (and whose gradient it
    zeroes)."""
    pool = POOLS[code]
    p = pool.of(scene)
    i = idx.clamp(0, pool.size(scene) - 1).long()
    return [gather_rows(getattr(p, f), i) for f in fields]


def _recompute_t(scene: Scene, o, d, hit_pool, idx, t_min):
    """Differentiable hit distance for the already-selected primitive."""
    t = torch.full(o.shape[:-1], T_FAR, dtype=o.dtype, device=o.device)
    for pool in POOLS:
        if pool.size(scene):
            t = torch.where(hit_pool == pool.code, pool.t_p(
                o, d, *_hit_rows(scene, pool.code, idx, *pool.fields),
                t_min), t)
    return t


def _packet_ok(scene: Scene, pool, o, packet, bvh) -> bool:
    """Whether the pool takes the packet path, as in the reference: it
    has a BVH (``bvh``, None without one or without use_bvh) and its
    packet accelerator, and the rays come in whole tiles.  (A missing
    triangle accelerator is derived per frame by
    ``render.trace_rays_tiled``, as the reference derives it.)"""
    return (bvh is not None and packet is not None
            and pool.accel(scene) is not None
            and o.shape[0] % packet[0] == 0)


def _scene_closest_hit_raw(scene: Scene, o, d, t_min, t_max, use_bvh,
                           packet) -> Hit:
    r_shape = o.shape[:-1]
    best_t = torch.full(r_shape, T_FAR, dtype=o.dtype, device=o.device)
    best_pool = torch.full(r_shape, -1, dtype=torch.int32, device=o.device)
    best_idx = torch.zeros(r_shape, dtype=torch.int32, device=o.device)
    for pool in POOLS:
        if pool.size(scene) == 0:
            continue
        bvh = pool.bvh(scene) if use_bvh else None
        if _packet_ok(scene, pool, o, packet, bvh) and o.dim() == 2:
            t, i = _packet_closest(scene, pool, o, d, t_min, packet)
        elif bvh is not None:
            t, i = bvh_mod.bvh_closest_hit(scene, bvh, pool.code, o, d, t_min,
                                           t_max)
        else:
            t, i = _pool_closest(o, d, scene, pool, t_min, t_max)
        better = t < best_t
        best_t = torch.where(better, t, best_t)
        best_pool = torch.where(better, torch.full_like(best_pool, pool.code),
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


def _ray_block_slabs(o, d, block_bounds, t_min):
    """Per-(ray, block) slab test: (entry (R, B), hit (R, B)); entry is
    clamped to 0, a lower bound on any hit t inside the block."""
    entry, hit = pk.slab_entries_g(o[None], d[None], block_bounds[None], t_min)
    return entry[0], hit[0]


def spatial_keys(p, bmin, bmax):
    """Coarse Morton key (64 cells per axis) of positions p (R, 3) in the
    box; sorts rays into spatially tight strips (the net's needy rays,
    and ``render``'s live rays of a bounce)."""
    span = torch.clamp(bmax - bmin, min=1e-6)
    q = torch.clamp((p - bmin) / span * 64.0, 0.0, 63.0).to(torch.int32)

    def spread(x):  # interleave 6 bits -> every 3rd bit
        x = (x | (x << 8)) & 0x0300F
        x = (x | (x << 4)) & 0x030C3
        x = (x | (x << 2)) & 0x09249
        return x

    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


def _needy_tiles(need, sort_key, query):
    """The rays in ``need`` (R,) that the net takes, sorted by
    ``sort_key`` so that each strip is spatially tight, laid out in
    whole tiles of the sweep kernels' strips.  Returns (idx (n,) the
    needy rays in that order, slot (S * SB,) the ray in each slot of the
    tiles, padding slots repeating ray 0, live (S, SB), false on
    padding), or None when no ray needs the net.  ``query`` ("closest"
    or "shadow") files the needy rays in NET_STATS.

    Counting ``need`` is the net's first host sync; it replaces the
    reference's ``lax.cond``.  The sort puts the needy rays first, so
    their ids need no second count."""
    n = int(need.sum())
    NET_STATS["calls"] += 1
    NET_STATS["needy_rays"] += n
    stage = "later" if _bounce else "primary"
    NET_STATS[f"needy_{stage}_{query}"] += n
    if n == 0:
        return None
    key = torch.where(need, sort_key.to(torch.float32),
                      torch.full(need.shape, float("inf"), device=need.device))
    idx = torch.argsort(key, stable=True)[:n]
    tile = STRIP * _NET_STRIPS
    n_pad = -(-n // tile) * tile
    slot = torch.nn.functional.pad(idx, (0, n_pad - n))
    live = (torch.arange(n_pad, device=need.device) < n).reshape(-1, tile)
    NET_STATS["strips"] += -(-n // STRIP)
    return idx, slot, live


def _strip_lists(o, d, live, bound, block_bounds, t_min):
    """Each 32-ray strip's own block list: the blocks that some live ray
    of the strip enters at or before its ``bound`` (its best t for a
    closest hit, its light distance for a shadow ray).  Blocks partition
    the pool, so the list holds every block that can hold a hit of the
    strip's rays before their bounds.  o/d (N, 3), live and bound (N,),
    N a whole number of strips.

    Returns (cand (N / 32, K) int32, the list in ascending block id,
    block 0 past its count; counts (N / 32,) int32; nearb (N / 32, K),
    the suffix minimum of the strip's entry bounds over its list: a
    lower bound on any hit in that block or a later one, ascending as
    the sweeps' ``nearb`` does, so skipping a block once ``nearb >=
    done`` stays exact in id order; T_FAR past the count), or None when
    every list is empty.
    The widest list and the lists' total are the net's second host
    sync.  The slab test takes the rays in passes whose (rays x blocks)
    matrices stay near _CHUNK_ELEMS elements."""
    nb = block_bounds.shape[0]
    real = block_bounds[:, 0] < 1e29  # padding blocks park at +1e30
    rays = max(STRIP, _CHUNK_ELEMS // nb // STRIP * STRIP)
    on_s, entry_s = [], []
    for r0 in range(0, o.shape[0], rays):
        rs = slice(r0, r0 + rays)
        entry, hit = _ray_block_slabs(o[rs], d[rs], block_bounds, t_min)
        on = hit & (entry <= bound[rs, None]) & live[rs, None] & real
        on = on.reshape(-1, STRIP, nb)
        on_s.append(on.any(1))
        entry_s.append(entry.reshape(on.shape).masked_fill(~on, T_FAR)
                       .amin(1))
    on, entry = torch.cat(on_s), torch.cat(entry_s)
    counts = on.sum(1, dtype=torch.int32)
    k, total = torch.stack([counts.max(), counts.sum(dtype=torch.int32)]
                           ).tolist()
    NET_STATS["strip_blocks"] += total
    if k == 0:
        return None
    ids = torch.arange(nb, dtype=torch.int32, device=o.device)
    ids = torch.where(on, ids, torch.full_like(ids, nb)).sort(1).values[:, :k]
    listed = ids < nb
    cand = torch.where(listed, ids, torch.zeros_like(ids))
    nearb = torch.where(listed, torch.gather(entry, 1, cand.long()),
                        torch.full_like(entry[:, :k], T_FAR))
    nearb = nearb.flip(1).cummin(1).values.flip(1)
    return cand, counts, nearb


def _window(x, w0, shape):
    """Columns [w0, w0 + _NET_WINDOW) of a strip list tensor (N / 32, K),
    as the kernels take it: (S, G, width)."""
    return x[:, w0:w0 + _NET_WINDOW].reshape(*shape, -1)


def _window_counts(counts, w0, shape):
    """The strips' list lengths within the window at ``w0``, (S, G); one
    more sweep launch in NET_STATS."""
    NET_STATS["windows"] += 1
    return torch.clamp(counts - w0, 0, _NET_WINDOW).reshape(shape)


def _net_closest(accel, prim, o, d, t_cap, bt, bi, need, sort_key, t_min):
    """The exactness net of a closest hit.  The rays in ``need`` sweep,
    32-ray strip by strip, the blocks of their strip's list with the
    sweep kernel of ``prim``; a hit replaces the carry (bt, bi) (R,)
    only where strictly closer, so a tie keeps the earlier block in id
    order, then the lowest lane.  ``t_cap`` (R,) is each ray's
    scene-box exit.  Returns (bt, bi), written in place."""
    with render_phase("net"):
        rays = _needy_tiles(need, sort_key, "closest")
        if rays is None:
            return bt, bi
        idx, slot, live = rays
        o_n, d_n, best_t, best_i = o[slot], d[slot], bt[slot], bi[slot]
        lists = _strip_lists(o_n, d_n, live.reshape(-1), best_t,
                             accel.block_bounds, t_min)
        if lists is None:
            return bt, bi
        cand, counts, nearb = lists
        shape = (live.shape[0], _NET_STRIPS)
        o_t = o_n.reshape(*live.shape, 3)
        d_t = d_n.reshape(*live.shape, 3)
        cap = t_cap[slot].reshape(live.shape)
        best_t = best_t.reshape(live.shape)
        best_i = best_i.reshape(live.shape)
        for w0 in range(0, cand.shape[1], _NET_WINDOW):
            t, i, _ = sweep.sweep_closest(
                accel.packed, o_t, d_t, torch.minimum(best_t, cap), live,
                _window(cand, w0, shape), _window_counts(counts, w0, shape),
                _window(nearb, w0, shape), t_min, prim)
            better = t < best_t
            best_t = torch.where(better, t, best_t)
            best_i = torch.where(better, i, best_i)
        n = idx.shape[0]
        bt[idx] = best_t.reshape(-1)[:n]
        bi[idx] = best_i.reshape(-1)[:n]
        return bt, bi


def _net_transmittance(accel, prim, o, d, tm, tr, need, sort_key, t_min):
    """The exactness net of shadow rays: each ray in ``need`` takes the
    product, in block id order, of the factors of its strip's list, which
    holds every block that can occlude it before ``tm`` (R,); that
    product is its transmittance and replaces ``tr`` (R,) there.  A
    list wider than one window multiplies the windows' products, and a
    strip whose live rays are all at or below 1e-6 takes no further
    window, as the kernel stops it between blocks (the same product
    where the factors multiply exactly, as 0, 1 and powers of two do).
    Returns ``tr``, written in place."""
    with render_phase("net"):
        rays = _needy_tiles(need, sort_key, "shadow")
        if rays is None:
            return tr
        idx, slot, live = rays
        o_n, d_n, tm_n = o[slot], d[slot], tm[slot]
        lists = _strip_lists(o_n, d_n, live.reshape(-1), tm_n,
                             accel.block_bounds, t_min)
        n = idx.shape[0]
        if lists is None:
            tr[idx] = 1.0
            return tr
        cand, counts, _ = lists
        shape = (live.shape[0], _NET_STRIPS)
        o_t = o_n.reshape(*live.shape, 3)
        d_t = d_n.reshape(*live.shape, 3)
        tm_t = tm_n.reshape(live.shape)
        prod = None
        for w0 in range(0, cand.shape[1], _NET_WINDOW):
            counts_w = _window_counts(counts, w0, shape)
            if prod is not None:
                lit = masked_max(prod.reshape(-1, STRIP),
                                 live.reshape(-1, STRIP))
                counts_w = torch.where(lit.reshape(shape) > 1e-6, counts_w,
                                       torch.zeros_like(counts_w))
            p, _ = sweep.sweep_transmittance(
                accel.packed, o_t, d_t, tm_t, live, _window(cand, w0, shape),
                counts_w, t_min, prim)
            prod = p if prod is None else prod * p
        tr[idx] = prod.reshape(-1)[:n]
        return tr


def _packet_closest(scene: Scene, pool, o, d, t_min, packet):
    """Packet closest hit over an accelerated pool: strip interval
    lists -> front-to-back sweep -> exactness net for rays whose drop
    certificate fails."""
    tile_rays, ks, kt, exact = packet
    r = o.shape[0]
    prim = pool.name
    accel = pool.accel(scene)
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
    t_cap = t_cap.reshape(r)
    t_mid = 0.5 * torch.minimum(bt, t_cap)
    net_key = spatial_keys(o + d * t_mid[:, None], bmin, bmax)
    return _net_closest(accel, prim, o, d, t_cap, bt, bi, need, net_key,
                        t_min)


def scene_transmittance(scene: Scene, o, d, t_max, t_min=RAY_EPS,
                        use_bvh: bool = True, packet=None):
    """Shadow-ray transmittance in [0, 1]: the product over occluding
    primitives of their material transparency (emissive primitives are
    the lights and never occlude).  o/d (R, 3) or (R, L, 3)."""
    with render_phase("shadow"):
        trans = torch.ones(o.shape[:-1], dtype=o.dtype, device=o.device)
        for pool in POOLS:
            if pool.size(scene) == 0:
                continue
            bvh = pool.bvh(scene) if use_bvh else None
            if _packet_ok(scene, pool, o, packet, bvh):
                # Detached inputs: the accelerated pool's occluder
                # transparency carries no gradient, as in the reference.
                with torch.no_grad():
                    trans = trans * _packet_transmittance(
                        scene, pool, o.detach(), d.detach(), t_max.detach(),
                        t_min, packet)
                continue
            if bvh is not None:
                with torch.no_grad():
                    trans = trans * bvh_mod.bvh_transmittance(
                        scene, bvh, pool.code, o.detach(), d.detach(), t_min,
                        t_max.detach())
                continue
            trans = trans * _pool_transmittance_brute(scene, pool, o, d, t_max,
                                                      t_min)
        return trans


def _packet_transmittance(scene: Scene, pool, o, d, t_max, t_min, packet):
    """Packet shadow transmittance over an accelerated pool; lights
    unroll as a Python loop over the (R, L, 3) rays."""
    tile_rays, ks, kt, exact = packet
    prim = pool.name
    accel = pool.accel(scene)

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
        return _net_transmittance(accel, prim, o2, d2, tm2, tr, need,
                                  spatial_keys(o2, bmin, bmax), t_min)

    tm = t_max.expand(o.shape[:-1])
    if o.dim() == 3:
        return torch.stack([one_light(o[:, l], d[:, l], tm[:, l])
                            for l in range(o.shape[1])], 1)
    return one_light(o, d, tm)


def _pool_transmittance_brute(scene: Scene, pool, o, d, t_max,
                              t_min=RAY_EPS):
    """Brute-force transmittance over one pool, chunk by chunk.  The last
    partial chunk clamps its start and masks the rows already covered, so
    every factor applies exactly once."""
    size = pool.size(scene)
    trans = torch.ones(o.shape[:-1], dtype=o.dtype, device=o.device)
    if size == 0:
        return trans
    BRUTE_CALLS[pool.name] += 1
    material = pool.of(scene).material
    chunk = _prim_chunk(o[..., 0].numel(), size)
    with render_phase("brute"):
        for ci in range((size + chunk - 1) // chunk):
            start = min(ci * chunk, size - chunk)
            t = _pool_t_chunk(scene, pool, o, d, start, chunk, t_min)
            idx = start + torch.arange(chunk, device=o.device)
            occ = (t < t_max[..., None]) & (idx >= ci * chunk)
            f = shadow_factor(material[idx], scene.materials)
            trans = trans * torch.where(occ, f, torch.ones_like(t)).prod(-1)
    return trans


def surface_at(scene: Scene, hit: Hit, o, d) -> SurfaceInfo:
    """Point, normals, UV and material at the selected hits.  The
    material's normal and bump maps perturb the shading normal before
    the normals are flipped to oppose the ray, so the flip still holds
    for the perturbed normal."""
    with render_phase("surface"):
        t = torch.where(hit.valid, hit.t, torch.ones_like(hit.t))
        point = o + t[..., None] * d
        r_shape = o.shape[:-1]
        normal = torch.zeros_like(o)
        normal[..., 2] = -1.0
        shading = normal
        uv = torch.zeros(r_shape + (2,), dtype=o.dtype, device=o.device)
        material = torch.zeros(r_shape, dtype=torch.int64, device=o.device)

        def blend(mask, n_new, sn_new, uv_new, m_new):
            m3 = mask[..., None]
            return (torch.where(m3, n_new, normal), torch.where(m3, sn_new, shading),
                    torch.where(m3, uv_new, uv), torch.where(mask, m_new, material))

        if POOLS[POOL_SPHERE].size(scene):
            center, radius, mat = _hit_rows(scene, POOL_SPHERE, hit.idx,
                                            "center", "radius", "material")
            r = torch.clamp(radius, min=1e-6)
            n = normalize((point - center) / r[..., None])
            normal, shading, uv, material = blend(
                hit.pool == POOL_SPHERE, n, n, spherical_uv(n), mat.long())

        if POOLS[POOL_TRIANGLE].size(scene):
            v0, v1, v2, n0, n1, n2, uv0, uv1, uv2, mat = _hit_rows(
                scene, POOL_TRIANGLE, hit.idx, "v0", "v1", "v2", "n0", "n1",
                "n2", "uv0", "uv1", "uv2", "material")
            gn = normalize(cross(v1 - v0, v2 - v0))
            bu, bv = isect.triangle_bary(o, d, v0, v1, v2)
            bw = 1.0 - bu - bv
            sn = (bw[..., None] * n0 + bu[..., None] * n1
                  + bv[..., None] * n2)
            has_sn = dot(sn, sn) > 1e-12
            sn = normalize(torch.where(has_sn[..., None], sn, gn))
            uvt = (bw[..., None] * uv0 + bu[..., None] * uv1
                   + bv[..., None] * uv2)
            normal, shading, uv, material = blend(
                hit.pool == POOL_TRIANGLE, gn, sn, uvt, mat.long())

        if POOLS[POOL_CYLINDER].size(scene):
            p0, p1, mat = _hit_rows(scene, POOL_CYLINDER, hit.idx, "p0", "p1",
                                    "material")
            axis = p1 - p0
            h2 = torch.clamp(dot(axis, axis), min=1e-12)
            s = dot(point - p0, axis) / h2
            n_side = normalize(point - (p0 + s[..., None] * axis))
            # End-cap hits pin s to 0 or 1; their normal is the axis.
            a_hat = axis / torch.sqrt(h2)[..., None]
            n = torch.where((s < 1e-4)[..., None], -a_hat,
                            torch.where((s > 1.0 - 1e-4)[..., None], a_hat, n_side))
            uvc = torch.stack([spherical_uv(n_side)[..., 0], s], -1)
            normal, shading, uv, material = blend(
                hit.pool == POOL_CYLINDER, n, n, uvc, mat.long())

        if POOLS[POOL_ELLIPSOID].size(scene):
            center, radii, mat = _hit_rows(scene, POOL_ELLIPSOID, hit.idx,
                                           "center", "radii", "material")
            rad = torch.clamp(radii, min=1e-6)
            local = (point - center) / rad
            n = normalize(local / rad)
            normal, shading, uv, material = blend(
                hit.pool == POOL_ELLIPSOID, n, n, spherical_uv(local),
                mat.long())

        if POOLS[POOL_PLANE].size(scene):
            axis, origin, half, mat = _hit_rows(
                scene, POOL_PLANE, hit.idx, "axis", "origin", "half_extents",
                "material")
            ax = axis.long()
            n = torch.eye(3, dtype=o.dtype, device=o.device)[ax]
            # The two in-plane axes, ascending: UV across the rectangle.
            in_plane = torch.tensor([[1, 2], [0, 2], [0, 1]],
                                    device=o.device)[ax]
            pu = torch.gather(point - origin, -1, in_plane)
            uvp = 0.5 + 0.5 * pu / torch.clamp(half, min=1e-6)
            normal, shading, uv, material = blend(
                hit.pool == POOL_PLANE, n, n, uvp, mat.long())

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

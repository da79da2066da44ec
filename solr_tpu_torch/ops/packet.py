"""Packet (tile-frustum) traversal: block packing, bundle culls and the
per-strip interval selection (counterpart of solr_tpu/ops/packet.py).

The triangle pool, in Morton order, is cut into blocks of ``block``
triangles.  Rays come in spatially coherent 16x16-pixel tiles; each tile
culls the whole block list with a bundle test, keeps its Kt nearest
survivors, slab-tests every ray against them, and every 32-ray strip
gets its own entry-sorted front-to-back candidate list of at most K
blocks.  Any block a list had to drop is certified per ray by
``dropped``: a lower bound on the hit distance inside every dropped
block.  The sweep kernels in :mod:`solr_tpu_torch.ops.sweep` consume the
lists; the exactness net in :mod:`solr_tpu_torch.ops.traverse`
re-walks the rays whose certificate does not hold.

All of it is dense tensor math, as in the reference, where XLA ran it
outside any Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from solr_tpu_torch.constants import T_FAR
from solr_tpu_torch.ops.vecmath import cross, safe_inv
from solr_tpu_torch.types import TriAccel

__all__ = [
    "STRIP",
    "strips_per_tile",
    "tile_permutation",
    "make_bundles",
    "capsule_bundles",
    "cull_blocks",
    "cull_capsule",
    "ray_box_exit",
    "slab_entries_g",
    "strip_interval_select",
    "block_pack",
    "build_tri_accel",
    "tri_blocks_closest",
    "tri_blocks_transmittance",
]

# Rays per strip: the granularity of the per-strip candidate lists and
# the width of one warp in the sweep kernels.
STRIP = 32

_BIG = 1.0e30

# Candidate blocks evaluated per step of the block mirrors (bounds the
# (T, TR, chunk, block) intermediates).
_MIRROR_CHUNK = 16


def strips_per_tile(tile_rays: int) -> int:
    """STRIP-ray groups when they divide the tile, else one whole-tile
    strip (odd tile shapes; only the plain sweep takes those)."""
    return tile_rays // STRIP if tile_rays % STRIP == 0 else 1


def tile_permutation(width: int, height: int, tile_w: int, tile_h: int):
    """Row-major-pixel -> tile-major permutation and its inverse (numpy)."""
    assert width % tile_w == 0 and height % tile_h == 0
    idx = np.arange(width * height, dtype=np.int64).reshape(height, width)
    perm = idx.reshape(
        height // tile_h, tile_h, width // tile_w, tile_w
    ).transpose(0, 2, 1, 3).reshape(-1)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int64)
    return perm, inv


def _masked_mean(x, live, n_live):
    denom = torch.clamp(n_live, min=1.0)
    return torch.where(live, x, torch.zeros_like(x)).sum(1) / denom


def _masked_max(x, live):
    return torch.where(live, x, torch.zeros_like(x)).amax(1)


def make_bundles(o_t, d_t, live):
    """Per-tile bundle: origin sphere (po, ro) plus direction cone
    (axis, cos of the half angle), over the tile's live rays."""
    ox, oy, oz = o_t[..., 0], o_t[..., 1], o_t[..., 2]
    dx, dy, dz = d_t[..., 0], d_t[..., 1], d_t[..., 2]
    n_live = live.to(o_t.dtype).sum(1)
    px = _masked_mean(ox, live, n_live)
    py = _masked_mean(oy, live, n_live)
    pz = _masked_mean(oz, live, n_live)
    rx, ry, rz = ox - px[:, None], oy - py[:, None], oz - pz[:, None]
    ro = torch.sqrt(_masked_max(rx * rx + ry * ry + rz * rz, live))
    ax = _masked_mean(dx, live, n_live)
    ay = _masked_mean(dy, live, n_live)
    az = _masked_mean(dz, live, n_live)
    an = torch.sqrt(torch.clamp(ax * ax + ay * ay + az * az, min=1e-12))
    ax, ay, az = ax / an, ay / an, az / an
    cosv = dx * ax[:, None] + dy * ay[:, None] + dz * az[:, None]
    cos_g = torch.where(live, cosv, torch.ones_like(cosv)).amin(1)
    cos_g = torch.clamp(cos_g, -1.0, 1.0)
    return (torch.stack([px, py, pz], -1), ro,
            torch.stack([ax, ay, az], -1), cos_g)


def capsule_bundles(o_t, d_t, tmax_t, live):
    """Per-tile segment bundle for shadow rays: origin sphere (po, ro)
    and endpoint sphere (pa, ra) around the segment ends o + d * t_max."""
    ex = o_t[..., 0] + d_t[..., 0] * tmax_t
    ey = o_t[..., 1] + d_t[..., 1] * tmax_t
    ez = o_t[..., 2] + d_t[..., 2] * tmax_t
    ox, oy, oz = o_t[..., 0], o_t[..., 1], o_t[..., 2]
    n_live = live.to(o_t.dtype).sum(1)
    px = _masked_mean(ox, live, n_live)
    py = _masked_mean(oy, live, n_live)
    pz = _masked_mean(oz, live, n_live)
    ro = torch.sqrt(_masked_max(
        (ox - px[:, None]) ** 2 + (oy - py[:, None]) ** 2
        + (oz - pz[:, None]) ** 2, live))
    qx = _masked_mean(ex, live, n_live)
    qy = _masked_mean(ey, live, n_live)
    qz = _masked_mean(ez, live, n_live)
    ra = torch.sqrt(_masked_max(
        (ex - qx[:, None]) ** 2 + (ey - qy[:, None]) ** 2
        + (ez - qz[:, None]) ** 2, live))
    return (torch.stack([px, py, pz], -1), ro,
            torch.stack([qx, qy, qz], -1), ra)


def _split_bounds(centers, half_extents):
    c = [centers[:, i][None] for i in range(3)]
    h = [half_extents[:, i][None] for i in range(3)]
    return c, h


def cull_blocks(po, ro, axis, cos_g, centers, half_extents):
    """(T, B) conservative cone-bundle vs AABB test and a lower bound
    ``near`` on any bundle ray's hit distance inside each box (see the
    reference's support-function derivation)."""
    (cx, cy, cz), (hx, hy, hz) = _split_bounds(centers, half_extents)
    vx = cx - po[:, 0][:, None]
    vy = cy - po[:, 1][:, None]
    vz = cz - po[:, 2][:, None]
    ax, ay, az = axis[:, 0][:, None], axis[:, 1][:, None], axis[:, 2][:, None]
    t_c = vx * ax + vy * ay + vz * az
    d2 = vx * vx + vy * vy + vz * vz
    perp = torch.sqrt(torch.clamp(d2 - t_c * t_c, min=0.0))
    inv_p = safe_inv(perp, perp > 1e-9)
    r_perp = (
        hx * torch.abs(vx - t_c * ax)
        + hy * torch.abs(vy - t_c * ay)
        + hz * torch.abs(vz - t_c * az)
    ) * inv_p
    h_norm = torch.sqrt(hx * hx + hy * hy + hz * hz)
    r_perp = torch.where(perp > 1e-9, r_perp, h_norm.expand_as(r_perp))
    r_axis = hx * torch.abs(ax) + hy * torch.abs(ay) + hz * torch.abs(az)

    rr = ro[:, None]
    cg = cos_g[:, None]
    sin_g = torch.sqrt(torch.clamp(1.0 - cg * cg, min=0.0))
    tan_g = sin_g / torch.clamp(cg, min=1e-3)
    reach = torch.clamp(t_c + r_axis, min=0.0)
    narrow = cg > 0.05
    ahead = t_c + r_axis >= -rr
    ang_ok = perp - r_perp <= rr + reach * tan_g
    near_sphere_hit = torch.sqrt(d2) <= h_norm + rr
    mask = ~narrow | near_sphere_hit | (ahead & ang_ok)
    near = torch.maximum(torch.sqrt(d2) - h_norm - rr, t_c - r_axis - rr)
    return mask, torch.clamp(near, min=0.0)


def cull_capsule(po, ro, pa, ra, centers, half_extents):
    """(T, B) conservative segment-bundle vs AABB test; ``near`` is the
    slack, a lower bound on any bundle ray's hit distance in the box."""
    (cx, cy, cz), (hx, hy, hz) = _split_bounds(centers, half_extents)
    ux = pa[:, 0] - po[:, 0]
    uy = pa[:, 1] - po[:, 1]
    uz = pa[:, 2] - po[:, 2]
    ln = torch.sqrt(torch.clamp(ux * ux + uy * uy + uz * uz, min=1e-12))
    ux, uy, uz = ux / ln, uy / ln, uz / ln
    vx = cx - po[:, 0][:, None]
    vy = cy - po[:, 1][:, None]
    vz = cz - po[:, 2][:, None]
    t_c = vx * ux[:, None] + vy * uy[:, None] + vz * uz[:, None]
    s = torch.minimum(torch.clamp(t_c, min=0.0), ln[:, None])
    wx = vx - s * ux[:, None]
    wy = vy - s * uy[:, None]
    wz = vz - s * uz[:, None]
    d = torch.sqrt(torch.clamp(wx * wx + wy * wy + wz * wz, min=1e-12))
    inv_d = safe_inv(d, d > 1e-6)
    support = (hx * torch.abs(wx) + hy * torch.abs(wy)
               + hz * torch.abs(wz)) * inv_d
    h_norm = torch.sqrt(hx * hx + hy * hy + hz * hz)
    support = torch.where(d > 1e-6, support, h_norm.expand_as(support))
    slack = d - support - torch.maximum(ro, ra)[:, None]
    return slack <= 1e-5, torch.clamp(slack, min=0.0)


def ray_box_exit(o, d, bmin, bmax):
    """Per-ray exit distance through the AABB (bmin, bmax); 0 when the
    ray misses it.  An upper bound on any hit distance in the scene."""
    ok = d.abs() > 1e-12
    inv = safe_inv(d, ok)
    t0 = (bmin - o) * inv
    t1 = (bmax - o) * inv
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    inside = (o >= bmin) & (o <= bmax)
    big = torch.full_like(lo, _BIG)
    lo = torch.where(~ok, torch.where(inside, -big, big), lo)
    hi = torch.where(~ok, torch.where(inside, big, -big), hi)
    t_enter = lo.amax(-1)
    t_exit = hi.amin(-1)
    hit = (t_exit >= t_enter) & (t_exit > 0.0)
    return torch.where(hit, t_exit, torch.zeros_like(t_exit))


def slab_entries_g(o_t, d_t, bounds_g, t_min):
    """Per-(ray, candidate) slab test against per-tile gathered block
    bounds: (entry (S, SB, Kt), hit (S, SB, Kt)).  ``entry`` is the
    slab entry clamped to 0, a lower bound on any hit t in the block."""

    def axis(o_a, d_a, c_a, h_a):
        ok = d_a.abs() > 1e-12
        inv = safe_inv(d_a, ok)[..., None]
        off = o_a[..., None]
        c_b = c_a[:, None, :]
        h_b = h_a[:, None, :]
        lo = (c_b - h_b - off) * inv
        hi = (c_b + h_b - off) * inv
        t0 = torch.minimum(lo, hi)
        t1 = torch.maximum(lo, hi)
        inside = torch.abs(off - c_b) <= h_b
        deg = ~ok[..., None]
        big = torch.full_like(t0, _BIG)
        t0 = torch.where(deg, torch.where(inside, -big, big), t0)
        t1 = torch.where(deg, torch.where(inside, big, -big), t1)
        return t0, t1

    x0, x1 = axis(o_t[..., 0], d_t[..., 0], bounds_g[..., 0], bounds_g[..., 3])
    y0, y1 = axis(o_t[..., 1], d_t[..., 1], bounds_g[..., 1], bounds_g[..., 4])
    z0, z1 = axis(o_t[..., 2], d_t[..., 2], bounds_g[..., 2], bounds_g[..., 5])
    t_enter = torch.maximum(torch.maximum(x0, y0), z0)
    t_exit = torch.minimum(torch.minimum(x1, y1), z1)
    hit = (t_exit >= t_enter) & (t_exit > t_min)
    return torch.clamp(t_enter, min=0.0), hit


def strip_interval_select(o_t, d_t, live, accel: TriAccel, kt: int, ks: int,
                          t_min, tm_t=None):
    """Per-strip front-to-back block candidate lists.

    Args: o_t/d_t (S, SB, 3); live (S, SB) bool; ``accel``; kt/ks the
    tile prefilter and per-strip widths; tm_t (S, SB) per-ray maximum
    distance for shadow segments, or None for closest hit.

    Returns (cand (S, G, K) int32, counts (S, G) int32, nearb (S, G, K)
    ascending entry bounds, T_FAR past counts, dropped (S, SB)).  Slots
    past ``counts`` hold block 0; the sweeps never read them.
    """
    s_tiles, sb = o_t.shape[:2]
    g = strips_per_tile(sb)
    bb = accel.block_bounds
    nb = bb.shape[0]
    dev, dt = o_t.device, o_t.dtype

    if tm_t is None:
        po, ro, axis, cos_g = make_bundles(o_t, d_t, live)
        mask, near = cull_blocks(po, ro, axis, cos_g, bb[:, 0:3], bb[:, 3:6])
    else:
        po, ro, pa, ra = capsule_bundles(o_t, d_t, tm_t, live)
        mask, near = cull_capsule(po, ro, pa, ra, bb[:, 0:3], bb[:, 3:6])
    # Padding blocks (parked at +BIG) hold no hit.  A wide bundle passes
    # them, and in the tile-drop box below their BIG corner would round
    # the box's other corner away in f32, so they never enter the lists.
    # The reference keeps them (ROADMAP C4).
    mask = mask & live.any(1)[:, None] & (bb[:, 0] < 1e29)[None]

    kt_eff = min(kt, nb)
    score = torch.where(mask, -near, torch.full_like(near, -_BIG))
    topv, tile_cand = torch.topk(score, kt_eff, dim=1)
    tile_valid = topv > -_BIG * 0.5

    # Tile-drop certificate: the ray's slab entry into the AABB of the
    # cull-passing blocks the prefilter did not keep.
    if nb > kt_eff:
        sel = torch.zeros((s_tiles, nb), dtype=torch.bool, device=dev)
        sel.scatter_(1, tile_cand, tile_valid)
        drop = (mask & ~sel)[..., None]  # (S, B, 1)
        lo = (bb[:, 0:3] - bb[:, 3:6])[None]
        hi = (bb[:, 0:3] + bb[:, 3:6])[None]
        dmin = torch.where(drop, lo, torch.full_like(lo, _BIG)).amin(1)
        dmax = torch.where(drop, hi, torch.full_like(hi, -_BIG)).amax(1)
        dc = 0.5 * (dmin + dmax)
        dh = torch.clamp(0.5 * (dmax - dmin), min=0.0)
        box = torch.cat([dc, dh, torch.zeros((s_tiles, 2), dtype=dt, device=dev)],
                        -1)[:, None, :]
        entry_d, hit_d = slab_entries_g(o_t, d_t, box, t_min)
        any_drop = drop[..., 0].any(1)
        tile_dropped = torch.where(hit_d[..., 0] & any_drop[:, None],
                                   entry_d[..., 0],
                                   torch.full_like(entry_d[..., 0], T_FAR))
    else:
        tile_dropped = torch.full((s_tiles, sb), T_FAR, dtype=dt, device=dev)

    entry, hitm = slab_entries_g(o_t, d_t, bb[tile_cand], t_min)
    hitm = hitm & tile_valid[:, None, :] & live[..., None]
    if tm_t is not None:
        # Occluders live only in blocks whose interval starts before the
        # light.
        hitm = hitm & (entry <= tm_t[..., None])

    e_s = torch.where(hitm, entry, torch.full_like(entry, _BIG)).reshape(
        s_tiles, g, sb // g, kt_eff).amin(2)  # (S, G, Kt)

    ks_eff = min(ks, kt_eff)
    v2, i2 = torch.topk(-e_s, min(ks_eff + 1, kt_eff), dim=-1)
    valid2 = v2[..., :ks_eff] > -_BIG * 0.5
    cand = torch.gather(tile_cand[:, None, :].expand(s_tiles, g, kt_eff), -1,
                        i2[..., :ks_eff])
    cand = torch.where(valid2, cand, torch.zeros_like(cand)).to(torch.int32)
    counts = valid2.sum(-1).to(torch.int32)
    far = torch.full_like(v2[..., :ks_eff], T_FAR)
    nearb = torch.where(valid2, -v2[..., :ks_eff], far)
    if kt_eff > ks_eff:
        nxt = v2[..., ks_eff]
        strip_dropped = torch.where(nxt > -_BIG * 0.5, -nxt,
                                    torch.full_like(nxt, T_FAR))
    else:
        strip_dropped = torch.full((s_tiles, g), T_FAR, dtype=dt, device=dev)
    dropped = torch.minimum(strip_dropped.repeat_interleave(sb // g, dim=1),
                            tile_dropped)
    return cand, counts, nearb, dropped


# --------------------------------------------------------------------------
# Block data: Woop transforms and block bounds.
# --------------------------------------------------------------------------


def _dot3(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def block_pack(tris, factor, block: int):
    """Pack the Morton-ordered triangle pool into per-block data.

    Returns (packed (B, 16, block), centers (B, 3), half_extents (B, 3)).
    Rows 0..11 of ``packed`` hold the Woop transform
    [r1 m1 | r2 m2 | r3 m3], rows 12..14 zeros, row 15 the per-triangle
    shadow ``factor`` (1 for padding lanes).  Degenerate (padding)
    triangles get all-zero rows and never hit, and are left out of the
    block bounds; an empty block parks at +1e30.
    """
    n = tris.v0.shape[0]
    b = (n + block - 1) // block
    pad = b * block - n

    def pv(a):
        return torch.nn.functional.pad(a, (0, 0, 0, pad)) if pad else a

    v0, v1, v2 = pv(tris.v0), pv(tris.v1), pv(tris.v2)
    e1 = v1 - v0
    e2 = v2 - v0
    nrm = cross(e1, e2)
    den = _dot3(nrm, nrm)
    inv = safe_inv(den, den > 1e-18)[:, None]
    r1 = cross(e2, nrm) * inv
    r2 = cross(nrm, e1) * inv
    r3 = nrm * inv
    m1 = -_dot3(r1, v0)
    m2 = -_dot3(r2, v0)
    m3 = -_dot3(r3, v0)

    zeros = torch.zeros((b * block,), dtype=v0.dtype, device=v0.device)
    fac = torch.nn.functional.pad(factor, (0, pad), value=1.0) if pad else factor
    comps = [
        r1[:, 0], r1[:, 1], r1[:, 2], m1,
        r2[:, 0], r2[:, 1], r2[:, 2], m2,
        r3[:, 0], r3[:, 1], r3[:, 2], m3,
        zeros, zeros, zeros, fac,
    ]
    packed = torch.stack([c.reshape(b, block) for c in comps], 1)

    real = (v0.abs().sum(-1) + v1.abs().sum(-1) + v2.abs().sum(-1)) > 0.0
    vmin = torch.minimum(torch.minimum(v0, v1), v2)
    vmax = torch.maximum(torch.maximum(v0, v1), v2)
    vmin = torch.where(real[:, None], vmin, torch.full_like(vmin, _BIG))
    vmax = torch.where(real[:, None], vmax, torch.full_like(vmax, -_BIG))
    bmin = vmin.reshape(b, block, 3).amin(1)
    bmax = vmax.reshape(b, block, 3).amax(1)
    empty = (bmax[:, 0] < bmin[:, 0])[:, None]
    centers = torch.where(empty, torch.full_like(bmin, _BIG), 0.5 * (bmin + bmax))
    half = torch.where(empty, torch.zeros_like(bmin), 0.5 * (bmax - bmin) + 1e-5)
    return packed, centers, half


def _group_blocks(packed, centers, half, block: int) -> TriAccel:
    """Pad the block list to a multiple of 128 blocks (zero slabs, bounds
    parked at +1e30 so every cull rejects them)."""
    b = packed.shape[0]
    bp = ((b + 127) // 128) * 128
    if bp > b:
        packed = torch.nn.functional.pad(packed, (0, 0, 0, 0, 0, bp - b))
        centers = torch.cat([centers, torch.full((bp - b, 3), _BIG,
                                                 dtype=centers.dtype,
                                                 device=centers.device)])
        half = torch.cat([half, torch.zeros((bp - b, 3), dtype=half.dtype,
                                            device=half.device)])
    zeros2 = torch.zeros((bp, 2), dtype=centers.dtype, device=centers.device)
    return TriAccel(packed=packed.contiguous(),
                    block_bounds=torch.cat([centers, half, zeros2], -1),
                    block=block)


def build_tri_accel(triangles, materials, block: int) -> TriAccel:
    """The triangle accelerator.  Row 15 of ``packed`` carries the shadow
    factor: the material's transparency, 1 for emissive triangles."""
    m = triangles.material.long()
    factor = torch.where(materials.emission[m] > 0.0,
                         torch.ones_like(materials.transparency[m]),
                         materials.transparency[m])
    packed, centers, half = block_pack(triangles, factor, block)
    return _group_blocks(packed, centers, half, block)


# --------------------------------------------------------------------------
# Block mirrors: the exactness net's sweeps and the plain side of the
# kernels' Woop arithmetic.
# --------------------------------------------------------------------------


def _woop_t(o, d, w, t_min):
    """Woop intersection.  o/d (..., 3) broadcast against the packed rows
    w (..., 16, block) as rays (..., R, 1) x lanes (..., 1, block).

    The association ((ox*r0 + oy*r1) + oz*r2) + r3 is the one the CUDA
    kernels use (built without FMA contraction), so both agree bit for
    bit on the same device."""
    ox, oy, oz = (o[..., i, None] for i in range(3))
    dx, dy, dz = (d[..., i, None] for i in range(3))
    r = [w[..., None, i, :] for i in range(12)]
    opx = ox * r[0] + oy * r[1] + oz * r[2] + r[3]
    opy = ox * r[4] + oy * r[5] + oz * r[6] + r[7]
    opz = ox * r[8] + oy * r[9] + oz * r[10] + r[11]
    dpx = dx * r[0] + dy * r[1] + dz * r[2]
    dpy = dx * r[4] + dy * r[5] + dz * r[6]
    dpz = dx * r[8] + dy * r[9] + dz * r[10]
    safe = dpz.abs() > 1e-12
    inv = safe_inv(dpz, safe)
    t = -opz * inv
    u = opx + t * dpx
    v = opy + t * dpy
    valid = safe & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min)
    return torch.where(valid, t, torch.full_like(t, T_FAR))


def tri_blocks_closest(packed, o_t, d_t, cand, counts, t_min):
    """Closest hit of every ray against its tile's candidate blocks.

    packed (B, 16, block); o_t/d_t (T, TR, 3); cand (T, K) block ids;
    counts (T,).  Returns (t (T, TR), prim idx (T, TR), -1 on a miss).
    Ties go to the earliest candidate, then the lowest lane, as in the
    reference's sequential scan: the first minimum of each flattened
    (candidate, lane) chunk is exactly that order.
    """
    block = packed.shape[2]
    k_max = cand.shape[1]
    best_t = torch.full(o_t.shape[:2], T_FAR, dtype=o_t.dtype, device=o_t.device)
    best_i = torch.full(o_t.shape[:2], -1, dtype=torch.int32, device=o_t.device)
    ks = torch.arange(k_max, device=o_t.device)
    for k0 in range(0, k_max, _MIRROR_CHUNK):
        kc = cand[:, k0:k0 + _MIRROR_CHUNK].long()  # (T, C)
        w = packed[kc]  # (T, C, 16, block)
        t = _woop_t(o_t[:, None], d_t[:, None], w, t_min)  # (T, C, TR, block)
        ok = ks[k0:k0 + kc.shape[1]][None] < counts[:, None]  # (T, C)
        t = torch.where(ok[:, :, None, None], t, torch.full_like(t, T_FAR))
        t = t.permute(0, 2, 1, 3).reshape(t.shape[0], t.shape[2], -1)
        c_min, flat = t.min(-1)
        blk = torch.gather(kc, 1, flat // block)
        c_idx = (blk * block + flat % block).to(torch.int32)
        better = c_min < best_t
        best_t = torch.where(better, c_min, best_t)
        best_i = torch.where(better, c_idx, best_i)
    return best_t, best_i


def tri_blocks_transmittance(packed, o_t, d_t, t_max_t, cand, counts, t_min):
    """Shadow transmittance of every ray through its tile's candidate
    blocks: the product of the row-15 factor of every triangle hit with
    t < t_max.  (T, TR) in [0, 1]."""
    k_max = cand.shape[1]
    trans = torch.ones(o_t.shape[:2], dtype=o_t.dtype, device=o_t.device)
    ks = torch.arange(k_max, device=o_t.device)
    for k0 in range(0, k_max, _MIRROR_CHUNK):
        kc = cand[:, k0:k0 + _MIRROR_CHUNK].long()
        w = packed[kc]  # (T, C, 16, block)
        t = _woop_t(o_t[:, None], d_t[:, None], w, t_min)  # (T, C, TR, block)
        ok = ks[k0:k0 + kc.shape[1]][None] < counts[:, None]
        occ = (t < t_max_t[:, None, :, None]) & ok[:, :, None, None]
        f = torch.where(occ, w[:, :, None, 15, :], torch.ones_like(t))
        trans = trans * f.prod(-1).prod(1)
    return trans

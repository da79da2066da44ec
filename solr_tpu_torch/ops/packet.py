"""Packet (tile-frustum) traversal: block packing, bundle culls and the
per-strip interval selection (counterpart of solr_tpu/ops/packet.py).

Each accelerated pool (triangles, spheres, cylinders), in Morton order,
is cut into blocks of ``block`` primitives.  Rays come in spatially
coherent 16x16-pixel tiles; each tile culls the whole block list with a
bundle test, keeps its Kt nearest survivors, slab-tests every ray
against them, and every 32-ray strip gets its own entry-sorted
front-to-back candidate list of at most K blocks.  Any block a list had to drop is certified per ray by
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

from solr_tpu_torch.constants import INTERSECT_EPS, T_FAR
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
    "sphere_pack",
    "cylinder_pack",
    "build_tri_accel",
    "build_sph_accel",
    "build_cyl_accel",
    "cyl_core",
    "PRIM_T",
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
# Block data: primitive rows and block bounds.
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
    b, pad = _pad_pool(tris.v0.shape[0], block)

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
    fac = _pad_factor(factor, pad)
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
    return (packed,) + _block_bounds(real, vmin, vmax, b, block)


def _block_bounds(real, vmin, vmax, b: int, block: int):
    """(centers (B, 3), half_extents (B, 3)) of each block's real
    primitives' AABBs (vmin, vmax (B * block, 3)); an empty block parks
    at +1e30."""
    vmin = torch.where(real[:, None], vmin, torch.full_like(vmin, _BIG))
    vmax = torch.where(real[:, None], vmax, torch.full_like(vmax, -_BIG))
    bmin = vmin.reshape(b, block, 3).amin(1)
    bmax = vmax.reshape(b, block, 3).amax(1)
    empty = (bmax[:, 0] < bmin[:, 0])[:, None]
    centers = torch.where(empty, torch.full_like(bmin, _BIG), 0.5 * (bmin + bmax))
    half = torch.where(empty, torch.zeros_like(bmin), 0.5 * (bmax - bmin) + 1e-5)
    return centers, half


def _pad_pool(n: int, block: int):
    """(blocks, padding rows) of a pool of n primitives."""
    b = (n + block - 1) // block
    return b, b * block - n


def _pad_factor(factor, pad: int):
    return torch.nn.functional.pad(factor, (0, pad), value=1.0) if pad else factor


def sphere_pack(spheres, factor, block: int):
    """Pack the Morton-ordered sphere pool: (packed (B, 16, block),
    centers, half_extents).  Rows 0..2 the centre, row 3 the radius,
    rows 4..14 zero, row 15 the shadow ``factor``.  Padding spheres
    (radius <= 0) never hit and are left out of the block bounds."""
    b, pad = _pad_pool(spheres.radius.shape[0], block)
    c, rad = spheres.center, spheres.radius
    if pad:
        c = torch.nn.functional.pad(c, (0, 0, 0, pad))
        rad = torch.nn.functional.pad(rad, (0, pad), value=-1.0)
    zeros = torch.zeros((b * block,), dtype=c.dtype, device=c.device)
    comps = [c[:, 0], c[:, 1], c[:, 2], rad] + [zeros] * 11 \
        + [_pad_factor(factor, pad)]
    packed = torch.stack([x.reshape(b, block) for x in comps], 1)
    return (packed,) + _block_bounds(rad > 0.0, c - rad[:, None],
                                     c + rad[:, None], b, block)


def cylinder_pack(cyls, factor, block: int):
    """Pack the Morton-ordered cylinder pool: (packed (B, 16, block),
    centers, half_extents).  Rows 0..2 p0, row 3 the radius, rows 4..6
    the axis p1 - p0, row 7 |axis|^2, rows 8..14 zero, row 15 the shadow
    ``factor``.  Padding cylinders (radius <= 0) never hit and are left
    out of the block bounds."""
    b, pad = _pad_pool(cyls.radius.shape[0], block)
    p0, p1, rad = cyls.p0, cyls.p1, cyls.radius
    if pad:
        p0 = torch.nn.functional.pad(p0, (0, 0, 0, pad))
        p1 = torch.nn.functional.pad(p1, (0, 0, 0, pad))
        rad = torch.nn.functional.pad(rad, (0, pad), value=-1.0)
    axis = p1 - p0
    h2 = _dot3(axis, axis)
    zeros = torch.zeros((b * block,), dtype=p0.dtype, device=p0.device)
    comps = [p0[:, 0], p0[:, 1], p0[:, 2], rad,
             axis[:, 0], axis[:, 1], axis[:, 2], h2] + [zeros] * 7 \
        + [_pad_factor(factor, pad)]
    packed = torch.stack([x.reshape(b, block) for x in comps], 1)
    return (packed,) + _block_bounds(
        rad > 0.0, torch.minimum(p0, p1) - rad[:, None],
        torch.maximum(p0, p1) + rad[:, None], b, block)


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


def _shadow_factor(material, materials):
    """Per-primitive shadow factor: the material's transparency, 1 for
    emissive primitives (the lights never occlude)."""
    m = material.long()
    return torch.where(materials.emission[m] > 0.0,
                       torch.ones_like(materials.transparency[m]),
                       materials.transparency[m])


@torch.no_grad()
def build_tri_accel(triangles, materials, block: int) -> TriAccel:
    """The triangle accelerator; row 15 of ``packed`` carries the shadow
    factor.  The three builders run under ``torch.no_grad``: an
    accelerator is detached traversal data, built from inputs that may
    require grad (``Scene.refresh_accel``) without keeping a graph."""
    packed, centers, half = block_pack(
        triangles, _shadow_factor(triangles.material, materials), block)
    return _group_blocks(packed, centers, half, block)


@torch.no_grad()
def build_sph_accel(spheres, materials, block: int) -> TriAccel:
    """The sphere-pool accelerator (the sweeps' ``prim="sphere"``)."""
    packed, centers, half = sphere_pack(
        spheres, _shadow_factor(spheres.material, materials), block)
    return _group_blocks(packed, centers, half, block)


@torch.no_grad()
def build_cyl_accel(cylinders, materials, block: int) -> TriAccel:
    """The cylinder-pool accelerator (the sweeps' ``prim="cyl"``)."""
    packed, centers, half = cylinder_pack(
        cylinders, _shadow_factor(cylinders.material, materials), block)
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


def _sphere_t(o, d, w, t_min):
    """Sphere test, broadcast as :func:`_woop_t`; rows per
    :func:`sphere_pack`.  The nearest root > t_min (the exit root for a
    ray that starts inside).  The association is the CUDA kernels'."""
    ocx, ocy, ocz = (o[..., i, None] - w[..., None, i, :] for i in range(3))
    dx, dy, dz = (d[..., i, None] for i in range(3))
    rad = w[..., None, 3, :]
    b = ocx * dx + ocy * dy + ocz * dz
    c0 = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
    disc = b * b - c0
    valid = (disc > 0.0) & (rad > 0.0)
    sq = torch.sqrt(torch.where(valid, disc, torch.ones_like(disc)))
    far = torch.full_like(disc, T_FAR)
    t1 = torch.where(valid & (-b - sq > t_min), -b - sq, far)
    t2 = torch.where(valid & (-b + sq > t_min), -b + sq, far)
    return torch.minimum(t1, t2)


def cyl_core(c, r, t_min):
    """Capped cylinder (side plus both end disks, two-sided; radius <= 0
    never hits), as solr_tpu.ops.packet.cyl_core: ``c(i)`` is ray
    component i (0..2 origin, 4..6 direction), ``r(i)`` packed row i
    (:func:`cylinder_pack`); both broadcast.  The CUDA kernels'
    ``cyl_t`` repeats it operation for operation."""
    ocx, ocy, ocz = c(0) - r(0), c(1) - r(1), c(2) - r(2)
    dx, dy, dz = c(4), c(5), c(6)
    rad = r(3)
    h2 = r(7)
    inv_h2 = 1.0 / torch.clamp(h2, min=INTERSECT_EPS)
    d_a = dx * r(4) + dy * r(5) + dz * r(6)
    oc_a = ocx * r(4) + ocy * r(5) + ocz * r(6)
    a = 1.0 - d_a * d_a * inv_h2
    b = (ocx * dx + ocy * dy + ocz * dz) - d_a * oc_a * inv_h2
    cq = (ocx * ocx + ocy * ocy + ocz * ocz) - oc_a * oc_a * inv_h2 \
        - rad * rad
    safe_a = torch.clamp(a, min=INTERSECT_EPS)
    disc = b * b - safe_a * cq
    base = (disc > 0.0) & (a > INTERSECT_EPS) & (rad > 0.0)
    sq = torch.sqrt(torch.where(base, disc, torch.ones_like(disc)))
    t1 = (-b - sq) / safe_a
    t2 = (-b + sq) / safe_a
    s1 = oc_a + t1 * d_a
    s2 = oc_a + t2 * d_a
    far = torch.full_like(t1, T_FAR)
    t1 = torch.where(base & (s1 >= 0.0) & (s1 <= h2) & (t1 > t_min), t1, far)
    t2 = torch.where(base & (s2 >= 0.0) & (s2 <= h2) & (t2 > t_min), t2, far)
    t_side = torch.minimum(t1, t2)

    ax_safe = d_a.abs() > INTERSECT_EPS
    inv_da = safe_inv(d_a, ax_safe)

    def cap(plane_s, off_scale):
        tc = (plane_s - oc_a) * inv_da
        qx = ocx + tc * dx - off_scale * r(4)
        qy = ocy + tc * dy - off_scale * r(5)
        qz = ocz + tc * dz - off_scale * r(6)
        rad2 = qx * qx + qy * qy + qz * qz
        ok = ax_safe & (rad > 0.0) & (rad2 <= rad * rad) & (tc > t_min)
        return torch.where(ok, tc, far)

    return torch.minimum(t_side, torch.minimum(cap(0.0, 0.0), cap(h2, 1.0)))


def _cyl_t(o, d, w, t_min):
    """Cylinder test, broadcast as :func:`_woop_t`."""
    return cyl_core(
        lambda i: o[..., i, None] if i < 3 else d[..., i - 4, None],
        lambda i: w[..., None, i, :], t_min)


# The block test of each primitive kind: (o, d, packed rows, t_min) -> t.
PRIM_T = {"tri": _woop_t, "sphere": _sphere_t, "cyl": _cyl_t}


def tri_blocks_closest(packed, o_t, d_t, cand, counts, t_min,
                       prim: str = "tri"):
    """Closest hit of every ray against its tile's candidate blocks.

    packed (B, 16, block) rows of kind ``prim``; o_t/d_t (T, TR, 3);
    cand (T, K) block ids; counts (T,).  Returns (t (T, TR), prim idx
    (T, TR), -1 on a miss).
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
        t = PRIM_T[prim](o_t[:, None], d_t[:, None], w, t_min)  # (T, C, TR, block)
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


def tri_blocks_transmittance(packed, o_t, d_t, t_max_t, cand, counts, t_min,
                             prim: str = "tri"):
    """Shadow transmittance of every ray through its tile's candidate
    blocks: the product of the row-15 factor of every triangle hit with
    t < t_max.  (T, TR) in [0, 1]."""
    k_max = cand.shape[1]
    trans = torch.ones(o_t.shape[:2], dtype=o_t.dtype, device=o_t.device)
    ks = torch.arange(k_max, device=o_t.device)
    for k0 in range(0, k_max, _MIRROR_CHUNK):
        kc = cand[:, k0:k0 + _MIRROR_CHUNK].long()
        w = packed[kc]  # (T, C, 16, block)
        t = PRIM_T[prim](o_t[:, None], d_t[:, None], w, t_min)
        ok = ks[k0:k0 + kc.shape[1]][None] < counts[:, None]
        occ = (t < t_max_t[:, None, :, None]) & ok[:, :, None, None]
        f = torch.where(occ, w[:, :, None, 15, :], torch.ones_like(t))
        trans = trans * f.prod(-1).prod(1)
    return trans

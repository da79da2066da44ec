"""The plain reference renderer: Whitted-style ray tracing in plain
PyTorch, written from the renderer's stated semantics and not from the
program's code.  It imports nothing of the program.

Per bounce: the closest hit over the sphere, triangle and cylinder
pools; Phong shading with hard shadows (each light's shadow ray is
occluded by any non-emissive primitive before the light); the material's
reflection weight continues the ray along the mirror direction of the
shading normal; a miss takes the background (a vertical sky gradient or
a solid colour).

Closest hits are exact and need no tree: each pool is cut into blocks of
BLOCK primitives in the Morton order of their centroids, and each ray
tests the blocks it enters in the order of their entry distance, ROUND
blocks at a time, until the next block starts beyond its best hit (or,
for a shadow ray, beyond its light, or once it is fully occluded).  A
block's box is padded, so rounding in the slab test never skips a hit.

Gradients follow the renderer's contract: the hits are selected without
gradient, then each hit's distance is recomputed with autograd from the
selected primitive, so gradients reach rays, geometry, materials and
lights at fixed topology; shadow transmittance carries none.  Every
computation runs in the scene's dtype: float64 for the reference,
bfloat16 for the control.
"""

from __future__ import annotations

import dataclasses

import torch

RAY_EPS = 1e-4  # t_min of every ray, and a quarter of the origin offset
T_FAR = 3.0e38  # a miss
MIN_THROUGHPUT = 1e-3  # a continuation ray dies below this throughput
BLOCK = 64  # primitives per culling block
ROUND = 8  # blocks each ray tests per round
RAY_CHUNK = 8192  # rays whose block entries are held at once
SPHERE, TRIANGLE, CYLINDER = 0, 1, 2  # an equal t keeps the lower code


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def normalize(v):
    return v / torch.sqrt(torch.clamp(dot(v, v), min=1e-12))[..., None]


def reflect(d, n):
    return d - 2.0 * dot(d, n)[..., None] * n


def _inf(x):
    return torch.full_like(x, float("inf"))


# ---- ray-primitive distances: the smallest t > t_min, else inf ----

def sphere_t(o, d, c, r, t_min=RAY_EPS):
    oc = o - c
    b = dot(oc, d)
    disc = b * b - (dot(oc, oc) - r * r)
    ok = (disc > 0.0) & (r > 0.0)
    sq = torch.sqrt(torch.where(ok, disc, torch.ones_like(disc)))
    near, far = -b - sq, -b + sq
    t = torch.where(near > t_min, near, far)
    return torch.where(ok & (t > t_min), t, _inf(t))


def triangle_t(o, d, v0, e1, e2, t_min=RAY_EPS):
    """Two-sided Moller-Trumbore."""
    p = cross(d, e2)
    det = dot(e1, p)
    ok = det.abs() > 1e-8
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    s = o - v0
    u = dot(s, p) * inv
    q = cross(s, e1)
    v = dot(d, q) * inv
    t = dot(e2, q) * inv
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min)
    return torch.where(hit, t, _inf(t))


def cylinder_t(o, d, p0, axis, r, t_min=RAY_EPS):
    """Capped cylinder p0 -> p0 + axis: the side between the end planes
    and the two end disks, two-sided."""
    h = torch.sqrt(torch.clamp(dot(axis, axis), min=1e-30))
    a_hat = axis / h[..., None]
    oc = o - p0
    d_par, oc_par = dot(d, a_hat), dot(oc, a_hat)
    d_perp = d - d_par[..., None] * a_hat
    oc_perp = oc - oc_par[..., None] * a_hat
    qa = dot(d_perp, d_perp)
    qb = dot(oc_perp, d_perp)
    disc = qb * qb - qa * (dot(oc_perp, oc_perp) - r * r)
    ok = (disc > 0.0) & (qa > 1e-8) & (r > 0.0)
    sq = torch.sqrt(torch.where(ok, disc, torch.ones_like(disc)))
    qa = torch.where(ok, qa, torch.ones_like(qa))
    best = None
    for t in ((-qb - sq) / qa, (-qb + sq) / qa):
        s = oc_par + t * d_par
        t = torch.where(ok & (s >= 0.0) & (s <= h) & (t > t_min), t, _inf(t))
        best = t if best is None else torch.minimum(best, t)
    along = d_par.abs() > 1e-8
    d_par = torch.where(along, d_par, torch.ones_like(d_par))
    for plane in (torch.zeros_like(h), h):
        t = (plane - oc_par) / d_par
        q = oc + t[..., None] * d - plane[..., None] * a_hat
        hit = along & (r > 0.0) & (dot(q, q) <= r * r) & (t > t_min)
        best = torch.minimum(best, torch.where(hit, t, _inf(t)))
    return best


# ---- the scene ----

@dataclasses.dataclass
class RefScene:
    """Materials, pools and lights in one dtype.  Pool rows are the
    builder's inputs in input order; ``tri_normal`` is each triangle's
    shading normal, fixed when the scene is made."""

    mat_color: torch.Tensor  # (M, 4), the albedo
    mat_specular: torch.Tensor  # (M,) strength
    mat_power: torch.Tensor  # (M,) exponent
    mat_reflection: torch.Tensor  # (M,)
    mat_emission: torch.Tensor  # (M,) > 0 for lights
    mat_transparency: torch.Tensor  # (M,)
    sph_center: torch.Tensor  # (S, 3)
    sph_radius: torch.Tensor  # (S,)
    sph_material: torch.Tensor  # (S,) int64
    tri_v0: torch.Tensor  # (T, 3)
    tri_v1: torch.Tensor
    tri_v2: torch.Tensor
    tri_normal: torch.Tensor
    tri_material: torch.Tensor
    cyl_p0: torch.Tensor  # (C, 3)
    cyl_p1: torch.Tensor
    cyl_radius: torch.Tensor
    cyl_material: torch.Tensor
    light_position: torch.Tensor  # (L, 3)
    light_color: torch.Tensor  # (L, 3), colour times intensity
    ambient: float
    shadow_intensity: float
    background: torch.Tensor  # (3,) solid miss colour
    sky: tuple | None  # (horizon (3,), zenith (3,)) or None

    @property
    def dtype(self):
        return self.mat_color.dtype


def empty_pools(device, dtype) -> dict:
    """Empty pool fields, for scene kinds that lack a pool."""
    z3 = torch.zeros((0, 3), dtype=dtype, device=device)
    z = torch.zeros((0,), dtype=dtype, device=device)
    zi = torch.zeros((0,), dtype=torch.int64, device=device)
    return dict(sph_center=z3, sph_radius=z, sph_material=zi, tri_v0=z3,
                tri_v1=z3, tri_v2=z3, tri_normal=z3, tri_material=zi,
                cyl_p0=z3, cyl_p1=z3, cyl_radius=z, cyl_material=zi)


def face_normals(v0, v1, v2):
    return normalize(cross(v1 - v0, v2 - v0))


def materials(mats: list, device, dtype) -> dict:
    """Material fields from dicts with the keys color, specular,
    specular_power, reflection, emission and transparency."""
    def col(key, default):
        return torch.tensor([m.get(key, default) for m in mats], dtype=dtype,
                            device=device)

    return dict(mat_color=torch.tensor([list(m["color"]) for m in mats],
                                       dtype=dtype, device=device),
                mat_specular=col("specular", 0.0),
                mat_power=col("specular_power", 50.0),
                mat_reflection=col("reflection", 0.0),
                mat_emission=col("emission", 0.0),
                mat_transparency=col("transparency", 0.0))


def info_fields(info: dict, gradient_background: bool, device, dtype) -> dict:
    def vec(key):
        return torch.tensor(info[key][:3], dtype=dtype, device=device)

    return dict(ambient=float(info["ambient"]),
                shadow_intensity=float(info["shadow_intensity"]),
                background=vec("background_color"),
                sky=((vec("gradient_sky_horizon"), vec("gradient_sky_zenith"))
                     if gradient_background else None))


# ---- culling blocks and exact queries ----

def _morton(p, lo, hi):
    """30-bit Morton codes of points p (N, 3) in the box [lo, hi]."""
    q = ((p - lo) / torch.clamp(hi - lo, min=1e-30) * 1023.0)
    q = torch.clamp(q.float(), 0.0, 1023.0).to(torch.int64)
    code = torch.zeros(p.shape[0], dtype=torch.int64, device=p.device)
    for bit in range(10):
        for ax in range(3):
            code |= ((q[:, ax] >> bit) & 1) << (3 * bit + ax)
    return code


class Pool:
    """One primitive kind, its culling blocks and its exact queries.
    ``rows`` are the detached fields its distance test takes."""

    def __init__(self, kind, rows, material, box_lo, box_hi, scene):
        self.kind, self.rows, self.material = kind, rows, material
        n = material.shape[0]
        self.factor = torch.where(scene.mat_emission[material] > 0.0,
                                  torch.ones_like(scene.mat_transparency[material]),
                                  scene.mat_transparency[material])
        order = torch.argsort(_morton(0.5 * (box_lo + box_hi), box_lo.amin(0),
                                      box_hi.amax(0)), stable=True)
        n_pad = -(-n // BLOCK) * BLOCK
        pad = n_pad - n
        self.order = torch.cat([order, order.new_zeros(pad)])
        self.real = torch.cat([torch.ones(n, dtype=torch.bool, device=order.device),
                               torch.zeros(pad, dtype=torch.bool, device=order.device)])
        far = box_lo.new_full((pad, 3), float("inf"))
        lo = torch.cat([box_lo[order], far]).reshape(-1, BLOCK, 3)
        hi = torch.cat([box_hi[order], -far]).reshape(-1, BLOCK, 3)
        span = (box_hi.amax(0) - box_lo.amin(0)).amax()
        slack = 1e-5 * span + 1e-6 * (box_lo.abs().amax() + box_hi.abs().amax())
        self.lo = lo.amin(1) - slack
        self.hi = hi.amax(1) + slack

    def t(self, o, d, idx):
        """Distances of rays o, d (A, 1, 3) to the primitives idx (A, K)."""
        r = self.rows
        if self.kind == SPHERE:
            return sphere_t(o, d, r["c"][idx], r["r"][idx])
        if self.kind == TRIANGLE:
            return triangle_t(o, d, r["v0"][idx], r["e1"][idx], r["e2"][idx])
        return cylinder_t(o, d, r["p0"][idx], r["axis"][idx], r["r"][idx])

    def _entries(self, o, inv):
        """Entry distance of each ray into each block, inf where it
        misses: (A, NB)."""
        tn = torch.zeros((o.shape[0], self.lo.shape[0]), dtype=o.dtype,
                         device=o.device)
        tf = _inf(tn)
        for ax in range(3):
            t0 = (self.lo[None, :, ax] - o[:, None, ax]) * inv[:, None, ax]
            t1 = (self.hi[None, :, ax] - o[:, None, ax]) * inv[:, None, ax]
            tn = torch.maximum(tn, torch.minimum(t0, t1))
            tf = torch.minimum(tf, torch.maximum(t0, t1))
        return torch.where((tn <= tf) & (tf >= RAY_EPS), tn, _inf(tn))

    def _rounds(self, o, d, limit):
        """Rounds of (ray ids, primitive ids (A, ROUND * BLOCK), mask):
        the untested blocks each ray enters before ``limit`` of that ray,
        nearest first.  The caller lowers ``limit`` between rounds; a ray
        leaves once its next block starts at or past it."""
        tiny = torch.full_like(d, 1e-30)
        inv = 1.0 / torch.where(d.abs() < 1e-30, torch.copysign(tiny, d), d)
        lanes = torch.arange(BLOCK, device=o.device)
        for c0 in range(0, o.shape[0], RAY_CHUNK):
            ids = torch.arange(c0, min(o.shape[0], c0 + RAY_CHUNK),
                               device=o.device)
            ent = self._entries(o[ids], inv[ids])
            keep = ent.amin(1) < limit[ids]
            ids, ent = ids[keep], ent[keep]
            while ids.numel():
                k = min(ROUND, ent.shape[1])
                ev, eb = torch.topk(ent, k, dim=1, largest=False, sorted=True)
                slot = eb[..., None] * BLOCK + lanes
                enter = (ev < limit[ids][:, None])[..., None]
                mask = (enter & self.real[slot]).reshape(ids.shape[0], -1)
                yield ids, self.order[slot].reshape(ids.shape[0], -1), mask
                ent.scatter_(1, eb, float("inf"))
                keep = ent.amin(1) < limit[ids]
                ids, ent = ids[keep], ent[keep]

    def closest(self, o, d):
        best = torch.full(o.shape[:1], T_FAR, dtype=o.dtype, device=o.device)
        best_i = torch.zeros(o.shape[:1], dtype=torch.int64, device=o.device)
        for ids, prims, mask in self._rounds(o, d, best):
            t = torch.where(mask, self.t(o[ids, None], d[ids, None], prims),
                            torch.tensor(float("inf"), dtype=o.dtype,
                                         device=o.device))
            tm, am = t.min(1)
            better = tm < best[ids]
            best[ids] = torch.where(better, tm, best[ids])
            best_i[ids] = torch.where(better, prims.gather(1, am[:, None])[:, 0],
                                      best_i[ids])
        return best, best_i

    def transmittance(self, o, d, t_max):
        trans = torch.ones(o.shape[:1], dtype=o.dtype, device=o.device)
        limit = t_max.clone()
        for ids, prims, mask in self._rounds(o, d, limit):
            t = self.t(o[ids, None], d[ids, None], prims)
            occ = mask & (t < t_max[ids, None])
            f = torch.where(occ, self.factor[prims], torch.ones_like(t)).prod(1)
            trans[ids] = trans[ids] * f
            limit[ids] = torch.where(trans[ids] > 0.0, t_max[ids],
                                     torch.full_like(t_max[ids], -float("inf")))
        return trans


def pools(scene: RefScene) -> list:
    """The scene's non-empty pools, detached, in code order."""
    out = []
    with torch.no_grad():
        c, r = scene.sph_center.detach(), scene.sph_radius.detach()
        if r.shape[0]:
            rr = torch.clamp(r, min=0.0)[:, None]
            out.append(Pool(SPHERE, {"c": c, "r": r}, scene.sph_material,
                            c - rr, c + rr, scene))
        v0, v1, v2 = (x.detach() for x in (scene.tri_v0, scene.tri_v1,
                                            scene.tri_v2))
        if v0.shape[0]:
            out.append(Pool(TRIANGLE, {"v0": v0, "e1": v1 - v0, "e2": v2 - v0},
                            scene.tri_material,
                            torch.minimum(torch.minimum(v0, v1), v2),
                            torch.maximum(torch.maximum(v0, v1), v2), scene))
        p0, p1 = scene.cyl_p0.detach(), scene.cyl_p1.detach()
        if p0.shape[0]:
            rr = torch.clamp(scene.cyl_radius.detach(), min=0.0)[:, None]
            out.append(Pool(CYLINDER, {"p0": p0, "axis": p1 - p0,
                                       "r": scene.cyl_radius.detach()},
                            scene.cyl_material, torch.minimum(p0, p1) - rr,
                            torch.maximum(p0, p1) + rr, scene))
    return out


@torch.no_grad()
def closest_hit(pool_list, o, d):
    """(t, pool code, index) of the closest hit over the pools; t is
    T_FAR on a miss."""
    best = torch.full(o.shape[:1], T_FAR, dtype=o.dtype, device=o.device)
    code = torch.full(o.shape[:1], -1, dtype=torch.int64, device=o.device)
    idx = torch.zeros(o.shape[:1], dtype=torch.int64, device=o.device)
    for pool in pool_list:
        t, i = pool.closest(o, d)
        better = t < best
        best = torch.where(better, t, best)
        code = torch.where(better, torch.full_like(code, pool.kind), code)
        idx = torch.where(better, i, idx)
    return best, code, idx


@torch.no_grad()
def transmittance(pool_list, o, d, t_max):
    trans = torch.ones(o.shape[:1], dtype=o.dtype, device=o.device)
    for pool in pool_list:
        trans = trans * pool.transmittance(o, d, t_max)
    return trans


# ---- surfaces, shading and the bounce loop ----

def _by_pool(code, fn, out_shape, like):
    """Assemble fn(kind, rows) over the hits of each pool, with autograd:
    rows are the hit rays of pool ``kind``."""
    out = torch.zeros(out_shape, dtype=like.dtype, device=like.device)
    for kind in (SPHERE, TRIANGLE, CYLINDER):
        rows = (code == kind).nonzero()[:, 0]
        if rows.numel():
            out = out.index_put((rows,), fn(kind, rows))
    return out


def _hit_t(scene, o, d, code, idx):
    """Each hit's distance, recomputed with autograd from its
    primitive."""
    def fn(kind, rows):
        i = idx[rows]
        if kind == SPHERE:
            return sphere_t(o[rows], d[rows], scene.sph_center[i],
                            scene.sph_radius[i])
        if kind == TRIANGLE:
            v0 = scene.tri_v0[i]
            return triangle_t(o[rows], d[rows], v0, scene.tri_v1[i] - v0,
                              scene.tri_v2[i] - v0)
        p0 = scene.cyl_p0[i]
        return cylinder_t(o[rows], d[rows], p0, scene.cyl_p1[i] - p0,
                          scene.cyl_radius[i])
    return _by_pool(code, fn, o.shape[:1], o)


def _normals(scene, p, code, idx):
    """(geometric normal, shading normal, material) at hit points p."""
    def fn(kind, rows):
        i, q = idx[rows], p[rows]
        if kind == SPHERE:
            n = normalize(q - scene.sph_center[i])
            return torch.cat([n, n], -1)
        if kind == TRIANGLE:
            v0 = scene.tri_v0[i]
            n = normalize(cross(scene.tri_v1[i] - v0, scene.tri_v2[i] - v0))
            return torch.cat([n, scene.tri_normal[i]], -1)
        p0 = scene.cyl_p0[i]
        axis = scene.cyl_p1[i] - p0
        h2 = torch.clamp(dot(axis, axis), min=1e-12)
        s = dot(q - p0, axis) / h2
        side = normalize(q - (p0 + s[:, None] * axis))
        a_hat = axis / torch.sqrt(h2)[:, None]
        n = torch.where((s < 1e-4)[:, None], -a_hat,
                        torch.where((s > 1.0 - 1e-4)[:, None], a_hat, side))
        return torch.cat([n, n], -1)

    both = _by_pool(code, fn, p.shape[:1] + (6,), p)
    mats = {SPHERE: scene.sph_material, TRIANGLE: scene.tri_material,
            CYLINDER: scene.cyl_material}
    mat = torch.zeros(p.shape[:1], dtype=torch.int64, device=p.device)
    for kind, m in mats.items():
        sel = code == kind
        if m.shape[0]:
            mat = torch.where(sel, m[idx.clamp(max=m.shape[0] - 1)], mat)
    return both[:, :3], both[:, 3:], mat


def _background(scene, d):
    if scene.sky is None:
        return scene.background.expand(d.shape[0], 3)
    horizon, zenith = scene.sky
    t = torch.clamp(0.5 + 0.5 * d[:, 1], 0.0, 1.0)[:, None]
    return (1.0 - t) * horizon + t * zenith


def _shade(scene, pool_list, p, n_geo, n_sh, mat, view):
    """Ambient and emission, plus each light's diffuse and specular
    term times its shadow: 1 - shadow_intensity * (1 - transmittance)."""
    albedo = scene.mat_color[mat][:, :3]
    out = albedo * (scene.ambient + scene.mat_emission[mat])[:, None]
    n_l = scene.light_position.shape[0]
    if n_l == 0:
        return out
    to_l = scene.light_position[None] - p[:, None]
    dist = torch.sqrt(torch.clamp(dot(to_l, to_l), min=1e-12))
    ldir = to_l / dist[..., None]
    ndotl = torch.clamp(dot(n_sh[:, None], ldir), 0.0, 1.0)
    rdotl = torch.clamp(dot(reflect(view, n_sh)[:, None], ldir), 0.0, 1.0)
    spec = scene.mat_specular[mat][:, None] * torch.pow(
        rdotl, torch.clamp(scene.mat_power[mat], min=1.0)[:, None])
    with torch.no_grad():
        origin = (p + n_geo * (4.0 * RAY_EPS))[:, None].expand_as(ldir)
        trans = transmittance(pool_list, origin.reshape(-1, 3).detach(),
                              ldir.reshape(-1, 3).detach(),
                              (dist - RAY_EPS).reshape(-1).detach())
    shadow = 1.0 - scene.shadow_intensity * (1.0 - trans.reshape(dist.shape))
    direct = ((albedo[:, None] * ndotl[..., None] + spec[..., None])
              * scene.light_color[None] * shadow[..., None]).sum(1)
    return out + direct


def trace(scene: RefScene, o, d, bounces: int):
    """RGB (R, 3) of rays o, d through ``bounces`` bounces."""
    pool_list = pools(scene)
    n = o.shape[0]
    color = torch.zeros((n, 3), dtype=o.dtype, device=o.device)
    thru = torch.ones((n, 3), dtype=o.dtype, device=o.device)
    ids = torch.arange(n, device=o.device)
    for _ in range(bounces):
        if not ids.numel():
            break
        t_raw, code, idx = closest_hit(pool_list, o.detach(), d.detach())
        hit = t_raw < T_FAR * 0.5
        miss = (~hit).nonzero()[:, 0]
        color = color.index_add(0, ids[miss],
                                thru[miss] * _background(scene, d[miss]))
        h = hit.nonzero()[:, 0]
        o, d, thru, ids, code, idx = (x[h] for x in (o, d, thru, ids, code,
                                                     idx))
        t = _hit_t(scene, o, d, code, idx)
        t = torch.where(t < T_FAR * 0.5, t, t_raw[h])
        p = o + t[:, None] * d
        n_geo, n_sh, mat = _normals(scene, p, code, idx)
        one = torch.ones_like(t)
        n_geo = n_geo * torch.where(dot(d, n_geo) > 0.0, -one, one)[:, None]
        n_sh = n_sh * torch.where(dot(d, n_sh) > 0.0, -one, one)[:, None]
        local = _shade(scene, pool_list, p, n_geo, n_sh, mat, d)
        w = scene.mat_reflection[mat]
        color = color.index_add(0, ids, thru * (1.0 - w)[:, None] * local)
        nd = normalize(reflect(d, n_sh))
        thru = thru * w[:, None]
        live = (w > 1e-4) & (thru.amax(-1) > MIN_THROUGHPUT)
        o = (p + nd * (4.0 * RAY_EPS))[live]
        d, thru, ids = nd[live], thru[live], ids[live]
    return color


def rotate_euler(v, angles):
    """Rotate (..., 3) vectors about X, then Y, then Z."""
    ax, ay, az = angles
    cx, sx = torch.cos(ax), torch.sin(ax)
    cy, sy = torch.cos(ay), torch.sin(ay)
    cz, sz = torch.cos(az), torch.sin(az)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    y, z = cx * y - sx * z, sx * y + cx * z
    x, z = cy * x + sy * z, -sy * x + cy * z
    x, y = cz * x - sz * y, sz * x + cz * y
    return torch.stack([x, y, z], -1)


def camera_rays(camera: dict, width: int, height: int, device, dtype,
                pixels=None):
    """Pinhole rays through the centres of ``pixels`` (row-major ids,
    default all): the image plane spans [-aspect, aspect] x [1, -1] at
    tan(fov / 2), camera space looks down +z and ``angles`` rotate it
    into the world."""
    if pixels is None:
        pixels = torch.arange(width * height, device=device)
    y = (pixels // width).to(dtype) + 0.5
    x = (pixels % width).to(dtype) + 0.5
    u = (2.0 * x / width - 1.0) * (width / height)
    v = 1.0 - 2.0 * y / height
    scale = torch.tan(torch.tensor(0.5 * camera["fov"], dtype=dtype,
                                   device=device))
    d = torch.stack([u * scale, v * scale, torch.ones_like(u)], -1)
    angles = torch.tensor(camera.get("angles", (0.0, 0.0, 0.0)), dtype=dtype,
                          device=device)
    d = normalize(rotate_euler(d, angles))
    o = torch.tensor(camera["position"], dtype=dtype,
                     device=device).expand_as(d)
    return o, d


def render(scene: RefScene, camera: dict, width: int, height: int,
           bounces: int, pixels=None):
    """RGB of ``pixels`` (default the whole frame, (H * W, 3))."""
    o, d = camera_rays(camera, width, height, scene.mat_color.device,
                       scene.dtype, pixels)
    return trace(scene, o, d, bounces)

"""Independent NumPy float64 reference tracer (counterpart of
solr_tpu/oracle/cpu_tracer.py, kept as this package's own copy).

Implements the SAME rendering semantics as solr_tpu_torch.ops.render /
shade / traverse (Whitted-style: Phong direct lighting with
transparent-attenuated shadows; continuation ray = refraction if the
material is transparent else reflection; forward throughput
accumulation) -- but in a deliberately different code shape:
primitive-at-a-time python loops over numpy ray batches, no chunking,
no masking tricks, float64 throughout, and no torch operation in its
arithmetic: the scene's tensors are copied to numpy once.  Divergence
between the two implementations is a bug in one of them; closed-form
unit tests arbitrate.

Primitives are visited in pool order and the first of equally near ones
is kept, so a tie pixel follows the pool order ``SceneBuilder.build``
gives (it Morton-orders spheres and cylinders).  Padding rows (radius
<= 0, zero-area triangles, zero half-extents) are skipped.

Deliberately NOT supported (oracle scenes avoid them): texture atlases,
procedural kinds other than CHECKER, depth of field, soft shadows,
fisheye/anaglyph cameras, post-processing.
"""

from __future__ import annotations

import numpy as np

RAY_EPS = 1e-4
T_FAR = 3.0e38
_MIN_THROUGHPUT = 1e-3

# pool codes match solr_tpu_torch.constants
SPHERE, TRIANGLE, CYLINDER, ELLIPSOID, PLANE = 0, 1, 2, 3, 4


def _host(t) -> np.ndarray:
    """A tensor's values as a numpy array on the host."""
    return t.detach().cpu().numpy()


def _np(t) -> np.ndarray:
    return np.asarray(_host(t), np.float64)


def _normalize(v):
    n = np.sqrt(np.maximum((v * v).sum(-1, keepdims=True), 1e-12))
    return v / n


class OracleScene:
    """Plain-numpy snapshot of a solr_tpu_torch Scene: float fields in
    float64, integer fields as they are."""

    def __init__(self, scene):
        s = scene
        self.sph_c = _np(s.spheres.center)
        self.sph_r = _np(s.spheres.radius)
        self.sph_m = _host(s.spheres.material)
        self.tri = [_np(getattr(s.triangles, k)) for k in
                    ("v0", "v1", "v2", "n0", "n1", "n2", "uv0", "uv1", "uv2")]
        self.tri_m = _host(s.triangles.material)
        self.cyl_p0 = _np(s.cylinders.p0)
        self.cyl_p1 = _np(s.cylinders.p1)
        self.cyl_r = _np(s.cylinders.radius)
        self.cyl_m = _host(s.cylinders.material)
        self.ell_c = _np(s.ellipsoids.center)
        self.ell_r = _np(s.ellipsoids.radii)
        self.ell_m = _host(s.ellipsoids.material)
        self.pla_a = _host(s.planes.axis)
        self.pla_o = _np(s.planes.origin)
        self.pla_h = _np(s.planes.half_extents)
        self.pla_m = _host(s.planes.material)
        m = s.materials
        self.m_color = _np(m.color)
        self.m_spec = _np(m.specular)
        self.m_refl = _np(m.reflection)
        self.m_ior = _np(m.ior)
        self.m_trans = _np(m.transparency)
        self.m_emis = _np(m.emission)
        self.m_proc = _host(m.procedural)
        self.m_pscale = _np(m.procedural_scale)
        self.l_pos = _np(s.lights.position)
        self.l_col = _np(s.lights.color)
        info = s.info
        self.bg = _np(info.background_color)
        self.ambient = float(_np(info.ambient))
        self.shadow_intensity = float(_np(info.shadow_intensity))
        self.grad_zenith = _np(info.gradient_sky_zenith)
        self.grad_horizon = _np(info.gradient_sky_horizon)


def _prim_list(sc: OracleScene):
    """Yield (pool, index, intersect_fn) for every primitive."""
    out = []
    for i in range(len(sc.sph_r)):
        if sc.sph_r[i] > 0:
            out.append((SPHERE, i))
    for i in range(len(sc.tri_m)):
        v0, v1, v2 = sc.tri[0][i], sc.tri[1][i], sc.tri[2][i]
        if np.linalg.norm(np.cross(v1 - v0, v2 - v0)) > 1e-12:
            out.append((TRIANGLE, i))
    for i in range(len(sc.cyl_r)):
        if sc.cyl_r[i] > 0:
            out.append((CYLINDER, i))
    for i in range(len(sc.ell_m)):
        if np.all(sc.ell_r[i] > 0):
            out.append((ELLIPSOID, i))
    for i in range(len(sc.pla_m)):
        if np.all(sc.pla_h[i] > 0):
            out.append((PLANE, i))
    return out


def _isect_one(sc: OracleScene, pool, i, o, d, t_min):
    """t (R,) for one primitive against all rays; T_FAR if miss."""
    if pool == SPHERE:
        oc = o - sc.sph_c[i]
        b = (oc * d).sum(-1)
        c = (oc * oc).sum(-1) - sc.sph_r[i] ** 2
        disc = b * b - c
        t = np.full(o.shape[0], T_FAR)
        ok = disc > 0
        sq = np.sqrt(np.maximum(disc, 0))
        t1 = -b - sq
        t2 = -b + sq
        t1 = np.where(ok & (t1 > t_min), t1, T_FAR)
        t2 = np.where(ok & (t2 > t_min), t2, T_FAR)
        return np.minimum(t1, t2)
    if pool == TRIANGLE:
        v0, v1, v2 = sc.tri[0][i], sc.tri[1][i], sc.tri[2][i]
        e1, e2 = v1 - v0, v2 - v0
        p = np.cross(d, e2)
        det = (p * e1).sum(-1)
        ok = np.abs(det) > 1e-12
        inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
        tv = o - v0
        u = (tv * p).sum(-1) * inv
        q = np.cross(tv, e1)
        v = (q * d).sum(-1) * inv
        t = (q * np.broadcast_to(e2, q.shape)).sum(-1) * inv
        ok = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > t_min)
        return np.where(ok, t, T_FAR)
    if pool == CYLINDER:
        p0, p1, r = sc.cyl_p0[i], sc.cyl_p1[i], sc.cyl_r[i]
        axis = p1 - p0
        h2 = (axis * axis).sum()
        oc = o - p0
        da = (d * axis).sum(-1)
        oa = (oc * axis).sum(-1)
        a = 1.0 - da * da / h2
        b = (oc * d).sum(-1) - da * oa / h2
        c = (oc * oc).sum(-1) - oa * oa / h2 - r * r
        sa = np.maximum(a, 1e-12)
        disc = b * b - sa * c
        sq = np.sqrt(np.maximum(disc, 0))
        res = np.full(o.shape[0], T_FAR)
        for t_cand in ((-b - sq) / sa, (-b + sq) / sa):
            s = oa + t_cand * da
            ok = (disc > 0) & (a > 1e-12) & (s >= 0) & (s <= h2) & (
                t_cand > t_min
            )
            res = np.where(ok & (t_cand < res), t_cand, res)
        # End-cap disks (capped cylinderIntersection).
        da_ok = np.abs(da) > 1e-12
        inv_da = np.where(da_ok, 1.0, 0.0) / np.where(da_ok, da, 1.0)
        for plane_s, center_off in ((0.0, 0.0 * axis), (h2, axis)):
            tc = (plane_s - oa) * inv_da
            q = oc + tc[:, None] * d - center_off
            ok = da_ok & ((q * q).sum(-1) <= r * r) & (tc > t_min)
            res = np.where(ok & (tc < res), tc, res)
        return res
    if pool == ELLIPSOID:
        cen, rad = sc.ell_c[i], sc.ell_r[i]
        oc = (o - cen) / rad
        dd = d / rad
        a = (dd * dd).sum(-1)
        b = (oc * dd).sum(-1)
        c = (oc * oc).sum(-1) - 1.0
        disc = b * b - a * c
        sq = np.sqrt(np.maximum(disc, 0))
        t1 = (-b - sq) / a
        t2 = (-b + sq) / a
        t1 = np.where((disc > 0) & (t1 > t_min), t1, T_FAR)
        t2 = np.where((disc > 0) & (t2 > t_min), t2, T_FAR)
        return np.minimum(t1, t2)
    if pool == PLANE:
        ax = int(sc.pla_a[i])
        orig, he = sc.pla_o[i], sc.pla_h[i]
        dn = d[:, ax]
        ok = np.abs(dn) > 1e-12
        t = np.where(ok, (orig[ax] - o[:, ax]) / np.where(ok, dn, 1.0), T_FAR)
        p = o + t[:, None] * d
        in_axes = [j for j in range(3) if j != ax]
        inside = ok & (t > t_min)
        for k, j in enumerate(in_axes):
            inside = inside & (np.abs(p[:, j] - orig[j]) <= he[k])
        return np.where(inside, t, T_FAR)
    raise ValueError(pool)


def _closest(sc, prims, o, d, t_min=RAY_EPS):
    best_t = np.full(o.shape[0], T_FAR)
    best_pool = np.zeros(o.shape[0], np.int64)
    best_idx = np.zeros(o.shape[0], np.int64)
    for pool, i in prims:
        t = _isect_one(sc, pool, i, o, d, t_min)
        better = t < best_t
        best_t = np.where(better, t, best_t)
        best_pool = np.where(better, pool, best_pool)
        best_idx = np.where(better, i, best_idx)
    return best_t, best_pool, best_idx


def _transmittance(sc, prims, o, d, dist):
    trans = np.ones(o.shape[0])
    for pool, i in prims:
        t = _isect_one(sc, pool, i, o, d, RAY_EPS)
        occ = t < dist
        mat = _material_of(sc, pool, i)
        # Emissive primitives are light sources and never occlude shadow
        # rays (reference: processShadows skips the lamp primitive).
        f = 1.0 if sc.m_emis[mat] > 0.0 else sc.m_trans[mat]
        trans = trans * np.where(occ, f, 1.0)
    return trans


def _material_of(sc, pool, i):
    return [sc.sph_m, sc.tri_m, sc.cyl_m, sc.ell_m, sc.pla_m][pool][i]


def _surface(sc, pool, idx, p, o, d):
    """normal, shading normal, uv, material for scalar (pool, idx) rows."""
    n = np.zeros_like(p)
    sn = np.zeros_like(p)
    uv = np.zeros((p.shape[0], 2))
    mat = np.zeros(p.shape[0], np.int64)
    for pl in (SPHERE, TRIANGLE, CYLINDER, ELLIPSOID, PLANE):
        rows = np.nonzero(pool == pl)[0]
        if len(rows) == 0:
            continue
        for r in rows:
            i = idx[r]
            pt = p[r]
            if pl == SPHERE:
                nn = (pt - sc.sph_c[i]) / sc.sph_r[i]
                u = 0.5 + np.arctan2(nn[2], nn[0]) / (2 * np.pi)
                v = 0.5 - np.arcsin(np.clip(nn[1], -1, 1)) / np.pi
                n[r] = sn[r] = nn
                uv[r] = (u, v)
                mat[r] = sc.sph_m[i]
            elif pl == TRIANGLE:
                v0, v1, v2 = sc.tri[0][i], sc.tri[1][i], sc.tri[2][i]
                e1, e2 = v1 - v0, v2 - v0
                gn = np.cross(e1, e2)
                gn = gn / max(np.linalg.norm(gn), 1e-12)
                pp = np.cross(d[r], e2)
                det = (pp * e1).sum()
                inv = 1.0 / det if abs(det) > 1e-12 else 0.0
                tv = o[r] - v0
                bu = (tv * pp).sum() * inv
                bv = (np.cross(tv, e1) * d[r]).sum() * inv
                bw = 1 - bu - bv
                s = bw * sc.tri[3][i] + bu * sc.tri[4][i] + bv * sc.tri[5][i]
                if (s * s).sum() < 1e-12:
                    s = gn
                s = s / max(np.linalg.norm(s), 1e-12)
                n[r] = gn
                sn[r] = s
                uv[r] = (bw * sc.tri[6][i] + bu * sc.tri[7][i]
                         + bv * sc.tri[8][i])
                mat[r] = sc.tri_m[i]
            elif pl == CYLINDER:
                p0, p1 = sc.cyl_p0[i], sc.cyl_p1[i]
                axis = p1 - p0
                h2 = (axis * axis).sum()
                s = ((pt - p0) * axis).sum() / h2
                foot = p0 + s * axis
                nn = pt - foot
                nn = nn / max(np.linalg.norm(nn), 1e-12)
                a_hat = axis / np.sqrt(h2)
                if s < 1e-4:
                    cap = -a_hat
                elif s > 1.0 - 1e-4:
                    cap = a_hat
                else:
                    cap = None
                uv[r] = (np.arctan2(nn[2], nn[0]) / (2 * np.pi) + 0.5, s)
                if cap is not None:
                    nn = cap
                n[r] = sn[r] = nn
                mat[r] = sc.cyl_m[i]
            elif pl == ELLIPSOID:
                cen, rad = sc.ell_c[i], sc.ell_r[i]
                local = (pt - cen) / rad
                nn = local / rad
                nn = nn / max(np.linalg.norm(nn), 1e-12)
                u = 0.5 + np.arctan2(local[2], local[0]) / (2 * np.pi)
                v = 0.5 - np.arcsin(np.clip(local[1], -1, 1)) / np.pi
                n[r] = sn[r] = nn
                uv[r] = (u, v)
                mat[r] = sc.ell_m[i]
            else:  # PLANE
                ax = int(sc.pla_a[i])
                nn = np.zeros(3)
                nn[ax] = 1.0
                in_axes = [j for j in range(3) if j != ax]
                he = sc.pla_h[i]
                rel = pt - sc.pla_o[i]
                uv[r] = (0.5 + 0.5 * rel[in_axes[0]] / he[0],
                         0.5 + 0.5 * rel[in_axes[1]] / he[1])
                n[r] = sn[r] = nn
                mat[r] = sc.pla_m[i]
    backface = (d * n).sum(-1) > 0
    n = np.where(backface[:, None], -n, n)
    sn = np.where(((d * sn).sum(-1) > 0)[:, None], -sn, sn)
    return n, sn, uv, mat, backface


def _albedo(sc, mat, uv):
    color = sc.m_color[mat]
    # CHECKER procedural (kind 3) — the only procedural the oracle does.
    kind = sc.m_proc[mat]
    scale = sc.m_pscale[mat]
    checker = (np.floor(uv[:, 0] * scale) + np.floor(uv[:, 1] * scale)) % 2
    alt = 1.0 - color
    out = np.where(
        ((kind == 3) & (checker <= 0.5))[:, None], alt, color
    )
    out[:, 3] = color[:, 3]
    return out


def _shade(sc, prims, p, n, sn, uv, mat, d, shadows=True):
    albedo = _albedo(sc, mat, uv)
    out = albedo * (sc.ambient + sc.m_emis[mat][:, None])
    for li in range(len(sc.l_pos)):
        to_l = sc.l_pos[li] - p
        dist = np.sqrt(np.maximum((to_l * to_l).sum(-1), 1e-12))
        ldir = to_l / dist[:, None]
        ndotl = np.maximum(0.0, (sn * ldir).sum(-1))
        refl = d - 2 * (d * sn).sum(-1, keepdims=True) * sn
        rdotl = np.maximum(0.0, (refl * ldir).sum(-1))
        ks = sc.m_spec[mat][:, 0]
        kp = np.maximum(sc.m_spec[mat][:, 1], 1.0)
        spec = ks * rdotl ** kp
        if shadows:
            origin = p + n * (RAY_EPS * 4)
            trans = _transmittance(sc, prims, origin, ldir, dist - RAY_EPS)
            shadow = 1.0 - sc.shadow_intensity * (1.0 - trans)
        else:
            shadow = np.ones_like(ndotl)
        contrib = (albedo * ndotl[:, None] + spec[:, None]) * sc.l_col[li]
        out = out + contrib * shadow[:, None]
    out[:, 3] = 1.0
    return out


def _background(sc, d, gradient):
    if gradient:
        t = np.clip(0.5 + 0.5 * d[:, 1], 0, 1)[:, None]
        return (1 - t) * sc.grad_horizon + t * sc.grad_zenith
    return np.broadcast_to(sc.bg, (d.shape[0], 4)).copy()


def _refract(d, n, eta):
    cos_i = -(d * n).sum(-1, keepdims=True)
    sin2 = eta[:, None] ** 2 * np.maximum(0, 1 - cos_i ** 2)
    tir = (sin2 > 1)[:, 0]
    cos_t = np.sqrt(np.maximum(0, 1 - sin2))
    refr = eta[:, None] * d + (eta[:, None] * cos_i - cos_t) * n
    refl = d - 2 * (d * n).sum(-1, keepdims=True) * n
    out = np.where(tir[:, None], refl, refr)
    return _normalize(out)


def oracle_render(scene, camera, cfg) -> np.ndarray:
    """Render (H, W, 4) float64 with the mono pinhole camera.

    ``scene``/``camera``/``cfg`` are a solr_tpu_torch Scene, Camera and
    RenderConfig (its ``max_bounces``, ``shadows`` and
    ``gradient_background``); their tensors, on any device, are copied
    to numpy.  Must match solr_tpu_torch.ops.render.render_sample (with
    antialias_jitter=False, aperture=0, shadow_samples=1) to f32
    tolerance.
    """
    sc = OracleScene(scene)
    prims = _prim_list(sc)
    w, h = cfg.width, cfg.height

    pos = _np(camera.position)
    angles = _np(camera.angles)
    fov = float(_np(camera.fov))

    xs = (np.arange(w) + 0.5)
    ys = (np.arange(h) + 0.5)
    px, py = np.meshgrid(xs, ys)
    u = (2 * px.reshape(-1) / w - 1) * (w / h)
    v = 1 - 2 * py.reshape(-1) / h
    scale = np.tan(0.5 * fov)
    d_cam = np.stack([u * scale, v * scale, np.ones_like(u)], -1)

    # Euler rotation X then Y then Z (matches vecmath.rotate_euler).
    def rot(vec, a):
        x, y, z = vec[:, 0].copy(), vec[:, 1].copy(), vec[:, 2].copy()
        cx, sx = np.cos(a[0]), np.sin(a[0])
        y, z = cx * y - sx * z, sx * y + cx * z
        cy, sy = np.cos(a[1]), np.sin(a[1])
        x, z = cy * x + sy * z, -sy * x + cy * z
        cz, sz = np.cos(a[2]), np.sin(a[2])
        x, y = cz * x - sz * y, sz * x + cz * y
        return np.stack([x, y, z], -1)

    d = _normalize(rot(d_cam, angles))
    o = np.broadcast_to(pos, d.shape).copy()

    r = d.shape[0]
    thru = np.ones((r, 4))
    color = np.zeros((r, 4))
    live = np.ones(r, bool)

    for _ in range(cfg.max_bounces):
        t, pool, idx = _closest(sc, prims, o, d)
        hit_mask = t < T_FAR * 0.5
        valid = hit_mask & live
        p = o + t[:, None] * d
        p = np.where(hit_mask[:, None], p, o)
        n, sn, uv, mat, backface = _surface(sc, pool, idx, p, o, d)
        local = _shade(sc, prims, p, n, sn, uv, mat, d,
                       shadows=cfg.shadows)
        local = np.where(valid[:, None], local, 0.0)

        w_refr = sc.m_trans[mat]
        w_refl = sc.m_refl[mat]
        has_refr = w_refr > 1e-4
        wgt = np.where(has_refr, w_refr, w_refl)
        own = 1 - wgt
        color += thru * own[:, None] * local * valid[:, None]

        missed = live & ~hit_mask
        bg = _background(sc, d, cfg.gradient_background)
        color += thru * bg * missed[:, None]

        eta = np.where(backface, sc.m_ior[mat],
                       1.0 / np.maximum(sc.m_ior[mat], 1e-3))
        refr_d = _refract(d, sn, eta)
        refl_d = _normalize(d - 2 * (d * sn).sum(-1, keepdims=True) * sn)
        nd = np.where(has_refr[:, None], refr_d, refl_d)
        no = p + nd * (RAY_EPS * 4)

        tint = np.where(has_refr[:, None],
                        sc.m_color[mat] * 0.98 + 0.02,
                        np.ones((r, 4)))
        thru = thru * wgt[:, None] * tint
        live = valid & (wgt > 1e-4) & (thru[:, :3].max(-1) > _MIN_THROUGHPUT)
        o = np.where(live[:, None], no, o)
        d = np.where(live[:, None], nd, d)

    color[:, 3] = 1.0
    return color.reshape(h, w, 4)

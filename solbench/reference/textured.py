"""The reference's textured scene and its own renderer: refraction,
textures, a textured sky, fog, soft shadows, antialiasing jitter,
keyed samples and screen-space ambient occlusion, in plain PyTorch,
written from the renderer's stated semantics (its docstrings and
Sol-R's) and not from the program's code.  It imports nothing of the
program.

Per sample and bounce, for each ray still alive:

* the exact closest hit over the spheres (the light among them), the
  triangles (``render.Pool``'s block culling), the ellipsoids and the
  bounded planes; an equal t keeps the earlier of those four.  A
  plane's half extents bound its in-plane axes as the renderer's
  intersection does, the first extent an axis below the normal axis,
  the second one above it; its uv spans the rectangle by the first
  extent along the lower in-plane axis and the second along the
  higher, as documented.  (The documentation, and the oracle, bound
  the two axes as the uv does; an XY or YZ plane of unequal extents
  shows the difference: PERF.md.)
* at the hit: the point, the geometric and shading normals, the uv
  (spheres and ellipsoids by longitude and latitude, triangles by
  barycentric interpolation of their vertex uvs, planes across the
  rectangle) and the material; the material's normal map (RGB * 2 - 1
  in the tangent frame) or bump map (the central difference, one texel
  each way, of its luminance, times BUMP_STRENGTH) tilts the shading
  normal, then both normals turn to oppose the ray;
* the albedo times the diffuse map; ambient and emission, plus each
  light's diffuse and specular term (strength times the specular map's
  luminance) times its shadow, 1 - shadow_intensity (1 -
  transmittance), the mean over the shadow samples: with a key, each
  sample moves the light by a point of the unit ball (a normal
  direction, normalised, times the cube root of a uniform) times its
  radius; the transmittance is the product of the transparency of
  every non-emissive primitive whose nearest root lies between the
  surface and the light;
* the continuation weight: the transparency times the transparency
  map's luminance where that is over 1e-4 (refract, Snell with total
  internal reflection, tinted by 0.98 colour + 0.02), else the
  reflection times the reflection map's luminance (mirror about the
  shading normal); the surface keeps 1 - weight, faded by fog over the
  distance travelled since the eye; a miss takes the sky texture at its
  longitude and latitude; a ray dies once its weight is under 1e-4 or
  its throughput under 1e-3.

Then the mean of the samples, and the ambient occlusion pass on the
first sample's primary-hit depth (T_FAR on a miss): each pixel darkens
by shadow_intensity times the share of its 16 golden-angle taps within
8 pixels that are closer to the eye by over 5% of its depth.

The random draws are the program's ``Key`` draws, copied here (its
splitmix64 mixing, ``split``, ``fold_in``, and ``torch.Generator``
draws in float32 on the run's device), in the same shapes: per sample
key, the camera jitter (pixels, 2) from the first child of split(2);
per bounce key (split(bounces)) the soft shadows' (samples, pixels,
lights, 3) normals and (samples, pixels, lights, 1) uniforms from the
two children of split(2).  Each draw is widened to the scene's dtype.

Departures from the program, none of which changes a result beyond
rounding: every computation runs in the scene's dtype (float64 for the
reference, bfloat16 for the control); the rays are traced in chunks of
pixels, only while alive; the draws line up with the program's only
where the program traces the frame's rays in pixel order, as it does on
the per-ray walk (a frame that is not whole packet tiles); the program
stops a shadow walk once the transmittance is under 1e-6, where this
multiplies on; a mesh's triangles shade with their face normal (the
program interpolates per-vertex normals, which a mesh handed over
without normals takes from its faces); only the MONO pinhole camera.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from solbench.reference.render import (RAY_EPS, SPHERE, T_FAR, TRIANGLE,
                                       Pool, cross, dot, normalize, reflect,
                                       rotate_euler, sphere_t)

ELLIPSOID, PLANE = 3, 4
MIN_THROUGHPUT = 1e-3
BUMP_STRENGTH = 2.0
AO_RADIUS = 8.0
AO_SAMPLES = 16
CHUNK = 1 << 18  # pixels traced at once
_SLOTS = ("diffuse", "normal", "bump", "specular", "reflection",
          "transparency")

# ---- the program's random keys ----

_MASK = (1 << 64) - 1
_FOLD = 0xF01D_1A7E_5EED_0000


def _mix(x: int) -> int:
    """splitmix64's finaliser."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return x ^ (x >> 31)


class Key:
    """A functional random key: children by mixing, draws from a
    generator seeded with the key's state, in float32."""

    def __init__(self, state: int, device):
        self.state = int(state) & _MASK
        self.device = torch.device(device)

    @staticmethod
    def seed(seed: int, device) -> "Key":
        return Key(_mix(int(seed) & _MASK), device)

    def split(self, n: int = 2) -> list:
        return [Key(_mix(self.state ^ _mix(i + 1)), self.device)
                for i in range(n)]

    def fold_in(self, i: int) -> "Key":
        return Key(_mix(self.state ^ _mix(_FOLD ^ (int(i) & _MASK))),
                   self.device)

    def _generator(self):
        g = torch.Generator(self.device)
        g.manual_seed(self.state)
        return g

    def uniform(self, shape) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self._generator(),
                          dtype=torch.float32, device=self.device)

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self._generator(),
                           dtype=torch.float32, device=self.device)


# ---- the scene ----

@dataclasses.dataclass
class TexScene:
    """Materials, textures, the four pools and the lights in one dtype.
    ``tex`` stacks the textures (T, H, W, 4) in [0, 1], in id order;
    each ``mat_tex_<slot>`` names a texture id or -1."""

    mat_color: torch.Tensor  # (M, 4)
    mat_specular: torch.Tensor  # (M,)
    mat_power: torch.Tensor
    mat_reflection: torch.Tensor
    mat_transparency: torch.Tensor
    mat_ior: torch.Tensor
    mat_emission: torch.Tensor
    mat_tex: dict  # slot -> (M,) int64 texture ids
    tex: torch.Tensor
    sph_center: torch.Tensor  # (S, 3)
    sph_radius: torch.Tensor
    sph_material: torch.Tensor
    tri_v0: torch.Tensor  # (T, 3)
    tri_v1: torch.Tensor
    tri_v2: torch.Tensor
    tri_uv0: torch.Tensor  # (T, 2)
    tri_uv1: torch.Tensor
    tri_uv2: torch.Tensor
    tri_material: torch.Tensor
    ell_center: torch.Tensor  # (E, 3)
    ell_radii: torch.Tensor
    ell_material: torch.Tensor
    pl_axis: torch.Tensor  # (P,) int64: the normal's axis
    pl_origin: torch.Tensor  # (P, 3)
    pl_half: torch.Tensor  # (P, 2): along the other two axes, ascending
    pl_material: torch.Tensor
    light_position: torch.Tensor  # (L, 3)
    light_color: torch.Tensor  # (L, 3), colour times intensity
    light_radius: torch.Tensor  # (L,)
    ambient: float
    shadow_intensity: float
    soft_shadow_radius: float
    fog_start: float
    view_distance: float
    background: torch.Tensor  # (3,)
    sky: tuple | None  # (horizon, zenith) of the gradient, or None

    @property
    def dtype(self):
        return self.mat_color.dtype


def quantize(image, device, dtype):
    """An image as a texture holds it: (H, W, 4) in [0, 1], from a float
    image in [0, 1] scaled by 255 and truncated to whole levels, grey
    as RGB, a missing alpha opaque."""
    img = torch.as_tensor(image, dtype=torch.float64, device=device)
    img = torch.floor(torch.clamp(img * 255.0, 0.0, 255.0)) / 255.0
    if img.dim() == 2:
        img = img[..., None]
    if img.shape[-1] == 1:
        img = img.expand(img.shape[:2] + (3,))
    if img.shape[-1] == 3:
        img = torch.cat([img, torch.ones_like(img[..., :1])], -1)
    return img.to(dtype)


def reference_scene(raw: dict, config: dict, device, dtype) -> TexScene:
    """The scene from the raw inputs and the configuration.  Material
    order: terrain, the glass spheres', amber, mirror, light; a
    material key left out takes ``SceneBuilder.add_material``'s default."""
    def ten(x, dt=dtype):
        return torch.as_tensor(x, device=device).to(dt)

    order = config["texture_order"]
    tex = torch.stack([quantize(raw["textures"][n], device, dtype)
                       for n in order])
    tid = {n: i for i, n in enumerate(order)}
    light = config["light"]
    mats = ([(config["terrain_material"], config["terrain_maps"])]
            + [(m, config["glass_maps"].get(str(i), {}))
               for i, m in enumerate(config["glass_materials"])]
            + [(config["amber_material"], config["amber_maps"]),
               (config["mirror_material"], config["mirror_maps"]),
               (dict(color=light["color"], emission=light["intensity"]), {})])

    def col(key, default):
        return ten([m.get(key, default) for m, _ in mats])

    n_glass = len(config["glass_spheres"])
    glass, amber, mirror, lamp = 1, 1 + n_glass, 2 + n_glass, 3 + n_glass
    verts = torch.as_tensor(raw["vertices"], device=device)
    uvs = torch.as_tensor(raw["uvs"], device=device)
    faces = torch.as_tensor(raw["faces"], device=device).long()
    (c_ell, r_ell), plane = config["ellipsoid"], config["mirror_plane"]
    info = config["info"]
    return TexScene(
        mat_color=ten([list(m["color"]) if "color" in m
                       else [0.8, 0.8, 0.8, 1.0] for m, _ in mats]),
        mat_specular=col("specular", 0.0),
        mat_power=col("specular_power", 50.0),
        mat_reflection=col("reflection", 0.0),
        mat_transparency=col("transparency", 0.0),
        mat_ior=col("ior", 1.0),
        mat_emission=col("emission", 0.0),
        mat_tex={s: torch.tensor([tid[maps[f"texture_{s}"]]
                                  if f"texture_{s}" in maps else -1
                                  for _, maps in mats], device=device)
                 for s in _SLOTS},
        tex=tex,
        sph_center=ten([c for c, _ in config["glass_spheres"]]
                       + [light["position"]]),
        sph_radius=ten([r for _, r in config["glass_spheres"]]
                       + [light["radius"]]),
        sph_material=torch.tensor(list(range(glass, glass + n_glass))
                                  + [lamp], device=device),
        tri_v0=verts[faces[:, 0]].to(dtype),
        tri_v1=verts[faces[:, 1]].to(dtype),
        tri_v2=verts[faces[:, 2]].to(dtype),
        tri_uv0=uvs[faces[:, 0]].to(dtype),
        tri_uv1=uvs[faces[:, 1]].to(dtype),
        tri_uv2=uvs[faces[:, 2]].to(dtype),
        tri_material=torch.zeros(faces.shape[0], dtype=torch.int64,
                                 device=device),
        ell_center=ten([c_ell]), ell_radii=ten([r_ell]),
        ell_material=torch.tensor([amber], device=device),
        pl_axis=torch.tensor(["YZ", "XZ", "XY"].index(plane["axis"]),
                             device=device)[None],
        pl_origin=ten([plane["origin"]]),
        pl_half=ten([plane["half_extents"]]),
        pl_material=torch.tensor([mirror], device=device),
        light_position=ten([light["position"]]),
        light_color=ten([light["color"][:3]]) * light["intensity"],
        light_radius=ten([light["radius"]]),
        ambient=float(info["ambient"]),
        shadow_intensity=float(info["shadow_intensity"]),
        soft_shadow_radius=float(info["soft_shadow_radius"]),
        fog_start=float(info["fog_start"]),
        view_distance=float(info["view_distance"]),
        background=ten(info["background_color"][:3]),
        sky=((ten(info["gradient_sky_horizon"][:3]),
              ten(info["gradient_sky_zenith"][:3]))
             if config["gradient_background"] else None))


# ---- the pools ----

def ellipsoid_t(o, d, center, radii):
    """Distances (A, E) of rays o, d (A, 3) to axis-aligned ellipsoids,
    scaled to the unit sphere, t along the world-space ray: the smallest
    t > RAY_EPS, else inf."""
    inv_r = 1.0 / torch.clamp(radii, min=1e-8)
    oc = (o[:, None] - center) * inv_r
    dd = d[:, None] * inv_r
    a = dot(dd, dd)
    b = dot(oc, dd)
    disc = b * b - a * (dot(oc, oc) - 1.0)
    ok = (disc > 0.0) & (radii > 0.0).all(-1)
    sq = torch.sqrt(torch.where(ok, disc, torch.ones_like(disc)))
    a = torch.clamp(a, min=1e-8)
    inf = torch.full_like(disc, float("inf"))
    near, far = (-b - sq) / a, (-b + sq) / a
    return torch.minimum(torch.where(ok & (near > RAY_EPS), near, inf),
                         torch.where(ok & (far > RAY_EPS), far, inf))


def _in_plane(axis):
    """The two axes of planes normal to ``axis``, ascending: (P, 2)."""
    return torch.tensor([[1, 2], [0, 2], [0, 1]], device=axis.device)[axis]


def _bound_slot(axis):
    """Which half extent bounds each in-plane axis of planes normal to
    ``axis`` in the renderer: the first for an axis below the normal
    axis, the second above it (so an XY plane's y takes the first, as
    its x does, and a YZ plane's y the second): (P, 2)."""
    return (_in_plane(axis) > axis[:, None]).long()


def plane_t(o, d, axis, origin, half):
    """Distances (A, P) to axis-aligned rectangles, two-sided: normal to
    ``axis``, centred at ``origin``, bounded along the two other axes by
    the half extents ``half`` (P, 2) as :func:`_bound_slot` assigns
    them."""
    rows = torch.arange(axis.shape[0], device=axis.device)
    d_n = d[:, axis]
    along = d_n.abs() > 1e-8
    t = (origin[rows, axis] - o[:, axis]) / torch.where(
        along, d_n, torch.ones_like(d_n))
    ok = along & (half > 0.0).all(-1) & (t > RAY_EPS)
    for k in range(2):
        ax = _in_plane(axis)[:, k]
        dev = (o[:, ax] + t * d[:, ax] - origin[rows, ax]).abs()
        ok = ok & (dev <= half[rows, _bound_slot(axis)[:, k]])
    return torch.where(ok, t, torch.full_like(t, float("inf")))


class Scene:
    """A TexScene with its pools: the triangles culled by blocks, the
    spheres, ellipsoids and planes by brute force."""

    def __init__(self, s: TexScene):
        self.s = s
        v0, v1, v2 = s.tri_v0, s.tri_v1, s.tri_v2
        self.triangles = Pool(
            TRIANGLE, {"v0": v0, "e1": v1 - v0, "e2": v2 - v0},
            s.tri_material, torch.minimum(torch.minimum(v0, v1), v2),
            torch.maximum(torch.maximum(v0, v1), v2), s)

    def factor(self, material):
        """Each primitive's share of light let through: its transparency,
        1 for a light."""
        s = self.s
        return torch.where(s.mat_emission[material] > 0.0,
                           torch.ones_like(s.mat_transparency[material]),
                           s.mat_transparency[material])

    def _analytic(self, o, d):
        """(pool code, distances (A, N), materials (N,)) of the pools
        taken by brute force."""
        s = self.s
        return ((SPHERE, sphere_t(o[:, None], d[:, None], s.sph_center,
                                  s.sph_radius), s.sph_material),
                (ELLIPSOID, ellipsoid_t(o, d, s.ell_center, s.ell_radii),
                 s.ell_material),
                (PLANE, plane_t(o, d, s.pl_axis, s.pl_origin, s.pl_half),
                 s.pl_material))

    def closest(self, o, d):
        """(t, pool code, index): T_FAR and -1 on a miss."""
        best = torch.full(o.shape[:1], T_FAR, dtype=o.dtype, device=o.device)
        code = torch.full(o.shape[:1], -1, dtype=torch.int64, device=o.device)
        idx = torch.zeros(o.shape[:1], dtype=torch.int64, device=o.device)
        sph, ell, pl = self._analytic(o, d)
        found = [(SPHERE, *sph[1].min(1)),
                 (TRIANGLE, *self.triangles.closest(o, d)),
                 (ELLIPSOID, *ell[1].min(1)), (PLANE, *pl[1].min(1))]
        for kind, t, i in found:
            better = t < best
            best = torch.where(better, t, best)
            code = torch.where(better, torch.full_like(code, kind), code)
            idx = torch.where(better, i, idx)
        return best, code, idx

    def transmittance(self, o, d, t_max):
        trans = self.triangles.transmittance(o, d, t_max)
        for _, t, mat in self._analytic(o, d):
            occ = t < t_max[:, None]
            f = torch.where(occ, self.factor(mat)[None], torch.ones_like(t))
            trans = trans * f.prod(1)
        return trans


# ---- textures ----

def luminance(rgba):
    return 0.299 * rgba[..., 0] + 0.587 * rgba[..., 1] + 0.114 * rgba[..., 2]


def sample(tex, tid, uv):
    """Bilinear RGBA (R, 4) of textures ``tid`` (R,) at ``uv`` (R, 2),
    wrapped (repeat addressing); white where tid is -1."""
    h, w = tex.shape[1], tex.shape[2]
    u = uv[:, 0] - torch.floor(uv[:, 0])
    v = uv[:, 1] - torch.floor(uv[:, 1])
    x = u * w - 0.5
    y = v * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]
    xi, yi = x0.long(), y0.long()
    t = tid.clamp(min=0)

    def texel(dx, dy):
        return tex[t, torch.remainder(yi + dy, h), torch.remainder(xi + dx, w)]

    rgba = ((texel(0, 0) * (1 - fx) + texel(1, 0) * fx) * (1 - fy)
            + (texel(0, 1) * (1 - fx) + texel(1, 1) * fx) * fy)
    return torch.where((tid >= 0)[:, None], rgba, torch.ones_like(rgba))


def map_scale(s: TexScene, slot: str, mat, uv):
    """The luminance of the material's map in ``slot`` at uv, 1 where
    the material has none."""
    tid = s.mat_tex[slot][mat]
    return torch.where(tid >= 0, luminance(sample(s.tex, tid, uv)),
                       torch.ones_like(uv[:, 0]))


def tangent_basis(n):
    """(tangent, bitangent) of unit normals: Frisvad's frame with the
    sign fix."""
    nx, ny, nz = n[:, 0], n[:, 1], n[:, 2]
    sign = torch.where(nz >= 0.0, torch.ones_like(nz), -torch.ones_like(nz))
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], -1)
    bt = torch.stack([b, sign + ny * ny * a, -ny], -1)
    return t, bt


def mapped_normals(s: TexScene, mat, uv, n):
    """The shading normals n tilted by the materials' bump maps, else
    their normal maps."""
    tn, tb = s.mat_tex["normal"][mat], s.mat_tex["bump"][mat]
    out = n
    rows = ((tn >= 0) | (tb >= 0)).nonzero()[:, 0]
    if not rows.numel():
        return out
    n, uv, tn, tb = n[rows], uv[rows], tn[rows], tb[rows]
    t, bt = tangent_basis(n)
    rgb = sample(s.tex, tn, uv)[:, :3] * 2.0 - 1.0
    mapped = normalize(rgb[:, 0:1] * t + rgb[:, 1:2] * bt + rgb[:, 2:3] * n)
    du = 1.0 / s.tex.shape[2]
    dv = 1.0 / s.tex.shape[1]

    def height(du_, dv_):
        step = torch.tensor([du_, dv_], dtype=uv.dtype, device=uv.device)
        return luminance(sample(s.tex, tb, uv + step))

    gu = (height(du, 0.0) - height(-du, 0.0)) / (2.0 * du)
    gv = (height(0.0, dv) - height(0.0, -dv)) / (2.0 * dv)
    bumped = normalize(n - BUMP_STRENGTH * (gu[:, None] * t
                                            + gv[:, None] * bt))
    mapped = torch.where((tb >= 0)[:, None], bumped,
                         torch.where((tn >= 0)[:, None], mapped, n))
    return out.index_put((rows,), mapped)


def spherical_uv(n):
    """Longitude and latitude of a direction, off the poles by 1e-6."""
    eps = 1e-6
    x, y, z = n[:, 0], n[:, 1], n[:, 2]
    pole = (x.abs() < eps) & (z.abs() < eps)
    e = torch.full_like(x, eps)
    u = 0.5 + torch.atan2(torch.where(pole, e, z),
                          torch.where(pole, e, x)) / (2.0 * math.pi)
    v = 0.5 - torch.asin(torch.clamp(y, -1.0 + eps, 1.0 - eps)) / math.pi
    return torch.stack([u, v], -1)


# ---- the bounce loop ----

def surface(s: TexScene, o, d, t, code, idx):
    """(point, geometric normal, shading normal, uv, material, backface)
    at the hits; the normals oppose the ray."""
    p = o + t[:, None] * d
    n_geo = torch.zeros_like(p)
    uv = torch.zeros_like(p[:, :2])
    mat = torch.zeros_like(idx)
    n_sh = n_geo
    for kind in (SPHERE, TRIANGLE, ELLIPSOID, PLANE):
        rows = (code == kind).nonzero()[:, 0]
        if not rows.numel():
            continue
        i, q = idx[rows], p[rows]
        if kind == SPHERE:
            n = normalize((q - s.sph_center[i])
                          / torch.clamp(s.sph_radius[i], min=1e-6)[:, None])
            sn, uvk, m = n, spherical_uv(n), s.sph_material[i]
        elif kind == TRIANGLE:
            v0 = s.tri_v0[i]
            e1, e2 = s.tri_v1[i] - v0, s.tri_v2[i] - v0
            n = normalize(cross(e1, e2))
            dd, sv = d[rows], o[rows] - v0
            pv = cross(dd, e2)
            inv = 1.0 / dot(pv, e1)
            bu = dot(sv, pv) * inv
            bv = dot(dd, cross(sv, e1)) * inv
            uvk = ((1.0 - bu - bv)[:, None] * s.tri_uv0[i]
                   + bu[:, None] * s.tri_uv1[i] + bv[:, None] * s.tri_uv2[i])
            sn, m = n, s.tri_material[i]
        elif kind == ELLIPSOID:
            rad = torch.clamp(s.ell_radii[i], min=1e-6)
            local = (q - s.ell_center[i]) / rad
            n = normalize(local / rad)
            sn, uvk, m = n, spherical_uv(local), s.ell_material[i]
        else:
            ax = s.pl_axis[i]
            n = torch.eye(3, dtype=p.dtype, device=p.device)[ax]
            pu = torch.gather(q - s.pl_origin[i], 1, _in_plane(ax))
            uvk = 0.5 + 0.5 * pu / torch.clamp(s.pl_half[i], min=1e-6)
            sn, m = n, s.pl_material[i]
        n_geo = n_geo.index_put((rows,), n)
        n_sh = n_sh.index_put((rows,), sn)
        uv = uv.index_put((rows,), uvk)
        mat = mat.index_put((rows,), m)
    n_sh = mapped_normals(s, mat, uv, n_sh)
    back = dot(d, n_geo) > 0.0
    one = torch.ones_like(t)
    n_geo = n_geo * torch.where(back, -one, one)[:, None]
    n_sh = n_sh * torch.where(dot(d, n_sh) > 0.0, -one, one)[:, None]
    return p, n_geo, n_sh, uv, mat, back


def shade(sc: Scene, p, n_geo, n_sh, uv, mat, view, jitter):
    """Local shading (A, 3).  ``jitter`` (S, A, L, 3), points of the
    unit ball for S soft-shadow samples, or None for one hard sample."""
    s = sc.s
    albedo = s.mat_color[mat][:, :3] * sample(
        s.tex, s.mat_tex["diffuse"][mat], uv)[:, :3]
    out = albedo * (s.ambient + s.mat_emission[mat])[:, None]
    lpos = s.light_position[None, None]  # (1, 1, L, 3)
    if jitter is not None:
        lpos = lpos + jitter * (s.light_radius[:, None]
                                * s.soft_shadow_radius)
    lpos = lpos.expand(-1, p.shape[0], -1, -1)  # (S, A, L, 3)
    to_l = lpos - p[None, :, None]
    dist = torch.sqrt(torch.clamp(dot(to_l, to_l), min=1e-12))
    ldir = to_l / dist[..., None]
    ndotl = torch.clamp(dot(n_sh[None, :, None], ldir), 0.0, 1.0)
    rdotl = torch.clamp(dot(reflect(view, n_sh)[None, :, None], ldir),
                        0.0, 1.0)
    ks = s.mat_specular[mat] * map_scale(s, "specular", mat, uv)
    spec = ks[None, :, None] * torch.pow(
        rdotl, torch.clamp(s.mat_power[mat], min=1.0)[None, :, None])
    origin = (p + n_geo * (4.0 * RAY_EPS))[None, :, None].expand_as(ldir)
    trans = sc.transmittance(origin.reshape(-1, 3), ldir.reshape(-1, 3),
                             (dist - RAY_EPS).reshape(-1))
    shadow = 1.0 - s.shadow_intensity * (1.0 - trans.reshape(dist.shape))
    direct = ((albedo[None, :, None] * ndotl[..., None] + spec[..., None])
              * s.light_color * shadow[..., None]).sum(2)
    return out + direct.sum(0) / lpos.shape[0]


def background(s: TexScene, d, sky_id: int):
    if sky_id >= 0:
        tid = torch.full(d.shape[:1], sky_id, dtype=torch.int64,
                         device=d.device)
        return sample(s.tex, tid, spherical_uv(d))[:, :3]
    if s.sky is None:
        return s.background.expand(d.shape[0], 3)
    horizon, zenith = s.sky
    t = torch.clamp(0.5 + 0.5 * d[:, 1], 0.0, 1.0)[:, None]
    return (1.0 - t) * horizon + t * zenith


def refract(d, n, eta):
    """Snell refraction of unit d about n (opposing d), eta = n_i / n_t;
    the mirror direction under total internal reflection."""
    eta = eta[:, None]
    cos_i = -dot(d, n)[:, None]
    sin2 = eta * eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    tir = sin2 > 1.0
    cos_t = torch.sqrt(torch.where(tir, torch.ones_like(sin2), 1.0 - sin2))
    out = torch.where(tir, reflect(d, n), eta * d + (eta * cos_i - cos_t) * n)
    return normalize(out)


def trace(sc: Scene, o, d, pix, settings: dict, jitters):
    """RGB (C, 3) and primary-hit depth (C,) of the rays o, d of pixels
    ``pix``; ``jitters[b]`` the soft-shadow draws of bounce b over the
    whole frame (S, pixels, L, 3), or None."""
    s = sc.s
    n = o.shape[0]
    color = torch.zeros((n, 3), dtype=o.dtype, device=o.device)
    depth = torch.full((n,), T_FAR, dtype=o.dtype, device=o.device)
    thru = torch.ones_like(color)
    dist0 = torch.zeros_like(depth)
    ids = torch.arange(n, device=o.device)
    sky_id = int(settings.get("sky_texture", -1))
    span = max(s.view_distance - s.fog_start, 1e-3)
    for b, jit in enumerate(jitters):
        if not ids.numel():
            break
        t, code, idx = sc.closest(o, d)
        hit = t < T_FAR * 0.5
        if b == 0:
            depth = t
        miss = (~hit).nonzero()[:, 0]
        color = color.index_add(0, ids[miss], thru[miss]
                                * background(s, d[miss], sky_id))
        h = hit.nonzero()[:, 0]
        o, d, t, code, idx, thru, ids, dist0 = (
            x[h] for x in (o, d, t, code, idx, thru, ids, dist0))
        p, n_geo, n_sh, uv, mat, back = surface(s, o, d, t, code, idx)
        local = shade(sc, p, n_geo, n_sh, uv, mat, d,
                      None if jit is None else jit[:, pix[ids]])
        w_refr = s.mat_transparency[mat] * map_scale(s, "transparency", mat,
                                                      uv)
        w_refl = s.mat_reflection[mat] * map_scale(s, "reflection", mat, uv)
        refr = w_refr > 1e-4
        w = torch.where(refr, w_refr, w_refl)
        own = 1.0 - w
        if settings.get("fog", False):
            dist0 = dist0 + t
            own = own * torch.clamp(1.0 - (dist0 - s.fog_start) / span,
                                    0.0, 1.0)
        color = color.index_add(0, ids, thru * own[:, None] * local)
        ior = s.mat_ior[mat]
        eta = torch.where(back, ior, 1.0 / torch.clamp(ior, min=1e-3))
        nd = torch.where(refr[:, None], refract(d, n_sh, eta),
                         normalize(reflect(d, n_sh)))
        tint = torch.where(refr[:, None], s.mat_color[mat][:, :3] * 0.98
                           + 0.02, torch.ones_like(local))
        thru = thru * w[:, None] * tint
        live = (w > 1e-4) & (thru.amax(-1) > MIN_THROUGHPUT)
        o = (p + nd * (4.0 * RAY_EPS))[live]
        d, thru, ids, dist0 = nd[live], thru[live], ids[live], dist0[live]
    return color, depth


def camera_rays(camera: dict, width: int, height: int, pix, jitter, dtype):
    """Pinhole rays through pixels ``pix`` (row-major ids) moved by
    ``jitter`` (A, 2) within the pixel: the image plane spans [-aspect,
    aspect] x [1, -1] at tan(fov / 2), camera space looks down +z and
    ``angles`` rotate it into the world."""
    dev = pix.device
    x = (pix % width).to(dtype) + 0.5 + jitter[:, 0]
    y = (pix // width).to(dtype) + 0.5 + jitter[:, 1]
    u = (2.0 * x / width - 1.0) * (width / height)
    v = 1.0 - 2.0 * y / height
    scale = torch.tan(torch.tensor(0.5 * camera["fov"], dtype=dtype,
                                   device=dev))
    d = torch.stack([u * scale, v * scale, torch.ones_like(u)], -1)
    d = normalize(rotate_euler(d, torch.tensor(camera["angles"], dtype=dtype,
                                               device=dev)))
    o = torch.tensor(camera["position"], dtype=dtype, device=dev).expand_as(d)
    return o, d


def ao_taps(samples: int, radius: float) -> list:
    """(dy, dx) pixel offsets of the golden-angle spiral over the disk of
    ``radius``, rounded half to even."""
    golden = math.pi * (3.0 - math.sqrt(5.0))
    taps = []
    for i in range(samples):
        r = math.sqrt((i + 0.5) / samples) * radius
        a = (i + 0.5) * golden
        taps.append((round(r * math.sin(a)), round(r * math.cos(a))))
    return taps


def ambient_occlusion(img, depth, strength: float, samples: int):
    """img (H, W, 3) darkened by ``strength`` times the share of the
    taps whose depth is closer by over 5% of the pixel's."""
    h, w = depth.shape
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    occ = torch.zeros_like(depth)
    for dy, dx in ao_taps(samples, AO_RADIUS):
        dz = depth[(ys + dy).clamp(0, h - 1), (xs + dx).clamp(0, w - 1)]
        occ = occ + ((depth - dz) > 0.05 * depth.abs()).to(img.dtype)
    return img * torch.clamp(1.0 - strength * (occ / samples), 0.0,
                             1.0)[..., None]


def render(scene: TexScene, camera: dict, workload: dict, settings: dict,
           seed):
    """RGB (H, W, 3) of the frame: ``workload``'s size, bounces, ``spp``
    and ``keyed``, the configuration's ``render`` settings, keyed by
    ``Key.seed(seed)`` where the workload is keyed."""
    if settings.get("camera_mode", "MONO") != "MONO":
        raise NotImplementedError("only the MONO camera")
    width, height = workload["width"], workload["height"]
    dev, dtype = scene.mat_color.device, scene.dtype
    npx = width * height
    key = Key.seed(seed, dev) if workload.get("keyed", False) else None
    spp = workload.get("spp", 1)
    keys = [key] if key is None or spp <= 1 else key.split(spp)
    soft = settings.get("shadows", True) and settings.get(
        "shadow_samples", 1) > 1 and key is not None
    if not settings.get("shadows", True):
        raise NotImplementedError("shadows are always traced")
    sc = Scene(scene)
    n_l = scene.light_position.shape[0]
    img = torch.zeros((npx, 3), dtype=dtype, device=dev)
    depth = None
    for k in keys:
        if k is not None and settings.get("antialias_jitter", False):
            jitter = k.split(2)[0].uniform((npx, 2)).to(dtype) - 0.5
        else:
            jitter = torch.zeros((npx, 2), dtype=dtype, device=dev)
        jitters = []
        for bk in ([None] * workload["bounces"] if k is None
                   else k.split(workload["bounces"])):
            if not soft:
                jitters.append(None)
                continue
            k_dir, k_rad = bk.split(2)
            shape = (settings["shadow_samples"], npx, n_l)
            v = k_dir.normal(shape + (3,)).to(dtype)
            v = v / torch.sqrt(torch.clamp(dot(v, v), min=1e-12))[..., None]
            jitters.append(v * k_rad.uniform(shape + (1,)).to(dtype)
                           ** (1.0 / 3.0))
        first = torch.empty((npx,), dtype=dtype, device=dev)
        for c0 in range(0, npx, CHUNK):
            pix = torch.arange(c0, min(npx, c0 + CHUNK), device=dev)
            o, d = camera_rays(camera, width, height, pix, jitter[pix], dtype)
            rgb, t0 = trace(sc, o, d, pix, settings, jitters)
            img[c0:c0 + pix.shape[0]] += rgb
            first[c0:c0 + pix.shape[0]] = t0
        depth = first if depth is None else depth
    img = (img / len(keys)).reshape(height, width, 3)
    if settings.get("postfx", "NONE") == "AMBIENT_OCCLUSION":
        img = ambient_occlusion(img, depth.reshape(height, width),
                                scene.shadow_intensity,
                                settings.get("postfx_samples", AO_SAMPLES))
    elif settings.get("postfx", "NONE") != "NONE":
        raise NotImplementedError(settings["postfx"])
    return img

"""The render loop: bounce chain, background, accumulation (counterpart
of solr_tpu/ops/render.py).  The reference's ``lax.scan`` over bounces
is a Python loop here."""

from __future__ import annotations

import torch

from solr_tpu_torch.constants import PARK_DIR, PARK_POS, RAY_EPS
from solr_tpu_torch.ops import textures as tex_ops
from solr_tpu_torch.ops.camera import camera_rays
from solr_tpu_torch.ops.packet import tile_permutation
from solr_tpu_torch.ops.shade import phong_shade
from solr_tpu_torch.ops.traverse import (_spatial_keys, scene_closest_hit,
                                         surface_at)
from solr_tpu_torch.ops.vecmath import normalize, reflect, refract
from solr_tpu_torch.types import Camera, RenderConfig, Scene

__all__ = ["render_sample", "trace_rays", "trace_rays_tiled",
           "background_color", "accumulate"]

_MIN_THROUGHPUT = 1e-3


def _compact_perm(live, key=None):
    """Live-first compaction permutation: ``x[perm]`` packs live rays to
    the front and ``y[target]`` undoes it.

    With ``key`` (R,), 32-ray groups are sorted (stable) by their
    smallest live key, so the leading tiles stay spatially tight;
    all-dead groups key to +inf and sink to the back."""
    r = live.shape[0]
    ar = torch.arange(r, device=live.device)
    if key is None:
        li = live.to(torch.int64)
        n_live = li.sum()
        target = torch.where(live, li.cumsum(0) - 1, n_live + (1 - li).cumsum(0) - 1)
        perm = torch.empty_like(ar)
        perm[target] = ar
        return perm, target
    grp = 32 if r % 32 == 0 else 1
    sort_key = torch.where(live, key.to(torch.float32),
                           torch.full((r,), float("inf"), device=live.device))
    gkey = sort_key.reshape(-1, grp).amin(1)
    gperm = torch.argsort(gkey, stable=True)
    perm = (gperm[:, None] * grp
            + torch.arange(grp, device=live.device)[None]).reshape(-1)
    target = torch.empty_like(ar)
    target[perm] = ar
    return perm, target


def background_color(scene: Scene, cfg: RenderConfig, d):
    """Miss radiance: vertical gradient or solid color."""
    info = scene.info
    if cfg.gradient_background:
        t = torch.clamp(0.5 + 0.5 * d[..., 1], 0.0, 1.0)[..., None]
        return (1.0 - t) * info.gradient_sky_horizon + t * info.gradient_sky_zenith
    return info.background_color.expand(d.shape[:-1] + (4,))


def trace_rays(scene: Scene, o, d, cfg: RenderConfig, packet=None):
    """Trace a flat ray batch through the bounce chain.  With ``packet``
    the rays must come in tile-coherent groups (trace_rays_tiled).
    Returns (color (R, 4), primary hit distance (R,))."""
    r = o.shape[0]
    mats = scene.materials
    thru = torch.ones((r, 4), dtype=o.dtype, device=o.device)
    color = torch.zeros((r, 4), dtype=o.dtype, device=o.device)
    live = torch.ones((r,), dtype=torch.bool, device=o.device)
    primary_t = None
    for _ in range(cfg.max_bounces):
        target = None
        if packet is not None and cfg.compact_rays:
            # Wavefront compaction: live rays first, in Morton order of
            # their origins; dead rays park where every cull rejects.
            with torch.no_grad():
                o_sg = o.detach()
                lv = live[:, None]
                omin = torch.where(lv, o_sg, torch.full_like(o_sg, float("inf"))).amin(0)
                omax = torch.where(lv, o_sg, torch.full_like(o_sg, float("-inf"))).amax(0)
                perm, target = _compact_perm(live, _spatial_keys(o_sg, omin, omax))
            o, d, thru, color, live = (o[perm], d[perm], thru[perm],
                                       color[perm], live[perm])
            park = ~live[..., None]
            o = torch.where(park, torch.full_like(o, PARK_POS), o)
            d = torch.where(park, torch.full_like(d, PARK_DIR), d)

        hit = scene_closest_hit(scene, o, d, packet=packet)
        valid = hit.valid & live
        surf = surface_at(scene, hit, o, d)
        local = phong_shade(scene, surf, d, cfg, packet=packet)

        m = surf.material
        _, refl_scale, trans_scale = tex_ops.material_map_scales(scene, m, surf.uv)
        w_refr = mats.transparency[m] * trans_scale
        w_refl = mats.reflection[m] * refl_scale
        has_refr = w_refr > 1e-4
        w = torch.where(has_refr, w_refr, w_refl)
        own = 1.0 - w

        contrib = thru * own[..., None] * local
        color = color + torch.where(valid[..., None], contrib,
                                    torch.zeros_like(contrib))
        missed = live & ~hit.valid
        bg = thru * background_color(scene, cfg, d)
        color = color + torch.where(missed[..., None], bg, torch.zeros_like(bg))

        # Continuation: refract if transparent, else reflect.
        n = surf.shading_normal
        ior = mats.ior[m]
        eta = torch.where(surf.backface, ior, 1.0 / torch.clamp(ior, min=1e-3))
        refr_d, _ = refract(d, n, eta)
        nd = normalize(torch.where(has_refr[..., None], refr_d, reflect(d, n)))
        no = surf.point + nd * (RAY_EPS * 4.0)
        tint = torch.where(has_refr[..., None], mats.color[m] * 0.98 + 0.02,
                           torch.ones_like(local))
        thru = thru * w[..., None] * tint
        live = valid & (w > 1e-4) & (thru[..., :3].amax(-1) > _MIN_THROUGHPUT)
        o = torch.where(live[..., None], no, o)
        d = torch.where(live[..., None], nd, d)
        t_out = hit.t
        if target is not None:  # undo the compaction permutation
            o, d, thru, color, live, t_out = (
                x[target] for x in (o, d, thru, color, live, t_out))
        if primary_t is None:
            primary_t = t_out
    color = torch.cat([color[..., :3], torch.ones_like(color[..., 3:])], -1)
    return color, primary_t


def trace_rays_tiled(scene: Scene, o, d, cfg: RenderConfig):
    """Trace a row-major pixel block with the packet tile swizzle when
    the scene and frame allow it."""
    n = o.shape[0]
    if scene.tri_accel is None or n % cfg.width != 0:
        return trace_rays(scene, o, d, cfg)
    h_loc = n // cfg.width
    if cfg.width % cfg.packet_tile_w or h_loc % cfg.packet_tile_h:
        return trace_rays(scene, o, d, cfg)
    spec = (cfg.packet_rays, cfg.packet_max_blocks, cfg.packet_tile_cand,
            cfg.packet_exact)
    perm, inv = tile_permutation(cfg.width, h_loc, cfg.packet_tile_w,
                                 cfg.packet_tile_h)
    perm = torch.as_tensor(perm, device=o.device)
    inv = torch.as_tensor(inv, device=o.device)
    color, t = trace_rays(scene, o[perm], d[perm], cfg, packet=spec)
    return color[inv], t[inv]


def render_sample(scene: Scene, camera: Camera, cfg: RenderConfig):
    """One sample: (image (H, W, 4), depth (H, W))."""
    o, d = camera_rays(camera, cfg)
    color, t = trace_rays_tiled(scene, o, d, cfg)
    return color.reshape(cfg.height, cfg.width, 4), t.reshape(cfg.height, cfg.width)


def accumulate(accum, sample, iteration):
    """Progressive-refinement running average."""
    it = torch.as_tensor(iteration, dtype=sample.dtype, device=sample.device)
    return (accum * it + sample) / (it + 1.0)

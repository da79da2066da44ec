"""Local shading: Phong lighting with hard or soft shadows, textures and
emission (counterpart of solr_tpu/ops/shade.py).  Soft shadows jitter
the light within its radius, one draw per shadow sample, and need a
key: without one, ``shadow_samples > 1`` renders hard shadows, as in
the reference (shade.py:99)."""

from __future__ import annotations

import torch

from solr_tpu_torch.constants import PARK_DIR, PARK_POS, RAY_EPS
from solr_tpu_torch.ops import textures as tex_ops
from solr_tpu_torch.ops.traverse import SurfaceInfo, scene_transmittance
from solr_tpu_torch.ops.vecmath import dot, reflect
from solr_tpu_torch.types import RenderConfig, Scene
from solr_tpu_torch.utils.profiling import render_phase

__all__ = ["surface_albedo", "phong_shade", "ball_jitter", "cbrt"]


def cbrt(u):
    """Real cube root of u >= 0.  PyTorch has no cbrt: u^(1/3) in
    float64, rounded to u's dtype (ROADMAP C11)."""
    return torch.pow(u.double(), 1.0 / 3.0).to(u.dtype)


def ball_jitter(key, shape, dtype):
    """Uniform samples in the closed unit ball, shape + (3,): a
    normal-distributed direction times a cbrt(u) radius, so the jittered
    light stays within its extent."""
    k_dir, k_rad = key.split(2)
    v = k_dir.normal(tuple(shape) + (3,), dtype)
    v = v / torch.sqrt(torch.clamp(dot(v, v, keepdim=True), min=1e-12))
    return v * cbrt(k_rad.uniform(tuple(shape) + (1,), dtype))


def surface_albedo(scene: Scene, surf: SurfaceInfo):
    """Material color at the hit, replaced by its procedural texture and
    multiplied by its diffuse texture where it has one."""
    mats = scene.materials
    m = surf.material
    color = tex_ops.procedural_color(mats.procedural[m],
                                     mats.procedural_scale[m], surf.uv,
                                     mats.color[m])
    if scene.textures.count > 0:
        tid = mats.texture_diffuse[m]
        sampled = tex_ops.sample_texture(scene.textures, tid, surf.uv)
        color = torch.where((tid >= 0)[..., None], sampled * color, color)
    return color


def phong_shade(scene: Scene, surf: SurfaceInfo, view_dir, cfg: RenderConfig,
                key=None, packet=None):
    """Direct lighting at the hit points, (R, 4):

      emission * albedo + ambient * albedo
      + sum_l shadow_l * lcol_l * (albedo * max(0, n.l) + ks * max(0, r.l)^p)

    with shadow_l = 1 - shadow_intensity * (1 - transmittance_l).  With
    soft shadows (``cfg.shadow_samples`` S > 1 and a key) each of the S
    samples jitters every light within its radius times
    ``soft_shadow_radius``, traces its own shadow rays, and the direct
    term is the mean of the S samples.
    """
    with render_phase("shade"):
        info = scene.info
        mats = scene.materials
        m = surf.material
        albedo = surface_albedo(scene, surf)
        spec_scale, _, _ = tex_ops.material_map_scales(scene, m, surf.uv)
        n = surf.shading_normal
        p = surf.point

        out = albedo * (info.ambient + mats.emission[m][..., None])

        lights = scene.lights
        n_lights = lights.position.shape[0]
        if n_lights > 0:
            lpos = lights.position[None]  # (1, L, 3)
            if cfg.shadows and cfg.shadow_samples > 1 and key is not None:
                jit = ball_jitter(key, (cfg.shadow_samples,) + p.shape[:-1]
                                  + (n_lights,), p.dtype)
                lpos = (lpos[None] + jit * lights.radius[None, None, :, None]
                        * info.soft_shadow_radius)  # (S, R, L, 3)
            else:
                lpos = lpos.expand(p.shape[0], n_lights, 3)[None]

            # In the reference's op order: autograd sums the gradient parts
            # of a tensor used twice (n, p) in the reverse of that order, so
            # the order fixes the gradients' last bits.
            def one_sample(lp):
                to_l = lp - p[:, None, :]
                dist = torch.sqrt(torch.clamp(dot(to_l, to_l), min=1e-12))
                ldir = to_l / dist[..., None]
                # Clipped to [0, 1]: a masked miss lane's garbage must not
                # reach pow() (an inf forward value is a NaN backward).
                ndotl = torch.clamp(dot(n[:, None, :], ldir), 0.0, 1.0)
                refl = reflect(view_dir, n)
                rdotl = torch.clamp(dot(refl[:, None, :], ldir), 0.0, 1.0)
                spec_str = mats.specular[m][..., 0:1]
                spec_pow = torch.clamp(mats.specular[m][..., 1:2], min=1.0)
                spec = spec_str * spec_scale[..., None] * torch.pow(rdotl,
                                                                    spec_pow)
                if cfg.shadows:
                    origin = (p + surf.normal * (RAY_EPS * 4.0))[:, None, :] \
                        .expand_as(ldir)
                    # Shadow rays of miss lanes park far away pointing out of
                    # the scene, so their tiles cull to zero candidate blocks.
                    invalid = ~surf.valid[:, None, None]
                    origin = torch.where(invalid, torch.full_like(origin, PARK_POS),
                                         origin)
                    sdir = torch.where(invalid, torch.full_like(ldir, PARK_DIR),
                                       ldir)
                    t_max = dist - RAY_EPS
                    t_max = torch.where(invalid[..., 0], torch.ones_like(t_max),
                                        t_max)
                    trans = scene_transmittance(scene, origin, sdir, t_max,
                                                use_bvh=cfg.use_bvh,
                                                packet=packet)
                    shadow = 1.0 - info.shadow_intensity * (1.0 - trans)
                else:
                    shadow = torch.ones_like(ndotl)
                contrib = (albedo[:, None, :] * ndotl[..., None]
                           + spec[..., None]) * lights.color[None] \
                    * shadow[..., None]
                return contrib.sum(1)

            # One sample after another: each traces its own shadow rays.
            direct = one_sample(lpos[0])
            for i in range(1, lpos.shape[0]):
                direct = direct + one_sample(lpos[i])
            out = out + direct / lpos.shape[0]

        out = torch.where(surf.valid[..., None], out, torch.zeros_like(out))
        return torch.cat([out[..., :3], torch.ones_like(out[..., 3:])], -1)

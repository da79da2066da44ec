"""Local shading: Phong lighting with hard shadows (counterpart of
solr_tpu/ops/shade.py).  Soft shadows (``shadow_samples > 1``) are not
ported yet (ROADMAP A11) and raise."""

from __future__ import annotations

import torch

from solr_tpu_torch.constants import PARK_DIR, PARK_POS, RAY_EPS
from solr_tpu_torch.ops import textures as tex_ops
from solr_tpu_torch.ops.traverse import SurfaceInfo, scene_transmittance
from solr_tpu_torch.ops.vecmath import dot, reflect
from solr_tpu_torch.types import RenderConfig, Scene

__all__ = ["surface_albedo", "phong_shade"]


def surface_albedo(scene: Scene, surf: SurfaceInfo):
    """Material color at the hit, replaced by its procedural texture."""
    mats = scene.materials
    m = surf.material
    return tex_ops.procedural_color(mats.procedural[m],
                                    mats.procedural_scale[m], surf.uv,
                                    mats.color[m])


def phong_shade(scene: Scene, surf: SurfaceInfo, view_dir, cfg: RenderConfig,
                packet=None):
    """Direct lighting at the hit points, (R, 4):

      emission * albedo + ambient * albedo
      + sum_l shadow_l * lcol_l * (albedo * max(0, n.l) + ks * max(0, r.l)^p)

    with shadow_l = 1 - shadow_intensity * (1 - transmittance_l).
    """
    if cfg.shadows and cfg.shadow_samples > 1:
        raise NotImplementedError("soft shadows are not ported")
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
        lpos = lights.position[None].expand(p.shape[0], n_lights, 3)
        to_l = lpos - p[:, None, :]
        dist = torch.sqrt(torch.clamp(dot(to_l, to_l), min=1e-12))
        ldir = to_l / dist[..., None]
        ndotl = torch.clamp(dot(n[:, None, :], ldir), 0.0, 1.0)
        refl = reflect(view_dir, n)
        rdotl = torch.clamp(dot(refl[:, None, :], ldir), 0.0, 1.0)
        spec_str = mats.specular[m][..., 0:1]
        spec_pow = torch.clamp(mats.specular[m][..., 1:2], min=1.0)
        spec = spec_str * spec_scale[..., None] * torch.pow(rdotl, spec_pow)

        if cfg.shadows:
            origin = (p + surf.normal * (RAY_EPS * 4.0))[:, None, :].expand_as(ldir)
            # Shadow rays of miss lanes park far away pointing out of the
            # scene, so their tiles cull to zero candidate blocks.
            invalid = ~surf.valid[:, None, None]
            origin = torch.where(invalid, torch.full_like(origin, PARK_POS), origin)
            sdir = torch.where(invalid, torch.full_like(ldir, PARK_DIR), ldir)
            t_max = dist - RAY_EPS
            t_max = torch.where(invalid[..., 0], torch.ones_like(t_max), t_max)
            trans = scene_transmittance(scene, origin, sdir, t_max,
                                        packet=packet)
            shadow = 1.0 - info.shadow_intensity * (1.0 - trans)
        else:
            shadow = torch.ones_like(ndotl)

        contrib = (albedo[:, None, :] * ndotl[..., None] + spec[..., None]) \
            * lights.color[None] * shadow[..., None]
        out = out + contrib.sum(1)

    out = torch.where(surf.valid[..., None], out, torch.zeros_like(out))
    return torch.cat([out[..., :3], torch.ones_like(out[..., 3:])], -1)

"""The sweep and walk kernels at a frame's shapes, outside the frame: the
primary rays of a frame in tile order, their triangle hits, the shadow
rays toward the first light from their hits, the strip selection that
``render_sample`` would hand each sweep kernel, the first call a frame
makes of each walk kernel, a CUDA-event timer and nvcc's register
report.  Used by ``chip_smoke.py``, ``solr_tpu_torch.sweep_steps`` and
``solr_tpu_torch.walk_steps``."""

from __future__ import annotations

import re

import torch

from solr_tpu_torch.constants import PARK_DIR, PARK_POS, RAY_EPS, T_FAR
from solr_tpu_torch.ops import packet as pk
from solr_tpu_torch.ops.camera import camera_rays
from solr_tpu_torch.ops.traverse import (POOL_TRIANGLE, Hit, _scene_box,
                                         surface_at)

__all__ = ["first_walk_calls", "fractional", "primary_tiles",
           "ptxas_usage", "shadow_rays", "sweep_args", "time_ms",
           "triangle_hits"]


def primary_tiles(cam, cfg):
    """The frame's camera rays in packet tile order: (o_t, d_t) of shape
    (tiles, packet_rays, 3), and live (tiles, packet_rays), all True."""
    o, d = camera_rays(cam, cfg)
    perm, _ = pk.tile_permutation(cfg.width, cfg.height, cfg.packet_tile_w,
                                  cfg.packet_tile_h)
    perm = torch.as_tensor(perm, device=o.device)
    sb = cfg.packet_rays
    o_t, d_t = o[perm].reshape(-1, sb, 3), d[perm].reshape(-1, sb, 3)
    return o_t, d_t, torch.ones(o_t.shape[:2], dtype=torch.bool,
                                device=o.device)


def shadow_rays(scene, o_t, d_t, hit):
    """Shadow rays toward the first light from the hits ``hit`` of the
    tile-ordered rays, in the same tile order; misses park as on the
    main path.  Returns (so_t, sd_t, tm_t, live)."""
    r = o_t.shape[0] * o_t.shape[1]
    surf = surface_at(scene, hit, o_t.reshape(r, 3), d_t.reshape(r, 3))
    to_l = scene.lights.position[0] - surf.point
    dist = torch.sqrt(torch.clamp((to_l * to_l).sum(-1), min=1e-12))
    so = surf.point + surf.normal * (RAY_EPS * 4.0)
    sd = to_l / dist[:, None]
    bad = ~surf.valid[:, None]
    so = torch.where(bad, torch.full_like(so, PARK_POS), so)
    sd = torch.where(bad, torch.full_like(sd, PARK_DIR), sd)
    tm = torch.where(surf.valid, dist - RAY_EPS, torch.ones_like(dist))
    so_t, sd_t = so.reshape(o_t.shape), sd.reshape(o_t.shape)
    return so_t, sd_t, tm.reshape(o_t.shape[:2]), so_t[..., 0] < 1e7


def triangle_hits(t_t, idx_t):
    """The Hit of ``sweep_closest``'s per-tile (t, prim idx) over the
    triangle pool, flattened in tile order; a miss has pool -1."""
    t, idx = t_t.reshape(-1), idx_t.reshape(-1)
    return Hit(t=t, pool=torch.where(t < T_FAR * 0.5, POOL_TRIANGLE, -1)
               .to(torch.int32), idx=idx.clamp(min=0))


def fractional(packed, seed: int = 0):
    """``packed`` with its row-15 shadow factors drawn in [0.35, 0.95)."""
    frac = packed.clone()
    gen = torch.Generator(device=frac.device).manual_seed(seed)
    frac[:, 15, :] = torch.rand(frac[:, 15, :].shape, generator=gen,
                                device=frac.device) * 0.6 + 0.35
    return frac


def sweep_args(accel, o_t, d_t, live, cfg, closest, tm_t=None):
    """The positional arguments of ``sweep_closest`` (``closest``) or
    ``sweep_transmittance`` for these rays over ``accel``, selected as
    the frame selects them."""
    cand, counts, nearb, _ = pk.strip_interval_select(
        o_t, d_t, live, accel, cfg.packet_tile_cand, cfg.packet_max_blocks,
        RAY_EPS, tm_t=tm_t)
    if closest:
        t_cap = pk.ray_box_exit(o_t, d_t, *_scene_box(accel))
        return (accel.packed, o_t, d_t, t_cap, live, cand, counts, nearb,
                RAY_EPS)
    return (accel.packed, o_t, d_t, tm_t, live, cand, counts, RAY_EPS)


def time_ms(fn, reps: int) -> float:
    """Mean ms per call of ``fn`` over ``reps`` calls on the current CUDA
    stream, timed with CUDA events after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def first_walk_calls(frame):
    """The arguments of the first call of each walk (entry point x
    primitive kind) in one run of ``frame()``, read by wrapping the
    wrappers."""
    from solr_tpu_torch.ops import bvh

    calls, inner = {}, {e: getattr(bvh, e) for e in bvh.ENTRIES}

    def recorder(entry):
        def call(scene, tree, code, o, d, t_min, t_max, **kw):
            key = bvh.kernel_name(entry, bvh.POOL_PRIM[code])
            if key not in calls:
                calls[key] = (entry, bvh.POOL_PRIM[code], tree, o.clone(),
                              d.clone(), t_min, torch.as_tensor(
                                  t_max, dtype=o.dtype, device=o.device)
                              .expand(o.shape[:-1]).clone())
            return inner[entry](scene, tree, code, o, d, t_min, t_max, **kw)
        return call

    for e in bvh.ENTRIES:
        setattr(bvh, e, recorder(e))
    try:
        with torch.no_grad():
            frame()
        torch.cuda.synchronize()
    finally:
        for e in bvh.ENTRIES:
            setattr(bvh, e, inner[e])
    return calls


def ptxas_usage(log):
    """{mangled kernel name: {"registers", "stack_bytes", "spill_stores",
    "spill_loads"}} from nvcc's -Xptxas -v output."""
    usage, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?([\w]+)'?", line)
        if m:
            name = m.group(1)
            usage.setdefault(name, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            usage[name].update(stack_bytes=int(m.group(1)),
                               spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            usage[name]["registers"] = int(m.group(1))
    return usage

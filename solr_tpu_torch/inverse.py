"""Inverse rendering (BASELINE config #4; counterpart of
examples/inverse.py): recover scene parameters from a target render by
gradient descent through the renderer.

A ground-truth scene (a matte and a glossy sphere on a checkerboard
floor, one light) is rendered; the optimization starts from perturbed
sphere albedos and a displaced light and descends the pixel MSE with
Adam.  ``--geometry`` also perturbs the two spheres' centres (by about
0.15) and radii (by about 12%) and recovers them from an RGB-D
objective: hit topology is detached, so silhouette coverage carries no
gradient, and the renderer's depth channel supplies the smooth
geometric cue.  Each step is ``scene.with_params`` (which refreshes
the packet accelerators), ``render_sample``, the loss, ``backward``
and an Adam step with the gradient clipped to norm 1.  Checkpoints
every 10 steps (``--resume`` continues from the newest), one metrics
line per step.

    python -m solr_tpu_torch.inverse                  # on the card
    python -m solr_tpu_torch.inverse --device cpu --size 32 --steps 60
    python -m solr_tpu_torch.inverse --geometry --steps 300
    python -m solr_tpu_torch.inverse --resume

Exits non-zero when the loss falls less than 20x or, with
``--geometry``, the centre error less than 5x.
"""

from __future__ import annotations

import argparse
import os
import struct
import sys
import time
import zlib

import numpy as np
import torch

from solr_tpu_torch.ops.render import render_sample
from solr_tpu_torch.scene import SceneBuilder
from solr_tpu_torch.types import Camera, PlaneAxis, ProceduralKind, RenderConfig
from solr_tpu_torch.utils.checkpoint import CheckpointManager, RenderState
from solr_tpu_torch.utils.metrics import MetricsLogger

__all__ = ["build_scene", "perturb", "make_optimizer", "rgbd_loss", "main"]

# The objective's depth weight and the pass bars (examples/inverse.py).
DEPTH_WEIGHT = 0.05
LOSS_DROP = 20.0
CENTER_PERTURBATION = 0.15
CENTER_DROP = 5.0
GEOMETRY_LR = 1e-2
CLIP_NORM = 1.0
CKPT_EVERY = 10
GEOMETRY = ("sphere_center", "sphere_radius")


def build_scene(device="cuda"):
    """The ground-truth scene and camera of examples/inverse.py."""
    b = SceneBuilder()
    floor = b.add_material(color=(0.75, 0.75, 0.75, 1.0),
                           procedural=ProceduralKind.CHECKER,
                           procedural_scale=8.0)
    red = b.add_material(color=(0.85, 0.25, 0.2, 1.0), specular=0.4)
    teal = b.add_material(color=(0.15, 0.6, 0.65, 1.0), specular=0.6,
                          specular_power=30.0)
    b.add_plane(PlaneAxis.XZ, (0.0, -1.0, 0.0), (12.0, 12.0), floor)
    b.add_sphere((-1.1, 0.0, 0.8), 1.0, red)
    b.add_sphere((1.2, -0.3, 0.0), 0.7, teal)
    b.add_light((3.0, 6.0, -4.0), intensity=1.0, radius=0.2)
    scene = b.build(device=device)
    cam = Camera.create(position=(0.0, 1.2, -5.0), angles=(0.18, 0.0, 0.0),
                        fov=1.0, device=device)
    return scene, cam


def perturb(true_params: dict, geometry: bool):
    """(start params, names of the perturbed groups): the sphere albedos
    shifted and the light dragged sideways; with ``geometry`` the two
    spheres' centres and radii too (examples/inverse.py)."""
    def shifted(x, rows, delta):
        x = x.detach().clone()
        x[rows] += torch.as_tensor(delta, dtype=x.dtype, device=x.device)
        return x

    start = dict(true_params)
    albedo = true_params["albedo"].detach().clone()
    albedo[1:3, :3] += torch.as_tensor(
        [[0.25, -0.2, 0.15], [-0.1, 0.25, -0.2]], dtype=albedo.dtype,
        device=albedo.device)
    start["albedo"] = albedo
    start["light_position"] = shifted(true_params["light_position"],
                                      slice(None), [[-2.0, 0.0, 1.5]])
    groups = ["albedo", "light_position"]
    if geometry:
        start["sphere_center"] = shifted(
            true_params["sphere_center"], slice(0, 2),
            [[0.15, -0.12, 0.1], [-0.12, 0.1, -0.08]])
        radius = true_params["sphere_radius"].detach().clone()
        radius[0:2] *= torch.as_tensor([1.12, 0.9], dtype=radius.dtype,
                                       device=radius.device)
        start["sphere_radius"] = radius
        groups += list(GEOMETRY)
    return start, groups


def make_optimizer(params: dict, groups, lr: float):
    """Adam over the perturbed groups alone (the reference's mask): the
    geometry at GEOMETRY_LR, materials and light at ``lr`` (one rate
    diverges: geometry gradients are shading-scale, material ones
    color-scale)."""
    geo = [params[k] for k in groups if k in GEOMETRY]
    mat = [params[k] for k in groups if k not in GEOMETRY]
    return torch.optim.Adam(
        [g for g in ({"params": geo, "lr": GEOMETRY_LR},
                     {"params": mat, "lr": lr}) if g["params"]])


def rgbd_loss(img, depth, target, target_depth, geometry: bool, keep=None):
    """Pixel MSE over RGB, plus with ``geometry`` DEPTH_WEIGHT times the
    MSE of depth where both renders hit.  ``keep`` (H, W) bool restricts
    both means to its pixels (the gradient checks' silhouette mask)."""
    if keep is None:
        keep = torch.ones(depth.shape, dtype=torch.bool, device=depth.device)
    n = keep.sum()
    sq = (img[..., :3] - target) ** 2
    loss = torch.where(keep[..., None], sq, torch.zeros_like(sq)).sum() / (
        n * 3)
    if geometry:
        both = (target_depth < 1e29) & (depth < 1e29) & keep
        dres = torch.where(both, depth - target_depth,
                           torch.zeros_like(depth))
        loss = loss + DEPTH_WEIGHT * (dres ** 2).sum() / n
    return loss


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _save_png(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) image in [0, 1] as an 8-bit PNG."""
    h, w, _ = rgb.shape
    px = (np.clip(rgb, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    raw = b"".join(b"\x00" + px[y].tobytes() for y in range(h))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _errors(p, true_params, geometry: bool) -> dict:
    err = {"albedo_err": float((p["albedo"][:, :3]
                                - true_params["albedo"][:, :3]).abs().max()),
           "light_err": float((p["light_position"]
                               - true_params["light_position"]).abs().max())}
    if geometry:
        err["center_err"] = float((p["sphere_center"][0:2]
                                   - true_params["sphere_center"][0:2])
                                  .abs().max())
        err["radius_err"] = float((p["sphere_radius"][0:2]
                                   - true_params["sphere_radius"][0:2])
                                  .abs().max())
    return err


def main(argv=None) -> dict:
    """Run the demo; returns the run's summary (start and final loss,
    errors, ms per step and its parts).  Raises SystemExit when a bar
    is missed."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-2)
    ap.add_argument("--geometry", action="store_true",
                    help="also perturb and recover the sphere centres and "
                    "radii (RGB-D objective)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest checkpoint")
    ap.add_argument("--ckpt-dir", default=os.path.join("build", "inverse",
                                                       "ckpt"))
    ap.add_argument("--metrics", default=os.path.join("build", "inverse",
                                                      "metrics.jsonl"))
    ap.add_argument("--out", default=os.path.join("build", "inverse",
                                                  "inverse.png"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    scene, cam = build_scene(device)
    cfg = RenderConfig(width=args.size, height=args.size, max_bounces=2)
    true_params = scene.params
    with torch.no_grad():
        target, target_depth = render_sample(scene, cam, cfg)
    target = target[..., :3]

    start, groups = perturb(true_params, args.geometry)

    def loss_of(p):
        img, depth = render_sample(scene.with_params(p), cam, cfg)
        return rgbd_loss(img, depth, target, target_depth, args.geometry)

    with torch.no_grad():
        l_start = float(loss_of(start))

    p = {k: (v.detach().clone().requires_grad_(k in groups)
             if isinstance(v, torch.Tensor) else v) for k, v in start.items()}
    opt = make_optimizer(p, groups, args.lr)
    trained = [p[k] for k in groups]
    gen = torch.Generator().manual_seed(0)  # no random draws yet (C6)

    def state(step):
        return RenderState(params={k: p[k] for k in groups},
                           opt_state=opt.state_dict(),
                           rng_state=gen.get_state(), accum=None,
                           iteration=step)

    ckpt = CheckpointManager(args.ckpt_dir, keep_n=3)
    start_step = 0
    if args.resume:
        # Adam's per-parameter state in place, so every leaf of the
        # checkpoint has a slot to go into.
        template = RenderState(
            params={k: p[k] for k in groups}, rng_state=gen.get_state(),
            accum=None, iteration=0, opt_state={
                "state": {i: {"step": torch.zeros(()),
                              "exp_avg": torch.zeros_like(x),
                              "exp_avg_sq": torch.zeros_like(x)}
                          for i, x in enumerate(trained)},
                "param_groups": opt.state_dict()["param_groups"]})
        restored, at = ckpt.restore(template)
        if at is not None:
            with torch.no_grad():
                for k in groups:
                    p[k].copy_(restored.params[k])
            opt.load_state_dict(restored.opt_state)
            gen.set_state(restored.rng_state)
            start_step = restored.iteration
            print(f"resumed from step {at}", flush=True)

    metrics = MetricsLogger(args.metrics, echo=True)
    n_rays = cfg.n_pixels * cfg.max_bounces * 2
    parts = {"refresh_ms": [], "forward_ms": [], "backward_ms": [],
             "step_ms": []}
    t_wall = time.time()
    err = _errors(p, true_params, args.geometry)
    try:
        for i in range(start_step, args.steps):
            _sync(device)
            t0 = time.perf_counter()
            s = scene.with_params(p)
            _sync(device)
            t1 = time.perf_counter()
            img, depth = render_sample(s, cam, cfg)
            loss = rgbd_loss(img, depth, target, target_depth, args.geometry)
            _sync(device)
            t2 = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            torch.nn.utils.clip_grad_norm_(trained, CLIP_NORM)
            opt.step()
            _sync(device)
            t3 = time.perf_counter()
            for k, a, b in (("refresh_ms", t0, t1), ("forward_ms", t1, t2),
                            ("backward_ms", t2, t3), ("step_ms", t0, t3)):
                parts[k].append((b - a) * 1e3)
            err = _errors(p, true_params, args.geometry)
            metrics.log(step=i, loss=float(loss),
                        rays_per_s=n_rays / max(t3 - t0, 1e-9),
                        **{k: v[-1] for k, v in parts.items()}, **err)
            if (i + 1) % CKPT_EVERY == 0 or i + 1 == args.steps:
                ckpt.save(i + 1, state(i + 1))
    finally:
        metrics.close()

    with torch.no_grad():
        final_img, _ = render_sample(scene.with_params(p), cam, cfg)
        l_final = float(loss_of(p))
    _save_png(args.out, final_img[..., :3].float().cpu().numpy())
    summary = dict(loss_start=l_start, loss_final=l_final,
                   loss_drop=l_start / max(l_final, 1e-12),
                   steps=args.steps, start_step=start_step, size=args.size,
                   geometry=args.geometry, seconds=time.time() - t_wall,
                   device=str(device), **err,
                   **{k: (float(np.median(v)) if v else None)
                      for k, v in parts.items()})
    tail = " ".join(f"{k}={v:.4f}" for k, v in err.items())
    print(f"loss {l_start:.5f} -> {l_final:.5f} ({summary['loss_drop']:.0f}x) "
          f"in {summary['seconds']:.0f}s; {tail}; final render -> {args.out}",
          flush=True)
    if l_final > l_start / LOSS_DROP:
        raise SystemExit(f"inverse demo failed to converge {LOSS_DROP:.0f}x")
    if args.geometry and err["center_err"] > CENTER_PERTURBATION / CENTER_DROP:
        raise SystemExit(f"geometry recovery failed the {CENTER_DROP:.0f}x "
                         f"error bar")
    return summary


if __name__ == "__main__":
    main(sys.argv[1:])

"""Offline viewer and render CLI (counterpart of solr_tpu/viewer.py).

Renders a demo scene, or an .obj / .pdb / .swc / .irt file, to PNG: a
still, a progressive refinement (resumable from checkpoints), a still
in checkpointed row bands, or an animation, with the camera modes and
post-processing passes of the reference's viewer.

  python -m solr_tpu_torch.viewer --scene cornell --out cornell.png
  python -m solr_tpu_torch.viewer --scene cubes --frames 24 --out anim/
  python -m solr_tpu_torch.viewer --file model.obj --width 512 --height 512
  python -m solr_tpu_torch.viewer --scene cornell --mode anaglyph --spp 8
  python -m solr_tpu_torch.viewer --scene cornell --device cpu

Everything runs on ``--device`` (the card by default).  The printed
seconds of a frame include the copy of the image to the host, which
waits for the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from solr_tpu_torch.io.image import save_image
from solr_tpu_torch.ops.render import accumulate, render
from solr_tpu_torch.ops.rng import Key
from solr_tpu_torch.scene import SceneBuilder
from solr_tpu_torch.types import (Camera, CameraMode, PlaneAxis, PostFxConfig,
                                  PostFxMode, ProceduralKind, RenderConfig)
from solr_tpu_torch.utils.metrics import MetricsLogger, RaysMeter

__all__ = ["build_from_file", "main", "run"]

_MODES = {"mono": CameraMode.MONO, "anaglyph": CameraMode.ANAGLYPH,
          "sidebyside": CameraMode.SIDE_BY_SIDE, "fisheye": CameraMode.FISHEYE}
_POSTFX = {"none": PostFxMode.NONE, "dof": PostFxMode.DEPTH_OF_FIELD,
           "ao": PostFxMode.AMBIENT_OCCLUSION}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build_from_file(path: str, device="cuda"):
    """(scene, camera) of a file: an .irt scene as saved (its camera, or
    the default one), or an .obj, .pdb or .swc model over a checkered
    floor with one light.  Prints the seconds spent reading the file and
    building the scene."""
    from solr_tpu_torch.io import load_obj, load_pdb, load_scene, load_swc

    ext = os.path.splitext(path)[1].lower()
    t0 = time.time()
    if ext == ".irt":
        scene, camera = load_scene(path, device=device)
        _sync(device)
        print(f"loaded {path} in {time.time() - t0:.4f}s")
        return scene, camera or Camera.create(device=device)
    b = SceneBuilder()
    if ext == ".obj":
        load_obj(path, b, scale=1.5)
    elif ext == ".pdb":
        load_pdb(path, b, scale=0.2)
    elif ext == ".swc":
        load_swc(path, b, scale=0.02)
    else:
        raise SystemExit(f"unsupported file type: {ext}")
    floor = b.add_material(color=(0.85, 0.85, 0.85, 1.0),
                           procedural=ProceduralKind.CHECKER,
                           procedural_scale=8.0)
    b.add_plane(PlaneAxis.XZ, (0.0, -1.8, 0.0), (12.0, 12.0), floor)
    b.add_light((5.0, 8.0, -5.0))
    t1 = time.time()
    scene = b.build(device=device)
    _sync(device)
    print(f"parsed {path} in {t1 - t0:.4f}s, built the scene in "
          f"{time.time() - t1:.4f}s")
    return scene, Camera.create(position=(0.0, 0.5, -4.0), fov=0.9,
                                device=device)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scene", default=None,
                    help="demo scene name (see --list)")
    ap.add_argument("--file", default=None,
                    help=".obj / .pdb / .swc / .irt to view")
    ap.add_argument("--list", action="store_true",
                    help="list demo scenes and exit")
    ap.add_argument("--out", default="frame.png")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--bounces", type=int, default=3)
    ap.add_argument("--spp", type=int, default=1,
                    help="progressive samples to accumulate")
    ap.add_argument("--frames", type=int, default=1,
                    help="animation frames (scene.animate per frame)")
    ap.add_argument("--mode", default="mono", choices=list(_MODES))
    ap.add_argument("--postfx", default="none", choices=list(_POSTFX))
    ap.add_argument("--save-irt", default=None,
                    help="also serialize the scene to this .irt path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="progressive mode: save the accumulation buffer "
                    "and the key here every --checkpoint-every samples")
    ap.add_argument("--checkpoint-every", type=int, default=8)
    ap.add_argument("--resume", action="store_true",
                    help="resume the progressive render from the latest "
                    "checkpoint in --checkpoint-dir")
    ap.add_argument("--metrics", default=None,
                    help="append per-sample / per-frame metrics JSONL "
                    "(rays/s, sample index) to this path")
    ap.add_argument("--tile-rows", type=int, default=0,
                    help="still mode: render in row bands of this many "
                    "rows, checkpointing each into --checkpoint-dir; a "
                    "killed render resumes at the first unfinished band")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default: the card)")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.list:
        from solr_tpu_torch.scenes import SCENE_REGISTRY

        for name in sorted(SCENE_REGISTRY):
            print(name)
        return None
    return run(args, Key.seed(args.seed, args.device))


@torch.no_grad()
def run(args, key):
    """Render what ``args`` (parsed flags) ask for, drawing from ``key``
    (a :class:`Key`, or anything with its methods); returns the last
    image written, (H, W, 4) float32 on the host."""
    from solr_tpu_torch.scenes import make_scene

    device = torch.device(args.device)
    cfg = RenderConfig(width=args.width, height=args.height,
                       max_bounces=args.bounces, camera_mode=_MODES[args.mode],
                       postfx=PostFxConfig(mode=_POSTFX[args.postfx]),
                       antialias_jitter=args.spp > 1)
    demo = None
    if args.file:
        scene, camera = build_from_file(args.file, device)
    else:
        demo = make_scene(args.scene or "cornell", seed=args.seed,
                          device=device)
        scene, camera = demo.scene, demo.camera

    if args.save_irt:
        from solr_tpu_torch.io import save_scene

        save_scene(args.save_irt, scene, camera)
        print(f"saved {args.save_irt}")

    metrics = MetricsLogger(args.metrics) if args.metrics else None
    meter = RaysMeter()
    n_lights = int(scene.lights.position.shape[0])
    rays_per_sample = cfg.n_pixels * cfg.max_bounces * (1 + n_lights)

    if args.frames <= 1 and args.spp > 1:
        return _progressive(scene, camera, cfg, key, args, metrics, meter,
                            rays_per_sample)

    if args.frames <= 1 and args.tile_rows > 0:
        # A still in checkpointed row bands: a killed render launched
        # again with the same flags renders only its unfinished bands.
        # A directory derived from --out is removed after the frame; an
        # explicit --checkpoint-dir is kept.
        from solr_tpu_torch.ops.postfx import apply_postfx
        from solr_tpu_torch.utils.resumable import resumable_render

        t0 = time.time()
        img, depth = resumable_render(
            scene, camera, cfg, args.checkpoint_dir or (args.out + ".ckpt"),
            rows_per_chunk=args.tile_rows,
            log=metrics.log if metrics else None,
            cleanup=args.checkpoint_dir is None)
        img = apply_postfx(img, depth, scene, camera, cfg, None).cpu().numpy()
        dt = time.time() - t0
        print(f"rendered {args.width}x{args.height} in {dt:.4f}s "
              f"(resumable chunks of {args.tile_rows} rows)")
        save_image(args.out, img[..., :3])
        print(f"wrote {args.out}")
        return img

    if args.frames <= 1:
        t0 = time.time()
        img = render(scene, camera, cfg, key).cpu().numpy()
        dt = time.time() - t0
        print(f"rendered {args.width}x{args.height} in {dt:.4f}s")
        if metrics:
            metrics.log(event="still", seconds=round(dt, 3),
                        rays_per_s=rays_per_sample / dt)
        save_image(args.out, img[..., :3])
        print(f"wrote {args.out}")
        return img

    os.makedirs(args.out, exist_ok=True)
    img = None
    for f in range(args.frames):
        if demo is not None:
            scene, camera = demo.animate(f)
        key, sub = key.split()
        t0 = time.time()
        img = render(scene, camera, cfg, sub).cpu().numpy()
        dt = time.time() - t0
        rate = meter.tick(rays_per_sample)
        path = os.path.join(args.out, f"frame_{f:04d}.png")
        save_image(path, img[..., :3])
        if metrics:
            metrics.log(event="frame", frame=f, seconds=round(dt, 3),
                        rays_per_s=rate)
        print(f"wrote {path} (rendered in {dt:.4f}s)")
    return img


def _progressive(scene, camera, cfg, key, args, metrics, meter,
                 rays_per_sample):
    """Progressive refinement: the running average of ``args.spp``
    jittered samples, each from the next split of the key.  With
    ``--checkpoint-dir`` the buffer, the key and the sample count are
    saved every ``--checkpoint-every`` samples, and ``--resume`` goes on
    from the newest save (a :class:`Key` only: it is saved by its
    state)."""
    from solr_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                 RenderState, latest_step)

    cfg = dataclasses.replace(cfg, antialias_jitter=True)
    device = torch.device(args.device)
    accum = torch.zeros((cfg.height, cfg.width, 4), dtype=torch.float32,
                        device=device)
    start = 0
    mgr = None
    if args.checkpoint_dir:
        if not isinstance(key, Key):
            raise TypeError(f"checkpointing saves a solr_tpu_torch Key, got "
                            f"{type(key).__name__}")
        mgr = CheckpointManager(args.checkpoint_dir)
    if mgr and args.resume and latest_step(args.checkpoint_dir) is not None:
        template = RenderState(params=None, opt_state=None,
                               rng_state=key.state, accum=accum, iteration=0)
        state, _ = mgr.restore(template)
        accum, key = state.accum, Key(state.rng_state, device)
        start = int(state.iteration)
        print(f"resumed progressive render at sample {start}")

    for it in range(start, args.spp):
        key, sub = key.split()
        accum = accumulate(accum, render(scene, camera, cfg, sub), it)
        rate = meter.tick(rays_per_sample)
        if metrics:
            metrics.log(event="progressive", sample=it + 1, rays_per_s=rate)
        if mgr and (it + 1) % args.checkpoint_every == 0:
            mgr.save(it + 1, RenderState(params=None, opt_state=None,
                                         rng_state=key.state, accum=accum,
                                         iteration=it + 1))
    img = accum.cpu().numpy()
    save_image(args.out, img[..., :3])
    print(f"wrote {args.out} ({args.spp} samples)")
    return img


if __name__ == "__main__":
    main()

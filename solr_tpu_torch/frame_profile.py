"""Where a frame's time goes.

    python -m solr_tpu_torch.frame_profile [--scene bench|molecule]
        [--n-tris N] [--n-atoms N] [--ground-res R] [--size S]
        [--height H] [--traversal auto|packet|while] [--block B]
        [--out FILE]

Builds the bench frame (bench_scene.py; by default the full 1M-triangle
512x512 frame at BLOCK=512) or the molecule frame (molecule_scene.py; by
default 100k atoms over a res-128 ground, 512x512, BLOCK=256) on cuda:0,
``--size`` pixels wide and ``--height`` (default ``--size``) high, with
the given traversal, renders one warm-up frame, then:

1. three plain frames, each timed on the host clock up to a device sync;
2. on a CUDA device, one frame under ``torch.profiler``: the number of
   device kernels, their summed time, the device's busy share of that
   frame's wall time, and the largest kernels by name;
3. one instrumented frame: each phase in ``PHASES`` timed on the host
   clock with a device sync on both sides, and the exactness net's
   counters (``traverse.NET_STATS``) read around each net call.  The
   sweep and walk wrappers are timed per kernel ("kernel
   sweep_closest_sphere", "kernel bvh_closest_hit_sphere").

The phases nest (the net calls the pool brute force when a union
overflows), so their seconds do not add up to the frame.  The syncs make
the instrumented frame a little slower than a plain one; both are
reported.  Prints the record as JSON and writes it to ``--out`` if given.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import contextlib
import functools
import inspect
import json
import time

import torch

from solr_tpu_torch.bench_scene import bench_scene
from solr_tpu_torch.molecule_scene import molecule_scene
from solr_tpu_torch.ops import bvh, packet, render, sweep, traverse

__all__ = ["PHASES", "profile_frame"]

# (module, attribute, label): the calls the instrumented frame times.
PHASES = (
    (render, "_compact_perm", "compact_perm"),
    (render, "scene_closest_hit", "scene_closest_hit"),
    (render, "surface_at", "surface_at"),
    (render, "phong_shade", "phong_shade"),
    (packet, "strip_interval_select", "strip_interval_select"),
    (sweep, "sweep_closest", "kernel sweep_closest"),
    (sweep, "sweep_transmittance", "kernel sweep_transmittance"),
    (bvh, "bvh_closest_hit", "kernel bvh_closest_hit"),
    (bvh, "bvh_transmittance", "kernel bvh_transmittance"),
    (traverse, "_compacted_net", "exactness net"),
    (traverse, "_pool_closest", "pool_closest (small pools, net overflows)"),
    (traverse, "_pool_transmittance_brute",
     "pool_transmittance_brute (small pools, net overflows)"),
)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _frame(scene, cam, cfg, device):
    t0 = time.perf_counter()
    img, _ = render.render_sample(scene, cam, cfg)
    _sync(device)
    return img, time.perf_counter() - t0


def _device_profile(scene, cam, cfg, device, top: int):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = _frame(scene, cam, cfg, device)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
        by_name[e.name][1] += 1
    largest = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return dict(frame_s=wall, device_kernels=len(kernels), device_busy_s=busy,
                device_busy_share=busy / wall,
                largest_kernels=[dict(name=n[:120], ms=ms, launches=c)
                                 for n, (ms, c) in largest])


@contextlib.contextmanager
def _instrumented(device, seconds, calls, net_calls):
    """Patch every phase in PHASES with a synced timer for the block."""
    saved = []

    def timed(fn, label, is_net):
        kernels = fn.__module__ in (sweep.__name__, bvh.__name__)
        sig = inspect.signature(fn) if kernels else None

        @functools.wraps(fn)
        def call(*args, **kwargs):
            key = label
            if sig is not None:  # one label per kernel of the wrapper
                a = sig.bind(*args, **kwargs).arguments
                if fn.__module__ == bvh.__name__:
                    key = "kernel " + bvh.kernel_name(
                        fn.__name__, bvh.POOL_PRIM[a["pool_code"]])
                else:
                    key = "kernel " + sweep.kernel_name(
                        fn.__name__, a.get("prim", "tri"))
            before = dict(traverse.NET_STATS)
            _sync(device)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                _sync(device)
                seconds[key] += time.perf_counter() - t0
                calls[key] += 1
                if is_net:
                    net_calls.append({k: traverse.NET_STATS[k] - before[k]
                                      for k in before})
        return call

    try:
        for mod, name, label in PHASES:
            fn = getattr(mod, name)
            saved.append((mod, name, fn))
            is_net = mod is traverse and name == "_compacted_net"
            setattr(mod, name, timed(fn, label, is_net))
        yield
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


def profile_frame(scene, cam, cfg, frames: int = 3, top: int = 12) -> dict:
    """The record described in the module docstring, for one scene."""
    device = scene.materials.color.device
    rec = {}
    with torch.no_grad():
        img, rec["warmup_s"] = _frame(scene, cam, cfg, device)
        rec["frame_s"] = [_frame(scene, cam, cfg, device)[1]
                          for _ in range(frames)]
        rec["digest"] = float(img.double().sum())
        if device.type == "cuda":
            rec["device"] = _device_profile(scene, cam, cfg, device, top)
        seconds = collections.defaultdict(float)
        calls = collections.defaultdict(int)
        net_calls = []
        for k in traverse.NET_STATS:
            traverse.NET_STATS[k] = 0
        with _instrumented(device, seconds, calls, net_calls):
            img2, rec["instrumented_frame_s"] = _frame(scene, cam, cfg, device)
    rec["instrumented_digest"] = float(img2.double().sum())
    rec["phases"] = {k: dict(s=seconds[k], calls=calls[k]) for k in seconds}
    rec["net_calls"] = net_calls
    rec["net_stats"] = dict(traverse.NET_STATS)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", choices=("bench", "molecule"), default="bench")
    ap.add_argument("--n-tris", type=int, default=1_000_000)
    ap.add_argument("--n-atoms", type=int, default=100_000)
    ap.add_argument("--ground-res", type=int, default=128)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--traversal", choices=("auto", "packet", "while"),
                    default="auto")
    ap.add_argument("--block", type=int, default=None,
                    help="primitives per block (bench 512, molecule 256)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = torch.device("cuda:0")
    height = args.height or args.size
    t0 = time.perf_counter()
    if args.scene == "bench":
        block = args.block or 512
        scene, cam, cfg = bench_scene(args.n_tris, block=block,
                                      width=args.size, height=height,
                                      device=device)
        rec = dict(scene="bench", n_tris=args.n_tris)
    else:
        block = args.block or 256
        scene, cam, cfg = molecule_scene(args.n_atoms, args.ground_res,
                                         width=args.size, height=height,
                                         block=block, device=device)
        rec = dict(scene="molecule", n_atoms=args.n_atoms,
                   ground_res=args.ground_res)
    cfg = dataclasses.replace(cfg, traversal=args.traversal)
    _sync(device)
    rec.update(size=args.size, height=height, traversal=args.traversal,
               block=block,
               scene_build_s=time.perf_counter() - t0,
               pools={k: int(v) for k, v in (
                   ("spheres", scene.spheres.radius.shape[0]),
                   ("triangles", scene.triangles.v0.shape[0]),
                   ("cylinders", scene.cylinders.radius.shape[0]))},
               **profile_frame(scene, cam, cfg))
    text = json.dumps(rec, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Where the bench frame's time goes.

    python -m solr_tpu_torch.frame_profile [--n-tris N] [--size S]
                                            [--block B] [--out FILE]

Builds the bench frame (bench_scene.py; by default the full 1M-triangle
512x512 frame at BLOCK=512) on cuda:0, renders one warm-up frame, then:

1. three plain frames, each timed on the host clock up to a device sync;
2. on a CUDA device, one frame under ``torch.profiler``: the number of
   device kernels, their summed time, the device's busy share of that
   frame's wall time, and the largest kernels by name;
3. one instrumented frame: each phase in ``PHASES`` timed on the host
   clock with a device sync on both sides, and the exactness net's
   counters (``traverse.NET_STATS``) read around each net call.

The phases nest (the net calls the pool brute force when a union
overflows), so their seconds do not add up to the frame.  The syncs make
the instrumented frame a little slower than a plain one; both are
reported.  Prints the record as JSON and writes it to ``--out`` if given.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import json
import time

import torch

from solr_tpu_torch.bench_scene import bench_scene
from solr_tpu_torch.ops import packet, render, sweep, traverse

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
    (traverse, "_compacted_net", "exactness net"),
    (traverse, "_pool_closest", "pool_closest (spheres, net overflows)"),
    (traverse, "_pool_transmittance_brute",
     "pool_transmittance_brute (spheres, net overflows)"),
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
        @functools.wraps(fn)
        def call(*args, **kwargs):
            before = dict(traverse.NET_STATS)
            _sync(device)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                _sync(device)
                seconds[label] += time.perf_counter() - t0
                calls[label] += 1
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
    ap.add_argument("--n-tris", type=int, default=1_000_000)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--block", type=int, default=512)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = torch.device("cuda:0")
    scene, cam, cfg = bench_scene(args.n_tris, block=args.block,
                                  width=args.size, height=args.size,
                                  device=device)
    rec = dict(n_tris=args.n_tris, size=args.size, block=args.block,
               **profile_frame(scene, cam, cfg))
    text = json.dumps(rec, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

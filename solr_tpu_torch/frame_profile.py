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
2. one frame under ``torch.profiler``, timed the same way: for each span
   of the port (``utils.profiling.render_phase``, ``solr/<name>``) its
   calls, its total ms (the union of its intervals) and its self ms (its
   time less the part its child spans cover), and the exactness net's
   counters (``traverse.NET_STATS``: its needy rays, their 32-ray
   strips, the blocks of the strips' lists and the sweep windows over
   them) over that frame; on a CUDA device
   also the number of kernels, the device's busy share of the frame's
   wall time (the union of kernel and copy intervals, so overlapping
   kernels count once) and the largest kernels by name.

Prints the record as JSON and writes it to ``--out`` if given.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import time

import torch

from solr_tpu_torch.bench_scene import bench_scene
from solr_tpu_torch.molecule_scene import molecule_scene
from solr_tpu_torch.ops import render, traverse
from solr_tpu_torch.ops.pools import BY_PRIM

__all__ = ["profile_frame"]

_COPIES = ("Memcpy", "Memset")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _frame(scene, cam, cfg, device):
    t0 = time.perf_counter()
    img, _ = render.render_sample(scene, cam, cfg)
    _sync(device)
    return img, time.perf_counter() - t0


def _union_ms(intervals) -> float:
    """Length in ms of the union of (start_us, end_us) intervals."""
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total * 1e-3


def _span_table(host) -> dict:
    """Per span name (``solr/...``) of the host events ``host``, (name,
    start_us, end_us): its calls, total ms (the union of its intervals)
    and self ms (each span's time less what its child spans cover).
    Spans nest on the host thread, so a span's children are the spans
    that start inside it before it ends."""
    spans = sorted(((s, e, n) for n, s, e in host if n.startswith("solr/")),
                   key=lambda x: (x[0], -x[1]))
    covered = [0.0] * len(spans)
    open_spans = []
    for i, (s, e, _) in enumerate(spans):
        while open_spans and spans[open_spans[-1]][1] <= s:
            open_spans.pop()
        if open_spans:
            parent_end = spans[open_spans[-1]][1]
            covered[open_spans[-1]] += min(e, parent_end) - s
        open_spans.append(i)
    table = {}
    for (s, e, name), child in zip(spans, covered):
        row = table.setdefault(name, dict(calls=0, ms=[], self_ms=0.0))
        row["calls"] += 1
        row["ms"].append((s, e))
        row["self_ms"] += (e - s - child) * 1e-3
    for row in table.values():
        row["ms"] = _union_ms(row["ms"])
    return table


def _profiled_frame(scene, cam, cfg, device, top: int) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    for k in traverse.NET_STATS:
        traverse.NET_STATS[k] = 0
    with profile(activities=acts) as prof:
        img, wall = _frame(scene, cam, cfg, device)
    rec = dict(profiled_frame_s=wall,
               profiled_digest=float(img.double().sum()),
               net_stats=dict(traverse.NET_STATS))
    host, activity = [], []
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns() * 1e-3
        item = (ev.name(), start, start + ev.duration_ns() * 1e-3)
        (activity if ev.device_type() == DeviceType.CUDA else host).append(
            item)
    rec["spans"] = _span_table(host)
    if device.type == "cuda":
        kernels = [a for a in activity if not a[0].startswith(_COPIES)]
        busy = _union_ms([(s, e) for _, s, e in activity]) * 1e-3
        by_name = collections.defaultdict(lambda: [0.0, 0])
        for name, s, e in kernels:
            by_name[name][0] += (e - s) * 1e-3
            by_name[name][1] += 1
        largest = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
        rec["device"] = dict(
            device_kernels=len(kernels), device_busy_s=busy,
            device_busy_share=busy / wall,
            largest_kernels=[dict(name=n[:120], ms=ms, launches=c)
                             for n, (ms, c) in largest])
    return rec


def profile_frame(scene, cam, cfg, frames: int = 3, top: int = 12) -> dict:
    """The record described in the module docstring, for one scene."""
    device = scene.materials.color.device
    rec = {}
    with torch.no_grad():
        img, rec["warmup_s"] = _frame(scene, cam, cfg, device)
        rec["frame_s"] = [_frame(scene, cam, cfg, device)[1]
                          for _ in range(frames)]
        rec["digest"] = float(img.double().sum())
        rec.update(_profiled_frame(scene, cam, cfg, device, top))
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
               pools={p.attr: p.size(scene) for p in BY_PRIM.values()},
               **profile_frame(scene, cam, cfg))
    text = json.dumps(rec, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

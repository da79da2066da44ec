"""Headline benchmark (counterpart of bench.py): rays/s on one card,
primary + secondary, on the bench frame (a 1M-triangle terrain, 24
mirror spheres, one light; 512x512, 2 bounces).

    python -m solr_tpu_torch.bench [--tris 1000000] [--width 512]
        [--height 512] [--bounces 2] [--repeats 3] [--block 512] [--k 64]
        [--kt 256] [--attempt-timeout 2400] [--device cuda] [--metrics PATH]

Ray accounting as in bench.py: every bounce traces one closest-hit ray
per pixel and one shadow ray per light per pixel, so rays per frame =
pixels x bounces x (1 + lights).

Two paths, each at the headline scale in a child process of its own
(``--attempt --traversal packet|while``) within ``--attempt-timeout``
seconds: the frame's two exact traversals, packets (the sweep kernels B1
and B2 and the exactness net) and the per-ray BVH walk (the triangle
walk kernels).  A CUDA error such as an illegal address poisons the
process's context, so each path runs where it cannot take the other
down.  Each child builds the scene (``bench_scene``), renders one
warm-up frame (which includes the kernels' nvcc build at first use),
then ``--repeats`` frames, each timed on the host clock up to the sync
of its digest, the float64 sum of the image; ``frame_ms`` is the best
(as in bench.py) and ``frame_ms_mean`` the mean of all of them.
The launch counts (``sweep.LAUNCHES``, ``bvh.LAUNCHES``) and the net's
counters (``traverse.NET_STATS``, ``traverse.BRUTE_CALLS``) cover the
timed frames.  The packet child then takes the primary bounce's packet
diagnostics (``packet_diagnostics``), after the timed frames.

The summary line leads with the faster path and carries both under
``paths``; ``path_digest_rel_diff`` holds the two digests to each other
(a correctness check on the card: one frame through two traversals).
``best_prev_rays_s`` is the best rays/s of the repository's
``BENCH_r*.json`` records that name this run's device (the card's name
and power limit); none names an H100, so it is 0 until one does.
Every record goes to ``--metrics`` (default
``build/solr_tpu_torch/bench_metrics.jsonl``); the last line of
standard output is the summary as one JSON object.  The process exits 1
when an attempt fails or the digests disagree beyond 1e-3.

Not ported from bench.py: ``bytes_by_phase`` and the ``roofline`` block
(XLA cost analysis, which counts untaken ``lax.cond`` branches and has
no PyTorch counterpart), and the reduced-scale ladder (N/5, N/20),
which stood in for TPU worker crashes: a failed attempt here is a
failure, and no smaller scale runs in its place.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import signal
import subprocess
import sys
import time

import torch

__all__ = ["BASELINE_RAYS_PER_S", "DIAGNOSTICS", "build_scene",
           "diagnostics_mismatch", "main", "packet_diagnostics",
           "parse_args"]

BASELINE_RAYS_PER_S = 1.0e9  # the north-star target, not a measurement
DIGEST_RTOL = 1e-3  # the two paths' digests (bench.py:495-502)
NET_RATE_BUDGET = 0.02
# The eight packet diagnostics, each with its decimals in the record
# (None: an integer).
DIAGNOSTICS = {"blocks": None, "strips_per_tile": None,
               "mean_strip_candidates": 2, "max_strip_candidates": None,
               "mean_strip_visits": 2, "mean_visits": 2, "net_ray_rate": 5,
               "strip_drop_rate": 4}
RESULT_MARKER = "SOLR_BENCH_RESULT "
TRAVERSALS = ("packet", "while")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_METRICS = os.path.join(_REPO, "build", "solr_tpu_torch",
                        "bench_metrics.jsonl")


def parse_args(argv):
    """The flags of ``argv`` (the module docstring's) as a namespace."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tris", type=int, default=1_000_000)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--bounces", type=int, default=2)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--block", type=int, default=512)
    ap.add_argument("--k", type=int, default=64,
                    help="per-strip candidate list width")
    ap.add_argument("--kt", type=int, default=256,
                    help="tile prefilter width")
    ap.add_argument("--attempt-timeout", type=float, default=2400.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--metrics", default=_METRICS)
    ap.add_argument("--attempt", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--traversal", choices=TRAVERSALS, default="packet",
                    help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def build_scene(args, traversal: str = "packet", device="cuda"):
    """(scene, camera, config) of the bench frame at ``args``' size and
    packet list widths, with ``traversal``; its packet tiles are
    ``bench_scene``'s 16x16, bench.py's default."""
    from solr_tpu_torch.bench_scene import bench_scene

    scene, cam, cfg = bench_scene(args.tris, block=args.block,
                                  width=args.width, height=args.height,
                                  bounces=args.bounces, device=device)
    cfg = dataclasses.replace(
        cfg, packet_max_blocks=args.k, packet_tile_cand=args.kt,
        traversal=traversal)
    return scene, cam, cfg


@torch.no_grad()
def packet_diagnostics(scene, cam, cfg) -> dict:
    """Primary-bounce packet statistics of the strip-interval traversal
    (bench.py:135-237): the per-strip candidate list lengths, the
    strips' block visits in the closest-hit sweep (``sweep_closest``: the
    B1 kernel on the card, its plain version on the CPU, both stopping a
    strip once ``nearb`` reaches its ``done`` bound), the visits per ray
    (blocks of its strip's list that a front-to-back walk would enter:
    entry <= its ``done``), the share of rays the exactness net would
    take (``done`` past the ``dropped`` certificate) and the share with
    a dropped block at all."""
    from solr_tpu_torch.constants import RAY_EPS, T_FAR
    from solr_tpu_torch.kernel_shapes import primary_tiles
    from solr_tpu_torch.ops import packet as pk
    from solr_tpu_torch.ops.sweep import sweep_closest
    from solr_tpu_torch.ops.traverse import _scene_box

    accel = scene.tri_accel
    o_t, d_t, live = primary_tiles(cam, cfg)
    cand, counts, nearb, dropped = pk.strip_interval_select(
        o_t, d_t, live, accel, cfg.packet_tile_cand, cfg.packet_max_blocks,
        RAY_EPS)
    s, g, k = cand.shape
    t_cap = pk.ray_box_exit(o_t, d_t, *_scene_box(accel))
    bt, _, nv = sweep_closest(accel.packed, o_t, d_t, t_cap, live, cand,
                              counts, nearb, RAY_EPS)
    strip_visits = nv.float() / g  # nv sums the tile's G strips
    done = torch.minimum(bt, t_cap)  # (S, SB)
    net = done > dropped
    bounds = accel.block_bounds[cand.reshape(s * g, k).long()]
    entry, hit = pk.slab_entries_g(o_t.reshape(s * g, -1, 3),
                                   d_t.reshape(s * g, -1, 3), bounds, RAY_EPS)
    k_valid = (torch.arange(k, device=cand.device)[None, None, :]
               < counts.reshape(-1, 1, 1))
    ray_visits = (hit & k_valid & (entry <= done.reshape(s * g, -1)[..., None])
                  ).sum(-1)
    del entry, hit, bounds
    raw = {
        "blocks": accel.packed.shape[0],
        "strips_per_tile": pk.strips_per_tile(cfg.packet_rays),
        "mean_strip_candidates": counts.float().mean(),
        "max_strip_candidates": counts.max(),
        "mean_strip_visits": strip_visits.mean(),
        "mean_visits": ray_visits.float().mean(),
        "net_ray_rate": net.float().mean(),
        "strip_drop_rate": (dropped < T_FAR * 0.5).float().mean(),
    }
    out = {k: int(v) if DIAGNOSTICS[k] is None
           else round(float(v), DIAGNOSTICS[k]) for k, v in raw.items()}
    if out["net_ray_rate"] > NET_RATE_BUDGET:
        out["warning"] = ("net_ray_rate above the 2% design budget - raise "
                          "packet_max_blocks / packet_tile_cand")
    return out


def diagnostics_mismatch(got: dict, want: dict, rays: int) -> dict:
    """The diagnostics of ``got`` outside their allowance against
    ``want`` (bench.py's at the same settings and ``rays`` primary
    rays), each as (got, want, allowance).  The block and strip counts
    and the longest list are equal, and so is the mean list length: the
    lists are equal as sets (ROADMAP C7).  The two visit means may differ
    by a tie at the K cut, which can swap one block of one strip's list:
    one strip visit over the frame's strips, and one visit for each of
    that strip's rays over the rays; the rates by 2 / rays.  The
    rounded keys also get one unit of their last decimal."""
    from solr_tpu_torch.ops.sweep import STRIP

    slack = {"mean_strip_visits": STRIP / rays, "mean_visits": STRIP / rays,
             "net_ray_rate": 2 / rays, "strip_drop_rate": 2 / rays}
    out = {}
    for k, decimals in DIAGNOSTICS.items():
        allow = 0.0
        if k in slack:
            allow = slack[k] + 10.0 ** -decimals
        if not abs(got[k] - want[k]) <= allow:
            out[k] = (got[k], want[k], allow)
    return out


def _sync_digest(img) -> float:
    """The frame's digest; reading it on the host syncs the device."""
    return float(img.double().sum())


def _run(args, traversal: str, metrics) -> dict:
    """One path's record; raises on any failure."""
    from solr_tpu_torch.ops import bvh, sweep, traverse
    from solr_tpu_torch.ops.render import render_sample
    from solr_tpu_torch.utils.card import card_name

    device = torch.device(args.device)
    t0 = time.perf_counter()
    scene, cam, cfg = build_scene(args, traversal, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t0
    counters = (sweep.LAUNCHES, bvh.LAUNCHES, traverse.NET_STATS,
                traverse.BRUTE_CALLS)
    with torch.no_grad():
        t0 = time.perf_counter()
        img, _ = render_sample(scene, cam, cfg)
        digest = _sync_digest(img)
        warmup_s = time.perf_counter() - t0
        if not torch.isfinite(img).all():
            raise AssertionError("the warm-up frame is not finite")
        del img
        for c in counters:
            c.update(dict.fromkeys(c, 0))
        runs = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            _sync_digest(render_sample(scene, cam, cfg)[0])
            runs.append(time.perf_counter() - t0)
    best = min(runs)
    n_lights = scene.lights.position.shape[0]
    rays = cfg.n_pixels * cfg.max_bounces * (1 + n_lights)
    rays_per_s = rays / best
    result = {
        "metric": (f"rays/s/chip primary+secondary, {args.tris} tris, "
                   f"{args.width}x{args.height}x{args.bounces}b BVH"),
        "value": round(rays_per_s, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_s / BASELINE_RAYS_PER_S, 6),
        "traversal": traversal,
        "rays": rays,
        "frame_ms": round(best * 1000, 2),
        "frame_ms_mean": round(sum(runs) / len(runs) * 1000, 2),
        "frame_ms_runs": [round(t * 1000, 2) for t in runs],
        "warmup_s": round(warmup_s, 2),
        "scene_build_s": round(build_s, 2),
        "device": card_name(device),
        "digest": digest,
        "launches": {k: v for k, v in {**sweep.LAUNCHES,
                                       **bvh.LAUNCHES}.items() if v},
        "net": {**traverse.NET_STATS,
                "brute_calls": {k: v for k, v in traverse.BRUTE_CALLS.items()
                                if v},
                "frames": args.repeats},
    }
    if traversal == "packet":
        result["packet"] = packet_diagnostics(scene, cam, cfg)
    metrics.log(**result)
    return result


def _attempt_main(args) -> int:
    """One path in this process: prints the marker line with its
    record."""
    from solr_tpu_torch.utils.metrics import MetricsLogger

    with MetricsLogger(args.metrics) as metrics:
        result = _run(args, args.traversal, metrics)
    print(RESULT_MARKER + json.dumps(result), flush=True)
    return 0


def _attempt_subprocess(argv, traversal, timeout_s, metrics):
    """One path in a child process in a session of its own, ended with
    every process it started when past ``timeout_s``: (record, None), or
    (None, the error)."""
    child = subprocess.Popen(
        [sys.executable, "-m", "solr_tpu_torch.bench", *argv, "--attempt",
         "--traversal", traversal], cwd=_REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        stdout, stderr = child.communicate(timeout=timeout_s)
        for line in stdout.splitlines():
            if line.startswith(RESULT_MARKER):
                return json.loads(line[len(RESULT_MARKER):]), None
        err = f"exit {child.returncode}: " + stderr.strip()[-500:]
    except subprocess.TimeoutExpired:
        err = f"attempt timed out after {timeout_s:.0f}s"
    finally:
        if child.poll() is None:
            os.killpg(child.pid, signal.SIGKILL)
            child.communicate()
    metrics.log(event="bench_attempt_failed", traversal=traversal,
                error=err[:600])
    return None, err


def _best_previous(device: str, root: str = _REPO) -> float:
    """Best headline rays/s of the ``BENCH_r*.json`` records in ``root``
    that name ``device`` (the card's name and power limit): the
    regression floor.  Records of other devices (the reference's TPU
    rounds) are never compared."""
    best = 0.0
    for path in glob.glob(os.path.join(root, "BENCH_r*.json")):
        try:
            with open(path) as f:
                rec = json.load(f)
            parsed = rec.get("parsed", rec)
            if parsed.get("unit") == "rays/s" and parsed.get("device") == device:
                best = max(best, float(parsed.get("value", 0.0)))
        except (OSError, ValueError, TypeError, AttributeError):
            continue
    return best


def _summary(paths: dict, errors: dict) -> dict:
    """The summary record: the faster path's record, both paths, their
    digests' agreement and the errors of the failed attempts."""
    if not paths:
        return {"metric": "bench failed", "value": 0.0, "unit": "rays/s",
                "vs_baseline": 0.0, "errors": errors}
    result = dict(max(paths.values(), key=lambda r: r["value"]))
    result["paths"] = {name: {k: r[k] for k in (
        "value", "frame_ms", "frame_ms_mean", "frame_ms_runs", "warmup_s",
        "scene_build_s",
        "digest", "launches", "net")} for name, r in paths.items()}
    if "packet" in paths:
        result["packet"] = paths["packet"]["packet"]
    if len(paths) == 2:
        a, b = (r["digest"] for r in paths.values())
        rel = abs(a - b) / max(abs(a), 1e-30)
        result["path_digest_rel_diff"] = rel
        if rel > DIGEST_RTOL:
            result["warning"] = "packet/while digests disagree beyond 1e-3"
    if errors:
        result["errors"] = errors
    return result


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, and no CUDA device is visible")
    if args.attempt:
        return _attempt_main(args)
    from solr_tpu_torch.utils.metrics import MetricsLogger

    os.makedirs(os.path.dirname(os.path.abspath(args.metrics)), exist_ok=True)
    paths, errors = {}, {}
    with MetricsLogger(args.metrics) as metrics:
        for traversal in TRAVERSALS:
            res, err = _attempt_subprocess(argv, traversal,
                                           args.attempt_timeout, metrics)
            if res is None:
                errors[traversal] = err
            else:
                paths[traversal] = res
        result = _summary(paths, errors)
        prev = _best_previous(result.get("device", args.device))
        result["best_prev_rays_s"] = round(prev, 1)
        short = result["value"] < prev
        result["regression_vs_best_prev"] = (
            round(1.0 - result["value"] / prev, 4) if (short and prev) else 0)
        metrics.log(event="bench_summary", **{
            k: v for k, v in result.items() if not isinstance(v, dict)})
    print(json.dumps(result), flush=True)
    return 1 if errors or "warning" in result else 0


if __name__ == "__main__":
    sys.exit(main())

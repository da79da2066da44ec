#!/usr/bin/env python3
"""GPU smoke run of solr_tpu_torch, the PyTorch + CUDA port.

    python3 chip_smoke.py

Needs one CUDA card (sm_90a, an H100) and nvcc; builds the sweep kernels
from solr_tpu_torch/csrc/ on first use.  Phases, each of which must pass:

1. the card's name and power limit (nvidia-smi);
2. build the kernels with nvcc and report the build seconds;
3. kernel vs plain PyTorch at the bench shapes: the strip selection of
   the bench scene's primary rays (1M triangles, 512x512, BLOCK=512,
   K=64, Kt=256) through sweep_closest, and of its primary hits' shadow
   rays through sweep_transmittance (once with the scene's 0/1 shadow
   factors, once with fractional ones); t, idx, tr and visits must be
   bit-equal; both times are reported;
4. the main path: render_sample of the full bench frame (2 bounces, hard
   shadows), one warm-up and three timed frames; frame ms, rays/s as
   bench.py counts them, the digest img.sum(), and each kernel's launch
   count over the run, which must be > 0; the image must be finite;
5. the port on the card against the committed solr_tpu CPU reference of
   a reduced bench frame (tests/data/torch_bench_ref.npz): atol 1e-4
   outside a budget of 0.2% of pixels (discrete hit flips at silhouette
   edges, where the reference's CPU build contracts the Woop and cross
   product chains into FMAs).

Prints the full record of the run on one line ("record: {...}"), the
kernel table as one JSON line, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Exits non-zero, without that line, when
any phase fails or no card is visible.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
MISMATCH_ATOL = 1e-4
MISMATCH_BUDGET = 0.002
N_TRIS = 1_000_000
SIZE = 512
BLOCK = 512
BOUNCES = 2


def _nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int):
    """Mean ms per call over ``reps`` calls, CUDA events, after one
    warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _tiles(o, d, cfg):
    import torch

    from solr_tpu_torch.ops.packet import tile_permutation

    perm, _ = tile_permutation(cfg.width, cfg.height, cfg.packet_tile_w,
                               cfg.packet_tile_h)
    perm = torch.as_tensor(perm, device=o.device)
    sb = cfg.packet_rays
    return o[perm].reshape(-1, sb, 3), d[perm].reshape(-1, sb, 3)


def phase_kernels(scene, cam, cfg, rec):
    """Kernel vs plain at the bench shapes."""
    import torch

    from solr_tpu_torch.constants import PARK_DIR, PARK_POS, RAY_EPS, T_FAR
    from solr_tpu_torch.ops import packet as pk
    from solr_tpu_torch.ops import sweep
    from solr_tpu_torch.ops.camera import camera_rays
    from solr_tpu_torch.ops.traverse import POOL_TRIANGLE, Hit, _scene_box, surface_at

    accel = scene.tri_accel
    ks, kt = cfg.packet_max_blocks, cfg.packet_tile_cand
    with torch.no_grad():
        o, d = camera_rays(cam, cfg)
        o_t, d_t = _tiles(o, d, cfg)
        live = torch.ones(o_t.shape[:2], dtype=torch.bool, device=o.device)
        cand, counts, nearb, _ = pk.strip_interval_select(
            o_t, d_t, live, accel, kt, ks, RAY_EPS)
        bmin, bmax = _scene_box(accel)
        t_cap = pk.ray_box_exit(o_t, d_t, bmin, bmax)
        args = (accel.packed, o_t, d_t, t_cap, live, cand, counts, nearb, RAY_EPS)
        t_k, i_k, v_k = sweep.sweep_closest(*args)
        t_p, i_p, v_p = sweep.sweep_closest_plain(*args)
        torch.cuda.synchronize()
        ok = (torch.equal(t_k, t_p) and torch.equal(i_k, i_p)
              and torch.equal(v_k, v_p))
        err = float((t_k - t_p).abs().max())
        closest = dict(
            name="sweep_closest", equal=ok, max_abs_err=err,
            hits=int((t_k < T_FAR * 0.5).sum()), strips=int(counts.numel()),
            mean_strip_list=float(counts.float().mean()),
            visits=int(v_k.sum()),
            ms=_time_ms(lambda: sweep.sweep_closest(*args), 5),
            plain_ms=_time_ms(lambda: sweep.sweep_closest_plain(*args), 1))
        rec["kernels"].append(closest)

        # Shadow rays toward the light from the primary hits, in the same
        # tile order; misses park as on the main path.
        r = t_k.numel()
        of, df = o_t.reshape(r, 3), d_t.reshape(r, 3)
        tf, idx = t_k.reshape(r), i_k.reshape(r)
        hit = Hit(t=tf, pool=torch.where(tf < T_FAR * 0.5, POOL_TRIANGLE, -1)
                  .to(torch.int32), idx=idx.clamp(min=0))
        surf = surface_at(scene, hit, of, df)
        to_l = scene.lights.position[0] - surf.point
        dist = torch.sqrt(torch.clamp((to_l * to_l).sum(-1), min=1e-12))
        so = surf.point + surf.normal * (RAY_EPS * 4.0)
        sd = to_l / dist[:, None]
        bad = ~surf.valid[:, None]
        so = torch.where(bad, torch.full_like(so, PARK_POS), so)
        sd = torch.where(bad, torch.full_like(sd, PARK_DIR), sd)
        tm = torch.where(surf.valid, dist - RAY_EPS, torch.ones_like(dist))
        so_t, sd_t = so.reshape(o_t.shape), sd.reshape(o_t.shape)
        tm_t = tm.reshape(t_cap.shape)
        slive = so_t[..., 0] < 1e7
        cand2, counts2, _, _ = pk.strip_interval_select(
            so_t, sd_t, slive, accel, kt, ks, RAY_EPS, tm_t=tm_t)
        frac = accel.packed.clone()
        gen = torch.Generator(device=frac.device).manual_seed(0)
        frac[:, 15, :] = torch.rand(frac[:, 15, :].shape, generator=gen,
                                    device=frac.device) * 0.6 + 0.35
        for label, packed in (("scene", accel.packed), ("fractional", frac)):
            a2 = (packed, so_t, sd_t, tm_t, slive, cand2, counts2, RAY_EPS)
            tr_k, vk2 = sweep.sweep_transmittance(*a2)
            tr_p, vp2 = sweep.sweep_transmittance_plain(*a2)
            torch.cuda.synchronize()
            entry = dict(
                name="sweep_transmittance", factors=label,
                equal=torch.equal(tr_k, tr_p) and torch.equal(vk2, vp2),
                max_abs_err=float((tr_k - tr_p).abs().max()),
                shadowed=int((tr_k < 1.0).sum()),
                mean_strip_list=float(counts2.float().mean()),
                visits=int(vk2.sum()))
            if label == "scene":
                entry["ms"] = _time_ms(lambda: sweep.sweep_transmittance(*a2), 5)
                entry["plain_ms"] = _time_ms(
                    lambda: sweep.sweep_transmittance_plain(*a2), 1)
            rec["kernels"].append(entry)
    bad = [k for k in rec["kernels"] if not k["equal"]]
    if bad:
        raise AssertionError(f"kernel and plain version disagree: {bad}")


def phase_main_path(scene, cam, cfg, rec):
    import torch

    from solr_tpu_torch.ops import sweep
    from solr_tpu_torch.ops.render import render_sample

    for k in sweep.LAUNCHES:
        sweep.LAUNCHES[k] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with torch.no_grad():
        img, _ = render_sample(scene, cam, cfg)
        torch.cuda.synchronize()
        warm_s = time.time() - t0
        times = []
        for _ in range(3):
            t0 = time.time()
            img, _ = render_sample(scene, cam, cfg)
            torch.cuda.synchronize()
            times.append(time.time() - t0)
    launches = dict(sweep.LAUNCHES)
    best = min(times)
    n_lights = scene.lights.position.shape[0]
    rays = cfg.n_pixels * cfg.max_bounces * (1 + n_lights)
    finite = bool(torch.isfinite(img).all())
    rec["main_path"] = dict(
        n_tris=N_TRIS, size=SIZE, bounces=BOUNCES, block=BLOCK,
        warmup_s=warm_s, frame_ms=[t * 1000 for t in times],
        best_frame_ms=best * 1000, rays_per_s=rays / best,
        digest=float(img.double().sum()), finite=finite, launches=launches,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    if not finite:
        raise AssertionError("main-path image is not finite")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was never launched: {launches}")
    return launches


def phase_reference(rec, device):
    import numpy as np
    import torch

    from solr_tpu_torch.bench_scene import bench_scene
    from solr_tpu_torch.ops.render import render_sample

    ref = np.load(os.path.join(ROOT, "tests", "data", "torch_bench_ref.npz"))
    size = int(ref["size"])
    scene, cam, cfg = bench_scene(int(ref["n_tris"]), block=int(ref["block"]),
                                  width=size, height=size,
                                  bounces=int(ref["bounces"]), device=device)
    with torch.no_grad():
        img = render_sample(scene, cam, cfg)[0].cpu().numpy()
    err = np.abs(img - ref["image"]).max(-1)
    frac = float((err > MISMATCH_ATOL).mean())
    rec["reference"] = dict(
        size=size, n_tris=int(ref["n_tris"]), block=int(ref["block"]),
        mismatched=int((err > MISMATCH_ATOL).sum()), mismatched_frac=frac,
        budget=MISMATCH_BUDGET, max_err=float(err.max()),
        digest=float(img.astype(np.float64).sum()),
        ref_digest=float(ref["image"].astype(np.float64).sum()))
    if not np.isfinite(img).all() or frac > MISMATCH_BUDGET:
        raise AssertionError(f"reduced frame differs from the reference: "
                             f"{rec['reference']}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from solr_tpu_torch.bench_scene import bench_scene
    from solr_tpu_torch.ops import sweep

    device = torch.device("cuda:0")
    smi = _nvidia_smi()
    rec = {"nvidia_smi": smi, "torch": torch.__version__,
           "cuda": torch.version.cuda, "kernels": [], "failed": []}
    print(f"card: {smi}", flush=True)

    t0 = time.time()
    log = sweep.build(verbose=True)
    rec["build_s"] = time.time() - t0
    print(f"build: {rec['build_s']:.2f} s\n{log.strip()}", flush=True)

    t0 = time.time()
    scene, cam, cfg = bench_scene(N_TRIS, block=BLOCK, width=SIZE,
                                  height=SIZE, bounces=BOUNCES, device=device)
    torch.cuda.synchronize()
    rec["scene_build_s"] = time.time() - t0
    print(f"scene: {scene.triangles.v0.shape[0]} triangles, "
          f"{scene.tri_accel.packed.shape[0]} blocks, "
          f"{rec['scene_build_s']:.2f} s", flush=True)

    launches = {}
    steps = (
        ("kernels", lambda: phase_kernels(scene, cam, cfg, rec)),
        ("main_path", lambda: launches.update(
            phase_main_path(scene, cam, cfg, rec))),
        ("reference", lambda: phase_reference(rec, device)))
    for name, fn in steps:
        try:
            fn()
            print(f"phase {name}: ok", flush=True)
        except Exception:  # every phase runs; any failure fails the run
            rec["failed"].append(name)
            print(f"phase {name}: FAILED\n{traceback.format_exc()}", flush=True)
    print(f"record: {json.dumps(rec)}", flush=True)
    if rec["failed"]:
        print(f"chip_smoke: failed phases {rec['failed']}", file=sys.stderr)
        return 1

    by_name = {}
    for k in rec["kernels"]:
        if "ms" in k:
            by_name[k["name"]] = k
    replaces = {"sweep_closest": "solr_tpu/ops/pallas_kernels.py:175",
                "sweep_transmittance": "solr_tpu/ops/pallas_kernels.py:255"}
    table = [dict(name=n, route="cuda", source="solr_tpu_torch/csrc/sweep.cu",
                  replaces=replaces[n], launches=launches[n],
                  max_abs_err=max(k["max_abs_err"] for k in rec["kernels"]
                                  if k["name"] == n),
                  ms=by_name[n]["ms"], plain_ms=by_name[n]["plain_ms"])
             for n in ("sweep_closest", "sweep_transmittance")]
    print(json.dumps({"kernels": table}))
    print(_nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""GPU smoke run of solr_tpu_torch, the PyTorch + CUDA port.

    python3 chip_smoke.py

Needs one CUDA card (sm_90a, an H100) and nvcc; builds the sweep and BVH
walk kernels from solr_tpu_torch/csrc/ on first use, one nvcc per source,
both started together.  Phases, each of which must pass:

1. the card's name and power limit (nvidia-smi);
2. build the kernels with nvcc and report the build seconds;
3. ``kernels``: B1 and B2 against their plain PyTorch versions at the
   bench shapes: the strip selection of the bench scene's primary rays
   (1M triangles, 512x512, BLOCK=512, K=64, Kt=256) through
   sweep_closest, and of its primary hits' shadow rays through
   sweep_transmittance (once with the scene's 0/1 shadow factors, once
   with fractional ones); t, idx, tr and visits must be bit-equal; both
   times are reported;
4. ``main_path``: render_sample of the full bench frame (2 bounces, hard
   shadows), one warm-up and three timed frames; frame ms, rays/s as
   bench.py counts them, the digest img.sum(), and the launch count of
   B1 and B2 over the run, which must be > 0; the image must be finite;
5. ``reference``: the port on the card against the committed solr_tpu
   CPU reference of a reduced bench frame (tests/data/torch_bench_ref.npz):
   atol 1e-4 outside a budget of 0.2% of pixels (discrete hit flips at
   silhouette edges, where the reference's CPU build contracts the Woop
   and cross product chains into FMAs);
6. ``kernels_molecule``: B3 (sphere) and B5 (cylinder) sweep_closest at
   the molecule frame's primary selection, B1 at its ground's primary
   selection and B2 at its ground's shadow selection (BLOCK=256, B1's
   and B2's second shapes on the main paths), and B4 and B6
   sweep_transmittance at its shadow selection (B2, B4 and B6 with the
   scene's factors and fractional ones), against their plain versions:
   bit-equal, times reported (in phases 3 and 6, each kernel's launch
   order is held to its plain version, a stable sort);
7. ``molecule_path``: render_sample of the full molecule frame (a
   100,000-atom synthetic PDB in ball-and-stick mode over a
   32,768-triangle reflective ground, 512x512, 2 bounces, BLOCK=256),
   one warm-up and three timed frames; frame ms, live rays per bounce,
   the digest, the exactness net's counters, peak memory, scene-build
   seconds, and the launch count of all six kernels over the run, each
   of which must be > 0;
8. ``molecule_reference``: a reduced molecule frame on the card against
   the committed solr_tpu CPU frame (tests/data/torch_molecule_ref.npz,
   whose PDB text's sha256 must match), atol 1e-4 outside 0.2% of
   pixels (f32 differences in the recomputed hit distance, amplified in
   the normals of thin cylinders);
9. ``kernels_walk``: the six BVH walk kernels (csrc/bvh_walk.cu:
   closest hit and transmittance over the triangle, sphere and cylinder
   BVHs) against their plain versions, each on the first call that the
   walk paths below make of it (recorded in one frame of each): t, idx,
   tr, node visits and lane tests bit-equal; kernel and plain times,
   visits and tests per ray, and the bound;
10. ``walk_path``: the bench scene at 1920x1080, 2 bounces: 1080 rows are
   no whole number of 16-pixel tiles, so every triangle query walks the
   triangle BVH; one warm-up and three timed frames as in 4; the walk
   kernels of the triangle pool must launch, and B1, B2 and the
   triangle pool's brute force must not;
11. ``molecule_while``: the full molecule frame with traversal="while",
   one warm-up and three timed frames: all six walk kernels launch and
   no sweep kernel does;
12. ``walk_reference``: reduced frames of those two paths on the card
   against committed solr_tpu CPU frames (tests/data/torch_walk_ref.npz,
   the bench frame at 64x56; torch_molecule_while_ref.npz), as in 5;
13. ``cornell``: the gallery's Cornell box (planes and spheres, brute
   force) built by the port's SceneBuilder, at 64x64 against
   tests/data/torch_cornell_ref.npz as in 5, then at BASELINE.json
   config #1's 256x256 and 2 bounces, one warm-up and three timed
   frames;
14. ``grad_reference``: gradients on the card against the committed
   solr_tpu CPU gradients (tests/data/torch_grad_ref.npz): the inverse
   demo's scene at 64x64 over the pixels outside the stored silhouette
   mask, every leaf (|port - ref| <= tol x max|ref|: 1e-3 for sphere
   geometry, 1e-4 for the others); the reduced bench frame with
   packets (64x64) and with the walk (64x56) against the stored target:
   the vertex-gradient L1 totals within rtol 1e-3 and, over the rows
   the reference touches, the L1 of the difference within 5e-3 of the
   reference's (whole rows move where an f32 edge flip changes a hit);
15. ``grad_main_path``: gradient steps through the full bench frame
   (packets): with_params, render_sample, the MSE against 0.8 x the
   frame's own image, backward, over vertices, sphere centres and radii,
   albedo and light position; one warm-up and three timed steps, ms for
   the refresh, forward and backward, peak memory, the rows with a
   non-zero vertex gradient, and one backward's device profile; every
   gradient finite, the vertex gradients non-zero, B1 and B2 launched
   and no walk kernel;
16. ``grad_walk_path``: the same at 1920x1080 (the walk): the triangle
   walk kernels launch, B1 and B2 do not;
17. ``inverse``: ``python -m solr_tpu_torch.inverse`` on the card at
   128x128: 60 steps, the loss must fall 20x; with ``--geometry`` 300
   steps, the centre error must fall 5x; ms per step and its parts,
   the final errors;
18. ``stereo_path``: BASELINE config #5's single-card frame: the bench
   scene at 1920x1080 SIDE_BY_SIDE with 32x8-pixel tiles (a strip is one
   pixel row), 2 bounces, packets, as in 4 (B1 and B2 launch, no walk
   kernel; when the warm-up frame takes over STEREO_SLOW_S seconds, one
   timed frame instead of three, and the record says so); then the same
   frame with traversal="while" (``stereo_while``): the triangle walks
   launch, B1 and B2 do not;
19. ``stereo_reference``: the side-by-side bench frame cut to 20,000
   triangles at 128x64 with 32x8 tiles, and the gallery's anaglyph
   Cornell box at 64x64, against committed solr_tpu CPU frames
   (tests/data/torch_stereo_ref.npz, torch_anaglyph_ref.npz), as in 5;
20. ``textured_path``: BASELINE config #3, ``render(textured_scene(1920,
   1080), key=Key.seed(0), spp=4)`` (3 bounces, 4 soft-shadow samples,
   antialiasing jitter, fog, sky, six texture maps, ambient occlusion;
   1080 rows: the triangle walk), one warm-up and three timed frames: ms
   per frame and per sample, peak memory, the digest, the launch counts
   (the triangle walks must launch), and one more frame under
   torch.profiler for the device kernels per frame and the device busy
   share (its device time over the best timed frame);
21. ``textured_reference``: the textured scene at 64x64 without a key
   (hard shadows, no jitter; ambient occlusion), with FISHEYE, and with
   a lens (aperture 0.1) and DEPTH_OF_FIELD, against
   tests/data/torch_textured_ref.npz, as in 5.

Each main path runs with the launch counts set to 0 just before it and
read just after; the packet paths (4, 7, 15) must launch no walk kernel.  Prints the full record of the run on one line
("record: {...}"), the kernel table as one JSON line (each kernel's
time, its plain version's, its bound: the larger of the bytes its
inputs and outputs take over 3.35 TB/s and the f32 operations its
visited (ray, primitive) tests take over 67 TFLOP/s, a sphere's or a
cylinder's roots counted only in the pairs of this run that reach
them, and for the walks also the slab tests of the nodes visited; for
the sweeps, its ceiling: those operations at 33.5e12 single-issue
instructions/s, its tests/s, and its design, "staged" for all six,
with its warps per CTA),
the nvidia-smi line, and last {"ok": true, "device": {...}}.  Exits
non-zero, without that line, when any phase fails or no card is
visible.
"""

from __future__ import annotations

import hashlib
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
MOL_ATOMS = 100_000
MOL_GROUND_RES = 128
MOL_BLOCK = 256
WALK_WIDTH, WALK_HEIGHT = 1920, 1080
CORNELL_SIZE = 256
# BASELINE config #5's single-card frame: 32x8 tiles (tools/stereo_1080p.py).
STEREO_TILE = (32, 8)
STEREO_SLOW_S = 60.0
# BASELINE config #3's frame: samples per pixel.
TEXTURED_SPP = 4

# The card's published peaks (NVIDIA H100 SXM data sheet, at 700 W):
# device memory bandwidth and f32 rate outside the tensor cores.  The
# f32 rate counts a fused multiply-add as two operations; the kernels
# build with --fmad=false, so each add or multiply is one instruction of
# its own, and their own ceiling is half of it: 132 SMs x 128 lanes x
# 1.98 GHz single-issue f32 instructions.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F32_SINGLE_ISSUE_PER_S = 33.5e12
# f32 adds, subtracts, multiplies, divides and square roots, counted
# from the functors of solr_tpu_torch/csrc/sweep.cu (WoopT, SphereT,
# CylT; a negated operand is no operation of its own): those of every
# (ray, primitive) test; those of the roots, only in a pair that
# reaches them (_reaches_roots): SphereT's square root and two roots,
# CylT's square root, two side roots and their two axial positions; and
# CylT's per-primitive terms 1/max(h2, 1e-8) and r*r, once per lane of
# a visited block.
OPS_PER_TEST = {"tri": 40, "sphere": 17, "cyl": 75}
OPS_PER_ROOT_PAIR = {"tri": 0, "sphere": 3, "cyl": 9}
OPS_PER_LANE = {"tri": 0, "sphere": 0, "cyl": 2}
REPLACES = {"sweep_closest": "solr_tpu/ops/pallas_kernels.py:175",
            "sweep_transmittance": "solr_tpu/ops/pallas_kernels.py:255"}
BODY = {"tri": "_woop_rows :108", "sphere": "_sphere_rows :136",
        "cyl": "_cyl_rows :158"}
# The walks (solr_tpu_torch/csrc/bvh_walk.cu), counted the same way:
# per ray, the three divisions of 1/d; per node visited, the slab test's
# six subtractions and six multiplies; per leaf lane tested, the pool
# test of TriP (Moller-Trumbore), SphereP or CylP (which also forms the
# axis, |axis|^2, 1/max(|axis|^2, 1e-8) and r*r of its cylinder); per
# pair that reaches its roots, as for the sweeps.  The shadow walk's
# products are not counted.
WALK_OPS_PER_RAY = 3
WALK_OPS_PER_VISIT = 12
WALK_OPS_PER_LANE = {"tri": 52, "sphere": 17, "cyl": 85}
WALK_REPLACES = {"bvh_closest_hit": "solr_tpu/ops/bvh.py:333",
                 "bvh_transmittance": "solr_tpu/ops/bvh.py:397"}
# Gradient checks: per-leaf f32 tolerances of the inverse scene, the
# vertex L1 total's rtol and the rows' L1 difference bound of the bench
# frames, the leaves a gradient step trains, the inverse demo's runs.
GRAD_TOL = {"sphere_center": 1e-3, "sphere_radius": 1e-3, "albedo": 1e-4,
            "ior": 1e-4, "light_position": 1e-4}
GRAD_L1_RTOL = 1e-3
GRAD_ROWS_L1 = 5e-3
GRAD_KEYS = ("vertices", "sphere_center", "sphere_radius", "albedo",
             "light_position")
GRAD_STEPS = 3
INVERSE_SIZE = 128
INVERSE_RUNS = (("inverse", ["--steps", "60"]),
                ("inverse_geometry", ["--steps", "300", "--geometry"]))


def _nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def _reaches_roots(prim, o, d, w):
    """The (ray, primitive) pairs of one block test, broadcast as
    packet.PRIM_T, that need their roots: a sphere's where disc > 0 and
    r > 0, a cylinder's side roots where disc > 0, a > 1e-8 and r > 0
    (packet._sphere_t and packet.cyl_core, in their association)."""
    import torch

    from solr_tpu_torch.constants import INTERSECT_EPS

    oc = [o[..., i, None] - w[..., None, i, :] for i in range(3)]
    dd = [d[..., i, None] for i in range(3)]
    rad = w[..., None, 3, :]

    def dot(u, v):
        return u[0] * v[0] + u[1] * v[1] + u[2] * v[2]

    if prim == "sphere":
        b = dot(oc, dd)
        disc = b * b - (dot(oc, oc) - rad * rad)
        return (disc > 0.0) & (rad > 0.0)
    ax = [w[..., None, i, :] for i in range(4, 7)]
    inv_h2 = 1.0 / torch.clamp(w[..., None, 7, :], min=INTERSECT_EPS)
    d_a, oc_a = dot(dd, ax), dot(oc, ax)
    a = 1.0 - d_a * d_a * inv_h2
    b = dot(oc, dd) - d_a * oc_a * inv_h2
    cq = dot(oc, oc) - oc_a * oc_a * inv_h2 - rad * rad
    disc = b * b - torch.clamp(a, min=INTERSECT_EPS) * cq
    return (disc > 0.0) & (a > INTERSECT_EPS) & (rad > 0.0)


def _plain_with_root_pairs(plain, args, prim):
    """The plain version's outputs on ``args``, and how many of its
    (ray, primitive) tests reach their roots (0 for triangles), counted
    by wrapping its block test: the plain version tests just the blocks
    that the kernel visits."""
    from solr_tpu_torch.ops import packet

    if prim == "tri":
        return plain(*args, prim=prim), 0
    test, pairs = packet.PRIM_T[prim], []

    def counting(o, d, w, t_min):
        pairs.append(int(_reaches_roots(prim, o, d, w).sum()))
        return test(o, d, w, t_min)

    packet.PRIM_T[prim] = counting
    try:
        out = plain(*args, prim=prim)
    finally:
        packet.PRIM_T[prim] = test
    return out, sum(pairs)


def _bound_ms(prim, args, outs, visits, block, root_pairs):
    """(bound ms, "bytes" or "operations", ceiling ms) of one sweep call:
    each input and output tensor counted once against the card's memory
    rate, and the operations of the visited strips' tests (visits x 32
    rays x block primitives x OPS_PER_TEST, OPS_PER_ROOT_PAIR for each
    of the ``root_pairs`` that reach their roots, OPS_PER_LANE for each
    visited block's lanes) against its f32 rate; the ceiling is those
    ops at the single-issue rate of a --fmad=false build."""
    import torch

    tensors = [x for x in args + outs if isinstance(x, torch.Tensor)]
    nbytes = sum(x.numel() * x.element_size() for x in tensors)
    ops = (int(visits) * block * (32 * OPS_PER_TEST[prim] + OPS_PER_LANE[prim])
           + int(root_pairs) * OPS_PER_ROOT_PAIR[prim])
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations",
            ops / F32_SINGLE_ISSUE_PER_S * 1e3)


def _check_kernel(rec, entry, prim, args, label=None, timed=True):
    """One kernel against its plain version on the same inputs: outputs
    bit-equal, and the launch order its entry computes first (the order
    kernel) equal to ``longest_first``; times
    (the order kernel's included), bound and ceiling when ``timed``.
    ``label`` names the factors or the shapes where one kernel is
    checked twice."""
    import torch

    from solr_tpu_torch.kernel_shapes import time_ms
    from solr_tpu_torch.ops import sweep

    kernel = getattr(sweep, entry)
    plain = getattr(sweep, entry + "_plain")
    got = kernel(*args, prim=prim)
    want, root_pairs = _plain_with_root_pairs(plain, args, prim)
    shape = sweep.kernel_shape(entry, prim, args[0].shape[2])
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    counts = args[6]  # its launch order, on the same counts
    equal &= torch.equal(
        sweep.launch_order(sweep._library(), counts, args[5].shape[2]),
        sweep.longest_first(counts))
    torch.cuda.synchronize()
    visits = int(got[-1].sum())
    entry_rec = dict(
        name=sweep.kernel_name(entry, prim), entry=entry, prim=prim, **shape,
        equal=equal,
        max_abs_err=float((got[0] - want[0]).abs().max()),
        strips=int(args[6].numel()),
        mean_strip_list=float(args[6].float().mean()), visits=visits,
        tests=visits * 32 * args[0].shape[2], root_pairs=root_pairs)
    if entry == "sweep_closest":
        entry_rec["hits"] = int((got[0] < 1e30).sum())
    else:
        entry_rec["shadowed"] = int((got[0] < 1.0).sum())
    if label:
        entry_rec["label"] = label
    if timed:
        entry_rec["ms"] = time_ms(lambda: kernel(*args, prim=prim), 5)
        entry_rec["plain_ms"] = time_ms(lambda: plain(*args, prim=prim), 1)
        (entry_rec["bound_ms"], entry_rec["bound_by"],
         entry_rec["ceiling_ms"]) = _bound_ms(
            prim, list(args), list(got), visits, args[0].shape[2],
            root_pairs)
        entry_rec["tests_per_s"] = entry_rec["tests"] / entry_rec["ms"] * 1e3
    rec["kernels"].append(entry_rec)
    return got


def _assert_equal(rec):
    bad = [k for k in rec["kernels"] if not k["equal"]]
    if bad:
        raise AssertionError(f"kernel and plain version disagree: {bad}")


def phase_kernels(scene, cam, cfg, rec):
    """B1 and B2 against their plain versions at the bench shapes."""
    import torch

    from solr_tpu_torch.kernel_shapes import (fractional, primary_tiles,
                                              shadow_rays, sweep_args,
                                              triangle_hits)

    accel = scene.tri_accel
    with torch.no_grad():
        o_t, d_t, live = primary_tiles(cam, cfg)
        args = sweep_args(accel, o_t, d_t, live, cfg, True)
        t_k, i_k, _ = _check_kernel(rec, "sweep_closest", "tri", args)
        # Shadow rays toward the light from the primary triangle hits.
        so_t, sd_t, tm_t, slive = shadow_rays(scene, o_t, d_t,
                                              triangle_hits(t_k, i_k))
        args = sweep_args(accel, so_t, sd_t, slive, cfg, False, tm_t)
        _check_kernel(rec, "sweep_transmittance", "tri", args, "scene")
        _check_kernel(rec, "sweep_transmittance", "tri",
                      (fractional(accel.packed),) + args[1:], "fractional",
                      timed=False)
    _assert_equal(rec)


def phase_kernels_molecule(scene, cam, cfg, rec):
    """B3-B6 against their plain versions at the molecule frame's primary
    and shadow selections, and B1 and B2 at its ground's primary and
    shadow selections (BLOCK=256, the second shape B1 and B2 run at on
    the main paths)."""
    import torch

    from solr_tpu_torch.kernel_shapes import (fractional, primary_tiles,
                                              shadow_rays, sweep_args)
    from solr_tpu_torch.ops.traverse import scene_closest_hit

    spec = (cfg.packet_rays, cfg.packet_max_blocks, cfg.packet_tile_cand,
            cfg.packet_exact)
    with torch.no_grad():
        o_t, d_t, live = primary_tiles(cam, cfg)
        # The frame's primary hits over all pools, for the shadow rays.
        hit = scene_closest_hit(scene, o_t.reshape(-1, 3), d_t.reshape(-1, 3),
                                packet=spec)
        so_t, sd_t, tm_t, slive = shadow_rays(scene, o_t, d_t, hit)
        args = sweep_args(scene.tri_accel, o_t, d_t, live, cfg, True)
        _check_kernel(rec, "sweep_closest", "tri", args, "molecule ground")
        args = sweep_args(scene.tri_accel, so_t, sd_t, slive, cfg, False,
                          tm_t)
        _check_kernel(rec, "sweep_transmittance", "tri", args,
                      "molecule ground")
        _check_kernel(rec, "sweep_transmittance", "tri",
                      (fractional(args[0]),) + args[1:],
                      "molecule ground, fractional", timed=False)
        for prim, accel in (("sphere", scene.sph_accel),
                            ("cyl", scene.cyl_accel)):
            args = sweep_args(accel, o_t, d_t, live, cfg, True)
            _check_kernel(rec, "sweep_closest", prim, args)
            args = sweep_args(accel, so_t, sd_t, slive, cfg, False, tm_t)
            _check_kernel(rec, "sweep_transmittance", prim, args, "scene")
            _check_kernel(rec, "sweep_transmittance", prim,
                          (fractional(accel.packed),) + args[1:],
                          "fractional", timed=False)
    _assert_equal(rec)


def _first_walk_calls(scene, cam, cfg):
    """The arguments of the first call of each walk (entry point x
    primitive kind) in one frame, read by wrapping the wrappers."""
    import torch

    from solr_tpu_torch.ops import bvh
    from solr_tpu_torch.ops.render import render_sample

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
            render_sample(scene, cam, cfg)
        torch.cuda.synchronize()
    finally:
        for e in bvh.ENTRIES:
            setattr(bvh, e, inner[e])
    return calls


def _walk_root_pairs(scene, prim, o, d, first, cnt, leaf_size):
    """How many tested (ray, leaf lane) pairs of one walk step reach their
    roots (_reaches_roots on the lanes' rows)."""
    import torch

    lanes = torch.arange(leaf_size, device=cnt.device, dtype=cnt.dtype)
    if prim == "sphere":
        p = scene.spheres
        n = p.radius.shape[0]
        pids = (first[:, None] + lanes).clamp(0, n - 1).long()
        w = torch.cat([p.center[pids], p.radius[pids][..., None]], -1)
    else:
        p = scene.cylinders
        n = p.radius.shape[0]
        pids = (first[:, None] + lanes).clamp(0, n - 1).long()
        axis = p.p1[pids] - p.p0[pids]
        h2 = (axis[..., 0] * axis[..., 0] + axis[..., 1] * axis[..., 1]
              + axis[..., 2] * axis[..., 2])
        w = torch.cat([p.p0[pids], p.radius[pids][..., None], axis,
                       h2[..., None]], -1)
    reach = _reaches_roots(prim, o[:, None, :], d[:, None, :],
                           w.transpose(1, 2))[:, 0, :]
    return int((reach & (lanes < cnt[:, None])).sum())


def _walk_plain_with_root_pairs(plain, args, prim):
    """The plain walk's outputs on ``args``, and how many of its tested
    (ray, lane) pairs reach their roots (0 for triangles), counted by
    wrapping its leaf test."""
    from solr_tpu_torch.ops import bvh

    if prim == "tri":
        return plain(*args), 0
    leaf_t, pairs = bvh._leaf_t, []

    def counting(scene, prim_, o, d, first, cnt, leaf_size, t_min):
        pairs.append(_walk_root_pairs(scene, prim_, o, d, first, cnt,
                                      leaf_size))
        return leaf_t(scene, prim_, o, d, first, cnt, leaf_size, t_min)

    bvh._leaf_t = counting
    try:
        out = plain(*args)
    finally:
        bvh._leaf_t = leaf_t
    return out, sum(pairs)


def _walk_bound_ms(prim, closest, scene, tree, args, outs, visits, tests,
                   root_pairs):
    """(bound ms, "bytes" or "operations") of one walk call: its rays,
    outputs, node arrays and pool arrays (and the materials' factors for
    the shadow walk) each counted once against the memory rate, and the
    WALK_OPS_* operations of this run's visits, tests and root pairs
    against the f32 rate."""
    import torch

    p = {"tri": scene.triangles, "sphere": scene.spheres,
         "cyl": scene.cylinders}[prim]
    pool = {"tri": ("v0", "v1", "v2"), "sphere": ("center", "radius"),
            "cyl": ("p0", "p1", "radius")}[prim]
    tensors = [x for x in list(args) + list(outs)
               if isinstance(x, torch.Tensor)]
    tensors += [tree.aabb_min, tree.aabb_max, tree.skip, tree.first_prim,
                tree.prim_count] + [getattr(p, k) for k in pool]
    if not closest:
        m = scene.materials
        tensors += [p.material, m.emission, m.transparency]
    nbytes = sum(x.numel() * x.element_size() for x in tensors)
    n_rays = args[3].shape[0]
    ops = (n_rays * WALK_OPS_PER_RAY + visits * WALK_OPS_PER_VISIT
           + tests * WALK_OPS_PER_LANE[prim]
           + root_pairs * OPS_PER_ROOT_PAIR[prim])
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations")


def _check_walk(rec, scene, call):
    """One walk kernel against its plain version on one recorded call:
    t or tr, idx, visits and tests bit-equal; times, visits and tests per
    ray, and the bound."""
    import torch

    from solr_tpu_torch.kernel_shapes import time_ms
    from solr_tpu_torch.ops import bvh

    entry, prim, tree, o, d, t_min, t_max = call
    closest = entry == "bvh_closest_hit"
    launch = bvh.launch_closest if closest else bvh.launch_transmittance
    plain = (bvh.bvh_closest_hit_plain if closest
             else bvh.bvh_transmittance_plain)
    args = (scene, tree, prim, o, d, t_min, t_max)
    got = launch(bvh._library(), *args)
    want, root_pairs = _walk_plain_with_root_pairs(plain, args, prim)
    torch.cuda.synchronize()
    visits, tests = int(want[-2].sum()), int(want[-1].sum())
    n = o.shape[0]
    entry_rec = dict(
        name=bvh.kernel_name(entry, prim), entry=entry, prim=prim,
        equal=all(torch.equal(a, b) for a, b in zip(got, want)),
        max_abs_err=float((got[0] - want[0]).abs().max()), rays=n,
        nodes=tree.n_nodes, visits_per_ray=visits / n,
        tests_per_ray=tests / n, root_pairs=root_pairs,
        ms=time_ms(lambda: launch(bvh._library(), *args), 5),
        plain_ms=time_ms(lambda: plain(*args), 1))
    if closest:
        entry_rec["hits"] = int((want[0] < 1e30).sum())
    else:
        entry_rec["shadowed"] = int((want[0] < 1.0).sum())
    entry_rec["bound_ms"], entry_rec["bound_by"] = _walk_bound_ms(
        prim, closest, scene, tree, args, got, visits, tests, root_pairs)
    rec["walk_kernels"].append(entry_rec)


def phase_kernels_walk(scenes, rec):
    """The six walk kernels on the first calls of the walk paths: the
    triangle pool's from the 1080p bench frame, the sphere and cylinder
    pools' from the molecule frame with traversal="while"."""
    import dataclasses

    scene, cam, cfg = scenes["bench"]
    calls = _first_walk_calls(scene, cam, _walk_cfg(cfg))
    for prim in ("tri",):
        for entry in ("bvh_closest_hit", "bvh_transmittance"):
            _check_walk(rec, scene, calls[f"{entry}_{prim}"])
    scene, cam, cfg = scenes["molecule"]
    calls = _first_walk_calls(scene, cam,
                              dataclasses.replace(cfg, traversal="while"))
    for prim in ("sphere", "cyl"):
        for entry in ("bvh_closest_hit", "bvh_transmittance"):
            _check_walk(rec, scene, calls[f"{entry}_{prim}"])
    bad = [k["name"] for k in rec["walk_kernels"] if not k["equal"]]
    if bad:
        raise AssertionError(f"walk kernel and plain version disagree: {bad}")


def _walk_cfg(cfg):
    import dataclasses

    return dataclasses.replace(cfg, width=WALK_WIDTH, height=WALK_HEIGHT)


def _reset_counts():
    from solr_tpu_torch.ops import bvh, sweep, traverse

    for counts in (sweep.LAUNCHES, bvh.LAUNCHES, traverse.NET_STATS,
                   traverse.BRUTE_CALLS):
        for k in counts:
            counts[k] = 0


def _live_rays_per_bounce(scene, cam, cfg):
    """Live rays entering each bounce of one frame (the rays whose origin
    is not parked), read by wrapping the render loop's closest-hit
    call."""
    import torch

    from solr_tpu_torch.constants import PARK_THRESHOLD
    from solr_tpu_torch.ops import render

    live, inner = [], render.scene_closest_hit

    def counting(scene, o, d, **kw):
        live.append(int((o[:, 0] < PARK_THRESHOLD).sum()))
        return inner(scene, o, d, **kw)

    render.scene_closest_hit = counting
    try:
        img, _ = render.render_sample(scene, cam, cfg)
        torch.cuda.synchronize()
    finally:
        render.scene_closest_hit = inner
    return img, live


def phase_path(scene, cam, cfg, rec, key, kernels, frames=3, idle=(),
               no_brute=(), slow_s=None):
    """One main path: the launch and net counts set to 0, render_sample
    once as a warm-up (counting live rays per bounce) and ``frames``
    timed times (one when the warm-up took over ``slow_s`` seconds), the
    counts read.  Every kernel in ``kernels`` must have launched, none in
    ``idle``, and no pool in ``no_brute`` may have been brute-forced."""
    import torch

    from solr_tpu_torch.ops import bvh, sweep, traverse
    from solr_tpu_torch.ops.render import render_sample

    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with torch.no_grad():
        img, live = _live_rays_per_bounce(scene, cam, cfg)
        warm_s = time.time() - t0
        cut = slow_s is not None and warm_s > slow_s
        if cut:
            frames = 1
        times = []
        for _ in range(frames):
            t0 = time.time()
            img, _ = render_sample(scene, cam, cfg)
            torch.cuda.synchronize()
            times.append(time.time() - t0)
    launches = {**sweep.LAUNCHES, **bvh.LAUNCHES}
    best = min(times)
    n_lights = scene.lights.position.shape[0]
    rays = cfg.n_pixels * cfg.max_bounces * (1 + n_lights)
    finite = bool(torch.isfinite(img).all())
    rec[key] = dict(
        width=cfg.width, height=cfg.height, bounces=cfg.max_bounces,
        traversal=cfg.traversal, camera_mode=cfg.camera_mode.name,
        tile=[cfg.packet_tile_w, cfg.packet_tile_h],
        block=scene.tri_accel.block if scene.tri_accel else None,
        warmup_s=warm_s, timed_frames=frames,
        frames_cut=(f"warm-up {warm_s:.1f} s > {slow_s} s: one timed frame"
                    if cut else None),
        frame_ms=[t * 1000 for t in times], best_frame_ms=best * 1000,
        rays_per_s=rays / best, live_rays_per_bounce=live,
        digest=float(img.double().sum()), finite=finite, launches=launches,
        net_stats=dict(traverse.NET_STATS),
        brute_calls=dict(traverse.BRUTE_CALLS),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    if not finite:
        raise AssertionError(f"{key} image is not finite")
    missing = [k for k in kernels if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on {key}: {missing}")
    stray = [k for k in idle if launches[k]] + [
        f"brute force over {k}" for k in no_brute if traverse.BRUTE_CALLS[k]]
    if stray:
        raise AssertionError(f"launched or called on {key}: {stray}")
    return launches


def _hold_to(rec, key, img, ref, **extra):
    import numpy as np

    err = np.abs(img - ref).max(-1)
    frac = float((err > MISMATCH_ATOL).mean())
    rec[key] = dict(
        mismatched=int((err > MISMATCH_ATOL).sum()), mismatched_frac=frac,
        budget=MISMATCH_BUDGET, max_err=float(err.max()),
        digest=float(img.astype(np.float64).sum()),
        ref_digest=float(ref.astype(np.float64).sum()), **extra)
    if not np.isfinite(img).all() or frac > MISMATCH_BUDGET:
        raise AssertionError(f"{key}: the frame differs from the reference: "
                             f"{rec[key]}")


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
    _hold_to(rec, "reference", img, ref["image"], size=size,
             n_tris=int(ref["n_tris"]), block=int(ref["block"]))


def phase_molecule_reference(rec, device):
    import numpy as np
    import torch

    from solr_tpu_torch.molecule_scene import molecule_scene, synthetic_pdb
    from solr_tpu_torch.ops.render import render_sample

    ref = np.load(os.path.join(ROOT, "tests", "data",
                               "torch_molecule_ref.npz"))
    n_atoms, size = int(ref["n_atoms"]), int(ref["size"])
    sha = hashlib.sha256(synthetic_pdb(n_atoms).encode()).hexdigest()
    if sha != str(ref["pdb_sha256"]):
        raise AssertionError(f"the synthetic PDB text differs from the one "
                             f"the reference read: {sha}")
    scene, cam, cfg = molecule_scene(
        n_atoms, int(ref["ground_res"]), width=size, height=size,
        bounces=int(ref["bounces"]), block=int(ref["block"]), device=device)
    with torch.no_grad():
        img = render_sample(scene, cam, cfg)[0].cpu().numpy()
    _hold_to(rec, "molecule_reference", img, ref["image"], size=size,
             n_atoms=n_atoms, block=int(ref["block"]), pdb_sha256=sha)


def phase_walk_reference(rec, device):
    """The reduced walk frames on the card against their committed
    solr_tpu CPU frames."""
    import dataclasses

    import numpy as np
    import torch

    from solr_tpu_torch.bench_scene import bench_scene
    from solr_tpu_torch.molecule_scene import molecule_scene
    from solr_tpu_torch.ops.render import render_sample

    data = os.path.join(ROOT, "tests", "data")
    ref = np.load(os.path.join(data, "torch_walk_ref.npz"))
    scene, cam, cfg = bench_scene(int(ref["n_tris"]), block=int(ref["block"]),
                                  width=int(ref["size"]),
                                  height=int(ref["height"]),
                                  bounces=int(ref["bounces"]), device=device)
    with torch.no_grad():
        img = render_sample(scene, cam, cfg)[0].cpu().numpy()
    walk = {}
    _hold_to(walk, "bench", img, ref["image"], width=cfg.width,
             height=cfg.height, n_tris=int(ref["n_tris"]))
    ref = np.load(os.path.join(data, "torch_molecule_while_ref.npz"))
    scene, cam, cfg = molecule_scene(
        int(ref["n_atoms"]), int(ref["ground_res"]), width=int(ref["size"]),
        height=int(ref["size"]), bounces=int(ref["bounces"]),
        block=int(ref["block"]), device=device)
    cfg = dataclasses.replace(cfg, traversal=str(ref["traversal"]))
    with torch.no_grad():
        img = render_sample(scene, cam, cfg)[0].cpu().numpy()
    _hold_to(walk, "molecule_while", img, ref["image"], size=cfg.width,
             n_atoms=int(ref["n_atoms"]))
    rec["walk_reference"] = walk


def phase_cornell(rec, device):
    """The port's Cornell box at 64x64 against the gallery's, rendered by
    solr_tpu on the CPU; then BASELINE config #1's frame, timed."""
    import numpy as np
    import torch

    from solr_tpu_torch.cornell_scene import cornell_scene
    from solr_tpu_torch.ops.render import render_sample

    ref = np.load(os.path.join(ROOT, "tests", "data", "torch_cornell_ref.npz"))
    scene, cam, cfg = cornell_scene(int(ref["size"]), int(ref["size"]),
                                    int(ref["bounces"]), device=device)
    with torch.no_grad():
        img = render_sample(scene, cam, cfg)[0].cpu().numpy()
    _hold_to(rec, "cornell_reference", img, ref["image"], size=cfg.width)
    scene, cam, cfg = cornell_scene(CORNELL_SIZE, CORNELL_SIZE, BOUNCES,
                                    device=device)
    return phase_path(scene, cam, cfg, rec, "cornell", [])


def _stereo_cfg(cfg, width=WALK_WIDTH, height=WALK_HEIGHT):
    import dataclasses

    from solr_tpu_torch.types import CameraMode

    return dataclasses.replace(
        cfg, width=width, height=height, camera_mode=CameraMode.SIDE_BY_SIDE,
        packet_tile_w=STEREO_TILE[0], packet_tile_h=STEREO_TILE[1])


def phase_stereo_reference(rec, device):
    """The reduced side-by-side bench frame (32x8 tiles) and the
    anaglyph Cornell box on the card against their committed solr_tpu
    CPU frames."""
    import dataclasses

    import numpy as np
    import torch

    from solr_tpu_torch.bench_scene import bench_scene
    from solr_tpu_torch.cornell_scene import cornell_scene
    from solr_tpu_torch.ops.render import render_sample
    from solr_tpu_torch.types import CameraMode

    data = os.path.join(ROOT, "tests", "data")
    ref = np.load(os.path.join(data, "torch_stereo_ref.npz"))
    scene, cam, cfg = bench_scene(int(ref["n_tris"]), block=int(ref["block"]),
                                  bounces=int(ref["bounces"]), device=device)
    cfg = _stereo_cfg(cfg, int(ref["width"]), int(ref["height"]))
    assert [cfg.packet_tile_w, cfg.packet_tile_h] == [int(ref["tile_w"]),
                                                      int(ref["tile_h"])]
    out = {}
    with torch.no_grad():
        img = render_sample(scene, cam, cfg)[0].cpu().numpy()
    _hold_to(out, "side_by_side", img, ref["image"], width=cfg.width,
             height=cfg.height, tile=[cfg.packet_tile_w, cfg.packet_tile_h])
    ref = np.load(os.path.join(data, "torch_anaglyph_ref.npz"))
    size = int(ref["size"])
    scene, cam, cfg = cornell_scene(size, size, int(ref["bounces"]),
                                    device=device)
    cfg = dataclasses.replace(cfg, camera_mode=CameraMode.ANAGLYPH)
    with torch.no_grad():
        img = render_sample(scene, cam, cfg)[0].cpu().numpy()
    _hold_to(out, "anaglyph", img, ref["image"], size=size)
    rec["stereo_reference"] = out


def phase_textured_path(rec, device, kernels, frames=3):
    """BASELINE config #3 at 1920x1080 through ``render`` with a key and
    TEXTURED_SPP samples: the launch counts set to 0, one warm-up and
    ``frames`` timed frames, the counts read (every kernel in
    ``kernels`` must have launched); then one frame under
    torch.profiler."""
    import torch

    from solr_tpu_torch.ops import bvh, sweep, traverse
    from solr_tpu_torch.ops.render import render
    from solr_tpu_torch.ops.rng import Key
    from solr_tpu_torch.textured_scene import textured_scene

    t0 = time.time()
    scene, cam, cfg = textured_scene(WALK_WIDTH, WALK_HEIGHT, device=device)
    _sync(device)
    build_s = time.time() - t0
    key = Key.seed(0, device)

    def frame():
        return render(scene, cam, cfg, key, spp=TEXTURED_SPP)

    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        t0 = time.time()
        img = frame()
        _sync(device)
        warm_s = time.time() - t0
        times = []
        for _ in range(frames):
            t0 = time.time()
            img = frame()
            _sync(device)
            times.append(time.time() - t0)
        launches = {**sweep.LAUNCHES, **bvh.LAUNCHES}
        brute = dict(traverse.BRUTE_CALLS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        profile = _device_profile(frame)
    best = min(times)
    finite = bool(torch.isfinite(img).all())
    rec["textured_path"] = dict(
        width=cfg.width, height=cfg.height, bounces=cfg.max_bounces,
        spp=TEXTURED_SPP, shadow_samples=cfg.shadow_samples,
        postfx=cfg.postfx.mode.name, triangles=int(scene.triangles.v0.shape[0]),
        textures=scene.textures.count, scene_build_s=build_s, warmup_s=warm_s,
        frame_ms=[t * 1e3 for t in times], best_frame_ms=best * 1e3,
        best_sample_ms=best * 1e3 / TEXTURED_SPP,
        device_kernels_per_frame=profile["device_kernels"],
        # The profiler slows the host, not the kernels: the profiled
        # frame's device time over the best unprofiled frame.
        device_busy_share=profile["device_busy_ms"] / (best * 1e3),
        profile=profile, digest=float(img.double().sum()), finite=finite,
        launches=launches, brute_calls=brute, peak_mem_gb=peak)
    if not finite:
        raise AssertionError("textured_path image is not finite")
    missing = [k for k in kernels if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on textured_path: "
                             f"{missing}")
    return launches


def phase_textured_reference(rec, device):
    """The textured scene at 64x64 without a key, plain, with FISHEYE and
    with a lens and DEPTH_OF_FIELD, against the committed solr_tpu CPU
    frames."""
    import dataclasses

    import numpy as np
    import torch

    from solr_tpu_torch.ops.render import render
    from solr_tpu_torch.textured_scene import textured_scene
    from solr_tpu_torch.types import CameraMode, PostFxConfig, PostFxMode

    ref = np.load(os.path.join(ROOT, "tests", "data",
                               "torch_textured_ref.npz"))
    size = int(ref["size"])
    scene, cam, cfg = textured_scene(size, size, int(ref["bounces"]),
                                     device=device)
    lens = cam.replace(
        aperture=torch.tensor(float(ref["aperture"]), device=device),
        focal_distance=torch.tensor(float(ref["focal"]), device=device))
    cases = {
        "image": (cam, cfg),
        "image_fisheye": (cam, dataclasses.replace(
            cfg, camera_mode=CameraMode.FISHEYE)),
        "image_dof": (lens, dataclasses.replace(cfg, postfx=PostFxConfig(
            mode=PostFxMode.DEPTH_OF_FIELD))),
    }
    out, bad = {}, []
    for name, (c, f) in cases.items():
        with torch.no_grad():
            img = render(scene, c, f).cpu().numpy()
        try:
            _hold_to(out, name, img, ref[name], size=size)
        except AssertionError:
            bad.append(name)
    rec["textured_reference"] = out
    if bad:
        raise AssertionError(f"textured frames differ from the reference: "
                             f"{bad}: {out}")


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _leaves(params, keys=None):
    """Fresh copies of a Scene.params tree; those under ``keys`` (all when
    None) are leaf tensors that require grad."""
    def leaf(x, grad):
        return x.detach().clone().requires_grad_(grad)

    return {k: (tuple(leaf(x, keys is None or k in keys) for x in v)
                if isinstance(v, tuple) else leaf(v, keys is None or k in keys))
            for k, v in params.items()}


def _grad_leaf_list(tree):
    """The tensors of a Scene.params-like tree, flat."""
    out = []
    for v in tree.values():
        out += list(v) if isinstance(v, tuple) else [v]
    return out


def _grad_tree(p):
    import torch

    def g(x):
        return torch.zeros_like(x) if x.grad is None else x.grad

    return {k: tuple(g(x) for x in v) if isinstance(v, tuple) else g(v)
            for k, v in p.items()}


def _hold_grads_inverse(ref, device):
    """The inverse scene's masked gradients against the reference's."""
    import numpy as np
    import torch

    from solr_tpu_torch import inverse
    from solr_tpu_torch.ops.render import render_sample
    from solr_tpu_torch.types import RenderConfig

    size = int(ref["inverse_size"])
    scene, cam = inverse.build_scene(device)
    cfg = RenderConfig(width=size, height=size, max_bounces=BOUNCES)
    with torch.no_grad():
        img, _ = render_sample(scene, cam, cfg)
        start, _ = inverse.perturb(scene.params, True)
        _, start_depth = render_sample(scene.with_params(start), cam, cfg)
    target = img[..., :3] * float(ref["target_scale"])
    keep = ~torch.as_tensor(ref["inverse_mask"], device=device)
    p = _leaves(scene.params)
    img, depth = render_sample(scene.with_params(p), cam, cfg)
    loss = inverse.rgbd_loss(img, depth, target, start_depth, True, keep)
    loss.backward()
    g = _grad_tree(p)
    out = dict(size=size, masked=int((~keep).sum()), loss=float(loss),
               ref_loss=float(ref["inverse_loss"]), leaves={})
    bad = []
    for k, tol in GRAD_TOL.items():
        got = g[k].double().cpu().numpy()
        want = ref[f"inverse_{k}"].astype(np.float64)
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        out["leaves"][k] = dict(max_err=err, ref_max=scale, tol=tol,
                                finite=bool(np.isfinite(got).all()))
        if not np.isfinite(got).all() or err > tol * scale:
            bad.append(k)
    return out, bad


def _hold_grads_bench(ref, name, device):
    """A reduced bench frame's vertex gradients against the reference's
    non-zero rows."""
    import numpy as np
    import torch

    from solr_tpu_torch.bench_scene import bench_scene
    from solr_tpu_torch.ops.render import render_sample

    scene, cam, cfg = bench_scene(
        int(ref["n_tris"]), block=int(ref["block"]), width=int(ref["size"]),
        height=int(ref[f"{name}_height"]), bounces=int(ref["bounces"]),
        device=device)
    target = torch.as_tensor(ref[f"{name}_target"], device=device)
    p = _leaves(scene.params)
    img, _ = render_sample(scene.with_params(p), cam, cfg)
    loss = ((img[..., :3] - target) ** 2).mean()
    loss.backward()
    g = _grad_tree(p)
    l1 = l1_ref = diff = 0.0
    rows = ref_rows = shared = 0
    for i in range(3):
        got = g["vertices"][i].double().cpu().numpy()
        idx = ref[f"{name}_v{i}_idx"]
        want = ref[f"{name}_v{i}_rows"].astype(np.float64)
        touched = np.abs(got).sum(-1) > 0
        l1 += float(np.abs(got).sum())
        l1_ref += float(np.abs(want).sum())
        diff += float(np.abs(got[idx] - want).sum())
        rows += int(touched.sum())
        ref_rows += len(idx)
        shared += int(touched[idx].sum())
    finite = all(bool(torch.isfinite(x).all()) for x in
                 list(g["vertices"]) + [g[k] for k in GRAD_TOL])
    out = dict(width=cfg.width, height=cfg.height, loss=float(loss),
               ref_loss=float(ref[f"{name}_loss"]), vertex_l1=l1,
               ref_vertex_l1=l1_ref, l1_rel_err=abs(l1 / l1_ref - 1.0),
               rows_l1_rel_err=diff / l1_ref, rows=rows, ref_rows=ref_rows,
               shared_rows=shared, finite=finite)
    bad = (not finite or out["l1_rel_err"] > GRAD_L1_RTOL
           or out["rows_l1_rel_err"] > GRAD_ROWS_L1)
    return out, bad


def phase_grad_reference(rec, device):
    """Gradients on ``device`` against the committed solr_tpu CPU
    gradients (tests/data/torch_grad_ref.npz)."""
    import numpy as np

    ref = np.load(os.path.join(ROOT, "tests", "data", "torch_grad_ref.npz"))
    out, bad = _hold_grads_inverse(ref, device)
    res = {"inverse": out}
    for name in ("bench", "walk"):
        res[name], failed = _hold_grads_bench(ref, name, device)
        if failed:
            bad.append(name)
    rec["grad_reference"] = res
    if bad:
        raise AssertionError(f"gradients differ from the reference: {bad}: "
                             f"{res}")


def _device_profile(fn, top=8):
    """Device busy time and the largest kernels of ``fn()`` under
    torch.profiler, and the device time of its accumulating index writes
    (the backward of ``x[i]`` gathers) by the shapes of the table
    written and of the values."""
    import collections

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        _sync("cuda")
    wall = time.perf_counter() - t0
    index_puts = sorted(
        (dict(table=e.input_shapes[0], values=e.input_shapes[2],
              ms=e.device_time_total / 1e3, calls=e.count)
         for e in prof.key_averages(group_by_input_shape=True)
         if e.key == "aten::_index_put_impl_"), key=lambda r: -r["ms"])
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
        by_name[e.name][1] += 1
    largest = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return dict(wall_ms=wall * 1e3, device_kernels=len(kernels),
                device_busy_ms=busy,
                largest=[dict(name=n[:100], ms=ms, launches=c)
                         for n, (ms, c) in largest],
                index_puts=index_puts[:top])


def phase_grad_path(scene, cam, cfg, rec, key, kernels, idle=(),
                    steps=GRAD_STEPS):
    """Gradient steps through one main path: the MSE of render_sample
    against 0.8 x the frame's own image over GRAD_KEYS.  A step is
    with_params (refresh), render_sample and the loss (forward) and
    backward, each timed with a sync on each side.  The launch counts
    are set to 0 just before the warm-up step and read after the last;
    every kernel in ``kernels`` must have launched, none in ``idle``;
    every gradient must be finite and the vertex gradients non-zero.
    One more backward runs under torch.profiler."""
    import torch

    from solr_tpu_torch.ops import bvh, sweep
    from solr_tpu_torch.ops.render import render_sample

    device = scene.device
    with torch.no_grad():
        target = render_sample(scene, cam, cfg)[0][..., :3] * 0.8
    p = _leaves(scene.params, GRAD_KEYS)

    def forward():
        _sync(device)
        t0 = time.perf_counter()
        s = scene.with_params(p)
        _sync(device)
        t1 = time.perf_counter()
        img, _ = render_sample(s, cam, cfg)
        loss = ((img[..., :3] - target) ** 2).mean()
        _sync(device)
        return loss, (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3

    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    parts = []
    for _ in range(1 + steps):
        for x in _grad_leaf_list(p):
            x.grad = None
        loss, refresh_ms, forward_ms = forward()
        t0 = time.perf_counter()
        loss.backward()
        _sync(device)
        parts.append(dict(refresh_ms=refresh_ms, forward_ms=forward_ms,
                          backward_ms=(time.perf_counter() - t0) * 1e3))
    launches = {**sweep.LAUNCHES, **bvh.LAUNCHES}
    peak = torch.cuda.max_memory_allocated() / 2**30
    g = _grad_tree(p)
    finite = all(bool(torch.isfinite(x).all()) for x in _grad_leaf_list(g))
    rows = int(sum((x.abs().sum(-1) > 0) for x in g["vertices"]).gt(0).sum())
    timed = parts[1:]
    for x in _grad_leaf_list(p):
        x.grad = None
    loss, _, _ = forward()
    profile = _device_profile(loss.backward)
    rec[key] = dict(
        width=cfg.width, height=cfg.height, bounces=cfg.max_bounces,
        triangles=int(scene.triangles.v0.shape[0]), loss=float(loss),
        steps=parts, step_ms=[sum(q.values()) for q in timed],
        best_step_ms=min(sum(q.values()) for q in timed),
        best={k: min(q[k] for q in timed) for k in timed[0]},
        peak_mem_gb=peak, vertex_rows_with_grad=rows, finite=finite,
        launches=launches, backward_profile=profile)
    if not finite or rows == 0:
        raise AssertionError(f"{key}: gradients not finite or no vertex "
                             f"gradient: {rec[key]}")
    missing = [k for k in kernels if launches[k] <= 0]
    stray = [k for k in idle if launches[k]]
    if missing or stray:
        raise AssertionError(f"{key}: kernels never launched {missing}, "
                             f"launched {stray}")
    return launches


def phase_inverse(rec):
    """The inverse demo on the card at INVERSE_SIZE: each run of
    INVERSE_RUNS from a fresh checkpoint directory; the demo itself
    raises when it misses its bar."""
    import shutil

    from solr_tpu_torch import inverse

    out = os.path.join(ROOT, "build", "chip_smoke_inverse")
    shutil.rmtree(out, ignore_errors=True)
    res = {}
    for name, args in INVERSE_RUNS:
        try:
            res[name] = inverse.main(args + [
                "--size", str(INVERSE_SIZE), "--device", "cuda",
                "--ckpt-dir", os.path.join(out, name, "ckpt"),
                "--metrics", os.path.join(out, name, "metrics.jsonl"),
                "--out", os.path.join(out, name, "inverse.png")])
        except SystemExit as e:
            rec["inverse"] = res
            raise AssertionError(f"{name}: {e}") from None
    rec["inverse"] = res


def _kernel_table(rec, paths):
    """The kernels JSON line: each kernel's timed comparison, with its
    launches from the main path whose shapes it was timed at."""
    from solr_tpu_torch.ops import sweep

    table = []
    for prim in sweep.PRIMS:
        path = "main_path" if prim == "tri" else "molecule_path"
        for entry in ("sweep_closest", "sweep_transmittance"):
            name = sweep.kernel_name(entry, prim)
            runs = [k for k in rec["kernels"] if k["name"] == name]
            timed = next(k for k in runs if "ms" in k)
            table.append(dict(
                name=name, route="cuda", design=timed["design"],
                warps_per_cta=timed["warps_per_cta"],
                source="solr_tpu_torch/csrc/sweep.cu",
                replaces=f"{REPLACES[entry]} + {BODY[prim]}",
                launches=paths[path][name],
                max_abs_err=max(k["max_abs_err"] for k in runs),
                ms=timed["ms"], plain_ms=timed["plain_ms"],
                bound_ms=timed["bound_ms"], bound_by=timed["bound_by"],
                library_ms=None, ceiling_ms=timed["ceiling_ms"],
                tests_per_s=timed["tests_per_s"]))
    for k in rec["walk_kernels"]:
        path = "walk_path" if k["prim"] == "tri" else "molecule_while"
        table.append(dict(
            name=k["name"], route="cuda", design="one thread per ray",
            source="solr_tpu_torch/csrc/bvh_walk.cu",
            replaces=WALK_REPLACES[k["entry"]], launches=paths[path][k["name"]],
            max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"],
            bound_ms=k["bound_ms"], bound_by=k["bound_by"], library_ms=None,
            rays=k["rays"], visits_per_ray=k["visits_per_ray"],
            tests_per_ray=k["tests_per_ray"]))
    return table


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    import concurrent.futures
    import dataclasses

    from solr_tpu_torch.bench_scene import bench_scene
    from solr_tpu_torch.molecule_scene import molecule_scene
    from solr_tpu_torch.ops import bvh, sweep

    t_start = time.time()
    device = torch.device("cuda:0")
    smi = _nvidia_smi()
    rec = {"nvidia_smi": smi, "torch": torch.__version__,
           "cuda": torch.version.cuda, "kernels": [], "walk_kernels": [],
           "failed": []}
    print(f"card: {smi}", flush=True)

    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        logs = list(pool.map(lambda m: m.build(verbose=True), (sweep, bvh)))
    rec["build_s"] = time.time() - t0
    print(f"build: {rec['build_s']:.2f} s", flush=True)
    for log in logs:
        print(log.strip(), flush=True)

    paths = {}
    scenes = {}

    def bench():
        t0 = time.time()
        scenes["bench"] = bench_scene(N_TRIS, block=BLOCK, width=SIZE,
                                      height=SIZE, bounces=BOUNCES,
                                      device=device)
        torch.cuda.synchronize()
        rec["scene_build_s"] = time.time() - t0
        print(f"bench scene: {scenes['bench'][0].triangles.v0.shape[0]} "
              f"triangles, {rec['scene_build_s']:.2f} s", flush=True)

    def molecule():
        t0 = time.time()
        scene = molecule_scene(MOL_ATOMS, MOL_GROUND_RES, width=SIZE,
                               height=SIZE, bounces=BOUNCES, block=MOL_BLOCK,
                               device=device)
        torch.cuda.synchronize()
        scenes["molecule"] = scene
        s = scene[0]
        rec["molecule_scene"] = dict(
            build_s=time.time() - t0, atoms=MOL_ATOMS,
            spheres=int((s.spheres.radius > 0).sum()),
            cylinders=int((s.cylinders.radius > 0).sum()),
            triangles=int(s.triangles.v0.shape[0]),
            blocks={k: int(getattr(s, k).packed.shape[0])
                    for k in ("tri_accel", "sph_accel", "cyl_accel")})
        print(f"molecule scene: {rec['molecule_scene']}", flush=True)

    tri = ["sweep_closest", "sweep_transmittance"]
    walks = list(bvh.LAUNCHES)
    tri_walks = [bvh.kernel_name(e, "tri") for e in bvh.ENTRIES]

    def molecule_while():
        scene, cam, cfg = scenes["molecule"]
        return phase_path(scene, cam, dataclasses.replace(
            cfg, traversal="while"), rec, "molecule_while", walks,
            idle=list(sweep.LAUNCHES))

    steps = (
        ("bench_scene", bench),
        ("kernels", lambda: phase_kernels(*scenes["bench"], rec)),
        ("main_path", lambda: paths.update(main_path=phase_path(
            *scenes["bench"], rec, "main_path", tri, idle=walks))),
        ("reference", lambda: phase_reference(rec, device)),
        ("molecule_scene", molecule),
        ("kernels_molecule",
         lambda: phase_kernels_molecule(*scenes["molecule"], rec)),
        ("molecule_path", lambda: paths.update(molecule_path=phase_path(
            *scenes["molecule"], rec, "molecule_path", list(sweep.LAUNCHES),
            idle=walks))),
        ("molecule_reference", lambda: phase_molecule_reference(rec, device)),
        ("kernels_walk", lambda: phase_kernels_walk(scenes, rec)),
        ("walk_path", lambda: paths.update(walk_path=phase_path(
            scenes["bench"][0], scenes["bench"][1],
            _walk_cfg(scenes["bench"][2]), rec, "walk_path", tri_walks,
            idle=tri, no_brute=["tri"]))),
        ("molecule_while", lambda: paths.update(
            molecule_while=molecule_while())),
        ("walk_reference", lambda: phase_walk_reference(rec, device)),
        ("cornell", lambda: paths.update(cornell=phase_cornell(rec, device))),
        ("grad_reference", lambda: phase_grad_reference(rec, device)),
        ("grad_main_path", lambda: paths.update(grad_main_path=phase_grad_path(
            *scenes["bench"], rec, "grad_main_path", tri, idle=walks))),
        ("grad_walk_path", lambda: paths.update(grad_walk_path=phase_grad_path(
            scenes["bench"][0], scenes["bench"][1],
            _walk_cfg(scenes["bench"][2]), rec, "grad_walk_path", tri_walks,
            idle=tri))),
        ("inverse", lambda: phase_inverse(rec)),
        ("stereo_path", lambda: paths.update(stereo_path=phase_path(
            scenes["bench"][0], scenes["bench"][1],
            _stereo_cfg(scenes["bench"][2]), rec, "stereo_path", tri,
            idle=walks, slow_s=STEREO_SLOW_S))),
        ("stereo_while", lambda: paths.update(stereo_while=phase_path(
            scenes["bench"][0], scenes["bench"][1], dataclasses.replace(
                _stereo_cfg(scenes["bench"][2]), traversal="while"), rec,
            "stereo_while", tri_walks, idle=tri, no_brute=["tri"]))),
        ("stereo_reference", lambda: phase_stereo_reference(rec, device)),
        ("textured_path", lambda: paths.update(
            textured_path=phase_textured_path(rec, device, tri_walks))),
        ("textured_reference", lambda: phase_textured_reference(rec, device)),
    )
    for name, fn in steps:
        try:
            fn()
            print(f"phase {name}: ok", flush=True)
        except Exception:  # every phase runs; any failure fails the run
            rec["failed"].append(name)
            print(f"phase {name}: FAILED\n{traceback.format_exc()}", flush=True)
    rec["total_s"] = time.time() - t_start
    print(f"record: {json.dumps(rec)}", flush=True)
    if rec["failed"]:
        print(f"chip_smoke: failed phases {rec['failed']}", file=sys.stderr)
        return 1

    print(json.dumps({"kernels": _kernel_table(rec, paths)}))
    print(_nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

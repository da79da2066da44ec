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
   walk paths below make of it (recorded in one frame of each; the
   triangle kernels also on the first calls of the textured frame of
   21): t, idx, tr, node visits and lane tests bit-equal (the closest
   hits: all four to the plain walk of the dispatch's order, near child
   first for triangles and left child first for spheres and cylinders,
   t and idx also to the DFS walk); kernel and plain times, the repack
   of the packed nodes and rows timed apart, visits and tests per ray
   under the DFS walk's order and the kernel's, the bound at both, and
   each kernel's registers and stack from nvcc -Xptxas -v;
10. ``walk_path``: the bench scene at 1920x1080, 2 bounces: 1080 rows are
   no whole number of 16-pixel tiles, so every triangle query walks the
   triangle BVH; one warm-up and three timed frames as in 4; the walk
   kernels of the triangle pool must launch, and B1, B2 and the
   triangle pool's brute force must not;
11. ``molecule_while``: the full molecule frame with traversal="while",
   one warm-up and three timed frames: all six walk kernels launch and
   no sweep kernel does, nor the DFS-order triangle closest hit;
12. ``walk_reference``: reduced frames of those two paths on the card
   against committed solr_tpu CPU frames (tests/data/torch_walk_ref.npz,
   the bench frame at 64x56; torch_molecule_while_ref.npz), as in 5;
13. ``walk_stale``: the stale-tree rule (ROADMAP C14): the 1080p bench
   frame of 10 after a with_params step that moves every triangle by a
   random offset (sd WALK_STALE_SD), and the molecule frame of 11 after
   a with_params step that moves every sphere and a Scene.replace that
   moves every cylinder by one (sd MOL_STALE_RADII x the median cylinder
   radius), none refitted, so that some primitives leave their leaf
   boxes (counted): on the bench frame the DFS-order triangle closest
   hit must launch and the near-first one must not (the leaf-box check
   timed); on the molecule frame the sphere and cylinder closest hits
   (left child first, as always) must launch and the DFS-order triangle
   one must not; each pool's first closest-hit call must be bit-equal
   on t and idx to the DFS walk and on all four outputs to the plain
   walk of its own order, and it is timed as in 9; then the triangles'
   values in new tensors must take the near-first kernel again;
14. ``cornell``: the gallery's Cornell box (planes and spheres, brute
   force) built by the port's SceneBuilder, at 64x64 against
   tests/data/torch_cornell_ref.npz as in 5, then at BASELINE.json
   config #1's 256x256 and 2 bounces, one warm-up and three timed
   frames;
15. ``grad_reference``: gradients on the card against the committed
   solr_tpu CPU gradients (tests/data/torch_grad_ref.npz): the inverse
   demo's scene at 64x64 over the pixels outside the stored silhouette
   mask, every leaf (|port - ref| <= tol x max|ref|: 1e-3 for sphere
   geometry, 1e-4 for the others); the reduced bench frame with
   packets (64x64) and with the walk (64x56) against the stored target:
   the vertex-gradient L1 totals within rtol 1e-3 and, over the rows
   the reference touches, the L1 of the difference within 5e-3 of the
   reference's (whole rows move where an f32 edge flip changes a hit);
16. ``grad_main_path``: gradient steps through the full bench frame
   (packets): with_params, render_sample, the MSE against 0.8 x the
   frame's own image, backward, over vertices, sphere centres and radii,
   albedo and light position; one warm-up and three timed steps, ms for
   the refresh, forward and backward, peak memory, the rows with a
   non-zero vertex gradient, and one backward's device profile; every
   gradient finite, the vertex gradients non-zero, B1 and B2 launched
   and no walk kernel;
17. ``grad_walk_path``: the same at 1920x1080 (the walk): the triangle
   walk kernels launch, B1 and B2 do not;
18. ``inverse``: ``python -m solr_tpu_torch.inverse`` on the card at
   128x128: 60 steps, the loss must fall 20x; with ``--geometry`` 300
   steps, the centre error must fall 5x; ms per step and its parts,
   the final errors;
19. ``stereo_path``: BASELINE config #5's single-card frame: the bench
   scene at 1920x1080 SIDE_BY_SIDE with 32x8-pixel tiles (a strip is one
   pixel row), 2 bounces, packets, as in 4 (B1 and B2 launch, no walk
   kernel; when the warm-up frame takes over STEREO_SLOW_S seconds, one
   timed frame instead of three, and the record says so); then the same
   frame with traversal="while" (``stereo_while``): the triangle walks
   launch, B1 and B2 do not;
20. ``stereo_reference``: the side-by-side bench frame cut to 20,000
   triangles at 128x64 with 32x8 tiles, and the gallery's anaglyph
   Cornell box at 64x64, against committed solr_tpu CPU frames
   (tests/data/torch_stereo_ref.npz, torch_anaglyph_ref.npz), as in 5;
21. ``textured_path``: BASELINE config #3, ``render(textured_scene(1920,
   1080), key=Key.seed(0), spp=4)`` (3 bounces, 4 soft-shadow samples,
   antialiasing jitter, fog, sky, six texture maps, ambient occlusion;
   1080 rows: the triangle walk), one warm-up and three timed frames: ms
   per frame and per sample, peak memory, the digest, the launch counts
   (the triangle walks must launch), and one more frame under
   torch.profiler for the device kernels per frame and the device busy
   share (its device time over the best timed frame);
22. ``textured_reference``: the textured scene at 64x64 without a key
   (hard shadows, no jitter; ambient occlusion), with FISHEYE, and with
   a lens (aperture 0.1) and DEPTH_OF_FIELD, against
   tests/data/torch_textured_ref.npz, as in 5;
23. ``parallel_path``: BASELINE config #5 sharded
   (``solr_tpu_torch.parallel``): four spawned ranks share the card on
   gloo (NCCL refuses two ranks on one device); rank 0 builds the bench
   scene and ``broadcast_scene`` sends it to the others; ``shard_render``
   at 1920x1080 SIDE_BY_SIDE, 2 bounces, 32x9 tiles (270-row bands), a
   warm-up and a timed frame, must equal a one-process render_sample of
   the same configuration at atol 1e-6, and every rank must launch B1
   and B2 and no walk kernel; ms, peak memory and launches per rank
   ("4 ranks sharing one card", not a scaling figure);
24. ``parallel_grads``: in the same ranks, at 480x288 (72-row bands),
   ``sharded_loss_grad`` with "psum" and "reduce_scatter" against the
   one-process loss (rtol 1e-5) and gradients (every leaf rtol 1e-4,
   atol 1e-6), then three ``make_sharded_train_step`` steps in each mode
   (Adam at 1e-2; ZeRO-1 against psum at rtol 1e-4, atol 1e-6; every
   loss finite); B1 and B2 launch in every rank;
25. ``parallel_ring``: in the same ranks, ``ring_closest_hit`` of
   16,384 rays against 20,000 random triangles, against the brute-force
   ``triangle_t`` minimum on the card: hit ids equal, t rtol 1e-6, at
   least 20 hits;
26. ``parallel_nccl``: with two or more cards, 23's frame over min(4,
   cards) cards under NCCL, held as in 23; with one, ``shard_render``
   under NCCL at world size 1 on 19's frame, which it must equal
   (atol 1e-6);
27. ``resumable``: a spawned worker renders the bench frame through
   ``resumable_render`` in 64-row chunks and is SIGKILLed after its
   first heartbeat; a second worker resumes the directory, and its frame
   must equal an uninterrupted resumable_render of the same chunks bit
   for bit, and render_sample as in 5 (the pixels that differ at all
   are reported: a row band regroups the packets, and an edge-grazing
   ray can flip, ROADMAP C13); the same directory run again with
   128-row chunks must start over (ROADMAP C5), held the same way;
28. ``walk_profiles``: one more frame of 10 and of 19's ``stereo_while``
   under torch.profiler, after every timed phase: device kernels per
   frame and the device busy share (device time over the best timed
   frame).

Every spawned rank or worker must end within CHILD_DEADLINE_S seconds,
or its phase fails.

Each main path runs with the launch counts set to 0 just before it and
read just after (23 and 24 in each rank); the packet paths (4, 7, 16,
19, 23, 24) must launch no walk kernel.  Prints the full record of the
run on one line
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
# test: Moller-Trumbore with its two edges formed (52), the sphere with
# r*r formed (17), or the capped cylinder with its axis, |axis|^2,
# 1/max(|axis|^2, 1e-8) and r*r formed (85); per pair that reaches its
# roots, as for the sweeps.  The shadow walk's products are not counted.
# The kernels read the derived terms from their rows: the edges from
# pack_triangles (46 per lane: TriRow), r*r from pack_spheres (16:
# SphereRow's three subtractions, five for b, five for |oc|^2 - r*r and
# two for the discriminant), the axis, |axis|^2, 1/max(|axis|^2, 1e-8)
# and r*r from pack_cylinders (75: CylRow); their own bound counts
# those.
WALK_OPS_PER_RAY = 3
WALK_OPS_PER_VISIT = 12
WALK_OPS_PER_LANE = {"tri": 52, "sphere": 17, "cyl": 85}
PACKED_OPS_PER_LANE = {"tri": 46, "sphere": 16, "cyl": 75}
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
# BASELINE config #5 sharded (tools/stereo_1080p.py:20-22, :43-55,
# :147-160): four ranks; 32x9 tiles, so that 9 divides the 270-row bands
# of the 1080p frame and the 72-row bands of the 480x288 gradient frame.
PAR_RANKS = 4
PAR_TILE = (32, 9)
PAR_GRAD_SIZE = (480, 288)
PAR_TRAIN_STEPS = 3
PAR_LR = 1e-2
# test_parallel.py's tolerances: frames; loss; gradient and parameter
# leaves (rtol, atol).
PAR_FRAME_ATOL = 1e-6
PAR_LOSS_RTOL = 1e-5
PAR_LEAF_TOL = (1e-4, 1e-6)
# The ring: a random triangle field (tests/scenes_fixtures.py
# random_tri_field) and rays, made here with numpy from a seed.
RING_TRIS, RING_RAYS, RING_SEED = 20_000, 16_384, 5
RING_T_RTOL = 1e-6
RING_MIN_HITS = 20
# Resumable row bands: the bench frame at SIZE in RESUME_ROWS-row chunks.
RESUME_ROWS = 64
# The stale-tree frames: every bench triangle moved by a normal offset of
# this sd (about a sixteenth of an edge) from this seed, without a refit;
# every molecule cylinder by one of this many times the median radius.
WALK_STALE_SD, WALK_STALE_SEED = 0.01, 11
MOL_STALE_RADII = 0.5
# Every spawned rank or child must end by then.
CHILD_DEADLINE_S = 600.0


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
                   root_pairs, ops_per_lane=None):
    """(bound ms, "bytes" or "operations") of one walk call: its rays,
    outputs, node arrays and pool arrays (and the materials' factors for
    the shadow walk) each counted once against the memory rate, and the
    WALK_OPS_* operations of this run's visits, tests and root pairs
    (``ops_per_lane`` per test where given) against the f32 rate."""
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
           + tests * (ops_per_lane or WALK_OPS_PER_LANE[prim])
           + root_pairs * OPS_PER_ROOT_PAIR[prim])
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations")


# Each walk kernel's function in csrc/bvh_walk.cu, as parts of its
# mangled name, and its design.
WALK_FUNCTION = {
    "bvh_closest_hit_tri": ("closest_pairs", "TriRowELb1"),
    "bvh_closest_hit_tri_dfs": ("closest_pairs", "TriRowELb0"),
    "bvh_transmittance_tri": ("trans_pairs", "TriRow"),
    "bvh_closest_hit_sphere": ("closest_pairs", "SphereRowELb0"),
    "bvh_transmittance_sphere": ("trans_pairs", "SphereRow"),
    "bvh_closest_hit_cyl": ("closest_pairs", "CylRowELb0"),
    "bvh_transmittance_cyl": ("trans_pairs", "CylRow")}
WALK_DESIGN = {
    "bvh_closest_hit_tri": "packed child pairs, near child first, stack",
    "bvh_closest_hit_tri_dfs": "packed child pairs, DFS order, stack",
    "bvh_transmittance_tri": "packed child pairs, DFS order, stack",
    "bvh_closest_hit_sphere": "packed child pairs and sphere rows, DFS "
                              "order, stack",
    "bvh_transmittance_sphere": "packed child pairs and sphere rows, DFS "
                                "order, stack",
    "bvh_closest_hit_cyl": "packed child pairs and cylinder rows, DFS "
                           "order, stack",
    "bvh_transmittance_cyl": "packed child pairs and cylinder rows, DFS "
                             "order, stack"}
PACK_ROWS = {"tri": "pack_triangles", "sphere": "pack_spheres",
             "cyl": "pack_cylinders"}


def _walk_usage(rec, name):
    parts = WALK_FUNCTION[name]
    hit = [u for k, u in rec.get("bvh_ptxas", {}).items()
           if all(x in k for x in parts)]
    return hit[0] if hit else None


def _warm_ms(fn):
    """ms of one call of ``fn`` between two CUDA events.  The plain
    walks run for seconds, so each is timed on the call after the one
    whose outputs the check holds, which is its warm-up (time_ms(fn, 1)
    would run it a third time)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def _check_walk(rec, scene, call, label=None):
    """One walk kernel against its plain version on one recorded call:
    t or tr, idx, visits and tests bit-equal (the closest hits: all four
    to the plain walk of the dispatch's order, bvh.walks_near_first:
    near child first or the DFS walk's, and t and idx to the DFS walk);
    times (the kernel's over 5 calls after a warm-up, each plain walk's
    over one call after the checked one), visits and tests per ray under
    both orders, and the bound at the DFS walk's counts (the yardstick
    across PRs) and at the kernel's own.  The repack (pack_nodes and
    the pool's rows, built anew) is timed apart from the kernel, which
    reads the cached layouts."""
    import torch

    from solr_tpu_torch.kernel_shapes import time_ms
    from solr_tpu_torch.ops import bvh

    entry, prim, tree, o, d, t_min, t_max = call
    closest = entry == "bvh_closest_hit"
    dfs_plain = (bvh.bvh_closest_hit_plain if closest
                 else bvh.bvh_transmittance_plain)
    near_first = closest and bvh.walks_near_first(scene, tree, prim)
    args = (scene, tree, prim, o, d, t_min, t_max)
    if closest:
        def launch():
            return bvh.launch_closest(bvh._library(), *args,
                                      near_first=near_first)

        def plain():
            return bvh.bvh_closest_hit_ordered_plain(*args,
                                                     near_first=near_first)
    else:
        def launch():
            return bvh.launch_transmittance(bvh._library(), *args)
    got = launch()
    dfs, root_pairs = _walk_plain_with_root_pairs(dfs_plain, args, prim)
    own = plain() if closest else dfs
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(got, own))
    if closest:
        equal &= all(torch.equal(a, b) for a, b in zip(got[:2], dfs[:2]))
    visits, tests = int(dfs[-2].sum()), int(dfs[-1].sum())
    own_visits, own_tests = int(own[-2].sum()), int(own[-1].sum())
    n = o.shape[0]
    name = bvh.kernel_name(entry, prim,
                           dfs=closest and prim == "tri" and not near_first)
    entry_rec = dict(
        name=name, entry=entry, prim=prim, label=label,
        design=WALK_DESIGN[name],
        equal=equal, max_abs_err=float((got[0] - own[0]).abs().max()),
        rays=n, nodes=tree.n_nodes, visits_per_ray=visits / n,
        tests_per_ray=tests / n, own_visits_per_ray=own_visits / n,
        own_tests_per_ray=own_tests / n, root_pairs=root_pairs,
        ms=time_ms(launch, 5),
        plain_ms=_warm_ms(plain if closest else lambda: dfs_plain(*args)),
        ptxas=_walk_usage(rec, name))
    if near_first:
        entry_rec["dfs_plain_ms"] = _warm_ms(lambda: dfs_plain(*args))
    pack_rows = getattr(bvh, PACK_ROWS[prim])
    entry_rec["repack_ms"] = time_ms(
        lambda: (bvh.pack_nodes(tree), pack_rows(scene)), 5)
    if closest:
        entry_rec["hits"] = int((own[0] < 1e30).sum())
    else:
        entry_rec["shadowed"] = int((own[0] < 1.0).sum())
        entry_rec["stopped"] = int((own[0] <= 1e-6).sum())
    entry_rec["bound_ms"], entry_rec["bound_by"] = _walk_bound_ms(
        prim, closest, scene, tree, args, got, visits, tests, root_pairs)
    entry_rec["own_bound_ms"], entry_rec["own_bound_by"] = _walk_bound_ms(
        prim, closest, scene, tree, args, got, own_visits, own_tests,
        root_pairs, PACKED_OPS_PER_LANE[prim])
    rec["walk_kernels"].append(entry_rec)
    return entry_rec


def phase_kernels_walk(scenes, rec, device):
    """The six walk kernels on the first calls of the walk paths: the
    triangle pool's from the 1080p bench frame and from the textured
    frame (render with a key and TEXTURED_SPP samples: 3 bounces, 4
    shadow samples), the sphere and cylinder pools' from the molecule
    frame with traversal="while"."""
    import dataclasses

    from solr_tpu_torch.kernel_shapes import first_walk_calls
    from solr_tpu_torch.ops.render import render, render_sample
    from solr_tpu_torch.ops.rng import Key
    from solr_tpu_torch.textured_scene import textured_scene

    scene, cam, cfg = scenes["bench"]
    calls = first_walk_calls(lambda: render_sample(scene, cam,
                                                    _walk_cfg(cfg)))
    for entry in ("bvh_closest_hit", "bvh_transmittance"):
        _check_walk(rec, scene, calls[f"{entry}_tri"])
    tex, tcam, tcfg = textured_scene(WALK_WIDTH, WALK_HEIGHT, device=device)
    calls = first_walk_calls(lambda: render(tex, tcam, tcfg,
                                             Key.seed(0, device),
                                             spp=TEXTURED_SPP))
    for entry in ("bvh_closest_hit", "bvh_transmittance"):
        _check_walk(rec, tex, calls[f"{entry}_tri"], "textured frame")
    del tex, calls
    scene, cam, cfg = scenes["molecule"]
    calls = first_walk_calls(lambda: render_sample(
        scene, cam, dataclasses.replace(cfg, traversal="while")))
    for prim in ("sphere", "cyl"):
        for entry in ("bvh_closest_hit", "bvh_transmittance"):
            _check_walk(rec, scene, calls[f"{entry}_{prim}"])
    bad = [(k["name"], k["label"]) for k in rec["walk_kernels"]
           if not k["equal"]]
    if bad:
        raise AssertionError(f"walk kernel and plain version disagree: {bad}")


def _walk_cfg(cfg):
    import dataclasses

    return dataclasses.replace(cfg, width=WALK_WIDTH, height=WALK_HEIGHT)


def _stale_case(rec, key, cam, cfg, moved, prims, kernels, idle, paths,
                **extra):
    """One stale-tree frame of walk_stale: ``moved`` (a scene whose pools
    ``prims`` moved without a refit) must have rows outside their leaf
    boxes in each of those pools, and its frame, as a main path under
    ``key``, must launch every kernel in ``kernels`` and none in
    ``idle`` (nor a sweep kernel); each pool's first closest-hit call is
    checked as in kernels_walk (label "stale tree")."""
    from solr_tpu_torch.kernel_shapes import first_walk_calls
    from solr_tpu_torch.ops import bvh, sweep
    from solr_tpu_torch.ops.render import render_sample

    trees = {p: getattr(moved, {"tri": "tri_bvh", "sphere": "sph_bvh",
                                "cyl": "cyl_bvh"}[p]) for p in prims}
    strays = {p: int(bvh.outside_leaf_boxes(moved, t, p).sum())
              for p, t in trees.items()}
    if not all(strays.values()):
        raise AssertionError(f"{key}: the moved trees are not stale: {strays}")
    paths[key] = phase_path(moved, cam, cfg, rec, key, kernels,
                            idle=idle + list(sweep.LAUNCHES),
                            no_brute=list(prims))
    calls = first_walk_calls(lambda: render_sample(moved, cam, cfg))
    first = {p: _check_walk(rec, moved,
                            calls[bvh.kernel_name("bvh_closest_hit", p)],
                            "stale tree") for p in prims}
    rec[key].update(
        extra, primitives={p: int(t.prim_count.sum())
                           for p, t in trees.items()},
        outside_leaf_boxes=strays,
        first_call={p: dict(name=k["name"], equal=k["equal"], ms=k["ms"])
                    for p, k in first.items()})
    bad = [k["name"] for k in first.values() if not k["equal"]]
    if bad:
        raise AssertionError(f"{key}: {bad} and their plain walks disagree")


def phase_walk_stale(scenes, rec, paths, device):
    """The stale-tree rule (ROADMAP C14).  The 1080p bench walk frame
    after a with_params step that moves every triangle by a normal
    offset (sd WALK_STALE_SD) without a refit (``walk_stale``): the
    DFS-order triangle closest hit launches, the near-first one does
    not, the leaf-box check is timed, and the same values in new tensors
    take the near-first kernel again.  The molecule frame with
    traversal="while" after a with_params step that moves every sphere
    and a Scene.replace that moves every cylinder by a normal offset (sd
    MOL_STALE_RADII of the median cylinder radius) without a refit
    (``walk_stale_molecule``): the sphere and cylinder closest hits,
    left child first as on any tree, launch, the DFS-order triangle one
    does not.  Each as in :func:`_stale_case`."""
    import dataclasses

    import torch

    from solr_tpu_torch.kernel_shapes import time_ms
    from solr_tpu_torch.ops import bvh
    from solr_tpu_torch.ops.render import render_sample

    near, dfs = (bvh.kernel_name("bvh_closest_hit", "tri", dfs=f)
                 for f in (False, True))
    gen = torch.Generator(device=device).manual_seed(WALK_STALE_SEED)
    scene, cam, cfg = scenes["bench"]
    cfg = _walk_cfg(cfg)
    params = scene.params
    shift = torch.randn(params["vertices"][0].shape, generator=gen,
                        device=device) * WALK_STALE_SD
    with torch.no_grad():
        moved = scene.with_params(dict(params, vertices=tuple(
            v + shift for v in params["vertices"])))
        same = scene.with_params(dict(params, vertices=tuple(
            v.clone() for v in params["vertices"])))
    _stale_case(rec, "walk_stale", cam, cfg, moved, ["tri"],
                [dfs, bvh.kernel_name("bvh_transmittance", "tri")], [near],
                paths, shift_sd=WALK_STALE_SD, leaf_box_check_ms=time_ms(
                    lambda: bool(bvh.outside_leaf_boxes(
                        moved, moved.tri_bvh, "tri").any()), 5))
    with torch.no_grad():
        _reset_counts()
        render_sample(same, cam, cfg)
        torch.cuda.synchronize()
    counts = {k: bvh.LAUNCHES[k] for k in (near, dfs)}
    rec["walk_stale"]["unchanged_values"] = counts
    if counts[near] <= 0 or counts[dfs]:
        raise AssertionError(f"walk_stale: unchanged values took {counts}")
    del moved, same
    scene, cam, cfg = scenes["molecule"]
    c = scene.cylinders
    sd = float(c.radius[c.radius > 0].median()) * MOL_STALE_RADII
    params = scene.params
    with torch.no_grad():
        moved = scene.with_params(dict(
            params, sphere_center=params["sphere_center"] + torch.randn(
                params["sphere_center"].shape, generator=gen,
                device=device) * sd))
        shift = torch.randn(c.p0.shape, generator=gen, device=device) * sd
        moved = moved.replace(cylinders=c.replace(p0=c.p0 + shift,
                                                  p1=c.p1 + shift))
    _stale_case(rec, "walk_stale_molecule", cam, dataclasses.replace(
        cfg, traversal="while"), moved, ["sphere", "cyl"],
        [bvh.kernel_name(e, p) for p in ("sphere", "cyl")
         for e in bvh.ENTRIES], [dfs], paths, shift_sd=sd)


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
               no_brute=(), slow_s=None, keep=None):
    """One main path: the launch and net counts set to 0, render_sample
    once as a warm-up (counting live rays per bounce) and ``frames``
    timed times (one when the warm-up took over ``slow_s`` seconds), the
    counts read.  Every kernel in ``kernels`` must have launched, none in
    ``idle``, and no pool in ``no_brute`` may have been brute-forced.
    With ``keep`` (a dict), the last image is kept there under ``key``."""
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
    if keep is not None:
        keep[key] = img
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


# ---------------------------------------------------------------------------
# parallel/ (BASELINE config #5 sharded) and resumable row bands
# ---------------------------------------------------------------------------


def _par_cfg(cfg, width, height):
    """The sharded phases' side-by-side configuration: PAR_TILE tiles."""
    import dataclasses

    return dataclasses.replace(_stereo_cfg(cfg, width, height),
                               packet_tile_w=PAR_TILE[0],
                               packet_tile_h=PAR_TILE[1])


def _flat_leaves(tree):
    """(name, tensor) of a Scene.params-like tree, in key order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += ([(f"{k}[{i}]", x) for i, x in enumerate(v)]
                if isinstance(v, tuple) else [(k, v)])
    return out


def _digest(tree):
    return [float(x.double().sum()) for _, x in _flat_leaves(tree)]


def _worst(got, want, rtol, atol):
    """max over leaves of |got - want| - (atol + rtol |want|): <= 0 when
    every element is within tolerance; and the largest relative error."""
    worst, rel = float("-inf"), 0.0
    for (_, a), (_, b) in zip(_flat_leaves(got), _flat_leaves(want)):
        a, b = a.double(), b.double()
        err = (a - b).abs()
        worst = max(worst, float((err - (atol + rtol * b.abs())).max()))
        rel = max(rel, float((err / b.abs().clamp(min=1e-30)).max()))
    return worst, rel


def _ring_case():
    """(v0, v1, v2, o, d) as numpy: RING_TRIS random triangles in a box
    (random_tri_field's layout) and RING_RAYS rays shot into it."""
    import numpy as np

    rng = np.random.default_rng(RING_SEED)
    c = rng.uniform(-10, 10, (RING_TRIS, 3)) + np.array([0, 0, 15.0])
    d1 = rng.normal(0, 0.5, (RING_TRIS, 3))
    d2 = rng.normal(0, 0.5, (RING_TRIS, 3))
    o = rng.uniform(-2, 2, (RING_RAYS, 3))
    o[:, 2] = -20.0
    d = rng.normal(size=(RING_RAYS, 3))
    d[:, 2] = np.abs(d[:, 2]) * 6 + 2
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return tuple(x.astype(np.float32) for x in (c, c + d1, c + d2, o, d))


def _timed(fn, device):
    """(result, ms) of ``fn()`` between two syncs, the ranks lined up by
    a barrier first."""
    import torch.distributed as dist

    dist.barrier()
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, (time.perf_counter() - t0) * 1e3


def _launched():
    """The kernels launched since the counts were set to 0, and how
    often."""
    from solr_tpu_torch.ops import bvh, sweep

    return {k: v for k, v in {**sweep.LAUNCHES, **bvh.LAUNCHES}.items() if v}


def _peak_gb(device, reset=False):
    import torch

    if device.type != "cuda":
        return None
    if reset:
        torch.cuda.reset_peak_memory_stats(device)
    return torch.cuda.max_memory_allocated(device) / 2**30


def _parallel_rank(rank, world, device, n_tris, frame_cfg, grad_cfg=None,
                   target=None, ring=None):
    """One rank of the sharded phases on ``device`` ("cuda" alone: the
    rank's own card): rank 0 builds the bench scene of ``n_tris``
    triangles and broadcasts it; then the sharded frame (a warm-up and a
    timed frame), with ``grad_cfg`` the sharded loss and gradients in
    both modes and PAR_TRAIN_STEPS train steps in each, with ``ring``
    the geometry ring.  Rank 0 returns the arrays, the others digests."""
    entered = time.time()
    import functools

    import torch

    from solr_tpu_torch.bench_scene import bench_scene
    from solr_tpu_torch.parallel import (broadcast_scene, init_zero_opt_state,
                                         make_mesh, make_sharded_train_step,
                                         shard_render, sharded_loss_grad)
    from solr_tpu_torch.parallel.ring import ring_closest_hit

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(device_type=device.type)
    t0 = time.perf_counter()
    scene = cam = None
    if rank == 0:
        scene, cam, _ = bench_scene(n_tris, block=BLOCK, device=device)
    scene = broadcast_scene(scene, 0, mesh, device)
    cam = broadcast_scene(cam, 0, mesh, device)
    _sync(device)
    out = {"rank": rank, "device": str(device), "entered": entered,
           "scene_s": time.perf_counter() - t0}

    _reset_counts()
    _peak_gb(device, reset=True)
    ms = []
    with torch.no_grad():
        for _ in range(2):
            (img, _), t = _timed(lambda: shard_render(scene, cam, frame_cfg,
                                                      mesh), device)
            ms.append(t)
    out["frame"] = dict(
        warmup_ms=ms[0], frame_ms=ms[1], digest=float(img.double().sum()),
        launches=_launched(),
        peak_mem_gb=_peak_gb(device),
        image=img.cpu().numpy() if rank == 0 else None)
    del img
    if grad_cfg is None:
        return out

    target = torch.as_tensor(target, device=device)
    _reset_counts()
    _peak_gb(device, reset=True)
    grads = {}
    for mode in ("psum", "reduce_scatter"):
        (loss, g), t = _timed(lambda: sharded_loss_grad(
            scene, cam, grad_cfg, target, mesh, mode), device)
        grads[mode] = dict(loss=float(loss), ms=t, digest=_digest(g),
                           grads=({k: x.cpu() for k, x in _flat_leaves(g)}
                                  if rank == 0 else None))
    opt = functools.partial(torch.optim.Adam, lr=PAR_LR)
    train, final = {}, {}
    for mode in ("psum", "reduce_scatter"):
        step, opt = make_sharded_train_step(scene, cam, grad_cfg, mesh, opt,
                                            mode)
        params = {k: tuple(x.clone() for x in v) if isinstance(v, tuple)
                  else v.clone() for k, v in scene.params.items()}
        state = (opt([x for _, x in _flat_leaves(params)]) if mode == "psum"
                 else init_zero_opt_state(scene, opt, mesh))
        losses, step_ms = [], []
        for _ in range(PAR_TRAIN_STEPS):
            (params, state, loss), t = _timed(
                lambda: step(params, state, target), device)
            losses.append(float(loss))
            step_ms.append(t)
        train[mode] = dict(losses=losses, step_ms=step_ms)
        final[mode] = params
    train["worst"], train["max_rel"] = _worst(
        final["reduce_scatter"], final["psum"], *PAR_LEAF_TOL)
    out["grads"] = dict(modes=grads, train=train,
                        launches=_launched(),
                        peak_mem_gb=_peak_gb(device))

    from types import SimpleNamespace

    v0, v1, v2, o, d = (torch.as_tensor(x, device=device) for x in ring)
    pool = SimpleNamespace(triangles=SimpleNamespace(v0=v0, v1=v1, v2=v2))
    (t, i), ms_ring = _timed(lambda: ring_closest_hit(pool, o, d, mesh),
                             device)
    out["ring"] = dict(ms=ms_ring, digest=[float(t.double().sum()),
                                           int(i.sum())],
                       t=t.cpu().numpy() if rank == 0 else None,
                       i=i.cpu().numpy() if rank == 0 else None)
    return out


def _check_ranks(results, name, digest, launches=None, kernels=(),
                 idle=()):
    """Every rank's ``digest(result)`` equal to rank 0's; with
    ``launches(result)``, every kernel in ``kernels`` launched and none
    in ``idle`` in every rank."""
    bad = [r["rank"] for r in results if digest(r) != digest(results[0])]
    if bad:
        raise AssertionError(f"{name}: ranks {bad} differ from rank 0")
    for r in results if launches else ():
        counts = launches(r)
        missing = [k for k in kernels if counts.get(k, 0) <= 0]
        stray = [k for k in idle if counts.get(k, 0)]
        if missing or stray:
            raise AssertionError(f"{name}, rank {r['rank']}: never "
                                 f"launched {missing}, launched {stray}")


def phase_parallel(scenes, rec, par, device):
    """``parallel_path``: the single-process references on the card (the
    sharded frame's configuration, the gradient frame's loss and
    gradients, the ring's brute force), then PAR_RANKS ranks sharing the
    card on gloo run _parallel_rank; the frame is held to the
    single-process one.  The gradients and the ring are checked by
    phase_parallel_grads and phase_parallel_ring from ``par``."""
    import numpy as np
    import torch

    from solr_tpu_torch.ops import bvh, intersect
    from solr_tpu_torch.ops.render import render_sample
    from solr_tpu_torch.parallel import sharded_loss_grad
    from solr_tpu_torch.parallel.launch import spawn_group

    scene, cam, cfg = scenes["bench"]
    frame_cfg = _par_cfg(cfg, WALK_WIDTH, WALK_HEIGHT)
    grad_cfg = _par_cfg(cfg, *PAR_GRAD_SIZE)
    t0 = time.perf_counter()
    _reset_counts()
    with torch.no_grad():
        want = render_sample(scene, cam, frame_cfg)[0]
        _sync(device)
        single_ms = (time.perf_counter() - t0) * 1e3
        single_launches = _launched()
        target = render_sample(scene, cam, grad_cfg)[0][..., :3] * 0.7
    par["frame"] = want.cpu().numpy()
    loss, grads = sharded_loss_grad(scene, cam, grad_cfg, target)
    par["loss"], par["grads"] = float(loss), grads
    ring = _ring_case()
    v0, v1, v2, o, d = (torch.as_tensor(x, device=device) for x in ring)
    t_ref, i_ref = [], []
    with torch.no_grad():
        for s0 in range(0, o.shape[0], 1024):
            tm = intersect.triangle_t(o[s0:s0 + 1024], d[s0:s0 + 1024], v0,
                                      v1, v2, 1e-4)
            t_ref.append(tm.min(-1).values)
            i_ref.append(tm.argmin(-1))
    par["ring_ref"] = (torch.cat(t_ref).cpu().numpy(),
                       torch.cat(i_ref).cpu().numpy())
    del want, grads, tm
    if device.type == "cuda":
        torch.cuda.empty_cache()  # the ranks share the card

    t0, spawned = time.perf_counter(), time.time()
    group = spawn_group(_parallel_rank, PAR_RANKS,
                        (str(device), scene.triangles.v0.shape[0], frame_cfg,
                         grad_cfg, target.cpu().numpy(), ring),
                        backend="gloo", device=device,
                        timeout_s=CHILD_DEADLINE_S)
    results = group.join()
    group_s = time.perf_counter() - t0
    par["ranks"] = results
    img = results[0]["frame"]["image"]
    err = float(np.abs(img - par["frame"]).max())
    walks = list(bvh.LAUNCHES)
    rec["parallel_path"] = dict(
        ranks=PAR_RANKS, backend="gloo",
        note=f"{PAR_RANKS} ranks sharing one card ({device}) on gloo; "
             "not a scaling figure",
        width=frame_cfg.width, height=frame_cfg.height,
        camera_mode=frame_cfg.camera_mode.name, tile=list(PAR_TILE),
        band_rows=frame_cfg.height // PAR_RANKS, group_s=group_s,
        rank_start_s=[r["entered"] - spawned for r in results],
        scene_s=[r["scene_s"] for r in results],
        warmup_ms=[r["frame"]["warmup_ms"] for r in results],
        frame_ms=[r["frame"]["frame_ms"] for r in results],
        peak_mem_gb=[r["frame"]["peak_mem_gb"] for r in results],
        launches=[r["frame"]["launches"] for r in results],
        digest=results[0]["frame"]["digest"],
        single_digest=float(par["frame"].astype(np.float64).sum()),
        single_ms=single_ms, single_launches=single_launches,
        max_abs_err=err, atol=PAR_FRAME_ATOL)
    _check_ranks(results, "parallel_path", lambda r: r["frame"]["digest"],
                 lambda r: r["frame"]["launches"],
                 ["sweep_closest", "sweep_transmittance"], walks)
    if not np.isfinite(img).all() or err > PAR_FRAME_ATOL:
        raise AssertionError(f"parallel_path: sharded frame differs from the "
                             f"single-process frame by {err}")


def phase_parallel_grads(rec, par):
    """The sharded loss and gradients of both modes against the
    single-process ones; ZeRO-1 against psum over the train steps."""
    import math

    from solr_tpu_torch.ops import bvh

    ranks = par["ranks"]
    _check_ranks(ranks, "parallel_grads", lambda r: [
        r["grads"]["modes"][m]["digest"] for m in ("psum", "reduce_scatter")],
        lambda r: r["grads"]["launches"],
        ["sweep_closest", "sweep_transmittance"], list(bvh.LAUNCHES))
    g0 = ranks[0]["grads"]
    out = dict(width=PAR_GRAD_SIZE[0], height=PAR_GRAD_SIZE[1],
               single_loss=par["loss"], ranks=PAR_RANKS, backend="gloo",
               peak_mem_gb=[r["grads"]["peak_mem_gb"] for r in ranks],
               launches=[r["grads"]["launches"] for r in ranks])
    want = {k: x.cpu() for k, x in _flat_leaves(par["grads"])}
    bad = []
    for mode, res in g0["modes"].items():
        worst, rel = _worst(res["grads"], want, *PAR_LEAF_TOL)
        loss_rel = abs(res["loss"] - par["loss"]) / abs(par["loss"])
        out[mode] = dict(loss=res["loss"], loss_rel=loss_rel,
                         ms=[r["grads"]["modes"][mode]["ms"] for r in ranks],
                         worst=worst, max_rel=rel)
        if worst > 0 or loss_rel > PAR_LOSS_RTOL:
            bad.append(mode)
    train = g0["train"]
    out["train"] = dict(
        {m: dict(losses=train[m]["losses"],
                 step_ms=[r["grads"]["train"][m]["step_ms"] for r in ranks])
         for m in ("psum", "reduce_scatter")},
        worst=train["worst"], max_rel=train["max_rel"])
    rec["parallel_grads"] = out
    finite = all(math.isfinite(x) for m in ("psum", "reduce_scatter")
                 for x in train[m]["losses"])
    if bad or train["worst"] > 0 or not finite:
        raise AssertionError(f"parallel_grads: {bad or 'train'} off: {out}")


def phase_parallel_ring(rec, par):
    import numpy as np

    ranks = par["ranks"]
    _check_ranks(ranks, "parallel_ring", lambda r: r["ring"]["digest"])
    t_ref, i_ref = par["ring_ref"]
    t, i = ranks[0]["ring"]["t"], ranks[0]["ring"]["i"]
    hit = t_ref < 1e30
    rel = float((np.abs(t[hit] - t_ref[hit]) / np.abs(t_ref[hit])).max())
    ids = int((i[hit] != i_ref[hit]).sum())
    rec["parallel_ring"] = dict(
        triangles=RING_TRIS, rays=RING_RAYS, ranks=PAR_RANKS, hits=int(hit.sum()),
        id_mismatches=ids, t_max_rel=rel,
        ms=[r["ring"]["ms"] for r in ranks])
    if hit.sum() < RING_MIN_HITS or ids or rel > RING_T_RTOL or (
            i[~hit] != -1).any():
        raise AssertionError(f"parallel_ring: {rec['parallel_ring']}")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_parallel_nccl(scenes, rec, par, images, device):
    """Under NCCL: the parallel_path frame over min(4, cards) cards when
    the machine has two or more; else shard_render at world size 1 on
    stereo_path's frame, which it must equal."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from solr_tpu_torch.parallel import (initialize_distributed, make_mesh,
                                         shard_render)
    from solr_tpu_torch.parallel.launch import spawn_group

    scene, cam, cfg = scenes["bench"]
    cards = torch.cuda.device_count()
    if cards >= 2:
        world = min(4, cards)
        frame_cfg = _par_cfg(cfg, WALK_WIDTH, WALK_HEIGHT)
        results = spawn_group(_parallel_rank, world,
                              ("cuda", scene.triangles.v0.shape[0],
                               frame_cfg), backend="nccl", device="cuda",
                              timeout_s=CHILD_DEADLINE_S).join()
        img, want = results[0]["frame"]["image"], par["frame"]
        _check_ranks(results, "parallel_nccl", lambda r: r["frame"]["digest"],
                     lambda r: r["frame"]["launches"],
                     ["sweep_closest", "sweep_transmittance"])
        why = f"{cards} cards"
    else:
        world = 1
        frame_cfg = _stereo_cfg(cfg)
        initialize_distributed(f"localhost:{_free_port()}", 1, 0,
                               backend="nccl", device=device, retries=1,
                               timeout_s=CHILD_DEADLINE_S)
        try:
            with torch.no_grad():
                img = shard_render(scene, cam, frame_cfg,
                                   make_mesh(device_type="cuda"))[0]
            img = img.cpu().numpy()
        finally:
            dist.destroy_process_group()
        want = images["stereo_path"].cpu().numpy()
        why = ("one card: NCCL refuses two ranks on one device, so the "
               "multi-rank phases run on gloo")
    err = float(np.abs(img - want).max())
    rec["parallel_nccl"] = dict(
        nccl_ranks=world, why=why, width=frame_cfg.width,
        height=frame_cfg.height,
        tile=[frame_cfg.packet_tile_w, frame_cfg.packet_tile_h],
        digest=float(img.astype(np.float64).sum()),
        ref_digest=float(want.astype(np.float64).sum()), max_abs_err=err)
    if err > PAR_FRAME_ATOL:
        raise AssertionError(f"parallel_nccl: {rec['parallel_nccl']}")


def _resumable_child(device, n_tris, cfg, directory, heartbeat, events, out):
    """A worker of the resumable phase: the bench frame of ``n_tris``
    triangles at ``cfg`` through resumable_render in RESUME_ROWS-row
    chunks; its events go to ``events`` (JSON lines), its frame to
    ``out`` (.npy)."""
    import numpy as np

    from solr_tpu_torch.bench_scene import bench_scene
    from solr_tpu_torch.utils.resumable import resumable_render

    scene, cam, _ = bench_scene(n_tris, block=BLOCK, device=device)

    def log(event, **fields):
        with open(events, "a") as f:
            f.write(json.dumps(dict(event=event, **fields)) + "\n")

    img, _ = resumable_render(scene, cam, cfg, directory,
                              rows_per_chunk=RESUME_ROWS, heartbeat=heartbeat,
                              log=log)
    np.save(out, img.cpu().numpy())


def _against(img, ref):
    """Pixels of ``img`` off ``ref`` (any difference; past
    MISMATCH_ATOL) and the largest difference."""
    import numpy as np

    err = np.abs(img - ref).max(-1)
    return dict(differ=int((err > 0).sum()),
                past_atol=int((err > MISMATCH_ATOL).sum()),
                max_abs_err=float(err.max()))


def phase_resumable(scenes, rec, device):
    """A worker renders the bench frame in RESUME_ROWS-row checkpointed
    chunks and is SIGKILLed after its first heartbeat; a second worker
    resumes the directory.  Its frame must equal an uninterrupted
    resumable_render of the same chunks bit for bit, and render_sample
    within the frame budget (row bands regroup the packets, and an
    edge-grazing ray can flip where a net chunk overflows: ROADMAP
    C13).  Then the same directory with twice the chunk height must
    start over (ROADMAP C5), within the same budget."""
    import multiprocessing
    import tempfile

    import numpy as np
    import torch

    from solr_tpu_torch.ops.render import render_sample
    from solr_tpu_torch.utils.checkpoint import latest_step
    from solr_tpu_torch.utils.resumable import resumable_render

    scene, cam, cfg = scenes["bench"]
    n_chunks = cfg.height // RESUME_ROWS
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="solr_resume_") as tmp:
        ckpt, beat = os.path.join(tmp, "ckpt"), os.path.join(tmp, "beat")
        events, out = os.path.join(tmp, "events"), os.path.join(tmp, "f.npy")
        args = (str(device), scene.triangles.v0.shape[0], cfg, ckpt, beat,
                events, out)
        t0 = time.perf_counter()
        first = ctx.Process(target=_resumable_child, args=args)
        first.start()
        deadline = time.monotonic() + CHILD_DEADLINE_S
        while not os.path.exists(beat) and first.is_alive():
            if time.monotonic() > deadline:
                break
            time.sleep(0.02)
        first.kill()
        first.join()
        killed_at = latest_step(ckpt)
        second = ctx.Process(target=_resumable_child, args=args)
        second.start()
        second.join(CHILD_DEADLINE_S)
        if second.is_alive():
            second.kill()
            second.join()
        child_s = time.perf_counter() - t0
        if second.exitcode != 0 or not killed_at or killed_at >= n_chunks:
            raise AssertionError(f"resumable: killed at chunk {killed_at} of "
                                 f"{n_chunks}, relaunch exit "
                                 f"{second.exitcode}")
        img = np.load(out)
        with open(events) as f:
            seen = [json.loads(line) for line in f]
        with torch.no_grad():
            want = render_sample(scene, cam, cfg)[0].cpu().numpy()
        whole = resumable_render(scene, cam, cfg, os.path.join(tmp, "whole"),
                                 rows_per_chunk=RESUME_ROWS)[0].cpu().numpy()
        again = []
        t0 = time.perf_counter()
        img2 = resumable_render(
            scene, cam, cfg, ckpt, rows_per_chunk=2 * RESUME_ROWS,
            log=lambda event, **f: again.append(event))[0].cpu().numpy()
        rerun_s = time.perf_counter() - t0
    resumed = [e for e in seen if e["event"] == "resumed"]
    rec["resumable"] = r = dict(
        width=cfg.width, height=cfg.height, rows_per_chunk=RESUME_ROWS,
        chunks=n_chunks, killed_after_chunks=killed_at, resumed=resumed,
        chunks_rendered_after_kill=sum(
            e["event"] == "chunk_done" for e in seen[seen.index(resumed[0]):])
        if resumed else None,
        children_s=child_s,
        equal_to_uninterrupted=bool(np.array_equal(img, whole)),
        against_render_sample=_against(img, want),
        c5_events=sorted(set(again)), c5_rerun_s=rerun_s,
        c5_against_render_sample=_against(img2, want))
    budget = MISMATCH_BUDGET * cfg.n_pixels
    if (not resumed or resumed[0]["from_chunk"] != killed_at
            or not r["equal_to_uninterrupted"]
            or r["against_render_sample"]["past_atol"] > budget
            or "resumed" in again or "stale_checkpoint_discarded" not in again
            or r["c5_against_render_sample"]["past_atol"] > budget):
        raise AssertionError(f"resumable: {r}")


def phase_walk_profiles(scenes, rec):
    """One more frame of ``walk_path`` and of ``stereo_while`` under
    torch.profiler, last, so that no profiler session runs before a
    timed phase: device kernels per frame and the device busy share (the
    profiled frame's device time over the phase's best timed frame)."""
    import dataclasses

    import torch

    from solr_tpu_torch.ops.render import render_sample

    scene, cam, cfg = scenes["bench"]
    for key, c in (("walk_path", _walk_cfg(cfg)),
                   ("stereo_while", dataclasses.replace(
                       _stereo_cfg(cfg), traversal="while"))):
        with torch.no_grad():
            prof = _device_profile(lambda: render_sample(scene, cam, c))
        rec[key].update(
            device_kernels_per_frame=prof["device_kernels"],
            device_busy_share=prof["device_busy_ms"] / rec[key][
                "best_frame_ms"], profile=prof)


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
        if any(t["name"] == k["name"] for t in table):
            continue  # a kernel's other calls stay in the record
        if k["label"] == "stale tree":  # bvh_closest_hit_tri_dfs
            path = "walk_stale"
        else:
            path = "walk_path" if k["prim"] == "tri" else "molecule_while"
        table.append(dict(
            name=k["name"], route="cuda", design=k["design"],
            source="solr_tpu_torch/csrc/bvh_walk.cu",
            replaces=WALK_REPLACES[k["entry"]], launches=paths[path][k["name"]],
            max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"],
            bound_ms=k["bound_ms"], bound_by=k["bound_by"], library_ms=None,
            own_bound_ms=k["own_bound_ms"], repack_ms=k.get("repack_ms"),
            rays=k["rays"], visits_per_ray=k["visits_per_ray"],
            tests_per_ray=k["tests_per_ray"],
            own_visits_per_ray=k["own_visits_per_ray"],
            own_tests_per_ray=k["own_tests_per_ray"]))
    return table


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    import concurrent.futures
    import dataclasses

    from solr_tpu_torch.bench_scene import bench_scene
    from solr_tpu_torch.kernel_shapes import ptxas_usage
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
    rec["bvh_ptxas"] = ptxas_usage(logs[1])

    paths = {}
    scenes = {}
    images = {}
    par = {}

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
    six = [bvh.kernel_name(e, p) for p in bvh.PRIMS for e in bvh.ENTRIES]
    dfs_walks = [k for k in walks if k not in six]
    tri_walks = [bvh.kernel_name(e, "tri") for e in bvh.ENTRIES]

    def molecule_while():
        scene, cam, cfg = scenes["molecule"]
        return phase_path(scene, cam, dataclasses.replace(
            cfg, traversal="while"), rec, "molecule_while", six,
            idle=list(sweep.LAUNCHES) + dfs_walks)

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
        ("kernels_walk", lambda: phase_kernels_walk(scenes, rec, device)),
        ("walk_path", lambda: paths.update(walk_path=phase_path(
            scenes["bench"][0], scenes["bench"][1],
            _walk_cfg(scenes["bench"][2]), rec, "walk_path", tri_walks,
            idle=tri + dfs_walks, no_brute=["tri"]))),
        ("molecule_while", lambda: paths.update(
            molecule_while=molecule_while())),
        ("walk_reference", lambda: phase_walk_reference(rec, device)),
        ("walk_stale", lambda: phase_walk_stale(scenes, rec, paths, device)),
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
            idle=walks, slow_s=STEREO_SLOW_S, keep=images))),
        ("stereo_while", lambda: paths.update(stereo_while=phase_path(
            scenes["bench"][0], scenes["bench"][1], dataclasses.replace(
                _stereo_cfg(scenes["bench"][2]), traversal="while"), rec,
            "stereo_while", tri_walks, idle=tri + dfs_walks,
            no_brute=["tri"]))),
        ("stereo_reference", lambda: phase_stereo_reference(rec, device)),
        ("textured_path", lambda: paths.update(
            textured_path=phase_textured_path(rec, device, tri_walks))),
        ("textured_reference", lambda: phase_textured_reference(rec, device)),
        ("parallel_path", lambda: phase_parallel(scenes, rec, par, device)),
        ("parallel_grads", lambda: phase_parallel_grads(rec, par)),
        ("parallel_ring", lambda: phase_parallel_ring(rec, par)),
        ("parallel_nccl", lambda: phase_parallel_nccl(scenes, rec, par, images,
                                                      device)),
        ("resumable", lambda: phase_resumable(scenes, rec, device)),
        ("walk_profiles", lambda: phase_walk_profiles(scenes, rec)),
    )
    rec["phase_s"] = {}
    for name, fn in steps:
        t0 = time.time()
        try:
            fn()
            print(f"phase {name}: ok", flush=True)
        except Exception:  # every phase runs; any failure fails the run
            rec["failed"].append(name)
            print(f"phase {name}: FAILED\n{traceback.format_exc()}", flush=True)
        rec["phase_s"][name] = time.time() - t0
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

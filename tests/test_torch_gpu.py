"""The sweep and BVH walk kernels on the card against their plain
PyTorch versions, and the bench and molecule frames rendered on the card
against the same frames on the CPU.

All six kernels (closest and transmittance for tri, sphere and cyl) run
the staged design, which splits a block's lanes over several warps and
launches the strips with the longest lists first (an order kernel, held
to a stable sort); their cases add a BLOCK that is not a multiple of
the slices (200), forced ties (each block's second half a copy of its
first, and every listed block listed again at once as a copy), strips
with empty and with K-long lists, fractional shadow factors, padding
spheres, rays that start inside spheres, and a BLOCK whose rows do not
fit in shared memory.  The six walk kernels (closest hit and
transmittance over the triangle, sphere and cylinder BVHs) run on camera
and shadow rays with fractional and emissive materials, and on scenes
with every primitive twice (ties within a leaf and across leaves), the
closest hits in both orders (near child first, left child first); the
kernels also on fields with opaque occluders (the sphere field with
rays that start inside spheres and a sphere of radius 0), the triangle
and cylinder kernels on two leaves whose nearer one holds a tie's
second copy, the closest hits in DFS order on trees whose leaf boxes no
longer hold their primitives, and one cached layout per pool; the
molecule frame with traversal="while" launches all six.  A gradient step
through the reduced bench frame on the card (packets and walk) agrees
with the same step on the CPU.  The camera modes and texture features
render on the card against the committed solr_tpu CPU frames
(tests/data/torch_stereo_ref.npz, torch_anaglyph_ref.npz,
torch_textured_ref.npz) within the frame budget: the side-by-side bench
frame at 32x8 tiles (which must launch B1 and B2 and no walk kernel),
the anaglyph Cornell box, and the textured scene (BASELINE config #3)
plain, with the fisheye and with a lens and depth of field; the
textured frame with a key (soft shadows, jitter, 2 samples) renders
finite on the card.  ``shard_render`` over two gloo ranks sharing the
card equals the one-process frame, with B1 and B2 launched in both.
BASELINE config #1 at 64x64 on the card holds to the port's numpy
oracle.  The gathers' backward kernel (csrc/gather.cu) holds to a
float64 index_add_ at the gradient step's shapes, in float32 and
float64, and a float64 gradient step on the card matches the CPU's.
The procedural albedo's kernels (csrc/procedural.cu) hold to the plain
version on the card, bit for bit forward, and to autograd through it
backward, for each kind and a mix of all seven, in float32 and float64;
the gradient steps launch both.

These need a CUDA card and nvcc; without a card they skip.  The file
imports neither JAX nor solr_tpu, so it runs where only PyTorch is
installed:

    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Kernel and plain version must agree bit for bit on the same device (no
FMA contraction, the same association, tie rules and product order).
The card's frame is held to the CPU frame at atol 1e-4 outside 0.2% of
pixels: the plain PyTorch code around the kernels runs through other
elementwise and reduction kernels on the two devices.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from solr_tpu_torch.bench_scene import bench_scene
from solr_tpu_torch.constants import RAY_EPS
from solr_tpu_torch.cornell_scene import cornell_scene
from solr_tpu_torch.kernel_shapes import primary_tiles
from solr_tpu_torch.molecule_scene import molecule_scene
from solr_tpu_torch.ops import bvh
from solr_tpu_torch.ops import packet as pk
from solr_tpu_torch.ops import sweep
from solr_tpu_torch.ops.camera import camera_rays
from solr_tpu_torch.ops.pools import BY_PRIM
from solr_tpu_torch.ops.render import render, render_sample
from solr_tpu_torch.ops.rng import Key
from solr_tpu_torch.ops.traverse import _scene_box, scene_closest_hit
from solr_tpu_torch.textured_scene import textured_scene
from solr_tpu_torch.types import (CameraMode, PostFxConfig, PostFxMode,
                                  RenderConfig)
from solr_tpu_torch.parallel.launch import spawn_group
from torch_bvh_helpers import (STALE_ROW, cross_leaf_pairs, cyl_field,
                               fractional_materials, near_second_tie_cyl_scene,
                               near_second_tie_scene, tri_field,
                               shadow_rays_to_light, sphere_field, tie_scene,
                               two_leaf_stale)
from torch_parallel_helpers import gpu_frame
from torch_procedural_helpers import CASES as PROCEDURAL_CASES
from torch_procedural_helpers import assert_grads_match, autograd_grads
from torch_procedural_helpers import inputs as procedural_inputs
from torch_sweep_helpers import forced_ties

N_TRIS, SIZE, BLOCK = 20_000, 64, 512
N_ATOMS, GROUND_RES = 2_000, 32
ACCEL = {"sphere": "sph_accel", "cyl": "cyl_accel"}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sweep kernels have no CPU mode")
    sweep.build()
    return torch.device("cuda")


def _selection(device):
    scene, cam, cfg = bench_scene(N_TRIS, block=BLOCK, width=SIZE,
                                  height=SIZE, device=device)
    accel = scene.tri_accel
    perm, _ = pk.tile_permutation(SIZE, SIZE, 16, 16)
    perm = torch.as_tensor(perm, device=device)
    o, d = camera_rays(cam, cfg)
    o_t, d_t = o[perm].reshape(-1, 256, 3), d[perm].reshape(-1, 256, 3)
    live = torch.ones(o_t.shape[:2], dtype=torch.bool, device=device)
    live[2, 32:70] = False
    cand, counts, nearb, _ = pk.strip_interval_select(
        o_t, d_t, live, accel, 256, 64, RAY_EPS)
    t_cap = pk.ray_box_exit(o_t, d_t, *_scene_box(accel))
    return accel, o_t, d_t, live, t_cap, cand, counts, nearb


@pytest.mark.gpu
def test_closest_kernel_matches_plain(cuda):
    accel, o_t, d_t, live, t_cap, cand, counts, nearb = _selection(cuda)
    args = (accel.packed, o_t, d_t, t_cap, live, cand, counts, nearb, RAY_EPS)
    before = sweep.LAUNCHES["sweep_closest"]
    got = sweep.sweep_closest(*args)
    assert sweep.LAUNCHES["sweep_closest"] == before + 1
    want = sweep.sweep_closest_plain(*args)
    assert (got[0] < 1e30).any()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("factors", ["scene", "fractional"])
def test_transmittance_kernel_matches_plain(cuda, factors):
    accel, o_t, d_t, live, _, _, _, _ = _selection(cuda)
    tm = torch.full(o_t.shape[:2], 50.0, device=cuda)
    cand, counts, _, _ = pk.strip_interval_select(
        o_t, d_t, live, accel, 256, 64, RAY_EPS, tm_t=tm)
    packed = accel.packed
    if factors == "fractional":
        gen = torch.Generator(device=cuda).manual_seed(1)
        packed = packed.clone()
        packed[:, 15, :] = torch.rand(packed[:, 15, :].shape, generator=gen,
                                      device=cuda) * 0.4 + 0.55
    args = (packed, o_t, d_t, tm, live, cand, counts, RAY_EPS)
    before = sweep.LAUNCHES["sweep_transmittance"]
    got = sweep.sweep_transmittance(*args)
    assert sweep.LAUNCHES["sweep_transmittance"] == before + 1
    want = sweep.sweep_transmittance_plain(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_frame_on_card_matches_cpu(cuda):
    imgs = []
    for dev in ("cpu", cuda):
        scene, cam, cfg = bench_scene(N_TRIS, block=BLOCK, width=SIZE,
                                      height=SIZE, device=dev)
        before = dict(sweep.LAUNCHES)
        with torch.no_grad():
            imgs.append(render_sample(scene, cam, cfg)[0].cpu())
        if dev != "cpu":  # the bench frame's pools are triangles, spheres
            # under bvh_threshold: only the triangle kernels launch
            assert min(sweep.LAUNCHES[k] - before[k]
                       for k in ("sweep_closest", "sweep_transmittance")) > 0
    cpu, card = imgs
    assert torch.isfinite(card).all()
    err = (card - cpu).abs().amax(-1)
    assert float((err > 1e-4).float().mean()) <= 0.002


@pytest.fixture(scope="module")
def molecule(cuda):
    """The reduced molecule frame on the card, its primary rays in tiles
    (a few dead rays in one strip) and a shadow ray per pixel."""
    scene, cam, cfg = molecule_scene(N_ATOMS, GROUND_RES, width=SIZE,
                                     height=SIZE, device=cuda)
    perm, _ = pk.tile_permutation(SIZE, SIZE, 16, 16)
    perm = torch.as_tensor(perm, device=cuda)
    o, d = camera_rays(cam, cfg)
    o_t, d_t = o[perm].reshape(-1, 256, 3), d[perm].reshape(-1, 256, 3)
    live = torch.ones(o_t.shape[:2], dtype=torch.bool, device=cuda)
    live[2, 32:70] = False
    return scene, o_t, d_t, live


@pytest.mark.gpu
@pytest.mark.parametrize("prim", sorted(ACCEL))
def test_prim_closest_kernel_matches_plain(molecule, prim):
    scene, o_t, d_t, live = molecule
    accel = getattr(scene, ACCEL[prim])
    cand, counts, nearb, _ = pk.strip_interval_select(
        o_t, d_t, live, accel, 256, 64, RAY_EPS)
    t_cap = pk.ray_box_exit(o_t, d_t, *_scene_box(accel))
    args = (accel.packed, o_t, d_t, t_cap, live, cand, counts, nearb, RAY_EPS)
    name = sweep.kernel_name("sweep_closest", prim)
    before = sweep.LAUNCHES[name]
    got = sweep.sweep_closest(*args, prim=prim)
    assert sweep.LAUNCHES[name] == before + 1
    want = sweep.sweep_closest_plain(*args, prim=prim)
    assert (got[0] < 1e30).any()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("factors", ["scene", "fractional"])
@pytest.mark.parametrize("prim", sorted(ACCEL))
def test_prim_transmittance_kernel_matches_plain(molecule, prim, factors):
    """Shadow rays from the camera toward points past the molecule."""
    scene, o_t, d_t, live = molecule
    accel = getattr(scene, ACCEL[prim])
    tm = torch.full(o_t.shape[:2], 8.0, device=o_t.device)
    cand, counts, _, _ = pk.strip_interval_select(
        o_t, d_t, live, accel, 256, 64, RAY_EPS, tm_t=tm)
    packed = accel.packed
    if factors == "fractional":
        gen = torch.Generator(device=packed.device).manual_seed(1)
        packed = packed.clone()
        packed[:, 15, :] = torch.rand(packed[:, 15, :].shape, generator=gen,
                                      device=packed.device) * 0.4 + 0.55
    args = (packed, o_t, d_t, tm, live, cand, counts, RAY_EPS)
    name = sweep.kernel_name("sweep_transmittance", prim)
    before = sweep.LAUNCHES[name]
    got = sweep.sweep_transmittance(*args, prim=prim)
    assert sweep.LAUNCHES[name] == before + 1
    want = sweep.sweep_transmittance_plain(*args, prim=prim)
    assert (got[0] < 1.0).any()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_molecule_frame_on_card_matches_cpu(cuda):
    """The reduced molecule frame: all six kernels launch on the card,
    and the image agrees with the CPU's within the frame budget."""
    imgs = []
    for dev in ("cpu", cuda):
        scene, cam, cfg = molecule_scene(N_ATOMS, GROUND_RES, width=SIZE,
                                         height=SIZE, device=dev)
        before = dict(sweep.LAUNCHES)
        with torch.no_grad():
            imgs.append(render_sample(scene, cam, cfg)[0].cpu())
        if dev != "cpu":
            assert min(sweep.LAUNCHES[k] - before[k] for k in before) > 0
    cpu, card = imgs
    assert torch.isfinite(card).all()
    err = (card - cpu).abs().amax(-1)
    assert float((err > 1e-4).float().mean()) <= 0.002


@pytest.fixture(scope="module")
def odd_block(cuda):
    """The reduced molecule frame built with block=200 (SceneBuilder.build),
    which 8 and 4 slices of 2 or 4 lanes do not divide."""
    scene, cam, cfg = molecule_scene(N_ATOMS, GROUND_RES, width=SIZE,
                                     height=SIZE, block=200, device=cuda)
    o_t, d_t, live = primary_tiles(cam, cfg)
    live[2, 32:70] = False
    return scene, o_t, d_t, live


def _closest_equal(args, prim="tri"):
    name = sweep.kernel_name("sweep_closest", prim)
    before = sweep.LAUNCHES[name]
    got = sweep.sweep_closest(*args, prim=prim)
    assert sweep.LAUNCHES[name] == before + 1
    want = sweep.sweep_closest_plain(*args, prim=prim)
    assert (want[0] < 1e30).any()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    return want


def _trans_equal(args, prim="cyl"):
    name = sweep.kernel_name("sweep_transmittance", prim)
    before = sweep.LAUNCHES[name]
    got = sweep.sweep_transmittance(*args, prim=prim)
    assert sweep.LAUNCHES[name] == before + 1
    want = sweep.sweep_transmittance_plain(*args, prim=prim)
    assert (want[0] < 1.0).any()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    return want


def _fractional(packed, seed):
    gen = torch.Generator(device=packed.device).manual_seed(seed)
    packed = packed.clone()
    packed[:, 15, :] = torch.rand(packed[:, 15, :].shape, generator=gen,
                                  device=packed.device) * 0.4 + 0.55
    return packed


@pytest.mark.gpu
@pytest.mark.parametrize("ties", [False, True])
def test_staged_closest_odd_block(odd_block, ties):
    """B1 at block=200 on the ground's primary selection; with ``ties``,
    duplicated triangles inside each block and across listed blocks, an
    empty list and K-long lists."""
    scene, o_t, d_t, live = odd_block
    accel = scene.tri_accel
    assert accel.packed.shape[2] == 200
    cand, counts, nearb, _ = pk.strip_interval_select(
        o_t, d_t, live, accel, 256, 64, RAY_EPS)
    t_cap = pk.ray_box_exit(o_t, d_t, *_scene_box(accel))
    packed = accel.packed
    if ties:
        packed, cand, counts, nearb = forced_ties(packed, cand, counts, nearb)
    want = _closest_equal((packed, o_t, d_t, t_cap, live, cand, counts,
                           nearb, RAY_EPS))
    if ties:  # the earlier copy of a block wins every tie
        hit = want[1] >= 0
        assert hit.any() and (want[1][hit] < accel.packed.numel() // 16).all()


@pytest.mark.gpu
@pytest.mark.parametrize("ties", [False, True])
def test_staged_closest_ties_bench_block(cuda, ties):
    """B1 at the bench's block=512 with the same forced ties, empty and
    K-long lists."""
    accel, o_t, d_t, live, t_cap, cand, counts, nearb = _selection(cuda)
    packed = accel.packed
    if ties:
        packed, cand, counts, nearb = forced_ties(packed, cand, counts, nearb)
    _closest_equal((packed, o_t, d_t, t_cap, live, cand, counts, nearb,
                    RAY_EPS))


@pytest.mark.gpu
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("factors", ["scene", "fractional"])
def test_staged_transmittance_odd_block(odd_block, factors, ties):
    """B6 at block=200 with the scene's and with fractional factors; with
    ``ties``, duplicated cylinders inside each block and across listed
    blocks (each copy multiplies its factor in), an empty list and
    K-long lists."""
    scene, o_t, d_t, live = odd_block
    accel = scene.cyl_accel
    assert accel.packed.shape[2] == 200
    tm = torch.full(o_t.shape[:2], 8.0, device=o_t.device)
    cand, counts, _, _ = pk.strip_interval_select(
        o_t, d_t, live, accel, 256, 64, RAY_EPS, tm_t=tm)
    packed = accel.packed
    if factors == "fractional":
        packed = _fractional(packed, 3)
    if ties:
        packed, cand, counts = forced_ties(packed, cand, counts)
    _trans_equal((packed, o_t, d_t, tm, live, cand, counts, RAY_EPS))


@pytest.mark.gpu
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("factors", ["scene", "fractional"])
@pytest.mark.parametrize("block", [200, 512])
def test_staged_transmittance_tri(cuda, odd_block, block, factors, ties):
    """B2 on camera rays to t 50: at block=200 over the reduced molecule
    frame's ground, at the bench's block=512 over its triangle field;
    with the scene's and with fractional factors; with ``ties``,
    duplicated triangles inside each block and across listed blocks, an
    empty list and K-long lists."""
    if block == 200:
        scene, o_t, d_t, live = odd_block
        accel = scene.tri_accel
    else:
        accel, o_t, d_t, live, _, _, _, _ = _selection(cuda)
    assert accel.packed.shape[2] == block
    tm = torch.full(o_t.shape[:2], 50.0, device=o_t.device)
    cand, counts, _, _ = pk.strip_interval_select(
        o_t, d_t, live, accel, 256, 64, RAY_EPS, tm_t=tm)
    packed = accel.packed
    if factors == "fractional":
        packed = _fractional(packed, 5)
    if ties:
        packed, cand, counts = forced_ties(packed, cand, counts)
    _trans_equal((packed, o_t, d_t, tm, live, cand, counts, RAY_EPS), "tri")


@pytest.mark.gpu
@pytest.mark.parametrize("ties", [False, True])
def test_staged_closest_cyl_odd_block(odd_block, ties):
    """B5 at block=200 on the reduced molecule frame's primary rays; with
    ``ties``, duplicated cylinders inside each block and across listed
    blocks, an empty list and K-long lists."""
    scene, o_t, d_t, live = odd_block
    accel = scene.cyl_accel
    assert accel.packed.shape[2] == 200
    cand, counts, nearb, _ = pk.strip_interval_select(
        o_t, d_t, live, accel, 256, 64, RAY_EPS)
    t_cap = pk.ray_box_exit(o_t, d_t, *_scene_box(accel))
    packed = accel.packed
    if ties:
        packed, cand, counts, nearb = forced_ties(packed, cand, counts, nearb)
    want = _closest_equal((packed, o_t, d_t, t_cap, live, cand, counts,
                           nearb, RAY_EPS), "cyl")
    if ties:  # the earlier copy of a block wins every tie
        hit = want[1] >= 0
        assert hit.any() and (want[1][hit] < accel.packed.numel() // 16).all()


@pytest.mark.gpu
@pytest.mark.parametrize("ties", [False, True])
def test_staged_closest_sphere_odd_block(odd_block, ties):
    """B3 at block=200 on the reduced molecule frame's primary rays; the
    last block ends in padding spheres (radius -1), which the forced
    ties' K-long lists visit; with ``ties``, duplicated spheres inside
    each block and across listed blocks, an empty list and K-long
    lists."""
    scene, o_t, d_t, live = odd_block
    accel = scene.sph_accel
    assert accel.packed.shape[2] == 200
    assert (accel.packed[:, 3] <= 0).any()
    cand, counts, nearb, _ = pk.strip_interval_select(
        o_t, d_t, live, accel, 256, 64, RAY_EPS)
    t_cap = pk.ray_box_exit(o_t, d_t, *_scene_box(accel))
    packed = accel.packed
    if ties:
        packed, cand, counts, nearb = forced_ties(packed, cand, counts, nearb)
    want = _closest_equal((packed, o_t, d_t, t_cap, live, cand, counts,
                           nearb, RAY_EPS), "sphere")
    if ties:  # the earlier copy of a block wins every tie
        hit = want[1] >= 0
        assert hit.any() and (want[1][hit] < accel.packed.numel() // 16).all()


@pytest.mark.gpu
def test_staged_closest_sphere_inside(odd_block):
    """B3 on rays that start inside spheres: strip 1 of tile 0 starts on
    the centres of 32 atoms and must take each atom's exit root."""
    scene, o_t, d_t, live = odd_block
    accel = scene.sph_accel
    rows = accel.packed.permute(0, 2, 1).reshape(-1, 16)
    atoms = rows[rows[:, 3] > 0][:32]
    o_t = o_t.clone()
    o_t[0, 32:64] = atoms[:, :3]
    cand, counts, nearb, _ = pk.strip_interval_select(
        o_t, d_t, live, accel, 256, 64, RAY_EPS)
    t_cap = pk.ray_box_exit(o_t, d_t, *_scene_box(accel))
    t, _, _ = _closest_equal((accel.packed, o_t, d_t, t_cap, live, cand,
                              counts, nearb, RAY_EPS), "sphere")
    assert (t[0, 32:64] <= atoms[:, 3] * (1 + 1e-6)).all()


@pytest.mark.gpu
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("factors", ["scene", "fractional"])
def test_staged_transmittance_sphere_odd_block(odd_block, factors, ties):
    """B4 at block=200 with the scene's and with fractional factors; with
    ``ties``, duplicated spheres inside each block and across listed
    blocks (each copy multiplies its factor in), padding spheres, an
    empty list and K-long lists."""
    scene, o_t, d_t, live = odd_block
    accel = scene.sph_accel
    assert accel.packed.shape[2] == 200
    tm = torch.full(o_t.shape[:2], 8.0, device=o_t.device)
    cand, counts, _, _ = pk.strip_interval_select(
        o_t, d_t, live, accel, 256, 64, RAY_EPS, tm_t=tm)
    packed = accel.packed
    if factors == "fractional":
        packed = _fractional(packed, 7)
    if ties:
        packed, cand, counts = forced_ties(packed, cand, counts)
    _trans_equal((packed, o_t, d_t, tm, live, cand, counts, RAY_EPS),
                 "sphere")


@pytest.mark.gpu
def test_staged_kernels_reject_blocks_beyond_shared_memory(cuda):
    """A block whose staged rows exceed the card's shared memory raises
    before any launch."""
    accel, o_t, d_t, live, t_cap, cand, counts, nearb = _selection(cuda)
    big = torch.zeros((2, 16, 8192), device=cuda)
    before = dict(sweep.LAUNCHES)
    for prim in sweep.PRIMS:  # B1, B3 and B5; B2, B4 and B6
        with pytest.raises(ValueError, match="shared memory"):
            sweep.sweep_closest(big, o_t, d_t, t_cap, live,
                                cand.clamp(max=1), counts, nearb, RAY_EPS,
                                prim=prim)
        with pytest.raises(ValueError, match="shared memory"):
            sweep.sweep_transmittance(big, o_t, d_t, t_cap, live,
                                      cand.clamp(max=1), counts, RAY_EPS,
                                      prim=prim)
    assert sweep.LAUNCHES == before


@pytest.mark.gpu
@pytest.mark.parametrize("counts", ["selection", "uniform", "one length"])
def test_launch_order_matches_stable_sort(cuda, counts):
    """The order kernel that every staged launch runs first, against its
    plain version (a stable descending sort of the list lengths): on the
    bench selection's counts, on 8,192 strips of random lengths up to
    K=64, and on 8,193 strips that all tie."""
    if counts == "selection":
        c = _selection(cuda)[6]
    elif counts == "uniform":
        gen = torch.Generator(device=cuda).manual_seed(7)
        c = torch.randint(0, 65, (1024, 8), generator=gen, device=cuda,
                          dtype=torch.int32)
    else:
        c = torch.full((8193,), 64, dtype=torch.int32, device=cuda)
    got = sweep.launch_order(sweep.LIBRARY.load(), c, 64)
    torch.cuda.synchronize()
    assert torch.equal(got, sweep.longest_first(c))


# --------------------------------------------------------------------------
# The per-ray BVH walk kernels (csrc/bvh_walk.cu)
# --------------------------------------------------------------------------

BVH_OF = {"tri": "tri_bvh", "sphere": "sph_bvh", "cyl": "cyl_bvh"}


@pytest.fixture(scope="module")
def walk(cuda):
    """The reduced molecule scene on the card with fractional and
    emissive materials, its camera rays in pixel order, and shadow rays
    toward its light from their hits."""
    bvh.build()
    scene, cam, cfg = molecule_scene(N_ATOMS, GROUND_RES, width=SIZE,
                                     height=SIZE, device=cuda)
    scene = fractional_materials(scene)
    o, d = camera_rays(cam, cfg)
    with torch.no_grad():
        hit = scene_closest_hit(scene, o, d)
    return (scene, o, d) + shadow_rays_to_light(scene, o, d, hit)


@pytest.mark.gpu
@pytest.mark.parametrize("prim", bvh.PRIMS)
def test_walk_closest_kernel_matches_plain(walk, prim):
    scene, o, d = walk[:3]
    tree = getattr(scene, BVH_OF[prim])
    name = bvh.kernel_name("bvh_closest_hit", prim)
    before = bvh.LAUNCHES[name]
    got = bvh.bvh_closest_hit(scene, tree, BY_PRIM[prim].code, o, d,
                              RAY_EPS)
    assert bvh.LAUNCHES[name] == before + 1
    want = bvh.bvh_closest_hit_plain(scene, tree, prim, o, d, RAY_EPS)
    assert (got[0] < 1e30).any()
    for a, b in zip(got, want):  # t, idx
        assert torch.equal(a, b)
    for near in (True, False):  # each order's own counts
        lib_out = bvh.launch_closest(bvh.LIBRARY.load(), scene, tree, prim, o, d,
                                     RAY_EPS, near_first=near)
        want = bvh.bvh_closest_hit_ordered_plain(scene, tree, prim, o, d,
                                                 RAY_EPS, near_first=near)
        for a, b in zip(lib_out, want):  # t, idx, visits, tests
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("rays", ["shadow", "camera"])
@pytest.mark.parametrize("prim", bvh.PRIMS)
def test_walk_transmittance_kernel_matches_plain(walk, prim, rays):
    scene, o, d, so, sd, tm = walk
    if rays == "camera":  # to t_max = 100: across the ground and molecule
        so, sd, tm = o, d, torch.full(o.shape[:1], 100.0, device=o.device)
    tree = getattr(scene, BVH_OF[prim])
    name = bvh.kernel_name("bvh_transmittance", prim)
    before = bvh.LAUNCHES[name]
    got = bvh.bvh_transmittance(scene, tree, BY_PRIM[prim].code, so, sd,
                                RAY_EPS, tm)
    assert bvh.LAUNCHES[name] == before + 1
    want = bvh.bvh_transmittance_plain(scene, tree, prim, so, sd, RAY_EPS, tm)
    assert torch.equal(got, want[0])
    lib_out = bvh.launch_transmittance(bvh.LIBRARY.load(), scene, tree, prim, so,
                                       sd, RAY_EPS, tm)
    for a, b in zip(lib_out[1:], want[1:]):  # visits, tests
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("prim", bvh.PRIMS)
def test_walk_closest_ties(cuda, prim):
    """Every primitive twice: the first copy wins, within a leaf and
    across neighbouring leaves, in either order, on the card as in the
    plain version."""
    bvh.build()
    scene, o, d = tie_scene(prim, SIZE, device=cuda)
    tree = getattr(scene, BVH_OF[prim])
    want = bvh.bvh_closest_hit_plain(scene, tree, prim, o, d, RAY_EPS)
    for near in (True, False):
        got = bvh.launch_closest(bvh.LIBRARY.load(), scene, tree, prim, o, d,
                                 RAY_EPS, near_first=near)
        for a, b in zip(got[:2], want[:2]):  # t, idx
            assert torch.equal(a, b)
        own = bvh.bvh_closest_hit_ordered_plain(scene, tree, prim, o, d,
                                                RAY_EPS, near_first=near)
        for a, b in zip(got, own):  # and the counts of the kernel's order
            assert torch.equal(a, b)
    hit = want[0] < 1e30
    assert (want[1][hit] % 2 == 0).all()
    assert cross_leaf_pairs(tree, want[1][hit]) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["field", "near_second_tie"])
def test_walk_tri_kernels_order_and_stop(cuda, case):
    """The triangle kernels on a field where shadow rays stop at opaque
    leaves, and on the two-leaf tie that the near-first walk reaches
    second copy first: the closest hit equal to the near-first plain
    walk on all four outputs and to the DFS walk on t and idx, the
    shadow walk to the DFS walk on all three."""
    bvh.build()
    scene, o, d = (tri_field(device=cuda) if case == "field"
                   else near_second_tie_scene(device=cuda))
    tree = scene.tri_bvh
    got = bvh.launch_closest(bvh.LIBRARY.load(), scene, tree, "tri", o, d,
                             RAY_EPS)
    dfs = bvh.bvh_closest_hit_plain(scene, tree, "tri", o, d, RAY_EPS)
    near = bvh.bvh_closest_hit_ordered_plain(scene, tree, "tri", o, d,
                                             RAY_EPS)
    assert all(torch.equal(a, b) for a, b in zip(got, near))
    assert all(torch.equal(a, b) for a, b in zip(got[:2], dfs[:2]))
    if case == "near_second_tie":
        assert (got[1] == 7).all()
    tm = torch.full(o.shape[:1], 100.0, device=o.device)
    got = bvh.launch_transmittance(bvh.LIBRARY.load(), scene, tree, "tri", o, d,
                                   RAY_EPS, tm)
    want = bvh.bvh_transmittance_plain(scene, tree, "tri", o, d, RAY_EPS, tm)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["field", "near_second_tie"])
def test_walk_cyl_kernels_order_and_stop(cuda, case):
    """test_walk_tri_kernels_order_and_stop for the cylinder kernels: a
    1,200-cylinder field (576 rays) and the two-leaf tie that the
    near-first walk reaches second copy first; the closest hit in both
    orders (the dispatch's is left child first)."""
    bvh.build()
    scene, o, d = (cyl_field(device=cuda) if case == "field"
                   else near_second_tie_cyl_scene(device=cuda))
    tree = scene.cyl_bvh
    dfs = bvh.bvh_closest_hit_plain(scene, tree, "cyl", o, d, RAY_EPS)
    for near in (True, False):
        got = bvh.launch_closest(bvh.LIBRARY.load(), scene, tree, "cyl", o, d,
                                 RAY_EPS, near_first=near)
        own = bvh.bvh_closest_hit_ordered_plain(scene, tree, "cyl", o, d,
                                                RAY_EPS, near_first=near)
        assert all(torch.equal(a, b) for a, b in zip(got, own))
        assert all(torch.equal(a, b) for a, b in zip(got[:2], dfs[:2]))
        if case == "near_second_tie":
            assert (got[1] == 7).all()
    tm = torch.full(o.shape[:1], 100.0, device=o.device)
    got = bvh.launch_transmittance(bvh.LIBRARY.load(), scene, tree, "cyl", o, d,
                                   RAY_EPS, tm)
    want = bvh.bvh_transmittance_plain(scene, tree, "cyl", o, d, RAY_EPS, tm)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _sphere_kernels_equal(scene, o, d, tm):
    """Both sphere kernels against their plain walks (the closest hit in
    both orders); returns the DFS walk's (t, idx) and the shadow walk's
    tr."""
    tree = scene.sph_bvh
    dfs = bvh.bvh_closest_hit_plain(scene, tree, "sphere", o, d, RAY_EPS)
    for near in (False, True):
        got = bvh.launch_closest(bvh.LIBRARY.load(), scene, tree, "sphere", o, d,
                                 RAY_EPS, near_first=near)
        own = bvh.bvh_closest_hit_ordered_plain(scene, tree, "sphere", o, d,
                                                RAY_EPS, near_first=near)
        assert all(torch.equal(a, b) for a, b in zip(got, own))
        assert all(torch.equal(a, b) for a, b in zip(got[:2], dfs[:2]))
    got = bvh.launch_transmittance(bvh.LIBRARY.load(), scene, tree, "sphere", o,
                                   d, RAY_EPS, tm)
    want = bvh.bvh_transmittance_plain(scene, tree, "sphere", o, d, RAY_EPS,
                                       tm)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    return dfs[0], dfs[1], want[0]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["field", "tie"])
def test_walk_sphere_kernels_order_and_stop(cuda, case):
    """The sphere kernels on a 1,500-sphere field (64 of its 576 rays
    start inside a sphere; shadow rays stop at opaque leaves; then its
    two most hit spheres at radius 0 and -r through Scene.replace) and
    on the scene with every sphere twice: the closest hit in DFS order
    (the dispatch's) and near child first equal to the plain walk of its
    order on all four outputs and to the DFS walk on t and idx, the
    shadow walk to the DFS walk on all three."""
    bvh.build()
    if case == "tie":
        scene, o, d = tie_scene("sphere", SIZE, device=cuda)
        tm = torch.full(o.shape[:1], 100.0, device=o.device)
        t, idx, _ = _sphere_kernels_equal(scene, o, d, tm)
        assert (t < 1e30).sum() > 50 and (idx[t < 1e30] % 2 == 0).all()
        return
    scene, o, d, inside = sphere_field(device=cuda)
    tm = torch.full(o.shape[:1], 100.0, device=o.device)
    t, idx, tr = _sphere_kernels_equal(scene, o, d, tm)
    assert (t < 1e30).sum() > 500 and (t[inside] <= 0.25).all()
    assert (tr == 0.0).sum() > 200
    rows = torch.bincount(idx[t < 1e30]).topk(2).indices
    p = scene.spheres
    radius = p.radius.clone()
    radius[rows] = torch.stack([torch.zeros((), device=cuda),
                                -radius[rows[1]]])
    gone = scene.replace(spheres=p.replace(radius=radius))
    t0, idx0, _ = _sphere_kernels_equal(gone, o, d, tm)
    assert not torch.isin(idx0[t0 < 1e30], rows).any()


@pytest.mark.gpu
@pytest.mark.parametrize("prim", bvh.PRIMS)
def test_walk_dfs_kernel_on_stale_tree(cuda, prim):
    """A primitive moved out of its leaf box without a refit (ROADMAP
    C14): bvh_closest_hit launches the DFS-order kernel (for triangles
    the "_dfs" instance; spheres and cylinders walk in no other order,
    under their plain name), which returns the DFS walk's t and idx and
    the counts of the plain walk of its order; the near-first kernel
    returns the near leaf's hit."""
    bvh.build()
    scene, o, d = two_leaf_stale(prim, device=cuda)
    tree = getattr(scene, BVH_OF[prim])
    name = bvh.kernel_name("bvh_closest_hit", prim, dfs=prim == "tri")
    before = dict(bvh.LAUNCHES)
    with torch.no_grad():
        t, idx = bvh.bvh_closest_hit(scene, tree, BY_PRIM[prim].code, o, d,
                                     RAY_EPS)
    assert bvh.LAUNCHES[name] == before[name] + 1
    assert all(bvh.LAUNCHES[k] == before[k] for k in before if k != name)
    dfs = bvh.bvh_closest_hit_plain(scene, tree, prim, o, d, RAY_EPS)
    assert torch.equal(t, dfs[0]) and torch.equal(idx, dfs[1])
    assert (idx == STALE_ROW).all()
    got = bvh.launch_closest(bvh.LIBRARY.load(), scene, tree, prim, o, d, RAY_EPS,
                             near_first=False)
    want = bvh.bvh_closest_hit_ordered_plain(scene, tree, prim, o, d, RAY_EPS,
                                             near_first=False)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = bvh.launch_closest(bvh.LIBRARY.load(), scene, tree, prim, o, d, RAY_EPS,
                             near_first=True)
    want = bvh.bvh_closest_hit_ordered_plain(scene, tree, prim, o, d, RAY_EPS)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (got[1] == 8).all()


@pytest.mark.gpu
def test_walk_layouts_one_per_pool(cuda, walk, monkeypatch):
    """On the card as in the emulation: a triangle, cylinder, sphere,
    triangle, cylinder, sphere sequence packs each pool once and checks
    the triangle tree once."""
    scene, o, d = walk[:3]
    packed, checked = [], []
    for name in ("pack_nodes", "pack_triangles", "pack_cylinders",
                 "pack_spheres"):
        fn = getattr(bvh, name)
        monkeypatch.setattr(bvh, name, lambda *a, _fn=fn, _n=name: (
            packed.append(_n), _fn(*a))[1])
    fn = bvh.outside_leaf_boxes
    monkeypatch.setattr(bvh, "outside_leaf_boxes", lambda *a: (
        checked.append(a[2]), fn(*a))[1])
    monkeypatch.setattr(bvh, "_DERIVED", {})
    with torch.no_grad():
        for prim in ("tri", "cyl", "sphere") * 2:
            tree = getattr(scene, BVH_OF[prim])
            bvh.bvh_closest_hit(scene, tree, BY_PRIM[prim].code, o, d,
                                RAY_EPS)
    assert packed == ["pack_nodes", "pack_triangles", "pack_nodes",
                      "pack_cylinders", "pack_nodes", "pack_spheres"]
    assert checked == ["tri"]


@pytest.mark.gpu
def test_while_frame_on_card_matches_cpu(cuda):
    """The reduced molecule frame with traversal="while": all six walk
    kernels launch on the card, no sweep kernel does, and the image
    agrees with the CPU's within the frame budget."""
    imgs = []
    for dev in ("cpu", cuda):
        scene, cam, cfg = molecule_scene(N_ATOMS, GROUND_RES, width=SIZE,
                                         height=SIZE, device=dev)
        cfg = dataclasses.replace(cfg, traversal="while")
        before, sweeps = dict(bvh.LAUNCHES), dict(sweep.LAUNCHES)
        with torch.no_grad():
            imgs.append(render_sample(scene, cam, cfg)[0].cpu())
        if dev != "cpu":  # the six walks; the trees are not stale
            six = [bvh.kernel_name(e, p) for p in bvh.PRIMS
                   for e in bvh.ENTRIES]
            assert min(bvh.LAUNCHES[k] - before[k] for k in six) > 0
            assert all(bvh.LAUNCHES[k] == before[k] for k in before
                       if k not in six)
            assert sweeps == sweep.LAUNCHES
    cpu, card = imgs
    assert torch.isfinite(card).all()
    err = (card - cpu).abs().amax(-1)
    assert float((err > 1e-4).float().mean()) <= 0.002


def _grads_on_card_and_cpu(cuda, height, cast=lambda x: x):
    """One gradient step through the reduced bench frame (``cast`` applied
    to its scene and camera) on the CPU and on the card, where the
    traversal's kernels (B1 and B2 on packets, the triangle walks at
    64x56), the gathers' backward and the procedural albedo's kernels
    (forward and backward) must launch.  Returns the vertex gradients' L1
    total and the albedo and light gradients of each."""
    from solr_tpu_torch.ops import gather
    from solr_tpu_torch.ops import textures as tex

    kernels = (("sweep_closest", "sweep_transmittance") if height == SIZE
               else ("bvh_closest_hit_tri", "bvh_transmittance_tri"))
    grads = []
    for dev in ("cpu", cuda):
        scene, cam, cfg = bench_scene(N_TRIS, block=BLOCK, width=SIZE,
                                      height=height, device=dev)
        scene, cam = cast(scene), cast(cam)
        with torch.no_grad():
            target = render_sample(scene, cam, cfg)[0][..., :3] * 0.8
        p = {k: (tuple(x.detach().clone().requires_grad_() for x in v)
                 if isinstance(v, tuple)
                 else v.detach().clone().requires_grad_())
             for k, v in scene.params.items()}
        before = {**sweep.LAUNCHES, **bvh.LAUNCHES, **gather.LAUNCHES,
                  **tex.LAUNCHES}
        img, _ = render_sample(scene.with_params(p), cam, cfg)
        ((img[..., :3] - target) ** 2).mean().backward()
        if dev != "cpu":
            after = {**sweep.LAUNCHES, **bvh.LAUNCHES, **gather.LAUNCHES,
                     **tex.LAUNCHES}
            assert min(after[k] - before[k]
                       for k in kernels + ("gather_rows_bwd",) + tuple(
                           tex.LAUNCHES)) > 0
        grads.append({
            "l1": sum(float(x.grad.abs().sum()) for x in p["vertices"]),
            "albedo": p["albedo"].grad.cpu(),
            "light": p["light_position"].grad.cpu()})
    return grads


def _assert_card_matches_cpu(cpu, card):
    assert cpu["l1"] > 0
    assert abs(card["l1"] / cpu["l1"] - 1.0) <= 1e-3
    for k in ("albedo", "light"):
        assert torch.isfinite(card[k]).all()
        scale = float(cpu[k].abs().max())
        assert float((card[k] - cpu[k]).abs().max()) <= 1e-2 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("height", [SIZE, 56], ids=["packets", "walk"])
def test_gradients_on_card_match_cpu(cuda, height):
    """A gradient step through the reduced bench frame with packets (B1,
    B2) and with the walk (64x56): on the card the kernels launch under
    autograd with detached inputs, and the vertex-gradient L1 total
    agrees with the CPU's within rtol 1e-3, the albedo and light
    gradients within 1e-2 of their largest entry (on the CPU the port and
    solr_tpu differ by 2e-3 and 3e-3 there, through f32 edge flips; the
    two devices' elementwise kernels can flip edges too)."""
    _assert_card_matches_cpu(*_grads_on_card_and_cpu(cuda, height))


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["one_index", "step_pattern",
                                  "step_pattern_integers", "one_index_f64",
                                  "step_pattern_f64"])
def test_gather_backward_kernel_against_float64(cuda, case):
    """The gathers' backward (csrc/gather.cu) through ``gather_rows`` on
    the card.  ``one_index``: 262,144 rows on one row of a (24, 3) table
    (the shared-memory path).  ``step_pattern``: a (999,698, 3) table (the
    global path) under the gradient step's pattern: half the rows exact
    zeros on row 0 (the rays that missed the pool), the rest in pairs and
    runs of equal rows.  Where the rows are small integers (in float64
    with a multiple of 2^-30 that float32 would round away), every order
    of their sums is exact, so the kernel is bit-equal to the float64
    index_add_ however many rows share an index.  ``step_pattern``'s rows
    are random: each entry within (k - 1) 2^-24 times the magnitudes of
    its k rows of a float64 index_add_, the float32 rounding of any order
    of the adds (the kernel's atomics add in no fixed order), and 2^-126
    more for each of its at most 2k atomic adds (float atomics flush
    subnormal values to zero).  gather.LAUNCHES counts the launch."""
    from solr_tpu_torch.ops import gather

    gen = torch.Generator(device=cuda).manual_seed(3)
    rays = 262_144
    dtype = torch.float64 if case.endswith("f64") else torch.float32
    if case.startswith("one_index"):
        n = 24
        idx = torch.full((rays,), 7, dtype=torch.int64, device=cuda)
        miss = torch.zeros(rays, dtype=torch.bool, device=cuda)
    else:
        n = 999_698
        idx = torch.randint(0, n, (rays,), generator=gen, device=cuda)
        idx[1::2] = idx[::2]
        idx[:4096] = 5
        miss = torch.rand(rays, generator=gen, device=cuda) < 0.5
        idx[miss] = 0
    if case == "step_pattern":
        g = torch.randn((rays, 3), generator=gen, device=cuda)
    else:
        g = torch.randint(-8, 9, (rays, 3), generator=gen,
                          device=cuda).to(dtype)
        if dtype == torch.float64:
            g += torch.randint(-8, 9, (rays, 3), generator=gen,
                               device=cuda) * 2.0 ** -30
    g[miss] = 0.0
    table = torch.zeros((n, 3), dtype=dtype, device=cuda, requires_grad=True)
    before = gather.LAUNCHES["gather_rows_bwd"]
    gather.gather_rows(table, idx).backward(g)
    torch.cuda.synchronize()
    assert gather.LAUNCHES["gather_rows_bwd"] == before + 1
    assert table.grad.dtype == dtype
    if case == "step_pattern":
        assert _chip_smoke()._rounding_excess(table.grad, g, idx, n) <= 0.0
    else:
        want = torch.zeros((n, 3), dtype=torch.float64,
                           device=cuda).index_add_(0, idx, g.double())
        assert torch.equal(table.grad.double(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("rays", [262_144, 262_144 + 77],
                         ids=["whole_blocks", "ragged"])
@pytest.mark.parametrize("case", PROCEDURAL_CASES)
def test_procedural_kernels_match_plain(cuda, case, rays, dtype):
    """The procedural albedo's kernels (csrc/procedural.cu) through
    ``procedural_color`` on the card, for one kind at a time and a batch
    that mixes all seven (and the clamped kinds -1 and 9), at a 512x512
    bounce's rays and at a count no block size divides.  The forward is
    bit-equal to procedural_color_plain on the card.  The backward
    (uv, scale and base_color requiring grad) against autograd through
    the plain version on the card: equal for NONE, MANDELBROT, JULIA and
    CHECKER; for NOISE, MARBLE and GRANITE within 1e-5 (f32) or 1e-12
    (f64) of each kind's largest entry, since the kernel takes the chain
    rule in another association (the emulation reads 2e-7 and 2e-16 on
    NOISE, tests/test_torch_procedural.py).  textures.LAUNCHES counts
    one launch a call of each."""
    from solr_tpu_torch.ops import textures as tex

    kind, scale, uv, base, grad = procedural_inputs(case, rays, dtype,
                                                    device=cuda)
    before = dict(tex.LAUNCHES)
    got = tex.procedural_color(kind, scale, uv, base)
    want = tex.procedural_color_plain(kind, scale, uv, base)
    torch.cuda.synchronize()
    assert tex.LAUNCHES["procedural_color"] == before["procedural_color"] + 1
    view = torch.int32 if dtype == torch.float32 else torch.int64
    assert torch.equal(got.view(view), want.view(view))

    leaves = [x.clone().requires_grad_() for x in (uv, scale, base)]
    out = tex.procedural_color(kind, leaves[1], leaves[0], leaves[2])
    kernel = torch.autograd.grad(out, leaves, grad)
    torch.cuda.synchronize()
    assert tex.LAUNCHES == {"procedural_color": before["procedural_color"] + 2,
                            "procedural_color_bwd":
                            before["procedural_color_bwd"] + 1}
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert_grads_match(kernel, autograd_grads(kind, scale, uv, base, grad),
                       kind, tol)


def _float64(x):
    """A scene or camera with its float leaves in float64; the packet
    accelerators and the BVHs stay as built (structure, not values)."""
    from solr_tpu_torch.types import BVH, TriAccel

    if isinstance(x, torch.Tensor):
        return x.double() if x.is_floating_point() else x
    if isinstance(x, (BVH, TriAccel)) or not dataclasses.is_dataclass(x):
        return x
    return x.replace(**{f.name: _float64(getattr(x, f.name))
                        for f in dataclasses.fields(x)})


@pytest.mark.gpu
def test_f64_gradients_on_card_match_cpu(cuda):
    """test_gradients_on_card_match_cpu's walk step (64x56) with the
    scene and camera in float64: the gathers' backward takes float64
    rows on the card, every gradient is float64 and finite, and the
    card's agree with the CPU's within that test's tolerances.  Packets
    are left out: the step's refresh packs the float64 vertices into a
    float64 accelerator, and the sweep kernels take float32 only."""
    cpu, card = _grads_on_card_and_cpu(cuda, 56, _float64)
    assert card["albedo"].dtype == cpu["albedo"].dtype == torch.float64
    _assert_card_matches_cpu(cpu, card)


DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _held(img, ref):
    """The frame budget: atol 1e-4 outside 0.2% of pixels."""
    img = img.cpu().numpy()
    assert np.isfinite(img).all()
    err = np.abs(img - ref).max(-1)
    assert float((err > 1e-4).mean()) <= 0.002, float((err > 1e-4).mean())


@pytest.mark.gpu
def test_stereo_frame_on_card_matches_reference(cuda):
    """BASELINE config #5's frame reduced: side by side, 32x8 tiles,
    packets (B1 and B2, no walk kernel)."""
    ref = np.load(os.path.join(DATA, "torch_stereo_ref.npz"))
    scene, cam, cfg = bench_scene(int(ref["n_tris"]), block=int(ref["block"]),
                                  width=int(ref["width"]),
                                  height=int(ref["height"]), device=cuda)
    cfg = dataclasses.replace(cfg, camera_mode=CameraMode.SIDE_BY_SIDE,
                              packet_tile_w=int(ref["tile_w"]),
                              packet_tile_h=int(ref["tile_h"]))
    before = {**sweep.LAUNCHES, **bvh.LAUNCHES}
    with torch.no_grad():
        img = render_sample(scene, cam, cfg)[0]
    after = {**sweep.LAUNCHES, **bvh.LAUNCHES}
    assert min(after[k] - before[k]
               for k in ("sweep_closest", "sweep_transmittance")) > 0
    assert all(after[k] == before[k] for k in bvh.LAUNCHES)
    _held(img, ref["image"])


@pytest.mark.gpu
def test_anaglyph_on_card_matches_reference(cuda):
    ref = np.load(os.path.join(DATA, "torch_anaglyph_ref.npz"))
    size = int(ref["size"])
    scene, cam, cfg = cornell_scene(size, size, int(ref["bounces"]),
                                    device=cuda)
    cfg = dataclasses.replace(cfg, camera_mode=CameraMode.ANAGLYPH)
    with torch.no_grad():
        _held(render_sample(scene, cam, cfg)[0], ref["image"])


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["image", "image_fisheye", "image_dof"])
def test_textured_on_card_matches_reference(cuda, case):
    """The textured frame without a key (hard shadows, no jitter), with
    its ambient occlusion; with the fisheye; with a lens and depth of
    field in place of the occlusion."""
    ref = np.load(os.path.join(DATA, "torch_textured_ref.npz"))
    size = int(ref["size"])
    scene, cam, cfg = textured_scene(size, size, int(ref["bounces"]),
                                     device=cuda)
    if case == "image_fisheye":
        cfg = dataclasses.replace(cfg, camera_mode=CameraMode.FISHEYE)
    if case == "image_dof":
        cam = cam.replace(
            aperture=torch.tensor(float(ref["aperture"]), device=cuda),
            focal_distance=torch.tensor(float(ref["focal"]), device=cuda))
        cfg = dataclasses.replace(cfg, postfx=PostFxConfig(
            mode=PostFxMode.DEPTH_OF_FIELD))
    with torch.no_grad():
        _held(render(scene, cam, cfg), ref[case])


@pytest.mark.gpu
def test_textured_with_key_on_card(cuda):
    """Soft shadows, jitter and two samples from a key on the card: a
    finite frame that differs from the keyless one."""
    scene, cam, cfg = textured_scene(64, 48, device=cuda)
    with torch.no_grad():
        img = render(scene, cam, cfg, Key.seed(0, cuda), spp=2)
        hard = render(scene, cam, cfg)
    assert img.shape == (48, 64, 4) and torch.isfinite(img).all()
    assert float((img - hard).abs().max()) > 1e-2


@pytest.mark.gpu
def test_shard_render_two_ranks_share_the_card(cuda):
    """shard_render over two gloo ranks that share the card (NCCL
    refuses two ranks on one device), on the reduced bench frame side by
    side with 32x9 tiles (36-row bands): equal to the one-process frame
    at atol 1e-6, and both ranks launch B1 and B2."""
    scene, cam, cfg = bench_scene(N_TRIS, block=BLOCK, width=128, height=72,
                                  device=cuda)
    cfg = dataclasses.replace(cfg, camera_mode=CameraMode.SIDE_BY_SIDE,
                              packet_tile_w=32, packet_tile_h=9)
    group = spawn_group(gpu_frame, 2, (N_TRIS, BLOCK, cfg), backend="gloo",
                        device="cuda:0", timeout_s=300)
    with torch.no_grad():
        want = render_sample(scene, cam, cfg)[0].cpu().numpy()
    for img, launches in group.join():
        np.testing.assert_allclose(img, want, atol=1e-6)
        assert min(launches["sweep_closest"],
                   launches["sweep_transmittance"]) > 0


def _viewer_on_card(tmp_path, *flags):
    """The viewer's default path (the card) at 64x64; returns its image
    and the launches it made."""
    from solr_tpu_torch.viewer import _parser, run

    args = _parser().parse_args(["--width", "64", "--height", "64",
                                 "--seed", "1", "--out",
                                 str(tmp_path / "v.png"), *flags])
    before = {**sweep.LAUNCHES, **bvh.LAUNCHES}
    img = run(args, Key.seed(args.seed, "cuda"))
    after = {**sweep.LAUNCHES, **bvh.LAUNCHES}
    return img, {k: after[k] - before[k] for k in after}


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["terrain", "knot"])
def test_viewer_on_card_matches_reference(cuda, tmp_path, name):
    """A triangle-BVH scene takes B1 and B2; the knot (spheres and
    cylinders over the BVH threshold, no triangle BVH) walks both pools.
    Each frame is held to the committed solr_tpu frame at 64x64
    (tests/data/torch_gallery_ref.npz)."""
    bvh.build()
    img, launched = _viewer_on_card(tmp_path, "--scene", name)
    ref = np.load(os.path.join(DATA, "torch_gallery_ref.npz"))
    _held(torch.as_tensor(img), ref[f"{name}_64"])
    if name == "terrain":
        need = ["sweep_closest", "sweep_transmittance"]
    else:
        need = [bvh.kernel_name(e, p) for p in ("sphere", "cyl")
                for e in bvh.ENTRIES]
    assert min(launched[k] for k in need) > 0, launched


@pytest.mark.gpu
def test_engine_morphed_frames_on_card(cuda):
    """Two morphed frames of one Engine walked on the card: each equals
    the same morph of freshly built scenes, so no packed rows or
    leaf-box answer of one frame serves the next."""
    from solr_tpu_torch.engine import Engine, morph_scenes
    from solr_tpu_torch.scenes import make_scene

    def keys():  # the terrain, and the terrain moved with its tree
        a = make_scene("terrain", seed=1, device=cuda).scene
        t, tree = a.triangles, a.tri_bvh
        return a, a.replace(
            triangles=t.replace(v0=t.v0 + 0.3, v1=t.v1 + 0.3, v2=t.v2 + 0.3),
            tri_bvh=tree.replace(aabb_min=tree.aabb_min + 0.3,
                                 aabb_max=tree.aabb_max + 0.3,
                                 leaf_center=tree.leaf_center + 0.3),
            spheres=a.spheres.replace(center=a.spheres.center - 0.2))

    cfg = RenderConfig(width=64, height=48, max_bounces=2, traversal="while")
    eng = Engine(config=cfg, device=cuda)
    eng.set_nb_frames(3)
    eng.set_keyframes(*keys())
    before = dict(bvh.LAUNCHES)
    for t in (0.5, 1.0):
        with torch.no_grad():
            got, _ = render_sample(eng.next_frame(), eng.camera, cfg)
            want, _ = render_sample(morph_scenes(*keys(), t), eng.camera, cfg)
        assert torch.equal(got, want)
    dfs = bvh.kernel_name("bvh_closest_hit", "tri", dfs=True)
    assert bvh.LAUNCHES["bvh_closest_hit_tri"] > before["bvh_closest_hit_tri"]
    assert bvh.LAUNCHES[dfs] == before[dfs]  # the lerped boxes hold


@pytest.mark.gpu
def test_irt_frame_on_card(cuda, tmp_path):
    """A saved and loaded terrain frame on the card (the triangle
    accelerator derived per frame, ROADMAP C16) equals the original's."""
    from solr_tpu_torch.io import load_scene, save_scene
    from solr_tpu_torch.scenes import make_scene

    demo = make_scene("terrain", seed=1, device=cuda)
    path = str(tmp_path / "t.irt")
    save_scene(path, demo.scene, demo.camera)
    scene, cam = load_scene(path, device=cuda)
    cfg = RenderConfig(width=64, height=64, max_bounces=2)
    before = sweep.LAUNCHES["sweep_closest"]
    with torch.no_grad():
        got = render_sample(scene, cam, cfg)[0]
        want = render_sample(demo.scene, demo.camera, cfg)[0]
    assert sweep.LAUNCHES["sweep_closest"] > before
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.gpu
def test_config1_on_card_matches_oracle(cuda):
    """BASELINE config #1 (chip_smoke.py's config1_scene: the Cornell box
    with eight spheres) at 64x64 on the card, held to the port's numpy
    float64 oracle by tests/test_render_vs_oracle.py's criterion."""
    from solr_tpu_torch.oracle import oracle_render

    chip_smoke = _chip_smoke()
    scene, cam, cfg = chip_smoke.config1_scene(64, 64, cuda)
    with torch.no_grad():
        img = render_sample(scene, cam, cfg)[0].cpu().numpy()
    m = chip_smoke.oracle_mismatch(img, oracle_render(scene, cam, cfg))
    assert chip_smoke.oracle_holds(m), m


@pytest.mark.gpu
def test_spans_stay_off_the_device(cuda):
    """The port's spans (``render_phase``, ``solr/<name>``) are host events
    of the profiler: a small packet frame with short lists (so the net
    runs) profiled on the card leaves no CUDA-typed event with a
    ``solr/`` name, its spans and the runtime's syncs sit among the host
    events, and the image is the unprofiled one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    scene, cam, cfg = bench_scene(4_000, block=64, width=32, height=32,
                                  bounces=2, device=cuda)
    cfg = dataclasses.replace(cfg, packet_max_blocks=2, packet_tile_cand=8)
    with torch.no_grad():
        plain = render_sample(scene, cam, cfg)[0]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            img = render_sample(scene, cam, cfg)[0]
            torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    device = [e.name() for e in events if e.device_type() == DeviceType.CUDA]
    host = [e.name() for e in events if e.device_type() != DeviceType.CUDA]
    assert device and not any(n.startswith("solr/") for n in device)
    for name in ("frame", "closest", "shadow", "strips", "sweep", "net"):
        assert "solr/" + name in host, name
    assert "cudaStreamSynchronize" in host
    assert torch.equal(img, plain)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 5], ids=["one_window", "windows"])
@pytest.mark.parametrize("prim", ["tri", "sphere", "cyl"])
def test_net_strip_lists_on_the_kernels_match_plain(walk, prim, window,
                                                    monkeypatch):
    """The exactness net on the reduced molecule scene (fractional
    materials): 40% of the camera rays, and of the shadow rays toward
    the light, sweep their 32-ray strips' block lists with the kernels
    on the card and with the plain versions on the CPU, bit for bit, in
    one window and in windows of 5 blocks."""
    from solr_tpu_torch.constants import T_FAR
    from solr_tpu_torch.ops import traverse

    if window is not None:
        monkeypatch.setattr(traverse, "_NET_WINDOW", window)
    scene, o, d, so, sd, tm = walk
    accel = getattr(scene, {"tri": "tri_accel", **ACCEL}[prim])
    gen = torch.Generator().manual_seed(4)
    need = (torch.rand(o.shape[0], generator=gen) < 0.4).to(o.device)
    bmin, bmax = _scene_box(accel)
    key = traverse.spatial_keys(o + d * 10.0, bmin, bmax)
    cap = pk.ray_box_exit(o, d, bmin, bmax)
    far = torch.full(need.shape, T_FAR, device=o.device)
    miss = torch.full(need.shape, -1, dtype=torch.int32, device=o.device)
    ones = torch.ones(need.shape, device=o.device)
    skey = traverse.spatial_keys(so, bmin, bmax)

    def net(dev):
        a = accel.replace(packed=accel.packed.to(dev),
                          block_bounds=accel.block_bounds.to(dev))
        c = [x.to(dev) for x in (o, d, cap, far, miss, need, key, so, sd, tm,
                                 ones, skey)]
        traverse.NET_STATS.update(dict.fromkeys(traverse.NET_STATS, 0))
        with torch.no_grad():
            t, i = traverse._net_closest(a, prim, *c[:6], c[6], RAY_EPS)
            tr = traverse._net_transmittance(a, prim, *c[7:10], c[10], c[5],
                                             c[11], RAY_EPS)
        return [x.cpu() for x in (t, i, tr)], dict(traverse.NET_STATS)

    before = sum(sweep.LAUNCHES.values())
    card, stats = net(o.device)
    assert sum(sweep.LAUNCHES.values()) - before == stats["windows"] > 0
    host, _ = net("cpu")
    assert (host[0] < T_FAR).any()
    if prim != "tri":  # the ground occludes no shadow ray
        assert (host[2] < 1.0).any()
    if window is not None:
        assert stats["windows"] > 2
    for a, b in zip(card, host):
        assert torch.equal(a, b)

"""The helpers that call the sweep kernels outside the frame
(solr_tpu_torch.kernel_shapes) and the step-by-step timing script
(solr_tpu_torch.sweep_steps), on the CPU: the inputs they build are the
ones the frame's sweeps take, every step of the script applies to the
committed CUDA source, and chip_smoke.py counts the roots of its bounds
on the blocks the plain sweep visits and the leaf lanes the plain BVH
walk tests.  The timings themselves need the
card."""

import re

import pytest
import torch

from solr_tpu_torch.bench_scene import bench_scene
from solr_tpu_torch.constants import PARK_THRESHOLD
from solr_tpu_torch.kernel_shapes import (fractional, primary_tiles,
                                          shadow_rays, sweep_args,
                                          triangle_hits)
from solr_tpu_torch.molecule_scene import molecule_scene
from solr_tpu_torch.ops import sweep
from solr_tpu_torch.ops.traverse import POOL_TRIANGLE
from solr_tpu_torch.sweep_steps import STEPS, _registers, variant_source

# Several test workers share the cores: keep each one's intra-op pool small.
torch.set_num_threads(2)


def _const(src, name):
    return re.search(rf"constexpr (?:int|bool) {name} = ([^;]+);", src)[1]


@pytest.mark.parametrize("step", range(len(STEPS)))
def test_each_step_sets_its_constants(step):
    name, consts, patches = STEPS[step]
    src = sweep.LIBRARY.src.read_text()
    out = variant_source(src, consts, patches)
    for key, value in consts.items():
        assert _const(out, key) == str(value)
    for old, new in patches:
        assert src.count(old) == 1 and old not in out and new in out
    assert out.count("constexpr") == src.count("constexpr")
    assert len(out.splitlines()) == len(src.splitlines()) + sum(
        new.count("\n") - old.count("\n") for old, new in patches)


def test_variant_source_rejects_an_unknown_constant():
    with pytest.raises(ValueError, match="kNoSuchConstant"):
        variant_source(sweep.LIBRARY.src.read_text(), {"kNoSuchConstant": 1})
    with pytest.raises(ValueError, match="not found once"):
        variant_source(sweep.LIBRARY.src.read_text(), {}, (("no such text", ""),))


def test_longest_first_orders_tiles_by_list_length():
    """The staged kernels' launch order: strip ids (tile-major) by
    descending list length, equal lengths in id order."""
    counts = torch.tensor([[1, 0], [5, 5], [0, 0], [3, 4]], dtype=torch.int32)
    order = sweep.longest_first(counts)
    assert order.dtype == torch.int32
    assert order.tolist() == [2, 3, 7, 6, 0, 1, 4, 5]
    assert torch.equal(counts.reshape(-1)[order.long()],
                       torch.sort(counts.reshape(-1), descending=True).values)


def test_registers_read_from_ptxas_output():
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_112trans_stagedI5WoopTEEvPKfi' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_112trans",
        "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 85 registers, used 1 barriers",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_114closest_kernelI7SphereTEEvPKfi' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_112order_kernelEPKilPi' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 24 registers"])
    assert _registers(log) == {"trans_staged<WoopT>": "85 regs, 8 spill",
                               "closest_kernel<SphereT>": "40 regs, 0 spill",
                               "order_kernel": "24 regs, 0 spill"}


def test_kernel_inputs_are_the_frames():
    """Primary tiles, their closest hits through sweep_closest, shadow
    rays from those hits through sweep_transmittance: the shapes the
    frame hands the kernels, misses parked, fractional factors in range."""
    scene, cam, cfg = bench_scene(4_000, block=64, width=32, height=32,
                                  bounces=1, device="cpu")
    o_t, d_t, live = primary_tiles(cam, cfg)
    assert o_t.shape == (4, cfg.packet_rays, 3) and bool(live.all())
    args = sweep_args(scene.tri_accel, o_t, d_t, live, cfg, True)
    assert len(args) == 9 and args[5].shape[:2] == (4, cfg.packet_rays // 32)
    t, idx, visits = sweep.sweep_closest(*args)
    assert (t < 1e30).any() and (visits > 0).any()
    hit = triangle_hits(t, idx)
    assert torch.equal(hit.pool == POOL_TRIANGLE, t.reshape(-1) < 1e30)
    assert int(hit.idx.min()) >= 0
    so_t, sd_t, tm_t, slive = shadow_rays(scene, o_t, d_t, hit)
    assert torch.equal(slive, t < 1e30)
    assert (so_t[~slive][:, 0] >= PARK_THRESHOLD).all()
    targs = sweep_args(scene.tri_accel, so_t, sd_t, slive, cfg, False, tm_t)
    tr, _ = sweep.sweep_transmittance(*targs)
    assert ((tr >= 0) & (tr <= 1)).all()
    frac = fractional(scene.tri_accel.packed)[:, 15]
    assert ((frac >= 0.35) & (frac < 0.95)).all()
    assert torch.equal(fractional(scene.tri_accel.packed)[:, :15],
                       scene.tri_accel.packed[:, :15])


@pytest.mark.parametrize("prim", ["sphere", "cyl"])
def test_bound_counts_roots_where_reached(prim):
    """chip_smoke's bounds count a sphere's or a cylinder's roots only in
    the (ray, primitive) pairs that reach them, counted while the plain
    sweep runs; the sweep's outputs are its own, and every sphere hit
    reaches its roots."""
    from chip_smoke import _plain_with_root_pairs

    scene, cam, cfg = molecule_scene(400, 16, width=64, height=64, block=64,
                                     device="cpu")
    accel = scene.sph_accel if prim == "sphere" else scene.cyl_accel
    o_t, d_t, live = primary_tiles(cam, cfg)
    args = sweep_args(accel, o_t, d_t, live, cfg, True)
    test = sweep.PRIM_T[prim]
    (t, idx, visits), pairs = _plain_with_root_pairs(
        sweep.sweep_closest_plain, args, prim)
    assert sweep.PRIM_T[prim] is test
    want = sweep.sweep_closest_plain(*args, prim=prim)
    assert all(torch.equal(a, b) for a, b in zip((t, idx, visits), want))
    hits = int((t < 1e30).sum())
    assert 0 < hits <= pairs < int(visits.sum()) * 32 * 64


@pytest.mark.parametrize("prim", ["sphere", "cyl"])
def test_walk_bound_counts_roots_where_reached(prim):
    """The same for the BVH walks: chip_smoke counts a sphere's or a
    cylinder's roots only in the tested (ray, leaf lane) pairs that reach
    them, while the plain walk runs; the walk's outputs are its own, and
    every hit reaches its roots."""
    from chip_smoke import _walk_plain_with_root_pairs
    from solr_tpu_torch.constants import RAY_EPS
    from solr_tpu_torch.ops import bvh
    from solr_tpu_torch.ops.camera import camera_rays

    scene, cam, cfg = molecule_scene(400, 16, width=48, height=48,
                                     device="cpu")
    tree = scene.sph_bvh if prim == "sphere" else scene.cyl_bvh
    o, d = camera_rays(cam, cfg)
    args = (scene, tree, prim, o, d, RAY_EPS)
    leaf_t = bvh._leaf_t
    out, pairs = _walk_plain_with_root_pairs(bvh.bvh_closest_hit_plain, args,
                                             prim)
    assert bvh._leaf_t is leaf_t
    want = bvh.bvh_closest_hit_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(out, want))
    hits = int((out[0] < 1e30).sum())
    assert 0 < hits <= pairs < int(out[3].sum())

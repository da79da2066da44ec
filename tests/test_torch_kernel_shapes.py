"""The helpers that call the sweep kernels outside the frame
(solr_tpu_torch.kernel_shapes) and the step-by-step timing script
(solr_tpu_torch.sweep_steps), on the CPU: the inputs they build are the
ones the frame's sweeps take, and every step of the script applies to
the committed CUDA source.  The timings themselves need the card."""

import re

import pytest
import torch

from solr_tpu_torch.bench_scene import bench_scene
from solr_tpu_torch.constants import PARK_THRESHOLD
from solr_tpu_torch.kernel_shapes import (fractional, primary_tiles,
                                          shadow_rays, sweep_args)
from solr_tpu_torch.ops import sweep
from solr_tpu_torch.ops.traverse import POOL_TRIANGLE, Hit
from solr_tpu_torch.sweep_steps import STEPS, longest_first, variant_source

# Several test workers share the cores: keep each one's intra-op pool small.
torch.set_num_threads(2)


def _const(src, name):
    return re.search(rf"constexpr (?:int|bool) {name} = ([^;]+);", src)[1]


@pytest.mark.parametrize("step", range(len(STEPS)))
def test_each_step_sets_its_constants(step):
    name, consts, side_branch = STEPS[step]
    src = sweep._SRC.read_text()
    out = variant_source(src, consts, side_branch)
    for key, value in consts.items():
        assert _const(out, key) == str(value)
    assert ("if (base) {" in out) == side_branch
    assert out.count("constexpr") == src.count("constexpr")


def test_variant_source_rejects_an_unknown_constant():
    with pytest.raises(ValueError, match="kNoSuchConstant"):
        variant_source(sweep._SRC.read_text(), {"kNoSuchConstant": 1})


def test_longest_first_orders_tiles_by_list_length():
    counts = torch.tensor([[1, 0], [5, 5], [0, 0], [3, 4]], dtype=torch.int32)
    cand = torch.arange(4)[:, None, None].expand(4, 2, 3).contiguous()
    o = torch.arange(4.0)[:, None, None].expand(4, 64, 3)
    args = (torch.zeros(1), o, o, o[..., 0], o[..., 0] > -1, cand, counts,
            1e-4)
    out = longest_first(args)
    assert out[0] is args[0] and out[-1] == args[-1]
    assert out[5][:, 0, 0].tolist() == [1, 3, 0, 2]
    assert out[6].sum(1).tolist() == [10, 7, 1, 0]
    assert out[1][:, 0, 0].tolist() == [1.0, 3.0, 0.0, 2.0]


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
    tf = t.reshape(-1)
    hit = Hit(t=tf, pool=torch.where(tf < 1e30, POOL_TRIANGLE, -1)
              .to(torch.int32), idx=idx.reshape(-1).clamp(min=0))
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

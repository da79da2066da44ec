"""The frame profiler (solr_tpu_torch.frame_profile) on the CPU: it
times every phase, reads the exactness net's counters around each net
call, leaves the image as a plain frame renders it, and puts the
patched functions back."""

import dataclasses

import torch

from solr_tpu_torch.bench_scene import bench_scene
from solr_tpu_torch.frame_profile import PHASES, profile_frame
from solr_tpu_torch.ops import traverse
from solr_tpu_torch.ops.render import render_sample

# Several test workers share the cores: keep each one's intra-op pool small.
torch.set_num_threads(2)


def test_profile_reads_phases_and_net_counters():
    scene, cam, cfg = bench_scene(4_000, block=64, width=32, height=32,
                                  bounces=2)
    # Two blocks per strip drop most candidates, so the net has work.
    cfg = dataclasses.replace(cfg, packet_max_blocks=2, packet_tile_cand=8)
    originals = [getattr(mod, name) for mod, name, _ in PHASES]
    rec = profile_frame(scene, cam, cfg, frames=1)
    assert [getattr(mod, name) for mod, name, _ in PHASES] == originals

    assert rec["instrumented_digest"] == rec["digest"]
    assert "device" not in rec  # the device profile is taken on a card only
    phases = rec["phases"]
    assert phases["scene_closest_hit"]["calls"] == cfg.max_bounces
    assert phases["kernel sweep_closest"]["calls"] >= 1
    assert phases["kernel sweep_transmittance"]["calls"] >= 1
    assert all(p["s"] >= 0.0 for p in phases.values())

    stats = rec["net_stats"]
    assert len(rec["net_calls"]) == phases["exactness net"]["calls"]
    assert stats["calls"] == len(rec["net_calls"])
    for key in stats:
        assert sum(c[key] for c in rec["net_calls"]) == stats[key], key
    assert stats["needy_rays"] > 0
    assert stats["chunks"] >= 1
    assert stats["union_blocks"] >= stats["chunks"]


def test_net_keeps_the_frame_exact_when_lists_are_short():
    """With two blocks per strip most candidates are dropped and the net
    finds them: the frame is the one full lists give."""
    scene, cam, cfg = bench_scene(4_000, block=64, width=32, height=32,
                                  bounces=2)
    short = dataclasses.replace(cfg, packet_max_blocks=2, packet_tile_cand=8)
    for k in traverse.NET_STATS:
        traverse.NET_STATS[k] = 0
    with torch.no_grad():
        full, _ = render_sample(scene, cam, cfg)
        needy_full = traverse.NET_STATS["needy_rays"]
        img, _ = render_sample(scene, cam, short)
    assert traverse.NET_STATS["needy_rays"] > needy_full
    torch.testing.assert_close(img, full, rtol=0.0, atol=0.0)

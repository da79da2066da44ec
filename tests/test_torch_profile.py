"""The frame profiler (solr_tpu_torch.frame_profile) on the CPU: it reads
the port's spans (``solr/<name>``) and the exactness net's counters from
one frame under ``torch.profiler``, and that frame is the plain one."""

import dataclasses

import torch

from solr_tpu_torch.bench_scene import bench_scene
from solr_tpu_torch.frame_profile import profile_frame
from solr_tpu_torch.ops import traverse
from solr_tpu_torch.ops.render import render_sample

# Several test workers share the cores: keep each one's intra-op pool small.
torch.set_num_threads(2)


def test_profile_reads_phases_and_net_counters():
    scene, cam, cfg = bench_scene(4_000, block=64, width=32, height=32,
                                  bounces=2, device="cpu")
    # Two blocks per strip drop most candidates, so the net has work.
    cfg = dataclasses.replace(cfg, packet_max_blocks=2, packet_tile_cand=8)
    rec = profile_frame(scene, cam, cfg, frames=1)

    assert rec["profiled_digest"] == rec["digest"]
    assert "device" not in rec  # the device profile is taken on a card only
    spans = rec["spans"]
    assert spans["solr/frame"]["calls"] == 1
    assert spans["solr/closest"]["calls"] == cfg.max_bounces
    assert spans["solr/sweep"]["calls"] >= 2 * cfg.max_bounces
    assert "solr/walk" not in spans
    for name, row in spans.items():
        assert 0.0 <= row["self_ms"] <= row["ms"] + 1e-9, name
    # The frame encloses every other span: its self time is what they
    # leave over, and every span's self time adds up to the frame.
    total_self = sum(row["self_ms"] for row in spans.values())
    assert abs(total_self - spans["solr/frame"]["ms"]) < 1e-6

    stats = rec["net_stats"]
    assert spans["solr/net"]["calls"] == stats["calls"]
    assert stats["needy_rays"] > 0
    assert stats["windows"] >= 1
    assert stats["strip_blocks"] >= stats["windows"]
    assert stats["strips"] >= -(-stats["needy_rays"] // 32)


def test_net_keeps_the_frame_exact_when_lists_are_short():
    """With two blocks per strip most candidates are dropped and the net
    finds them: the frame is the one full lists give."""
    scene, cam, cfg = bench_scene(4_000, block=64, width=32, height=32,
                                  bounces=2, device="cpu")
    short = dataclasses.replace(cfg, packet_max_blocks=2, packet_tile_cand=8)
    for k in traverse.NET_STATS:
        traverse.NET_STATS[k] = 0
    with torch.no_grad():
        full, _ = render_sample(scene, cam, cfg)
        needy_full = traverse.NET_STATS["needy_rays"]
        img, _ = render_sample(scene, cam, short)
    assert traverse.NET_STATS["needy_rays"] > needy_full
    torch.testing.assert_close(img, full, rtol=0.0, atol=0.0)


def test_profile_times_the_walks_per_kernel():
    """With traversal="while" the frame walks: ``solr/walk`` for the
    closest hit and the shadow rays of every bounce, no sweep, no net."""
    scene, cam, cfg = bench_scene(4_000, block=64, width=32, height=24,
                                  bounces=2, device="cpu")
    cfg = dataclasses.replace(cfg, traversal="while")
    rec = profile_frame(scene, cam, cfg, frames=1)
    assert rec["profiled_digest"] == rec["digest"]
    spans = rec["spans"]
    assert spans["solr/walk"]["calls"] == 2 * cfg.max_bounces
    assert spans["solr/closest"]["calls"] == cfg.max_bounces
    assert "solr/sweep" not in spans and "solr/net" not in spans
    assert rec["net_stats"]["calls"] == 0

"""The port's spans (``utils.profiling.render_phase``, ``solr/<name>``)
and the exactness net's split counters on the CPU: a packet frame with
short candidate lists (so the net runs) rendered under ``torch.profiler``
shows each span the frame reaches, nested as the layers call each
other, and the same image as without the profiler; the net's needy rays
by query and bounce add up to its total; off the profiler a span is one
shared no-op."""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from solr_tpu_torch.bench_scene import bench_scene
from solr_tpu_torch.ops import traverse
from solr_tpu_torch.ops.render import render_sample
from solr_tpu_torch.utils import render_phase

# Several test workers share the cores: keep each one's intra-op pool small.
torch.set_num_threads(2)

NEEDY = ("needy_primary_closest", "needy_primary_shadow",
         "needy_later_closest", "needy_later_shadow")


@pytest.fixture(scope="module")
def short_frame():
    scene, cam, cfg = bench_scene(4_000, block=64, width=32, height=32,
                                  bounces=2, device="cpu")
    # Two blocks per strip drop most candidates, so the net has work.
    return scene, cam, dataclasses.replace(cfg, packet_max_blocks=2,
                                           packet_tile_cand=8)


def _spans(fn):
    """Run ``fn`` under the profiler: its result and its ``solr/`` spans,
    (name, start_ns, end_ns) in order of start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("solr/")), key=lambda x: x[1])
    return out, spans


def _inside(span, outer):
    return outer[1] <= span[1] and span[2] <= outer[2]


def _frame(scene, cam, cfg):
    with torch.no_grad():
        return render_sample(scene, cam, cfg)[0]


def test_a_frame_shows_its_spans_and_its_image(short_frame):
    scene, cam, cfg = short_frame
    plain = _frame(scene, cam, cfg)
    traverse.NET_STATS.update(dict.fromkeys(traverse.NET_STATS, 0))
    img, spans = _spans(lambda: _frame(scene, cam, cfg))
    assert torch.equal(img, plain)
    names = [s[0] for s in spans]
    for name in ("frame", "compact", "closest", "surface", "shade",
                 "shadow", "strips", "sweep", "net", "brute"):
        assert "solr/" + name in names, name
    assert "solr/walk" not in names and "solr/refresh" not in names
    assert names.count("solr/frame") == 1
    frame = spans[0]
    assert frame[0] == "solr/frame"
    assert all(_inside(s, frame) for s in spans)
    for name in ("closest", "surface", "shade", "compact"):
        assert names.count("solr/" + name) == cfg.max_bounces, name
    # One pool takes packets: a strip selection and a sweep for the
    # closest hit and the shadow rays of each bounce; the net sweeps its
    # strip lists too, one launch per window, inside its span.
    windows = traverse.NET_STATS["windows"]
    assert windows > 0
    assert names.count("solr/strips") == 2 * cfg.max_bounces
    assert names.count("solr/sweep") == 2 * cfg.max_bounces + windows
    nets = [s for s in spans if s[0] == "solr/net"]
    inner = [s for s in spans if s[0] == "solr/sweep"
             and any(_inside(s, n) for n in nets)]
    assert len(inner) == windows


def test_the_net_nests_in_its_query(short_frame):
    scene, cam, cfg = short_frame
    traverse.NET_STATS.update(dict.fromkeys(traverse.NET_STATS, 0))
    _, spans = _spans(lambda: _frame(scene, cam, cfg))
    nets = [s for s in spans if s[0] == "solr/net"]
    queries = [s for s in spans if s[0] in ("solr/closest", "solr/shadow")]
    assert len(nets) == traverse.NET_STATS["calls"] > 0
    assert all(any(_inside(n, q) for q in queries) for n in nets)
    shadows = [s for s in spans if s[0] == "solr/shadow"]
    shades = [s for s in spans if s[0] == "solr/shade"]
    assert all(any(_inside(s, h) for h in shades) for s in shadows)
    # The sphere pool (24 spheres, no BVH) takes the brute force outside
    # the net.
    brutes = [s for s in spans if s[0] == "solr/brute"]
    assert brutes and not any(_inside(b, n) for b in brutes for n in nets)


@pytest.mark.parametrize("bounces", [1, 2])
def test_the_net_sweeps_strip_lists_and_never_the_brute(short_frame,
                                                        bounces):
    """The net sweeps one list per 32-ray strip of needy rays with the
    sweep kernels: no whole-pool brute force runs inside it, nothing
    overflows, and its counters add up per call."""
    scene, cam, cfg = short_frame
    cfg = dataclasses.replace(cfg, max_bounces=bounces)
    calls = []
    net_tiles = traverse._needy_tiles

    def needy_tiles(need, sort_key, query):
        calls.append(int(need.sum()))
        return net_tiles(need, sort_key, query)

    traverse.NET_STATS.update(dict.fromkeys(traverse.NET_STATS, 0))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(traverse, "_needy_tiles", needy_tiles)
        _, spans = _spans(lambda: _frame(scene, cam, cfg))
    stats = dict(traverse.NET_STATS)
    nets = [s for s in spans if s[0] == "solr/net"]
    brutes = [s for s in spans if s[0] == "solr/brute"]
    assert nets and brutes
    assert not any(_inside(b, n) for b in brutes for n in nets)
    assert len(calls) == stats["calls"] == len(nets)
    assert sum(calls) == stats["needy_rays"] > 0
    assert stats["strips"] == sum(-(-n // 32) for n in calls) > 0
    assert stats["strip_blocks"] > 0
    assert stats["windows"] >= sum(n > 0 for n in calls) > 0
    # The net keeps no other counter.
    assert set(stats) == {"calls", "needy_rays", "strips", "strip_blocks",
                          "windows", "needy_primary_closest",
                          "needy_primary_shadow", "needy_later_closest",
                          "needy_later_shadow"}


@pytest.mark.parametrize("bounces", [1, 2])
def test_needy_rays_split_by_query_and_bounce(bounces):
    scene, cam, cfg = bench_scene(4_000, block=64, width=32, height=32,
                                  bounces=bounces, device="cpu")
    cfg = dataclasses.replace(cfg, packet_max_blocks=2, packet_tile_cand=8)
    traverse.NET_STATS.update(dict.fromkeys(traverse.NET_STATS, 0))
    _frame(scene, cam, cfg)
    stats = dict(traverse.NET_STATS)
    assert sum(stats[k] for k in NEEDY) == stats["needy_rays"] > 0
    assert stats["needy_primary_closest"] > 0
    assert stats["needy_primary_shadow"] > 0
    later = stats["needy_later_closest"] + stats["needy_later_shadow"]
    assert (later > 0) == (bounces > 1)
    # A query outside the bounce loop files its rays as primary.
    assert traverse._bounce == 0


def test_refresh_and_walk_spans():
    """``with_params`` rebuilds the packet accelerators under
    ``solr/refresh``; a walk frame walks under ``solr/walk`` and sweeps
    nothing."""
    scene, cam, cfg = bench_scene(4_000, block=64, width=32, height=24,
                                  bounces=2, device="cpu")
    cfg = dataclasses.replace(cfg, traversal="while")

    def step():
        return _frame(scene.with_params(scene.params), cam, cfg)

    _, spans = _spans(step)
    names = [s[0] for s in spans]
    assert names.count("solr/refresh") == 1
    assert names.count("solr/walk") == 2 * cfg.max_bounces
    assert "solr/sweep" not in names and "solr/net" not in names
    refresh = spans[names.index("solr/refresh")]
    frame = spans[names.index("solr/frame")]
    assert refresh[2] <= frame[1]


def test_render_phase_is_a_shared_no_op_off_the_profiler():
    off = render_phase("net")
    assert off is render_phase("frame")
    with off:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        on = render_phase("net")
    assert on is not off
